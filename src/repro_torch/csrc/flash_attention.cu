// Kernel B3: masked GQA attention with an online softmax (flash attention,
// forward), for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (body `_kernel`,
// src/repro/kernels/flash_attention/kernel.py).  Same contract:
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], f32 or bf16 -> out [B, Hq, Sq, D]
//   in q's type; kv head = q head / (Hq / Hkv) (no K/V expansion); q is
//   scaled by D^-0.5 before the dot; f32 online softmax (m, l, acc); masked
//   scores are -1e30 (not -inf), so a tile that is fully masked for a row
//   before that row's first visible key adds weight exp(0) that the next
//   live tile's rescale exp(-1e30 - m) wipes out, and never a NaN; masks:
//   causal, bidir, swa(window), key position < sk_valid (the static
//   padding tail) and < kv_valid_len[b] (per row, device int32), with
//   q_offsets[b] (per row, device int32) the absolute position of q[0];
//   a null pointer selects the scalar argument shared by the batch, so a
//   batch-uniform call (every prefill) copies nothing to the card.
//   Tiles that are dead for every row of the q tile are skipped with the
//   TPU kernel's rule (causal / swa only; bidir visits every tile).
//
// Design (a first, simple kernel): one block of 128 threads per
// (q tile of 32 rows, q head, batch row).  The scaled q tile stays in
// shared memory; each live key tile of BK keys is staged in shared memory as
// f32 (BK = 64 for D <= 128, 32 for D = 256, so the tiles fit; above 48 KB
// the kernel opts in to dynamic shared memory).  Each warp owns 8 q rows:
// for the scores a lane owns BK/32 keys (K rows padded to D + 1 floats, so
// the lanes' rows fall in distinct banks); for the output a lane owns D/32
// columns, accumulated in registers with f32 FMA.  Bound on this card:
// operations at every shape the model path runs (4 * D FLOPs per visible
// (q, k) pair against 67 TFLOP/s f32); this kernel does not use the tensor
// cores (wgmma/TMA are later work), so it sits far above that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                     // q rows per block
constexpr int kRows = kBQ / kWarps;         // q rows per warp
constexpr float kMasked = -1e30f;

enum Kind { kCausal = 0, kBidir = 1, kSwa = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr int tile_k() { return D <= 128 ? 64 : 32; }

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + BK * (D + 1) + BK * D + kBQ * BK);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_offsets,
                       const int* __restrict__ kv_valid_len, int q_offset0,
                       int kv_valid_len0, T* __restrict__ out, int hq, int hkv, int sq,
                       int sk, int sk_valid, int kind, int window, float scale) {
  constexpr int KS = D + 1;      // padded K row stride (bank-conflict free)
  constexpr int KPL = BK / 32;   // keys per lane
  constexpr int DPL = D / 32;    // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][D], q * D^-0.5
  float* ks = qs + kBQ * D;      // [BK][KS]
  float* vs = ks + BK * KS;      // [BK][D]
  float* ps = vs + BK * D;       // [kBQ][BK] probabilities of this tile

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // absolute position of the tile's row 0, and this row's live extent
  const int q_lo = (q_offsets ? q_offsets[b] : q_offset0) + iq * kBQ;
  const int kvl = kv_valid_len ? kv_valid_len[b] : kv_valid_len0;
  const size_t q_base = ((size_t)(b * hq + h) * sq + (size_t)iq * kBQ) * D;
  const size_t kv_base = (size_t)(b * hkv + hk) * sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) qs[i] = to_f32(q[q_base + i]) * scale;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  const int n_k = sk / BK;
  for (int ik = 0; ik < n_k; ++ik) {
    const int k_lo = ik * BK;
    if (kind != kBidir) {
      bool live = k_lo <= q_lo + kBQ - 1 && k_lo < kvl;
      if (kind == kSwa) live = live && k_lo + BK - 1 > q_lo - window;
      if (!live) continue;  // uniform across the block
    }
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const size_t src = kv_base + (size_t)(k_lo + c) * D + d;
      ks[c * KS + d] = to_f32(k[src]);
      vs[i] = to_f32(v[src]);
    }
    __syncthreads();

    float s[kRows][KPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) kv[j] = ks[(lane + 32 * j) * KS + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qs[(warp * kRows + r) * D + d];
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[r][j] = fmaf(qv, kv[j], s[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int q_pos = q_lo + row;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k_pos = k_lo + lane + 32 * j;
        bool ok = k_pos < sk_valid && k_pos < kvl;
        if (kind != kBidir) {
          ok = ok && k_pos <= q_pos;
          if (kind == kSwa) ok = ok && k_pos > q_pos - window;
        }
        if (!ok) s[r][j] = kMasked;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = expf(s[r][j] - m_new);
        ps[row * BK + lane + 32 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();  // the warp's P rows are written before any lane reads them

    for (int c = 0; c < BK; ++c) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vv[j] = vs[c * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = ps[(warp * kRows + r) * BK + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lr = fmaxf(l[r], 1e-30f);
    T* o = out + q_base + (size_t)(warp * kRows + r) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j) store(o + lane + 32 * j, acc[r][j] / lr);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_offsets,
                   const void* kv_valid_len, int q_offset0, int kv_valid_len0, void* out,
                   int b, int hq, int hkv, int sq, int sk, int sk_valid, int kind, int window,
                   float scale, cudaStream_t stream) {
  constexpr int BK = tile_k<D>();
  constexpr size_t smem = smem_bytes<D, BK>();
  if (sq % kBQ != 0 || sk % BK != 0 || hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<T, D, BK>;
  // opt in to > 48 KB of dynamic shared memory once per device
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(opted_in >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in |= 1ULL << dev;
  }
  dim3 grid(sq / kBQ, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_offsets), static_cast<const int*>(kv_valid_len), q_offset0,
      kv_valid_len0, static_cast<T*>(out), hq, hkv, sq, sk, sk_valid, kind, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const void* q_offsets, const void* kv_valid_len, int q_offset0,
                     int kv_valid_len0, void* out, int b, int hq, int hkv, int sq, int sk,
                     int sk_valid, int kind, int window, float scale, cudaStream_t stream) {
#define FA_CASE(DD)                                                                    \
  case DD:                                                                             \
    return launch<T, DD>(q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0,  \
                         out, b, hq, hkv, sq, sk, sk_valid, kind, window, scale, stream);
  switch (d) {  // the dense decoders' head dims: yi/internlm2/phi3, gemma
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// Key rows per tile for head dim `d` (the wrapper pads Sk to a multiple).
extern "C" int flash_attention_tile_k(int d) { return d <= 128 ? 64 : 32; }

// q_offsets / kv_valid_len: per-row int32 on the card, or null to use
// q_offset0 / kv_valid_len0 for every row.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offsets, const void* kv_valid_len,
                                      int q_offset0, int kv_valid_len0, void* out,
                                      int is_bf16, int b, int hq, int hkv, int sq, int sk,
                                      int sk_valid, int d, int kind, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(d, q, k, v, q_offsets, kv_valid_len, q_offset0,
                                   kv_valid_len0, out, b, hq, hkv, sq, sk, sk_valid, kind,
                                   window, scale, s);
  return launch_d<float>(d, q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0, out,
                         b, hq, hkv, sq, sk, sk_valid, kind, window, scale, s);
}
