// Kernel B3: masked GQA attention with an online softmax (flash attention,
// forward), for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (body `_kernel`,
// src/repro/kernels/flash_attention/kernel.py).  Same contract:
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], f32 or bf16 -> out [B, Hq, Sq, D]
//   in q's type; kv head = q head / (Hq / Hkv) (no K/V expansion); scores
//   scaled by D^-0.5 (q before the dot in the f32 kernel, the f32 dot in
//   the bf16 kernel); f32 online softmax (m, l, acc); masked
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
// Two kernels.  bf16 q/k/v take the tensor-core kernel `fa_tc_kernel`
// (below); f32 q/k/v take `flash_attention_kernel`, a first, simple
// design: one block of 128 threads per (q tile of 32 rows, q head, batch
// row).  The scaled q tile stays in
// shared memory; each live key tile of BK keys is staged in shared memory as
// f32 (BK = 64 for D <= 128, 32 for D = 256, so the tiles fit; above 48 KB
// the kernel opts in to dynamic shared memory).  Each warp owns 8 q rows:
// for the scores a lane owns BK/32 keys (K rows padded to D + 1 floats, so
// the lanes' rows fall in distinct banks); for the output a lane owns D/32
// columns (ceil(D/32): at D = 16 or 20 one, with the lanes past D idle),
// accumulated in registers with f32 FMA.  Bound on this card:
// operations at every shape the model path runs (4 * D FLOPs per visible
// (q, k) pair against 67 TFLOP/s f32 for the f32 kernel, 989 TFLOP/s bf16
// for the tensor-core kernel).  The f32 kernel keeps f32 FMA (the port runs
// no f32 matmul in TF32).
//
// Tensor-core kernel (bf16).  Rows: the GQA group of kv head `kvh` is one
// packed [G * Sq, D] matrix (q[b, kvh*G:(kvh+1)*G] is contiguous); packed
// row r is at position q_offset + r % Sq.  A block owns 64 packed rows per
// consumer warpgroup (two at D = 64 and 128, one at D = 256, where the O
// accumulator takes 128 f32 registers a thread), so at the serve shape
// (G = 8, Sq = 32) two blocks cover a kv head and each K/V tile is read by
// 128 rows, not once per q head.  Pipeline: one producer warp starts TMA
// loads of 64-key K and V tiles (D cut into 64-column boxes, 128-byte
// swizzle, zero fill past Sk, so the wrapper pads nothing) into a ring of
// 4 (D = 64: one box a tile), 3 (D = 128) or 2 (D = 256) stages guarded by
// full/empty mbarriers.  Each
// consumer warpgroup: S = Q.K^T by wgmma (SS, both K-major, f32
// accumulators; q and k are exact bf16 so every product is exact), then the
// D^-0.5 scale and the mask in f32 on the fragments, the online softmax
// with quad shuffles, and O += P.V as two register-A wgmmas with V read
// N-major (the transpose bit): P = P_hi + P_lo with P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), so P's f32 value enters to within 2^-16 |P|.  The
// dead-tile rule is taken on the min and max q position of the block's
// packed rows; rows past G * Sq are computed on TMA's zeros and not stored.
// Issuing the next tile's S before this tile's P.V, and a base-2 softmax
// that masks only the tiles at the mask's edge, both measured slower on
// the H100 than this plain order.  TMA descriptors are encoded per call on
// the host by
// cuTensorMapEncodeTiled, found with dlsym in libcuda.so.1, which the CUDA
// runtime has loaded (no -lcuda link flag).
#include <cuda.h>  // CUtensorMap and its enums only; the encoder comes from dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>

#include <chrono>
#include <cstddef>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;                     // q rows per block
constexpr int kRows = kBQ / kWarps;         // q rows per warp
constexpr float kMasked = -1e30f;

enum Kind { kCausal = 0, kBidir = 1, kSwa = 2 };


template <int D>
constexpr int tile_k() { return D <= 128 ? 64 : 32; }

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + BK * (D + 1) + BK * D + kBQ * BK);
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ q_offsets,
                       const int* __restrict__ kv_valid_len, int q_offset0,
                       int kv_valid_len0, float* __restrict__ out, int hq, int hkv, int sq,
                       int sk, int sk_valid, int kind, int window, float scale) {
  constexpr int KS = D + 1;      // padded K row stride (bank-conflict free)
  constexpr int KPL = BK / 32;   // keys per lane
  constexpr int DPL = (D + 31) / 32;  // output columns per lane (the last partial)
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

  for (int i = tid; i < kBQ * D; i += kThreads) qs[i] = q[q_base + i] * scale;

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
      ks[c * KS + d] = k[src];
      vs[i] = v[src];
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
      for (int j = 0; j < DPL; ++j)  // columns past D (D % 32 != 0) are never stored
        vv[j] = (D % 32 == 0 || lane + 32 * j < D) ? vs[c * D + lane + 32 * j] : 0.f;
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
    float* o = out + q_base + (size_t)(warp * kRows + r) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (D % 32 == 0 || lane + 32 * j < D) o[lane + 32 * j] = acc[r][j] / lr;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_offsets,
                   const void* kv_valid_len, int q_offset0, int kv_valid_len0, void* out,
                   int b, int hq, int hkv, int sq, int sk, int sk_valid, int kind, int window,
                   float scale, cudaStream_t stream) {
  constexpr int BK = tile_k<D>();
  constexpr size_t smem = smem_bytes<D, BK>();
  if (sq % kBQ != 0 || sk % BK != 0 || hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<D, BK>;
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
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_offsets), static_cast<const int*>(kv_valid_len), q_offset0,
      kv_valid_len0, static_cast<float*>(out), hq, hkv, sq, sk, sk_valid, kind, window, scale);
  return cudaGetLastError();
}

cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const void* q_offsets, const void* kv_valid_len, int q_offset0,
                     int kv_valid_len0, void* out, int b, int hq, int hkv, int sq, int sk,
                     int sk_valid, int kind, int window, float scale, cudaStream_t stream) {
#define FA_CASE(DD)                                                                    \
  case DD:                                                                             \
    return launch<DD>(q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0,  \
                         out, b, hq, hkv, sq, sk, sk_valid, kind, window, scale, stream);
  switch (d) {  // the served models' head dims: hymba 64, yi/internlm2/phi3 128,
                // gemma 256; and the reduced configs' (internlm2, yi and hymba 16,
                // phi3 20, gemma 32)
    FA_CASE(16)
    FA_CASE(20)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

// ---- tensor-core kernel (bf16) ------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kRowsWG = 64;   // packed q rows per consumer warpgroup
constexpr int kBox = 64;      // bf16 columns per TMA box (one 128-byte swizzled row)

template <int D>
struct Cfg {
  static constexpr int NWG = D <= 128 ? 2 : 1;   // consumer warpgroups
  static constexpr int STAGES = D <= 64 ? 4 : D <= 128 ? 3 : 2;
  static constexpr int BOXES = D / kBox;          // boxes across a row of D
  static constexpr int THREADS = NWG * 128 + 32;  // + one producer warp
  static constexpr int ROWS = NWG * kRowsWG;      // packed q rows per block
  static constexpr int Q_BOX = kRowsWG * 128;     // bytes of one q box
  static constexpr int KV_BOX = kBK * 128;        // bytes of one K or V box
  static constexpr int Q_BYTES = NWG * BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX; // one K (or V) tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
             const __grid_constant__ CUtensorMap tmv, const int* __restrict__ q_offsets,
             const int* __restrict__ kv_valid_len, int q_offset0, int kv_valid_len0,
             bf16* __restrict__ out, int hkv, int g, int sq, int sk, int sk_valid, int kind,
             int window, float scale) {
  using C = Cfg<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qs + C::Q_BYTES;  // stage s: K at s * 2 * KV_BYTES, V KV_BYTES after it
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + C::STAGES * 2 * C::KV_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int bh = blockIdx.y, b = bh / hkv;
  const int rows = g * sq;
  const int row0 = blockIdx.x * C::ROWS;
  const int row1 = min(row0 + C::ROWS, rows);
  const int q_off = q_offsets ? q_offsets[b] : q_offset0;
  const int kvl = kv_valid_len ? kv_valid_len[b] : kv_valid_len0;
  // min and max q position of the block's packed rows (the dead-tile rule)
  int pmin = 0, pmax = sq - 1;
  if (row1 - row0 < sq) {
    const int a = row0 % sq, z = (row1 - 1) % sq;
    if (a <= z) pmin = a, pmax = z;
  }
  pmin += q_off;
  pmax += q_off;
  const int n_k = (sk + kBK - 1) / kBK;
  auto live = [&](int ik) {
    if (kind == kBidir) return true;
    const int k_lo = ik * kBK;
    bool ok = k_lo <= pmax && k_lo < kvl;
    if (kind == kSwa) ok = ok && k_lo + kBK - 1 > pmin - window;
    return ok;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);  // lane 0 of every consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * C::NWG) {  // producer warp: TMA only
    if (lane == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int w = 0; w < C::NWG; ++w)
        for (int i = 0; i < C::BOXES; ++i)
          tma_load_3d(qs + (w * C::BOXES + i) * C::Q_BOX, &tmq, qbar, kBox * i,
                      row0 + kRowsWG * w, bh);
      int it = 0;
      for (int ik = 0; ik < n_k; ++ik) {
        if (!live(ik)) continue;
        const int s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        uint8_t* kt = kvs + s * 2 * C::KV_BYTES;
        for (int i = 0; i < C::BOXES; ++i) {
          tma_load_3d(kt + i * C::KV_BOX, &tmk, &full[s], kBox * i, ik * kBK, bh);
          tma_load_3d(kt + C::KV_BYTES + i * C::KV_BOX, &tmv, &full[s], kBox * i, ik * kBK, bh);
        }
        ++it;
      }
    }
    return;
  }

  // consumer warpgroup wg: packed rows row0 + 64 wg + [0, 64)
  const int wg = warp / 4, wl = warp % 4;
  const int r_a = row0 + kRowsWG * wg + 16 * wl + lane / 4;  // fragment rows r_a, r_a + 8
  const int c2 = 2 * (lane % 4);
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = q_off + (r_a + 8 * h) % sq;
  float o[D / 2], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t qaddr = smem_u32(qs + wg * C::BOXES * C::Q_BOX);

  mbar_wait(qbar, 0);
  int it = 0;
  for (int ik = 0; ik < n_k; ++ik) {
    if (!live(ik)) continue;
    const int s = it % C::STAGES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    const uint32_t kaddr = smem_u32(kvs + s * 2 * C::KV_BYTES);
    const uint32_t vaddr = kaddr + C::KV_BYTES;

    // S = Q . K^T (unscaled), 64 rows x 64 keys
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs<32>(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const uint32_t off = (j % 4) * 32;  // 16 columns further in the swizzled row
      wgmma_ss_n64(sc, desc_sw128(qaddr + (j / 4) * C::Q_BOX + off, 16, 1024),
                   desc_sw128(kaddr + (j / 4) * C::KV_BOX + off, 16, 1024), j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);

    // scale, mask (-1e30), online softmax; fragment i: row r_a + 8 * ((i >> 1) & 1),
    // key k_lo + 8 * (i / 4) + c2 + (i & 1)
    const int k_lo = ik * kBK;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kp = k_lo + 8 * (i / 4) + c2 + (i & 1);
      bool ok = kp < sk_valid && kp < kvl;
      if (kind != kBidir) {
        ok = ok && kp <= pos[h];
        if (kind == kSwa) ok = ok && kp > pos[h] - window;
      }
      sc[i] = ok ? sc[i] * scale : kMasked;
      mx[h] = fmaxf(mx[h], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = expf(sc[i] - m[h]);
      l[h] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P . V with P = P_hi + P_lo (bf16 each), 4 steps of 16 keys; the
    // A fragments are all built before the first wgmma, so no register a
    // pending wgmma reads is written while it runs
    uint32_t ah[kBK / 16][4], al[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float p0 = sc[8 * kk + 2 * q], p1 = sc[8 * kk + 2 * q + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        ah[kk][q] = *reinterpret_cast<const uint32_t*>(&hi);
        al[kk][q] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    fence_regs<D / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = desc_sw128(vaddr + kk * 16 * 128, C::KV_BOX, 1024);
      if constexpr (D == 64) {
        wgmma_rs_tn_n64(o, ah[kk], dv);
        wgmma_rs_tn_n64(o, al[kk], dv);
      } else if constexpr (D == 128) {
        wgmma_rs_tn_n128(o, ah[kk], dv);
        wgmma_rs_tn_n128(o, al[kk], dv);
      } else {
        wgmma_rs_tn_n256(o, ah[kk], dv);
        wgmma_rs_tn_n256(o, al[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    if (lane == 0) mbar_arrive(&empty[s]);
    ++it;
  }

  bf16* obase = out + (size_t)bh * rows * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const float lr = fmaxf(lh, 1e-30f);
    const int r = r_a + 8 * h;
    if (r >= rows) continue;
    bf16* orow = obase + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / lr, o[4 * j + 2 * h + 1] / lr);
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has loaded.
EncodeFn encoder() {
  static EncodeFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A [mats, rows, d] bf16 tensor as a 3-D map of (64 columns, box_rows rows)
// boxes, 128-byte swizzle, zeros past its edges.
bool encode_3d(EncodeFn fn, CUtensorMap* map, const void* ptr, int d, int rows, int mats,
               int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The three maps of one call: q as [B * Hkv, G * Sq, D], k and v as
// [B * Hkv, Sk, D].
bool encode_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv, const void* q,
                 const void* k, const void* v, int b, int hq, int hkv, int sq, int sk, int d) {
  EncodeFn fn = encoder();
  return fn && encode_3d(fn, mq, q, d, (hq / hkv) * sq, b * hkv, kRowsWG) &&
         encode_3d(fn, mk, k, d, sk, b * hkv, kBK) && encode_3d(fn, mv, v, d, sk, b * hkv, kBK);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_offsets,
                   const void* kv_valid_len, int q_offset0, int kv_valid_len0, void* out, int b,
                   int hq, int hkv, int sq, int sk, int sk_valid, int kind, int window,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  if (hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode_maps(&mq, &mk, &mv, q, k, v, b, hq, hkv, sq, sk, D)) return cudaErrorInvalidValue;
  auto kern = fa_tc_kernel<D>;
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(opted_in >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in |= 1ULL << dev;
  }
  const int g = hq / hkv;
  dim3 grid((g * sq + C::ROWS - 1) / C::ROWS, b * hkv);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<const int*>(q_offsets), static_cast<const int*>(kv_valid_len),
      q_offset0, kv_valid_len0, static_cast<bf16*>(out), hkv, g, sq, sk, sk_valid, kind, window,
      scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Key rows per tile of the f32 kernel for head dim `d` (the wrapper pads Sk
// to a multiple; the bf16 kernel needs no padding).
extern "C" int flash_attention_tile_k(int d) { return d <= 128 ? 64 : 32; }

// q_offsets / kv_valid_len: per-row int32 on the card, or null to use
// q_offset0 / kv_valid_len0 for every row.  bf16 runs the tensor-core kernel
// (q, k, v 16-byte aligned, any Sq and Sk), f32 the FMA kernel (Sq a
// multiple of 32, Sk of flash_attention_tile_k).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offsets, const void* kv_valid_len,
                                      int q_offset0, int kv_valid_len0, void* out,
                                      int is_bf16, int b, int hq, int hkv, int sq, int sk,
                                      int sk_valid, int d, int kind, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 64)
      return tc::launch<64>(q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0, out, b,
                            hq, hkv, sq, sk, sk_valid, kind, window, scale, s);
    if (d == 128)
      return tc::launch<128>(q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0, out, b,
                             hq, hkv, sq, sk, sk_valid, kind, window, scale, s);
    if (d == 256)
      return tc::launch<256>(q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0, out, b,
                             hq, hkv, sq, sk, sk_valid, kind, window, scale, s);
    return cudaErrorInvalidValue;
  }
  return launch_d(d, q, k, v, q_offsets, kv_valid_len, q_offset0, kv_valid_len0, out,
                         b, hq, hkv, sq, sk, sk_valid, kind, window, scale, s);
}

// Host microseconds to encode the three TMA descriptors of one bf16 call
// (mean over `reps`; -1 if the encoder is missing or refuses the shapes).
extern "C" double flash_attention_encode_us(const void* q, const void* k, const void* v, int b,
                                            int hq, int hkv, int sq, int sk, int d, int reps) {
  CUtensorMap mq, mk, mv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!tc::encode_maps(&mq, &mk, &mv, q, k, v, b, hq, hkv, sq, sk, d)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / (reps > 0 ? reps : 1);
}
