// Int8-plane CIM matmul for Hopper: y = scale * sum_b 2^b * (x @ P_b).
//
// Replaces the TPU kernel
// repro/kernels/cim_matmul/kernel.py::cim_matmul_kernel (body _kernel),
// both modes:
//   fused_dequant  rebuild the integer weight sum_b 2^b P_b, then one dot
//                  (what --materialize planes_int8 serves);
//   planes         one dot per plane over each 128-row K chunk, the partial
//                  sums weighted by 2^b (the crossbar's per-column dataflow;
//                  a parity oracle).
// Operands:
//   x        f32 or bf16 [M, K]
//   splanes  int8 [cols, K, N], values in {-1, 0, 1} (sign folded in),
//            plane 0 = LSB
//   scale    f32 scalar (device pointer)
//   out      f32 [M, N]
// Grouped launch (G >= 1 independent matmuls, the experts of a MoE layer):
// every operand gains a leading group axis ([G, M, K] x, [G, cols, K, N]
// splanes, [G] scale, [G, M, N] out), all contiguous; blockIdx.z carries
// group * m_tiles + M tile, a block offsets its base pointers by its
// group's stride once and then runs the one-matmul code, so a group gives
// what a single launch with the same plan gives, bit for bit.  The split-K
// workspace is [G, splits, M, N].
//
// What bounds it: at decode (M = batch) the plane bytes, cols * K * N (one
// byte per bit cell) over 3.35 TB/s; at prefill (M = 128) the same bytes
// for the tensor-core path (2 * M * K * N bf16 operations over 989 TFLOP/s
// take less time), the f32 multiply-adds over 67 TFLOP/s for f32 x.
//
// Two kernels.  fused_dequant with bf16 x runs the tensor-core kernel
// `cim_planes_tc_kernel`; f32 x, and the planes mode, run the FMA kernel
// `cim_planes_kernel` (the port runs no f32 matmul in TF32, and planes is
// the parity oracle).
//
// Tensor-core kernel.  The integer weight w = sum_b 2^b P_b (|w| < 2^16 for
// cols <= 16) splits exactly as w = 256 * hi + lo with hi, lo integers in
// [-255, 255]: both are exact bf16 values, a bf16 x is exact too, and every
// product is exact in f32, so y = scale * (256 * (x @ hi) + x @ lo) differs
// from the FMA loop only in the order of the f32 sums (within
// 2 * eps_f32 * K * (|x| @ |w|)).  A block owns up to 128 rows of x (64
// where M <= 64) and 128 columns (64 for cols > 10), so each plane byte is read once per 128
// rows (the FMA kernel reads it once per 16).  Its two warpgroups stream
// 64-row K stages of the cols int8 plane slices and of x
// with 16-byte cp.async into a two-stage ring (one block an SM), then
// dequantise each stage into hi / lo bf16 tiles in shared memory (K-major,
// 128-byte swizzle, the wgmma B layout), 16 weights a thread; one
// warpgroup per 64 rows then runs two SS wgmmas a 16-deep step (x @ hi,
// x @ lo) into f32 accumulators.  The dequantisation, not the tensor
// cores, is the arithmetic that competes with the plane stream, so both
// warpgroups share it even where M <= 64 leaves one of them no wgmma.  Decode (M < 16) runs the
// same kernel with x zero-filled to 64 rows: neither operand swap nor an
// FMA loop was taken, because the tensor cores cost nothing next to the
// plane stream, and the ring already keeps stages x cols x 4 KB of plane
// bytes in flight per SM, the lever a byte-bound decode needs.  Split K
// (f32 workspace, fixed-order reduce) only where the column tiles alone do
// not fill the SMs; runs are deterministic.  N % 16, K % 8 or base
// alignment failing selects element loads into the same layout.
//
// FMA kernel (the layout of csrc/cim_matmul.cu, without the bit unpack): each
// thread owns 4 adjacent output columns — one 32-bit load gives 4 plane
// bytes, a warp reads 128 contiguous bytes per (plane, K row) — and MT rows
// of x, staged as f32 in shared memory 128 K values at a time.  fused_dequant
// loads the words of all planes of 4 K rows before it uses any, so enough
// loads are in flight to stream the planes (a load followed at once by its
// use would expose the memory latency once per plane).  Split K
// with an f32 workspace and a fixed-order second pass fills the card for
// narrow N and keeps runs deterministic.  Ragged N is masked with byte
// loads; K needs no padding (rows past K are never read).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kCols = 4;       // output columns per thread
constexpr int kKChunk = 128;   // K values of x staged in shared memory at once
constexpr int kRows = 4;       // K rows whose plane words are loaded together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four adjacent int8 plane values of one K row starting at column n0, packed
// in one word (byte c = column n0 + c); columns past N read as zero.
template <bool kVec>
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ row, int n0, int n) {
  if (kVec) return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (n0 + c < n) v |= (uint32_t)(uint8_t)__ldg(row + n0 + c) << (8 * c);
  return v;
}

// Byte c of a word as a signed value.
__device__ __forceinline__ int byte_at(uint32_t w, int c) {
  return (int)(int8_t)(uint8_t)(w >> (8 * c));
}

template <typename XT, int MT, int COLS, bool kVec, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
cim_planes_kernel(const XT* __restrict__ x, const int8_t* __restrict__ splanes,
                  const float* __restrict__ scale, float* __restrict__ dst,
                  int m_rows, int k_dim, int n_cols, int cols, int k_per_split,
                  int apply_scale) {
  __shared__ float xs[MT][kKChunk];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.y;
  const int m_tiles = (m_rows + MT - 1) / MT;
  const int grp = blockIdx.z / m_tiles;
  const int m0 = (blockIdx.z % m_tiles) * MT;
  const int k_begin = split * k_per_split;
  const int k_end = min(k_dim, k_begin + k_per_split);
  const size_t plane_stride = (size_t)k_dim * n_cols;
  const bool live = n0 < n_cols;
  // this group's operands (grouped launch; group 0 of a single one)
  x += (size_t)grp * m_rows * k_dim;
  splanes += (size_t)grp * cols * plane_stride;
  scale += grp;
  dst += (size_t)grp * gridDim.y * m_rows * n_cols;

  float acc[MT][kCols];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[mm][c] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kKChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kKChunk; i += kThreads) {
      const int mm = i / kKChunk, kk = i % kKChunk;
      const int m = m0 + mm, k = kc + kk;
      xs[mm][kk] = (m < m_rows && k < k_end) ? to_f32(x[(size_t)m * k_dim + k]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int k_stop = min(kc + kKChunk, k_end);
    if (!kPlanes) {
      // kRows K rows at a time, every plane's word loaded before any is
      // used, so cols * kRows loads are in flight per thread
      for (int k0 = kc; k0 < k_stop; k0 += kRows) {
        uint32_t pw[kRows][COLS];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int b = 0; b < COLS; ++b)
            pw[r][b] = (b < cols && k0 + r < k_stop)
                           ? load4<kVec>(splanes + b * plane_stride + (size_t)(k0 + r) * n_cols,
                                         n0, n_cols)
                           : 0u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            int w = 0;
#pragma unroll
            for (int b = 0; b < COLS; ++b) w += byte_at(pw[r][b], c) * (1 << b);
            const float wf = (float)w;
#pragma unroll
            for (int mm = 0; mm < MT; ++mm)
              acc[mm][c] = fmaf(xs[mm][k0 - kc + r], wf, acc[mm][c]);
          }
        }
      }
    } else {
      for (int b = 0; b < cols; ++b) {
        float part[MT][kCols];
#pragma unroll
        for (int mm = 0; mm < MT; ++mm)
#pragma unroll
          for (int c = 0; c < kCols; ++c) part[mm][c] = 0.f;
        const int8_t* plane = splanes + b * plane_stride;
#pragma unroll 4
        for (int k = kc; k < k_stop; ++k) {
          const uint32_t pw = load4<kVec>(plane + (size_t)k * n_cols, n0, n_cols);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float v = (float)byte_at(pw, c);
#pragma unroll
            for (int mm = 0; mm < MT; ++mm) part[mm][c] = fmaf(xs[mm][k - kc], v, part[mm][c]);
          }
        }
        const float p2 = (float)(1 << b);
#pragma unroll
        for (int mm = 0; mm < MT; ++mm)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[mm][c] = fmaf(p2, part[mm][c], acc[mm][c]);
      }
    }
  }
  if (!live) return;
  const float s = apply_scale ? __ldg(scale) : 1.f;
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    const int m = m0 + mm;
    if (m >= m_rows) break;
    float* row = dst + ((size_t)split * m_rows + m) * n_cols;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (n0 + c < n_cols) row[n0 + c] = acc[mm][c] * s;
  }
}

// out[g][i] = scale[g] * sum_{s < splits} ws[g][s][i], summed in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int splits, long long mn,
                                     long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long g = i / mn, r = i % mn;
  const float* part = ws + (size_t)g * splits * mn + r;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * mn];
  out[i] = acc * __ldg(scale + g);
}

cudaError_t reduce_splits(const void* ws, const void* scale, void* out, int splits, int m, int n,
                          int groups, cudaStream_t st) {
  const long long mn = (long long)m * n, total = mn * groups;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const float*)ws, (const float*)scale, (float*)out, splits, mn, total);
  return cudaGetLastError();
}

struct Args {
  const void *x, *splanes, *scale;
  float* dst;
  int m, k, n, cols, splits, k_per_split, apply_scale, groups;
  cudaStream_t stream;
};

template <typename XT, int MT, int COLS, bool kVec, bool kPlanes>
void launch_main(const Args& a) {
  const int col_groups = (a.n + kCols - 1) / kCols;
  dim3 grid((col_groups + kThreads - 1) / kThreads, a.splits, a.groups * ((a.m + MT - 1) / MT));
  cim_planes_kernel<XT, MT, COLS, kVec, kPlanes><<<grid, kThreads, 0, a.stream>>>(
      (const XT*)a.x, (const int8_t*)a.splanes, (const float*)a.scale, a.dst,
      a.m, a.k, a.n, a.cols, a.k_per_split, a.apply_scale);
}

template <typename XT, int MT, int COLS, bool kPlanes>
void launch_vec(bool vec, const Args& a) {
  if (vec) launch_main<XT, MT, COLS, true, kPlanes>(a);
  else launch_main<XT, MT, COLS, false, kPlanes>(a);
}

template <typename XT, int MT, bool kPlanes>
void launch_cols(bool vec, const Args& a) {
  if (a.cols == 10) launch_vec<XT, MT, 10, kPlanes>(vec, a);
  else launch_vec<XT, MT, 16, kPlanes>(vec, a);
}

template <typename XT, bool kPlanes>
void launch_mt(int mt, bool vec, const Args& a) {
  if (mt == 4) launch_cols<XT, 4, kPlanes>(vec, a);
  else launch_cols<XT, 16, kPlanes>(vec, a);
}



// ---- tensor-core kernel (bf16 x, fused_dequant) --------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBK = 64;  // K rows per stage (one 128-byte swizzled row of bf16)

template <int COLS, int NWG>
struct Cfg {
  static constexpr int THREADS = 256;  // two warpgroups load and dequantise; NWG of them run wgmma
  static constexpr int BM = NWG * 64;  // x rows per block
  // output columns per block: 128 (each plane row is read as a 128-byte
  // segment), 64 for cols > 10, whose 16 planes would not fit two such
  // stages
  static constexpr int BN = COLS <= 10 ? 128 : 64;
  // two stages: one in flight while the other is dequantised (a ring of
  // four 32-row stages, three in flight, ran slower on the H100: the sync
  // and wgmma wait per stage cost more than the deeper stream gained)
  static constexpr int STAGES = 2;
  static constexpr int PLANE_BYTES = COLS * kBK * BN;  // int8 [COLS][kBK][BN]
  static constexpr int X_BYTES = BM * kBK * 2;         // bf16 [BM][kBK], swizzled
  static constexpr int STAGE_BYTES = PLANE_BYTES + X_BYTES;
  static constexpr int W_BYTES = BN * kBK * 2;         // one of hi / lo, [BN][kBK]
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * W_BYTES;
  static_assert(SMEM <= 232448, "a block's shared memory exceeds 227 KB");
};

// 4 x 4 byte transpose: t[c] byte b = byte c of w_b.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t* t) {
  const uint32_t x0 = __byte_perm(w0, w1, 0x5140), x1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t y0 = __byte_perm(w2, w3, 0x5140), y1 = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// c + sum of the 4 signed bytes of a times the 4 unsigned bytes of b.
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 128) hopper::wgmma_ss_n128(d, a, b, 1);
  else hopper::wgmma_ss_n64(d, a, b, 1);
}

// Stage `slot` <- plane rows [kc, kc + kBK) of columns [n0, n0 + BN) and x
// rows [m0, m0 + BM) of the same K range; zeros past K (the split's end), M
// and N.  kVec: 16-byte cp.async (N % 16 == 0, K % 8 == 0, aligned bases);
// otherwise element loads.
template <int COLS, int NWG, bool kVec>
__device__ __forceinline__ void load_stage(uint8_t* stage, const bf16* __restrict__ x,
                                           const int8_t* __restrict__ splanes, int m0, int n0,
                                           int kc, int k_end, int m_rows, int k_dim,
                                           int n_cols, int cols) {
  using C = Cfg<COLS, NWG>;
  const size_t plane_stride = (size_t)k_dim * n_cols;
  int8_t* ps = reinterpret_cast<int8_t*>(stage);
  uint8_t* xs = stage + C::PLANE_BYTES;
  if (kVec) {
    constexpr int CH = C::BN / 16;  // 16-byte chunks of a plane row
    for (int i = threadIdx.x; i < cols * kBK * CH; i += C::THREADS) {
      const int b = i / (kBK * CH), r = (i / CH) % kBK, c = i % CH;
      const int k = kc + r, n = n0 + 16 * c;
      const bool ok = k < k_end && n < n_cols;
      const int8_t* src = ok ? splanes + b * plane_stride + (size_t)k * n_cols + n : splanes;
      hopper::cp_async16(ps + (b * kBK + r) * C::BN + 16 * c, src, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < C::BM * (kBK / 8); i += C::THREADS) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const int m = m0 + r, k = kc + 8 * c;
      const bool ok = m < m_rows && k < k_end;
      const bf16* src = ok ? x + (size_t)m * k_dim + k : x;
      hopper::cp_async16(xs + hopper::swz128(r, c), src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < cols * kBK * C::BN; i += C::THREADS) {
      const int b = i / (kBK * C::BN), r = (i / C::BN) % kBK, c = i % C::BN;
      const int k = kc + r, n = n0 + c;
      ps[i] = (k < k_end && n < n_cols) ? splanes[b * plane_stride + (size_t)k * n_cols + n]
                                        : (int8_t)0;
    }
    for (int i = threadIdx.x; i < C::BM * kBK; i += C::THREADS) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = kc + kk;
      *reinterpret_cast<bf16*>(xs + hopper::swz128(r, kk / 8) + 2 * (kk % 8)) =
          (m < m_rows && k < k_end) ? x[(size_t)m * k_dim + k] : __float2bfloat16_rn(0.f);
    }
  }
}

// y[m0:m0+BM, n0:n0+64] (+ split part) = scale * (256 * (x @ hi) + x @ lo),
// where w = sum_b 2^b P_b = 256 * hi + lo, lo = sum_{b<8} 2^b P_b and
// hi = sum_{b>=8} 2^(b-8) P_b are integers in [-255, 255], exact in bf16.
template <int COLS, int NWG, bool kVec>
__global__ void __launch_bounds__(Cfg<COLS, NWG>::THREADS, 1)
cim_planes_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ splanes,
                     const float* __restrict__ scale, float* __restrict__ dst, int m_rows,
                     int k_dim, int n_cols, int cols, int k_per_split, int apply_scale) {
  using C = Cfg<COLS, NWG>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* w_hi = stages + C::STAGES * C::STAGE_BYTES;  // bf16 [BN][kBK], K-major, swizzled
  uint8_t* w_lo = w_hi + C::W_BYTES;

  const int m_tiles = (m_rows + C::BM - 1) / C::BM;
  const int grp = blockIdx.z / m_tiles;
  const int n0 = blockIdx.x * C::BN, split = blockIdx.y, m0 = (blockIdx.z % m_tiles) * C::BM;
  const int k_begin = split * k_per_split;
  const int k_end = min(k_dim, k_begin + k_per_split);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  // this group's operands (grouped launch; group 0 of a single one)
  x += (size_t)grp * m_rows * k_dim;
  splanes += (size_t)grp * cols * k_dim * n_cols;
  scale += grp;
  dst += (size_t)grp * gridDim.y * m_rows * n_cols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4;

  constexpr int NACC = C::BN / 2;  // f32 accumulators a thread, each of hi and lo
  float acc_hi[NACC], acc_lo[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc_hi[i] = acc_lo[i] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_tiles)
      load_stage<COLS, NWG, kVec>(stages + s * C::STAGE_BYTES, x, splanes, m0, n0,
                                  k_begin + s * kBK, k_end, m_rows, k_dim, n_cols, cols);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    uint8_t* stage = stages + (t % C::STAGES) * C::STAGE_BYTES;
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile t is in; every warpgroup is done with tile t - 1
    const int tn = t + C::STAGES - 1;
    if (tn < n_tiles)
      load_stage<COLS, NWG, kVec>(stages + (tn % C::STAGES) * C::STAGE_BYTES, x, splanes, m0,
                                  n0, k_begin + tn * kBK, k_end, m_rows, k_dim, n_cols, cols);
    cp_async_commit();

    // dequant: 4 K rows x 4 columns a thread (one 32-bit word per plane and
    // row), written K-major (8 bytes a column); byte transposes and dp4a
    // take about half the instructions of a byte-by-byte shift-and-add
    const int8_t* ps = reinterpret_cast<const int8_t*>(stage);
    constexpr int kPlaneSlots = (COLS + 3) / 4 * 4;  // whole groups of 4 planes
#pragma unroll
    for (int u = tid; u < (kBK / 4) * (C::BN / 4); u += C::THREADS) {
      const int nq = u % (C::BN / 4), kq = u / (C::BN / 4);
      // per K row: the plane words, 4 planes at a time, byte-transposed so
      // that a word holds 4 planes of one weight; dp4a then weighs them by
      // 2^b: lo from planes 0-7, hi from planes 8-15
      int lo[4][4], hi[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t w[kPlaneSlots];
#pragma unroll
        for (int b = 0; b < kPlaneSlots; ++b)
          w[b] = (b < COLS && b < cols) ? *reinterpret_cast<const uint32_t*>(
                                              ps + (b * kBK + kq * 4 + r) * C::BN + 4 * nq)
                                        : 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c) lo[r][c] = hi[r][c] = 0;
#pragma unroll
        for (int g = 0; g < kPlaneSlots / 4; ++g) {
          uint32_t t[4];
          transpose4(w[4 * g], w[4 * g + 1], w[4 * g + 2], w[4 * g + 3], t);
          const uint32_t pow2 = g % 2 ? 0x80402010u : 0x08040201u;  // 2^b of 4 planes
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (g < 2) lo[r][c] = dp4a_su(t[c], pow2, lo[r][c]);
            else hi[r][c] = dp4a_su(t[c], pow2, hi[r][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * nq + c;
        const __nv_bfloat162 h01 = __floats2bfloat162_rn((float)hi[0][c], (float)hi[1][c]);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn((float)hi[2][c], (float)hi[3][c]);
        const __nv_bfloat162 l01 = __floats2bfloat162_rn((float)lo[0][c], (float)lo[1][c]);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn((float)lo[2][c], (float)lo[3][c]);
        const uint32_t at = swz128(n, kq / 2) + 8 * (kq % 2);  // K rows 4 kq .. 4 kq + 3
        *reinterpret_cast<uint2*>(w_hi + at) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23));
        *reinterpret_cast<uint2*>(w_lo + at) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&l01), *reinterpret_cast<const uint32_t*>(&l23));
      }
    }
    fence_proxy_async();  // the hi / lo and cp.async x writes, for wgmma's reads
    __syncthreads();

    if (wg >= NWG) continue;  // a dequant-only warpgroup (M <= 64)
    const uint32_t xa = smem_u32(stage + C::PLANE_BYTES + wg * 64 * (2 * kBK));
    const uint32_t ha = smem_u32(w_hi), la = smem_u32(w_lo);
    fence_regs<NACC>(acc_hi);
    fence_regs<NACC>(acc_lo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint64_t da = desc_sw128(xa + 32 * j, 16, 1024);
      wgmma_ss<C::BN>(acc_hi, da, desc_sw128(ha + 32 * j, 16, 1024));
      wgmma_ss<C::BN>(acc_lo, da, desc_sw128(la + 32 * j, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NACC>(acc_hi);
    fence_regs<NACC>(acc_lo);
  }

  if (wg >= NWG) return;
  // fragment i: row 16 wl + lane / 4 + 8 * ((i >> 1) & 1), column 8 (i / 4) + 2 (lane % 4) + (i & 1)
  const float s = apply_scale ? __ldg(scale) : 1.f;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int m = m0 + wg * 64 + 16 * wl + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = n0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    if (m < m_rows && n < n_cols)
      dst[((size_t)split * m_rows + m) * n_cols + n] = (256.f * acc_hi[i] + acc_lo[i]) * s;
  }
}

template <int COLS, int NWG, bool kVec>
cudaError_t launch(const void* x, const void* splanes, const void* scale, float* dst, int m,
                   int k, int n, int cols, int groups, int splits, int k_per_split,
                   int apply_scale, cudaStream_t stream) {
  using C = Cfg<COLS, NWG>;
  auto kern = cim_planes_tc_kernel<COLS, NWG, kVec>;
  static unsigned long long opted_in = 0;  // > 48 KB of shared memory, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(opted_in >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in |= 1ULL << dev;
  }
  dim3 grid((n + C::BN - 1) / C::BN, splits, groups * ((m + C::BM - 1) / C::BM));
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(splanes),
      static_cast<const float*>(scale), dst, m, k, n, cols, k_per_split, apply_scale);
  return cudaGetLastError();
}

template <int COLS, int NWG>
cudaError_t launch_vec(bool vec, const void* x, const void* splanes, const void* scale,
                       float* dst, int m, int k, int n, int cols, int groups, int splits,
                       int k_per_split, int apply_scale, cudaStream_t stream) {
  return vec ? launch<COLS, NWG, true>(x, splanes, scale, dst, m, k, n, cols, groups, splits,
                                       k_per_split, apply_scale, stream)
             : launch<COLS, NWG, false>(x, splanes, scale, dst, m, k, n, cols, groups, splits,
                                        k_per_split, apply_scale, stream);
}

}  // namespace tc

}  // namespace

// The wrapper validates shapes and pointers.  cols <= 16; mt is 4 or 16;
// vec requires n % 4 == 0 and 4-byte aligned planes; planes_mode selects
// the per-plane oracle.  fused_dequant takes f32 x only (bf16 x runs
// cim_planes_tc_launch).  groups >= 1 matmuls of these shapes, each operand
// contiguous with a leading group axis (groups * ceil(m / mt) <= 65535).
// With splits > 1, ws holds f32[groups, splits, m, n].
// Returns the first CUDA error of the launches (0 on success).
extern "C" int cim_planes_launch(const void* x, int x_is_bf16, const void* splanes,
                                 const void* scale, void* out, void* ws, int m, int k, int n,
                                 int cols, int groups, int mt, int vec, int planes_mode,
                                 int splits, int k_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a{x, splanes, scale, splits > 1 ? (float*)ws : (float*)out,
         m, k, n, cols, splits, k_per_split, splits > 1 ? 0 : 1, groups, st};
  if (!planes_mode && x_is_bf16) return (int)cudaErrorInvalidValue;
  if (!planes_mode) launch_mt<float, false>(mt, vec != 0, a);
  else if (x_is_bf16) launch_mt<__nv_bfloat16, true>(mt, vec != 0, a);
  else launch_mt<float, true>(mt, vec != 0, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  return (int)reduce_splits(ws, scale, out, splits, m, n, groups, st);
}

// The tensor-core path of fused_dequant for bf16 x (the wrapper validates):
// cols <= 16; nwg 1 (M <= 64) or 2; vec requires n % 16 == 0, k % 8 == 0 and
// 16-byte aligned x and planes; k_per_split a multiple of 64; groups as for
// cim_planes_launch (groups * ceil(m / (64 nwg)) <= 65535).  With
// splits > 1, ws holds f32[groups, splits, m, n] and the fixed-order reduce
// scales.
extern "C" int cim_planes_tc_launch(const void* x, const void* splanes, const void* scale,
                                    void* out, void* ws, int m, int k, int n, int cols,
                                    int groups, int nwg, int vec, int splits, int k_per_split,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = splits > 1 ? (float*)ws : (float*)out;
  const int apply = splits > 1 ? 0 : 1;
  const bool v = vec != 0;
  cudaError_t err;
  if (cols <= 10)
    err = nwg == 1 ? tc::launch_vec<10, 1>(v, x, splanes, scale, dst, m, k, n, cols, groups,
                                           splits, k_per_split, apply, st)
                   : tc::launch_vec<10, 2>(v, x, splanes, scale, dst, m, k, n, cols, groups,
                                           splits, k_per_split, apply, st);
  else
    err = nwg == 1 ? tc::launch_vec<16, 1>(v, x, splanes, scale, dst, m, k, n, cols, groups,
                                           splits, k_per_split, apply, st)
                   : tc::launch_vec<16, 2>(v, x, splanes, scale, dst, m, k, n, cols, groups,
                                           splits, k_per_split, apply, st);
  if (err != cudaSuccess || splits <= 1) return (int)err;
  return (int)reduce_splits(ws, scale, out, splits, m, n, groups, st);
}
