// Bit-packed CIM matmul for Hopper: y = scale * (x @ (sign * sum_p 2^id[p] bits_p)).
//
// Two TPU kernels, one template flag (kSkip) in each kernel of this file:
//   B2 replaces repro/kernels/cim_matmul/kernel.py::cim_matmul_packed_kernel
//      (bodies _packed_kernel and _unpack_bits);
//   B4 replaces repro/kernels/cim_matmul/kernel.py::cim_matmul_packed_skip_kernel
//      (body _packed_skip_kernel): B2 plus the const_rle codec's zero-tile
//      flags, skipping the load and unpack of every (plane, 128-row K block)
//      whose flag is 0.
// Operands are the serving layout of repro_torch.core.bitslice.pack_linear_planes
// / pack_linear_sign:
//   x         f32 or bf16 [M, K]
//   planes    uint8 [cols, ceil(K/8), N], K packed MSB-first
//   sign      uint8 [ceil(K/8), N], bit 1 = negative weight
//   plane_ids int32 [cols] or null: stored plane p weighs 2^plane_ids[p]
//             (the col_perm codec; plane p weighs 2^p when null)
//   plane_gain f32 [cols, N] or null (FMA kernel, B2 only): stored plane p
//             at column n weighs gain[p, n] * 2^plane_ids[p] (drifted
//             conductances, repro_torch.core.nonideal.perturb_operands)
//   tile_nz   uint8 [cols, ceil(K/128)] (B4 only): 0 = the (plane, K block)
//             tile is zero across all N
//   scale     f32 scalar (device pointer)
//   out       f32 [M, N]
// Grouped launch (G >= 1 independent matmuls, the experts of a MoE layer):
// every operand above gains a leading group axis ([G, M, K] x, [G, cols,
// ceil(K/8), N] planes, [G] scale, [G, M, N] out, ...), all contiguous, and
// blockIdx.z carries (group, M tile) as group * m_tiles + tile.  A block
// offsets each base pointer by its group's stride (derived from M, K, N and
// cols) once, then runs exactly the one-matmul code: a group computes what a
// single launch of it with the same launch plan computes, bit for bit.  The
// split-K workspace is [G, splits, M, N] and the reduce sums each group's
// splits in order and scales by the group's scale.
//
// What bounds it: at decode (M = batch) the packed weight bytes,
// (cols + 1) / 8 * K * N (B4: the flagged-live tiles only), over 3.35 TB/s;
// at prefill (M = 128) the same bytes for the tensor-core path (2 * M * K * N
// bf16 operations over 989 TFLOP/s take less time), the f32 multiply-adds
// over 67 TFLOP/s for f32 x.  Between the two sits the unpack, which is
// integer work on every weight and, in practice, what the time follows.
//
// bf16 x runs the tensor-core kernel `cim_packed_tc_kernel`; f32 x runs
// the FMA kernel `cim_packed_kernel` (the port runs no f32 matmul in TF32).
//
// Tensor-core kernel (B5's tensor-core kernel in csrc/cim_planes.cu with
// another stage loader and dequantisation).  |w| < 2^16 for cols <= 16, so
// w = sign * (2^b * hi + lo) with lo = |w| mod 2^b and hi = |w| >> b, both
// integers exact in bf16 (b = 7 where cols <= 10, so both stay below 128;
// b = 8 for cols up to 16); with bf16 x every product is exact in f32, and
// y = scale * (2^b * (x @ (s hi)) + x @ (s lo)) differs from the FMA loop
// only in the order of the f32 sums (within 2 * eps_f32 * K * (|x| @ |w|)).
// A block owns 64 rows of x per wgmma warpgroup (two where M > 64) by 128
// columns and streams 64-row K stages (8 packed byte rows of every plane
// and of the signs, and the x tile) with 16-byte cp.async into a ring of
// as many slots as fit (4-6): a packed stage holds only 11-19 KB, so the
// plane stream needs several in flight, and x rows past M are zeroed once,
// not loaded.  Its 256 threads dequantise a stage, one byte row by 4
// columns each: the words of planes 0 .. b-1 hold an 8 x 8 bit matrix per
// column byte (plane x K value), and three rounds of masked shifts
// transpose all four at once, leaving in byte c of word q the lo of K
// value 7 - q; planes b .. cols-1 give hi the same way (the compiler drops
// the rounds on zero words).  A value v < 128 becomes bf16 as
// s (128 + v) - s 128 in bf16x2 (one prmt under the magic 0x4300, one
// subtraction for two values, the sign folded into both operands); a full
// byte as the f32 0x4B000000 | v minus 2^23, cvt.rn.bf16x2, and the sign
// XORed in (one multiply spreads two sign bits to bits 15 and 31).  Each
// thread writes one 16-byte chunk of the K-major, 128-byte-swizzled hi and
// lo tiles per column, into one of two tile buffers (hi and lo adjacent);
// the wgmma warpgroups run one SS wgmma of N = 256 a 16-deep step,
// x @ [hi | lo], into f32 accumulators and leave it running while the next
// stage is dequantised (the stage loop waits for the wgmmas of the stage
// before, so the latency of their dependent chain hides behind the
// dequantisation), combining 2^b * (x @ hi) + x @ lo at the end.  Packed rows sit 144 bytes apart in
// shared memory, so the eight byte rows a warp reads, and the chunks it
// writes, fall on distinct banks.  Decode (M < 16) runs the same kernel
// with x zero-filled to 64 rows, as B5 does.  Split K (f32 workspace,
// fixed-order reduce) only where the column tiles alone do not fill the
// SMs.  N % 16, K % 8 or base alignment failing selects element loads into
// the same layout.
//   plane_ids: stored plane p holds logical plane plane_ids[p]; the
//     transpose reads stored plane inv[b] for logical plane b, so the ids
//     must be a permutation of 0 .. cols - 1 (what the col_perm codec
//     stores).  Each block checks this once (every inv slot set, from a
//     sentinel); where it fails, the block loads no plane and writes NaN
//     to all its outputs, so such ids give an all-NaN result.
//   B4: a stage is half of a 128-row flag tile; the block reads the flags
//     of 256 stages at a time into shared memory.  A dead plane's bytes
//     are not loaded and its words are zero in the transpose; a stage whose
//     planes are all dead loads only its x rows, skips its dequantisation
//     and multiplies a zero tile (so no branch separates the wgmmas, which
//     the compiler would otherwise serialise).  Adding exactly zero
//     products leaves an f32 accumulator as it was, and B2 and B4 take one
//     launch plan, so they agree bit for bit.
//
// FMA kernel (f32 x): each thread owns 4 adjacent output columns (one
// 32-bit load per plane per byte row: a warp reads 128 contiguous bytes of
// each plane) and MT rows of x.  Per byte row it rebuilds the 4 x 8 integer
// magnitudes in registers, applies the signs and accumulates in f32 FMA; x
// is staged in shared memory.  B4 reads its flags once per 128-row tile
// (the same for the whole warp); a tile with every plane live takes B2's
// path, one with dead planes loads and unpacks the live planes only.  The
// magnitudes are exact integers however they are built, and the FMA order
// is the same on every path, so B2 and B4 agree bit for bit.  plane_ids
// makes the bit positions runtime values, so it is a template flag: without
// it they are constants the compiler folds.  plane_gain (template flag
// kGain, B2 only) makes the weights of a thread's 4 columns float: each
// thread reads gain[p, n] * 2^id[p] for its columns once (exact: a power of
// two scales) and a weight's magnitude is the sum, in plane order, of the
// weights of its set bits; the reference sends such operands to its plain
// version, whose unpack sums the same products.  The weights are read once per
// M tile (MT = 4 at decode, 16 at prefill).  Gemma's narrow matrices
// (N = 256 or 2048) have too few column blocks to fill 132 SMs, so K is
// split across blocks: each split writes an f32 partial to a workspace and
// a second pass sums the partials in a fixed order, so repeated runs give
// identical results (no float atomics).  Split boundaries are multiples of
// 8, not of 128, so B4 indexes its flags by absolute K row / 128.  Ragged N
// is masked with byte loads; ragged K needs nothing, since padded K bits
// are zero and the staged x is zero past K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kCols = 4;       // output columns per thread
constexpr int kKChunk = 128;   // K values of x staged in shared memory at once

// Four adjacent bytes of one packed row starting at column n0, as one word
// (byte c = column n0 + c); columns past N read as zero.
template <bool kVec>
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row, int n0, int n) {
  if (kVec) return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (n0 + c < n) v |= (uint32_t)__ldg(row + n0 + c) << (8 * c);
  return v;
}

// Accumulate one byte row (8 K values x 4 columns) into acc, given the
// magnitude of weight (j, c) as mag(j, c) (an integer, or a float with
// plane gains).  The FMA order (j, c, mm) is the same for every way of
// building the magnitudes, so B2 and B4 agree.
template <int MT, typename Mag>
__device__ __forceinline__ void fma_row(float (&acc)[MT][kCols], float (*xs)[kKChunk],
                                        int kk, uint32_t sw, Mag mag) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float xv[MT];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) xv[mm] = xs[mm][kk + j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int sh = 8 * c + 7 - j;  // K value k + j is bit 7 - j of its byte
      const float m = (float)mag(j, c, sh);
      const float w = ((sw >> sh) & 1u) ? -m : m;
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) acc[mm][c] = fmaf(xv[mm], w, acc[mm][c]);
    }
  }
}

template <int MT, int COLS, bool kVec, bool kSkip, bool kIds, bool kGain>
__global__ void __launch_bounds__(kThreads)
cim_packed_kernel(const float* __restrict__ x, const uint8_t* __restrict__ planes,
                  const uint8_t* __restrict__ sign, const int* __restrict__ plane_ids,
                  const uint8_t* __restrict__ tile_nz, const float* __restrict__ plane_gain,
                  const float* __restrict__ scale, float* __restrict__ dst, int m_rows,
                  int k_dim, int n_cols, int cols, int k_per_split, int apply_scale) {
  static_assert(!(kGain && kSkip), "plane gains run on B2's path only");
  __shared__ float xs[MT][kKChunk];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.y;
  const int m_tiles = (m_rows + MT - 1) / MT;
  const int grp = blockIdx.z / m_tiles;
  const int m0 = (blockIdx.z % m_tiles) * MT;
  const int k_begin = split * k_per_split;  // a multiple of 8
  const int k_end = min(k_dim, k_begin + k_per_split);
  const int k_bytes = (k_dim + 7) / 8;
  const int k_tiles = (k_bytes + 15) / 16;  // flags per plane (B4)
  const bool live = n0 < n_cols;
  // this group's operands (grouped launch; group 0 of a single one)
  x += (size_t)grp * m_rows * k_dim;
  planes += (size_t)grp * cols * k_bytes * n_cols;
  sign += (size_t)grp * k_bytes * n_cols;
  if (kIds) plane_ids += (size_t)grp * cols;
  if (kSkip) tile_nz += (size_t)grp * cols * k_tiles;
  if (kGain) plane_gain += (size_t)grp * cols * n_cols;
  scale += grp;
  dst += (size_t)grp * gridDim.y * m_rows * n_cols;

  // stored plane b's bit position in the magnitude: b, or plane_ids[b]
  int weight_bit[COLS];
#pragma unroll
  for (int b = 0; b < COLS; ++b) weight_bit[b] = (kIds && b < cols) ? __ldg(plane_ids + b) : b;

  // with plane gains: stored plane b's weight at each of this thread's columns
  float gain_w[kGain ? COLS : 1][kCols];
  if constexpr (kGain) {
#pragma unroll
    for (int b = 0; b < COLS; ++b)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        gain_w[b][c] = (b < cols && n0 + c < n_cols)
                           ? ldexpf(__ldg(plane_gain + (size_t)b * n_cols + n0 + c), weight_bit[b])
                           : 0.f;
  }

  float acc[MT][kCols];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[mm][c] = 0.f;

  const uint32_t all_planes = (1u << cols) - 1u;
  uint32_t live_planes = all_planes;
  int tile = -1;
  for (int kc = k_begin; kc < k_end; kc += kKChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kKChunk; i += kThreads) {
      const int mm = i / kKChunk, kk = i % kKChunk;
      const int m = m0 + mm, k = kc + kk;
      xs[mm][kk] = (m < m_rows && k < k_end) ? x[(size_t)m * k_dim + k] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int k_stop = min(kc + kKChunk, k_end);
    for (int k = kc; k < k_stop; k += 8) {
      const int kb = k >> 3;
      if (kSkip && (k >> 7) != tile) {  // the same for every thread: no divergence
        tile = k >> 7;
        live_planes = 0;
        for (int b = 0; b < cols; ++b)
          live_planes |= (uint32_t)(__ldg(tile_nz + (size_t)b * k_tiles + tile) != 0) << b;
      }
      // every live plane's word is loaded before any is used, so the loads
      // overlap; a dead plane of B4 is neither loaded nor unpacked
      uint32_t pw[COLS];
      if (!kSkip || live_planes == all_planes) {
        // every plane live (all of B2): rebuild each magnitude bit by bit
#pragma unroll
        for (int b = 0; b < COLS; ++b)
          pw[b] = b < cols ? load4<kVec>(planes + ((size_t)b * k_bytes + kb) * n_cols, n0, n_cols)
                           : 0u;
        const uint32_t sw = load4<kVec>(sign + (size_t)kb * n_cols, n0, n_cols);
        if constexpr (kGain) {
          fma_row<MT>(acc, xs, k - kc, sw, [&](int, int c, int sh) {
            float m = 0.f;
#pragma unroll
            for (int b = 0; b < COLS; ++b) m += ((pw[b] >> sh) & 1u) ? gain_w[b][c] : 0.f;
            return m;
          });
        } else {
          fma_row<MT>(acc, xs, k - kc, sw, [&](int, int, int sh) {
            uint32_t m = 0;
#pragma unroll
            for (int b = 0; b < COLS; ++b) m |= ((pw[b] >> sh) & 1u) << (kIds ? weight_bit[b] : b);
            return m;
          });
        }
      } else {
        // B4 with dead planes in this tile: load and unpack the live ones
#pragma unroll
        for (int b = 0; b < COLS; ++b)
          pw[b] = (b < cols && ((live_planes >> b) & 1u))
                      ? load4<kVec>(planes + ((size_t)b * k_bytes + kb) * n_cols, n0, n_cols)
                      : 0u;
        const uint32_t sw = load4<kVec>(sign + (size_t)kb * n_cols, n0, n_cols);
        uint32_t mag[8][kCols];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < kCols; ++c) mag[j][c] = 0u;
#pragma unroll
        for (int b = 0; b < COLS; ++b) {
          if (b >= cols || !((live_planes >> b) & 1u)) continue;
          const int wb = kIds ? weight_bit[b] : b;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < kCols; ++c) mag[j][c] |= ((pw[b] >> (8 * c + 7 - j)) & 1u) << wb;
        }
        fma_row<MT>(acc, xs, k - kc, sw, [&](int j, int c, int) { return mag[j][c]; });
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

cudaError_t reduce_splits(const float* ws, const float* scale, float* out, int splits, int m,
                          int n, int groups, cudaStream_t st) {
  const long long mn = (long long)m * n, total = mn * groups;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      ws, scale, out, splits, mn, total);
  return cudaGetLastError();
}

struct Args {
  const void *x, *planes, *sign, *plane_ids, *tile_nz, *plane_gain, *scale;
  float* dst;
  int m, k, n, cols, splits, k_per_split, apply_scale, groups;
  cudaStream_t stream;
};

template <int MT, int COLS, bool kVec, bool kSkip, bool kIds, bool kGain>
void launch_main(const Args& a) {
  const int col_groups = (a.n + kCols - 1) / kCols;
  dim3 grid((col_groups + kThreads - 1) / kThreads, a.splits, a.groups * ((a.m + MT - 1) / MT));
  cim_packed_kernel<MT, COLS, kVec, kSkip, kIds, kGain><<<grid, kThreads, 0, a.stream>>>(
      (const float*)a.x, (const uint8_t*)a.planes, (const uint8_t*)a.sign,
      (const int*)a.plane_ids, (const uint8_t*)a.tile_nz, (const float*)a.plane_gain,
      (const float*)a.scale, a.dst, a.m, a.k, a.n, a.cols, a.k_per_split, a.apply_scale);
}

template <int MT, int COLS, bool kSkip, bool kIds, bool kGain>
void launch_vec(bool vec, const Args& a) {
  if (vec) launch_main<MT, COLS, true, kSkip, kIds, kGain>(a);
  else launch_main<MT, COLS, false, kSkip, kIds, kGain>(a);
}

template <int MT, bool kSkip, bool kIds, bool kGain>
void launch_cols(bool vec, const Args& a) {
  if (a.cols == 10) launch_vec<MT, 10, kSkip, kIds, kGain>(vec, a);
  else launch_vec<MT, 16, kSkip, kIds, kGain>(vec, a);
}

template <bool kSkip, bool kIds, bool kGain>
void launch_mt(int mt, bool vec, const Args& a) {
  if (mt == 4) launch_cols<4, kSkip, kIds, kGain>(vec, a);
  else launch_cols<16, kSkip, kIds, kGain>(vec, a);
}

template <bool kSkip, bool kGain>
void launch_ids(int mt, bool vec, const Args& a) {
  if (a.plane_ids != nullptr) launch_mt<kSkip, true, kGain>(mt, vec, a);
  else launch_mt<kSkip, false, kGain>(mt, vec, a);
}

// ---- tensor-core kernel (bf16 x) --------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreadsTc = 256;  // two warpgroups dequantise; NWG of them run wgmma
constexpr int kBK = 64;          // K rows per stage (one 128-byte swizzled row of bf16)
constexpr int kRowsK = kBK / 8;  // packed byte rows per stage
constexpr int kBN = 128;         // output columns per block
constexpr int kRow = kBN + 16;   // shared-memory stride of a packed row (bank spread)
constexpr int kWBytes = kBN * kBK * 2;  // one of hi / lo: bf16 [kBN][kBK], K-major, swizzled
constexpr int kLiveRing = 2 * kThreadsTc;  // B4: per-stage plane flags kept in shared memory

template <int COLS, int NWG, bool kSkip = false>
struct Cfg {
  static constexpr int BM = NWG * 64;                      // x rows per block
  static constexpr int X_BYTES = BM * kBK * 2;             // bf16 [BM][kBK], swizzled
  static constexpr int PLANE_BYTES = COLS * kRowsK * kRow;  // uint8 [COLS][kRowsK][kRow]
  static constexpr int SIGN_BYTES = kRowsK * kRow;          // uint8 [kRowsK][kRow]
  // x first, at a 1024-byte boundary (the swizzle's period), as every stage
  static constexpr int STAGE_BYTES = (X_BYTES + PLANE_BYTES + SIGN_BYTES + 1023) / 1024 * 1024;
  // a packed stage is small, so several are kept in flight: as many slots
  // as fit (at most 6) beside two hi / lo tile pairs (one written, one read
  // by wgmma), B4's zero tile and the static arrays; two slots are the
  // stage being dequantised and the one whose wgmmas run, the rest are
  // loading
  static constexpr int ZERO_BYTES = kSkip ? 2 * kWBytes : 0;
  static constexpr int BUDGET = 232448 - 1024 - 4 * kWBytes - ZERO_BYTES - 4 * (kLiveRing + 16);
  static constexpr int SLOTS = BUDGET / STAGE_BYTES < 6 ? BUDGET / STAGE_BYTES : 6;
  static constexpr int AHEAD = SLOTS - 2;  // stages loading while one is dequantised
  static_assert(AHEAD >= 1, "too few stage slots fit in shared memory");
  static constexpr int SMEM = 1024 + SLOTS * STAGE_BYTES + 4 * kWBytes + ZERO_BYTES;
  // |w| = 2^LO_BITS * hi + lo: 7 bits where hi < 128 too (cols <= 14), so
  // both convert through the bf16 magic 128 + v; else 8 (f32 magic)
  static constexpr int LO_BITS = COLS <= 14 ? 7 : 8;
};

// Stage <- the x rows [m0, m0 + x_rows) (those below M; the kernel zeroes
// the rest of the tile once) by [kc, kc + kBK), the kRowsK packed byte rows
// from kc / 8 of every live plane and of the signs, columns [n0, n0 + kBN);
// zeros past K (the split's end) and N.  A plane whose bit of `live` is 0
// is not loaded, nor are the signs where no plane is live (B4).  kVec:
// 16-byte cp.async (N % 16 == 0, K % 8 == 0, aligned bases); otherwise
// element loads.
template <int COLS, int NWG, bool kVec>
__device__ __forceinline__ void load_stage(uint8_t* stage, const bf16* __restrict__ x,
                                           const uint8_t* __restrict__ planes,
                                           const uint8_t* __restrict__ sign, uint32_t live,
                                           int m0, int x_rows, int n0, int kc, int k_end,
                                           int k_dim, int n_cols, int cols) {
  using C = Cfg<COLS, NWG>;
  uint8_t* xs = stage;
  uint8_t* ps = stage + C::X_BYTES;
  const int kb0 = kc / 8, kb_end = (k_end + 7) / 8;
  const size_t plane_stride = (size_t)((k_dim + 7) / 8) * n_cols;
  // row block b < cols: plane b; b == cols: the signs (stored after COLS planes)
  auto src_of = [&](int b) { return b < cols ? planes + b * plane_stride : sign; };
  auto dst_of = [&](int b, int r) { return ps + ((b < cols ? b : COLS) * kRowsK + r) * kRow; };
  if (kVec) {
    constexpr int CH = kBN / 16;  // 16-byte chunks of a packed row
    for (int i = threadIdx.x; i < (cols + 1) * kRowsK * CH; i += kThreadsTc) {
      const int b = i / (kRowsK * CH), r = (i / CH) % kRowsK, c = i % CH;
      if (b < cols ? !((live >> b) & 1u) : live == 0u) continue;  // dead plane, or no plane
      const int kb = kb0 + r, n = n0 + 16 * c;
      const bool ok = kb < kb_end && n < n_cols;
      const uint8_t* src = ok ? src_of(b) + (size_t)kb * n_cols + n : sign;
      hopper::cp_async16(dst_of(b, r) + 16 * c, src, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < x_rows * (kBK / 8); i += kThreadsTc) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const int k = kc + 8 * c;
      const bool ok = k < k_end;
      const bf16* src = ok ? x + (size_t)(m0 + r) * k_dim + k : x;
      hopper::cp_async16(xs + hopper::swz128(r, c), src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < (cols + 1) * kRowsK * kBN; i += kThreadsTc) {
      const int b = i / (kRowsK * kBN), r = (i / kBN) % kRowsK, c = i % kBN;
      if (b < cols ? !((live >> b) & 1u) : live == 0u) continue;
      const int kb = kb0 + r, n = n0 + c;
      dst_of(b, r)[c] = (kb < kb_end && n < n_cols) ? src_of(b)[(size_t)kb * n_cols + n]
                                                    : (uint8_t)0;
    }
    for (int i = threadIdx.x; i < x_rows * kBK; i += kThreadsTc) {
      const int r = i / kBK, kk = i % kBK;
      const int k = kc + kk;
      *reinterpret_cast<bf16*>(xs + hopper::swz128(r, kk / 8) + 2 * (kk % 8)) =
          k < k_end ? x[(size_t)(m0 + r) * k_dim + k] : __float2bfloat16_rn(0.f);
    }
  }
}

// Exchange the bits of b under mask with the bits of a under mask << sh.
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int sh, uint32_t mask) {
  const uint32_t t = ((a >> sh) ^ b) & mask;
  b ^= t;
  a ^= t << sh;
}

// In each byte lane, the 8 x 8 bit matrix (word p, bit q) -> (word q, bit p):
// swap the off-diagonal 4 x 4 blocks, then the 2 x 2 blocks within them,
// then single bits.
__device__ __forceinline__ void transpose8(uint32_t (&w)[8]) {
  swap_bits(w[0], w[4], 4, 0x0F0F0F0Fu);
  swap_bits(w[1], w[5], 4, 0x0F0F0F0Fu);
  swap_bits(w[2], w[6], 4, 0x0F0F0F0Fu);
  swap_bits(w[3], w[7], 4, 0x0F0F0F0Fu);
  swap_bits(w[0], w[2], 2, 0x33333333u);
  swap_bits(w[1], w[3], 2, 0x33333333u);
  swap_bits(w[4], w[6], 2, 0x33333333u);
  swap_bits(w[5], w[7], 2, 0x33333333u);
  swap_bits(w[0], w[1], 1, 0x55555555u);
  swap_bits(w[2], w[3], 1, 0x55555555u);
  swap_bits(w[4], w[5], 1, 0x55555555u);
  swap_bits(w[6], w[7], 1, 0x55555555u);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// (byte c of a, byte c of b) as exact bf16 values, a in the low half, with
// the sign bits of `s` (bits 15 and 31).  Bytes < 128 (LO_BITS == 7): one
// prmt puts them under the bf16 magic 0x4300 (128; the selector's top bit
// copies a byte's zero top bit as 0x00), and s (128 + v) - s 128 = s v, in
// bf16x2.  Full bytes: f32 0x4B000000 | v minus 2^23, then cvt.rn.bf16x2.
template <int LO_BITS>
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t a, uint32_t b, int c, uint32_t s) {
  if (LO_BITS == 7) {
    const uint32_t magic = 0x43004300u | s;
    return sub_bf16x2(prmt(a, b, c | (8 | c) << 4 | (4 + c) << 8 | (12 + c) << 12) | magic,
                      magic);
  }
  const float fa = __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7540 | c)) - 8388608.f;
  const float fb = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 | c)) - 8388608.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(fa, fb);
  return *reinterpret_cast<const uint32_t*>(&h) ^ s;
}

// One thread's share of a stage: byte row kb (8 K values) of 4 columns from
// column 4 nq -> one 16-byte chunk of the hi and lo tiles per column.
// `plane_row[b]` is the stored plane of logical plane b; `live` flags
// stored planes (B4: a dead plane's words are zero).
template <int COLS, int LO_BITS>
__device__ __forceinline__ void dequant(const uint8_t* __restrict__ ps, uint8_t* w_hi,
                                        uint8_t* w_lo, const int (&plane_row)[COLS],
                                        uint32_t live, int cols) {
  const int kb = threadIdx.x & 7, nq = threadIdx.x >> 3;
  const int at = kb * kRow + 4 * nq;
  // word of logical plane b (zero past cols and for a dead plane)
  auto word = [&](int b) -> uint32_t {
    if (b >= COLS || b >= cols) return 0u;
    const int r = plane_row[b < COLS ? b : 0];
    if (!((live >> r) & 1u)) return 0u;
    return *reinterpret_cast<const uint32_t*>(ps + r * (kRowsK * kRow) + at);
  };
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    lo[b] = b < LO_BITS ? word(b) : 0u;
    hi[b] = word(b + LO_BITS);
  }
  const uint32_t sw = *reinterpret_cast<const uint32_t*>(ps + COLS * (kRowsK * kRow) + at);
  transpose8(lo);  // byte c of lo[q]: lo of K value 7 - q, column 4 nq + c
  transpose8(hi);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t sc = __byte_perm(sw, 0, 0x4440 | c);  // the sign byte of column c
    uint32_t h[4], l[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      // sign of K value 2 jj (bit 7 - 2 jj) to bit 15, of 2 jj + 1 to bit 31
      const uint32_t s = (sc * ((1u << (8 + 2 * jj)) | (1u << (25 + 2 * jj)))) & 0x80008000u;
      h[jj] = bytes_to_bf16x2<LO_BITS>(hi[7 - 2 * jj], hi[6 - 2 * jj], c, s);
      l[jj] = bytes_to_bf16x2<LO_BITS>(lo[7 - 2 * jj], lo[6 - 2 * jj], c, s);
    }
    const uint32_t off = hopper::swz128(4 * nq + c, kb);
    *reinterpret_cast<uint4*>(w_hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(w_lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], both from shared memory, K-major
// (the N = 256 form of hopper::wgmma_ss_n128).
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// y[m0:m0+BM, n0:n0+kBN] (+ split part) = scale * (2^LO_BITS (x @ s hi) + x @ s lo).
template <int COLS, int NWG, bool kVec, bool kSkip, bool kIds>
__global__ void __launch_bounds__(kThreadsTc, 1)
cim_packed_tc_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ planes,
                     const uint8_t* __restrict__ sign, const int* __restrict__ plane_ids,
                     const uint8_t* __restrict__ tile_nz, const float* __restrict__ scale,
                     float* __restrict__ dst, int m_rows, int k_dim, int n_cols, int cols,
                     int k_per_split, int apply_scale) {
  using C = Cfg<COLS, NWG, kSkip>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int inv_ids[COLS];
  __shared__ uint32_t live_s[kLiveRing];  // B4: live stored planes of stage t at t % kLiveRing
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tiles = stages + C::SLOTS * C::STAGE_BYTES;  // hi, lo of buffer 0, then of buffer 1
  uint8_t* zero_tile = tiles + 4 * kWBytes;  // B4: the hi | lo that a stage with no live plane multiplies

  const int m_tiles = (m_rows + C::BM - 1) / C::BM;
  const int grp = blockIdx.z / m_tiles;
  const int n0 = blockIdx.x * kBN, split = blockIdx.y, m0 = (blockIdx.z % m_tiles) * C::BM;
  const int x_rows = min(C::BM, m_rows - m0);  // rows of x below M
  const int k_begin = split * k_per_split;  // a multiple of kBK
  const int k_end = min(k_dim, k_begin + k_per_split);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int k_flag_tiles = (k_dim + 127) / 128;
  // this group's operands (grouped launch; group 0 of a single one)
  const size_t k_bytes = (size_t)(k_dim + 7) / 8;
  x += (size_t)grp * m_rows * k_dim;
  planes += (size_t)grp * cols * k_bytes * n_cols;
  sign += (size_t)grp * k_bytes * n_cols;
  if (kIds) plane_ids += (size_t)grp * cols;
  if (kSkip) tile_nz += (size_t)grp * cols * k_flag_tiles;
  scale += grp;
  dst += (size_t)grp * gridDim.y * m_rows * n_cols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4;

  // logical plane b is stored plane plane_row[b] (the inverse of plane_ids);
  // a slot no id fills keeps the sentinel -1
  int plane_row[COLS];
  if (kIds) {
    if (tid < COLS) inv_ids[tid] = -1;
    __syncthreads();
    const int id = tid < cols ? __ldg(plane_ids + tid) : -1;
    if (id >= 0 && id < cols) inv_ids[id] = tid;
  }
  // B4: thread i flags the live stored planes of stage t0 + i (a stage lies
  // in one 128-row flag tile)
  auto fill_live = [&](int t0) {
    const int t = t0 + tid;
    if (t >= n_tiles) return;
    const int tile = (k_begin + t * kBK) >> 7;
    uint32_t l = 0;
    for (int b = 0; b < cols; ++b)
      l |= (uint32_t)(__ldg(tile_nz + (size_t)b * k_flag_tiles + tile) != 0) << b;
    live_s[t % kLiveRing] = l;
  };
  if (kSkip) {
    fill_live(0);
    fill_live(kThreadsTc);
  }
  for (int i = tid; i < C::ZERO_BYTES / 16; i += kThreadsTc)
    reinterpret_cast<uint4*>(zero_tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  // x rows past M are zero in every slot, once
  for (int i = tid; i < C::SLOTS * (C::BM - x_rows) * 8; i += kThreadsTc) {
    const int slot = i / ((C::BM - x_rows) * 8), r = x_rows + (i / 8) % (C::BM - x_rows);
    *reinterpret_cast<uint4*>(stages + slot * C::STAGE_BYTES + r * 128 + (i % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (kIds) {
    // cols ids fill all cols slots only if they are a permutation of
    // 0 .. cols - 1 (a repeated or out-of-range id leaves a slot at -1).
    // Otherwise the block reads no plane: every output it owns (its split's
    // part of the workspace, which the reduce carries) becomes NaN.
    bool perm = true;
    for (int b = 0; b < cols; ++b) perm &= inv_ids[b] >= 0;
    if (!perm) {
      const int n_out = min(kBN, n_cols - n0);
      for (int i = tid; i < x_rows * n_out; i += kThreadsTc)
        dst[((size_t)split * m_rows + m0 + i / n_out) * n_cols + n0 + i % n_out] = __int_as_float(0x7fc00000);
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < COLS; ++b) plane_row[b] = (kIds && b < cols) ? inv_ids[b] : b;
  auto live_of = [&](int t) { return kSkip ? live_s[t % kLiveRing] : (1u << cols) - 1u; };
  auto load = [&](int t) {  // stage t into its slot (B4: its live planes only)
    if (t < n_tiles)
      load_stage<COLS, NWG, kVec>(stages + (t % C::SLOTS) * C::STAGE_BYTES, x, planes, sign,
                                  live_of(t), m0, x_rows, n0, k_begin + t * kBK, k_end, k_dim,
                                  n_cols, cols);
    cp_async_commit();  // one group a stage, empty or not
  };

  // f32 accumulators a thread: x @ [hi | lo], one 64 x 256 product (hi in
  // columns 0-127, lo in 128-255: the two tiles are adjacent, so one wgmma
  // of N = 256 a 16-deep step covers both)
  constexpr int NACC = kBN;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < C::AHEAD; ++t) load(t);
  // Stage t: loaded AHEAD iterations early into slot t % SLOTS, dequantised
  // into tile buffer t % 2, and its wgmmas run while stage t + 1 is
  // dequantised; each wgmma warpgroup waits for stage t - 1's before the
  // barrier of iteration t + 1, so the slot of stage t - 2 (= that of
  // t + AHEAD) and buffer t % 2 are free when they are written again.
  // Returns stage t's live planes once it is in and the next load is issued.
  auto begin_stage = [&](int t) {
    cp_async_wait<C::AHEAD - 1>();
    __syncthreads();  // stage t is in; stage t - 1 is dequantised, stage t - 2's wgmmas are done
    if (kSkip && t >= kThreadsTc && t % kThreadsTc == 0) {
      fill_live(t + kThreadsTc);  // over stages t - 256 .. t - 1, all done
      __syncthreads();
    }
    load(t + C::AHEAD);
    return live_of(t);
  };
  auto dequant_stage = [&](int t, uint32_t live_now) {
    uint8_t* w_hi = tiles + (t % 2) * (2 * kWBytes);
    dequant<COLS, C::LO_BITS>(stages + (t % C::SLOTS) * C::STAGE_BYTES + C::X_BYTES, w_hi,
                              w_hi + kWBytes, plane_row, live_now, cols);
  };
  // A warpgroup's role holds for the whole loop, and no branch separates a
  // wgmma from the next (a wgmma on a divergent path is serialised): a B4
  // stage with no live plane skips its plane loads and its dequantisation,
  // and its wgmmas read the zero tile, adding exact zeros.
  if (NWG == 1 && wg == 1) {  // dequantises only (M <= 64)
    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t live_now = begin_stage(t);
      if (!kSkip || live_now != 0u) dequant_stage(t, live_now);
      fence_proxy_async();  // the hi / lo and x writes, for wgmma's reads
      __syncthreads();
    }
    return;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t live_now = begin_stage(t);
    const bool live = !kSkip || live_now != 0u;
    if (live) dequant_stage(t, live_now);
    fence_proxy_async();  // the hi / lo and x writes, for wgmma's reads
    __syncthreads();
    const uint32_t xa = smem_u32(stages + (t % C::SLOTS) * C::STAGE_BYTES + wg * 64 * (2 * kBK));
    const uint32_t wa = smem_u32(live ? tiles + (t % 2) * (2 * kWBytes) : zero_tile);
    fence_regs<NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      wgmma_ss_n256(acc, desc_sw128(xa + 32 * j, 16, 1024), desc_sw128(wa + 32 * j, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // stage t - 1's wgmmas are done; stage t's run on
  }
  wgmma_wait<0>();
  fence_regs<NACC>(acc);
  // fragment i: row 16 wl + lane / 4 + 8 * ((i >> 1) & 1), column 8 (i / 4) + 2 (lane % 4) + (i & 1)
  const float s = apply_scale ? __ldg(scale) : 1.f;
  constexpr float kHiWeight = (float)(1 << C::LO_BITS);
#pragma unroll
  for (int i = 0; i < NACC / 2; ++i) {
    const int m = m0 + wg * 64 + 16 * wl + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = n0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    if (m < m_rows && n < n_cols)
      dst[((size_t)split * m_rows + m) * n_cols + n] = (kHiWeight * acc[i] + acc[NACC / 2 + i]) * s;
  }
}

template <int COLS, int NWG, bool kVec, bool kSkip, bool kIds>
cudaError_t launch(const Args& a) {
  using C = Cfg<COLS, NWG, kSkip>;
  auto kern = cim_packed_tc_kernel<COLS, NWG, kVec, kSkip, kIds>;
  static unsigned long long opted_in = 0;  // > 48 KB of shared memory, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(opted_in >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in |= 1ULL << dev;
  }
  dim3 grid((a.n + kBN - 1) / kBN, a.splits, a.groups * ((a.m + C::BM - 1) / C::BM));
  kern<<<grid, kThreadsTc, C::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const uint8_t*>(a.planes),
      static_cast<const uint8_t*>(a.sign), static_cast<const int*>(a.plane_ids),
      static_cast<const uint8_t*>(a.tile_nz), static_cast<const float*>(a.scale), a.dst, a.m,
      a.k, a.n, a.cols, a.k_per_split, a.apply_scale);
  return cudaGetLastError();
}

template <int COLS, int NWG, bool kVec, bool kSkip>
cudaError_t launch_ids(const Args& a) {
  return a.plane_ids != nullptr ? launch<COLS, NWG, kVec, kSkip, true>(a)
                                : launch<COLS, NWG, kVec, kSkip, false>(a);
}

template <int COLS, int NWG, bool kVec>
cudaError_t launch_skip(const Args& a) {
  return a.tile_nz != nullptr ? launch_ids<COLS, NWG, kVec, true>(a)
                              : launch_ids<COLS, NWG, kVec, false>(a);
}

template <int COLS, int NWG>
cudaError_t launch_vec(bool vec, const Args& a) {
  return vec ? launch_skip<COLS, NWG, true>(a) : launch_skip<COLS, NWG, false>(a);
}

template <int COLS>
cudaError_t launch_nwg(int nwg, bool vec, const Args& a) {
  return nwg == 1 ? launch_vec<COLS, 1>(vec, a) : launch_vec<COLS, 2>(vec, a);
}

}  // namespace tc

}  // namespace

// The FMA kernel, f32 x only (bf16 x runs cim_matmul_packed_tc_launch).  The
// wrapper validates shapes and pointers.  cols <= 16; k_per_split is a
// multiple of 8; mt is 4 or 16; vec requires n % 4 == 0 and 4-byte aligned
// planes and sign.  plane_ids may be null; tile_nz non-null selects B4;
// plane_gain (f32 [cols, n]) may be non-null only where tile_nz is null.
// groups >= 1 matmuls of these shapes, each operand contiguous with a
// leading group axis (groups * ceil(m / mt) <= 65535).  With splits > 1,
// ws holds f32[groups, splits, m, n].
// Returns the first CUDA error of the launches (0 on success).
extern "C" int cim_matmul_packed_launch(const void* x, const void* planes, const void* sign,
                                        const void* plane_ids, const void* tile_nz,
                                        const void* plane_gain, const void* scale, void* out,
                                        void* ws, int m, int k, int n, int cols, int groups,
                                        int mt, int vec, int splits, int k_per_split,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (plane_gain != nullptr && tile_nz != nullptr) return (int)cudaErrorInvalidValue;
  Args a{x, planes, sign, plane_ids, tile_nz, plane_gain, scale,
         splits > 1 ? (float*)ws : (float*)out,
         m, k, n, cols, splits, k_per_split, splits > 1 ? 0 : 1, groups, st};
  if (tile_nz != nullptr) launch_ids<true, false>(mt, vec != 0, a);
  else if (plane_gain != nullptr) launch_ids<false, true>(mt, vec != 0, a);
  else launch_ids<false, false>(mt, vec != 0, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  return (int)reduce_splits((const float*)ws, (const float*)scale, (float*)out, splits, m, n,
                            groups, st);
}

// The tensor-core kernel for bf16 x (the wrapper validates): cols <= 16;
// nwg 1 (M <= 64) or 2; vec requires n % 16 == 0, k % 8 == 0 and 16-byte
// aligned x, planes and sign; k_per_split a multiple of 64; plane_ids may
// be null (identity), and ids that are not a permutation of 0 .. cols - 1
// give NaN in every output element of their group; tile_nz non-null
// selects B4.  groups >= 1 as for the FMA launcher (groups *
// ceil(m / (64 nwg)) <= 65535).  With splits > 1, ws holds f32[groups,
// splits, m, n] and the fixed-order reduce scales.  Returns the first CUDA
// error of the launches (0 on success).
extern "C" int cim_matmul_packed_tc_launch(const void* x, const void* planes, const void* sign,
                                           const void* plane_ids, const void* tile_nz,
                                           const void* scale, void* out, void* ws, int m,
                                           int k, int n, int cols, int groups, int nwg, int vec,
                                           int splits, int k_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a{x, planes, sign, plane_ids, tile_nz, nullptr, scale,
         splits > 1 ? (float*)ws : (float*)out,
         m, k, n, cols, splits, k_per_split, splits > 1 ? 0 : 1, groups, st};
  const cudaError_t err = cols <= 10 ? tc::launch_nwg<10>(nwg, vec != 0, a)
                                     : tc::launch_nwg<16>(nwg, vec != 0, a);
  if (err != cudaSuccess || splits <= 1) return (int)err;
  return (int)reduce_splits((const float*)ws, (const float*)scale, (float*)out, splits, m, n,
                            groups, st);
}
