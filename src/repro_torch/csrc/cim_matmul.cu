// Bit-packed CIM matmul for Hopper: y = scale * (x @ (sign * sum_p 2^id[p] bits_p)).
//
// Two kernels, one template:
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
//   tile_nz   uint8 [cols, ceil(K/128)] (B4 only): 0 = the (plane, K block)
//             tile is zero across all N
//   scale     f32 scalar (device pointer)
//   out       f32 [M, N]
//
// What bounds it: at decode (M = batch) the packed weight bytes,
// (cols + 1) / 8 * K * N (B4: the flagged-live tiles only), over 3.35 TB/s;
// at prefill (M = 128) the f32 multiply-adds, 2 * M * K * N over 67 TFLOP/s.
// Tensor cores are not used: bf16 does not hold magnitudes up to
// 2^cols - 1 exactly, and TF32 does not hold an f32 x exactly, so the
// product is plain f32 FMA on exact integer weights.
//
// Design: each thread owns 4 adjacent output columns (one 32-bit load per
// plane per byte row: a warp reads 128 contiguous bytes of each plane) and
// MT rows of x.  Per byte row it rebuilds the 4 x 8 integer magnitudes in
// registers, applies the signs and accumulates in f32 FMA; x is staged in
// shared memory as f32, so bf16 activations are converted once per block.
// B4 reads its flags once per 128-row tile (the same for the whole warp); a
// tile with every plane live takes B2's path, one with dead planes loads and
// unpacks the live planes only.  The magnitudes are exact integers however
// they are built, and the FMA order is the same on every path, so B2 and B4
// agree bit for bit.  The dead-plane path saves loads but unpacks plane by
// plane into a 32-register magnitude array, which costs more per live plane
// than B2's unpack.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W
// (2048 x 16384), at 25% zero tiles B4 takes 0.97-1.14x B2's time at decode
// (M = 4; it varies from run to run) and 1.07x at prefill (M = 128); from
// 50% zero tiles on it is faster at both.  So skipping pays once about half
// the tiles are dead.  Operands whose every tile is live (const_rle on
// random weights) take B2's path and do not see this.  plane_ids makes the
// bit positions runtime values, so it is a template flag: without it they
// are constants the compiler folds.  The weights are read once per M tile
// (MT = 4 at decode, 16 at prefill).  Gemma's narrow matrices (N = 256 or 2048)
// have too few column blocks to fill 132 SMs, so K is split across blocks:
// each split writes an f32 partial to a workspace and a second pass sums the
// partials in a fixed order, so repeated runs give identical results (no
// float atomics).  Split boundaries are multiples of 8, not of 128, so B4
// indexes its flags by absolute K row / 128.  Ragged N is masked with byte
// loads; ragged K needs nothing, since padded K bits are zero and the staged
// x is zero past K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kCols = 4;       // output columns per thread
constexpr int kKChunk = 128;   // K values of x staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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
// magnitude of weight (j, c) as mag(j, c).  The FMA order (j, c, mm) is the
// same for every way of building the magnitudes, so B2 and B4 agree.
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
      const uint32_t m = mag(j, c, sh);
      const float w = ((sw >> sh) & 1u) ? -(float)m : (float)m;
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) acc[mm][c] = fmaf(xv[mm], w, acc[mm][c]);
    }
  }
}

template <typename XT, int MT, int COLS, bool kVec, bool kSkip, bool kIds>
__global__ void __launch_bounds__(kThreads)
cim_packed_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ planes,
                  const uint8_t* __restrict__ sign, const int* __restrict__ plane_ids,
                  const uint8_t* __restrict__ tile_nz, const float* __restrict__ scale,
                  float* __restrict__ dst, int m_rows, int k_dim, int n_cols,
                  int cols, int k_per_split, int apply_scale) {
  __shared__ float xs[MT][kKChunk];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * k_per_split;  // a multiple of 8
  const int k_end = min(k_dim, k_begin + k_per_split);
  const int k_bytes = (k_dim + 7) / 8;
  const int k_tiles = (k_bytes + 15) / 16;  // flags per plane (B4)
  const bool live = n0 < n_cols;

  // stored plane b's bit position in the magnitude: b, or plane_ids[b]
  int weight_bit[COLS];
#pragma unroll
  for (int b = 0; b < COLS; ++b) weight_bit[b] = (kIds && b < cols) ? __ldg(plane_ids + b) : b;

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
      xs[mm][kk] = (m < m_rows && k < k_end) ? to_f32(x[(size_t)m * k_dim + k]) : 0.f;
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
        fma_row<MT>(acc, xs, k - kc, sw, [&](int, int, int sh) {
          uint32_t m = 0;
#pragma unroll
          for (int b = 0; b < COLS; ++b) m |= ((pw[b] >> sh) & 1u) << (kIds ? weight_bit[b] : b);
          return m;
        });
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

// out[i] = scale * sum_{s < splits} ws[s][i], summed in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int splits, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += ws[(size_t)s * mn + i];
  out[i] = acc * __ldg(scale);
}

struct Args {
  const void *x, *planes, *sign, *plane_ids, *tile_nz, *scale;
  float* dst;
  int m, k, n, cols, splits, k_per_split, apply_scale;
  cudaStream_t stream;
};

template <typename XT, int MT, int COLS, bool kVec, bool kSkip, bool kIds>
void launch_main(const Args& a) {
  const int col_groups = (a.n + kCols - 1) / kCols;
  dim3 grid((col_groups + kThreads - 1) / kThreads, a.splits, (a.m + MT - 1) / MT);
  cim_packed_kernel<XT, MT, COLS, kVec, kSkip, kIds><<<grid, kThreads, 0, a.stream>>>(
      (const XT*)a.x, (const uint8_t*)a.planes, (const uint8_t*)a.sign,
      (const int*)a.plane_ids, (const uint8_t*)a.tile_nz, (const float*)a.scale,
      a.dst, a.m, a.k, a.n, a.cols, a.k_per_split, a.apply_scale);
}

template <typename XT, int MT, int COLS, bool kSkip, bool kIds>
void launch_vec(bool vec, const Args& a) {
  if (vec) launch_main<XT, MT, COLS, true, kSkip, kIds>(a);
  else launch_main<XT, MT, COLS, false, kSkip, kIds>(a);
}

template <typename XT, int MT, bool kSkip, bool kIds>
void launch_cols(bool vec, const Args& a) {
  if (a.cols == 10) launch_vec<XT, MT, 10, kSkip, kIds>(vec, a);
  else launch_vec<XT, MT, 16, kSkip, kIds>(vec, a);
}

template <typename XT, bool kSkip, bool kIds>
void launch_mt(int mt, bool vec, const Args& a) {
  if (mt == 4) launch_cols<XT, 4, kSkip, kIds>(vec, a);
  else launch_cols<XT, 16, kSkip, kIds>(vec, a);
}

template <bool kSkip, bool kIds>
void launch_x(bool bf16, int mt, bool vec, const Args& a) {
  if (bf16) launch_mt<__nv_bfloat16, kSkip, kIds>(mt, vec, a);
  else launch_mt<float, kSkip, kIds>(mt, vec, a);
}

template <bool kSkip>
void launch_ids(bool bf16, int mt, bool vec, const Args& a) {
  if (a.plane_ids != nullptr) launch_x<kSkip, true>(bf16, mt, vec, a);
  else launch_x<kSkip, false>(bf16, mt, vec, a);
}

}  // namespace

// The wrapper validates shapes and pointers.  cols <= 16; k_per_split is a
// multiple of 8; mt is 4 or 16; vec requires n % 4 == 0 and 4-byte aligned
// planes and sign.  plane_ids may be null; tile_nz non-null selects B4.
// With splits > 1, ws holds f32[splits, m, n].
// Returns the first CUDA error of the launches (0 on success).
extern "C" int cim_matmul_packed_launch(const void* x, int x_is_bf16, const void* planes,
                                        const void* sign, const void* plane_ids,
                                        const void* tile_nz, const void* scale, void* out,
                                        void* ws, int m, int k, int n, int cols, int mt,
                                        int vec, int splits, int k_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a{x, planes, sign, plane_ids, tile_nz, scale,
         splits > 1 ? (float*)ws : (float*)out,
         m, k, n, cols, splits, k_per_split, splits > 1 ? 0 : 1, st};
  if (tile_nz != nullptr) launch_ids<true>(x_is_bf16 != 0, mt, vec != 0, a);
  else launch_ids<false>(x_is_bf16 != 0, mt, vec != 0, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const long long mn = (long long)m * n;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0, st>>>(
      (const float*)ws, (const float*)scale, (float*)out, splits, mn);
  return (int)cudaGetLastError();
}
