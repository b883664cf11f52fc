// Bit-packed CIM matmul for Hopper: y = scale * (x @ (sign * sum_b 2^b bits_b)).
//
// Replaces the TPU kernel
// repro/kernels/cim_matmul/kernel.py::cim_matmul_packed_kernel (bodies
// _packed_kernel and _unpack_bits).  Operands are the serving layout of
// repro_torch.core.bitslice.pack_linear_planes / pack_linear_sign:
//   x       f32 or bf16 [M, K]
//   planes  uint8 [cols, ceil(K/8), N], plane 0 = LSB, K packed MSB-first
//   sign    uint8 [ceil(K/8), N], bit 1 = negative weight
//   scale   f32 scalar (device pointer)
//   out     f32 [M, N]
//
// What bounds it: at decode (M = batch) the packed weight bytes,
// (cols + 1) / 8 * K * N, over 3.35 TB/s; at prefill (M = 128) the f32
// multiply-adds, 2 * M * K * N over 67 TFLOP/s.  Tensor cores are not used:
// bf16 does not hold magnitudes up to 2^cols - 1 exactly, and TF32 does not
// hold an f32 x exactly, so the product is plain f32 FMA on exact integer
// weights.
//
// Design: each thread owns 4 adjacent output columns (one 32-bit load per
// plane per byte row: a warp reads 128 contiguous bytes of each plane) and
// MT rows of x.  It rebuilds the 4 x 8 integer magnitudes of a byte row in
// registers, applies the signs and accumulates in f32 FMA; x is staged in
// shared memory as f32, so bf16 activations are converted once per block.
// The weights are read once per M tile (MT = 4 at decode, 16 at prefill).
// Gemma's narrow matrices (N = 256 or 2048) have too few column blocks to
// fill 132 SMs, so K is split across blocks: each split writes an f32
// partial to a workspace and a second pass sums the partials in a fixed
// order, so repeated runs give identical results (no float atomics).
// Ragged N is masked with byte loads; ragged K needs nothing, since padded
// K bits are zero and the staged x is zero past K.

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

template <typename XT, int MT, int COLS, bool kVec>
__global__ void __launch_bounds__(kThreads)
cim_packed_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ planes,
                  const uint8_t* __restrict__ sign, const float* __restrict__ scale,
                  float* __restrict__ dst, int m_rows, int k_dim, int n_cols,
                  int cols, int k_per_split, int apply_scale) {
  __shared__ float xs[MT][kKChunk];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * k_per_split;  // a multiple of 8
  const int k_end = min(k_dim, k_begin + k_per_split);
  const int k_bytes = (k_dim + 7) / 8;
  const bool live = n0 < n_cols;

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
    for (int k = kc; k < k_stop; k += 8) {
      const int kb = k >> 3;
      uint32_t pw[COLS];
#pragma unroll
      for (int b = 0; b < COLS; ++b)
        pw[b] = b < cols ? load4<kVec>(planes + ((size_t)b * k_bytes + kb) * n_cols, n0, n_cols)
                         : 0u;
      const uint32_t sw = load4<kVec>(sign + (size_t)kb * n_cols, n0, n_cols);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bit = 7 - j;  // K value k + j is bit 7 - j of its byte
        float xv[MT];
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) xv[mm] = xs[mm][k - kc + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int sh = 8 * c + bit;
          uint32_t mag = 0;
#pragma unroll
          for (int b = 0; b < COLS; ++b) mag |= ((pw[b] >> sh) & 1u) << b;
          const float w = ((sw >> sh) & 1u) ? -(float)mag : (float)mag;
#pragma unroll
          for (int mm = 0; mm < MT; ++mm) acc[mm][c] = fmaf(xv[mm], w, acc[mm][c]);
        }
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

template <typename XT, int MT, int COLS, bool kVec>
void launch_main(const void* x, const void* planes, const void* sign, const void* scale,
                 float* dst, int m, int k, int n, int cols, int splits, int k_per_split,
                 int apply_scale, cudaStream_t stream) {
  const int col_groups = (n + kCols - 1) / kCols;
  dim3 grid((col_groups + kThreads - 1) / kThreads, splits, (m + MT - 1) / MT);
  cim_packed_kernel<XT, MT, COLS, kVec><<<grid, kThreads, 0, stream>>>(
      (const XT*)x, (const uint8_t*)planes, (const uint8_t*)sign, (const float*)scale,
      dst, m, k, n, cols, k_per_split, apply_scale);
}

template <typename XT, int MT>
void launch_cols(bool vec, int cols, const void* x, const void* planes, const void* sign,
                 const void* scale, float* dst, int m, int k, int n, int splits,
                 int k_per_split, int apply_scale, cudaStream_t stream) {
  if (cols == 10) {
    if (vec) launch_main<XT, MT, 10, true>(x, planes, sign, scale, dst, m, k, n, cols, splits, k_per_split, apply_scale, stream);
    else launch_main<XT, MT, 10, false>(x, planes, sign, scale, dst, m, k, n, cols, splits, k_per_split, apply_scale, stream);
  } else {
    if (vec) launch_main<XT, MT, 16, true>(x, planes, sign, scale, dst, m, k, n, cols, splits, k_per_split, apply_scale, stream);
    else launch_main<XT, MT, 16, false>(x, planes, sign, scale, dst, m, k, n, cols, splits, k_per_split, apply_scale, stream);
  }
}

template <typename XT>
void launch_x(int mt, bool vec, int cols, const void* x, const void* planes, const void* sign,
              const void* scale, float* dst, int m, int k, int n, int splits,
              int k_per_split, int apply_scale, cudaStream_t stream) {
  if (mt == 4) launch_cols<XT, 4>(vec, cols, x, planes, sign, scale, dst, m, k, n, splits, k_per_split, apply_scale, stream);
  else launch_cols<XT, 16>(vec, cols, x, planes, sign, scale, dst, m, k, n, splits, k_per_split, apply_scale, stream);
}

}  // namespace

// The wrapper validates shapes and pointers.  cols <= 16; k_per_split is a
// multiple of 8; mt is 4 or 16; vec requires n % 4 == 0 and 4-byte aligned
// planes and sign.  With splits > 1, ws holds f32[splits, m, n].
// Returns the first CUDA error of the launches (0 on success).
extern "C" int cim_matmul_packed_launch(const void* x, int x_is_bf16, const void* planes,
                                        const void* sign, const void* scale, void* out,
                                        void* ws, int m, int k, int n, int cols, int mt,
                                        int vec, int splits, int k_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = splits > 1 ? (float*)ws : (float*)out;
  const int apply_scale = splits > 1 ? 0 : 1;
  if (x_is_bf16)
    launch_x<__nv_bfloat16>(mt, vec != 0, cols, x, planes, sign, scale, dst, m, k, n, splits, k_per_split, apply_scale, st);
  else
    launch_x<float>(mt, vec != 0, cols, x, planes, sign, scale, dst, m, k, n, splits, k_per_split, apply_scale, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const long long mn = (long long)m * n;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0, st>>>(
      (const float*)ws, (const float*)scale, (float*)out, splits, mn);
  return (int)cudaGetLastError();
}
