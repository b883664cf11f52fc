// Int8-plane CIM matmul for Hopper: y = scale * sum_b 2^b * (x @ P_b).
//
// Replaces the TPU kernel
// repro/kernels/cim_matmul/kernel.py::cim_matmul_kernel (body _kernel),
// both modes:
//   fused_dequant  rebuild the integer weight sum_b 2^b P_b in registers,
//                  then one f32 FMA dot (what --materialize planes_int8
//                  serves);
//   planes         one dot per plane over each 128-row K chunk, the partial
//                  sums weighted by 2^b (the crossbar's per-column dataflow;
//                  a parity oracle).
// Operands:
//   x        f32 or bf16 [M, K]
//   splanes  int8 [cols, K, N], values in {-1, 0, 1} (sign folded in),
//            plane 0 = LSB
//   scale    f32 scalar (device pointer)
//   out      f32 [M, N]
//
// What bounds it: at decode (M = batch) the plane bytes, cols * K * N (one
// byte per bit cell) over 3.35 TB/s; at prefill (M = 128) the f32
// multiply-adds, 2 * M * K * N over 67 TFLOP/s.  Tensor cores are not used,
// for the reason csrc/cim_matmul.cu gives: bf16 does not hold the integer
// weights up to 2^cols - 1 exactly, TF32 not an f32 x.
//
// Design (the layout of csrc/cim_matmul.cu, without the bit unpack): each
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
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * k_per_split;
  const int k_end = min(k_dim, k_begin + k_per_split);
  const size_t plane_stride = (size_t)k_dim * n_cols;
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
  const void *x, *splanes, *scale;
  float* dst;
  int m, k, n, cols, splits, k_per_split, apply_scale;
  cudaStream_t stream;
};

template <typename XT, int MT, int COLS, bool kVec, bool kPlanes>
void launch_main(const Args& a) {
  const int col_groups = (a.n + kCols - 1) / kCols;
  dim3 grid((col_groups + kThreads - 1) / kThreads, a.splits, (a.m + MT - 1) / MT);
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

template <bool kPlanes>
void launch_x(bool bf16, int mt, bool vec, const Args& a) {
  if (bf16) launch_mt<__nv_bfloat16, kPlanes>(mt, vec, a);
  else launch_mt<float, kPlanes>(mt, vec, a);
}

}  // namespace

// The wrapper validates shapes and pointers.  cols <= 16; mt is 4 or 16;
// vec requires n % 4 == 0 and 4-byte aligned planes; planes_mode selects
// the per-plane oracle.  With splits > 1, ws holds f32[splits, m, n].
// Returns the first CUDA error of the launches (0 on success).
extern "C" int cim_planes_launch(const void* x, int x_is_bf16, const void* splanes,
                                 const void* scale, void* out, void* ws, int m, int k, int n,
                                 int cols, int mt, int vec, int planes_mode, int splits,
                                 int k_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Args a{x, splanes, scale, splits > 1 ? (float*)ws : (float*)out,
         m, k, n, cols, splits, k_per_split, splits > 1 ? 0 : 1, st};
  if (planes_mode) launch_x<true>(x_is_bf16 != 0, mt, vec != 0, a);
  else launch_x<false>(x_is_bf16 != 0, mt, vec != 0, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const long long mn = (long long)m * n;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0, st>>>(
      (const float*)ws, (const float*)scale, (float*)out, splits, mn);
  return (int)cudaGetLastError();
}
