// Stable ascending argsort of a weight tensor by its SWS key, for Hopper.
//
// Replaces no TPU kernel.  The reference sorts on the host
// (repro/core/sws.py: a pure_callback around numpy's stable argsort); the
// port's planner sorts on the card, and torch.sort(stable=True) keeps int64
// indices and its own copies of keys and values, ~30 bytes a weight in
// flight.  This helper keeps 16: two uint32 key buffers and two int32
// index buffers, ping-ponged by CUB's DeviceRadixSort over a DoubleBuffer.
//
// Keys: sign_magnitude sorts by |w| + 0.0, whose bits are the weight's with
// the sign bit cleared; offset_binary sorts by w + 0.0 (-0.0 becomes +0.0),
// flipped so that unsigned order is float order (negative: all bits
// inverted; non-negative: the sign bit set).  Slots past n are the zero
// padding of the last section and take the key of +0.0.  Radix sort is
// stable, so ties keep source order: the permutation equals
// torch.sort(stable=True)'s on the float keys.
//
// What bounds it: memory.  Four 8-bit passes over 32-bit keys each read and
// write keys and indices (16 bytes a slot a pass), plus one key-building
// pass (4 bytes read, 8 written), so the least time is ~72 bytes a slot over
// the card's 3.35 TB/s.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sws_keys_kernel(const uint32_t* __restrict__ w_bits, uint32_t* __restrict__ keys,
                int* __restrict__ idx, long long n, long long n_total, int offset_binary) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n_total; i += stride) {
    uint32_t b = i < n ? __ldg(w_bits + i) : 0u;
    uint32_t k;
    if (offset_binary) {
      if (b == 0x80000000u) b = 0u;  // -0.0 + 0.0 == +0.0
      k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    } else {
      k = b & 0x7fffffffu;
    }
    keys[i] = k;
    idx[i] = (int)i;
  }
}

}  // namespace

// Bytes of CUB scratch the sort of n_total slots needs (written to *bytes).
extern "C" int sws_sort_temp_bytes(long long n_total, unsigned long long* bytes) {
  size_t need = 0;
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  cudaError_t err = cub::DeviceRadixSort::SortPairs(nullptr, need, keys, vals, (int)n_total);
  *bytes = need;
  return (int)err;
}

// w: float32[n] as bits; keys0/keys1: uint32[n_total]; idx0/idx1:
// int32[n_total]; temp: the scratch sws_sort_temp_bytes asked for.  On
// return *selector says which index buffer holds the permutation (0: idx0).
// n_total < 2^31.  Returns the CUDA error of the launches (0 on success).
extern "C" int sws_argsort_launch(const void* w, void* keys0, void* keys1, void* idx0,
                                  void* idx1, void* temp, unsigned long long temp_bytes,
                                  long long n, long long n_total, int offset_binary,
                                  int* selector, void* stream) {
  *selector = 0;
  if (n_total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n_total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  sws_keys_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const uint32_t*)w, (uint32_t*)keys0, (int*)idx0, n, n_total, offset_binary);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cub::DoubleBuffer<uint32_t> keys((uint32_t*)keys0, (uint32_t*)keys1);
  cub::DoubleBuffer<int> vals((int*)idx0, (int*)idx1);
  size_t bytes = (size_t)temp_bytes;
  err = cub::DeviceRadixSort::SortPairs(temp, bytes, keys, vals, (int)n_total, 0, 32, s);
  if (err != cudaSuccess) return (int)err;
  *selector = vals.selector;
  return (int)cudaGetLastError();
}
