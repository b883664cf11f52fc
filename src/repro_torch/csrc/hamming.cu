// Packed Hamming transition counting (Eq. 1 of the paper) for Hopper.
//
// Replaces the TPU kernel repro/kernels/hamming/kernel.py::hamming_pairs_kernel
// (body _kernel): out[t] = sum popcount(a[t] ^ b[t]) over one reprogramming
// pair's packed section planes uint8[W, C] (W = ceil(rows/8), C = bit columns).
//
// What bounds it: memory.  Each pair is 2 * W * C bytes in (160 bytes at the
// paper's 128x10 crossbars) and 4 bytes out, with three integer operations
// per 16 bytes, so the least time is 2*T*W*C bytes over the card's 3.35 TB/s.
//
// Design: a block owns 256 consecutive pairs, i.e. one contiguous stretch of
// both operands.  Its threads stream that stretch in 16-byte loads, with
// neighbouring threads on neighbouring addresses, XOR the words, popcount
// them with __popc, and add each load's count into its pair's slot in
// shared memory.  One coalesced store per pair writes the result.  The
// wrapper guarantees 16-byte aligned operands whose pair size is a multiple
// of 16 bytes (it zero-pads the pair otherwise: zero bytes cost nothing).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairsPerBlock = 256;

__global__ void __launch_bounds__(kPairsPerBlock)
hamming_pairs_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                     int* __restrict__ out, long long n_pairs, int vec_per_pair) {
  __shared__ int acc[kPairsPerBlock];
  const long long pair0 = (long long)blockIdx.x * kPairsPerBlock;
  const long long left = n_pairs - pair0;
  const int n_here = left < kPairsPerBlock ? (int)left : kPairsPerBlock;
  acc[threadIdx.x] = 0;
  __syncthreads();
  const long long base = pair0 * vec_per_pair;
  const int n_vec = n_here * vec_per_pair;
  for (int i = threadIdx.x; i < n_vec; i += kPairsPerBlock) {
    const uint4 x = __ldg(a + base + i);
    const uint4 y = __ldg(b + base + i);
    const int c = __popc(x.x ^ y.x) + __popc(x.y ^ y.y) + __popc(x.z ^ y.z) +
                  __popc(x.w ^ y.w);
    atomicAdd(&acc[i / vec_per_pair], c);
  }
  __syncthreads();
  if (threadIdx.x < n_here) out[pair0 + threadIdx.x] = acc[threadIdx.x];
}

}  // namespace

// a, b: uint8[n_pairs, vec_per_pair * 16], 16-byte aligned; out: int32[n_pairs].
// Returns the CUDA error of the launch (0 on success).
extern "C" int hamming_pairs_launch(const void* a, const void* b, void* out,
                                    long long n_pairs, int vec_per_pair,
                                    void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kPairsPerBlock - 1) / kPairsPerBlock;
  hamming_pairs_kernel<<<(unsigned)blocks, kPairsPerBlock, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (int*)out, n_pairs, vec_per_pair);
  return (int)cudaGetLastError();
}
