// Kernel B6: fused quantize + signed bit-plane slice, for sm_90a.
//
// Replaces the Pallas TPU kernel `bitslice_kernel` (body `_kernel`,
// src/repro/kernels/bitslice/kernel.py).  Same contract:
//   q = clip(round(|w| * inv_scale), 0, 2^cols - 1)   (round half to even)
//   out[b] = ((q >> b) & 1) * (w < 0 ? -1 : 1)        int8, plane 0 = LSB
// for w f32 [L, K, N] (L stacked layers sharing one scale; L = 1 for a
// single tensor) into out int8 [L, cols, K, N], so a stacked tensor's
// planes land in the serving operand layout without a transpose.
// `inv_scale` is one f32 on the card (no host round trip).
//
// Design: one thread per weight reads 4 bytes and writes its `cols` plane
// bytes, which sit K*N apart; neighbouring threads hold neighbouring
// columns, so every load and every plane's store is coalesced.  The
// intermediate q never reaches device memory.  Rounding is rintf (the
// current rounding mode, round half to even, as jnp.round and torch.round),
// not roundf, which rounds half away from zero.  Bound on this card: bytes,
// (4 + cols) per weight against 3.35 TB/s.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitslice_kernel(const float* __restrict__ w, const float* __restrict__ inv_scale,
                int8_t* __restrict__ out, long long total, long long k, long long n,
                int cols) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float x = w[i];
  const float levels = (float)((1 << cols) - 1);
  const int q = (int)fminf(fmaxf(rintf(fabsf(x) * *inv_scale), 0.f), levels);
  const int sign = x < 0.f ? -1 : 1;
  const long long plane = k * n;  // stride between planes
  const long long row = i / n, col = i - row * n;
  const long long layer = row / k, kr = row - layer * k;
  int8_t* o = out + layer * cols * plane + kr * n + col;
  for (int b = 0; b < cols; ++b) o[b * plane] = (int8_t)(((q >> b) & 1) * sign);
}

}  // namespace

// w f32 [layers * k, n] contiguous -> out int8 [layers, cols, k, n].
extern "C" int bitslice_launch(const void* w, const void* inv_scale, void* out,
                               long long layers, long long k, long long n, int cols,
                               void* stream) {
  if (cols < 1 || cols > 16 || k <= 0 || n <= 0 || layers <= 0) return cudaErrorInvalidValue;
  const long long total = layers * k * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bitslice_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(inv_scale),
      static_cast<int8_t*>(out), total, k, n, cols);
  return cudaGetLastError();
}
