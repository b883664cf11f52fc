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
// What bounds it on this card: bytes.  Each weight is read once (4 bytes)
// and written as cols plane bytes, (4 + cols) bytes a weight (14 at
// cols 10, 71% of them writes) against 3.35 TB/s; the arithmetic, a
// rounding and a few integer operations a plane, is far below the card's
// rate.  So the design keeps bytes in flight and spends few instructions
// on each:
//   - a thread takes 16 consecutive weights of one row and issues them as
//     four 16-byte loads before any arithmetic (ld.global.nc, no L1
//     allocation: every byte is read once), 64 bytes in flight a thread;
//   - it quantises them in registers (rintf: round half to even, as
//     torch.round and jnp.round; never roundf, which rounds half away from
//     zero), and packs byte 0 (and byte 1, for cols > 8) of the four q of
//     each output word into one word (prmt), so plane b's four bits are
//     (Q >> b) & 0x01010101, and the signed bytes (0x01, or 0xFF = -1) are
//     those times 0xFF masked by the word's sign bytes;
//   - one 16-byte streaming store a plane (st.global.cs: the planes, up to
//     2.6 GB a launch, pass through the 50 MB L2 without settling), cols
//     stores per 16 weights in place of cols per weight.
// The sign is the sign bit of w; it differs from w < 0 only for -0.0 and
// NaN, whose q is 0 (fmaxf(NaN, 0) = 0), so every output byte is the same.
//
// Indexing: grid (ceil(K * ceil(N / 16) / 256), min(L, 65535)); x walks the
// 16-weight chunks of one layer, y the layers (a grid-stride loop past
// 65535).  Where N % 16 == 0 and w is 16-byte aligned (the vector path),
// chunk u of a layer starts at element 16u of that layer of w and of each
// of its planes, so a thread needs no division; otherwise (ragged N, or w
// a view at an offset) it takes row u / ceil(N / 16) (one 32-bit division
// where the layer has < 2^32 chunks), loads element by element and stores
// byte by byte, masked to the row.  Offsets are 64-bit: a plane stack
// past 2^31 bytes (yi-6b's head at cols 10 writes 2.6 GB) is addressed
// directly.  `cols` is a template parameter (1 .. 16), so the plane loop
// unrolls.  kernels/bitslice/ops.py::launch_plan computes the grid and
// mirrors this index math for the CPU tests.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // consecutive weights of one row a thread
constexpr int kMaxCols = 16;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float4 load_once(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// The four bytes `sel` (0x0040: byte 0, 0x0051: byte 1, 0x0073: byte 3) of
// a, b, c, d, in that order, in one word.
__device__ __forceinline__ uint32_t gather4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                            uint32_t sel) {
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}

template <int COLS, bool kVec>
__global__ void __launch_bounds__(kThreads)
bitslice_kernel(const float* __restrict__ w, const float* __restrict__ inv_scale,
                int8_t* __restrict__ out, long long layers, long long k, long long n,
                long long chunks) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;  // chunk of a layer
  const long long per_layer = k * chunks;
  if (u >= per_layer) return;
  const long long plane = k * n;  // elements of a plane, and of a layer of w
  long long at = (long long)kChunk * u;  // the chunk's element inside a layer and a plane
  int valid = kChunk;
  if (!kVec) {
    const long long row = per_layer <= 0xffffffffLL
                              ? (long long)((unsigned)u / (unsigned)chunks)
                              : u / chunks;
    const long long c0 = kChunk * (u - row * chunks);
    at = row * n + c0;
    valid = (int)min((long long)kChunk, n - c0);
  }
  const float inv = __ldg(inv_scale);
  constexpr float kLevels = (float)((1 << COLS) - 1);
  for (long long layer = blockIdx.y; layer < layers; layer += gridDim.y) {
    const float* src = w + layer * plane + at;
    int8_t* dst = out + layer * COLS * plane + at;
    float v[kChunk];
    if (kVec) {
#pragma unroll
      for (int i = 0; i < kChunk / 4; ++i) {
        const float4 t = load_once(src + 4 * i);
        v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = i < valid ? __ldg(src + i) : 0.f;
    }
    // word j of a plane holds weights 4j .. 4j + 3 (byte i = weight 4j + i)
    uint32_t lo[4], hi[4], sign[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t q[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = v[4 * j + i];
        q[i] = (uint32_t)fminf(fmaxf(rintf(fabsf(x) * inv), 0.f), kLevels);
        s[i] = __float_as_uint(x);
      }
      lo[j] = gather4(q[0], q[1], q[2], q[3], 0x0040);
      hi[j] = COLS > 8 ? gather4(q[0], q[1], q[2], q[3], 0x0051) : 0u;
      const uint32_t neg = (gather4(s[0], s[1], s[2], s[3], 0x0073) >> 7) & 0x01010101u;
      sign[j] = neg * 0xFEu | 0x01010101u;  // per byte 0x01, or 0xFF where w is negative
    }
#pragma unroll
    for (int b = 0; b < COLS; ++b) {
      uint32_t word[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t bits = (b < 8 ? lo[j] >> b : hi[j] >> (b - 8)) & 0x01010101u;
        word[j] = (bits * 0xFFu) & sign[j];
      }
      int8_t* p = dst + b * plane;
      if (kVec) {
        __stcs(reinterpret_cast<int4*>(p),
               make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]));
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (i < valid) p[i] = (int8_t)(word[i / 4] >> (8 * (i % 4)));
      }
    }
  }
}

struct Args {
  const float* w;
  const float* inv_scale;
  int8_t* out;
  long long layers, k, n, chunks, blocks_x;
  int blocks_y;
  bool vec;
  cudaStream_t stream;
};

template <int COLS>
cudaError_t launch(const Args& a) {
  const dim3 grid((unsigned)a.blocks_x, (unsigned)a.blocks_y);
  if (a.vec)
    bitslice_kernel<COLS, true><<<grid, kThreads, 0, a.stream>>>(a.w, a.inv_scale, a.out,
                                                                 a.layers, a.k, a.n, a.chunks);
  else
    bitslice_kernel<COLS, false><<<grid, kThreads, 0, a.stream>>>(a.w, a.inv_scale, a.out,
                                                                  a.layers, a.k, a.n, a.chunks);
  return cudaGetLastError();
}

template <int COLS>
cudaError_t dispatch(int cols, const Args& a) {
  if constexpr (COLS > kMaxCols) {
    return cudaErrorInvalidValue;
  } else {
    return cols == COLS ? launch<COLS>(a) : dispatch<COLS + 1>(cols, a);
  }
}

}  // namespace

// w f32 [layers * k, n] contiguous -> out int8 [layers, cols, k, n], with
// the grid of kernels/bitslice/ops.py::launch_plan: chunks = ceil(n / 16),
// blocks_x = ceil(k * chunks / 256), blocks_y = min(layers, 65535); vec
// requires n % 16 == 0 and 16-byte aligned w and out.  Returns the launch's
// CUDA error (0 on success).
extern "C" int bitslice_launch(const void* w, const void* inv_scale, void* out,
                               long long layers, long long k, long long n, int cols,
                               long long chunks, long long blocks_x, int blocks_y, int vec,
                               void* stream) {
  if (cols < 1 || cols > kMaxCols || k <= 0 || n <= 0 || layers <= 0) return cudaErrorInvalidValue;
  if (chunks != (n + kChunk - 1) / kChunk || blocks_x > 0x7fffffffLL ||
      blocks_x != (k * chunks + kThreads - 1) / kThreads ||
      blocks_y != (layers < kMaxGridY ? layers : kMaxGridY))
    return cudaErrorInvalidValue;
  if (vec && (n % kChunk != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(w), static_cast<const float*>(inv_scale),
               static_cast<int8_t*>(out), layers, k, n, chunks, blocks_x, blocks_y, vec != 0,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch<1>(cols, a);
}
