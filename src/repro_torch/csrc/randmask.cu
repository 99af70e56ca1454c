// The paper's random element mask for Hopper: the dense compressing wire's
// Bernoulli(p) mask drawn from the shared Threefry key stream, applied in
// one pass.
//
//   out[q, i] = mask(q, i) ? x[q, i] * scale : 0
//   mask(q, i) = uniform(key[q], i + offset) < p
//   uniform(key, c) = float((bits >> 9) | 0x3F800000) - 1,
//   bits = y0 ^ y1, (y0, y1) = threefry2x32(key, (c >> 32, c & 0xffffffff))
//
// x is [Q, N] (a worker's [B, F] block flattened; f32, or bf16 where the
// mask compresses a bf16 LM gradient leaf: out = bf16(x * bf16(scale)),
// the exact f32 product rounded once), keys [Q, 2] uint32, one
// key per worker, and the counter c is the element's flat index inside
// its worker's block plus offset: bitwise jax.random.bernoulli(key, p,
// (B, F)) in the partitionable Threefry layout (jax's default), vmapped
// over workers.  Optionally counts[q] += kept elements of worker q (the
// compressor's wire bits).
//
// No TPU kernel corresponds: the JAX package leaves this mask to XLA
// (repro/core/compression.py::_random_mask).  It is a kernel here
// because the mask is one 20-round hash per activation, 45M per exchange
// at the paper's width, which plain PyTorch would spend over a hundred
// elementwise passes on.
//
// What bounds it: bytes and integer operations about equally.  Per
// element 76 32-bit integer ops (20 rounds of add, rotate, xor; the key
// injections; the conversion and compare) against 8 bytes moved (read x,
// write out).  At the SM's issue ceiling (128 integer results a clock:
// the ALU pipe's adds, logic and shifts and the FMA pipe's IMADs) the
// ops of the path's [4, 44227, 256] block take 0.103 ms on an H100, its
// bytes 0.108 ms.
//
// In bf16 (granite's [1, 49155 * 2048] embedding gradient) the bytes halve
// to 4 an element and the integer operations bound it: 0.23 ms against
// 0.12 ms of bytes at that shape.
//
// Design: a thread takes 4 consecutive elements (one 16-byte load and
// store in f32, 8-byte in bf16; four independent hashes to hide the ALU
// latency); rotations are
// single funnel shifts; blockIdx.y is the worker, so a block loads one key
// and its threads grid-stride over that worker's N elements; kept counts
// are summed per thread, then per warp, one atomic per warp.
//
// random_uniform draws the same stream as floats, for the uniforms of
// stochastic rounding where the width map mixes fp32 and quantised pairs:
//
//   out[b, i] = uniform(key[b], i + offset)       float32 [B, N]
//
// bitwise jax.random.uniform(key, shape) with N = prod(shape), vmapped
// over keys (repro/kernels/ops.py::quant_levels draws it through XLA; no
// TPU kernel corresponds).  It is bound by operations: 76 integer ops an
// element against 4 bytes written; at [12, 40960, 256] the ops take about
// 0.285 ms at the issue ceiling, the bytes 0.150 ms.  Same layout as the
// mask: 4 consecutive counters per thread, one float4 store, blockIdx.y
// the key.
//
// The Threefry round function is shared with the fused stochastic codec
// (threefry.cuh).
//
// C interface (ctypes): pointers and the stream are void*, sizes 64-bit;
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool keep(uint32_t k0, uint32_t k1, uint32_t k2,
                                     uint64_t c, float p) {
  return threefry::uniform(k0, k1, k2, c) < p;
}

// the element types of the mask: f32, and bf16 (a gradient leaf of the
// bf16 LM configs); arithmetic is in f32 either way
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x * scale in x's dtype: the scale is first cast to it (JAX's
// scale.astype(x.dtype)); for bf16 the f32 product of two bf16 values is
// exact, so rounding it once is bf16's own multiply
template <typename T>
__device__ __forceinline__ T scaled(T v, float s) {
  return from_f32<T>(to_f32(v) * s);
}

// four consecutive elements: one 16-byte (f32) or 8-byte (bf16) access
template <typename T>
struct alignas(4 * sizeof(T)) Group4 {
  T v[4];
};

// VEC: N % 4 == 0 and rows aligned to a group, so a group is one load and
// one store
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
random_mask_kernel(const T* __restrict__ x, const uint32_t* __restrict__ keys,
                   T* __restrict__ out,
                   unsigned long long* __restrict__ counts, int64_t n,
                   uint64_t offset, float p, float scale) {
  const int q = blockIdx.y;
  const uint32_t k0 = keys[2 * q], k1 = keys[2 * q + 1];
  const uint32_t k2 = k0 ^ k1 ^ threefry::kParity;
  const float s = to_f32(from_f32<T>(scale));
  const T zero = from_f32<T>(0.f);
  const T* xq = x + (int64_t)q * n;
  T* oq = out + (int64_t)q * n;
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  unsigned int kept = 0;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const int64_t i = 4 * g;
    const uint64_t c = (uint64_t)i + offset;
    if (VEC) {
      const Group4<T> v = reinterpret_cast<const Group4<T>*>(xq)[g];
      Group4<T> o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool m = keep(k0, k1, k2, c + j, p);
        o.v[j] = m ? scaled(v.v[j], s) : zero;
        kept += (unsigned)m;
      }
      reinterpret_cast<Group4<T>*>(oq)[g] = o;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < n) {
          const bool m = keep(k0, k1, k2, c + j, p);
          oq[i + j] = m ? scaled(xq[i + j], s) : zero;
          kept += (unsigned)m;
        }
      }
    }
  }
  if (counts != nullptr) {
    // every thread of the block ran the loop above: the warp is whole
    const unsigned warp_kept = __reduce_add_sync(0xffffffffu, kept);
    if ((threadIdx.x & 31) == 0 && warp_kept)
      atomicAdd(counts + q, (unsigned long long)warp_kept);
  }
}

// VEC: N % 4 == 0 and a 16-byte aligned output, so a group is one float4
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
random_uniform_kernel(const uint32_t* __restrict__ keys,
                      float* __restrict__ out, int64_t n, uint64_t offset) {
  const int b = blockIdx.y;
  const uint32_t k0 = keys[2 * b], k1 = keys[2 * b + 1];
  const uint32_t k2 = k0 ^ k1 ^ threefry::kParity;
  float* ob = out + (int64_t)b * n;
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const int64_t i = 4 * g;
    const uint64_t c = (uint64_t)i + offset;
    if (VEC) {
      float4 o;
      o.x = threefry::uniform(k0, k1, k2, c);
      o.y = threefry::uniform(k0, k1, k2, c + 1);
      o.z = threefry::uniform(k0, k1, k2, c + 2);
      o.w = threefry::uniform(k0, k1, k2, c + 3);
      reinterpret_cast<float4*>(ob)[g] = o;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) ob[i + j] = threefry::uniform(k0, k1, k2, c + j);
    }
  }
}

// about 8 blocks of kThreads threads per SM over all rows
dim3 grid_for(long long q, long long n, int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long groups = (n + 3) / 4;
  const long long want = ((long long)sms * 8 + q - 1) / q;
  const long long need = (groups + kThreads - 1) / kThreads;
  const unsigned bx = (unsigned)(need < want ? need : want);
  return dim3(bx > 0 ? bx : 1, (unsigned)q);
}

template <typename T>
int launch_random_mask(const void* x, const void* keys, void* out,
                       void* counts, long long q, long long n,
                       long long offset, float p, float scale, int device,
                       void* stream) {
  cudaSetDevice(device);
  if (q == 0 || n == 0) return (int)cudaGetLastError();
  if (q > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(q, n, device);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % sizeof(Group4<T>) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(Group4<T>) == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const uint32_t*>(keys);
  auto* cp = static_cast<unsigned long long*>(counts);
  if (vec)
    random_mask_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), kp, static_cast<T*>(out), cp, (int64_t)n,
        (uint64_t)offset, p, scale);
  else
    random_mask_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), kp, static_cast<T*>(out), cp, (int64_t)n,
        (uint64_t)offset, p, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: float32 [Q, N]; keys: uint32 [Q, 2]; counts: uint64 [Q] (added
// to) or null; offset: added to every counter.
extern "C" int random_mask_f32(const void* x, const void* keys, void* out,
                               void* counts, long long q, long long n,
                               long long offset, float p, float scale,
                               int device, void* stream) {
  return launch_random_mask<float>(x, keys, out, counts, q, n, offset, p,
                                   scale, device, stream);
}

// the same over bf16 x and out: out = bf16(x * bf16(scale)) where kept
extern "C" int random_mask_bf16(const void* x, const void* keys, void* out,
                                void* counts, long long q, long long n,
                                long long offset, float p, float scale,
                                int device, void* stream) {
  return launch_random_mask<__nv_bfloat16>(x, keys, out, counts, q, n,
                                           offset, p, scale, device, stream);
}

// keys: uint32 [B, 2]; out: float32 [B, N]; offset: added to every
// counter.
extern "C" int random_uniform_f32(const void* keys, void* out, long long b,
                                  long long n, long long offset, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(b, n, device);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const uint32_t*>(keys);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    random_uniform_kernel<true><<<grid, kThreads, 0, s>>>(
        kp, static_cast<float*>(out), (int64_t)n, (uint64_t)offset);
  else
    random_uniform_kernel<false><<<grid, kThreads, 0, s>>>(
        kp, static_cast<float*>(out), (int64_t)n, (uint64_t)offset);
  return (int)cudaGetLastError();
}
