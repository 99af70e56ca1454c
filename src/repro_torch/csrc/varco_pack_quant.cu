// Fused quantised wire codec for Hopper: lane-block gather + per-block
// symmetric quantisation + sub-byte bit-pack (send), and bit-unpack +
// sign-extend + dequantise + scatter (receive).
//
// pack_quant:   x [B, H, NB*128] f32, kept [B, K] i32, qmax [B] f32
//               -> payload [B, H, K*128*W/8] u8, scales [B, H, K] f32
//   for each (b, h, k): blk = x[b, h, kept[b, k]*128 : +128]
//     amax  = max |blk|;  scale = amax > 0 ? amax / qmax[b] : 1
//     level = clamp(rint(blk / scale), -qmax[b], qmax[b])      (int)
//     payload: 8/W consecutive lanes per byte, little-endian, the low W
//     bits of each level's two's complement
//   stochastic rounding (keys [B, 2] uint32 given): for lane l of kept
//   block k of row h of batch row b,
//     u     = uniform(keys[b], h*K*128 + k*128 + l)     (threefry.cuh)
//     level = clamp(floor(blk / scale + u), -qmax[b], qmax[b])
//   bitwise the JAX package's quant_levels(wire_pack(x), w, key=keys[b])
//   (repro/kernels/ops.py:195, jax.random.uniform over the packed
//   [H, K, 128] block: the Pallas kernel rounds to nearest only)
// unpack_quant: payload, scales, inv [B, NB] i32 -> out [B, H, NB*128] f32
//   out[b, h, j*128 + l] = level(payload[b, h, inv[b, j]], l) *
//                          scales[b, h, inv[b, j]]    where inv[b, j] >= 0,
//   else 0 (a dropped block)
//
// Replace the Pallas TPU kernels repro/kernels/varco_pack.py::
// varco_pack_quant (_pack_quant_kernel) and ::varco_unpack_quant
// (_unpack_quant_kernel).  The TPU kernels take one static qmax and one
// index row; here a leading batch dimension carries one index row and one
// qmax per (sender, ring hop), so one launch quantises every hop of an
// exchange, each at its pair's width under the storage width W.
//
// Design: both kernels are bound by device-memory bytes (a handful of
// flops per 4-byte load).  A block is 32 x 8 threads; threadIdx.y picks a
// row and the 32 lanes of a warp cover one 128-lane block as 32 float4s
// (fully coalesced 16-byte loads).  The block amax is a warp shuffle
// max-reduce, so no shared memory is used.  Each lane's 4 consecutive
// levels fill whole bytes at every width (4 bytes at W=8, 2 at W=4, 1 at
// W=2), so no two lanes share a byte and the store needs no atomics.
// Lane 0 writes the block's scale.  The arithmetic is bitwise the JAX
// package's quant_levels + pack_bits: an IEEE division (__fdiv_rn; the
// build never uses --use_fast_math), rintf (round half to even, like
// jnp.rint), clamp before the integer cast, and on decode one f32
// multiply per lane (no add to contract into an FMA).
//
// The stochastic variant is a second instantiation (STOCH, selected with
// if constexpr, so the rint instantiation keeps its code): each lane
// hashes its 4 consecutive counters (one 20-round Threefry each, 76
// integer ops) and rounds with floorf(__fadd_rn(__fdiv_rn(v, scale), u)).
// It is bound by operations, not bytes: at the w8 hop shape [12, 40960,
// 256] the hashes take about 0.285 ms at the SM's integer issue ceiling
// (128 results a clock), the bytes 0.189 ms.
//
// C interface (ctypes): pointers and the stream are void*, sizes 64-bit,
// width an int in {2, 4, 8}, keys null for round-half-even; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for any
// other width).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kLaneVec = 32;  // float4s per 128-lane block

__device__ __forceinline__ int level_of(float v, float scale, float qmax) {
  const float l = rintf(__fdiv_rn(v, scale));
  return static_cast<int>(fminf(fmaxf(l, -qmax), qmax));
}

__device__ __forceinline__ int level_stoch(float v, float scale, float qmax,
                                           float u) {
  const float l = floorf(__fadd_rn(__fdiv_rn(v, scale), u));
  return static_cast<int>(fminf(fmaxf(l, -qmax), qmax));
}

template <int W>
__device__ __forceinline__ int sign_extend(uint32_t field) {
  return static_cast<int>(static_cast<int8_t>(
             static_cast<uint8_t>(field << (8 - W)))) >> (8 - W);
}

template <int W, bool STOCH>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
pack_quant_kernel(const float4* __restrict__ x, const int* __restrict__ kept,
                  const float* __restrict__ qmax_b,
                  const uint32_t* __restrict__ keys,
                  uint8_t* __restrict__ payload, float* __restrict__ scales,
                  int64_t rows, int64_t h, int nb, int k) {
  constexpr int kBytes = 128 * W / 8;  // payload bytes per lane-block
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;
  const int64_t bat = row / h;
  const int* kq = kept + bat * k;
  const float qmax = qmax_b[bat];
  const float4* xr = x + row * nb * kLaneVec;
  uint8_t* prow = payload + row * k * kBytes;
  float* srow = scales + row * k;
  const int lane = threadIdx.x;
  uint32_t k0 = 0, k1 = 0, k2 = 0;
  uint64_t c = 0;  // the counter of this lane's first value in block 0
  if constexpr (STOCH) {
    k0 = keys[2 * bat];
    k1 = keys[2 * bat + 1];
    k2 = k0 ^ k1 ^ threefry::kParity;
    c = (uint64_t)(row - bat * h) * (uint64_t)k * 128u + 4u * lane;
  }
  for (int kb = 0; kb < k; ++kb) {
    const int b = kq[kb];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b >= 0 && b < nb) v = xr[b * kLaneVec + lane];
    float a = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                    fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    const float scale = a > 0.f ? __fdiv_rn(a, qmax) : 1.f;
    uint32_t l0, l1, l2, l3;
    if constexpr (STOCH) {
      const uint64_t cb = c + (uint64_t)kb * 128u;
      l0 = (uint32_t)level_stoch(v.x, scale, qmax,
                                 threefry::uniform(k0, k1, k2, cb));
      l1 = (uint32_t)level_stoch(v.y, scale, qmax,
                                 threefry::uniform(k0, k1, k2, cb + 1));
      l2 = (uint32_t)level_stoch(v.z, scale, qmax,
                                 threefry::uniform(k0, k1, k2, cb + 2));
      l3 = (uint32_t)level_stoch(v.w, scale, qmax,
                                 threefry::uniform(k0, k1, k2, cb + 3));
    } else {
      l0 = (uint32_t)level_of(v.x, scale, qmax);
      l1 = (uint32_t)level_of(v.y, scale, qmax);
      l2 = (uint32_t)level_of(v.z, scale, qmax);
      l3 = (uint32_t)level_of(v.w, scale, qmax);
    }
    uint8_t* dst = prow + kb * kBytes;
    if (W == 8) {
      reinterpret_cast<uint32_t*>(dst)[lane] =
          (l0 & 0xffu) | (l1 & 0xffu) << 8 | (l2 & 0xffu) << 16 |
          (l3 & 0xffu) << 24;
    } else if (W == 4) {
      reinterpret_cast<uint16_t*>(dst)[lane] = (uint16_t)(
          (l0 & 0xfu) | (l1 & 0xfu) << 4 | (l2 & 0xfu) << 8 |
          (l3 & 0xfu) << 12);
    } else {
      dst[lane] = (uint8_t)((l0 & 0x3u) | (l1 & 0x3u) << 2 |
                            (l2 & 0x3u) << 4 | (l3 & 0x3u) << 6);
    }
    if (lane == 0) srow[kb] = scale;
  }
}

template <int W>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
unpack_quant_kernel(const uint8_t* __restrict__ payload,
                    const float* __restrict__ scales,
                    const int* __restrict__ inv, float4* __restrict__ out,
                    int64_t rows, int64_t h, int nb, int k) {
  constexpr int kBytes = 128 * W / 8;
  constexpr uint32_t kMask = (1u << W) - 1u;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;
  const int* iq = inv + (row / h) * nb;
  const uint8_t* prow = payload + row * k * kBytes;
  const float* srow = scales + row * k;
  float4* orow = out + row * nb * kLaneVec;
  const int lane = threadIdx.x;
  for (int j = 0; j < nb; ++j) {
    const int src = iq[j];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0 && src < k) {
      const uint8_t* blk = prow + src * kBytes;
      uint32_t u;
      if (W == 8) {
        u = reinterpret_cast<const uint32_t*>(blk)[lane];
      } else if (W == 4) {
        u = reinterpret_cast<const uint16_t*>(blk)[lane];
      } else {
        u = blk[lane];
      }
      const float s = srow[src];
      v.x = (float)sign_extend<W>(u & kMask) * s;
      v.y = (float)sign_extend<W>((u >> W) & kMask) * s;
      v.z = (float)sign_extend<W>((u >> (2 * W)) & kMask) * s;
      v.w = (float)sign_extend<W>((u >> (3 * W)) & kMask) * s;
    }
    orow[j * kLaneVec + lane] = v;
  }
}

dim3 grid_for(int64_t rows) {
  return dim3((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

template <int W, bool STOCH>
void launch_pack_as(const void* x, const void* kept, const void* qmax,
                    const void* keys, void* payload, void* scales,
                    int64_t rows, int64_t h, int nb, int k,
                    cudaStream_t stream) {
  pack_quant_kernel<W, STOCH><<<grid_for(rows), dim3(32, kRowsPerBlock), 0,
                                stream>>>(
      static_cast<const float4*>(x), static_cast<const int*>(kept),
      static_cast<const float*>(qmax), static_cast<const uint32_t*>(keys),
      static_cast<uint8_t*>(payload), static_cast<float*>(scales), rows, h,
      nb, k);
}

template <int W>
void launch_pack(const void* x, const void* kept, const void* qmax,
                 const void* keys, void* payload, void* scales, int64_t rows,
                 int64_t h, int nb, int k, cudaStream_t stream) {
  if (keys != nullptr)
    launch_pack_as<W, true>(x, kept, qmax, keys, payload, scales, rows, h,
                            nb, k, stream);
  else
    launch_pack_as<W, false>(x, kept, qmax, keys, payload, scales, rows, h,
                             nb, k, stream);
}

template <int W>
void launch_unpack(const void* payload, const void* scales, const void* inv,
                   void* out, int64_t rows, int64_t h, int nb, int k,
                   cudaStream_t stream) {
  unpack_quant_kernel<W><<<grid_for(rows), dim3(32, kRowsPerBlock), 0,
                           stream>>>(
      static_cast<const uint8_t*>(payload),
      static_cast<const float*>(scales), static_cast<const int*>(inv),
      static_cast<float4*>(out), rows, h, nb, k);
}

}  // namespace

// keys: uint32 [B, 2] (one key per batch row: stochastic rounding) or
// null (round half to even)
extern "C" int varco_pack_quant_f32(const void* x, const void* kept,
                                    const void* qmax, const void* keys,
                                    void* payload, void* scales, long long b,
                                    long long h, long long nb, long long k,
                                    int width, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t rows = (int64_t)b * h;
  if (width != 2 && width != 4 && width != 8) return (int)cudaErrorInvalidValue;
  if (rows == 0 || k == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (width == 8) {
    launch_pack<8>(x, kept, qmax, keys, payload, scales, rows, h, (int)nb, (int)k, s);
  } else if (width == 4) {
    launch_pack<4>(x, kept, qmax, keys, payload, scales, rows, h, (int)nb, (int)k, s);
  } else {
    launch_pack<2>(x, kept, qmax, keys, payload, scales, rows, h, (int)nb, (int)k, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int varco_unpack_quant_f32(const void* payload, const void* scales,
                                      const void* inv, void* out, long long b,
                                      long long h, long long nb, long long k,
                                      int width, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t rows = (int64_t)b * h;
  if (width != 2 && width != 4 && width != 8) return (int)cudaErrorInvalidValue;
  if (rows == 0 || nb == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (width == 8) {
    launch_unpack<8>(payload, scales, inv, out, rows, h, (int)nb, (int)k, s);
  } else if (width == 4) {
    launch_unpack<4>(payload, scales, inv, out, rows, h, (int)nb, (int)k, s);
  } else {
    launch_unpack<2>(payload, scales, inv, out, rows, h, (int)nb, (int)k, s);
  }
  return (int)cudaGetLastError();
}
