// Lane-block pack / unpack for Hopper (the p2p wire's gather and scatter).
//
// pack:   x [Q, N, NB*128] f32, kept [Q, K] i32    -> out [Q, N, K*128]
//         out[q, n, k*128 + l] = x[q, n, kept[q, k]*128 + l]
// unpack: packed [Q, M, K*128] f32, inv [Q, NB] i32 -> out [Q, M, NB*128]
//         out[q, m, b*128 + l] = packed[q, m, inv[q, b]*128 + l]
//         where inv[q, b] >= 0, else 0 (a dropped block)
//
// Replace the Pallas TPU kernels repro/kernels/varco_pack.py::varco_pack
// (_pack_kernel) and ::varco_unpack (_unpack_kernel).  On the TPU the
// kept/inv indices ride in scalar-prefetch memory and steer whole-tile
// DMAs; here each thread block loads its own index rows (a few bytes,
// served from L1/L2), and the batch dimension Q carries one index row per
// sender, so one launch serves every sender.
//
// Design: a block is 32 x 8 threads; threadIdx.y picks one of 8 rows and
// the 32 lanes of a warp copy one 128-lane block of that row as 32
// float4s (512 contiguous bytes: fully coalesced 16-byte accesses).  Each
// thread walks the row's K (pack) or NB (unpack) blocks.  Both kernels are
// pure data movement, bound by device-memory bytes; an index outside its
// range reads as a dropped block (zeros) rather than faulting.
//
// C interface (ctypes): pointers and the stream are void*, sizes 64-bit;
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kLaneVec = 32;  // float4s per 128-lane block

__global__ void __launch_bounds__(32 * kRowsPerBlock)
pack_kernel(const float4* __restrict__ x, const int* __restrict__ kept,
            float4* __restrict__ out, int64_t rows, int64_t n, int nb,
            int k) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;
  const int* kq = kept + (row / n) * k;
  const float4* xr = x + row * nb * kLaneVec;
  float4* orow = out + row * k * kLaneVec;
  for (int kb = 0; kb < k; ++kb) {
    const int b = kq[kb];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b >= 0 && b < nb) v = xr[b * kLaneVec + threadIdx.x];
    orow[kb * kLaneVec + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
unpack_kernel(const float4* __restrict__ packed, const int* __restrict__ inv,
              float4* __restrict__ out, int64_t rows, int64_t m, int nb,
              int k) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;
  const int* iq = inv + (row / m) * nb;
  const float4* pr = packed + row * k * kLaneVec;
  float4* orow = out + row * nb * kLaneVec;
  for (int b = 0; b < nb; ++b) {
    const int src = iq[b];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0 && src < k) v = pr[src * kLaneVec + threadIdx.x];
    orow[b * kLaneVec + threadIdx.x] = v;
  }
}

dim3 grid_for(int64_t rows) {
  return dim3((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

}  // namespace

extern "C" int varco_pack_f32(const void* x, const void* kept, void* out,
                              long long q, long long n, long long nb,
                              long long k, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t rows = (int64_t)q * n;
  if (rows == 0 || k == 0) return (int)cudaGetLastError();
  pack_kernel<<<grid_for(rows), dim3(32, kRowsPerBlock), 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(kept),
      static_cast<float4*>(out), rows, (int64_t)n, (int)nb, (int)k);
  return (int)cudaGetLastError();
}

extern "C" int varco_unpack_f32(const void* packed, const void* inv,
                                void* out, long long q, long long m,
                                long long nb, long long k, int device,
                                void* stream) {
  cudaSetDevice(device);
  const int64_t rows = (int64_t)q * m;
  if (rows == 0 || nb == 0) return (int)cudaGetLastError();
  unpack_kernel<<<grid_for(rows), dim3(32, kRowsPerBlock), 0,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(packed), static_cast<const int*>(inv),
      static_cast<float4*>(out), rows, (int64_t)m, (int)nb, (int)k);
  return (int)cudaGetLastError();
}
