// ELL SpMM for Hopper: out[q, i, :] = sum_k w[q, i, k] * x[q, nbr[q, i, k], :]
//
// Replaces the Pallas TPU kernel repro/kernels/ell_spmm.py::ell_spmm
// (_ell_kernel).  The TPU kernel streams source chunks of x through VMEM
// and masks neighbours outside the chunk; on Hopper every gather reads
// device memory (through L2) directly, so there is no chunking and no row
// padding: the kernel masks its own ragged edge.
//
// Design: one warp per destination row.  Lane l of the warp owns columns
// [l*VEC + 32*VEC*c, ...) for column chunk c, loads them as one 16-byte
// float4 (VEC == 4) or one float (VEC == 1, any width), and accumulates in
// f32 with k ascending — the order of the plain version.  The K neighbour
// ids and weights of the row are loaded once, one per lane, and broadcast
// with __shfl_sync; pad slots (w == 0, warp-uniform) skip their gather.
// The kernel is bound by device-memory bytes (2 flops per 4 bytes read).
//
// C interface (ctypes): pointers and the stream are void*, sizes 64-bit;
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 2;  // column chunks held in registers per pass

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                const float* __restrict__ w, float* __restrict__ out,
                int64_t rows, int64_t n_dst, int64_t n_src, int k, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  const int64_t part = row / n_dst;
  const float* xq = x + part * n_src * f;
  const int* nr = nbr + row * k;
  const float* wr = w + row * k;
  float* orow = out + row * f;

  constexpr int kTile = 32 * VEC * kChunks;
  for (int c0 = 0; c0 < f; c0 += kTile) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[c][v] = 0.f;

    for (int kb = 0; kb < k; kb += 32) {
      const int my = kb + lane;
      const int my_j = my < k ? nr[my] : 0;
      const float my_w = my < k ? wr[my] : 0.f;
      const int n_here = min(32, k - kb);
      for (int s = 0; s < n_here; ++s) {
        const int j = __shfl_sync(0xffffffffu, my_j, s);
        const float wj = __shfl_sync(0xffffffffu, my_w, s);
        if (wj == 0.f || j < 0 || j >= n_src) continue;  // pad slot
        const float* xr = xq + (int64_t)j * f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = c0 + c * 32 * VEC + lane * VEC;
          if (col < f) {
            if constexpr (VEC == 4) {
              const float4 v = *reinterpret_cast<const float4*>(xr + col);
              acc[c][0] = fmaf(wj, v.x, acc[c][0]);
              acc[c][1] = fmaf(wj, v.y, acc[c][1]);
              acc[c][2] = fmaf(wj, v.z, acc[c][2]);
              acc[c][3] = fmaf(wj, v.w, acc[c][3]);
            } else {
              acc[c][0] = fmaf(wj, xr[col], acc[c][0]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = c0 + c * 32 * VEC + lane * VEC;
      if (col < f) {
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        } else {
          orow[col] = acc[c][0];
        }
      }
    }
  }
}

}  // namespace

extern "C" int ell_spmm_f32(const void* x, const void* nbr, const void* w,
                            void* out, long long q, long long n_dst,
                            long long n_src, long long k, long long f,
                            int vec4, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t rows = (int64_t)q * n_dst;
  if (rows == 0 || f == 0) return (int)cudaGetLastError();
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    ell_spmm_kernel<4><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(nbr),
        static_cast<const float*>(w), static_cast<float*>(out), rows, n_dst,
        n_src, (int)k, (int)f);
  } else {
    ell_spmm_kernel<1><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(nbr),
        static_cast<const float*>(w), static_cast<float*>(out), rows, n_dst,
        n_src, (int)k, (int)f);
  }
  return (int)cudaGetLastError();
}
