// Mamba2 SSD intra-chunk quadratic form for Hopper.  Per (batch, chunk,
// head h) with group g = h / (H / G):
//
//   M[t, s]   = (C_t . B_s) * exp(cum_t - cum_s) * dt_s * 1[s <= t]
//   y[t, :]   = sum_s M[t, s] x[s, :]                              [Q, P]
//   st[p, n]  = sum_q x[q, p] * B[q, n] * (exp(cum_end - cum_q) * dt_q)
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk
// (_ssd_chunk_kernel), which holds a whole chunk's [Q, N] B/C and [Q, P] X
// tiles in VMEM for one (batch*chunk, head) grid step and takes B and C
// already repeated to the heads.  On Hopper a chunk's B and C alone are
// 256 KB in f32 at Q = 256, N = 128 - more than a block's 227 KB of shared
// memory - so the work is tiled:
//
//   * ssd_y_kernel: one block per (64-row t tile, head, batch*chunk).  It
//     keeps its C rows in shared memory and streams 64-row tiles of B, X,
//     cum and dt for s <= t only (the causal half).  Thread (ty, tx) owns
//     rows 4*ty..4*ty+3 and, of each s tile, columns tx + 16*j: 16 entries
//     of C B^T from float4 reads (rows padded by 4 floats: no bank
//     conflicts).  exp(cum_t - cum_s) is evaluated only where s <= t (above
//     the diagonal it can overflow); M goes through shared memory and
//     M X accumulates in registers over float4 column groups tx + 16*m.
//   * ssd_state_kernel: one block per (head, batch*chunk), the [P, N]
//     state contribution in passes of 64 x 128 outputs, streaming 32-row
//     tiles of X and of B weighted by exp(cum_end - cum_q) * dt_q.
//
// B and C are read un-expanded ([B, NC, Q, G, N], head h -> group g): at
// mamba2's 24 heads and one group the repeat would read 24x the bytes.
// Every input is a strided view (pointer + strides of its first four dims,
// last dim contiguous), so the model's conv output is read in place.  Rows
// past Q are masked, so any chunk length runs.  Work is f32 FMA on the CUDA
// cores; bound by operations at mamba2's prefill shape.
//
// C interface (ctypes): pointers and the stream are void*, strides 64-bit,
// sizes int; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;        // t rows per block (Y pass)
constexpr int kS = 64;        // s rows per streamed tile (Y pass)
constexpr int kLM = kS + 4;   // padded row stride of the M tile
constexpr int kSq = 32;       // q rows per streamed tile (state pass)
constexpr int kThreads = 256;

// a strided [B, NC, Q, H-or-G, last] view; the last dim is contiguous
struct View {
  const float* p;
  long long sb, sc, sq, sh;
  __device__ __forceinline__ const float* at(int bi, int ci, int q,
                                             int h) const {
    return p + bi * sb + ci * sc + q * sq + h * sh;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int PM>  // float4 column groups of P per thread: ceil(P / 64)
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(View x, View dt, View cum, View bm, View cm,
             float* __restrict__ y, int NC, int Q, int H, int P, int N,
             int rep) {
  const int LN = N + 4, LP = P + 4;
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // [kT][LN]
  float* Bs = Cs + kT * LN;                     // [kS][LN]
  float* Xs = Bs + kS * LN;                     // [kS][LP]
  float* Ms = Xs + kS * LP;                     // [kT][kLM]
  float* cum_t = Ms + kT * kLM;                 // [kT]
  float* cum_s = cum_t + kT;                    // [kS]
  float* dt_s = cum_s + kS;                     // [kS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * kT, h = blockIdx.y, bc = blockIdx.z;
  const int bi = bc / NC, ci = bc % NC, g = h / rep;

  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N, n = i % N, t = t0 + r;
    Cs[r * LN + n] = t < Q ? cm.at(bi, ci, t, g)[n] : 0.f;
  }
  for (int i = tid; i < kT; i += kThreads)
    cum_t[i] = t0 + i < Q ? *cum.at(bi, ci, t0 + i, h) : 0.f;

  float acc[4][PM][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < PM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.f;

  const int s_end = min(t0 + kT, Q);  // s <= t < t0 + kT
  for (int s0 = 0; s0 < s_end; s0 += kS) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kS * N; i += kThreads) {
      const int r = i / N, n = i % N, s = s0 + r;
      Bs[r * LN + n] = s < Q ? bm.at(bi, ci, s, g)[n] : 0.f;
    }
    for (int i = tid; i < kS * P; i += kThreads) {
      const int r = i / P, c = i % P, s = s0 + r;
      Xs[r * LP + c] = s < Q ? x.at(bi, ci, s, h)[c] : 0.f;
    }
    for (int i = tid; i < kS; i += kThreads) {
      const bool in = s0 + i < Q;
      cum_s[i] = in ? *cum.at(bi, ci, s0 + i, h) : 0.f;
      dt_s[i] = in ? *dt.at(bi, ci, s0 + i, h) : 0.f;
    }
    __syncthreads();

    float cb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      float4 ca[4], ba[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ca[i] = ld4(&Cs[(ty * 4 + i) * LN + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ba[j] = ld4(&Bs[(tx + 16 * j) * LN + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cb[i][j] = fmaf(ca[i].x, ba[j].x, cb[i][j]);
          cb[i][j] = fmaf(ca[i].y, ba[j].y, cb[i][j]);
          cb[i][j] = fmaf(ca[i].z, ba[j].z, cb[i][j]);
          cb[i][j] = fmaf(ca[i].w, ba[j].w, cb[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = t0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, s = s0 + c;
        float m = 0.f;
        if (s <= t && t < Q)  // s < Q follows
          m = cb[i][j] * expf(cum_t[r] - cum_s[c]) * dt_s[c];
        Ms[r * kLM + c] = m;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int ss = 0; ss < kS; ss += 4) {
      float4 ma[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ma[i] = ld4(&Ms[(ty * 4 + i) * kLM + ss]);
#pragma unroll
      for (int m = 0; m < PM; ++m) {
        const int gp = tx + 16 * m;
        if (4 * gp < P) {
          const float4 x0 = ld4(&Xs[(ss + 0) * LP + 4 * gp]);
          const float4 x1 = ld4(&Xs[(ss + 1) * LP + 4 * gp]);
          const float4 x2 = ld4(&Xs[(ss + 2) * LP + 4 * gp]);
          const float4 x3 = ld4(&Xs[(ss + 3) * LP + 4 * gp]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i][m];
            a[0] = fmaf(ma[i].x, x0.x, a[0]);
            a[1] = fmaf(ma[i].x, x0.y, a[1]);
            a[2] = fmaf(ma[i].x, x0.z, a[2]);
            a[3] = fmaf(ma[i].x, x0.w, a[3]);
            a[0] = fmaf(ma[i].y, x1.x, a[0]);
            a[1] = fmaf(ma[i].y, x1.y, a[1]);
            a[2] = fmaf(ma[i].y, x1.z, a[2]);
            a[3] = fmaf(ma[i].y, x1.w, a[3]);
            a[0] = fmaf(ma[i].z, x2.x, a[0]);
            a[1] = fmaf(ma[i].z, x2.y, a[1]);
            a[2] = fmaf(ma[i].z, x2.z, a[2]);
            a[3] = fmaf(ma[i].z, x2.w, a[3]);
            a[0] = fmaf(ma[i].w, x3.x, a[0]);
            a[1] = fmaf(ma[i].w, x3.y, a[1]);
            a[2] = fmaf(ma[i].w, x3.z, a[2]);
            a[3] = fmaf(ma[i].w, x3.w, a[3]);
          }
        }
      }
    }
  }

  // y is contiguous [B*NC, Q, H, P]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= Q) continue;
    float* yr = y + (((long long)bc * Q + t) * H + h) * P;
#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int gp = tx + 16 * m;
      if (4 * gp < P)
        *reinterpret_cast<float4*>(yr + 4 * gp) =
            make_float4(acc[i][m][0], acc[i][m][1], acc[i][m][2],
                        acc[i][m][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(View x, View dt, View cum, View bm, float* __restrict__ st,
                 int NC, int Q, int H, int P, int N, int rep) {
  __shared__ float Xs[kSq][64];
  __shared__ float Ws[kSq][128];
  __shared__ float wq[kSq];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, bc = blockIdx.y;
  const int bi = bc / NC, ci = bc % NC, g = h / rep;
  const float cum_end = *cum.at(bi, ci, Q - 1, h);
  float* out = st + ((long long)bc * H + h) * P * N;  // [P, N]

  for (int p0 = 0; p0 < P; p0 += 64) {
    for (int n0 = 0; n0 < N; n0 += 128) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int q0 = 0; q0 < Q; q0 += kSq) {
        __syncthreads();
        for (int i = tid; i < kSq; i += kThreads) {
          const int q = q0 + i;
          wq[i] = q < Q ? expf(cum_end - *cum.at(bi, ci, q, h)) *
                              *dt.at(bi, ci, q, h)
                        : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < kSq * 64; i += kThreads) {
          const int r = i / 64, c = i % 64, q = q0 + r, p = p0 + c;
          Xs[r][c] = q < Q && p < P ? x.at(bi, ci, q, h)[p] : 0.f;
        }
        for (int i = tid; i < kSq * 128; i += kThreads) {
          const int r = i / 128, c = i % 128, q = q0 + r, n = n0 + c;
          Ws[r][c] = q < Q && n < N ? bm.at(bi, ci, q, g)[n] * wq[r] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < kSq; ++r) {
          float xv[4], wv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = Xs[r][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) wv[j] = Ws[r][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < N) out[(long long)p * N + n] = acc[i][j];
        }
      }
    }
  }
}

template <int PM>
int launch_y(const View* v, float* y, int BNC, int NC, int Q, int H, int P,
             int N, int rep, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)(kT + kS) * (N + 4) + (size_t)kS * (P + 4) +
                       kT * kLM + kT + 2 * kS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel<PM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Q + kT - 1) / kT), (unsigned)H, (unsigned)BNC);
  ssd_y_kernel<PM><<<grid, kThreads, smem, s>>>(v[0], v[1], v[2], v[3], v[4],
                                                y, NC, Q, H, P, N, rep);
  return (int)cudaGetLastError();
}

View make_view(const void* p, long long sb, long long sc, long long sq,
               long long sh) {
  return View{static_cast<const float*>(p), sb, sc, sq, sh};
}

}  // namespace

// Each of x, dt, cum, b, c is (pointer, strides of its first four dims):
// x [B, NC, Q, H, P], dt/cum [B, NC, Q, H] (fourth stride 1), b/c [B, NC,
// Q, G, N].  Outputs: y [B, NC, Q, H, P] and st [B, NC, H, P, N],
// contiguous f32.  Requires P, N multiples of 4, at most 256.
extern "C" int ssd_chunk_f32(
    const void* x, long long xb, long long xc, long long xq, long long xh,
    const void* dt, long long db, long long dc, long long dq, long long dh,
    const void* cum, long long cb, long long cc, long long cq, long long ch,
    const void* b, long long bb, long long bc, long long bq, long long bg,
    const void* c, long long ccb, long long ccc, long long ccq, long long ccg,
    void* y, void* st, int B, int NC, int Q, int H, int P, int G, int N,
    int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || NC == 0 || Q == 0 || H == 0) return (int)cudaGetLastError();
  if (G <= 0 || H % G != 0 || P % 4 || N % 4 || P > 256 || N > 256)
    return (int)cudaErrorInvalidValue;
  const View v[5] = {make_view(x, xb, xc, xq, xh),
                     make_view(dt, db, dc, dq, dh),
                     make_view(cum, cb, cc, cq, ch),
                     make_view(b, bb, bc, bq, bg),
                     make_view(c, ccb, ccc, ccq, ccg)};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rep = H / G, BNC = B * NC;
  float* yp = static_cast<float*>(y);
  int err;
  if (P <= 64)
    err = launch_y<1>(v, yp, BNC, NC, Q, H, P, N, rep, s);
  else if (P <= 128)
    err = launch_y<2>(v, yp, BNC, NC, Q, H, P, N, rep, s);
  else
    err = launch_y<4>(v, yp, BNC, NC, Q, H, P, N, rep, s);
  if (err != 0) return err;
  ssd_state_kernel<<<dim3((unsigned)H, (unsigned)BNC), kThreads, 0, s>>>(
      v[0], v[1], v[2], v[3], static_cast<float*>(st), NC, Q, H, P, N, rep);
  return (int)cudaGetLastError();
}
