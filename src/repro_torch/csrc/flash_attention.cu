// Flash attention forward for Hopper: causal and/or sliding-window masks,
// GQA, f32 or bf16 inputs, f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel).  The TPU kernel walks a sequential grid
// (B, H, S/bq, S/bk) and carries m/l/acc in VMEM scratch across the KV
// axis; on Hopper blocks run in parallel and in no order, so one block
// owns one (query tile, head, batch) and loops over the KV tiles itself,
// carrying m/l/acc in registers.
//
// Design (a first, simple one; bound by operations at the serving shapes):
//   * 256 threads, a 64-row query tile, 64-key K/V tiles.  Q, K, V tiles
//     are converted to f32 in shared memory with rows padded by 4 floats,
//     so the 16-byte reads below hit distinct banks.
//   * Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4*ty..4*ty+3
//     and, of each 64-key tile, keys tx + 16*j (j < 4): 16 scores from
//     float4 reads of Q and K.  Row max and row sum reduce over the 16
//     lanes of a half-warp with xor shuffles.
//   * P goes through shared memory; for P·V the thread keeps its 4 rows
//     and the float4 column groups tx + 16*m of the head dim.
//   * Key tiles wholly above the diagonal or left of the window are never
//     visited; keys at or past S (a ragged last tile) are masked, so any
//     S runs.
//   * Explicit positions (qpos/kpos, int32 [B, S], the JAX package's
//     prefill mask): a key is live when kpos <= qpos (causal) and kpos >
//     qpos - window.  Such a mask need not be lower-triangular in index,
//     so the tile walk takes the query tile's key range [lo, hi) from the
//     wrapper (ranges, int4 [B, S/kBQ]; outside it the positions' extremes
//     prove every key masked) and masks its keys by position, except in
//     the run of tiles [full_lo, full_hi) that the extremes prove wholly
//     unmasked.  A masked score is -inf and a row with no live key so far
//     keeps m = -inf, p = 0, so a fully masked row ends with l = 0 and
//     writes 0 (acc / max(l, 1e-30)), as ref.mha_reference does.
//   * GQA: query head h reads KV head h / group, never a repeated copy.
//   * Strided inputs: (b, h, s) strides in elements, the head dim
//     contiguous, so the model's [B, S, H, D] tensors are read in place.
//   * FMA on the CUDA cores in f32; tensor cores (wgmma) are later work.
//
// C interface (ctypes): pointers and the stream are void*, sizes int,
// strides 64-bit; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLP = kBK + 4;  // padded row stride of the P tile

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
constexpr int smem_floats() {
  return (kBQ + 2 * kBK) * (D + 4) + kBQ * kLP;
}

// rows [r0, r0 + rows) of a [S, D] head slab into a [rows][LD] f32 tile,
// zero past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows, int S) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = r0 + r;
    dst[r * LD + c] = s < S ? to_f32(src[(long long)s * row_stride + c]) : 0.f;
  }
}

// BY_POS: positions given (a separate instantiation, so the index-masked
// kernel's code is the same as without the positions path)
template <typename T, int D, bool BY_POS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 const int4* __restrict__ ranges, int group, int S,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 int window, float scale) {
  constexpr int LD = D + 4;
  constexpr int DG = D / 4;            // float4 groups of a head row
  constexpr int CG = (DG + 15) / 16;   // groups per thread in P·V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;                     // [kBK][LD]
  float* Vs = Ks + kBK * LD;                     // [kBK][LD]
  float* Ps = Vs + kBK * LD;                     // [kBQ][kLP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  load_tile<T, D>(Qs, qb, sq.s, q0, kBQ, S);

  // the key range this query tile can see, in whole tiles
  constexpr bool by_pos = BY_POS;
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = causal ? q_last + 1 : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  long long rpos[4] = {0, 0, 0, 0};  // this thread's rows' positions
  int full_lo = 0, full_hi = 0;      // key tiles no position masks
  if constexpr (by_pos) {
    const int4 r = ranges[(long long)b * gridDim.x + blockIdx.x];
    k_begin = r.x;
    k_end = r.y;
    full_lo = r.z;
    full_hi = r.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi < S) rpos[i] = qpos[(long long)b * S + qi];
    }
  }

  float m[4], l[4], acc[4][CG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ps are done
    load_tile<T, D>(Ks, kb, sk.s, kt, kBK, S);
    load_tile<T, D>(Vs, vb, sv.s, kt, kBK, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = ld4(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    long long kp[4] = {0, 0, 0, 0};  // this thread's keys' positions
    bool pos_mask = false;
    if constexpr (by_pos) pos_mask = !(kt >= full_lo && kt + kBK <= full_hi);
    if (pos_mask) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt + tx + 16 * j;
        if (kj < S) kp[j] = kpos[(long long)b * S + kj];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt + tx + 16 * j;
        bool live;
        if constexpr (by_pos)
          live = kj < S && (!pos_mask ||
                            ((!causal || kp[j] <= rpos[i]) &&
                             (window <= 0 || kp[j] > rpos[i] - window)));
        else
          live = kj < S && (!causal || kj <= qi) &&
                 (window <= 0 || kj > qi - window);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);  // 0 when m[i] was -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);  // 0 for a masked key
          psum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty * 4 + i) * kLP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ld4(&Ps[(ty * 4 + i) * kLP + kk]);
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int g = tx + 16 * c;
        if (g < DG) {
          const float4 v0 = ld4(&Vs[(kk + 0) * LD + 4 * g]);
          const float4 v1 = ld4(&Vs[(kk + 1) * LD + 4 * g]);
          const float4 v2 = ld4(&Vs[(kk + 2) * LD + 4 * g]);
          const float4 v3 = ld4(&Vs[(kk + 3) * LD + 4 * g]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i][c];
            a[0] = fmaf(pa[i].x, v0.x, a[0]);
            a[1] = fmaf(pa[i].x, v0.y, a[1]);
            a[2] = fmaf(pa[i].x, v0.z, a[2]);
            a[3] = fmaf(pa[i].x, v0.w, a[3]);
            a[0] = fmaf(pa[i].y, v1.x, a[0]);
            a[1] = fmaf(pa[i].y, v1.y, a[1]);
            a[2] = fmaf(pa[i].y, v1.z, a[2]);
            a[3] = fmaf(pa[i].y, v1.w, a[3]);
            a[0] = fmaf(pa[i].z, v2.x, a[0]);
            a[1] = fmaf(pa[i].z, v2.y, a[1]);
            a[2] = fmaf(pa[i].z, v2.z, a[2]);
            a[3] = fmaf(pa[i].z, v2.w, a[3]);
            a[0] = fmaf(pa[i].w, v3.x, a[0]);
            a[1] = fmaf(pa[i].w, v3.y, a[1]);
            a[2] = fmaf(pa[i].w, v3.z, a[2]);
            a[3] = fmaf(pa[i].w, v3.w, a[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)qi * so.s;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int g = tx + 16 * c;
      if (g < DG) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          orow[4 * g + e] = from_f32<T>(acc[i][c][e] / denom);
      }
    }
  }
}

struct Pos {
  const int* q;
  const int* k;
  const int4* ranges;
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Pos pos,
           int B, int H, int KV, int S, const Strides* st, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = pos.q != nullptr ? flash_fwd_kernel<T, D, true>
                                 : flash_fwd_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), pos.q, pos.k, pos.ranges,
      H / KV, S, st[0], st[1], st[2], st[3], causal, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               Pos pos, int B, int H, int KV, int S, const Strides* st,
               int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                           s);
    case 32:
      return launch<T, 32>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                           s);
    case 64:
      return launch<T, 64>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                           s);
    case 128:
      return launch<T, 128>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qpos/kpos: int32 [B, S] positions and
// ranges: int32 [B, ceil(S / 64), 4] key ranges, all three null for the
// index mask.  Strides (in elements) are (b, h, s) for q, k, v and o in
// that order; the head dim is contiguous.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, const void* ranges, int dtype, int B, int H, int KV,
    int S, int D, long long qb, long long qh, long long qs, long long kb,
    long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, int causal, int window,
    int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  if ((qpos == nullptr) != (kpos == nullptr) ||
      (qpos == nullptr) != (ranges == nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides st[4] = {{qb, qh, qs}, {kb, kh, ks}, {vb, vh, vs},
                         {ob, oh, os}};
  const Pos pos{static_cast<const int*>(qpos), static_cast<const int*>(kpos),
                static_cast<const int4*>(ranges)};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, pos, B, H, KV, S, st, causal,
                             window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, pos, B, H, KV, S, st,
                                     causal, window, s);
  return (int)cudaErrorInvalidValue;
}
