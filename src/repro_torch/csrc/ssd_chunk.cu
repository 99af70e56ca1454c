// Mamba2 SSD intra-chunk quadratic form for Hopper.  Per (batch, chunk,
// head h) with group g = h / (H / G):
//
//   G[t, s]   = C_t . B_s                        (one per group, not head)
//   M[t, s]   = G[t, s] * exp(cum_t - cum_s) * dt_s * 1[s <= t]
//   y[t, :]   = sum_s M[t, s] x[s, :]                              [Q, P]
//   st[p, n]  = sum_q x[q, p] * B[q, n] * (exp(cum_end - cum_q) * dt_q)
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk
// (_ssd_chunk_kernel), which holds a whole chunk's [Q, N] B/C and [Q, P] X
// tiles in VMEM for one (batch*chunk, head) grid step and takes B and C
// already repeated to the heads.
//
// What bounds it: f32 operations on the CUDA cores (13.45 GFLOP of needed
// work against 0.27 GB at mamba2's prefill shape: 0.20 ms at 67 TFLOP/s).
// C B^T depends on the group only, so a design that forms it per head (24
// heads of one group in mamba2) does 2x the needed work; this one forms it
// once per (t tile, group, batch*chunk) and shares it across the heads.
//
//   * ssd_y_kernel: one block per (batch*chunk x group, head block, 64-row
//     t tile), t tiles launched longest first.  Phase 1: all 256 threads
//     form G_t = C_t B^T for s < t0 + 64 (the causal range) into shared
//     memory, streaming 32-column chunks of C and B with cp.async double
//     buffering.  Phase 2: two groups of 128 threads take alternate heads
//     of the block; per (head, 64-column P chunk, s tile) a group builds
//     M = G_t o exp(cum_t - cum_s) o dt_s (exp only where s <= t: above the
//     diagonal it can overflow) into its own shared tile and accumulates
//     Y += M X_h with a 4 x 8 register tile per thread, while cp.async
//     loads the next step's X tile and cum/dt vectors.
//   * ssd_state_kernel: one block per (batch*chunk x group, pair of
//     heads, P/N chunk).  Each 32-row q tile of B is loaded once and shared
//     by the pair; their X tiles come with it (cp.async, double-buffered),
//     the weights exp(cum_end - cum_q) * dt_q are formed once per (head, q)
//     in shared memory, and each thread keeps a 4 x 8 tile of both heads'
//     [P, N] contributions in registers.  Two heads a block measured
//     faster than four (fewer registers, twice the blocks).
//   * Heads per Y block: all of the group's (C B^T formed once) measured
//     fastest at mamba2's shape against 12, 8, 6, 4 and 2 (which fill more
//     of the card but form C B^T 2-12 times).
//
// B and C are read un-expanded ([B, NC, Q, G, N], head h -> group g).
// Every input is a strided view (pointer + strides of its first four dims,
// last dim contiguous), so the model's conv output is read in place; 16-byte
// copies are used where pointers and strides allow, 4-byte copies
// elsewhere.  Rows past Q are zero-filled and masked, so any chunk length
// up to 448 runs (G_t's shared tile grows with Q).
//
// C interface (ctypes): pointers and the stream are void*, strides 64-bit,
// sizes int; returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // t rows per Y block, s rows per s tile
constexpr int kNc = 32;          // N columns per phase-1 chunk
constexpr int kLC = kNc + 4;     // padded row of a phase-1 tile
constexpr int kYThreads = 256;   // Y pass: two groups of 128 in phase 2
constexpr int kSq = 32;          // q rows per state tile
constexpr int kSHB = 2;          // heads per state block
constexpr int kSThreads = 256;
constexpr int kMaxQ = 448;

// a strided [B, NC, Q, H-or-G, last] view; the last dim is contiguous
struct View {
  const float* p;
  long long sb, sc, sq, sh;
  __device__ __forceinline__ const float* at(int bi, int ci, int q,
                                             int h) const {
    return p + bi * sb + ci * sc + q * sq + h * sh;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid; vec = 16-byte aligned
// source, else four 4-byte copies
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid,
                                     bool vec) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? 16 : 0;
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       d + 4 * i),
                   "l"(src + (valid ? i : 0)), "r"(n / 4)
                   : "memory");
  }
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Ms holds M[r][c] at r * 64 + 4 * ((c / 4) ^ ((r / 4) & 15)) + c % 4: the
// four rows a thread reads share one swizzle, the rows of a warp differ
__device__ __forceinline__ int ms_idx(int r, int c) {
  return r * kT + ((((c >> 2) ^ ((r >> 2) & 15))) << 2) + (c & 3);
}

__global__ void __launch_bounds__(kYThreads, 1)
ssd_y_kernel(View x, View dt, View cum, View bm, View cm,
             float* __restrict__ y, int NC, int Q, int H, int P, int N,
             int G, int rep, int hb, int vec_x, int vec_bc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int GL = (Q + kT - 1) / kT * kT + 4;  // padded row of G_t
  float* Gs = smem;                           // [kT][GL]
  float* area = Gs + kT * GL;

  const int tid = threadIdx.x;
  const int bcg = blockIdx.x, g = bcg % G, bc = bcg / G;
  const int bi = bc / NC, ci = bc % NC;
  const int n_t = (Q + kT - 1) / kT;
  const int t0 = (n_t - 1 - blockIdx.z) * kT;  // longest first
  const int h_first = g * rep + blockIdx.y * hb;
  const int nh = min(hb, rep - blockIdx.y * hb);
  const int s_end = min(t0 + kT, Q);
  const int n_s = (s_end + kT - 1) / kT;

  // ---- phase 1: G_t = C_t B^T over s < s_end ----------------------------
  {
    float* Cb = area;                 // [2][kT][kLC]
    float* Bb = Cb + 2 * kT * kLC;    // [2][kT][kLC]
    const int n_nc = (N + kNc - 1) / kNc, steps = n_s * n_nc;
    const int tx = tid & 15, ty = tid >> 4;
    auto load = [&](int step, int buf) {
      const int s0 = (step / n_nc) * kT, n0 = (step % n_nc) * kNc;
      for (int i = tid; i < kT * (kNc / 4); i += kYThreads) {
        const int r = i / (kNc / 4), n = n0 + 4 * (i % (kNc / 4));
        const int t = t0 + r, s = s0 + r;
        const bool nin = n < N;
        cp16(Cb + (buf * kT + r) * kLC + n - n0,
             nin && t < Q ? cm.at(bi, ci, t, g) + n : cm.p, nin && t < Q,
             vec_bc);
        cp16(Bb + (buf * kT + r) * kLC + n - n0,
             nin && s < Q ? bm.at(bi, ci, s, g) + n : bm.p, nin && s < Q,
             vec_bc);
      }
      cp_commit();
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load(0, 0);
    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      if (step + 1 < steps) {
        load(step + 1, buf ^ 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* C = Cb + buf * kT * kLC;
      const float* Bt = Bb + buf * kT * kLC;
#pragma unroll
      for (int n = 0; n < kNc; n += 4) {
        float4 ca[4], ba[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = ld4(&C[(4 * ty + i) * kLC + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) ba[j] = ld4(&Bt[(tx + 16 * j) * kLC + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(ca[i].x, ba[j].x, acc[i][j]);
            acc[i][j] = fmaf(ca[i].y, ba[j].y, acc[i][j]);
            acc[i][j] = fmaf(ca[i].z, ba[j].z, acc[i][j]);
            acc[i][j] = fmaf(ca[i].w, ba[j].w, acc[i][j]);
          }
      }
      if (step % n_nc == n_nc - 1) {
        const int s0 = (step / n_nc) * kT;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            Gs[(4 * ty + i) * GL + s0 + tx + 16 * j] = acc[i][j];
            acc[i][j] = 0.f;
          }
      }
      __syncthreads();  // buf is refilled by the next step's load
    }
  }

  // ---- phase 2: per head of the group, Y_h = M_h X_h --------------------
  const int grp = tid >> 7, gtid = tid & 127;
  const int tx = gtid & 7, ty = gtid >> 3;  // rows 4ty+i, cols 4tx(+32)
  float* Ms = area + grp * (kT * kT * 3 + 6 * kT);  // [kT][kT], swizzled
  float* Xb = Ms + kT * kT;                         // [2][kT][kT]
  float* vecs = Xb + 2 * kT * kT;                   // [2][3][kT]
  const int n_pc = (P + kT - 1) / kT;
  const int my_heads = nh > grp ? (nh - grp + 1) / 2 : 0;
  const int steps = my_heads * n_pc * n_s;

  // step = ((head k) * n_pc + p chunk) * n_s + s tile
  auto load = [&](int step, int buf) {
    const int si = step % n_s, pc = (step / n_s) % n_pc;
    const int h = h_first + grp + 2 * (step / (n_s * n_pc));
    const int s0 = si * kT, p0 = pc * kT;
    float* X = Xb + buf * kT * kT;
    for (int i = gtid; i < kT * (kT / 4); i += 128) {
      const int r = i >> 4, p = p0 + 4 * (i & 15), s = s0 + r;
      const bool ok = s < Q && p < P;
      cp16(X + r * kT + p - p0, ok ? x.at(bi, ci, s, h) + p : x.p, ok, vec_x);
    }
    float* v = vecs + buf * 3 * kT;  // cum_s, dt_s, cum_t
    if (gtid < kT) {
      const int s = s0 + gtid, t = t0 + gtid;
      cp4(v + gtid, s < Q ? cum.at(bi, ci, s, h) : cum.p, s < Q);
      cp4(v + 2 * kT + gtid, t < Q ? cum.at(bi, ci, t, h) : cum.p, t < Q);
    } else {
      const int s = s0 + gtid - kT;
      cp4(v + gtid, s < Q ? dt.at(bi, ci, s, h) : dt.p, s < Q);
    }
    cp_commit();
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (steps > 0) load(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const int si = step % n_s, pc = (step / n_s) % n_pc;
    const int h = h_first + grp + 2 * (step / (n_s * n_pc));
    if (step + 1 < steps) {
      load(step + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    group_sync(1 + grp);
    // M for this s tile, exp only on s <= t
    const float* v = vecs + buf * 3 * kT;
    const int s0 = si * kT;
    for (int i = gtid; i < kT * kT; i += 128) {
      const int r = i >> 6, c = i & 63, t = t0 + r, s = s0 + c;
      float m = 0.f;
      if (s <= t && t < Q)  // s < Q follows
        m = Gs[r * GL + s] * expf(v[2 * kT + r] - v[c]) * v[kT + c];
      Ms[ms_idx(r, c)] = m;
    }
    group_sync(1 + grp);
    const float* X = Xb + buf * kT * kT;
#pragma unroll 2
    for (int ss = 0; ss < kT; ss += 4) {
      float4 ma[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ma[i] = ld4(&Ms[(4 * ty + i) * kT +
                        ((((ss >> 2) ^ (ty & 15))) << 2)]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 xa = ld4(&X[(ss + k) * kT + 4 * tx]);
        const float4 xb = ld4(&X[(ss + k) * kT + 32 + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mk = comp(ma[i], k);
          acc[i][0] = fmaf(mk, xa.x, acc[i][0]);
          acc[i][1] = fmaf(mk, xa.y, acc[i][1]);
          acc[i][2] = fmaf(mk, xa.z, acc[i][2]);
          acc[i][3] = fmaf(mk, xa.w, acc[i][3]);
          acc[i][4] = fmaf(mk, xb.x, acc[i][4]);
          acc[i][5] = fmaf(mk, xb.y, acc[i][5]);
          acc[i][6] = fmaf(mk, xb.z, acc[i][6]);
          acc[i][7] = fmaf(mk, xb.w, acc[i][7]);
        }
      }
    }
    if (si == n_s - 1) {
      // y is contiguous [B*NC, Q, H, P]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        float* yr = y + (((long long)bc * Q + t) * H + h) * P + pc * kT;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = pc * kT + 32 * half + 4 * tx;
          if (t < Q && p < P)
            *reinterpret_cast<float4*>(yr + 32 * half + 4 * tx) =
                make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                            acc[i][4 * half + 2], acc[i][4 * half + 3]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    group_sync(1 + grp);  // Ms and X[buf] are rewritten next
  }
}

// st[bc, h] = X_h^T (w_h o B_g) for the block's heads, one P x N chunk
__global__ void __launch_bounds__(kSThreads)
ssd_state_kernel(View x, View dt, View cum, View bm, float* __restrict__ st,
                 int NC, int Q, int H, int P, int N, int G, int rep,
                 int vec_x, int vec_bc) {
  extern __shared__ float4 smem4[];
  // Bs [2][kSq][128], Xs [2][kSHB][kSq][64], cs/ds [2][kSHB][kSq],
  // ws [kSHB][kSq], cend [kSHB]
  float* Bs = reinterpret_cast<float*>(smem4);
  float* Xs = Bs + 2 * kSq * 128;
  float* cs = Xs + 2 * kSHB * kSq * 64;
  float* ds = cs + 2 * kSHB * kSq;
  float* ws = ds + 2 * kSHB * kSq;
  float* cend = ws + kSHB * kSq;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bcg = blockIdx.x, g = bcg % G, bc = bcg / G;
  const int bi = bc / NC, ci = bc % NC;
  const int h_first = g * rep + blockIdx.y * kSHB;
  const int nh = min(kSHB, rep - blockIdx.y * kSHB);
  const int n_nchunk = (N + 127) / 128;
  const int p0 = (blockIdx.z / n_nchunk) * 64;
  const int n0 = (blockIdx.z % n_nchunk) * 128;
  if (tid < nh) cend[tid] = *cum.at(bi, ci, Q - 1, h_first + tid);

  auto load = [&](int qt, int buf) {
    const int q0 = qt * kSq;
    for (int i = tid; i < kSq * 32; i += kSThreads) {
      const int r = i >> 5, n = n0 + 4 * (i & 31), q = q0 + r;
      const bool ok = q < Q && n < N;
      cp16(Bs + (buf * kSq + r) * 128 + n - n0,
           ok ? bm.at(bi, ci, q, g) + n : bm.p, ok,
           vec_bc);
    }
    for (int i = tid; i < kSHB * kSq * 16; i += kSThreads) {
      const int k = i / (kSq * 16), r = (i / 16) % kSq;
      const int p = p0 + 4 * (i & 15), q = q0 + r;
      const bool ok = k < nh && q < Q && p < P;
      cp16(Xs + ((buf * kSHB + k) * kSq + r) * 64 + p - p0,
           ok ? x.at(bi, ci, q, h_first + k) + p : x.p,
           ok, vec_x);
    }
    if (tid < kSHB * kSq) {
      const int k = tid / kSq, r = tid % kSq, q = q0 + r;
      const bool ok = k < nh && q < Q;
      cp4(cs + (buf * kSHB + k) * kSq + r,
          ok ? cum.at(bi, ci, q, h_first + k) : cum.p, ok);
      cp4(ds + (buf * kSHB + k) * kSq + r,
          ok ? dt.at(bi, ci, q, h_first + k) : dt.p, ok);
    }
    cp_commit();
  };

  float acc[kSHB][4][8];
#pragma unroll
  for (int k = 0; k < kSHB; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][i][j] = 0.f;

  const int n_q = (Q + kSq - 1) / kSq;
  load(0, 0);
  for (int qt = 0; qt < n_q; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_q) {
      load(qt + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (tid < kSHB * kSq) {  // weights, one exp per (head, q)
      const int k = tid / kSq, r = tid % kSq;
      const int o = (buf * kSHB + k) * kSq + r;
      ws[k * kSq + r] = k < nh ? expf(cend[k] - cs[o]) * ds[o] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kSq; ++r) {
      const float4 b0 = ld4(Bs + (buf * kSq + r) * 128 + 4 * tx);
      const float4 b1 = ld4(Bs + (buf * kSq + r) * 128 + 64 + 4 * tx);
#pragma unroll
      for (int k = 0; k < kSHB; ++k) {
        if (k < nh) {
          const float w = ws[k * kSq + r];
          const float4 xv =
              ld4(Xs + ((buf * kSHB + k) * kSq + r) * 64 + 4 * ty);
          const float xs[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[k][i][0] = fmaf(xs[i], b0.x, acc[k][i][0]);
            acc[k][i][1] = fmaf(xs[i], b0.y, acc[k][i][1]);
            acc[k][i][2] = fmaf(xs[i], b0.z, acc[k][i][2]);
            acc[k][i][3] = fmaf(xs[i], b0.w, acc[k][i][3]);
            acc[k][i][4] = fmaf(xs[i], b1.x, acc[k][i][4]);
            acc[k][i][5] = fmaf(xs[i], b1.y, acc[k][i][5]);
            acc[k][i][6] = fmaf(xs[i], b1.z, acc[k][i][6]);
            acc[k][i][7] = fmaf(xs[i], b1.w, acc[k][i][7]);
          }
        }
      }
    }
    __syncthreads();  // buf is refilled by the next tile's load
  }

#pragma unroll
  for (int k = 0; k < kSHB; ++k) {
    if (k >= nh) continue;
    float* out = st + ((long long)bc * H + h_first + k) * P * N;  // [P, N]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 4 * ty + i;
      if (p >= P) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + 64 * half + 4 * tx;
        if (n < N)
          *reinterpret_cast<float4*>(out + (long long)p * N + n) =
              make_float4(acc[k][i][4 * half], acc[k][i][4 * half + 1],
                          acc[k][i][4 * half + 2], acc[k][i][4 * half + 3]);
      }
    }
  }
}

View make_view(const void* p, long long sb, long long sc, long long sq,
               long long sh) {
  return View{static_cast<const float*>(p), sb, sc, sq, sh};
}

// pointer and the strides of every dim longer than one are 16-byte aligned
bool vec_ok(const void* p, long long sb, long long sc, long long sq,
            long long sh, int nb, int nc, int nq, int nh) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const long long s[4] = {sb, sc, sq, sh};
  const int n[4] = {nb, nc, nq, nh};
  for (int i = 0; i < 4; ++i)
    if (n[i] > 1 && s[i] % 4) return false;
  return true;
}

}  // namespace

// Each of x, dt, cum, b, c is (pointer, strides of its first four dims):
// x [B, NC, Q, H, P], dt/cum [B, NC, Q, H] (fourth stride 1), b/c [B, NC,
// Q, G, N].  Outputs: y [B, NC, Q, H, P] and st [B, NC, H, P, N],
// contiguous f32.  Requires P, N multiples of 4, at most 256, and Q at
// most 448.
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
  if (G <= 0 || H % G != 0 || P % 4 || N % 4 || P > 256 || N > 256 ||
      Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  const View v[5] = {make_view(x, xb, xc, xq, xh),
                     make_view(dt, db, dc, dq, dh),
                     make_view(cum, cb, cc, cq, ch),
                     make_view(b, bb, bc, bq, bg),
                     make_view(c, ccb, ccc, ccq, ccg)};
  const int vec_x = vec_ok(x, xb, xc, xq, xh, B, NC, Q, H);
  const int vec_bc = vec_ok(b, bb, bc, bq, bg, B, NC, Q, G) &&
                     vec_ok(c, ccb, ccc, ccq, ccg, B, NC, Q, G);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rep = H / G, BNCG = B * NC * G;
  const int hb = rep;  // heads per Y block
  const int n_t = (Q + kT - 1) / kT;
  const int GL = n_t * kT + 4;
  const size_t area = (size_t)2 * (kT * kT * 3 + 6 * kT) > (size_t)4 * kT * kLC
                          ? (size_t)2 * (kT * kT * 3 + 6 * kT)
                          : (size_t)4 * kT * kLC;
  const size_t smem = sizeof(float) * ((size_t)kT * GL + area);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_y_kernel<<<dim3((unsigned)BNCG, (unsigned)((rep + hb - 1) / hb),
                      (unsigned)n_t),
                 kYThreads, smem, s>>>(v[0], v[1], v[2], v[3], v[4],
                                       static_cast<float*>(y), NC, Q, H, P,
                                       N, G, rep, hb, vec_x, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = ((P + 63) / 64) * ((N + 127) / 128);
  const int state_smem =
      (int)sizeof(float) * (2 * kSq * 128 + 2 * kSHB * kSq * 64 +
                            5 * kSHB * kSq + kSHB);
  err = cudaFuncSetAttribute(ssd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3((unsigned)BNCG, (unsigned)((rep + kSHB - 1) / kSHB),
                          (unsigned)chunks),
                     kSThreads, state_smem, s>>>(v[0], v[1], v[2], v[3],
                                        static_cast<float*>(st), NC, Q, H, P,
                                        N, G, rep, vec_x, vec_bc);
  return (int)cudaGetLastError();
}
