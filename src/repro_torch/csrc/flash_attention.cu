// Flash attention forward on Hopper's CUDA cores: f32 q/k/v, head dim D in
// {16, 32, 64, 128, 256}, causal and/or sliding-window masks, GQA, f32
// online softmax, exact f32 products (FMA only: no TF32).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) on the f32 prefill path (every SMOKE
// config, and any config served in f32).  bf16 goes to the tensor cores:
// flash_attention_wgmma.cu at D in {64, 128, 256}, flash_attention_mma.cu
// at D in {16, 32}.
//
// What bounds it: f32 operations.  4·D flops per unmasked (query, key)
// pair against 67 TFLOP/s, about 64 flops per byte at granite's widths,
// so the card's FMA pipe is the ceiling.  The design keeps that pipe fed:
//   * Loads never stall the products.  K and V tiles of BK keys go through
//     a 2-stage ring in shared memory, filled by 16-byte cp.async copies
//     (f32 needs no conversion): tile t + 1 is in flight while tile t is
//     multiplied.  Q is loaded once.  One block-wide barrier per key tile
//     both publishes tile t and frees tile t - 1's stage for t + 1.
//   * A register micro-tile of R query rows × 8 keys (S = Q·Kᵀ) and R rows
//     × 8 head columns (O += P·V) per thread at D = 32, 64 (R = 8): each
//     16-byte shared-memory read feeds 16–32 FMAs, an average of 16.  At
//     D = 128 the accumulator is 8 × 16 and S is 8 × 4; at D = 256, 4 × 32
//     and 4 × 4 (D = 16, 256: another tiling, correct but not tuned).
//     One byte of shared-memory traffic per FMA is the SM's own balance
//     (128 bytes and 128 FMAs a clock), so shared memory binds beside the
//     FMA pipe; a larger tile would not fit 255 registers beside the O
//     accumulator.
//   * Conflict-free shared memory without padding: K and V rows are
//     stored with their 16-byte chunks XOR-swizzled by (key / 4) mod 8, Q
//     and P by (row / R) mod 8, so the reads of a warp (one row or key
//     per lane group, the same chunk) hit distinct banks, and a thread's
//     R rows (contiguous) share one swizzle.
//   * Each warp owns its query rows in both products, so P passes from S
//     to P·V through the warp's own shared memory under __syncwarp, 4·TX
//     keys at a time; the only block barrier is the ring's.  A warp skips
//     the key tiles wholly masked for its own rows (under the causal
//     diagonal or left of the window).
//   * Occupancy: 2 blocks of 4 warps per SM at D <= 64 (112 KB of shared
//     memory at D = 64: Q 32, ring 64, P 16), 2 blocks of 2 warps at
//     D = 128, 1 block of 4 warps at D = 256 (flash_attention_simt_config
//     reports it).
//   * Heavy first: under the causal mask the grid's first blocks take the
//     last (longest) query tiles.
//   * Online softmax on the score registers: row max over the TX lanes of
//     a row group by xor shuffles, exp2 (one SFU op) of the logit scaled
//     inside an FMA; the row sum stays a per-thread partial until the end.
//     A masked score is -inf and a row with no live key so far keeps p =
//     0, so a fully masked row writes 0 (acc / max(l, 1e-30)).
//   * Explicit positions (qpos/kpos, int32 [B, S], the JAX package's
//     prefill mask): a key is live when kpos <= qpos (causal) and kpos >
//     qpos - window.  The tile walk takes the query tile's key range [lo,
//     hi) from the wrapper (ranges, int4 [B, ceil(S / BQ)]) and masks by
//     position the tiles outside the run [full_lo, full_hi) that the
//     positions' extremes prove wholly unmasked.
//   * Strided inputs: (b, h, s) strides in elements, the head dim
//     contiguous, pointers and strides 16-byte aligned (cp.async), so the
//     model's [B, S, H, D] tensors are read in place; keys and rows at or
//     past S are zero-filled and masked, so any S runs.
//
// C interface (ctypes): pointers and the stream are void*, sizes int,
// strides 64-bit; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;
};

// Per head dim: R query rows per thread, a warp's lanes as TY row groups
// x TX key / column groups, warps per block, key tile, blocks per SM, and
// the unroll of the S = Q K^T chunk loop (SU) and of the P V chunk loop
// (PU).  Chosen by measurement on the H100 (scripts/
// flash_narrow_variants.py, PERF.md).
template <int D>
struct Cfg;
template <>
struct Cfg<16> {
  static constexpr int R = 4, TY = 8, TX = 4, WARPS = 4, BK = 64, MINB = 2;
  static constexpr int SU = 1, PU = 2;
};
template <>
struct Cfg<32> {
  static constexpr int R = 8, TY = 4, TX = 8, WARPS = 4, BK = 64, MINB = 2;
  static constexpr int SU = 1, PU = 2;
};
template <>
struct Cfg<64> {
  static constexpr int R = 8, TY = 4, TX = 8, WARPS = 4, BK = 64, MINB = 2;
  static constexpr int SU = 1, PU = 2;
};
template <>
struct Cfg<128> {
  static constexpr int R = 8, TY = 4, TX = 8, WARPS = 2, BK = 32, MINB = 2;
  static constexpr int SU = 2, PU = 1;
};
template <>
struct Cfg<256> {
  static constexpr int R = 4, TY = 4, TX = 8, WARPS = 4, BK = 32, MINB = 1;
  static constexpr int SU = 2, PU = 2;
};

template <int D>
struct Tile : Cfg<D> {
  using C = Cfg<D>;
  static constexpr int THREADS = 32 * C::WARPS;
  static constexpr int RW = C::R * C::TY;        // query rows of a warp
  static constexpr int RSH = C::R == 8 ? 3 : 2;  // log2 R
  static constexpr int BQ = RW * C::WARPS;        // query rows of a block
  static constexpr int KG = C::BK / (4 * C::TX);  // key float4s a thread
  static constexpr int CG = D / (4 * C::TX);      // column float4s a thread
  static constexpr int PK = 4 * C::TX;            // keys of one P pass
  static constexpr int CH = D / 4;                // 16-byte chunks a row
  static constexpr int SW = (CH < 8 ? CH : 8) - 1;  // chunk swizzle mask
  static constexpr int STAGES = 2;
  static constexpr int KV_FLOATS = C::BK * D;     // one K or V tile
  static constexpr int P_FLOATS = RW * PK;        // one warp's P pass
  static constexpr int SMEM_FLOATS =
      BQ * D + STAGES * 2 * KV_FLOATS + C::WARPS * P_FLOATS;
  static_assert(C::TY * C::TX == 32, "a warp is TY x TX lanes");
  static_assert(KG >= 1 && CG >= 1, "tile too narrow for the lanes");
  static_assert(SW < C::TX, "a thread's keys share one swizzle");
  static_assert(C::R == 1 << RSH, "R is 4 or 8");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float ex2(float x) {  // 2^x, one SFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [r0, r0 + ROWS) of a [S, D] head slab into a [ROWS][D] tile whose
// chunk c of row r sits at chunk c ^ ((r >> SHIFT) & SW); rows past S are
// zero-filled.  Each thread copies one chunk column, every RSTEP-th row:
// a fixed count of copies, no division in the loop.
template <int D, int SHIFT, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int S) {
  using T = Tile<D>;
  constexpr int RSTEP = T::THREADS / T::CH;
  static_assert(T::THREADS % T::CH == 0 && ROWS % RSTEP == 0,
                "whole rows per pass");
  const int c = threadIdx.x % T::CH, rt = threadIdx.x / T::CH;
  const float* g = src + (long long)(r0 + rt) * row_stride + 4 * c;
  const long long step = (long long)RSTEP * row_stride;
#pragma unroll
  for (int j = 0; j < ROWS / RSTEP; ++j) {
    const int r = rt + j * RSTEP;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * D + 4 * (c ^ ((r >> SHIFT) & T::SW)), ok ? g : src,
               ok);
    g += step;
  }
}

// BY_POS: positions given (a separate instantiation, so the index-masked
// kernel's code is the same as without the positions path)
template <int D, bool BY_POS>
__global__ void __launch_bounds__(Tile<D>::THREADS, Tile<D>::MINB)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  const int* __restrict__ qpos, const int* __restrict__ kpos,
                  const int4* __restrict__ ranges, int S, int H, int B,
                  int group, Strides sq, Strides sk, Strides sv, Strides so,
                  int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int R = T::R, TY = T::TY, TX = T::TX, BK = T::BK, KG = T::KG,
                CG = T::CG, PK = T::PK, RW = T::RW, BQ = T::BQ, SW = T::SW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);    // [BQ][D], swizzled
  float* KVs = Qs + BQ * D;                       // [2][K, V][BK][D]
  float* Ps = KVs + T::STAGES * 2 * T::KV_FLOATS;  // [WARPS][RW][PK]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tx = lane % TX, ty = lane / TX;
  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % (H * B);
  const int order = blockIdx.x / (H * B);
  const int qt = causal ? n_qt - 1 - order : order;  // longest first
  const int h = bh % H, b = bh / H, hk = h / group;
  const int q0 = qt * BQ;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  // the key range this query tile can see, in whole tiles
  const int q_last = min(q0 + BQ, S) - 1;
  int k_end = causal ? q_last + 1 : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  int full_lo = 0, full_hi = 0;  // key tiles no position masks
  if constexpr (BY_POS) {  // >= 1 tile: the wrapper gives no empty range
    const int4 r = ranges[(long long)b * n_qt + qt];
    k_begin = r.x;
    k_end = r.y;
    full_lo = r.z;
    full_hi = r.w;
  }
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // this warp's rows: wr0 + R * ty + i; their Q and P chunks share the
  // swizzle of row group w * TY + ty
  const int wr0 = q0 + w * RW;
  const int qsw = (w * TY + ty) & SW, psw = ty & (TX - 1);
  const int wr_last = min(wr0 + RW, S) - 1;
  int rpos[R];  // the rows' positions
#pragma unroll
  for (int i = 0; i < R; ++i) {
    rpos[i] = 0;
    if constexpr (BY_POS) {
      const int qi = wr0 + R * ty + i;
      if (qi < S) rpos[i] = qpos[(long long)b * S + qi];
    }
  }

  auto load_kv = [&](int it) {
    float* st = KVs + (it & 1) * 2 * T::KV_FLOATS;
    const int kt = k_begin + it * BK;
    load_rows<D, 2, BK>(st, kb, sk.s, kt, S);
    load_rows<D, 2, BK>(st + T::KV_FLOATS, vb, sv.s, kt, S);
  };
  load_rows<D, T::RSH, BQ>(Qs, qb, sq.s, q0, S);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float m[R], l[R], acc[R][CG][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const float* Qw = Qs + w * RW * D;  // this warp's rows
  float* Pw = Ps + w * T::P_FLOATS;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * BK;
    cp_async_wait_all();  // this thread's copies of tile it have landed
    __syncthreads();      // everyone's have; tile it - 1 is consumed
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    const float* Ks = KVs + (it & 1) * 2 * T::KV_FLOATS;
    const float* Vs = Ks + T::KV_FLOATS;

    // a tile wholly masked for this warp's rows is skipped
    bool skip = wr0 >= S;
    if constexpr (!BY_POS)
      skip = skip || (causal && kt > wr_last) ||
             (window > 0 && kt + BK - 1 <= wr0 - window);
    if (skip) continue;

    // S = Q K^T: keys 4 * (tx + TX * g) + u of the tile (their chunks
    // share the swizzle tx & SW), rows R * ty + i of the warp
    float s[R][KG][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[i][g][u] = 0.f;
#pragma unroll T::SU
    for (int c = 0; c < T::CH; ++c) {
      float4 kf[KG][4];
      const int kc = 4 * (c ^ (tx & SW));
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          kf[g][u] = ld4(Ks + (4 * (tx + TX * g) + u) * D + kc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qf = ld4(Qw + (R * ty + i) * D + 4 * (c ^ qsw));
#pragma unroll
        for (int g = 0; g < KG; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float a = s[i][g][u];
            a = fmaf(qf.x, kf[g][u].x, a);
            a = fmaf(qf.y, kf[g][u].y, a);
            a = fmaf(qf.z, kf[g][u].z, a);
            a = fmaf(qf.w, kf[g][u].w, a);
            s[i][g][u] = a;
          }
      }
    }

    // masks: by index on tiles crossing the diagonal, the window's edge
    // or S; by position outside the wholly unmasked run
    bool need_mask;
    bool pos_mask = false;
    int kp[KG][4];
    if constexpr (BY_POS) {
      need_mask = kt + BK > S;
      pos_mask = !(kt >= full_lo && kt + BK <= full_hi);
      if (pos_mask) {
#pragma unroll
        for (int g = 0; g < KG; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int key = kt + 4 * (tx + TX * g) + u;
            kp[g][u] = key < S ? __ldg(kpos + (long long)b * S + key) : 0;
          }
      }
    } else {
      need_mask = kt + BK > S || (causal && kt + BK - 1 > wr0) ||
                  (window > 0 && kt <= wr_last - window);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = wr0 + R * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float x = s[i][g][u];
          if (need_mask || pos_mask) {
            const int key = kt + 4 * (tx + TX * g) + u;
            bool live = key < S;
            if constexpr (BY_POS) {
              if (pos_mask)
                live = live && (!causal || kp[g][u] <= rpos[i]) &&
                       (window <= 0 ||
                        (long long)kp[g][u] > (long long)rpos[i] - window);
            } else {
              live = live && (!causal || key <= qi) &&
                     (window <= 0 || key > qi - window);
            }
            x = live ? x : -INFINITY;
            s[i][g][u] = x;
          }
          mt = fmaxf(mt, x);
        }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      // a row with no live key so far keeps p = 0 (exp2(-inf) = 0)
      const float nb = mn == -INFINITY ? 0.f : -mn * scale_log2;
      const float alpha = ex2(fmaf(m[i], scale_log2, nb));
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[i][g][u] = ex2(fmaf(s[i][g][u], scale_log2, nb));
          sum += s[i][g][u];
        }
      l[i] = l[i] * alpha + sum;  // per-thread partial, reduced at the end
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }

    // O += P V, PK keys a pass through the warp's P buffer: the pass g
    // holds keys PK * g + [0, PK), chunk tx of row R * ty + i at tx ^ psw
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      __syncwarp();  // the previous pass's readers are done
#pragma unroll
      for (int i = 0; i < R; ++i)
        st4(Pw + (R * ty + i) * PK + 4 * (tx ^ psw),
            make_float4(s[i][g][0], s[i][g][1], s[i][g][2], s[i][g][3]));
      __syncwarp();
#pragma unroll T::PU
      for (int kc = 0; kc < TX; ++kc) {
        float4 pf[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          pf[i] = ld4(Pw + (R * ty + i) * PK + 4 * (kc ^ psw));
        const int vsw = (TX * g + kc) & SW;  // (key >> 2) & SW
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vrow = Vs + (PK * g + 4 * kc + u) * D;
          float4 vf[CG];
#pragma unroll
          for (int c = 0; c < CG; ++c)
            vf[c] = ld4(vrow + 4 * ((tx + TX * c) ^ vsw));
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float p = f4(pf[i], u);
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              acc[i][c][0] = fmaf(p, vf[c].x, acc[i][c][0]);
              acc[i][c][1] = fmaf(p, vf[c].y, acc[i][c][1]);
              acc[i][c][2] = fmaf(p, vf[c].z, acc[i][c][2]);
              acc[i][c][3] = fmaf(p, vf[c].w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }

  cp_async_wait_all();  // no copy is left in flight at exit

  // epilogue: acc / l, 16-byte stores in o's strides
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qi = wr0 + R * ty + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = ob + (long long)qi * so.s;
#pragma unroll
    for (int c = 0; c < CG; ++c)
      st4(orow + 4 * (tx + TX * c),
          make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                      acc[i][c][2] * inv, acc[i][c][3] * inv));
  }
}

struct Pos {
  const int* q;
  const int* k;
  const int4* ranges;
};

// the kernel's shared-memory attributes, set once per device before its
// first launch or occupancy query; returns a CUDA error code
template <int D, bool BY_POS>
int prepare() {
  static signed char done[64];  // per device: 0 not yet, 1 set
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && done[dev]) return 0;
  const int smem = (int)sizeof(float) * Tile<D>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<D, BY_POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        flash_simt_kernel<D, BY_POS>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return (int)err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Pos pos,
           int B, int H, int KV, int S, const Strides* st, int causal,
           int window, cudaStream_t stream) {
  using T = Tile<D>;
  const bool by_pos = pos.q != nullptr;
  const int err = by_pos ? prepare<D, true>() : prepare<D, false>();
  if (err) return err;
  auto kernel = by_pos ? flash_simt_kernel<D, true>
                       : flash_simt_kernel<D, false>;
  const long long blocks = (long long)((S + T::BQ - 1) / T::BQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<(unsigned)blocks, T::THREADS, sizeof(float) * T::SMEM_FLOATS,
           stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), pos.q, pos.k,
      pos.ranges, S, H, B, H / KV, st[0], st[1], st[2], st[3], causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

// out: query tile, key tile, threads, shared bytes, resident blocks per
// SM (of the index-masked instantiation)
template <int D>
int config(int* out) {
  using T = Tile<D>;
  out[0] = T::BQ;
  out[1] = T::BK;
  out[2] = T::THREADS;
  out[3] = (int)sizeof(float) * T::SMEM_FLOATS;
  const int err = prepare<D, false>();
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], flash_simt_kernel<D, false>, T::THREADS,
      sizeof(float) * T::SMEM_FLOATS);
}

}  // namespace

// f32 only.  qpos/kpos: int32 [B, S] positions and ranges: int32 [B,
// ceil(S / BQ), 4] key ranges (BQ, BK: flash_attention_simt_config), all
// three null for the index mask.  Strides (in elements) are (b, h, s) for
// q, k, v and o in that order; the head dim is contiguous; pointers and
// strides of more than one element must be 16-byte aligned (cp.async).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, const void* ranges, int B, int H, int KV, int S, int D,
    long long qb, long long qh, long long qs, long long kb, long long kh,
    long long ks, long long vb, long long vh, long long vs, long long ob,
    long long oh, long long os, int causal, int window, int device,
    void* stream) {
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
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, pos, B, H, KV, S, st, causal, window, s);
    case 32:
      return launch<32>(q, k, v, o, pos, B, H, KV, S, st, causal, window, s);
    case 64:
      return launch<64>(q, k, v, o, pos, B, H, KV, S, st, causal, window, s);
    case 128:
      return launch<128>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                         s);
    case 256:
      return launch<256>(q, k, v, o, pos, B, H, KV, S, st, causal, window,
                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tiling at head dim D on `device`: out[5] = query tile, key tile,
// threads a block, shared bytes a block, resident blocks per SM.
extern "C" int flash_attention_simt_config(int D, int device, int* out) {
  cudaSetDevice(device);
  switch (D) {
    case 16:
      return config<16>(out);
    case 32:
      return config<32>(out);
    case 64:
      return config<64>(out);
    case 128:
      return config<128>(out);
    case 256:
      return config<256>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
