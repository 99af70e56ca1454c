// Flash attention forward on Hopper's tensor cores for narrow heads: bf16
// q/k/v, head dim D in {16, 32}, causal and/or sliding-window masks, GQA,
// f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) on the bf16 path at head dims 16 and 32
// (the SMOKE configs' widths; those configs serve in f32, so bf16 at these
// widths is a config's own choice: no shipped config makes it).
// flash_attention_wgmma.cu takes bf16 at D in {64, 128, 256};
// flash_attention.cu takes f32.
//
// What bounds it: neither the tensor cores nor memory.  At D = 32 a key
// costs 4·32 flops per query against one exponential, so the SFU's 16
// exponentials a clock per SM and the latency of each key tile's chain
// (load, Q·Kᵀ, row max, exp, P·V) set the time; the operations bound
// (989 TFLOP/s bf16) is far below.  Under the causal mask the last query
// tile walks every key tile in series, so that walk is the kernel's time.
// wgmma does not fit: its 128-byte swizzled boxes are 64 bf16 columns
// wide, and a 16- or 32-column head is a 32- or 64-byte row.
//
// Design:
//   * One block per (64-row query tile, head, batch), launched longest
//     tile first (causal: the last query tile sees the most keys); 4
//     warps of 16 query rows each.
//   * Loads: 16-byte cp.async copies into a 3-stage ring of K/V tiles of
//     128 keys (two tiles in flight while one is multiplied); Q once.  Rows
//     are XOR-swizzled by 16-byte chunk so that every ldmatrix reads 8
//     distinct bank groups.  One block barrier per key tile publishes the
//     tile and frees the stage read two tiles ago.  Keys and rows past S
//     are zero-filled and masked, so any S runs.
//   * S = Q Kᵀ: mma.sync m16n8k16, bf16 in, f32 accumulate; Q's A
//     fragments are loaded once into registers (ldmatrix), K's B fragments
//     by ldmatrix per tile.
//   * Online softmax on the f32 S fragment in registers: row max and sum
//     over the quad of lanes that share a row (xor shuffles), exp2 of the
//     logit scaled inside an FMA; the row sum stays a per-thread partial
//     until the end.  A masked score is -inf; a row with no live key so
//     far keeps p = 0, so a fully masked row writes 0.
//   * O += P V: P is rounded to bf16 in registers straight into the A
//     fragment (two n8 accumulator tiles are one k16 A tile), the same
//     single extra rounding the wgmma kernel makes; V's B fragments by
//     ldmatrix.trans from its [key][d] rows.
//   * Explicit positions (qpos/kpos, int32 [B, S]): a key is live when
//     kpos <= qpos (causal) and kpos > qpos - window; the walk takes the
//     query tile's key range [lo, hi) from the wrapper (ranges, int4 [B,
//     ceil(S / 64)]) and masks by position the tiles outside the run
//     [full_lo, full_hi) that the positions' extremes prove unmasked.
//   * A warp skips the key tiles wholly masked for its own 16 rows.
//   * Epilogue: acc / l to bf16 pairs, stored in o's strides.
//
// C interface (ctypes): pointers and the stream are void*, sizes int,
// strides 64-bit (in elements); returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 3;

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;
};

template <int D>
struct Tile {
  static constexpr int CPR = D / 8;  // 16-byte chunks of a row
  // chunk c of row r sits at c ^ ((r >> SH) & (CPR - 1)): the 8 rows of
  // an ldmatrix land in 8 distinct 16-byte bank groups
  static constexpr int SH = CPR == 4 ? 1 : 2;
  static constexpr int KV = kBK * D;  // elements of one K or V tile
  static constexpr int SMEM_BYTES = 2 * (kBQ * D + kStages * 2 * KV);
  static_assert(D == 16 || D == 32, "narrow heads only");
};

template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return c ^ ((r >> Tile<D>::SH) & (Tile<D>::CPR - 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[4] += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one SFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of a [S, D] head slab into a swizzled [ROWS][D]
// tile, rows past S zero-filled.  Each thread copies one chunk column,
// every RSTEP-th row: a fixed count of copies, no division in the loop.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int CPR = Tile<D>::CPR, RSTEP = kThreads / CPR;
  static_assert(ROWS % RSTEP == 0, "whole rows per pass");
  const int c = threadIdx.x % CPR, rt = threadIdx.x / CPR;
  const bf16* g = src + (long long)(r0 + rt) * row_stride + 8 * c;
  const long long step = (long long)RSTEP * row_stride;
#pragma unroll
  for (int j = 0; j < ROWS / RSTEP; ++j) {
    const int r = rt + j * RSTEP;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * D + 8 * swz<D>(r, c), ok ? g : src, ok);
    g += step;
  }
}

// BY_POS: positions given (a separate instantiation, so the index-masked
// kernel's code is the same as without the positions path)
template <int D, bool BY_POS>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 const int4* __restrict__ ranges, int S, int H, int B,
                 int group, Strides sq, Strides sk, Strides sv, Strides so,
                 int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int NT = kBK / 8;  // n8 tiles of S
  constexpr int ND = D / 8;    // n8 tiles of O
  extern __shared__ uint4 smem16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem16);  // [kBQ][D]
  bf16* KVs = Qs + kBQ * D;                    // [kStages][K, V][kBK][D]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (H * B);
  const int order = blockIdx.x / (H * B);
  const int qt = causal ? n_qt - 1 - order : order;  // longest first
  const int h = bh % H, b = bh / H, hk = h / group;
  const int q0 = qt * kBQ;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;

  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = causal ? q_last + 1 : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  int full_lo = 0, full_hi = 0;  // key tiles no position masks
  if constexpr (BY_POS) {  // >= 1 tile: the wrapper gives no empty range
    const int4 r = ranges[(long long)b * n_qt + qt];
    k_begin = r.x;
    k_end = r.y;
    full_lo = r.z;
    full_hi = r.w;
  }
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  // this thread's fragment rows (ra, rb = ra + 8) and column pair
  const int wr0 = q0 + 16 * w;
  const int wr_last = min(wr0 + 16, S) - 1;
  const int ra = wr0 + (lane >> 2), rb = ra + 8;
  const int cq = 2 * (lane & 3);
  int pos_a = 0, pos_b = 0;
  if constexpr (BY_POS) {
    if (ra < S) pos_a = qpos[(long long)b * S + ra];
    if (rb < S) pos_b = qpos[(long long)b * S + rb];
  }

  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      bf16* st = KVs + (it % kStages) * 2 * T::KV;
      const int kt = k_begin + it * kBK;
      load_rows<D, kBK>(st, kb, sk.s, kt, S);
      load_rows<D, kBK>(st + T::KV, vb, sv.s, kt, S);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
  load_rows<D, kBQ>(Qs, qb, sq.s, q0, S);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_kv(st);

  uint32_t qa[D / 16][4];  // Q's A fragments, loaded once
  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * kBK;
    cp_async_wait<kStages - 2>();  // tile it (and Q) has landed here
    __syncthreads();               // everywhere; tile it - 1 is consumed
    if (it == 0) {
      // A fragment of rows 16w + [0, 16), columns 16kk + [0, 16):
      // matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15)
      const int r = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[kk], Qs + r * D + 8 * swz<D>(r, 2 * kk + (lane >> 4)));
    }
    load_kv(it + kStages - 1);  // into the stage tile it - 1 held
    const bf16* Ks = KVs + (it % kStages) * 2 * T::KV;
    const bf16* Vs = Ks + T::KV;

    bool skip = wr0 >= S;
    if constexpr (!BY_POS)
      skip = skip || (causal && kt > wr_last) ||
             (window > 0 && kt + kBK - 1 <= wr0 - window);
    if (skip) continue;

    // S = Q K^T: B fragments of two n8 tiles (keys 16jp + [0, 16)) per
    // ldmatrix.x4: matrices (keys 0-7 | 8-15) x (columns 0-7 | 8-15)
    float sacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int key = 16 * jp + 8 * (lane >> 4) + (lane & 7);
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + key * D +
                            8 * swz<D>(key, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(sacc[2 * jp], qa[kk], kf[0], kf[1]);
        mma_bf16(sacc[2 * jp + 1], qa[kk], kf[2], kf[3]);
      }

    // masks, then the online softmax of the fragment in place
    bool need_mask, pos_mask = false;
    if constexpr (BY_POS) {
      need_mask = kt + kBK > S;
      pos_mask = !(kt >= full_lo && kt + kBK <= full_hi);
    } else {
      need_mask = kt + kBK > S || (causal && kt + kBK - 1 > wr0) ||
                  (window > 0 && kt <= wr_last - window);
    }
    if (need_mask || pos_mask) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kt + 8 * j + cq + c;
          bool live_a = key < S, live_b = key < S;
          if constexpr (BY_POS) {
            if (pos_mask) {
              const long long kp =
                  key < S ? __ldg(kpos + (long long)b * S + key) : 0;
              live_a = live_a && (!causal || kp <= pos_a) &&
                       (window <= 0 || kp > (long long)pos_a - window);
              live_b = live_b && (!causal || kp <= pos_b) &&
                       (window <= 0 || kp > (long long)pos_b - window);
            }
          } else {
            live_a = live_a && (!causal || key <= ra) &&
                     (window <= 0 || key > ra - window);
            live_b = live_b && (!causal || key <= rb) &&
                     (window <= 0 || key > rb - window);
          }
          if (!live_a) sacc[j][c] = -INFINITY;
          if (!live_b) sacc[j][2 + c] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sacc[j][0], sacc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sacc[j][2], sacc[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no live key so far keeps p = 0 (exp2(-inf) = 0)
    const float nb_a = mn_a == -INFINITY ? 0.f : -mn_a * scale_log2;
    const float nb_b = mn_b == -INFINITY ? 0.f : -mn_b * scale_log2;
    const float al_a = ex2(fmaf(m_a, scale_log2, nb_a));
    const float al_b = ex2(fmaf(m_b, scale_log2, nb_b));
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sacc[j][0] = ex2(fmaf(sacc[j][0], scale_log2, nb_a));
      sacc[j][1] = ex2(fmaf(sacc[j][1], scale_log2, nb_a));
      sacc[j][2] = ex2(fmaf(sacc[j][2], scale_log2, nb_b));
      sacc[j][3] = ex2(fmaf(sacc[j][3], scale_log2, nb_b));
      sum_a += sacc[j][0] + sacc[j][1];
      sum_b += sacc[j][2] + sacc[j][3];
    }
    l_a = l_a * al_a + sum_a;  // per-thread partial, reduced at the end
    l_b = l_b * al_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      oacc[j][0] *= al_a;
      oacc[j][1] *= al_a;
      oacc[j][2] *= al_b;
      oacc[j][3] *= al_b;
    }

    // O += P V: keys 16t + [0, 16) are one k16 slice (S tiles 2t, 2t + 1
    // as its A fragment); V's B fragments of two n8 tiles (columns 16np +
    // [0, 16)) per ldmatrix.x4.trans: matrices (keys 0-7 | 8-15) x
    // (columns 0-7 | 8-15)
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * t][0], sacc[2 * t][1]),
          pack_bf16(sacc[2 * t][2], sacc[2 * t][3]),
          pack_bf16(sacc[2 * t + 1][0], sacc[2 * t + 1][1]),
          pack_bf16(sacc[2 * t + 1][2], sacc[2 * t + 1][3])};
      const int key = 16 * t + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + key * D +
                                  8 * swz<D>(key, 2 * np + (lane >> 4)));
        mma_bf16(oacc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight at exit

  // epilogue: acc / l in bf16 pairs, in o's strides
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if (ra < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)ra * so.s + 8 * j + cq) =
          pack_bf16(oacc[j][0] * inv_a, oacc[j][1] * inv_a);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)rb * so.s + 8 * j + cq) =
          pack_bf16(oacc[j][2] * inv_b, oacc[j][3] * inv_b);
  }
}

struct Pos {
  const int* q;
  const int* k;
  const int4* ranges;
};

// the kernel's shared-memory attribute, set once per device before its
// first launch or occupancy query; returns a CUDA error code
template <int D, bool BY_POS>
int prepare() {
  static signed char done[64];  // per device: 0 not yet, 1 set
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && done[dev]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D, BY_POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::SMEM_BYTES);
  if (err == cudaSuccess && dev < 64) done[dev] = 1;
  return (int)err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Pos pos,
           int B, int H, int KV, int S, const Strides* st, int causal,
           int window, cudaStream_t stream) {
  const bool by_pos = pos.q != nullptr;
  const int err = by_pos ? prepare<D, true>() : prepare<D, false>();
  if (err) return err;
  auto kernel = by_pos ? flash_mma_kernel<D, true>
                       : flash_mma_kernel<D, false>;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<(unsigned)blocks, kThreads, Tile<D>::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), pos.q, pos.k,
      pos.ranges, S, H, B, H / KV, st[0], st[1], st[2], st[3], causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int config(int* out) {
  out[0] = kBQ;
  out[1] = kBK;
  out[2] = kThreads;
  out[3] = Tile<D>::SMEM_BYTES;
  const int err = prepare<D, false>();
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], flash_mma_kernel<D, false>, kThreads, Tile<D>::SMEM_BYTES);
}

}  // namespace

// bf16 only, D in {16, 32}.  qpos/kpos: int32 [B, S] positions and
// ranges: int32 [B, ceil(S / 64), 4] key ranges, all three null for the
// index mask.  Strides (in elements) are (b, h, s) for q, k, v and o in
// that order; the head dim is contiguous; pointers and strides of more
// than one element must be 16-byte aligned (cp.async).
extern "C" int flash_attention_mma_fwd(
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tiling at head dim D on `device`: out[5] = query tile, key tile,
// threads a block, shared bytes a block, resident blocks per SM.
extern "C" int flash_attention_mma_config(int D, int device, int* out) {
  cudaSetDevice(device);
  switch (D) {
    case 16:
      return config<16>(out);
    case 32:
      return config<32>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
