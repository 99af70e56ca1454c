// ELL SpMM for Hopper: out[q, i, :] = sum_k w[q, i, k] * x[q, nbr[q, i, k], :]
//
// Replaces the Pallas TPU kernel repro/kernels/ell_spmm.py::ell_spmm
// (_ell_kernel, the pl.pallas_call at ell_spmm.py:78).  The TPU kernel
// streams source chunks of x through VMEM and masks neighbours outside the
// chunk, so every x row it gathers comes from fast memory.
//
// What bounds it on this card: bytes.  Two flops per gathered f32 against
// the bytes of each referenced x row read once, the lists and out.  But a
// row of x is gathered once per edge that reads it (about 8 times on the
// GNN path), so the bound is within reach only while the rows being
// gathered stay on chip; one partition's x slab (44450 rows of 1 KB at
// F = 256, 45.5 MB) is about the whole 50 MB L2.
//
// Design: the Hopper counterpart of the TPU kernel's VMEM chunks is a
// column slice of x held in L2.
// - Tiles of (partition, column slice of SW columns, row tile) are walked
//   slice-major: partition outermost, then slice, then row tile, so the
//   blocks in flight gather from one partition's column slice of x
//   (44450 x 512 B = 22.8 MB at SW = 128).  Loading a row's lists once and
//   looping over its slices (ELL_SLICE_INNER) gathers from the whole slab
//   and loses.  The grid is persistent (SMs x resident blocks) and each
//   block takes the next tile of that order from a counter the caller
//   zeroes (ELL_PERSIST 2): the order holds across the card and a block
//   that drew short rows takes more tiles.  A static stride (block b takes
//   b, b + grid, ...) loses to the sum of its blocks' unequal tiles.
// - Blocks of 128 threads capped at 48 registers (10 resident per SM)
//   keep 40 warps of an SM in flight: the kernel is bound by how many
//   gathers are outstanding, and more warps beat more gathers per warp.
// - Cache policy per instruction: x gathers carry an L2 evict_last policy
//   (createpolicy + ld.global.nc.L2::cache_hint) and out is written with
//   streaming stores (st.global.cs), so the out stream does not push the
//   slice out.  Nothing device-wide is set (no persisting-L2 limit, no
//   access-policy window).  The lists load with the default policy.
// - A row is owned by LPR lanes (a half-warp), each with CH 16-byte loads
//   per neighbour: SW = LPR * VEC * CH = 128 columns.  A row's ids and
//   weights are loaded once per slice, one slot per lane (32 / LPR slots
//   each), and broadcast by __shfl_sync; a ballot finds the warp's last
//   valid slot and the neighbour loop stops there (valid slots lead in the
//   port's ELL lists; interspersed w == 0 or out-of-range slots are still
//   skipped, so correctness does not lean on that layout).  U slots at a
//   time, their predicated gathers issue before their FMAs.
// - Arithmetic of the plain version: per column, f32 fmaf with k
//   ascending; ids outside [0, n_src) and w == 0 slots contribute nothing.
// - VEC == 1 (any F, any alignment of x): a full warp per row, 4-byte
//   loads, the same raster and slice width.
//
// The macros below hold the shipped design; scripts/ell_spmm_variants.py
// builds this file with -D overrides (slice width, lanes per row, hints,
// tile walk, block size, lists once per row) to measure the others.  Its
// diagnostic builds, whose gathers hit only L1 or L2, show misses to
// device memory as the smaller part of the gap to the bound; issuing the
// gathers and each row's list work are the larger (PERF.md).
//
// C interface (ctypes): pointers and the stream are void*, sizes 64-bit;
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ELL_LPR        // lanes per row (8, 16 or 32)
#define ELL_LPR 16
#endif
#ifndef ELL_VEC        // floats per load on the aligned path (4 or 2)
#define ELL_VEC 4
#endif
#ifndef ELL_CH         // column chunks per lane: SW = LPR * VEC * CH
#define ELL_CH 2
#endif
#ifndef ELL_X_HINT     // x gathers with an L2 evict_last policy
#define ELL_X_HINT 1
#endif
#ifndef ELL_OUT_STREAM // out written with streaming (evict-first) stores
#define ELL_OUT_STREAM 1
#endif
#ifndef ELL_LIST_HINT  // list loads with an L2 evict_last policy
#define ELL_LIST_HINT 0
#endif
#ifndef ELL_PERSIST    // the tile walk: 0 one block a tile, 1 persistent
#define ELL_PERSIST 2  // static stride, 2 persistent, tiles from a counter
#endif
#ifndef ELL_THREADS    // threads per block
#define ELL_THREADS 128
#endif
#ifndef ELL_MINB       // resident blocks per SM asked of ptxas (0: none);
#define ELL_MINB 10    // 10 x 128 threads caps a thread at 48 registers
#endif
#ifndef ELL_SLICE_INNER // tiles (partition, row tile); a row group loads
#define ELL_SLICE_INNER 0 // its lists once and loops over the slices
#endif
#ifndef ELL_UNROLL     // gathers issued before their FMAs
#define ELL_UNROLL 4
#endif

namespace {

constexpr int kThreads = ELL_THREADS;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0, 0, 0, 0); }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0, 0); }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
};

// one gather of VEC floats of x, with or without the evict_last policy
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_x(const float* p,
                                                       uint64_t pol) {
  typename Vec<VEC>::T v;
#if ELL_X_HINT
  if constexpr (VEC == 4) {
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "l"(pol));
  } else if constexpr (VEC == 2) {
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(v.x), "=f"(v.y)
        : "l"(p), "l"(pol));
  } else {
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v)
        : "l"(p), "l"(pol));
  }
#else
  (void)pol;
  v = __ldg(reinterpret_cast<const typename Vec<VEC>::T*>(p));
#endif
  return v;
}

// list loads (weights, ids), with or without the evict_last policy
__device__ __forceinline__ float load_list(const float* p, uint64_t pol) {
#if ELL_LIST_HINT
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
#else
  (void)pol;
  return __ldg(p);
#endif
}

__device__ __forceinline__ int load_list(const int* p, uint64_t pol) {
#if ELL_LIST_HINT
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
#else
  (void)pol;
  return __ldg(p);
#endif
}

template <int VEC>
__device__ __forceinline__ void store_out(float* p,
                                          const float (&a)[VEC]) {
  typename Vec<VEC>::T v;
  if constexpr (VEC == 4) {
    v = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (VEC == 2) {
    v = make_float2(a[0], a[1]);
  } else {
    v = a[0];
  }
#if ELL_OUT_STREAM
  __stcs(reinterpret_cast<typename Vec<VEC>::T*>(p), v);
#else
  *reinterpret_cast<typename Vec<VEC>::T*>(p) = v;
#endif
}

template <int VEC>
__device__ __forceinline__ void fma_vec(float (&acc)[VEC], float wj,
                                        const typename Vec<VEC>::T& v) {
  if constexpr (VEC == 4) {
    acc[0] = fmaf(wj, v.x, acc[0]);
    acc[1] = fmaf(wj, v.y, acc[1]);
    acc[2] = fmaf(wj, v.z, acc[2]);
    acc[3] = fmaf(wj, v.w, acc[3]);
  } else if constexpr (VEC == 2) {
    acc[0] = fmaf(wj, v.x, acc[0]);
    acc[1] = fmaf(wj, v.y, acc[1]);
  } else {
    acc[0] = fmaf(wj, v, acc[0]);
  }
}

// The tile walk shared by both kernels: tiles in the order (partition,
// outer, row tile).  ELL_PERSIST 0: one tile per block, in blockIdx order;
// 1: a persistent grid, block b takes tiles b, b + grid, ...; 2: a
// persistent grid whose blocks take the next tile from a counter.
struct Raster {
  int n_tiles, n_outer, n_rt;
  int* counter;                 // ELL_PERSIST 2: zeroed by the caller
  __device__ __forceinline__ void split(int t, int& part, int& outer,
                                        int& rt) const {
    part = t / (n_outer * n_rt);
    const int rem = t - part * n_outer * n_rt;
    outer = rem / n_rt;
    rt = rem - outer * n_rt;
  }
  // the block's tile after t (t < 0: its first); block-uniform, and a
  // barrier of the block under ELL_PERSIST 2 (s_next: two ints of shared
  // memory, par: the walk's parity)
  __device__ __forceinline__ int next(int t, int* s_next, int& par) const {
    if (ELL_PERSIST == 2) {
      if (threadIdx.x == 0) s_next[par] = atomicAdd(counter, 1);
      __syncthreads();
      const int v = s_next[par];
      par ^= 1;
      return v;
    }
    if (t < 0) return blockIdx.x;
    return ELL_PERSIST == 1 ? t + (int)gridDim.x : n_tiles;
  }
};

// One list chunk of 32 slots of a row, NS = 32/LPR per lane: slot
// kb + r*LPR + sub in register r of lane sub of the row group.  Ids and
// weights load independently (no round trip between them).
template <int LPR>
__device__ __forceinline__ void load_chunk(int (&ids)[32 / LPR],
                                           float (&ws)[32 / LPR],
                                           const int* nr, const float* wr,
                                           int kb, int k, bool row_ok,
                                           uint64_t pol) {
  const int sub = threadIdx.x % LPR;
#pragma unroll
  for (int r = 0; r < 32 / LPR; ++r) {
    const int slot = kb + r * LPR + sub;
    const bool in = row_ok && slot < k;
    ws[r] = in ? load_list(wr + slot, pol) : 0.f;
    ids[r] = in ? load_list(nr + slot, pol) : -1;
  }
}

// Zeroes the weight of every slot that contributes nothing (w == 0 or an
// id outside [0, n_src)) and returns one past the last slot of the chunk
// that any row of the warp still needs: warp-uniform, found by ballot.
template <int LPR>
__device__ __forceinline__ int valid_prefix(const int (&ids)[32 / LPR],
                                            float (&ws)[32 / LPR],
                                            int64_t n_src) {
  const int lane = threadIdx.x & 31;
  const int gshift = lane / LPR * LPR;      // the row group's first lane
  const unsigned gmask = LPR == 32 ? kFull : ((1u << LPR) - 1u);
  unsigned valid = 0;                       // this row's valid slots
#pragma unroll
  for (int r = 0; r < 32 / LPR; ++r) {
    const bool ok = ws[r] != 0.f && (unsigned)ids[r] < (uint64_t)n_src;
    if (!ok) ws[r] = 0.f;
    valid |= ((__ballot_sync(kFull, ok) >> gshift) & gmask) << (r * LPR);
  }
  return __reduce_max_sync(kFull, 32 - __clz(valid));
}

// Gathers of slots [0, n) of one list chunk into acc, for the columns this
// lane owns from col0: U slots at a time, their shuffles and predicated
// loads all issued before their FMAs (k ascending).  n is warp-uniform.
template <int VEC, int LPR, int CH>
__device__ __forceinline__ void gather_chunk(
    float (&acc)[CH][VEC], const int (&ids)[32 / LPR],
    const float (&ws)[32 / LPR], int n, const float* xq, int64_t f,
    int col0, uint64_t pol) {
  constexpr int NS = 32 / LPR;
  constexpr int U = ELL_UNROLL < LPR ? ELL_UNROLL : LPR;
  const int sub = threadIdx.x % LPR;
#pragma unroll
  for (int r = 0; r < NS; ++r) {
    if (r * LPR >= n) break;                    // warp-uniform
    const int tn = min(LPR, n - r * LPR);
    for (int t0 = 0; t0 < tn; t0 += U) {
      int j[U];
      float wj[U];
      typename Vec<VEC>::T v[U][CH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        j[u] = __shfl_sync(kFull, ids[r], t0 + u, LPR);
        wj[u] = __shfl_sync(kFull, ws[r], t0 + u, LPR);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* xr = xq + (int64_t)j[u] * f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int col = col0 + (c * LPR + sub) * VEC;
          v[u][c] = (wj[u] != 0.f && col < f) ? load_x<VEC>(xr + col, pol)
                                              : Vec<VEC>::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (wj[u] != 0.f) {
#pragma unroll
          for (int c = 0; c < CH; ++c) fma_vec<VEC>(acc[c], wj[u], v[u][c]);
        }
      }
    }
  }
}

template <int VEC, int LPR, int CH>
__device__ __forceinline__ void store_row(float* orow, int64_t f, int col0,
                                          const float (&acc)[CH][VEC]) {
  const int sub = threadIdx.x % LPR;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = col0 + (c * LPR + sub) * VEC;
    if (col < f) store_out<VEC>(orow + col, acc[c]);
  }
}

// The shipped kernel: tiles (partition, slice, row tile); each row group
// loads its row's lists once per slice.
#if ELL_MINB > 0
#define ELL_BOUNDS __launch_bounds__(kThreads, ELL_MINB)
#else
#define ELL_BOUNDS __launch_bounds__(kThreads)
#endif

template <int VEC, int LPR, int CH>
__global__ void ELL_BOUNDS
ell_spmm_slice_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                      const float* __restrict__ w, float* __restrict__ out,
                      Raster ras, int64_t n_dst, int64_t n_src, int k,
                      int64_t f) {
  constexpr int SW = LPR * VEC * CH;
  constexpr int NS = 32 / LPR;
  constexpr int kRows = kThreads / LPR;
  const int grp = threadIdx.x / LPR;
  const uint64_t pol = evict_last_policy();
  __shared__ int s_next[2];
  int par = 0;
  for (int t = ras.next(-1, s_next, par); t < ras.n_tiles;) {
    const int t_next = ras.next(t, s_next, par);   // drawn a tile ahead
    int part, s, rt;
    ras.split(t, part, s, rt);
    const int64_t i = (int64_t)rt * kRows + grp;
    const bool row_ok = i < n_dst;    // a ragged last tile: not uniform
    const int64_t row = part * n_dst + i;
    const float* xq = x + part * n_src * f;
    const int n_inner = ELL_SLICE_INNER ? (int)((f + SW - 1) / SW) : 1;
    int ids[NS];
    float ws[NS];
    int n = 0;
    for (int si = 0; si < n_inner; ++si) {
      const int col0 = (ELL_SLICE_INNER ? si : s) * SW;
      float acc[CH][VEC];
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[c][v] = 0.f;
      for (int kb = 0; kb < k; kb += 32) {
        if (si == 0 || k > 32) {     // one chunk: its lists stay loaded
          load_chunk<LPR>(ids, ws, nbr + row * k, w + row * k, kb, k,
                          row_ok, pol);
          n = valid_prefix<LPR>(ids, ws, n_src);
        }
        gather_chunk<VEC, LPR, CH>(acc, ids, ws, n, xq, f, col0, pol);
      }
      if (row_ok) store_row<VEC, LPR, CH>(out + row * f, f, col0, acc);
    }
    t = t_next;
  }
}

template <int VEC, int LPR, int CH>
int launch(const float* x, const int* nbr, const float* w, float* out,
           int* counter, int64_t q, int64_t n_dst, int64_t n_src, int k,
           int64_t f, int device, cudaStream_t stream) {
  constexpr int SW = LPR * VEC * CH;
  constexpr int kRows = kThreads / LPR;
  const int64_t n_slices = (f + SW - 1) / SW;
  const int64_t n_rt = (n_dst + kRows - 1) / kRows;
  const int64_t n_outer = ELL_SLICE_INNER ? 1 : n_slices;
  if (q * n_outer * n_rt >= (int64_t)1 << 31) {
    return (int)cudaErrorInvalidValue;      // tiles are counted in 32 bits
  }
  if (ELL_PERSIST == 2 && counter == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Raster ras;
  ras.n_rt = (int)n_rt;
  ras.n_outer = (int)n_outer;
  ras.n_tiles = (int)(q * n_outer * n_rt);
  ras.counter = counter;
  const auto kernel = ell_spmm_slice_kernel<VEC, LPR, CH>;
  int64_t grid = ras.n_tiles;
  if (ELL_PERSIST != 0) {
    // resident blocks of the whole card, per device (cached: the
    // occupancy of one instantiation does not change at run time)
    static int resident[64] = {0};
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[device] == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
      resident[device] = sms * (per_sm > 0 ? per_sm : 1);
    }
    grid = grid < resident[device] ? grid : resident[device];
  }
  kernel<<<(unsigned)grid, kThreads, 0, stream>>>(x, nbr, w, out, ras, n_dst,
                                                  n_src, k, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_spmm_f32(const void* x, const void* nbr, const void* w,
                            void* out, void* counter, long long q,
                            long long n_dst,
                            long long n_src, long long k, long long f,
                            int vec4, int device, void* stream) {
  cudaSetDevice(device);
  if (q * n_dst == 0 || f == 0) return (int)cudaGetLastError();
  if (k > (1 << 24)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const int* np = static_cast<const int*>(nbr);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  int* cp = static_cast<int*>(counter);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr int kSW = ELL_LPR * ELL_VEC * ELL_CH;
  if (vec4) {
    return launch<ELL_VEC, ELL_LPR, ELL_CH>(xp, np, wp, op, cp, q, n_dst, n_src,
                                            (int)k, f, device, s);
  }
  // any width or alignment: a full warp of 4-byte lanes, same slice width
  return launch<1, 32, (kSW >= 32 ? kSW / 32 : 1)>(
      xp, np, wp, op, cp, q, n_dst, n_src, (int)k, f, device, s);
}
