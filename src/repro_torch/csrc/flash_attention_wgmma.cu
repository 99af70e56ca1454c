// Flash attention forward on Hopper's tensor cores: bf16 q/k/v, head dim
// D in {64, 128, 256}, causal and/or sliding-window masks, GQA, f32
// online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) on the bf16 prefill path; the CUDA-core
// kernel in flash_attention.cu keeps f32 and the narrow (D <= 32) heads.
//
// What bounds it: operations.  At granite's prefill shape the two
// products are 1.4e11 bf16 flops against 84 MB moved, so the only road to
// the card's rate is wgmma (989 TFLOP/s bf16 against 67 TFLOP/s f32 FMA on
// the CUDA cores).  At D = 64 the softmax's exponentials (16 a clock on
// an SM) cost about as many cycles as the two products, so the design
// keeps the tensor cores and the SFUs busy at once across two consumer
// warpgroups.
//
// Design:
//   * One block per (128-row query tile, head, batch), launched longest
//     tile first (causal: the last query tile sees the most keys).  384
//     threads: warpgroup 0 is the producer (one thread issues TMA; the
//     group gives its registers away with setmaxnreg), warpgroups 1 and 2
//     are consumers of 64 query rows each.
//   * Loads: TMA (cp.async.bulk.tensor) into 128B-swizzled shared memory,
//     one 64-column box per 64 of the head dim.  Q is loaded once; K and
//     V tiles of BK keys go through a ring of STAGES stages paced by full
//     (K and V apart, so Q.K^T starts before V lands) and empty
//     mbarriers, so the next tiles load while this one is multiplied.
//     The tensor maps are built on the host from the views' strides (the
//     model's [B, S, H, D] tensors are read in place) with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters.  TMA
//     zero-fills rows past S; those keys are also masked by index.
//   * S = Q K^T: wgmma m64nBKk16, bf16 in, f32 out, both operands from
//     shared memory through descriptors (K's rows are K-major).
//   * Online softmax on the f32 accumulator fragment in registers: row
//     max and sum by quad shuffles, exp2 (one SFU op) of logits scaled
//     inside an FMA; a masked score is -inf and a row whose max is still
//     -inf keeps p = 0, so a fully masked row writes 0 (acc / max(l,
//     1e-30)).  The row sum stays a per-thread partial until the end.
//     Only tiles that cross the causal diagonal, the window's edge or S
//     evaluate the index mask.
//   * Explicit positions (qpos/kpos, int32 [B, S], the JAX package's
//     prefill mask): a key is live when kpos <= qpos (causal) and kpos >
//     qpos - window.  Such a mask need not be lower-triangular in index,
//     so both the producer's and the consumers' tile walk take the query
//     tile's key range [lo, hi) from the wrapper (ranges, int4 [B,
//     S/kBQ]; outside it the positions' extremes prove every key masked).
//     Tiles in the run [full_lo, full_hi) that the extremes prove wholly
//     unmasked skip the mask, as interior tiles do on the index path;
//     the others are masked by position (the row positions sit in
//     registers, the key positions are read through the read-only cache).
//   * O += P V: P is rounded to bf16 in registers straight into wgmma's
//     A fragment (the accumulator layout of two 8-column chunks is the A
//     layout of one 16-deep slice), with no trip through shared memory; V
//     [BK, D] is the MN-major B operand (wgmma's transpose bit), one
//     m64n64k16 per 64 columns of the head dim.
//   * Scheduling (per head dim, Cfg below, from measurements): at D = 64
//     and 128 a warpgroup issues the next tile's Q K^T before this tile's
//     P V and runs the next softmax while P V is on the tensor cores; the
//     two warpgroups interleave freely.  At D = 256 the 128 accumulator
//     registers of O leave no room for that, and the plain order (Q K^T,
//     softmax, P V) measures faster.  The last tile is peeled out of the
//     overlapped loop so that ptxas can prove no accumulator is read while
//     its wgmma is in flight (else it serialises every wgmma).
//   * Epilogue: acc / l to bf16, staged through the warpgroup's own
//     (now idle) rows of the Q buffer, then 16-byte stores in q's strides.
//
// C interface (ctypes): pointers and the stream are void*, sizes int,
// strides 64-bit (in elements); returns a CUDA error code (or 1 =
// cudaErrorInvalidValue when a tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;         // query rows per block
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kRow = 128;        // bytes of one swizzled 64-column row

template <int D>
struct Cfg;
// Per head dim: key tile, ring depth, and whether the next tile's Q K^T
// is issued before this tile's P V (so the softmax overlaps P V).  Chosen
// by measurement on the H100 (scripts/lm_kernel_variants.py, PERF.md): at
// D = 256 the 128 accumulator registers of O leave no room for the
// overlap to pay.
template <int D>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int BK = 128, STAGES = 4;
  static constexpr bool OVERLAP = true;
};
template <>
struct Cfg<128> {
  static constexpr int BK = 128, STAGES = 3;
  static constexpr bool OVERLAP = true;
};
template <>
struct Cfg<256> {
  static constexpr int BK = 64, STAGES = 2;
  static constexpr bool OVERLAP = false;
};

template <int D>
constexpr int smem_bytes() {
  // 1024 bytes of alignment slack, Q, STAGES x (K, V), the barriers
  return 1024 + kBQ * D * 2 + Cfg<D>::STAGES * 2 * Cfg<D>::BK * D * 2 + 256;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// --- TMA --------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled tile whose 8-row
// groups are 1024 bytes apart (SBO).  For K-major operands the leading
// offset is unused; for the MN-major V tile (64 columns = one swizzle atom
// wide) the MN repeat is unused too, so both offsets carry 1024.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins an accumulator register after wgmma.wait_group, so no read of it
// is scheduled before the wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] += A (shared, K-major) * B (shared, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64] += A (shared, K-major) * B (shared, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d[32] += A (registers, 4 x bf16x2) * B (shared, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  wgmma_ss_n64(d, da, db, acc);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  wgmma_ss_n128(d, da, db, acc);
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

// one 64-column box of a map whose outer slots hold (s, h, b) in the order
// packed into perm (two bits each: the slot, 1..3, of s, of h, of b)
__device__ __forceinline__ void load_box(const CUtensorMap* map, int perm,
                                         uint32_t dst, uint32_t bar, int d0,
                                         int s, int h, int b) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = ps == 1 ? s : ph == 1 ? h : b;
  const int c2 = ps == 2 ? s : ph == 2 ? h : b;
  const int c3 = ps == 3 ? s : ph == 3 ? h : b;
  tma_load_4d(dst, map, bar, d0, c1, c2, c3);
}

struct OutView {
  __nv_bfloat16* p;
  long long b, h, s;
};

// BY_POS: positions given (a separate instantiation, so the index-masked
// kernel's code is the same as without the positions path)
template <int D, bool BY_POS>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, OutView o,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   const int4* __restrict__ ranges, int S, int H, int B,
                   int group, int causal, int window, float scale_log2,
                   int perm_q, int perm_kv) {
  constexpr int BK = Cfg<D>::BK, STAGES = Cfg<D>::STAGES, NDB = D / 64;
  constexpr int QBYTES = kBQ * D * 2, KVBYTES = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  // 128B swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + QBYTES;             // [STAGES][NDB][BK][128 B]
  uint8_t* vs = ks + STAGES * KVBYTES;   // [STAGES][NDB][BK][128 B]
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  const uint32_t bar_q = smem_u32(vs + STAGES * KVBYTES);
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES,
                 bar_e = bar_v + 8 * STAGES;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (H * B);
  const int order = blockIdx.x / (H * B);
  const int qt = causal ? n_qt - 1 - order : order;  // longest first
  const int h = bh % H, b = bh / H, hk = h / group;
  const int q0 = qt * kBQ;
  constexpr bool by_pos = BY_POS;
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = causal ? q_last + 1 : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  int full_lo = 0, full_hi = 0;  // key tiles no position masks
  if constexpr (by_pos) {  // >= 1 tile: the wrapper gives no empty range
    const int4 r = ranges[(long long)b * n_qt + qt];
    k_begin = r.x;
    k_end = r.y;
    full_lo = r.z;
    full_hi = r.w;
  }
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, QBYTES);
      for (int j = 0; j < NDB; ++j)
        load_box(&tq, perm_q, smem_u32(qs + j * kBQ * kRow), bar_q, 64 * j,
                 q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int kt = k_begin + it * BK;
        mbar_wait(bar_e + 8 * st, ph ^ 1);  // the first round passes
        mbar_expect_tx(bar_k + 8 * st, KVBYTES);
        for (int j = 0; j < NDB; ++j)
          load_box(&tk, perm_kv, smem_u32(ks + st * KVBYTES + j * BK * kRow),
                   bar_k + 8 * st, 64 * j, kt, hk, b);
        mbar_expect_tx(bar_v + 8 * st, KVBYTES);
        for (int j = 0; j < NDB; ++j)
          load_box(&tv, perm_kv, smem_u32(vs + st * KVBYTES + j * BK * kRow),
                   bar_v + 8 * st, 64 * j, kt, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64 w .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = wg - 1;
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int rloc = 16 * (tid >> 5) + (lane >> 2);  // and rloc + 8
  const int ra = q0 + 64 * w + rloc, rb = ra + 8;
  const int cq = 2 * (lane & 3);                    // fragment column
  long long pos_a = 0, pos_b = 0;                   // rows' positions
  if constexpr (by_pos) {
    if (ra < S) pos_a = qpos[(long long)b * S + ra];
    if (rb < S) pos_b = qpos[(long long)b * S + rb];
  }
  const uint32_t qbase = smem_u32(qs) + w * 64 * kRow;

  float sacc[BK / 2], oacc[D / 2];
  uint32_t pa[BK / 16][4];  // P in bf16: wgmma's A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  // running max in raw-score units; per-thread partial row sums
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float al_a = 1.f, al_b = 1.f;  // the last tile's rescale factors

  // S = Q K^T for tile it, issued (not waited)
  auto issue_qk = [&](int it) {
    const int st = it % STAGES;
    const uint32_t kbase = smem_u32(ks + st * KVBYTES);
    mbar_wait(bar_k + 8 * st, (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(sacc,
                   desc_sw128(qbase + (kk >> 2) * kBQ * kRow + (kk & 3) * 32),
                   desc_sw128(kbase + (kk >> 2) * BK * kRow + (kk & 3) * 32),
                   kk > 0);
    wgmma_commit();
  };
  // online softmax of tile it in place: sacc becomes p (f32), m and l
  // advance, al_* take the factor the accumulator must be scaled by
  // the position mask of a tile outside the whole run: its own pass
  // before the softmax, so that the softmax keeps the index path's code
  auto position_mask = [&](int kt) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      long long kp[2] = {0, 0};  // positions of this slice's two keys
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kt + 8 * j + cq + c;
        if (key < S) kp[c] = __ldg(kpos + (long long)b * S + key);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kq = kp[e & 1], rq = e < 2 ? pos_a : pos_b;
        if ((causal && kq > rq) || (window > 0 && kq <= rq - window))
          sacc[4 * j + e] = -INFINITY;
      }
    }
  };
  // online softmax of tile it in place: sacc becomes p (f32), m and l
  // advance, al_* take the factor the accumulator must be scaled by
  auto softmax = [&](int it) {
    const int kt = k_begin + it * BK;
    bool need_mask;
    if constexpr (by_pos) {
      if (!(kt >= full_lo && kt + BK <= full_hi)) position_mask(kt);
      need_mask = kt + BK > S;  // left: the keys past S
    } else {
      need_mask = kt + BK > S || (causal && kt + BK - 1 > q0) ||
                  (window > 0 && kt <= q0 + kBQ - 1 - window);
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e];
        if (need_mask) {
          const int key = kt + 8 * j + cq + (e & 1);
          const int row = e < 2 ? ra : rb;
          bool live;
          if constexpr (by_pos)
            live = key < S;
          else
            live = key < S && (!causal || key <= row) &&
                   (window <= 0 || key > row - window);
          x = live ? x : -INFINITY;
          sacc[4 * j + e] = x;
        }
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
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
    al_a = ex2(fmaf(m_a, scale_log2, nb_a));
    al_b = ex2(fmaf(m_b, scale_log2, nb_b));
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sacc[4 * j + 0] = ex2(fmaf(sacc[4 * j + 0], scale_log2, nb_a));
      sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], scale_log2, nb_a));
      sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], scale_log2, nb_b));
      sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], scale_log2, nb_b));
      sum_a += sacc[4 * j + 0] + sacc[4 * j + 1];
      sum_b += sacc[4 * j + 2] + sacc[4 * j + 3];
    }
    l_a = l_a * al_a + sum_a;  // per-thread partial, reduced at the end
    l_b = l_b * al_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
  };
  // rescale the accumulator, then p to bf16 straight into the A fragments
  // of the 16-key slices (two 8-column accumulator chunks = one slice)
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[4 * j + 0] *= al_a;
      oacc[4 * j + 1] *= al_a;
      oacc[4 * j + 2] *= al_b;
      oacc[4 * j + 3] *= al_b;
    }
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      pa[t][0] = pack_bf16(sacc[8 * t + 0], sacc[8 * t + 1]);
      pa[t][1] = pack_bf16(sacc[8 * t + 2], sacc[8 * t + 3]);
      pa[t][2] = pack_bf16(sacc[8 * t + 4], sacc[8 * t + 5]);
      pa[t][3] = pack_bf16(sacc[8 * t + 6], sacc[8 * t + 7]);
    }
  };

  auto issue_pv = [&](int it) {
    const int st = it % STAGES;
    mbar_wait(bar_v + 8 * st, (it / STAGES) & 1);
    wgmma_fence();
    const uint32_t vbase = smem_u32(vs + st * KVBYTES);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
#pragma unroll
      for (int j = 0; j < NDB; ++j)
        wgmma_rs_n64(oacc + 32 * j, pa[t],
                     desc_sw128(vbase + j * BK * kRow + t * 16 * kRow));
    wgmma_commit();
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e + 8 * (it % STAGES));
  };
  mbar_wait(bar_q, 0);
  if constexpr (Cfg<D>::OVERLAP) {
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sacc);
    softmax(0);
    rescale_and_pack();
    for (int it = 0; it + 1 < n_tiles; ++it) {
      // the next tile's S = Q K^T is issued before this tile's O += P V,
      // so the next softmax runs while the tensor cores do O += P V
      issue_qk(it + 1);
      issue_pv(it);
      wgmma_wait<1>();  // S of tile it + 1 is in
      fence_regs<BK / 2>(sacc);
      softmax(it + 1);
      wgmma_wait<0>();  // O += P V of tile it is in
      fence_regs<D / 2>(oacc);
      release(it);
      rescale_and_pack();
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
    release(n_tiles - 1);
  } else {
    for (int it = 0; it < n_tiles; ++it) {
      issue_qk(it);
      wgmma_wait<0>();
      fence_regs<BK / 2>(sacc);
      softmax(it);
      rescale_and_pack();
      issue_pv(it);
      wgmma_wait<0>();
      fence_regs<D / 2>(oacc);
      release(it);
    }
  }

  // epilogue: acc / l in bf16 through this warpgroup's rows of the Q tile
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* blk = qs + (j >> 3) * kBQ * kRow + w * 64 * kRow;
    const int chunk = ((j & 7) ^ (rloc & 7)) * 16 + cq * 2;
    *reinterpret_cast<uint32_t*>(blk + rloc * kRow + chunk) =
        pack_bf16(oacc[4 * j + 0] * inv_a, oacc[4 * j + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(blk + (rloc + 8) * kRow + chunk) =
        pack_bf16(oacc[4 * j + 2] * inv_b, oacc[4 * j + 3] * inv_b);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  constexpr int CPR = D / 8;  // 16-byte chunks of an output row
  __nv_bfloat16* ob = o.p + b * o.b + h * o.h;
  for (int i = tid; i < 64 * CPR; i += 128) {
    const int r = i / CPR, cc = i % CPR, row = q0 + 64 * w + r;
    const uint8_t* blk = qs + (cc >> 3) * kBQ * kRow + w * 64 * kRow;
    const uint4 val = *reinterpret_cast<const uint4*>(
        blk + r * kRow + ((cc & 7) ^ (r & 7)) * 16);
    if (row < S)
      *reinterpret_cast<uint4*>(ob + (long long)row * o.s + 8 * cc) = val;
  }
}

// --- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, NH, S, D] bf16 view (strides in elements; D contiguous) as a 4-D
// tensor map: D innermost, then s, h, b ordered by stride (a dim of size 1
// goes outermost).  Boxes are 64 columns x `rows` rows of s, 128B-swizzled.
// Returns 0 or a CUDA error code; *perm gets the slots of s, h and b.
int make_map(CUtensorMap* map, const void* p, int D, int S, int NH, int B,
             long long ss, long long sh, long long sb, int rows, int* perm) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  long long size[3] = {S, NH, B}, stride[3] = {ss, sh, sb};
  long long extent = D;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * size[i] > extent)
      extent = stride[i] * size[i];
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = extent;
  int order[3] = {0, 1, 2};  // dims by ascending stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    gdim[i + 1] = (cuuint64_t)size[d];
    gstride[i] = (cuuint64_t)(stride[d] * 2);
    slot[d] = i + 1;
    if (d == 0) box[i + 1] = (cuuint32_t)rows;
  }
  *perm = slot[0] | slot[1] << 2 | slot[2] << 4;
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), gdim,
      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* qpos, const int* kpos, const int4* ranges, int B,
           int H, int KV, int S, const long long* st, int causal, int window,
           cudaStream_t stream) {
  constexpr int BK = Cfg<D>::BK;
  CUtensorMap tq, tk, tv;
  int perm_q, perm_kv, perm_v, err;
  if ((err = make_map(&tq, q, D, S, H, B, st[2], st[1], st[0], kBQ,
                      &perm_q)) ||
      (err = make_map(&tk, k, D, S, KV, B, st[5], st[4], st[3], BK,
                      &perm_kv)) ||
      (err = make_map(&tv, v, D, S, KV, B, st[8], st[7], st[6], BK,
                      &perm_v)))
    return err;
  if (perm_v != perm_kv) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D>();
  auto kernel = qpos != nullptr ? flash_wgmma_kernel<D, true>
                                : flash_wgmma_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * H * B;
  const OutView ov{static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11]};
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, ov, qpos, kpos, ranges, S, H, B, H / KV, causal, window,
      scale_log2, perm_q, perm_kv);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only.  qpos/kpos: int32 [B, S] positions and ranges: int32 [B,
// ceil(S / 128), 4] key ranges, all three null for the index mask.
// Strides (in elements) are (b, h, s) for q, k, v and o in that order; the
// head dim is contiguous; pointers and strides of more than one element
// must be 16-byte aligned (TMA).
extern "C" int flash_attention_wgmma_fwd(
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
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const int4* rg = static_cast<const int4*>(ranges);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, qp, kp, rg, B, H, KV, S, st, causal,
                        window, s);
    case 128:
      return launch<128>(q, k, v, o, qp, kp, rg, B, H, KV, S, st, causal,
                         window, s);
    case 256:
      return launch<256>(q, k, v, o, qp, kp, rg, B, H, KV, S, st, causal,
                         window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
