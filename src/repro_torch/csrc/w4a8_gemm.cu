// Group-dequant W4/W8 x A8 GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/w4a8_gemm.py
// (w4a8_gemm_pallas, body _kernel). Same function as
// repro_torch.kernels.ref.w4a8_matmul_ref:
//
//   out[m, n] = (sum_g float(dot_g(x[m], w[n])) * sg[n, g]) * sx[m]
//
// with x (M, K) int8, sx (M,) f32 per-token scales, w (N, K) int8 (int4
// values stored in int8 for W4), sg (N, K / group) f32 group scales and
// dot_g the exact int32 dot over group g's columns.
//
// Bound on the card: the weights (N*K bytes) and activations (M*K bytes)
// are read once; 2*M*N*K int8 operations against the 1,979 TOP/s int8
// rate. At decode (M = 4) that is bytes over 3.35 TB/s (13.9 us at
// llama1_7b's 11008 x 4096); at M = 512 on llama1_7b's widths it is the
// operations (23.3 us).
//
// Two instances; kernels/w4a8_gemm.py::launch_plan picks one from the
// shapes and base addresses (never as a fallback: a refused launch or
// tensor map raises).
//
// w4a8_wgmma (group 32, 64, 128 or 256; x and w on 16-byte aligned
// bases). The exact int32 group dots run on the int8 tensor cores (wgmma
// m64nBTk32.s32.s8.s8). A and B are swapped: A is a tile of 64 weight rows
// per consumer warpgroup (WGS = 1 or 2 of them), B a tile of BT tokens
// (the instruction's N: 8, 16, 32 at decode, 64 or 128 at prefill), both
// K-major as qw (N, K) and qx (M, K) are stored, so the int32
// accumulator is the transpose of the output tile: the group scale
// sg[n, g] is per accumulator row and sx[m] per column. The first thread
// of a producer warpgroup keeps a ring of ns stages full with TMA (2-D
// tensor maps over w and x, 128-byte swizzle, boxes 128 bytes of K wide,
// kb boxes of each a stage holding whole groups; the hardware zero-fills
// past N, M and K), counted on "full" mbarriers; each consumer warp frees
// a stage on its "empty" mbarrier once the wgmmas that read it are done.
// Per group a warpgroup issues group / 32 wgmmas (unrolled: the group is
// a template argument, KPG = group / 32) into one of two int32
// accumulators in turn (the first with scale-d 0), waits, and folds the
// previous group into its f32 accumulator in this order:
//
//   acc = __fadd_rn(acc, __fmul_rn(__int2float_rn(part), sg[n, g])),
//
// g increasing: explicit roundings, so no FMA contraction changes a bit
// (the conversion is exact, |part| <= 2^22). This epilogue costs about as
// many issue slots as the group's products take on the tensor cores
// (three instructions an accumulator a group of 128), and is what keeps
// M = 512 from the int8 rate (PERF.md). Prefill blocks run two consumer
// warpgroups (three accumulators of 64 registers each a thread): the
// producer warpgroup gives up registers to them (setmaxnreg).
//
// K split. Where the output tiles are too few to fill the card, the host
// asks for split <= 8 blocks per output tile along K, launched as one
// thread block cluster (1, 1, split). Rank r owns a contiguous range of
// groups (G / split each, the first G % split ranks one more), so its
// f32 chain covers groups in increasing order. Each rank leaves its f32
// tile in its own shared memory; after a cluster barrier each rank reads
// its share of the tile from every rank through distributed shared
// memory, adds the ranks in rank order (__fadd_rn) and stores y =
// __fmul_rn(sum, sx[m]); a second barrier keeps every block resident until
// all have read. With no split the tile is stored from registers. No
// memset, no atomics, one launch per call.
// kernels/w4a8_gemm.py::w4a8_gemm_ordered computes this order in plain
// torch: the kernel is held to it bit for bit.
//
// w4a8_dot (any group dividing K, any K: every other call). One block
// of 256 threads (8 warps) per (32 columns n, BM = 8 rows m). The block
// walks K in activation tiles of at most KT = 4096 bytes per row: it
// copies its BM rows' tile (BM x min(K, KT) bytes, at most 32 KiB) into
// shared memory, so any K fits. Lane l of every warp owns column
// n = 32 * bx + l; warp v takes the groups g = v, v + 8, ...: per group it
// runs the exact int32 dot of its weight row against the BM rows, then
// adds the group term in f32, in increasing g. A group that runs past the
// end of a tile keeps its int32 partial in registers into the next tile
// (the warp that owns it owns it there too). The dots use __dp4a (four
// int8 products per instruction; the activation words are one address
// for the whole warp, a broadcast) when group % 4 == 0, and one byte at a
// time otherwise. The eight warps' f32 partials are summed in a fixed
// order through shared memory and scaled by sx. The f32 group terms are
// summed in another order than the reference's, so the two agree within
// a tolerance (chip_smoke.py states it), not bit for bit. It runs the
// dots on the scalar pipes and re-reads the weights once per block of 8
// rows.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 8;        // rows per block
constexpr int WARPS = 8;     // warps per block, each a share of the groups
constexpr int KT = 4096;     // activation bytes per row and tile

// The exact dot of BM activation rows (shared memory, row stride kts
// bytes, starting at byte lo) with w[lo, hi) (global), added to acc.
template <bool WORDS>
__device__ __forceinline__ void group_dot(const int8_t* xs, int kts,
                                          const int8_t* w, int lo, int hi,
                                          int32_t* acc) {
  if constexpr (WORDS) {
    const int32_t* x4 = reinterpret_cast<const int32_t*>(xs);
    const int32_t* w4 = reinterpret_cast<const int32_t*>(w);
    const int kw = kts / 4;
#pragma unroll 4
    for (int q = lo / 4; q < hi / 4; ++q) {
      const int32_t wv = __ldg(w4 + q);
#pragma unroll
      for (int r = 0; r < BM; ++r)
        acc[r] = __dp4a(x4[r * kw + q], wv, acc[r]);
    }
  } else {
    for (int q = lo; q < hi; ++q) {
      const int32_t wv = __ldg(w + q);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += (int32_t)xs[r * kts + q] * wv;
    }
  }
}

template <bool WORDS>
__global__ void __launch_bounds__(WARPS * 32)
w4a8_dot(const int8_t* __restrict__ x, const float* __restrict__ sx,
         const int8_t* __restrict__ w, const float* __restrict__ sg, int M,
         int N, int K, int group, int kts, float* __restrict__ out) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;                                   // BM x kts bytes
  float* red = reinterpret_cast<float*>(smem + BM * kts);  // WARPS x BM x 32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * BM;
  const int n_groups = K / group;
  const int8_t* wrow = w + (size_t)(n < N ? n : 0) * K;

  float accf[BM];
  int32_t acc[BM];              // the int32 partial of the current group
#pragma unroll
  for (int r = 0; r < BM; ++r) accf[r] = 0.f, acc[r] = 0;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    __syncthreads();                             // the last tile is used
    if constexpr (WORDS) {
      const int kw = kt / 4;
      for (int i = threadIdx.x; i < BM * kw; i += WARPS * 32) {
        const int r = i / kw, q = i - r * kw;
        reinterpret_cast<int32_t*>(xs)[r * (kts / 4) + q] =
            (m0 + r < M) ? __ldg(reinterpret_cast<const int32_t*>(
                               x + (size_t)(m0 + r) * K + k0) + q)
                         : 0;
      }
    } else {
      for (int i = threadIdx.x; i < BM * kt; i += WARPS * 32) {
        const int r = i / kt, q = i - r * kt;
        xs[r * kts + q] = (m0 + r < M) ? x[(size_t)(m0 + r) * K + k0 + q] : 0;
      }
    }
    __syncthreads();
    if (n >= N) continue;
    // groups that meet [k0, k0 + kt), this warp's in increasing order
    const int g_first = k0 / group, g_last = (k0 + kt - 1) / group;
    int g = g_first + ((warp - g_first % WARPS) + WARPS) % WARPS;
    for (; g <= g_last; g += WARPS) {
      const int lo = max(g * group, k0), hi = min((g + 1) * group, k0 + kt);
      if (lo == g * group) {
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = 0;
      }
      group_dot<WORDS>(xs, kts, wrow + k0, lo - k0, hi - k0, acc);
      if (hi == (g + 1) * group) {               // the group is complete
        const float s = __ldg(sg + (size_t)n * n_groups + g);
#pragma unroll
        for (int r = 0; r < BM; ++r) accf[r] += (float)acc[r] * s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) red[(warp * BM + r) * 32 + lane] = accf[r];
  __syncthreads();
  const int r = threadIdx.x / 32;                // BM * 32 == 256 threads
  const int m = m0 + r;
  if (m < M && n < N) {
    float y = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) y += red[(v * BM + r) * 32 + lane];
    out[(size_t)m * N + n] = y * __ldg(sx + m);
  }
}

// ---- w4a8_wgmma -----------------------------------------------------------

constexpr int BOX_K = 128;         // bytes of K per TMA box (the swizzle span)
constexpr int KSTEP = 32;          // bytes of K per wgmma
constexpr int MAX_SPLIT = 8;       // blocks per cluster (portable maximum)
constexpr int MAX_KB = 4;          // boxes of each operand per stage
constexpr int PAD = 4;             // floats past each row of the f32 tile
constexpr int SMEM_LIMIT = 232448; // a block's shared memory on Hopper
constexpr int SMEM_SLACK = 1024;   // to align the ring to 1024 B (swizzle)

// Errors of this file's own, beside cudaError_t codes (w4a8_gemm_error).
constexpr int ERR_ENTRY = -1;      // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -2;     // the driver refused a tensor map
constexpr int ERR_ALIGN = -3;      // w4a8_wgmma on unaligned data
constexpr int ERR_PLAN = -4;       // tiling out of range

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
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
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait beyond 4 s traps (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > 4000000000ull) __trap();
}

// The same wait as one asm block with its loop inside, no timer and no
// trap: the consumers wait so while their wgmmas are in flight, where a
// branch of the compiler's own would make it wait for those first.
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT_%=;\n\t}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The (c0, c1) box of `map` into shared memory at dst, counted on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The wgmma descriptor of a K-major tile at shared address `addr` stored
// as TMA's 128-byte swizzle leaves it: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO 64 x 16 B), LBO unused (1), layout 1 (128-byte
// swizzle). A k-step of 32 bytes inside the row adds 32 to the address.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of wgmmas are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulator across the
// wgmma fence and wait (its registers are written asynchronously).
template <int R>
__device__ __forceinline__ void fence_operands(int32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int BT>
__device__ __forceinline__ void wgmma(int32_t* d, uint64_t da, uint64_t db,
                                      int acc);

// D (64 x 8 int32, 4 per thread) = A * B (+ D if acc).
template <>
__device__ __forceinline__ void wgmma<8>(int32_t* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 16 int32, 8 per thread) = A * B (+ D if acc).
template <>
__device__ __forceinline__ void wgmma<16>(int32_t* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 32 int32, 16 per thread) = A * B (+ D if acc).
template <>
__device__ __forceinline__ void wgmma<32>(int32_t* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64 int32, 32 per thread) = A * B (+ D if acc).
template <>
__device__ __forceinline__ void wgmma<64>(int32_t* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128 int32, 64 per thread) = A * B (+ D if acc).
template <>
__device__ __forceinline__ void wgmma<128>(int32_t* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// float(v), rounded to nearest (exact for every group dot of at most 256
// int8 products, |v| <= 2^22).
__device__ __forceinline__ float to_f32(int32_t v) {
  return __int2float_rn(v);
}

// Shared memory of w4a8_wgmma: the alignment slack, ns stages of kb boxes
// of weights (64 * wgs rows) and of tokens (bt rows), 128 bytes of K each,
// then a "full" and an "empty" mbarrier per stage. The f32 tile of a K
// split (bt x (64 * wgs + PAD) floats) reuses the ring.
__host__ __device__ constexpr size_t wgmma_smem(int bt, int wgs, int ns,
                                                int kb) {
  return SMEM_SLACK + (size_t)ns * kb * (64 * wgs + bt) * BOX_K +
         16 * (size_t)ns;
}

__host__ __device__ constexpr size_t tile_bytes(int bt, int wgs) {
  return (size_t)bt * (64 * wgs + PAD) * sizeof(float);
}

// The ring as a consumer warpgroup sees it: shared addresses of the
// stages and their mbarriers, its shape, and the warpgroup's rows.
struct Ring {
  uint32_t base, stage, full, empty;
  int ns, kb, gps, wg;
};

// Issue group q's KPG wgmmas into d, first waiting for its stage (at once
// where an earlier group of the stage waited). The group starts at k-step
// (q % gps) * KPG of the stage, inside one box where KPG < 4 (4 % KPG ==
// 0) and at a box's start otherwise, so its k-step j lies (j / 4) boxes
// and 32 * (j % 4) bytes further: one descriptor a group, and constants.
// The k-steps go straight, no branch between them.
template <int BT, int WGS, int KPG>
__device__ __forceinline__ void issue(const Ring& ring, int q,
                                      int32_t (&d)[BT / 2]) {
  constexpr int A_BOX = 64 * WGS * BOX_K;
  constexpr int B_BOX = BT * BOX_K;
  const int i = q / ring.gps, s = i % ring.ns;
  const int k0 = (q - i * ring.gps) * KPG;     // the group's first k-step
  mbar_wait_spin(ring.full + 8u * s, (i / ring.ns) & 1);
  const uint32_t at = ring.base + s * ring.stage + (k0 & 3) * KSTEP;
  const uint64_t da = desc(at + ring.wg * 64 * BOX_K + (k0 >> 2) * A_BOX);
  const uint64_t db = desc(at + ring.kb * A_BOX + (k0 >> 2) * B_BOX);
  fence_operands<BT / 2>(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KPG; ++j)
    wgmma<BT>(d, da + (((j >> 2) * A_BOX + (j & 3) * KSTEP) >> 4),
              db + (((j >> 2) * B_BOX + (j & 3) * KSTEP) >> 4), j > 0);
  wgmma_commit();
}

// Group q's products are done: free its stage where q is the stage's
// last group (each warp once its own reads are done).
__device__ __forceinline__ void release(const Ring& ring, int q, int n_g,
                                        int lane) {
  const int i = q / ring.gps;
  if (q - i * ring.gps == ring.gps - 1 || q == n_g - 1) {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + 8u * (i % ring.ns));
  }
}

// acc += float(d) * the row's group scale, rounded as stated: row r0 for
// registers with (r & 2) == 0, row r0 + 8 for the others.
template <int R>
__device__ __forceinline__ void fold(float (&acc)[R], const int32_t (&d)[R],
                                     float s0, float s1) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc[r] = __fadd_rn(acc[r], __fmul_rn(to_f32(d[r]), (r & 2) ? s1 : s0));
}

// Reduce a K split through distributed shared memory: every thread of
// the block (both roles call it), each rank adding every rank's f32 tile
// (bt x PS floats at `tile` in each block), in rank order, over its share
// of the outputs, then y = sum * sx[m].
template <int BT, int WGS>
__device__ __forceinline__ void reduce_split(float* tile, int split, int rank,
                                             int m0, int n0, int M, int N,
                                             const float* __restrict__ sx,
                                             float* __restrict__ out) {
  constexpr int ROWS = 64 * WGS, PS = ROWS + PAD, E = BT * ROWS;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (E + split - 1) / split;
  const int e_lo = rank * share, e_hi = min(E, e_lo + share);
  const float* peer[MAX_SPLIT];
#pragma unroll
  for (int q = 0; q < MAX_SPLIT; ++q)
    peer[q] = q < split ? cluster.map_shared_rank(tile, q) : nullptr;
#pragma unroll 4
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += (WGS + 1) * 128) {
    const int ml = e / ROWS, nl = e - ml * ROWS;
    const int m = m0 + ml, n = n0 + nl;
    if (m < M && n < N) {
      const int at = ml * PS + nl;
      float y = peer[0][at];
#pragma unroll
      for (int q = 1; q < MAX_SPLIT; ++q)
        if (q < split) y = __fadd_rn(y, peer[q][at]);
      out[(size_t)m * N + n] = __fmul_rn(y, __ldg(sx + m));
    }
  }
  cluster.sync();               // peers stay resident until all have read
}

// One block per (BT tokens from m0 = BT * blockIdx.x, 64 * WGS weight rows
// from n0 = 64 * WGS * blockIdx.y, rank blockIdx.z of the K split):
// WGS consumer warpgroups (warps 0 .. 4 * WGS - 1), then a producer
// warpgroup whose first thread issues the TMA loads. With two consumer
// warpgroups (two int32 accumulators and an f32 one, 64 x BT / 128 each a
// thread) the producer gives up registers (setmaxnreg) for them; the two
// roles never meet again after the split (the register counts need it):
// each ends in its own return.
template <int BT, int WGS, int KPG>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
w4a8_wgmma(const __grid_constant__ CUtensorMap map_w,
           const __grid_constant__ CUtensorMap map_x,
           const float* __restrict__ sx, const float* __restrict__ sg, int M,
           int N, int K, int split, int ns, int kb, float* __restrict__ out) {
  constexpr int ROWS = 64 * WGS;
  constexpr int A_BOX = ROWS * BOX_K;
  constexpr int B_BOX = BT * BOX_K;
  constexpr int R = BT / 2;                 // accumulators per thread
  constexpr int PS = ROWS + PAD;            // row stride of the f32 tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + (SMEM_SLACK - 1)) & ~(uint32_t)(SMEM_SLACK - 1);
  float* tile = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t stage = (uint32_t)kb * (A_BOX + B_BOX);
  const uint32_t full = base + (uint32_t)ns * stage;
  const uint32_t empty = full + 8u * ns;
  constexpr int group = KPG * KSTEP;
  const int G = K / group;
  const int rank = blockIdx.z;              // the cluster is (1, 1, split)
  const int per = G / split, extra = G % split;
  const int g_lo = rank * per + min(rank, extra);
  const int g_hi = g_lo + per + (rank < extra ? 1 : 0);
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(full + 8u * i, 1);
      mbar_init(empty + 8u * i, 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == WGS) {                          // the producer warpgroup
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == WGS * 128) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      const int k_lo = g_lo * group, k_hi = g_hi * group;
      const int n_st = (k_hi - k_lo + kb * BOX_K - 1) / (kb * BOX_K);
      for (int i = 0; i < n_st; ++i) {
        const int s = i % ns;
        if (i >= ns) mbar_wait(empty + 8u * s, ((i / ns) - 1) & 1);
        const int k0 = k_lo + i * kb * BOX_K;
        const int nb = min(kb, (k_hi - k0 + BOX_K - 1) / BOX_K);
        const uint32_t bar = full + 8u * s, dst = base + s * stage;
        mbar_expect_tx(bar, (uint32_t)nb * (A_BOX + B_BOX));
        for (int j = 0; j < nb; ++j) {
          tma_load_2d(dst + j * A_BOX, &map_w, bar, k0 + j * BOX_K, n0);
          tma_load_2d(dst + kb * A_BOX + j * B_BOX, &map_x, bar,
                      k0 + j * BOX_K, m0);
        }
      }
    }
    __syncwarp();
    if (split > 1)
      reduce_split<BT, WGS>(tile, split, rank, m0, n0, M, N, sx, out);
    return;
  }
  if constexpr (WGS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // Accumulator register i of a thread holds row r0 (+ 8 where i & 2) and
  // column 8 * (i / 4) + 2 * (lane % 4) + (i & 1) of its warpgroup's
  // 64 x BT tile (wgmma's fragment layout).
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const float* sg0 = sg + (size_t)min(n0 + r0, N - 1) * G;
  const float* sg1 = sg + (size_t)min(n0 + r0 + 8, N - 1) * G;
  int32_t d[R], e[R];
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0, e[i] = 0, acc[i] = 0.0f;
  const int n_g = g_hi - g_lo;               // this rank's groups
  float s0 = __ldg(sg0 + g_lo), s1 = __ldg(sg1 + g_lo);
  float t0 = __ldg(sg0 + g_lo + min(1, n_g - 1));
  float t1 = __ldg(sg1 + g_lo + min(1, n_g - 1));
  // Group q of the rank lies in stage q / gps. Its KPG wgmmas are issued
  // straight (no branch between them, so the tensor cores pipeline them)
  // into one of two int32 accumulators in turn, each group's before the
  // previous group's epilogue; then all are waited for and the previous
  // group is folded into the f32 accumulator. Nothing branches around a
  // wgmma: where no group is left, the last is issued again and never
  // read (a branch there, or folding a group while the next one's
  // products run, makes the compiler serialize every wgmma: slower on
  // the card).
  const Ring ring{base, stage, full, empty, ns, kb, 4 * kb / KPG, wg};
  const int last = n_g - 1;
  issue<BT, WGS, KPG>(ring, 0, d);
  int q = 0;
  for (; q < last; q += 2) {                 // groups q (d) and q + 1 (e)
    issue<BT, WGS, KPG>(ring, q + 1, e);
    wgmma_wait<0>();
    fence_operands<R>(d);
    fence_operands<R>(e);
    release(ring, q, n_g, lane);
    fold<R>(acc, d, s0, s1);
    s0 = t0, s1 = t1;
    t0 = __ldg(sg0 + g_lo + min(q + 2, last));
    t1 = __ldg(sg1 + g_lo + min(q + 2, last));
    issue<BT, WGS, KPG>(ring, min(q + 2, last), d);
    wgmma_wait<0>();
    fence_operands<R>(d);
    release(ring, q + 1, n_g, lane);
    fold<R>(acc, e, s0, s1);
    s0 = t0, s1 = t1;
    t0 = __ldg(sg0 + g_lo + min(q + 3, last));
    t1 = __ldg(sg1 + g_lo + min(q + 3, last));
  }
  wgmma_wait<0>();
  fence_operands<R>(d);
  if (q == last) {                           // n_g odd: the last group
    release(ring, q, n_g, lane);
    fold<R>(acc, d, s0, s1);
  }
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r0 + ((r & 2) ? 8 : 0);
      const int m = m0 + (r >> 2) * 8 + 2 * (lane & 3) + (r & 1);
      if (m < M && n < N)
        out[(size_t)m * N + n] = __fmul_rn(acc[r], __ldg(sx + m));
    }
    return;
  }
  // The ring is free once every consumer is past its last wait.
  asm volatile("bar.sync 1, %0;\n" ::"n"(WGS * 128) : "memory");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + ((r & 2) ? 8 : 0);
    const int col = (r >> 2) * 8 + 2 * (lane & 3) + (r & 1);
    tile[col * PS + row] = acc[r];
  }
  reduce_split<BT, WGS>(tile, split, rank, m0, n0, M, N, sx, out);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_entry() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous (rows, K) int8 matrix, dims innermost
// first, box (BOX_K, box_rows), 128-byte swizzle; outside reads as zero.
int encode(CUtensorMap* map, const void* p, int rows, int K, int box_rows) {
  EncodeTiled fn = encode_entry();
  if (fn == nullptr) return ERR_ENTRY;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BOX_K, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p),
                  dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int BT, int WGS, int KPG>
int launch_tc(const CUtensorMap& map_w, const CUtensorMap& map_x,
              const float* sx, const float* sg, int M, int N, int K,
              int split, int ns, int kb, float* out, size_t smem,
              cudaStream_t st) {
  auto kernel = w4a8_wgmma<BT, WGS, KPG>;
  static size_t granted = 0;    // once per instance: the most any ring takes
  cudaError_t e = cudaSuccess;
  if (smem > granted) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    granted = SMEM_LIMIT;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BT - 1) / BT, (N + 64 * WGS - 1) / (64 * WGS),
                     split);
  cfg.blockDim = dim3((WGS + 1) * 128, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map_w, map_x, sx, sg, M, N, K, split,
                         ns, kb, out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int BT, int WGS>
int by_group(const CUtensorMap& map_w, const CUtensorMap& map_x,
             const float* sx, const float* sg, int M, int N, int K, int group,
             int split, int ns, int kb, float* out, size_t smem,
             cudaStream_t st) {
  switch (group) {
    case 32:
      return launch_tc<BT, WGS, 1>(map_w, map_x, sx, sg, M, N, K, split, ns,
                                   kb, out, smem, st);
    case 64:
      return launch_tc<BT, WGS, 2>(map_w, map_x, sx, sg, M, N, K, split, ns,
                                   kb, out, smem, st);
    case 128:
      return launch_tc<BT, WGS, 4>(map_w, map_x, sx, sg, M, N, K, split, ns,
                                   kb, out, smem, st);
  }
  return launch_tc<BT, WGS, 8>(map_w, map_x, sx, sg, M, N, K, split, ns, kb,
                               out, smem, st);
}

}  // namespace

extern "C" {

// out (M, N) f32. x, w contiguous int8 device pointers (4-byte aligned
// when group % 4 == 0); sx (M,) and sg (N, K / group) contiguous f32.
// K % group == 0; any K. Returns the cudaError_t of the launch (0 on
// success).
int w4a8_gemm_launch(const void* x, const void* sx, const void* w,
                     const void* sg, int M, int N, int K, int group,
                     void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || K % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
  const int kts = ((K < KT ? K : KT) + 15) / 16 * 16;   // tile row stride
  const size_t smem = (size_t)BM * kts + WARPS * BM * 32 * sizeof(float);
  if (group % 4 == 0)
    w4a8_dot<true><<<grid, WARPS * 32, smem, st>>>(
        (const int8_t*)x, (const float*)sx, (const int8_t*)w,
        (const float*)sg, M, N, K, group, kts, (float*)out);
  else
    w4a8_dot<false><<<grid, WARPS * 32, smem, st>>>(
        (const int8_t*)x, (const float*)sx, (const int8_t*)w,
        (const float*)sg, M, N, K, group, kts, (float*)out);
  return (int)cudaGetLastError();
}

// out (M, N) f32 by w4a8_wgmma. x (M, K), w (N, K) contiguous int8 on
// 16-byte aligned bases; sx (M,) and sg (N, K / group) contiguous f32;
// group 32, 64, 128 or 256, K % group == 0. (bt, wgs) one of (8, 1),
// (16, 1), (32, 1), (64, 2), (128, 2); split <= min(8, K / group) blocks
// of a cluster along K; a ring of ns >= 2 stages of kb <= 4 boxes, 4 * kb
// k-steps a multiple of group / 32 (whole groups a stage): the host's
// kernels/w4a8_gemm.py::launch_plan. Returns 0 on success, else a
// cudaError_t or one of this file's negative codes (w4a8_gemm_error).
int w4a8_wgmma_launch(const void* x, const void* sx, const void* w,
                      const void* sg, int M, int N, int K, int group,
                      void* out, int bt, int wgs, int split, int ns, int kb,
                      void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || K % group)
    return (int)cudaErrorInvalidValue;
  if ((group != 32 && group != 64 && group != 128 && group != 256) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return ERR_ALIGN;
  const int G = K / group;
  if (split < 1 || split > MAX_SPLIT || split > G || ns < 2 || kb < 1 ||
      kb > MAX_KB || (4 * kb) % (group / KSTEP))
    return ERR_PLAN;
  const size_t smem = wgmma_smem(bt, wgs, ns, kb);
  if (smem > (size_t)SMEM_LIMIT ||
      (split > 1 && tile_bytes(bt, wgs) > smem - SMEM_SLACK - 16 * (size_t)ns))
    return ERR_PLAN;
  alignas(64) CUtensorMap map_w, map_x;
  int e = encode(&map_w, w, N, K, 64 * wgs);
  if (e == 0) e = encode(&map_x, x, M, K, bt);
  if (e != 0) return e;
  const float* sxf = (const float*)sx;
  const float* sgf = (const float*)sg;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (bt == 8 && wgs == 1)
    return by_group<8, 1>(map_w, map_x, sxf, sgf, M, N, K, group, split, ns,
                          kb, o, smem, st);
  if (bt == 16 && wgs == 1)
    return by_group<16, 1>(map_w, map_x, sxf, sgf, M, N, K, group, split, ns,
                           kb, o, smem, st);
  if (bt == 32 && wgs == 1)
    return by_group<32, 1>(map_w, map_x, sxf, sgf, M, N, K, group, split, ns,
                           kb, o, smem, st);
  if (bt == 64 && wgs == 2)
    return by_group<64, 2>(map_w, map_x, sxf, sgf, M, N, K, group, split, ns,
                           kb, o, smem, st);
  if (bt == 128 && wgs == 2)
    return by_group<128, 2>(map_w, map_x, sxf, sgf, M, N, K, group, split,
                            ns, kb, o, smem, st);
  return ERR_PLAN;
}

// w4a8_wgmma's shared memory at a tiling (kernels/w4a8_gemm.py::
// wgmma_smem mirrors it).
int w4a8_wgmma_smem(int bt, int wgs, int ns, int kb) {
  return (int)wgmma_smem(bt, wgs, ns, kb);
}

const char* w4a8_gemm_error(int code) {
  switch (code) {
    case ERR_ENTRY: return "the driver has no cuTensorMapEncodeTiled";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_ALIGN:
      return "w4a8_wgmma needs group 32, 64, 128 or 256 and 16-byte "
             "aligned x and w";
    case ERR_PLAN: return "tiling out of range (bt, wgs, split, ns, kb)";
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
