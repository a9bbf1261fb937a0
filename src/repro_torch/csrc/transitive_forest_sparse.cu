// Scoreboard forest for tile-local plans with T >= 16, from a plan that keeps
// only the nodes it makes, hand-written for Hopper (sm_90a): forest_sparse.
//
// Replaces the Pallas kernel src/repro/kernels/transitive_forest.py
// (transitive_forest_pallas, body _kernel -> core/engine.py forest_body) for
// such plans: int32 activations through the planned forest -> int32
// per-group sums, bit-exact with repro_torch.core.engine.run_device on the
// DevicePlan and sparse_forest_plain on the SparseForestPlan.
//
// Why a plan of its own. From T = 16 a node index no longer fits the int16
// gathers of forest_fused16 (csrc/transitive_forest_dense.cu), and one
// column of a tile's full 2^16-node table (256 KiB) no longer fits a block's
// 227 KiB. But the planner makes only a few of those nodes: ~8,700 of
// 65,536 per tile at N = 1536, W4. The SparseForestPlan
// (core/engine.py::pack_sparse_forest_plan) numbers each tile's made nodes
// densely in level order, so a slot fits int16 and one column of the table
// is ~35 KB:
//
//   codes (J, U) int32: how slot u is made, prefix slot p | bit b << 16
//     (psum[u] = psum[p] + x[j*T + b], p in an earlier level), or DIRECT | v
//     (the subset sum of the tile's activations over node v's bits); slot 0
//     is the empty sum; U is a multiple of 4 (16-byte rows for cp.async);
//   bounds (J, T + 1) int32: level L is slots bounds[L - 1] .. bounds[L] - 1;
//   rows (J, S, N) int16, N fastest: the slot output n gathers from tile j
//     in plane s; signs (S,) int32.
//
// Design (forest_fused16's skeleton, one table a round). A thread block
// cluster of C <= 16 blocks ("ranks") covers one quantization group, BN
// outputs and BM columns; grid (G * C, N / BN, M / BM). Rank r walks its
// group's tiles in rounds, round q taking tile q * C + r. The tile's U x BM
// table lives in shared memory and is built in place, level by level, from
// the slot ranges: all SNT threads share a level, a block barrier separates
// levels (an empty level costs none), and a slot reads only earlier levels,
// so one buffer suffices. Slot 0 is zero; slots past the tile's last level
// are never written (the packer checks nothing reads one). Then each thread
// adds signs[s] * table[rows[j, s, n]] for its output n over its share of
// the planes (SNT / BN threads per output) and keeps the sums in registers
// across rounds. The next round's codes and rows arrive by cp.async into a
// second buffer, and its activations and level bounds into registers, while
// the current round builds (one buffer where a group has one round). After
// the last round the ranks leave their sums in shared memory, the cluster
// synchronises, and each rank adds its share of the BN x BM outputs over the
// ranks in rank order through distributed shared memory and stores it; a
// second cluster barrier keeps every block resident until all have read. No
// scratch, no workspace, no memset, no atomics: the wrapper allocates the
// output only. Sums are unsigned, so they wrap mod 2^32 like the
// reference's int32.
//
// Tiling (chosen on the host, kernels/transitive_forest_sparse.py::
// sparse_tiling, and checked here): C = min(16, tiles per group); of the
// tilings that fit 227 KiB, the most columns (BM <= 8), then the most
// outputs per block (BN <= 512: every block builds its tables anew, so
// fewer blocks per column build less), then two plan buffers where a group
// has more than one round. Where not even BM = 1, BN = 64 with one buffer
// fits, the host routes the plan to the two-pass kernel instead.
//
// Bound on the card. The function moves x (M*K), the int8 weights (N*K
// bytes) and the int32 output once, and adds one per made chained node,
// popcount per direct node and one per APE gather per column: at N=1536
// K=64 M=4 that is ~0.13 MB and ~0.2 M adds, so it is bound by bytes (~0.04
// us). What this design reads instead of the weights is the plan, ~47 KB a
// tile at that shape against the DevicePlan's ~8.4 MB. In practice the
// build bounds it: at that shape a call takes ~13.5 us at M = 4, ~5.5 with
// the T levels taken out and ~11.6 with only their barriers taken out
// (launch/bench_forest_sparse.py; PERF.md has the times). The rest is the
// launch, the plan bytes' first arrival and the cluster's two barriers.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SNT = 512;           // threads per block
constexpr int MAX_T = 31;          // a direct node's bits fit the code
constexpr int MAX_CLUSTER = 16;    // > 8 needs the non-portable attribute
constexpr int MAX_SLOTS = 32768;   // table rows: a slot fits int16
constexpr int UNROLL = 2;          // slots per thread in flight, per level
constexpr uint32_t DIRECT = 0x80000000u;   // engine.SPARSE_DIRECT
constexpr size_t SMEM_LIMIT = 232448;

// One table row of BM words (columns) in registers.
template <int BM>
struct Row {
  uint32_t w[BM];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < BM; ++c) w[c] = 0;
  }
  __device__ __forceinline__ void add(const uint32_t* a) {
    if constexpr (BM % 4 == 0) {
#pragma unroll
      for (int c = 0; c < BM; c += 4) {
        const uint4 q = *(const uint4*)(a + c);
        w[c] += q.x; w[c + 1] += q.y; w[c + 2] += q.z; w[c + 3] += q.w;
      }
    } else if constexpr (BM == 2) {
      const uint2 q = *(const uint2*)a;
      w[0] += q.x; w[1] += q.y;
    } else {
      w[0] += a[0];
    }
  }
  // a slot from its code: the prefix slot's row plus activation row b, or
  // the subset sum of the activation rows over the node's bits (DIRECT)
  __device__ __forceinline__ void make(const uint32_t* tab, const uint32_t* xt,
                                       int T, uint32_t code) {
    zero();
    if (!(code & DIRECT)) {
      add(tab + (code & 0xFFFFu) * BM);
      add(xt + (code >> 16) * BM);
    } else {
      for (int b = 0; b < T; ++b)
        if ((code >> b) & 1u) add(xt + b * BM);
    }
  }
  __device__ __forceinline__ void store(uint32_t* dst) const {
    if constexpr (BM % 4 == 0) {
#pragma unroll
      for (int c = 0; c < BM; c += 4)
        *(uint4*)(dst + c) = make_uint4(w[c], w[c + 1], w[c + 2], w[c + 3]);
    } else if constexpr (BM == 2) {
      *(uint2*)dst = make_uint2(w[0], w[1]);
    } else {
      dst[0] = w[0];
    }
  }
};

// Table rows in shared memory: U, or enough for the BM x (BN + 1) sums the
// cluster reduction leaves there (rounded up to 4).
__host__ __device__ inline size_t table_rows(int U, int bn) {
  const size_t r = (size_t)(bn + 4) & ~(size_t)3;
  return (size_t)U > r ? (size_t)U : r;
}

// Shared memory of one block, in the kernel's carve-up order (every part a
// multiple of 16 bytes): the table (table_rows x BM words), the round's
// T x BM activations (padded to 4 words), the level bounds (32 int32), the
// plane weights (8 int32), NBUF x U codes and NBUF x S rows rows of BN + 8
// int16.
__host__ __device__ inline size_t sparse_smem(int T, int S, int U, int bm,
                                              int nbuf, int bn) {
  return table_rows(U, bn) * bm * 4 + (size_t)((T * bm + 3) & ~3) * 4 +
         32 * 4 + 8 * 4 + (size_t)nbuf * U * 4 +
         (size_t)nbuf * S * (bn + 8) * 2;
}

template <bool ROWS, int BM>
__global__ void __launch_bounds__(SNT, 1)
forest_sparse(const void* __restrict__ xv, int K, int M,
              const uint32_t* __restrict__ codes,
              const int32_t* __restrict__ bounds,
              const uint16_t* __restrict__ rows,
              const int32_t* __restrict__ signs, int T, int S, int N, int G,
              int U, int C, int NBUF, int BN, bool aligned,
              uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int jg = K / T / G;                       // tiles per group
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / C;
  const int n0 = blockIdx.y * BN, col0 = blockIdx.z * BM;
  const int rounds = (jg + C - 1) / C;
  const int rstr = BN + 8;
  const int xw = T * BM;                          // activations per round
  uint32_t* table = (uint32_t*)smem_bytes;        // table_rows(U, BN) * BM
  uint32_t* xs = table + table_rows(U, BN) * BM;  // xw (pad 4)
  int32_t* lv = (int32_t*)(xs + ((xw + 3) & ~3)); // 32: the level bounds
  int32_t* sgs = lv + 32;                         // 8
  uint32_t* cbuf = (uint32_t*)(sgs + 8);          // NBUF * U
  uint16_t* rbuf = (uint16_t*)(cbuf + (size_t)NBUF * U);

  // round q's codes and rows into buffer b (cp.async where aligned; the
  // caller commits), rows past N as slot 0
  auto fetch_plan = [&](int q, int b) {
    const int s0 = q * C + rank;
    if (s0 >= jg) return;
    const size_t j = (size_t)g * jg + s0;
    uint32_t* cd = cbuf + (size_t)b * U;
    const uint32_t* cs = codes + j * U;
    uint16_t* rd = rbuf + (size_t)b * S * rstr;
    if (aligned) {
      for (int i = tid * 4; i < U; i += SNT * 4)
        __pipeline_memcpy_async(cd + i, cs + i, 16);
      const int per = BN / 8;                     // 16-byte units per row
      for (int i = tid; i < S * per; i += SNT) {
        const int s = i / per, nl = (i - s * per) * 8, n = n0 + nl;
        uint16_t* d = rd + s * rstr + nl;
        if (n < N)
          __pipeline_memcpy_async(d, rows + (j * S + s) * N + n, 16);
        else
          *(uint4*)d = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < U; i += SNT) cd[i] = cs[i];
      for (int i = tid; i < S * BN; i += SNT) {
        const int s = i / BN, nl = i - s * BN, n = n0 + nl;
        rd[s * rstr + nl] = n < N ? rows[(j * S + s) * N + n] : 0;
      }
    }
  };
  // round q's activations (thread tid < xw: bit tid / BM, column tid % BM)
  // and level bounds (thread tid <= T) into registers, 0 past M
  uint32_t xr = 0;
  int32_t lr = 0;
  auto fetch_x = [&](int q) {
    const int s0 = q * C + rank;
    xr = 0;
    lr = 0;
    if (s0 >= jg) return;
    const size_t j = (size_t)g * jg + s0;
    if (tid < xw) {
      const size_t k = j * T + tid / BM;
      const int col = col0 + tid % BM;
      if (col < M)
        xr = ROWS ? (uint32_t)(int32_t)((const int8_t*)xv)[(size_t)col * K + k]
                  : (uint32_t)((const int32_t*)xv)[k * M + col];
    }
    if (tid <= T) lr = bounds[j * (T + 1) + tid];
  };

  fetch_plan(0, 0);
  __pipeline_commit();
  fetch_x(0);
  if (tid < 8) sgs[tid] = tid < S ? signs[tid] : 0;

  const int tpo = SNT / BN;                       // threads per output
  const int nl = tid / tpo, part = tid - nl * tpo;
  uint32_t acc[BM];
#pragma unroll
  for (int c = 0; c < BM; ++c) acc[c] = 0;
  for (int q = 0; q < rounds; ++q) {
    const int b = NBUF == 2 ? (q & 1) : 0;
    const bool live = q * C + rank < jg;          // the same for the block
    __syncthreads();              // round q-1's table and buffer are free
    if (NBUF == 1 && q > 0) {
      fetch_plan(q, 0);
      __pipeline_commit();
    }
    if (tid < xw) xs[tid] = xr;
    if (tid <= T) lv[tid] = lr;
    if (tid < BM) table[tid] = 0;                 // slot 0
    if (NBUF == 2 && q + 1 < rounds) fetch_plan(q + 1, b ^ 1);
    __pipeline_commit();
    if (q + 1 < rounds) fetch_x(q + 1);
    __pipeline_wait_prior(1);                     // round q's bytes
    __syncthreads();
    if (!live) continue;

    // 1. the T levels in place, UNROLL slots per thread in flight; a block
    // barrier after each level that has slots
    const uint32_t* cw = cbuf + (size_t)b * U;
    for (int L = 1; L <= T; ++L) {
      const int lo = lv[L - 1], hi = lv[L];
      if (lo >= hi) continue;
      for (int i0 = lo + tid; i0 < hi; i0 += UNROLL * SNT) {
        uint32_t code[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + u * SNT;
          code[u] = i < hi ? cw[i] : 0u;
        }
        Row<BM> r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (i0 + u * SNT < hi) r[u].make(table, xs, T, code[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (i0 + u * SNT < hi)
            r[u].store(table + (size_t)(i0 + u * SNT) * BM);
      }
      __syncthreads();
    }

    // 2. APE: output n0 + nl over planes part, part + tpo, ...
    const uint16_t* rs = rbuf + (size_t)b * S * rstr;
    for (int s = part; s < S; s += tpo) {
      Row<BM> r;
      r.zero();
      r.add(table + (size_t)rs[s * rstr + nl] * BM);
      const uint32_t w = (uint32_t)sgs[s];
#pragma unroll
      for (int c = 0; c < BM; ++c) acc[c] += w * r.w[c];
    }
  }

  // 3. the tpo threads of an output meet in shuffles, the ranks through
  // distributed shared memory, in rank order
  for (int o = tpo / 2; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < BM; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  __syncthreads();                                // tables no longer read
  uint32_t* sums = table;                         // [c * (BN + 1) + nl]
  if (!part)
#pragma unroll
    for (int c = 0; c < BM; ++c) sums[c * (BN + 1) + nl] = acc[c];
  cluster.sync();
  const int total = BN * BM, share = (total + C - 1) / C;
  const int e_hi = min(total, (rank + 1) * share);
  for (int e = rank * share + tid; e < e_hi; e += SNT) {
    // ROWS: consecutive threads take consecutive outputs; else columns
    const int c = ROWS ? e / BN : e % BM, nn = ROWS ? e % BN : e / BM;
    const int n = n0 + nn, col = col0 + c;
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)       // every rank's load in flight
      if (q < C) v += cluster.map_shared_rank(sums, q)[c * (BN + 1) + nn];
    if (n < N && col < M) {
      if (ROWS) out[((size_t)col * G + g) * N + n] = v;
      else out[((size_t)n * G + g) * M + col] = v;
    }
  }
  cluster.sync();                 // peers stay resident until all have read
}

template <bool ROWS, int BM>
int launch_sparse(const void* x, int K, int M, const uint32_t* codes,
                  const int32_t* bounds, const uint16_t* rows,
                  const int32_t* signs, int T, int S, int N, int G, int U,
                  int nbuf, int bn, int cluster, uint32_t* out,
                  cudaStream_t st) {
  static size_t granted = 0;      // shared memory allowed so far
  static bool nonportable = false;
  auto kernel = forest_sparse<ROWS, BM>;
  const size_t smem = sparse_smem(T, S, U, BM, nbuf, bn);
  cudaError_t e = cudaSuccess;
  if (smem > granted) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) granted = smem;
  }
  if (e == cudaSuccess && cluster > 8 && !nonportable) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    nonportable = e == cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  const bool aligned = N % 8 == 0 && ((uintptr_t)codes & 15) == 0 &&
                       ((uintptr_t)rows & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * cluster, (N + bn - 1) / bn, (M + BM - 1) / BM);
  cfg.blockDim = dim3(SNT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, K, M, codes, bounds, rows, signs, T,
                         S, N, G, U, cluster, nbuf, bn, aligned, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool ROWS>
int sparse_by_bm(const void* x, int K, int M, const uint32_t* codes,
                 const int32_t* bounds, const uint16_t* rows,
                 const int32_t* signs, int T, int S, int N, int G, int U,
                 int bm, int nbuf, int bn, int cluster, uint32_t* out,
                 cudaStream_t st) {
#define SPARSE(BM)                                                         \
  return launch_sparse<ROWS, BM>(x, K, M, codes, bounds, rows, signs, T, S, \
                                 N, G, U, nbuf, bn, cluster, out, st)
  switch (bm) {
    case 1: SPARSE(1);
    case 2: SPARSE(2);
    case 4: SPARSE(4);
    case 8: SPARSE(8);
  }
#undef SPARSE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of one forest_sparse block (the kernel's carve-up).
size_t transitive_forest_sparse_smem(int T, int S, int U, int bm, int nbuf,
                                     int bn) {
  return sparse_smem(T, S, U, bm, nbuf, bn);
}

// Launches forest_sparse on `stream`; returns the cudaError_t of the launch
// (0 on success). rows_layout = 0: x (K, M) int32 -> out (N, G, M); 1: x
// (M, K) int8 -> out (M, G, N). All pointers are contiguous device memory:
// codes (J, U) int32 (16-byte aligned for cp.async where N % 8 == 0, else
// read plainly), bounds (J, T + 1) int32, rows (J, S, N) int16, signs (S,)
// int32, out int32, written whole. Needs 1 <= T <= 31, 1 <= S <= 8, M, N >
// 0, (K / T) % G == 0, 4 <= U <= 32768 with U % 4 == 0, and the tiling of
// sparse_tiling: bm in {1, 2, 4, 8}, nbuf in {1, 2}, bn in {64, 128, 256,
// 512}, 1 <= cluster <= 16, M / bm blocks within the grid's 65,535 and the
// block's shared memory within 227 KiB.
int transitive_forest_sparse_launch(const void* x, int rows_layout, int K,
                                    int M, const void* codes,
                                    const void* bounds, const void* rows,
                                    const void* signs, int T, int S, int N,
                                    int G, int U, int bm, int nbuf, int bn,
                                    int cluster, void* out, void* stream) {
  const bool pow2 = bm > 0 && bm <= 8 && !(bm & (bm - 1));
  if (T < 1 || T > MAX_T || M <= 0 || N <= 0 || K <= 0 || G <= 0 || K % T ||
      (K / T) % G || S < 1 || S > 8 || U < 4 || U > MAX_SLOTS || U % 4 ||
      !pow2 || (nbuf != 1 && nbuf != 2) ||
      (bn != 64 && bn != 128 && bn != 256 && bn != 512) || cluster < 1 ||
      cluster > MAX_CLUSTER || (M + bm - 1) / bm > 65535 ||
      (N + bn - 1) / bn > 65535 ||
      sparse_smem(T, S, U, bm, nbuf, bn) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* cp = (const uint32_t*)codes;
  const int32_t* bp = (const int32_t*)bounds;
  const uint16_t* rp = (const uint16_t*)rows;
  const int32_t* sp = (const int32_t*)signs;
  uint32_t* op = (uint32_t*)out;
  if (rows_layout)
    return sparse_by_bm<true>(x, K, M, cp, bp, rp, sp, T, S, N, G, U, bm,
                              nbuf, bn, cluster, op, st);
  return sparse_by_bm<false>(x, K, M, cp, bp, rp, sp, T, S, N, G, U, bm,
                             nbuf, bn, cluster, op, st);
}

const char* transitive_forest_sparse_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
