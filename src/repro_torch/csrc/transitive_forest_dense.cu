// Scoreboard forest for tile-local plans with T > 8, whose nodes do not fit
// the byte of the T <= 8 ForestPlan (csrc/transitive_forest.cu runs those),
// hand-written for Hopper (sm_90a). Two kernels:
//
//   forest_fused16 (9 <= T <= 15): one fused launch from a ForestPlan whose
//     APE gathers are int16 (a node index fits int16 up to T = 15, and one
//     column of a tile's table, 2^15 x 4 B, fits a block's shared memory);
//   forest_dense_tiles + forest_dense_ape (any T; served for T >= 16): two
//     passes from the dense int32 DevicePlan.
//
// Both replace the Pallas kernel src/repro/kernels/transitive_forest.py
// (transitive_forest_pallas, body _kernel -> core/engine.py forest_body)
// for such plans: int32 activations through the planned forest -> int32
// per-group sums, bit-exact with repro_torch.core.engine.run_device (and,
// for the fused kernel, forest_plan_plain on the ForestPlan).
//
// ---- forest_fused16 ------------------------------------------------------
//
// The plan (core/engine.py::pack_forest_plan): producer (J, 2^T) uint8, the
// code that makes node v of tile j (a bit b < T: psum[v ^ (1 << b)] +
// x[j*T + b], made at level popcount(v); DIRECT: the subset sum of the
// tile's activations over v's bits; UNUSED: never read); rows (J, S, N)
// int16, N fastest, the node output n gathers from tile j in plane s;
// signs (S,) int32.
//
// Design. A thread block cluster of C <= 16 blocks ("ranks") covers one
// quantization group (a cluster never straddles a group), BN outputs and
// BM columns; grid (G * C, N / BN, M / BM). Rank r walks its group's tiles
// in rounds: round q takes the JB consecutive tiles (q * C + r) * JB + jj.
// Each tile's 2^T x BM table lives in shared memory, one buffer, built in
// place in level order; a round builds its JB tables side by side, each by
// its own NT / JB threads (levels separated by a named barrier of those
// threads, a warp barrier when JB = 8), so a round has no block-wide
// barrier between levels. A node reads only lower levels, so one buffer
// suffices; direct nodes are summed at their own level; unused nodes are
// never written (the pack checks that nothing reads them). Then every
// thread adds signs[s] * table[rows[j, s, n]] for its output n over the
// round's (tile, plane) pairs (NT / BN threads per output split the
// pairs), and keeps the sums in registers across rounds. The next round's
// producer and rows bytes arrive by cp.async into a second buffer, and its
// activations into registers, while the current round is built (one
// buffer where two do not fit: T = 15). After the last round the
// ranks leave their sums in shared memory, the cluster synchronises, and
// each rank adds its share of the BN x BM outputs over the ranks in rank
// order through distributed shared memory and stores it; a second cluster
// barrier keeps every block resident until all have read. No scratch, no
// workspace, no memset, no atomics: the wrapper allocates the output only.
// Sums are unsigned, so they wrap mod 2^32 like the reference's int32.
//
// Level order. The T <= 8 kernel reads its node order from a 512-byte
// __constant__ table; at T = 15 that order holds 32,768 nodes. Here the
// order of width T (2^T uint16: popcount, then value) is a table in
// device memory that the wrapper makes once per T and device
// (kernels/transitive_forest_dense.py::level_order) and every block
// copies into shared memory by cp.async with its first round's plan
// bytes; the level sizes come from a 16 x 16 binomial table each block
// computes. Generating the order in the kernel instead (each node to its
// place by its combinatorial rank, popcount(v) dependent steps per node)
// took 1.6-13 us more per call at smollm-135m's shapes (PERF.md).
//
// Gathers. A table row is BM consecutive words (one 16-byte load at BM =
// 4), so a thread's gather of one node reads all its columns at once. The
// rows bytes of a round are staged with a row pitch of BN + 8 int16, so
// the NT / BN threads that share an output, which read other (tile,
// plane) rows of the same output, hit other banks. A warp's APE gathers
// of 32 outputs land on data-dependent nodes, so their rows fall on any
// bank group, and so do the prefix rows of a level's nodes; an XOR
// swizzle of the rows over the banks cost more than it saved (PERF.md),
// so the table is laid out plainly, node v at row v.
//
// Tiling (chosen on the host, kernels/transitive_forest_dense.py::
// wide_tiling, and checked here): of the tilings that fit, the one a cost
// model fitted to this kernel's times on an H100 rates fastest. A block's
// chain is its rounds times the build steps per round, so the cluster
// takes up to 16 ranks (a non-portable size, inside one GPC) and a round
// as many tables as keeps the grid within one wave of clusters; BM may
// drop below M to let more tables share a block.
//
// Bound on the card. The function moves x (M*K), the int8 weights (N*K
// bytes) and the int32 output once, and adds one per level node, popcount
// per direct node and one per APE gather per column: at N=1536 K=576 M=4
// that is 0.91 MB over 3.35 TB/s, ~0.27 us, against ~1.7 M adds, so it is
// bound by bytes. What this design reads instead of the weights is the
// ForestPlan (rows S*N*J*2 B + producer J*2^T B: 0.82 MB at T = 9, 0.79 MB
// at T = 12 for that shape), about as much. In practice the chain of
// rounds x T dependent levels, each a barrier of its tile's threads, and
// the launch bound it (PERF.md has the times).
//
// ---- forest_dense_tiles + forest_dense_ape ---------------------------------
//
// compile_plan keeps every level edge, every direct target and
// every activation row of a row inside its own T-tile (level_src[rows] =
// tile*2^T + prefix; checked once per plan by check_tile_local). So:
//
//   pass 1 (forest_dense_tiles): one block per (tile j, block of bm columns)
//     holds the tile's 2^T x bm psum table, double buffered across
//     levels, plus the tile's T activation rows and a pinned zero row
//     ((T + 1) * bm int32) in shared memory. The table is in shared
//     memory too (2 * 2^T * bm int32; the wrapper halves bm from 16 until
//     it fits the block's 227 KiB) up to T = 14; from T = 15, where even
//     one column's two tables do not fit, it lives in a global-memory
//     workspace of two tables per block, which the wrapper allocates.
//     Each block reads and writes only its own tile's rows, so a block
//     barrier between levels orders it either way. It applies the direct
//     entries that target its tile
//     (direct_idx is sorted; a binary search finds the tile's range, pad
//     lanes at J*2^T fall outside every tile and are dropped), runs the T
//     gather-only levels psum = psum[src] + x[xsrc] with a barrier between
//     levels, and writes the tile's table to a (J*2^T, M) int32 scratch.
//   pass 2 (forest_dense_ape): one thread per output (row n*G+g, column m) sums
//     signs[s] * psum[gather_idx[s, n, j], m] over the group's tiles and
//     the S bit planes. Integer sums are exact in any order; accumulation
//     is unsigned so it wraps mod 2^32 like the reference's int32.
//
// Bound on the card: the kernel must read the plan (level maps 2*T*J*2^T
// int32, gather_idx S*N*J int32, direct arrays) and x, and write the
// output; that is megabytes per linear against a few thousand integer
// adds per column, so it is bound by bytes over 3.35 TB/s. This simple
// two-pass design also moves the scratch
// table twice (J*2^T*M int32 written by pass 1, gathered by pass 2) and
// re-reads the level maps once per column block.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int lower_bound(const int32_t* a, int n,
                                           int32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// work: null for tables in shared memory, else the global workspace of
// two size * bm tables per block.
__global__ void forest_dense_tiles(const int32_t* __restrict__ x, int K, int M,
                             const int32_t* __restrict__ level_src,
                             const int32_t* __restrict__ level_xsrc,
                             const int32_t* __restrict__ direct_idx,
                             const int32_t* __restrict__ direct_bits, int D,
                             int T, int bm, int32_t* __restrict__ work,
                             int32_t* __restrict__ scratch) {
  extern __shared__ int32_t smem[];
  const int size = 1 << T;
  const int J = K / T;
  const long R = (long)J * size;
  const int j = blockIdx.x;
  const int col0 = blockIdx.y * bm;
  const int base = j * size;
  const int nt = blockDim.x;
  const long cells = (long)size * bm;
  int32_t* xs = smem;                        // (T + 1) * bm; row T = 0
  int32_t* cur = smem + (T + 1) * bm;        // size * bm
  if (work) cur = work + ((long)blockIdx.y * J + j) * 2 * cells;
  int32_t* nxt = cur + cells;                // size * bm

  for (int i = threadIdx.x; i < (T + 1) * bm; i += nt) {
    const int b = i / bm, c = i % bm, col = col0 + c;
    xs[i] = (b < T && col < M) ? x[(long)(j * T + b) * M + col] : 0;
  }
  for (long i = threadIdx.x; i < cells; i += nt) cur[i] = 0;
  __syncthreads();

  // direct dispatch: subset sums of this tile's outlier / root patterns
  const int lo = lower_bound(direct_idx, D, base);
  const int hi = lower_bound(direct_idx, D, base + size);
  for (int e = threadIdx.x; e < (hi - lo) * bm; e += nt) {
    const int d = lo + e / bm, c = e % bm;
    const int32_t* bits = direct_bits + (long)d * T;
    int32_t acc = 0;
    for (int b = 0; b < T; ++b) acc += bits[b] * xs[b * bm + c];
    cur[(long)(direct_idx[d] - base) * bm + c] = acc;
  }
  __syncthreads();

  // T gather-only levels; identity rows gather themselves + the zero row
  for (int l = 0; l < T; ++l) {
    const int32_t* src = level_src + l * R + base;
    const int32_t* xsrc = level_xsrc + l * R + base;
    for (long e = threadIdx.x; e < cells; e += nt) {
      const int r = (int)(e / bm), c = (int)(e % bm);
      const int s = src[r] - base;
      const int xr = xsrc[r];
      const int xb = (xr == K) ? T : xr - j * T;
      nxt[e] = cur[(long)s * bm + c] + xs[xb * bm + c];
    }
    __syncthreads();
    int32_t* t = cur; cur = nxt; nxt = t;
  }

  for (long e = threadIdx.x; e < cells; e += nt) {
    const int r = (int)(e / bm), c = (int)(e % bm), col = col0 + c;
    if (col < M) scratch[(long)(base + r) * M + col] = cur[e];
  }
}

__global__ void forest_dense_ape(const int32_t* __restrict__ scratch, int M,
                           const int32_t* __restrict__ gather_idx,
                           const int32_t* __restrict__ signs, int S, int N,
                           int J, int G, int32_t* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * G * M) return;
  const int col = idx % M;
  const int row = idx / M;                  // n * G + g
  const int n = row / G, g = row % G;
  const int jg = J / G;
  uint32_t acc = 0;
  for (int s = 0; s < S; ++s) {
    const int32_t* gi = gather_idx + ((long)s * N + n) * J + g * jg;
    uint32_t part = 0;
    for (int jj = 0; jj < jg; ++jj)
      part += (uint32_t)scratch[(long)gi[jj] * M + col];
    acc += (uint32_t)signs[s] * part;
  }
  out[(long)row * M + col] = (int32_t)acc;
}


// ---- forest_fused16 ------------------------------------------------------

constexpr int WNT = 256;           // threads per block
constexpr int WIDE_MIN_T = 9, WIDE_MAX_T = 15;
constexpr int MAX_CLUSTER = 16;    // > 8 needs the non-portable attribute
constexpr int XREGS = 4;           // activations per thread in flight
constexpr int UNROLL = 2;          // nodes per thread in flight, per level
constexpr int DIRECT = 254;        // engine.FOREST_DIRECT; any other code
                                   // >= T (FOREST_UNUSED) is never made
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
  // node v from its code p: the prefix row plus activation row p, or the
  // subset sum of the activation rows over v's bits (DIRECT)
  __device__ __forceinline__ void make(const uint32_t* tab, const uint32_t* xt,
                                       int T, int v, int p) {
    zero();
    if (p < T) {
      add(tab + (v ^ (1 << p)) * BM);
      add(xt + p * BM);
    } else {
      for (int b = 0; b < T; ++b)
        if ((v >> b) & 1) add(xt + b * BM);
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

// Shared memory of one block, in the kernel's carve-up order (every part
// a multiple of 16 bytes): JB tables of 2^T x BM words, JB x T x BM
// activations (padded to 4 words), the level order (2^T uint16), the
// binomials (16 x 16 uint16), the plane weights (8 int32), NBUF x JB x 2^T
// producer bytes and NBUF x JB x S rows rows of BN + 8 int16.
__host__ __device__ inline size_t fused16_smem(int T, int S, int bm, int jb,
                                               int nbuf, int bn) {
  const size_t size = (size_t)1 << T;
  return (size_t)jb * size * bm * 4 + (size_t)((jb * T * bm + 3) & ~3) * 4 +
         size * 2 + 256 * 2 + 8 * 4 + (size_t)nbuf * jb * size +
         (size_t)nbuf * jb * S * (bn + 8) * 2;
}

__device__ __forceinline__ void group_sync(int id, int nthreads) {
  if (nthreads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

template <bool ROWS, int BM>
__global__ void __launch_bounds__(WNT)
forest_fused16(const void* __restrict__ xv, int K, int M,
               const uint8_t* __restrict__ producer,
               const uint16_t* __restrict__ rows,
               const uint16_t* __restrict__ level_order,
               const int32_t* __restrict__ signs, int T, int S, int N, int G,
               int C, int JB, int NBUF, int BN, bool aligned,
               uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int size = 1 << T;
  const int jg = K / T / G;                       // tiles per group
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / C;
  const int n0 = blockIdx.y * BN, col0 = blockIdx.z * BM;
  const int rounds = (jg + C * JB - 1) / (C * JB);
  const int rstr = BN + 8;
  const int ts = size * BM;                       // words per table
  const int xw = JB * T * BM;                     // activations per round
  uint32_t* table = (uint32_t*)smem_bytes;                          // JB * ts
  uint32_t* xs = table + (size_t)JB * ts;                     // xw (pad 4)
  uint16_t* order = (uint16_t*)(xs + ((xw + 3) & ~3));        // size
  uint16_t* binom = order + size;                             // 16 x 16
  int32_t* sgs = (int32_t*)(binom + 256);                     // 8
  uint8_t* pbuf = (uint8_t*)(sgs + 8);                        // NBUF*JB*size
  uint16_t* rbuf = (uint16_t*)(pbuf + (size_t)NBUF * JB * size);

  // round q's first tile (index in the group) and its tile count
  auto round_tiles = [&](int q, int& s0, int& nj) {
    s0 = (q * C + rank) * JB;
    nj = max(0, min(JB, jg - s0));
  };
  // round q's producer and rows bytes into buffer b (cp.async where
  // aligned; the caller commits), rows past N as node 0
  auto fetch_plan = [&](int q, int b) {
    int s0, nj;
    round_tiles(q, s0, nj);
    if (!nj) return;
    const size_t j0 = (size_t)g * jg + s0;
    uint8_t* pd = pbuf + (size_t)b * JB * size;
    const uint8_t* ps = producer + j0 * size;
    uint16_t* rd = rbuf + (size_t)b * JB * S * rstr;
    if (aligned) {
      for (int i = tid * 16; i < nj * size; i += WNT * 16)
        __pipeline_memcpy_async(pd + i, ps + i, 16);
      const int per = BN / 8;                     // 16-byte units per row
      for (int i = tid; i < nj * S * per; i += WNT) {
        const int js = i / per, nl = (i - js * per) * 8, n = n0 + nl;
        uint16_t* d = rd + js * rstr + nl;
        if (n < N)
          __pipeline_memcpy_async(d, rows + (j0 * S + js) * N + n, 16);
        else
          *(uint4*)d = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < nj * size; i += WNT) pd[i] = ps[i];
      for (int i = tid; i < nj * S * BN; i += WNT) {
        const int js = i / BN, nl = i - js * BN, n = n0 + nl;
        rd[js * rstr + nl] = n < N ? rows[(j0 * S + js) * N + n] : 0;
      }
    }
  };
  // round q's activations into registers: i = tid + r * WNT over
  // (slot, bit, column), 0 past M and for slots past the group
  uint32_t xr[XREGS];
  auto fetch_x = [&](int q) {
    int s0, nj;
    round_tiles(q, s0, nj);
#pragma unroll
    for (int r = 0; r < XREGS; ++r) {
      const int i = tid + r * WNT;
      const int jj = i / (T * BM), rem = i - jj * T * BM;
      const int k = (g * jg + s0 + jj) * T + rem / BM, col = col0 + rem % BM;
      uint32_t v = 0;
      if (i < xw && jj < nj && col < M)
        v = ROWS ? (uint32_t)(int32_t)((const int8_t*)xv)[(size_t)col * K + k]
                 : (uint32_t)((const int32_t*)xv)[(size_t)k * M + col];
      xr[r] = v;
    }
  };

  for (int i = tid * 8; i < size; i += WNT * 8)     // the level order
    __pipeline_memcpy_async(order + i, level_order + i, 16);
  fetch_plan(0, 0);
  __pipeline_commit();
  fetch_x(0);
  if (tid < 8) sgs[tid] = tid < S ? signs[tid] : 0;
  {                                               // C(n, k), 0 for k > n
    const int n = tid >> 4, k = tid & 15;
    uint32_t c = k <= n;
    for (int j = 0; j < k && j < n; ++j) c = c * (n - j) / (j + 1);
    binom[tid] = (uint16_t)c;
  }

  const int tpo = WNT / BN;                       // threads per output
  const int nl = tid / tpo, part = tid - nl * tpo;
  const int gsz = WNT / JB;                       // threads per table
  const int slot = tid / gsz, tg = tid - slot * gsz;
  uint32_t acc[BM];
#pragma unroll
  for (int c = 0; c < BM; ++c) acc[c] = 0;
  for (int q = 0; q < rounds; ++q) {
    const int b = NBUF == 2 ? (q & 1) : 0;
    int s0, nj;
    round_tiles(q, s0, nj);
    __syncthreads();              // round q-1's tables and buffer are free
    if (NBUF == 1 && q > 0) {
      fetch_plan(q, 0);
      __pipeline_commit();
    }
#pragma unroll
    for (int r = 0; r < XREGS; ++r)
      if (tid + r * WNT < xw) xs[tid + r * WNT] = xr[r];
    for (int i = tid; i < JB * BM; i += WNT)
      table[(i / BM) * ts + i % BM] = 0;          // node 0 of every table
    if (NBUF == 2 && q + 1 < rounds) fetch_plan(q + 1, b ^ 1);
    __pipeline_commit();
    if (q + 1 < rounds) fetch_x(q + 1);
    __pipeline_wait_prior(1);                     // round q's bytes
    __syncthreads();

    // 1. the T levels of table `slot`, in place, UNROLL nodes per thread
    // in flight; levels separated by a barrier of the table's threads
    if (slot < nj) {
      uint32_t* tab = table + (size_t)slot * ts;
      const uint32_t* xt = xs + slot * T * BM;
      const uint8_t* pw = pbuf + ((size_t)b * JB + slot) * size;
      int off = 1;                                // level 0 is node 0
      for (int L = 1; L <= T; ++L) {
        const int cnt = binom[T * 16 + L];
        for (int i0 = tg; i0 < cnt; i0 += UNROLL * gsz) {
          int v[UNROLL], p[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * gsz;
            v[u] = i < cnt ? order[off + i] : 0;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            p[u] = i0 + u * gsz < cnt ? pw[v[u]] : DIRECT + 1;
          Row<BM> r[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (p[u] < T || p[u] == DIRECT) r[u].make(tab, xt, T, v[u], p[u]);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (p[u] < T || p[u] == DIRECT)
              r[u].store(tab + v[u] * BM);
        }
        off += cnt;
        group_sync(1 + slot, gsz);
      }
    }
    __syncthreads();

    // 2. APE: output n0 + nl over the round's (tile, plane) pairs e =
    // jj * S + s, part, part + tpo, ...
    const uint16_t* rs = rbuf + (size_t)b * JB * S * rstr;
    int jj = 0, s = part;
    while (s >= S) { s -= S; ++jj; }
    for (int e = part; e < nj * S; e += tpo) {
      Row<BM> r;
      r.zero();
      r.add(table + (size_t)jj * ts + rs[(jj * S + s) * rstr + nl] * BM);
      const uint32_t w = (uint32_t)sgs[s];
#pragma unroll
      for (int c = 0; c < BM; ++c) acc[c] += w * r.w[c];
      s += tpo;
      while (s >= S) { s -= S; ++jj; }
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
  for (int e = rank * share + tid; e < e_hi; e += WNT) {
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
int launch_fused16(const void* x, int K, int M, const uint8_t* producer,
                   const uint16_t* rows, const uint16_t* order,
                   const int32_t* signs, int T, int S, int N, int G, int jb,
                   int nbuf, int bn, int cluster, uint32_t* out,
                   cudaStream_t st) {
  static size_t granted = 0;      // shared memory allowed so far
  static bool nonportable = false;
  auto kernel = forest_fused16<ROWS, BM>;
  const size_t smem = fused16_smem(T, S, BM, jb, nbuf, bn);
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
  const bool aligned = N % 8 == 0 && ((uintptr_t)producer & 15) == 0 &&
                       ((uintptr_t)rows & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * cluster, (N + bn - 1) / bn, (M + BM - 1) / BM);
  cfg.blockDim = dim3(WNT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, K, M, producer, rows, order,
                         signs, T, S, N, G, cluster, jb, nbuf, bn, aligned,
                         out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool ROWS>
int fused16_by_bm(const void* x, int K, int M, const uint8_t* producer,
                  const uint16_t* rows, const uint16_t* order,
                  const int32_t* signs, int T, int S, int N, int G, int bm,
                  int jb, int nbuf, int bn, int cluster, uint32_t* out,
                  cudaStream_t st) {
#define FUSED16(BM)                                                      \
  return launch_fused16<ROWS, BM>(x, K, M, producer, rows, order, signs, \
                                  T, S, N, G, jb, nbuf, bn, cluster, out, st)
  switch (bm) {
    case 1: FUSED16(1);
    case 2: FUSED16(2);
    case 4: FUSED16(4);
    case 8: FUSED16(8);
  }
#undef FUSED16
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a block of bm columns at width T, with
// its tables in shared memory (in_smem) or in a global workspace.
size_t transitive_forest_dense_smem(int T, int bm, int in_smem) {
  return ((in_smem ? 2 * ((size_t)1 << T) * bm : 0) + (size_t)(T + 1) * bm) *
         sizeof(int32_t);
}

// Launches both passes on `stream`; returns the cudaError_t of the launch
// (0 on success). All pointers are device pointers to contiguous int32.
// work: null to keep pass 1's tables in shared memory, else a workspace
// of 2 * 2^T * bm int32 per pass-1 block (J * ceil(M / bm) blocks).
int transitive_forest_dense_launch(const void* x, int K, int M,
                                   const void* level_src,
                                   const void* level_xsrc,
                                   const void* direct_idx,
                                   const void* direct_bits, int D,
                                   const void* gather_idx, const void* signs,
                                   int T, int S, int N, int G, int bm,
                                   void* work, void* scratch, void* out,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int J = K / T;
  const size_t smem = transitive_forest_dense_smem(T, bm, work == nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        forest_dense_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid1(J, (M + bm - 1) / bm);
  forest_dense_tiles<<<grid1, 256, smem, st>>>(
      (const int32_t*)x, K, M, (const int32_t*)level_src,
      (const int32_t*)level_xsrc, (const int32_t*)direct_idx,
      (const int32_t*)direct_bits, D, T, bm, (int32_t*)work,
      (int32_t*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long total = (long)N * G * M;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  forest_dense_ape<<<(unsigned)blocks, threads, 0, st>>>(
      (const int32_t*)scratch, M, (const int32_t*)gather_idx,
      (const int32_t*)signs, S, N, J, G, (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* transitive_forest_dense_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}


// Shared memory of one forest_fused16 block (the kernel's carve-up).
size_t transitive_forest_fused16_smem(int T, int S, int bm, int jb, int nbuf,
                                      int bn) {
  return fused16_smem(T, S, bm, jb, nbuf, bn);
}

// Launches forest_fused16 on `stream`; returns the cudaError_t of the
// launch (0 on success). rows_layout = 0: x (K, M) int32 -> out (N, G, M);
// 1: x (M, K) int8 -> out (M, G, N). All pointers are contiguous device
// memory; producer (J, 2^T) uint8, rows (J, S, N) int16, order (2^T,)
// uint16 the nodes in level order (popcount, then value; 16-byte
// aligned), signs (S,) int32, out int32, written whole. Needs 9 <= T <=
// 15, 1 <= S <= 8, M, N > 0,
// (K / T) % G == 0, and the tiling of wide_tiling: bm, jb in {1, 2, 4,
// 8}, nbuf in {1, 2}, bn in {64, 128, 256}, 1 <= cluster <= 16, the
// block's shared memory within 227 KiB and jb * T * bm <= 1024.
int transitive_forest_fused16_launch(const void* x, int rows_layout, int K,
                                     int M, const void* producer,
                                     const void* rows, const void* order,
                                     const void* signs, int T, int S, int N,
                                     int G, int bm, int jb, int nbuf, int bn,
                                     int cluster, void* out, void* stream) {
  const bool pow2 = bm > 0 && bm <= 8 && !(bm & (bm - 1)) && jb > 0 &&
                    jb <= 8 && !(jb & (jb - 1));
  if (T < WIDE_MIN_T || T > WIDE_MAX_T || M <= 0 || N <= 0 || K <= 0 ||
      G <= 0 || K % T || (K / T) % G || S < 1 || S > 8 || !pow2 ||
      (nbuf != 1 && nbuf != 2) || (bn != 64 && bn != 128 && bn != 256) ||
      cluster < 1 || cluster > MAX_CLUSTER || jb * T * bm > XREGS * WNT ||
      ((uintptr_t)order & 15) ||
      fused16_smem(T, S, bm, jb, nbuf, bn) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pp = (const uint8_t*)producer;
  const uint16_t* rp = (const uint16_t*)rows;
  const uint16_t* lo = (const uint16_t*)order;
  const int32_t* sp = (const int32_t*)signs;
  uint32_t* op = (uint32_t*)out;
  if (rows_layout)
    return fused16_by_bm<true>(x, K, M, pp, rp, lo, sp, T, S, N, G, bm, jb,
                               nbuf, bn, cluster, op, st);
  return fused16_by_bm<false>(x, K, M, pp, rp, lo, sp, T, S, N, G, bm, jb,
                              nbuf, bn, cluster, op, st);
}

}  // extern "C"
