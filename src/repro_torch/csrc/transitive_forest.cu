// Scoreboard forest from a compact ForestPlan, hand-written for Hopper
// (sm_90a), in one fused pass.
//
// Replaces the Pallas kernel src/repro/kernels/transitive_forest.py
// (transitive_forest_pallas, body _kernel -> core/engine.py forest_body).
// Same function as repro_torch.core.engine.run_device on the DevicePlan the
// ForestPlan was packed from (and forest_plan_plain on the ForestPlan):
// activations through the planned forest -> int32 per-group sums, exact.
//
// The plan (core/engine.py::pack_forest_plan), one byte per entry:
//   producer (J, 2^T): node v of tile j is psum[v ^ (1 << b)] + x[j*T + b]
//     for a code b < T (made at level popcount(v), from a prefix one level
//     down), the subset sum of the tile's activations over v's bits for
//     DIRECT, and 0 for UNUSED;
//   rows (J, S, N), N fastest: the node output n gathers from tile j in
//     bit plane s;
//   signs (S,) int32: the 2's-complement plane weights.
//
// Design. Every edge stays inside its T-tile, so a block holds the psum
// tables of its tiles (2^T rows of its columns each) in shared memory
// from the first level to the APE sum; nothing of the table goes to
// device memory. A block never straddles a quantization group. For each
// tile a block
//   1. loads the tile's activations and producer bytes, and the rows
//      bytes of its outputs (cp.async, coalesced along n), and zeroes
//      node 0;
//   2. runs the T levels in place over the nodes in level order
//      (kOrder), each node from its code: a level reads only nodes of
//      lower levels, so one buffer suffices; direct nodes are summed at
//      their own level; unused nodes are never written, because nothing
//      reads them (pack_forest_plan checks that);
//   3. for each of its outputs n and columns, adds signs[s] *
//      table[rows[j, s, n]][col] over the tiles and the S planes.
// Blocks that cover part of a group add into a zeroed output with
// integer atomics (a plain store when one block covers a group). Integer
// sums are exact in any order; all sums are unsigned, so they wrap mod
// 2^32 like the reference's int32. Two shapes of block, by M:
//   narrow (M <= 8; decode): grid (chunk of JC = 8 tiles, block of BN =
//     64 outputs, block of BM <= 8 columns). Warp w builds tile w's table
//     alone, so levels are separated by warp barriers, not block ones,
//     while the rows bytes are still in flight; then NT / BN threads
//     share an output (split over the tiles, joined by shuffles), and a
//     table row of BM columns is one vector load.
//   wide (M > 8; prefill): grid (group x K split, block of BNW = 256
//     outputs, block of 32 columns). A lane owns a column and a warp 32
//     outputs, so a gather is one table row read by the whole warp (no
//     bank conflicts) and the sums stay in registers while the block
//     walks its share of the group's tiles, one tile per chunk, the next
//     tile's plan bytes and activations loading during the current one.
//     Results leave through shared memory so the stores are coalesced.
//     A wide grid of fewer than SPLIT blocks per SM splits each group's
//     tiles across blocks.
// The tiling (JC, BN, JCW, BNW, SPLIT) was chosen by timing the row
// entry on an H100 at smollm-135m's linear shapes (PERF.md).
// Two layouts of activations and outputs: (K, M) int32 in -> (N, G, M)
// out (the reference's contract), and (M, K) int8 in -> (M, G, N) out,
// the layout the quantized linear holds its codes in, so the serving path
// needs no cast, transpose or copy around the call.
//
// Bound on the card: the kernel must read the plan once (rows S*N*J bytes
// + producer J*2^T bytes + signs), the activations, and write the output;
// at the decode shape N=1536, K=576, M=4 that is ~0.46 MB against ~0.2 M
// integer adds, so it is bound by bytes over 3.35 TB/s (~0.15 us), and in
// practice by the launch, the memset and the chain of T dependent levels.
// At M = 512 the S*N*J*M table gathers (226 M at N=1536, K=576) dominate:
// bound by operations, and in practice by shared-memory loads (one 128-B
// wavefront per warp gather) and by rebuilding each tile's table once per
// block of outputs (N / BNW times).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block (8 warps)
constexpr int JC = 8;              // tiles per narrow block (one chunk)
constexpr int BN = 64;             // outputs per narrow block (NT / BN
                                   // threads per output)
constexpr int JCW = 1;             // tiles per chunk of a wide block
constexpr int BNW = 256;           // outputs per wide block (32 per warp)
constexpr int QW = BNW / (NT / 32) / 4;  // 4-output quads per warp, wide
constexpr int SPLIT = 8;           // wide grids below SPLIT blocks per SM
                                   // split K across blocks
constexpr int DIRECT = 254;        // engine.FOREST_DIRECT; any other
                                   // code >= T (FOREST_UNUSED) leaves 0

__constant__ int kBinom[9][9] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0},     {1, 1, 0, 0, 0, 0, 0, 0, 0},
    {1, 2, 1, 0, 0, 0, 0, 0, 0},     {1, 3, 3, 1, 0, 0, 0, 0, 0},
    {1, 4, 6, 4, 1, 0, 0, 0, 0},     {1, 5, 10, 10, 5, 1, 0, 0, 0},
    {1, 6, 15, 20, 15, 6, 1, 0, 0},  {1, 7, 21, 35, 35, 21, 7, 1, 0},
    {1, 8, 28, 56, 70, 56, 28, 8, 1}};

// The 2^T nodes of width T in level order (popcount, then value), for
// T = 1 .. 8 one after the other: width T starts at 2^T, a word boundary
// from T = 2 on (after two bytes of padding).
__device__ const __align__(16) uint8_t kOrder[512] = {
    0, 0, 0, 1, 0, 1, 2, 3, 0, 1, 2, 4, 3, 5, 6, 7, 0, 1,
    2, 4, 8, 3, 5, 6, 9, 10, 12, 7, 11, 13, 14, 15, 0, 1,
    2, 4, 8, 16, 3, 5, 6, 9, 10, 12, 17, 18, 20, 24, 7, 11,
    13, 14, 19, 21, 22, 25, 26, 28, 15, 23, 27, 29, 30, 31, 0, 1,
    2, 4, 8, 16, 32, 3, 5, 6, 9, 10, 12, 17, 18, 20, 24, 33,
    34, 36, 40, 48, 7, 11, 13, 14, 19, 21, 22, 25, 26, 28, 35, 37,
    38, 41, 42, 44, 49, 50, 52, 56, 15, 23, 27, 29, 30, 39, 43, 45,
    46, 51, 53, 54, 57, 58, 60, 31, 47, 55, 59, 61, 62, 63, 0, 1,
    2, 4, 8, 16, 32, 64, 3, 5, 6, 9, 10, 12, 17, 18, 20, 24,
    33, 34, 36, 40, 48, 65, 66, 68, 72, 80, 96, 7, 11, 13, 14, 19,
    21, 22, 25, 26, 28, 35, 37, 38, 41, 42, 44, 49, 50, 52, 56, 67,
    69, 70, 73, 74, 76, 81, 82, 84, 88, 97, 98, 100, 104, 112, 15, 23,
    27, 29, 30, 39, 43, 45, 46, 51, 53, 54, 57, 58, 60, 71, 75, 77,
    78, 83, 85, 86, 89, 90, 92, 99, 101, 102, 105, 106, 108, 113, 114, 116,
    120, 31, 47, 55, 59, 61, 62, 79, 87, 91, 93, 94, 103, 107, 109, 110,
    115, 117, 118, 121, 122, 124, 63, 95, 111, 119, 123, 125, 126, 127, 0, 1,
    2, 4, 8, 16, 32, 64, 128, 3, 5, 6, 9, 10, 12, 17, 18, 20,
    24, 33, 34, 36, 40, 48, 65, 66, 68, 72, 80, 96, 129, 130, 132, 136,
    144, 160, 192, 7, 11, 13, 14, 19, 21, 22, 25, 26, 28, 35, 37, 38,
    41, 42, 44, 49, 50, 52, 56, 67, 69, 70, 73, 74, 76, 81, 82, 84,
    88, 97, 98, 100, 104, 112, 131, 133, 134, 137, 138, 140, 145, 146, 148, 152,
    161, 162, 164, 168, 176, 193, 194, 196, 200, 208, 224, 15, 23, 27, 29, 30,
    39, 43, 45, 46, 51, 53, 54, 57, 58, 60, 71, 75, 77, 78, 83, 85,
    86, 89, 90, 92, 99, 101, 102, 105, 106, 108, 113, 114, 116, 120, 135, 139,
    141, 142, 147, 149, 150, 153, 154, 156, 163, 165, 166, 169, 170, 172, 177, 178,
    180, 184, 195, 197, 198, 201, 202, 204, 209, 210, 212, 216, 225, 226, 228, 232,
    240, 31, 47, 55, 59, 61, 62, 79, 87, 91, 93, 94, 103, 107, 109, 110,
    115, 117, 118, 121, 122, 124, 143, 151, 155, 157, 158, 167, 171, 173, 174, 179,
    181, 182, 185, 186, 188, 199, 203, 205, 206, 211, 213, 214, 217, 218, 220, 227,
    229, 230, 233, 234, 236, 241, 242, 244, 248, 63, 95, 111, 119, 123, 125, 126,
    159, 175, 183, 187, 189, 190, 207, 215, 219, 221, 222, 231, 235, 237, 238, 243,
    245, 246, 249, 250, 252, 127, 191, 223, 239, 247, 251, 253, 254, 255,
};

// Activation (jj, b, c) of tiles j0 .. j0+nj-1, columns col0 + c < col0 + W
// (0 past M), for index i = (jj * T + b) * W + c.
template <bool ROWS, int W>
__device__ __forceinline__ uint32_t x_at(const void* xv, int K, int M,
                                         int T, int j0, int col0, int i) {
  const int col = col0 + i % W, k = j0 * T + i / W;
  if (col >= M) return 0;
  return ROWS ? (uint32_t)(int32_t)((const int8_t*)xv)[(size_t)col * K + k]
              : (uint32_t)((const int32_t*)xv)[(size_t)k * M + col];
}

// n bytes from device memory to shared memory, by threads tid, tid + nt,
// ...: cp.async words when `aligned` (both addresses and n word-aligned),
// else plain byte copies. The caller commits and waits.
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int n, bool aligned, int tid,
                                           int nt) {
  if (aligned)
    for (int i = tid * 4; i < n; i += nt * 4)
      __pipeline_memcpy_async(dst + i, src + i, 4);
  else
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
}

// The rows bytes of outputs n0 .. n0+bn-1 for tiles j0 .. j0+nj-1 into
// rs[(jj * S + s) * stride + nl] (row 0 past N), by the whole block.
// `aligned`: rows and N word-aligned (bn and stride always are), so whole
// words are either in range or past N.
__device__ __forceinline__ void load_rows(uint8_t* rs, int stride,
                                          const uint8_t* rows, int S, int N,
                                          int j0, int nj, int n0, int bn,
                                          bool aligned) {
  const int step = aligned ? 4 : 1, per = bn / step;
  for (int i = threadIdx.x; i < nj * S * per; i += NT) {
    const int js = i / per, nl = (i - js * per) * step, n = n0 + nl;
    uint8_t* d = rs + js * stride + nl;
    const uint8_t* src = rows + ((size_t)j0 * S + js) * N + n;
    if (aligned) {
      if (n < N) __pipeline_memcpy_async(d, src, 4);
      else *(uint32_t*)d = 0;
    } else {
      *d = n < N ? *src : 0;
    }
  }
}

// One table row of a level: node v of a tile from its producer code p,
// W words (columns) per thread. The tile's rows are rw words apart, its
// activation rows xw words apart.
//   p < T: the prefix row v ^ (1 << p) plus activation row p;
//   DIRECT: the subset sum of the activation rows over v's bits.
// Other codes (unused nodes) are never read: pack_forest_plan checks that
// every prefix and every APE gather is a made node or node 0.
template <int W>
struct Row {
  uint32_t w[W];
  __device__ __forceinline__ void add(const uint32_t* a) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int c = 0; c < W; c += 4) {
        const uint4 q = *(const uint4*)(a + c);
        w[c] += q.x; w[c + 1] += q.y; w[c + 2] += q.z; w[c + 3] += q.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) w[c] += a[c];
    }
  }
  __device__ __forceinline__ void make(const uint32_t* tile, int rw,
                                       const uint32_t* xt, int xw, int T,
                                       int v, int p) {
#pragma unroll
    for (int c = 0; c < W; ++c) w[c] = 0;
    if (p < T) {
      add(tile + (v ^ (1 << p)) * rw);
      add(xt + p * xw);
    } else {
      for (int b = 0; b < T; ++b)
        if ((v >> b) & 1) add(xt + b * xw);
    }
  }
  __device__ __forceinline__ void store(uint32_t* dst) const {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int c = 0; c < W; c += 4)
        *(uint4*)(dst + c) = make_uint4(w[c], w[c + 1], w[c + 2], w[c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) dst[c] = w[c];
    }
  }
};

// The narrow block: warp w builds tile w's table alone (levels separated
// by warp barriers only), then NT / BN threads share each output: they
// split the tiles and meet in warp shuffles. The rows bytes load
// asynchronously while the tables are built.
template <bool ROWS, int BM>
__global__ void __launch_bounds__(NT)
forest_narrow(const void* __restrict__ xv, int K, int M,
              const uint8_t* __restrict__ producer,
              const uint8_t* __restrict__ rows,
              const int32_t* __restrict__ signs, int T, int S, int N, int G,
              int cpg, bool aligned, uint32_t* __restrict__ out,
              bool atomic) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int size = 1 << T;
  const int jg = K / T / G;                 // tiles per group
  const int g = blockIdx.x / cpg;
  const int j0 = g * jg + (blockIdx.x % cpg) * JC;
  const int nj = min(JC, (g + 1) * jg - j0);
  const int n0 = blockIdx.y * BN;
  const int col0 = blockIdx.z * BM;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ts = size * BM, xt = T * BM;
  uint32_t* table = (uint32_t*)smem;                     // JC * ts
  uint32_t* xs = table + JC * ts;                        // JC * xt
  uint8_t* prod = (uint8_t*)(xs + JC * xt);              // JC * size
  uint8_t* order = prod + JC * size;                     // JC * size
  uint8_t* rs = order + JC * size;                       // JC * S * rstr
  // rows rows of the block are rstr = BN + 4 bytes apart: the threads of
  // one output, which read tiles part, part + tpo, ..., hit other banks
  constexpr int rstr = BN + 4;
  uint32_t sg[8];                                        // plane weights
#pragma unroll
  for (int s = 0; s < 8; ++s) sg[s] = s < S ? (uint32_t)signs[s] : 0;

  if (w < nj) {                 // this warp's tile: producer bytes and
                                // its own copy of the node order, first
    copy_bytes(prod + w * size, producer + (size_t)(j0 + w) * size, size,
               aligned, lane, 32);
    copy_bytes(order + w * size, kOrder + size, size, T >= 2, lane, 32);
    __pipeline_commit();
  }
  load_rows(rs, rstr, rows, S, N, j0, nj, n0, BN, aligned);  // for the APE
  __pipeline_commit();
  if (w < nj) {
    // 1. activations, node 0 = 0, the producer bytes landed
    uint32_t* tab = table + w * ts;
    uint32_t* xw = xs + w * xt;
    const uint8_t* pw = prod + w * size;
    for (int i = lane; i < T * BM; i += 32)
      xw[i] = x_at<ROWS, BM>(xv, K, M, T, j0 + w, col0, i);
    if (lane < BM) tab[lane] = 0;
    __pipeline_wait_prior(1);
    __syncwarp();
    // 2. the T levels, in place, two nodes per lane in flight
    const uint8_t* ord = order + w * size;
    int off = 1;                                // level 0 is node 0 alone
    for (int L = 1; L <= T; ++L) {
      const int cnt = kBinom[T][L];
      for (int i = lane; i < cnt; i += 64) {
        const int i2 = i + 32;
        const int v = ord[off + i], v2 = i2 < cnt ? ord[off + i2] : 0;
        const int p = pw[v], p2 = i2 < cnt ? pw[v2] : DIRECT + 1;
        Row<BM> a, b;
        if (p < T || p == DIRECT) a.make(tab, BM, xw, BM, T, v, p);
        if (p2 < T || p2 == DIRECT) b.make(tab, BM, xw, BM, T, v2, p2);
        if (p < T || p == DIRECT) a.store(tab + v * BM);
        if (p2 < T || p2 == DIRECT) b.store(tab + v2 * BM);
      }
      off += cnt;
      __syncwarp();
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // 3. APE: tpo threads per output, each over tiles part, part + tpo, ...
  constexpr int tpo = NT / BN;
  const int nl = threadIdx.x / tpo, part = threadIdx.x % tpo;
  const int n = n0 + nl;
  uint32_t acc[BM];
#pragma unroll
  for (int c = 0; c < BM; ++c) acc[c] = 0;
  if (n < N) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s >= S) break;
      Row<BM> sum;
#pragma unroll
      for (int c = 0; c < BM; ++c) sum.w[c] = 0;
#pragma unroll 4
      for (int jj = part; jj < nj; jj += tpo)
        sum.add(table + jj * ts + rs[(jj * S + s) * rstr + nl] * BM);
#pragma unroll
      for (int c = 0; c < BM; ++c) acc[c] += sg[s] * sum.w[c];
    }
  }
  for (int o = tpo / 2; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < BM; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  if (part || n >= N) return;
#pragma unroll
  for (int c = 0; c < BM; ++c) {
    const int col = col0 + c;
    if (col >= M) break;
    uint32_t* o = ROWS ? out + ((size_t)col * G + g) * N + n
                       : out + ((size_t)n * G + g) * M + col;
    if (atomic) atomicAdd(o, acc[c]);
    else *o = acc[c];
  }
}

// The wide block: lane = column (32 per block), warp w owns outputs
// n0 + (q * 8 + w) * 4 + i for q < QW, i < 4; the block walks chunks
// [ch0, ch1) of group g. The next chunk's plan bytes load asynchronously
// into a second buffer, and its activations into registers, while the
// current chunk runs.
template <bool ROWS>
__global__ void __launch_bounds__(NT)
forest_wide(const void* __restrict__ xv, int K, int M,
            const uint8_t* __restrict__ producer,
            const uint8_t* __restrict__ rows,
            const int32_t* __restrict__ signs, int T, int S, int N, int G,
            int ksplit, int cps, bool aligned, uint32_t* __restrict__ out,
            bool atomic) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int size = 1 << T;
  const int jg = K / T / G;
  const int cpg = (jg + JCW - 1) / JCW;
  const int g = blockIdx.x / ksplit;
  const int ch0 = (blockIdx.x % ksplit) * cps;
  const int ch1 = min(cpg, ch0 + cps);
  const int n0 = blockIdx.y * BNW;
  const int col0 = blockIdx.z * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pbytes = JCW * size, rbytes = JCW * S * BNW;
  const size_t tbytes = (size_t)JCW * size * 32 * 4;
  const size_t sbytes = (size_t)BNW * 33 * 4;
  uint32_t* table = (uint32_t*)smem;          // JCW * size * 32; then the
                                              // staged outputs, BNW * 33
  uint32_t* xs = (uint32_t*)(smem + (tbytes > sbytes ? tbytes : sbytes));
  uint8_t* pbuf = (uint8_t*)(xs + JCW * T * 32);         // 2 x pbytes
  uint8_t* rbuf = pbuf + 2 * pbytes;                     // 2 x rbytes
  uint8_t* order = rbuf + 2 * rbytes;                    // size
  for (int i = threadIdx.x; i < size; i += NT) order[i] = kOrder[size + i];

  auto chunk_tiles = [&](int ch, int& j0, int& nj) {
    j0 = g * jg + ch * JCW;
    nj = min(JCW, (g + 1) * jg - j0);
  };
  auto fetch_plan = [&](int ch, int b) {      // async; the caller commits
    int j0, nj;
    chunk_tiles(ch, j0, nj);
    copy_bytes(pbuf + b * pbytes, producer + (size_t)j0 * size, nj * size,
               aligned, threadIdx.x, NT);
    load_rows(rbuf + b * rbytes, BNW, rows, S, N, j0, nj, n0, BNW, aligned);
  };
  uint32_t xnext[JCW];                        // activations, i = tid + k NT
  auto fetch_x = [&](int ch) {
    int j0, nj;
    chunk_tiles(ch, j0, nj);
#pragma unroll
    for (int k = 0; k < JCW; ++k) {
      const int i = threadIdx.x + k * NT;
      xnext[k] = i < nj * T * 32 ? x_at<ROWS, 32>(xv, K, M, T, j0, col0, i)
                                 : 0;
    }
  };

  uint32_t acc[4 * QW];
#pragma unroll
  for (int i = 0; i < 4 * QW; ++i) acc[i] = 0;
  fetch_plan(ch0, 0);
  __pipeline_commit();
  fetch_x(ch0);
  for (int ch = ch0; ch < ch1; ++ch) {
    const int b = (ch - ch0) & 1;
    int j0, nj;
    chunk_tiles(ch, j0, nj);
    __syncthreads();              // the last chunk's table and buffer free
#pragma unroll
    for (int k = 0; k < JCW; ++k)
      if (threadIdx.x + k * NT < JCW * T * 32)
        xs[threadIdx.x + k * NT] = xnext[k];
    for (int i = threadIdx.x; i < JCW * 32; i += NT)
      table[(i / 32) * size * 32 + i % 32] = 0;            // node 0
    if (ch + 1 < ch1) fetch_plan(ch + 1, b ^ 1);
    __pipeline_commit();
    if (ch + 1 < ch1) fetch_x(ch + 1);
    __pipeline_wait_prior(1);                 // this chunk's plan bytes
    __syncthreads();
    const uint8_t* prod = pbuf + b * pbytes;
    const uint8_t* rs = rbuf + b * rbytes;
    int off = 1;
    for (int L = 1; L <= T; ++L) {
      const int items = kBinom[T][L] * JCW;
      // two rows per warp at once: their loads overlap, then the stores
      for (int r = warp; r < items; r += 2 * (NT / 32)) {
        const int r2 = r + NT / 32;
        const int jj = r % JCW, v = order[off + r / JCW];
        const int jj2 = r2 % JCW, v2 = r2 < items ? order[off + r2 / JCW] : 0;
        const int p = jj < nj ? prod[jj * size + v] : DIRECT + 1;
        const int p2 =
            r2 < items && jj2 < nj ? prod[jj2 * size + v2] : DIRECT + 1;
        Row<1> a, b2;
        if (p < T || p == DIRECT)
          a.make(table + jj * size * 32 + lane, 32, xs + jj * T * 32 + lane,
                 32, T, v, p);
        if (p2 < T || p2 == DIRECT)
          b2.make(table + jj2 * size * 32 + lane, 32,
                  xs + jj2 * T * 32 + lane, 32, T, v2, p2);
        if (p < T || p == DIRECT) a.store(table + (jj * size + v) * 32 + lane);
        if (p2 < T || p2 == DIRECT)
          b2.store(table + (jj2 * size + v2) * 32 + lane);
      }
      off += kBinom[T][L];
      __syncthreads();
    }
    for (int s = 0; s < S; ++s) {
      const uint32_t w = (uint32_t)signs[s];
      for (int jj = 0; jj < nj; ++jj) {
        const uint32_t* tt = table + jj * size * 32 + lane;
        const uint32_t* rw = (const uint32_t*)(rs + (jj * S + s) * BNW);
#pragma unroll
        for (int q = 0; q < QW; ++q) {
          const uint32_t word = rw[q * 8 + warp];      // 4 outputs' rows
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[q * 4 + i] += w * tt[((word >> (8 * i)) & 255) * 32];
        }
      }
    }
  }
  __syncthreads();
  uint32_t* stage = table;                      // [nl * 33 + lane]
#pragma unroll
  for (int q = 0; q < QW; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stage[((q * 8 + warp) * 4 + i) * 33 + lane] = acc[q * 4 + i];
  __syncthreads();
  for (int e = threadIdx.x; e < BNW * 32; e += NT) {
    // ROWS: consecutive threads take consecutive outputs n; else
    // consecutive columns
    const int nl = ROWS ? e % BNW : e / 32, c = ROWS ? e / BNW : e % 32;
    const int n = n0 + nl, col = col0 + c;
    if (n >= N || col >= M) continue;
    uint32_t* o = ROWS ? out + ((size_t)col * G + g) * N + n
                       : out + ((size_t)n * G + g) * M + col;
    const uint32_t v = stage[nl * 33 + c];
    if (atomic) atomicAdd(o, v);
    else *o = v;
  }
}

size_t narrow_smem(int T, int S, int bm) {
  const size_t size = (size_t)1 << T;
  return (size_t)JC * size * bm * 4 + (size_t)JC * T * bm * 4 +
         2 * (size_t)JC * size + (size_t)JC * S * (BN + 4);
}

size_t wide_smem(int T, int S) {
  const size_t size = (size_t)1 << T;
  const size_t tb = (size_t)JCW * size * 32 * 4, sb = (size_t)BNW * 33 * 4;
  return (tb > sb ? tb : sb) + (size_t)JCW * T * 32 * 4 +
         2 * ((size_t)JCW * size + (size_t)JCW * S * BNW) + size;
}

template <typename F>
int allow_smem(F kernel, size_t smem, size_t& granted) {
  if (smem <= granted) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  granted = smem;
  return 0;
}

// Whether the plan bytes can be copied in whole words (cp.async): every
// tile's producer row and every (tile, plane) rows row starts on a word.
bool words_ok(const uint8_t* producer, const uint8_t* rows, int T, int N) {
  return T >= 2 && N % 4 == 0 && ((uintptr_t)producer & 3) == 0 &&
         ((uintptr_t)rows & 3) == 0;
}

int zero_out(bool atomic, uint32_t* out, size_t n, cudaStream_t st) {
  return atomic ? (int)cudaMemsetAsync(out, 0, n * 4, st) : 0;
}

template <bool ROWS, int BM>
int launch_narrow(const void* x, int K, int M, const uint8_t* producer,
                  const uint8_t* rows, const int32_t* signs, int T, int S,
                  int N, int G, uint32_t* out, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const int cpg = (K / T / G + JC - 1) / JC;
  const size_t smem = narrow_smem(T, S, BM);
  int e = allow_smem(forest_narrow<ROWS, BM>, smem, granted);
  if (e) return e;
  if ((e = zero_out(cpg > 1, out, (size_t)N * G * M, st))) return e;
  dim3 grid(G * cpg, (N + BN - 1) / BN, (M + BM - 1) / BM);
  forest_narrow<ROWS, BM><<<grid, NT, smem, st>>>(
      x, K, M, producer, rows, signs, T, S, N, G, cpg,
      words_ok(producer, rows, T, N), out, cpg > 1);
  return (int)cudaGetLastError();
}

template <bool ROWS>
int launch_wide(const void* x, int K, int M, const uint8_t* producer,
                const uint8_t* rows, const int32_t* signs, int T, int S,
                int N, int G, uint32_t* out, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const long target_blocks = (long)SPLIT * sms;
  const int cpg = (K / T / G + JCW - 1) / JCW;
  const long base = (long)G * ((N + BNW - 1) / BNW) * ((M + 31) / 32);
  int ksplit = 1;
  if (base < target_blocks) {
    const long want = (target_blocks + base - 1) / base;
    ksplit = (int)(want < cpg ? want : cpg);
  }
  const int cps = (cpg + ksplit - 1) / ksplit;
  ksplit = (cpg + cps - 1) / cps;
  const size_t smem = wide_smem(T, S);
  int e = allow_smem(forest_wide<ROWS>, smem, granted);
  if (e) return e;
  if ((e = zero_out(ksplit > 1, out, (size_t)N * G * M, st))) return e;
  dim3 grid(G * ksplit, (N + BNW - 1) / BNW, (M + 31) / 32);
  forest_wide<ROWS><<<grid, NT, smem, st>>>(
      x, K, M, producer, rows, signs, T, S, N, G, ksplit, cps,
      words_ok(producer, rows, T, N), out, ksplit > 1);
  return (int)cudaGetLastError();
}

template <bool ROWS>
int dispatch(const void* x, int K, int M, const uint8_t* producer,
             const uint8_t* rows, const int32_t* signs, int T, int S, int N,
             int G, uint32_t* out, cudaStream_t st) {
#define FOREST_NARROW(bm)                                                  \
  return launch_narrow<ROWS, bm>(x, K, M, producer, rows, signs, T, S, N,  \
                                 G, out, st)
  if (M <= 1) FOREST_NARROW(1);
  if (M <= 2) FOREST_NARROW(2);
  if (M <= 4) FOREST_NARROW(4);
  if (M <= 8) FOREST_NARROW(8);
#undef FOREST_NARROW
  return launch_wide<ROWS>(x, K, M, producer, rows, signs, T, S, N, G, out,
                           st);
}

}  // namespace

extern "C" {

// Launches the fused forest on `stream`; returns the cudaError_t of the
// launch (0 on success). rows_layout = 0: x (K, M) int32 -> out (N, G, M);
// 1: x (M, K) int8 -> out (M, G, N). All pointers are contiguous device
// memory; producer (J, 2^T) and rows (J, S, N) uint8, signs (S,) int32,
// out int32 (written whole; zeroed here first when several blocks add
// into one output). Needs 1 <= T <= 8, 1 <= S <= 8, M, N > 0,
// (K / T) % G == 0.
int transitive_forest_launch(const void* x, int rows_layout, int K, int M,
                             const void* producer, const void* rows,
                             const void* signs, int T, int S, int N, int G,
                             void* out, void* stream) {
  if (T < 1 || T > 8 || M <= 0 || N <= 0 || K <= 0 || G <= 0 || K % T ||
      (K / T) % G || S < 1 || S > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* pp = (const uint8_t*)producer;
  const uint8_t* rp = (const uint8_t*)rows;
  const int32_t* sp = (const int32_t*)signs;
  uint32_t* op = (uint32_t*)out;
  if (rows_layout)
    return dispatch<true>(x, K, M, pp, rp, sp, T, S, N, G, op, st);
  return dispatch<false>(x, K, M, pp, rp, sp, T, S, N, G, op, st);
}

const char* transitive_forest_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
