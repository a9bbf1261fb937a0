// Scoreboard forest from a dense DevicePlan of any T, hand-written for
// Hopper (sm_90a): the path for tile-local plans with T > 8, whose nodes do
// not fit the compact ForestPlan's byte (csrc/transitive_forest.cu runs
// those with T <= 8).
//
// Replaces the Pallas kernel src/repro/kernels/transitive_forest.py
// (transitive_forest_pallas, body _kernel -> core/engine.py forest_body)
// for such plans. Same function as repro_torch.core.engine.run_device:
// int32 activations x (K, M) through a compiled plan -> int32 (N*G, M),
// bit-exact.
//
// Design. compile_plan keeps every level edge, every direct target and
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
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
