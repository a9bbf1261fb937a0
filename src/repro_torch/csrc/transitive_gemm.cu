// Doubling-LUT transitive GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/transitive_gemm.py
// (transitive_gemm_pallas, body _kernel). Same function as
// repro_torch.kernels.ref.transitive_matmul_ref, bit-exact:
//
//   out (M, G, N) int32 = per group gi: x[:, gi] (M, Kg) @ w[:, gi]^T
//
// with x (M, K) int8, w (N, K) int8 holding S-bit values (S = w_bits in
// 2..8), K = G * Kg and Kg divisible by T in {4, 8}. G = 1 is the plain
// GEMM.
//
// Dataflow (the paper's, with the complete Hasse graph): for each T-wide
// subtile of K, every subset sum of the T activations of a row is built
// by doubling (lut[2^b + q] = lut[q] + x[b]: one add per entry) — at
// T = 8 as two 16-entry nibble LUTs (30 adds instead of 255, the
// reference's split LUT), at T = 4 as one. Each weight TransRow gathers
// its subset sum and the S bit planes shift-accumulate with 2's-complement
// signs (plane S-1 weighs -2^(S-1)).
//
// TransRows come straight from the int8 weight: bit i of plane s's
// pattern is bit s of w[n, j*T + i] (in S-bit 2's complement the low S
// bits of the int8 are the value's bits). One 32-bit word holds four
// weights; ((word >> s) & 0x01010101) * 0x10204080 >> 28 collects bit s
// of its four bytes into a nibble with byte i at bit i (the four partial
// products land on distinct bits, so nothing carries). So the kernel
// reads one byte per weight, not the (N, S, K/T) int32 patterns the
// reference packs on every call.
//
// Design. One block of 128 threads per (128 columns n, BM rows m, group,
// K split); each thread owns one column and BM accumulators. The block
// walks its K range in chunks of CH = 8 subtiles: it builds the chunk's
// CH x (T/4) x BM nibble LUTs in shared memory (one thread per LUT,
// doubling in registers), then every thread loads its column's T weight
// bytes per subtile, extracts the S patterns and gathers from the LUTs.
// All threads of a warp read one 16-word LUT row, so the gathers are free
// of bank conflicts. Ragged M and N are masked here (the reference pads).
// At decode shapes there are few (column, row) blocks, so K is split
// across blocks and the partial sums are added with integer atomics onto
// a zeroed output: integer addition is exact in any order.
//
// Bound on the card: the weights are read once (N*K bytes), the
// activations once per column block. At decode (M <= 8) the kernel must
// move ~1 MB per linear against a few million adds, so it is bound by
// bytes over 3.35 TB/s; the split across K keeps ~100 blocks loading. At
// M = 512 the S*(T/4) gathers per (m, n, subtile) dominate and it is
// bound by operations (scalar int32 adds and shared-memory loads).
// Accumulation is unsigned, so it wraps mod 2^32 like the reference's
// int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads per block = columns per block
constexpr int CH = 8;       // subtiles per chunk

template <int T, int BM>
__global__ void __launch_bounds__(NT)
tgemm_lut(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M,
          int N, int K, int G, int S, int ksplit, int chunks_per_split,
          uint32_t* __restrict__ out) {
  constexpr int NL = T / 4;                        // nibble LUTs per subtile
  __shared__ __align__(16) int32_t lut[CH][NL][BM][16];
  const int kg = K / G;
  const int jg = kg / T;                           // subtiles per group
  const int nchunks = (jg + CH - 1) / CH;
  const int gi = blockIdx.z / ksplit;
  const int ks = blockIdx.z % ksplit;
  const int c_lo = ks * chunks_per_split;
  const int c_hi = min(c_lo + chunks_per_split, nchunks);
  const int n = blockIdx.x * NT + threadIdx.x;
  const int m0 = blockIdx.y * BM;

  uint32_t acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0u;

  for (int c = c_lo; c < c_hi; ++c) {
    __syncthreads();                               // previous chunk's reads
    for (int e = threadIdx.x; e < CH * NL * BM; e += NT) {
      const int jj = e / (NL * BM);
      const int h = (e / BM) % NL;
      const int r = e % BM;
      const int jl = c * CH + jj;
      int32_t xb[4] = {0, 0, 0, 0};
      if (m0 + r < M && jl < jg) {
        const int8_t* xp = x + (size_t)(m0 + r) * K + gi * kg + jl * T + 4 * h;
#pragma unroll
        for (int b = 0; b < 4; ++b) xb[b] = xp[b];
      }
      int32_t v[16];
      v[0] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)                  // doubling: 15 adds
#pragma unroll
        for (int q = 0; q < (1 << b); ++q) v[(1 << b) + q] = v[q] + xb[b];
      int4* dst = reinterpret_cast<int4*>(&lut[jj][h][r][0]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();
    if (n < N) {
      const int8_t* wrow = w + (size_t)n * K + gi * kg;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int jl = c * CH + jj;
        if (jl >= jg) break;
        uint32_t lo, hi = 0u;
        if (T == 8) {
          const uint2 wv = __ldg(reinterpret_cast<const uint2*>(wrow + jl * 8));
          lo = wv.x;
          hi = wv.y;
        } else {
          lo = __ldg(reinterpret_cast<const uint32_t*>(wrow + jl * 4));
        }
        for (int s = 0; s < S; ++s) {
          const uint32_t coef = (s == S - 1) ? (0u - (1u << s)) : (1u << s);
          const int plo = (((lo >> s) & 0x01010101u) * 0x10204080u) >> 28;
          const int phi = (((hi >> s) & 0x01010101u) * 0x10204080u) >> 28;
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            uint32_t g = (uint32_t)lut[jj][0][r][plo];
            if (NL == 2) g += (uint32_t)lut[jj][NL - 1][r][phi];
            acc[r] += coef * g;
          }
        }
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      uint32_t* o = out + ((size_t)m * G + gi) * N + n;
      if (ksplit == 1) *o = acc[r];
      else atomicAdd(o, acc[r]);
    }
  }
}

template <int T, int BM>
int launch(const int8_t* x, const int8_t* w, int M, int N, int K, int G,
           int S, int target_blocks, uint32_t* out, cudaStream_t st) {
  const int jg = K / G / T;
  const int nchunks = (jg + CH - 1) / CH;
  const int gx = (N + NT - 1) / NT;
  const int gy = (M + BM - 1) / BM;
  const long base = (long)gx * gy * G;
  int ksplit = 1;
  if (base < target_blocks) {
    const long want = (target_blocks + base - 1) / base;
    ksplit = (int)(want < nchunks ? want : nchunks);
  }
  const int cps = (nchunks + ksplit - 1) / ksplit;
  ksplit = (nchunks + cps - 1) / cps;
  if (ksplit > 1) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)M * G * N * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(gx, gy, G * ksplit);
  tgemm_lut<T, BM><<<grid, NT, 0, st>>>(x, w, M, N, K, G, S, ksplit, cps,
                                         out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, G, N) int32 = grouped x (M, K) int8 @ w (N, K) int8 ^T. x and w
// are contiguous device pointers, w 8-byte aligned. K % G == 0,
// (K / G) % T == 0, T in {4, 8}, S in [2, 8]. target_blocks: fewer
// (column, row, group) blocks than this split K (the card's SM count x
// 2). Returns the cudaError_t of the launch (0 on success).
int transitive_gemm_launch(const void* x, const void* w, int M, int N, int K,
                           int G, int S, int T, int target_blocks, void* out,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || K % G || (K / G) % T || S < 2 || S > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  uint32_t* op = (uint32_t*)out;
  if (T == 8)
    return M <= 4 ? launch<8, 4>(xp, wp, M, N, K, G, S, target_blocks, op, st)
                  : launch<8, 8>(xp, wp, M, N, K, G, S, target_blocks, op, st);
  if (T == 4)
    return M <= 4 ? launch<4, 4>(xp, wp, M, N, K, G, S, target_blocks, op, st)
                  : launch<4, 8>(xp, wp, M, N, K, G, S, target_blocks, op, st);
  return (int)cudaErrorInvalidValue;
}

const char* transitive_gemm_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
