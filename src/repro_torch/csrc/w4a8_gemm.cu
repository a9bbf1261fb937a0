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
// Design. One block of 256 threads (8 warps) per (32 columns n, BM = 8
// rows m). The block walks K in activation tiles of at most KT = 4096
// bytes per row: it copies its BM rows' tile (BM x min(K, KT) bytes, at
// most 32 KiB) into shared memory, so any K fits. Lane l of every warp owns column
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
// a tolerance (chip_smoke.py states it), not bit for bit.
//
// Bound on the card: the weights (N*K bytes) and activations (M*K bytes)
// are read once; 2*M*N*K int8 operations against the 1,979 TOP/s int8
// rate. At decode (M = 4) that is bytes over 3.35 TB/s. This kernel runs
// the dots on the scalar pipes (dp4a), not the int8 tensor cores, and
// re-reads the weights once per block of 8 rows, so at M = 512 it is far
// from the int8 bound; wgmma tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

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

const char* w4a8_gemm_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
