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
// rows m). The block first copies its BM activation rows (BM x K bytes)
// into shared memory. Lane l of every warp owns column n = 32 * bx + l;
// warp v takes the groups g = v, v + 8, ...: per group it runs the exact
// int32 dot of its weight row against the BM rows with __dp4a (four int8
// products per instruction; the activation words are the same address for
// the whole warp, a broadcast), then adds the group term in f32. The
// eight warps' f32 partials are summed in a fixed order through shared
// memory and scaled by sx. The f32 group terms are summed in another
// order than the reference's, so the two agree within a tolerance
// (chip_smoke.py states it), not bit for bit.
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

__global__ void __launch_bounds__(WARPS * 32)
w4a8_dp4a(const int8_t* __restrict__ x, const float* __restrict__ sx,
          const int8_t* __restrict__ w, const float* __restrict__ sg, int M,
          int N, int K, int group, float* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int kw = K / 4;                          // 32-bit words per row
  int32_t* xs = smem;                            // BM x kw
  float* red = reinterpret_cast<float*>(smem + BM * kw);   // WARPS x BM x 32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * BM;

  for (int i = threadIdx.x; i < BM * kw; i += WARPS * 32) {
    const int r = i / kw;
    xs[i] = (m0 + r < M)
        ? __ldg(reinterpret_cast<const int32_t*>(x + (size_t)(m0 + r) * K) +
                (i - r * kw))
        : 0;
  }
  __syncthreads();

  float accf[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) accf[r] = 0.f;
  const int n_groups = K / group;
  const int gw = group / 4;
  if (n < N) {
    const int32_t* wrow = reinterpret_cast<const int32_t*>(w + (size_t)n * K);
    for (int g = warp; g < n_groups; g += WARPS) {
      int32_t acc[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = 0;
#pragma unroll 4
      for (int q = g * gw; q < (g + 1) * gw; ++q) {
        const int32_t wv = __ldg(wrow + q);
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = __dp4a(xs[r * kw + q], wv, acc[r]);
      }
      const float s = __ldg(sg + (size_t)n * n_groups + g);
#pragma unroll
      for (int r = 0; r < BM; ++r) accf[r] += (float)acc[r] * s;
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

// Shared memory one block needs at reduction length K.
size_t w4a8_gemm_smem(int K) {
  return (size_t)BM * K + (size_t)WARPS * BM * 32 * sizeof(float);
}

// out (M, N) f32. x, w contiguous int8 device pointers, 4-byte aligned;
// sx (M,) and sg (N, K / group) contiguous f32. group % 4 == 0 and
// K % group == 0. Returns the cudaError_t of the launch (0 on success).
int w4a8_gemm_launch(const void* x, const void* sx, const void* w,
                     const void* sg, int M, int N, int K, int group,
                     void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || group % 4 || K % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = w4a8_gemm_smem(K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w4a8_dp4a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
  w4a8_dp4a<<<grid, WARPS * 32, smem, st>>>(
      (const int8_t*)x, (const float*)sx, (const int8_t*)w, (const float*)sg,
      M, N, K, group, (float*)out);
  return (int)cudaGetLastError();
}

const char* w4a8_gemm_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
