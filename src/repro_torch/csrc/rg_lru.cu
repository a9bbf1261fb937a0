// Linear recurrence (RG-LRU / SSM scan), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rg_lru.py (rg_lru_pallas,
// body _kernel). Same function as repro_torch.kernels.ref.rg_lru_ref:
//
//   h_t = a_t * h_{t-1} + x_t   over x, a (B, S, D), h_{-1} = h0 (B, D)
//
// with an f32 carry; x and a are each float32, bfloat16, float16 or
// float64 (any pair), and the output h (B, S, D) takes x's dtype: every
// step is computed in f32 and rounded once to x's dtype, as the plain
// version rounds its f32 result (a float64 input is first rounded to f32,
// as the plain version's .to(float32) and the reference's astype do).
//
// Design. One thread per (b, d) walks the sequence in order, so the
// carry stays in a register and nothing crosses blocks; neighbouring
// threads own neighbouring d, so every load and store of a step is
// coalesced along D. Each thread loads U = 8 steps of a and x before it
// computes them, so 16 loads per thread are in flight. The multiply and
// the add are rounded separately (__fmul_rn, __fadd_rn, no FMA), which is
// what the plain version's two torch ops do: in f32 the two agree bit for
// bit. The Pallas kernel's in-block doubling scan rounds differently from
// any sequential scan, so the reference is held within a tolerance.
//
// Bound on the card: x and a are read once and h written once, 3 * B*S*D
// elements against 2 flops each: bound by bytes over 3.35 TB/s. With
// B*D = 16384 threads (recurrentgemma-9b's D = 4096 at B = 4) only 512
// warps, about 4 per SM, run across 132 SMs, so the loads in flight, not
// the memory rate, limit this design; splitting S into chunks with a
// carry fix-up pass is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 8;         // steps loaded ahead per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(double v) { return __double2float_rn(v); }

__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f(float v, __half* o) {
  *o = __float2half_rn(v);
}
__device__ __forceinline__ void from_f(float v, double* o) { *o = (double)v; }

template <typename TX, typename TA>
__global__ void __launch_bounds__(128)
rg_lru_seq(const TX* __restrict__ x, const TA* __restrict__ a,
           const float* __restrict__ h0, int B, int S, int D,
           TX* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * D) return;
  const long b = idx / D, d = idx % D;
  const size_t base = (size_t)b * S * D + d;
  float h = h0[idx];
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = to_f(a[base + (size_t)(t + u) * D]);
      xv[u] = to_f(x[base + (size_t)(t + u) * D]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      from_f(h, out + base + (size_t)(t + u) * D);
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + (size_t)t * D;
    h = __fadd_rn(__fmul_rn(to_f(a[i]), h), to_f(x[i]));
    from_f(h, out + i);
  }
}

template <typename TX, typename TA>
int launch(const void* x, const void* a, const void* h0, int B, int S, int D,
           void* out, cudaStream_t st) {
  const long n = (long)B * D;
  rg_lru_seq<TX, TA><<<(unsigned)((n + 127) / 128), 128, 0, st>>>(
      (const TX*)x, (const TA*)a, (const float*)h0, B, S, D, (TX*)out);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_a(const void* x, const void* a, int a_dtype, const void* h0,
             int B, int S, int D, void* out, cudaStream_t st) {
  switch (a_dtype) {
    case 0: return launch<TX, float>(x, a, h0, B, S, D, out, st);
    case 1: return launch<TX, __nv_bfloat16>(x, a, h0, B, S, D, out, st);
    case 2: return launch<TX, __half>(x, a, h0, B, S, D, out, st);
    case 3: return launch<TX, double>(x, a, h0, B, S, D, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (B, S, D) in x's dtype. x, a, out contiguous (B, S, D); h0 (B, D)
// contiguous f32. Dtype codes for x and a: 0 float32, 1 bfloat16,
// 2 float16, 3 float64. Returns the cudaError_t of the launch (0 on success).
int rg_lru_launch(const void* x, int x_dtype, const void* a, int a_dtype,
                  const void* h0, int B, int S, int D, void* out,
                  void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_dtype) {
    case 0: return launch_a<float>(x, a, a_dtype, h0, B, S, D, out, st);
    case 1:
      return launch_a<__nv_bfloat16>(x, a, a_dtype, h0, B, S, D, out, st);
    case 2: return launch_a<__half>(x, a, a_dtype, h0, B, S, D, out, st);
    case 3: return launch_a<double>(x, a, a_dtype, h0, B, S, D, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* rg_lru_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
