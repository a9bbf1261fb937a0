// Live-page paged-attention decode over the int8 KV pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _decode_kernel) in its serving layout: int8 pool
// with stored f32 per-position scales, dynamic int8 attention. The plain
// version is the gather + attend_cached path of
// repro_torch/models/attention.py.
//
// One block per (slot b, KV head): the G query heads of the group share
// the block. The P quantization scale is an absmax over the whole score
// row (attend_cached quantizes p * vs per row), so a single-pass online
// softmax cannot match it; the kernel runs in phases over a G x (P*ps)
// f32 row in shared memory (24 KiB at max_len 2048, G = 3):
//
//   1. scores for the live lanes l < min(step + 1, P*ps), which all lie in
//      the slot's first step/ps + 1 pages: s32 = q8 . k8 (dp4a), then
//      s = s32 * scale * sq * sk in that order; lanes past the step are the
//      reference's -1e30 lanes, whose softmax weight is exactly 0.
//   2. softmax over the row, exp(x - max) / sum, with true division.
//   3. p * vs (the stored V scales), absmax over the row, scale =
//      max(amax, 1e-8) / 127, codes = rint(x / scale) clamped to
//      [-128, 127] (round half to even, true division: built without
//      --use_fast_math).
//   4. int32 P.V over the live lanes, times the row scale.
//
// The sum orders of the softmax differ from the plain version's, so the
// output is held to a stated tolerance, not bit for bit.
//
// Bound on the card: the kernel must read the live pages' K and V rows
// (2 * live * hd int8 + 2 * live f32 scales per slot and KV head), q and
// the page table, and write the output; arithmetic is ~4 * G * hd int8
// operations per live lane, far below the card's rate, so it is bound by
// bytes over 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ float block_reduce(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();                       // red is reused across calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < nwarps; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

__global__ void paged_decode(const int8_t* __restrict__ qq,
                             const float* __restrict__ sq,
                             const int8_t* __restrict__ kpool,
                             const int8_t* __restrict__ vpool,
                             const float* __restrict__ kscale,
                             const float* __restrict__ vscale,
                             const int32_t* __restrict__ table,
                             const int32_t* __restrict__ steps, int KV,
                             int G, int hd, int ps, int P, float scale,
                             float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int S = P * ps;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int nt = blockDim.x, tid = threadIdx.x;
  float* row = reinterpret_cast<float*>(smem4);            // G * S
  int32_t* part = reinterpret_cast<int32_t*>(row + G * S); // parts*G*hd
  const int parts = nt / hd;
  float* red = reinterpret_cast<float*>(part + parts * G * hd);  // 32
  int32_t* q4 = reinterpret_cast<int32_t*>(red + 32);      // G * hd / 4
  int8_t* codes = reinterpret_cast<int8_t*>(q4 + G * hd / 4);   // G * S

  const int step = steps[b];
  const int valid = min(step + 1, S);
  const int32_t* trow = table + (long)b * P;
  const long qbase = ((long)b * KV + kvh) * G;

  const int32_t* qsrc = reinterpret_cast<const int32_t*>(qq + qbase * hd);
  for (int i = tid; i < G * hd / 4; i += nt) q4[i] = qsrc[i];
  __syncthreads();

  // phase 1: scores of the live lanes
  for (int l = tid; l < valid; l += nt) {
    const int pid = trow[l / ps];
    const long pos = ((long)pid * ps + l % ps) * KV + kvh;
    const int4* krow = reinterpret_cast<const int4*>(kpool + pos * hd);
    const float sk = kscale[pos];
    int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};      // G <= 8
    for (int c = 0; c < hd / 16; ++c) {
      const int4 kv4 = krow[c];
      const int kw[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
      for (int g = 0; g < G; ++g)
        for (int w = 0; w < 4; ++w)
          acc[g] = __dp4a(q4[(g * hd) / 4 + c * 4 + w], kw[w], acc[g]);
    }
    for (int g = 0; g < G; ++g)
      row[g * S + l] = (float)acc[g] * scale * sq[qbase + g] * sk;
  }
  __syncthreads();

  // phases 2 and 3 per query head: softmax, fold V scales, quantize
  float row_scale[8];
  for (int g = 0; g < G; ++g) {
    float* x = row + g * S;
    float m = kNegInf;
    for (int l = tid; l < valid; l += nt) m = fmaxf(m, x[l]);
    m = block_reduce(m, true, red);
    float sum = 0.f;
    for (int l = tid; l < valid; l += nt) {
      const float e = expf(x[l] - m);
      x[l] = e;
      sum += e;
    }
    sum = block_reduce(sum, false, red);
    float amax = 0.f;
    for (int l = tid; l < valid; l += nt) {
      const int pid = trow[l / ps];
      const long pos = ((long)pid * ps + l % ps) * KV + kvh;
      const float pv = (x[l] / sum) * vscale[pos];
      x[l] = pv;
      amax = fmaxf(amax, fabsf(pv));
    }
    amax = block_reduce(amax, true, red);
    const float sp = fmaxf(amax, 1e-8f) / 127.0f;
    row_scale[g] = sp;
    for (int l = tid; l < valid; l += nt) {
      const float c = fminf(fmaxf(rintf(x[l] / sp), -128.f), 127.f);
      codes[g * S + l] = (int8_t)c;
    }
  }
  __syncthreads();

  // phase 4: int32 P.V over the live lanes; thread (part, d)
  const int d = tid % hd, pi = tid / hd;
  if (pi < parts) {
    int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int l = pi; l < valid; l += parts) {
      const int pid = trow[l / ps];
      const long pos = ((long)pid * ps + l % ps) * KV + kvh;
      const int v = vpool[pos * hd + d];
      for (int g = 0; g < G; ++g) acc[g] += (int)codes[g * S + l] * v;
    }
    for (int g = 0; g < G; ++g) part[(pi * G + g) * hd + d] = acc[g];
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += nt) {
    const int g = i / hd, dd = i % hd;
    int o = 0;
    for (int p = 0; p < parts; ++p) o += part[(p * G + g) * hd + dd];
    out[(qbase + g) * hd + dd] = (float)o * row_scale[g];
  }
}

}  // namespace

extern "C" {

int paged_attention_threads() { return kThreads; }

size_t paged_attention_smem(int G, int hd, int S) {
  const int parts = kThreads / hd;
  return (size_t)G * S * sizeof(float) +
         (size_t)parts * G * hd * sizeof(int32_t) + 32 * sizeof(float) +
         (size_t)G * hd + (size_t)G * S;
}

// qq (B, KV, G, hd) int8; sq (B, KV, G) f32; k/v pools (n_pages, ps, KV,
// hd) int8; ks/vs (n_pages, ps, KV) f32; table (B, P) int32; steps (B,)
// int32; out (B, KV, G, hd) f32. Needs hd % 16 == 0, 128 % hd == 0, G <= 8.
int paged_attention_launch(const void* qq, const void* sq, const void* kpool,
                           const void* vpool, const void* kscale,
                           const void* vscale, const void* table,
                           const void* steps, int B, int KV, int G, int hd,
                           int ps, int P, float scale, void* out,
                           void* stream) {
  const size_t smem = paged_attention_smem(G, hd, P * ps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KV);
  paged_decode<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)qq, (const float*)sq, (const int8_t*)kpool,
      (const int8_t*)vpool, (const float*)kscale, (const float*)vscale,
      (const int32_t*)table, (const int32_t*)steps, KV, G, hd, ps, P, scale,
      (float*)out);
  return (int)cudaGetLastError();
}

const char* paged_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
