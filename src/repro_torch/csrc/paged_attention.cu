// Live-page paged-attention decode over the serve pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _decode_kernel) in all four of its pool layouts,
// one template instance each, <QUANT, INT8_POOL, PT> with PT the pool's
// element type:
//
//   int8 pool, quantized attention   (kv_cache_bits=8, quant_attention):
//     int8 K/V with stored f32 per-position scales ks/vs; q8 . k8 scores;
//     P folded with vs, quantized per row, int32 P.V.  (the serving layout)
//   exact pool, quantized attention  (kv_cache_bits=16, quant_attention):
//     bf16 or f32 K/V; each K row is quantized per token in the pool dtype
//     here; V is requantized with one |V| max per (KV head, d) over the
//     slot's gathered extent; int32 P.V.
//   exact pool, float attention      (kv_cache_bits=16):
//     the score dot in the pool dtype, P cast to it, P.V summed in f32 and
//     cast to it.
//   int8 pool, float attention       (kv_cache_bits=8):
//     K and V dequantized with the stored scales; f32 scores and P.V.
//
// The plain version is the gather + attend_cached path of
// repro_torch/models/attention.py; each instance computes what that path
// computes, operation for operation, over the live lanes only.
//
// One block of 128 threads per (slot b, KV head): the G query heads of
// the group share the block. The quantized layouts' P scale is an absmax
// over the whole score row (attend_cached quantizes P per row), so a
// single-pass online softmax cannot match it; every layout runs in phases
// over a G x (P*ps) f32 row in shared memory (24 KiB at max_len 2048, G =
// 3):
//
//   1. scores for the live lanes l < min(step + 1, P*ps), which all lie in
//      the slot's first step/ps + 1 pages. Lanes past the step are the
//      reference's -1e30 lanes, whose softmax weight is exactly 0.
//        int8 pool + quant: s32 = q8 . k8 (dp4a), s = s32 * scale * sq * sk.
//        exact pool + quant: the K row's codes, rint(x / ks) with ks =
//          max(amax, 1e-8) / 127, every step rounded to the pool dtype as
//          the reference's bf16 quantizer rounds; then as above.
//        exact pool, float: the dot in f32, rounded to the pool dtype
//          (the reference's dot has the pool dtype), times scale.
//        int8 pool, float: q (f32) . (k8 * ks) in f32, times scale.
//   2. softmax over the row, exp(x - max) / sum, with true division.
//   3. (quantized layouts) p (times vs in the int8 pool), absmax over the
//      row, scale = max(amax, 1e-8) / 127, codes = rint(x / scale)
//      clamped to [-128, 127] (round half to even, true division: built
//      without --use_fast_math).
//   4. P.V over the live lanes: int32 with the P codes (exact pool + quant:
//      V codes rint(v / sv), sv = vmax / 127 + 1e-8 in the pool dtype, the
//      |V| max taken over the live pages' every row and, when the table
//      has dead entries, the null page 0's rows, which is what the
//      reference's gather reads there), or f32 (float layouts; the exact
//      pool casts P to the pool dtype first and the sum to it last).
//
// The sum orders of the softmax and of the float dots differ from the
// plain version's, so the output is held to a stated tolerance, not bit
// for bit (chip_smoke.py states each).
//
// Bound on the card: the kernel must read the live lanes' K and V rows
// (and their scales in the int8 pool; the exact pool with quantized
// attention also the live pages' other V rows and page 0's), q and the
// page table, and write the output; arithmetic is ~4 * G * hd operations
// per live lane, far below the card's rate, so it is bound by bytes over
// 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// The pool element type: its value as f32, an f32 rounded to it (and back
// to f32), and an f32 stored as it.
template <typename T> struct Elem;
template <> struct Elem<int8_t> {
  static __device__ __forceinline__ float f(int8_t v) { return (float)v; }
};
template <> struct Elem<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float rd(float v) { return v; }
  static __device__ __forceinline__ float st(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float rd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 st(float v) {
    return __float2bfloat16_rn(v);
  }
};

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

// The shared-memory carve-up, the same for every layout (4-byte arrays
// first, the int8 P codes last).
struct Smem {
  float* row;       // G * S: scores, then P
  int32_t* part;    // parts * G * hd: P.V partials (int32 or f32)
  float* red;       // 32: block reductions
  float* vsc;       // hd: V scale per d (exact pool + quant)
  float* vmx;       // parts * hd: |V| max partials (exact pool + quant)
  float* qf;        // G * hd: q in f32 (float layouts)
  int32_t* q4;      // G * hd / 4: q codes (quantized layouts)
  int8_t* codes;    // G * S: P codes (quantized layouts)
};

__host__ __device__ inline size_t smem_bytes(int G, int hd, int S,
                                             Smem* out, void* base) {
  const size_t parts = kThreads / hd;
  const size_t sizes[8] = {(size_t)G * S * 4, parts * G * hd * 4, 32 * 4,
                           (size_t)hd * 4,    parts * hd * 4,
                           (size_t)G * hd * 4, (size_t)G * hd,
                           (size_t)G * S};
  size_t offs[8];
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    offs[i] = off;
    off += sizes[i];
  }
  if (out) {
    char* p = (char*)base;
    *out = Smem{(float*)(p + offs[0]),   (int32_t*)(p + offs[1]),
                (float*)(p + offs[2]),   (float*)(p + offs[3]),
                (float*)(p + offs[4]),   (float*)(p + offs[5]),
                (int32_t*)(p + offs[6]), (int8_t*)(p + offs[7])};
  }
  return off;
}

// QT: q's element type (int8 codes under quantized attention, f32 in the
// int8 pool's float layout, the pool dtype in the exact pool's). OT: the
// output's (the pool dtype in the exact pool's float layout, else f32).
template <bool QUANT, bool INT8_POOL, typename PT, typename QT, typename OT>
__global__ void paged_decode(const QT* __restrict__ q,
                             const float* __restrict__ sq,
                             const PT* __restrict__ kpool,
                             const PT* __restrict__ vpool,
                             const float* __restrict__ kscale,
                             const float* __restrict__ vscale,
                             const int32_t* __restrict__ table,
                             const int32_t* __restrict__ steps, int KV,
                             int G, int hd, int ps, int P, float scale,
                             OT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int S = P * ps;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int nt = blockDim.x, tid = threadIdx.x;
  Smem sm;
  smem_bytes(G, hd, S, &sm, smem4);
  float* row = sm.row;
  const int parts = nt / hd;

  const int step = steps[b];
  const int valid = min(step + 1, S);
  const int32_t* trow = table + (long)b * P;
  const long qbase = ((long)b * KV + kvh) * G;

  if constexpr (QUANT) {
    const int32_t* qsrc = reinterpret_cast<const int32_t*>(q + qbase * hd);
    for (int i = tid; i < G * hd / 4; i += nt) sm.q4[i] = qsrc[i];
  } else {
    for (int i = tid; i < G * hd; i += nt)
      sm.qf[i] = Elem<QT>::f(q[qbase * hd + i]);
  }
  __syncthreads();

  // phase 1: scores of the live lanes
  for (int l = tid; l < valid; l += nt) {
    const int pid = trow[l / ps];
    const long pos = ((long)pid * ps + l % ps) * KV + kvh;
    if constexpr (QUANT && INT8_POOL) {
      const int4* krow = reinterpret_cast<const int4*>(kpool + pos * hd);
      const float sk = kscale[pos];
      int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};    // G <= 8
      for (int c = 0; c < hd / 16; ++c) {
        const int4 kv4 = krow[c];
        const int kw[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
        for (int g = 0; g < G; ++g)
          for (int w = 0; w < 4; ++w)
            acc[g] = __dp4a(sm.q4[(g * hd) / 4 + c * 4 + w], kw[w], acc[g]);
      }
      for (int g = 0; g < G; ++g)
        row[g * S + l] = (float)acc[g] * scale * sq[qbase + g] * sk;
    } else if constexpr (QUANT) {
      // quantize_per_token of the K row in the pool dtype
      const PT* krow = kpool + pos * hd;
      float amax = 0.f;
      for (int d = 0; d < hd; ++d)
        amax = fmaxf(amax, fabsf(Elem<PT>::f(krow[d])));
      const float sk = Elem<PT>::rd(Elem<PT>::rd(fmaxf(amax, 1e-8f)) / 127.f);
      const int8_t* q8 = reinterpret_cast<const int8_t*>(sm.q4);
      int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int d = 0; d < hd; ++d) {
        const float c = fminf(
            fmaxf(rintf(Elem<PT>::rd(Elem<PT>::f(krow[d]) / sk)), -128.f),
            127.f);
        const int kc = (int)c;
        for (int g = 0; g < G; ++g) acc[g] += (int)q8[g * hd + d] * kc;
      }
      for (int g = 0; g < G; ++g)
        row[g * S + l] = (float)acc[g] * scale * sq[qbase + g] * sk;
    } else if constexpr (INT8_POOL) {
      const int8_t* krow = reinterpret_cast<const int8_t*>(kpool) + pos * hd;
      const float sk = kscale[pos];
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < hd; ++d) {
        const float kf = (float)krow[d] * sk;
        for (int g = 0; g < G; ++g) acc[g] = fmaf(sm.qf[g * hd + d], kf, acc[g]);
      }
      for (int g = 0; g < G; ++g) row[g * S + l] = acc[g] * scale;
    } else {
      const PT* krow = kpool + pos * hd;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < hd; ++d) {
        const float kf = Elem<PT>::f(krow[d]);
        for (int g = 0; g < G; ++g) acc[g] = fmaf(sm.qf[g * hd + d], kf, acc[g]);
      }
      for (int g = 0; g < G; ++g)
        row[g * S + l] = Elem<PT>::rd(acc[g]) * scale;
    }
  }

  // exact pool + quant: the |V| max per d over the gathered extent
  const int d = tid % hd, pi = tid / hd;
  if constexpr (QUANT && !INT8_POOL) {
    const int n_live = min(step / ps + 1, P);
    if (pi < parts) {
      float m = 0.f;
      for (int r = pi; r < n_live * ps; r += parts) {
        const long pos = ((long)trow[r / ps] * ps + r % ps) * KV + kvh;
        m = fmaxf(m, fabsf(Elem<PT>::f(vpool[pos * hd + d])));
      }
      if (n_live < P)                             // dead entries: page 0
        for (int r = pi; r < ps; r += parts)
          m = fmaxf(m, fabsf(Elem<PT>::f(vpool[((long)r * KV + kvh) * hd + d])));
      sm.vmx[pi * hd + d] = m;
    }
    __syncthreads();
    for (int i = tid; i < hd; i += nt) {
      float m = sm.vmx[i];
      for (int p = 1; p < parts; ++p) m = fmaxf(m, sm.vmx[p * hd + i]);
      sm.vsc[i] = Elem<PT>::rd(Elem<PT>::rd(m / 127.f) + 1e-8f);
    }
  }
  __syncthreads();

  // phases 2 and 3 per query head: softmax (and for the quantized
  // layouts: fold V scales, quantize)
  float row_scale[8];
  for (int g = 0; g < G; ++g) {
    float* x = row + g * S;
    float m = kNegInf;
    for (int l = tid; l < valid; l += nt) m = fmaxf(m, x[l]);
    m = block_reduce(m, true, sm.red);
    float sum = 0.f;
    for (int l = tid; l < valid; l += nt) {
      const float e = expf(x[l] - m);
      x[l] = e;
      sum += e;
    }
    sum = block_reduce(sum, false, sm.red);
    if constexpr (QUANT) {
      float amax = 0.f;
      for (int l = tid; l < valid; l += nt) {
        float pv = x[l] / sum;
        if constexpr (INT8_POOL) {
          const int pid = trow[l / ps];
          const long pos = ((long)pid * ps + l % ps) * KV + kvh;
          pv = pv * vscale[pos];
        }
        x[l] = pv;
        amax = fmaxf(amax, fabsf(pv));
      }
      amax = block_reduce(amax, true, sm.red);
      const float sp = fmaxf(amax, 1e-8f) / 127.0f;
      row_scale[g] = sp;
      for (int l = tid; l < valid; l += nt) {
        const float c = fminf(fmaxf(rintf(x[l] / sp), -128.f), 127.f);
        sm.codes[g * S + l] = (int8_t)c;
      }
    } else {
      for (int l = tid; l < valid; l += nt) {
        const float p = x[l] / sum;
        if constexpr (INT8_POOL) x[l] = p;
        else x[l] = Elem<PT>::rd(p);              // P in the pool dtype
      }
    }
  }
  __syncthreads();

  // phase 4: P.V over the live lanes; thread (part, d)
  if constexpr (QUANT) {
    if (pi < parts) {
      int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int l = pi; l < valid; l += parts) {
        const int pid = trow[l / ps];
        const long pos = ((long)pid * ps + l % ps) * KV + kvh;
        int v;
        if constexpr (INT8_POOL) {
          v = vpool[pos * hd + d];
        } else {
          v = (int)fminf(fmaxf(rintf(Elem<PT>::rd(
                                   Elem<PT>::f(vpool[pos * hd + d]) /
                                   sm.vsc[d])),
                               -128.f),
                         127.f);
        }
        for (int g = 0; g < G; ++g) acc[g] += (int)sm.codes[g * S + l] * v;
      }
      for (int g = 0; g < G; ++g) sm.part[(pi * G + g) * hd + d] = acc[g];
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += nt) {
      const int g = i / hd, dd = i % hd;
      int o = 0;
      for (int p = 0; p < parts; ++p) o += sm.part[(p * G + g) * hd + dd];
      if constexpr (INT8_POOL) out[(qbase + g) * hd + dd] = (float)o * row_scale[g];
      else out[(qbase + g) * hd + dd] = (float)o * row_scale[g] * sm.vsc[dd];
    }
  } else {
    float* fpart = reinterpret_cast<float*>(sm.part);
    if (pi < parts) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int l = pi; l < valid; l += parts) {
        const int pid = trow[l / ps];
        const long pos = ((long)pid * ps + l % ps) * KV + kvh;
        float v;
        if constexpr (INT8_POOL) v = (float)vpool[pos * hd + d] * vscale[pos];
        else v = Elem<PT>::f(vpool[pos * hd + d]);
        for (int g = 0; g < G; ++g) acc[g] = fmaf(row[g * S + l], v, acc[g]);
      }
      for (int g = 0; g < G; ++g) fpart[(pi * G + g) * hd + d] = acc[g];
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += nt) {
      const int g = i / hd, dd = i % hd;
      float o = 0.f;
      for (int p = 0; p < parts; ++p) o += fpart[(p * G + g) * hd + dd];
      if constexpr (INT8_POOL) out[(qbase + g) * hd + dd] = o;
      else out[(qbase + g) * hd + dd] = Elem<PT>::st(o);
    }
  }
}

template <bool QUANT, bool INT8_POOL, typename PT, typename QT, typename OT>
int launch(const void* q, const void* sq, const void* kpool,
           const void* vpool, const void* kscale, const void* vscale,
           const void* table, const void* steps, int B, int KV, int G,
           int hd, int ps, int P, float scale, void* out,
           cudaStream_t st) {
  auto* kernel = paged_decode<QUANT, INT8_POOL, PT, QT, OT>;
  const size_t smem = smem_bytes(G, hd, P * ps, nullptr, nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KV);
  kernel<<<grid, kThreads, smem, st>>>(
      (const QT*)q, (const float*)sq, (const PT*)kpool, (const PT*)vpool,
      (const float*)kscale, (const float*)vscale, (const int32_t*)table,
      (const int32_t*)steps, KV, G, hd, ps, P, scale, (OT*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_attention_threads() { return kThreads; }

size_t paged_attention_smem(int G, int hd, int S) {
  return smem_bytes(G, hd, S, nullptr, nullptr);
}

// layout: 0 int8 pool + quantized attention, 1 exact pool + quantized
// attention, 2 exact pool + float attention, 3 int8 pool + float
// attention. pool_dtype (exact pools): 0 float32, 1 bfloat16.
//
// q (B, KV, G, hd): int8 codes with sq (B, KV, G) f32 under quantized
// attention; f32 in layout 3; the pool dtype in layout 2. k/v pools
// (n_pages, ps, KV, hd) int8 or the pool dtype; ks/vs (n_pages, ps, KV)
// f32 in the int8 pool (else unused). table (B, P) int32; steps (B,)
// int32; out (B, KV, G, hd) f32, or the pool dtype in layout 2. Needs
// hd % 16 == 0, 128 % hd == 0, G <= 8.
int paged_attention_launch(int layout, int pool_dtype, const void* q,
                           const void* sq, const void* kpool,
                           const void* vpool, const void* kscale,
                           const void* vscale, const void* table,
                           const void* steps, int B, int KV, int G, int hd,
                           int ps, int P, float scale, void* out,
                           void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > 8 || hd % 16 || 128 % hd ||
      ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
#define PA_ARGS q, sq, kpool, vpool, kscale, vscale, table, steps, B, KV, G, \
                hd, ps, P, scale, out, st
  switch (layout) {
    case 0: return launch<true, true, int8_t, int8_t, float>(PA_ARGS);
    case 3: return launch<false, true, int8_t, float, float>(PA_ARGS);
    case 1:
      if (pool_dtype == 0)
        return launch<true, false, float, int8_t, float>(PA_ARGS);
      if (pool_dtype == 1)
        return launch<true, false, bf16, int8_t, float>(PA_ARGS);
      break;
    case 2:
      if (pool_dtype == 0)
        return launch<false, false, float, float, float>(PA_ARGS);
      if (pool_dtype == 1)
        return launch<false, false, bf16, bf16, bf16>(PA_ARGS);
      break;
  }
#undef PA_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
