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
// Design: one thread block cluster of C <= 8 blocks per (slot b, KV head,
// block of at most kMaxG query heads); the GB query heads of the block
// share it. A group of G > kMaxG query heads per KV head is cut into
// ceil(G / kMaxG) blocks of heads as even as they come (G = 16: two of 8,
// G = 9: 5 and 4), each its own cluster that stages the KV head's pages
// again: more bytes read, the reduction code unchanged. Rank r of the
// cluster owns the
// slot's pages r, r + C, r + 2C, ... (pages_per_rank of them at most) and
// works on those that are live (page index <= step / page_size), so the
// live pages are read by C SMs at once and each rank's P.V loop is short.
// The quantized layouts' P scale is an absmax over the whole score row
// (attend_cached quantizes P per row), so a one-pass online softmax cannot
// match it; the row statistics are instead reduced across the cluster
// through distributed shared memory, in at most four rounds, each for all
// G heads at once. In each round a rank leaves its partials in its shared
// memory (round 4: in the shared memory of the rank that needs them), the
// cluster synchronises, and the partials are combined in rank order, so
// every rank holds the same value on every run:
//
//   0. staging: the rank's live rows of K and V for its KV head (and, in
//      the int8 pool, their f32 scales) are copied into shared memory by
//      cp.async in 16-byte units, in chunks of chunk_rows rows (one chunk
//      at every serving shape; the wrapper sizes it to shared memory).
//   1. scores of the live lanes l < min(step + 1, P*ps): under quantized
//      attention TPL threads per lane (TPL the largest power of two up to
//      32 and the row's 16-byte units; thread u takes units u, u + TPL,
//      ..., their integer partial dots added by shuffles); in the float
//      layouts
//      one thread per lane, summing in d order as the plain version does.
//      Lanes past the step are the reference's -1e30 lanes, whose softmax
//      weight is exactly 0.
//        int8 pool + quant: s32 = q8 . k8 (dp4a), s = s32 * scale * sq * sk.
//        exact pool + quant: the K row's codes, rint(x / ks) with ks =
//          max(amax, 1e-8) / 127, every step rounded to the pool dtype as
//          the reference's bf16 quantizer rounds; then as above.
//        exact pool, float: the dot in f32, rounded to the pool dtype
//          (the reference's dot has the pool dtype), times scale.
//        int8 pool, float: q (f32) . (k8 * ks) in f32, times scale.
//   a. round 1: the row max per head; in the exact pool with quantized
//      attention also the |V| max per d over the live pages' every row
//      and, when the table has dead entries, the null page 0's rows (what
//      the reference's gather reads there; the last rank folds them in).
//      V codes then use sv = vmax / 127 + 1e-8 in the pool dtype.
//   b. round 2: exp(x - max) and its sum per head.
//   c. round 3 (quantized layouts): p = e / sum (times vs in the int8
//      pool), the |p| absmax per head, scale = max(amax, 1e-8) / 127 and
//      codes = rint(p / scale) clamped to [-128, 127] (round half to even,
//      true division: built without --use_fast_math).
//   d. round 4: P.V partials over the rank's live lanes (int32 with the P
//      codes, exact in any order; f32 in the float layouts, whose exact
//      pool casts P to the pool dtype first and the sum to it last). Each
//      rank owns a share of the G x hd outputs: the others write their
//      partials for it into its shared memory before the barrier, and it
//      adds them in rank order, scales and stores them after. Nothing is
//      read across the cluster after the last barrier, so no block waits
//      for its peers to finish.
//
// Every rank reaches every barrier, with or without a live page. No
// memset, no atomics, one launch per call; a refused cluster launch
// returns its error. The f32 sums run in a fixed order (within a rank,
// then rank by rank), so two calls give bit-identical outputs; that order
// differs from the plain version's, so the output is held to a stated
// tolerance, not bit for bit (kernels/paged_attention.py::agreement).
//
// Bound on the card: the kernel must read the live lanes' K and V rows
// (and their scales in the int8 pool; the exact pool with quantized
// attention also the live pages' other V rows and page 0's), q and the
// page table, and write the output; arithmetic is ~4 * G * hd operations
// per live lane, far below the card's rate, so it is bound by bytes over
// 3.35 TB/s. At decode sizes those bytes take well under a microsecond:
// the time is latency (the table read, then the staging round trip, then
// the cluster rounds), which the split over C SMs shortens.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                // query heads per block
constexpr int kMaxHd = 256;             // head dimension, a multiple of 16
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr size_t kSmemLimit = 232448;   // 227 KiB a block may use
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

// N pool elements at p (16-byte aligned for a whole unit) as f32.
template <typename PT, int N>
__device__ __forceinline__ void load_f(const unsigned char* p, float* f) {
  constexpr int BYTES = N * (int)sizeof(PT);
  alignas(16) PT e[N];
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(e) = *reinterpret_cast<const uint2*>(p);
  } else {
    static_assert(BYTES == 4, "4, 8 or 16 bytes");
    *reinterpret_cast<uint32_t*>(e) = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = Elem<PT>::f(e[i]);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The query heads one block serves out of G per KV head: G cut into
// ceil(G / kMaxG) blocks as even as they come
// (kernels/paged_attention.py::heads_per_block mirrors it).
__host__ __device__ constexpr int heads_per_block(int G) {
  return (G + (G + kMaxG - 1) / kMaxG - 1) / ((G + kMaxG - 1) / kMaxG);
}

// Threads that share one K row's score under quantized attention: the
// largest power of two up to 32 and the row's 16-byte units.
__device__ __forceinline__ int threads_per_row(int units) {
  int t = 1;
  while (t * 2 <= units && t < 32) t *= 2;
  return t;
}

// The shared-memory carve-up (kernels/paged_attention.py::smem_bytes
// mirrors it; a card test holds the two equal). G: the block's query heads
// (heads_per_block); lanes = pages_per_rank * page_size: the rank's row
// capacity; chunk: rows staged at once.
struct Smem {
  unsigned char* kbuf;  // chunk K rows; then the P.V partials per part
  unsigned char* vbuf;  // chunk V rows
  float* ksc;           // chunk K rows' scales (int8 pool)
  float* vsa;           // every live lane's V scale (int8 pool)
  float* row;           // G * lanes: scores, exp, then P
  float* part;          // C slots of ceil(G * hd / C): the P.V sums of
                        // this rank's outputs from each rank (int32/f32)
  float* qf;            // G * hd: q in f32, or q's int8 codes
  float* stat;          // 3 * kMaxG: this rank's max, exp-sum, |P| max
  float* gst;           // 3 * kMaxG: the cluster's max, exp-sum, P scale
  float* qs;            // kMaxG: q's scales (quantized layouts)
  float* red;           // kWarps * kMaxG: block reductions
  float* vmxp;          // max(kThreads, hd): |V| max per (part, d)
  float* vmxr;          // hd: this rank's |V| max per d
  float* vsc;           // hd: the V scale per d (exact pool + quant)
  int8_t* codes;        // G * lanes: P codes (quantized layouts)
};

__host__ __device__ inline size_t smem_bytes(int G, int hd, int esz,
                                             bool int8_pool, bool quant,
                                             int lanes, int chunk,
                                             Smem* out, void* base) {
  const size_t rb = (size_t)hd * esz;
  const size_t small =
      (size_t)(7 * kMaxG + kWarps * kMaxG + (hd > kThreads ? hd : kThreads) +
               2 * hd) * 4;
  const size_t pv_parts = (size_t)16 * kThreads * G;   // see paged_decode
  const size_t kb = (size_t)chunk * rb;
  const size_t sizes[9] = {kb > pv_parts ? kb : pv_parts,
                           (size_t)chunk * rb,
                           int8_pool ? (size_t)chunk * 4 : 0,
                           int8_pool ? (size_t)lanes * 4 : 0,
                           (size_t)G * lanes * 4,
                           (size_t)(G * hd + kMaxCluster) * 4,
                           (size_t)G * hd * 4,
                           small,
                           quant ? (size_t)G * lanes : 0};
  size_t offs[9];
  size_t off = 0;
  for (int i = 0; i < 9; ++i) {
    offs[i] = off;
    off += align16(sizes[i]);
  }
  if (out) {
    char* p = (char*)base;
    float* s = (float*)(p + offs[7]);
    *out = Smem{(unsigned char*)(p + offs[0]), (unsigned char*)(p + offs[1]),
                (float*)(p + offs[2]), (float*)(p + offs[3]),
                (float*)(p + offs[4]), (float*)(p + offs[5]),
                (float*)(p + offs[6]), s, s + 3 * kMaxG, s + 6 * kMaxG,
                s + 7 * kMaxG, s + (7 + kWarps) * kMaxG,
                s + (7 + kWarps) * kMaxG + (hd > kThreads ? hd : kThreads),
                s + (7 + kWarps) * kMaxG + (hd > kThreads ? hd : kThreads) + hd,
                (int8_t*)(p + offs[8])};
  }
  return off;
}

// Reduce v[g] (g < G) over the block, max or sum, in a fixed order (the
// shuffle tree, then the warps in order); thread g < G writes dst[g].
// Every thread of the block calls it.
template <bool MAX, int NG>
__device__ __forceinline__ void block_reduce(float (&v)[NG], int G,
                                             float* red, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[g], o);
      v[g] = MAX ? fmaxf(v[g], w) : v[g] + w;
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g < G) red[warp * kMaxG + g] = v[g];
  __syncthreads();
  if ((int)threadIdx.x < G) {
    float a = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float b = red[w * kMaxG + threadIdx.x];
      a = MAX ? fmaxf(a, b) : a + b;
    }
    dst[threadIdx.x] = a;
  }
}

// Copy rows [r0, r0 + nr) of a rank's live rows (local row li: row
// li % ps of page r + (li / ps) * C of the slot's table row trow, KV head
// kvh) into shared memory: their rb bytes of pool into buf in 16-byte
// units (when buf is given) and their f32 scales into sbuf (when given).
// Not inlined: one copy of this code serves every staging site, and a
// block runs its code once, so code size is fetch time.
__device__ __noinline__ void stage_rows(const unsigned char* pool, int rb,
                                        unsigned char* buf,
                                        const float* scl, float* sbuf,
                                        const int32_t* trow, int r, int C,
                                        int ps, int KV, int kvh, int r0,
                                        int nr) {
  auto row_pos = [&](int li) -> long {
    const int page = r + (li / ps) * C;
    return ((long)__ldg(trow + page) * ps + li % ps) * KV + kvh;
  };
  if (buf) {
    const int units = rb / 16;
    for (int i = threadIdx.x; i < nr * units; i += kThreads) {
      const int li = i / units;
      copy16(buf + (size_t)i * 16,
             pool + row_pos(r0 + li) * rb + (i - li * units) * 16);
    }
  }
  if (sbuf)
    for (int i = threadIdx.x; i < nr; i += kThreads)
      copy4(sbuf + i, scl + row_pos(r0 + i));
}

// v[p] = element i of peer p's copy of the shared array a, for p < C:
// all C loads issued before any is used (one DSMEM round trip, not C).
template <typename T>
__device__ __forceinline__ void from_peers(cg::cluster_group& cluster,
                                           T* a, int i, int C,
                                           T (&v)[kMaxCluster]) {
#pragma unroll
  for (int p = 0; p < kMaxCluster; ++p)
    if (p < C) v[p] = cluster.map_shared_rank(a, p)[i];
}

// QT: q's element type (int8 codes under quantized attention, f32 in the
// int8 pool's float layout, the pool dtype in the exact pool's). OT: the
// output's (the pool dtype in the exact pool's float layout, else f32).
// NG >= GB: the query heads the registers and unrolled loops are sized
// for (GB itself up to 4, else 8). A block runs its code once, so the
// code's size is fetch time: a small group does not fetch an 8-head
// body. G: query heads per KV head; GB: per block (heads_per_block(G)).
// Grid (C * B, KV * NB) with NB = ceil(G / GB), cluster (C, 1, 1),
// kThreads threads: block x serves slot x / C as rank x % C; block y
// serves KV head y / NB and its query heads [GB * (y % NB), ...).
template <bool QUANT, bool INT8_POOL, typename PT, typename QT, typename OT,
          int NG>
__global__ void __launch_bounds__(kThreads)
paged_decode(const QT* __restrict__ q, const float* __restrict__ sq,
             const PT* __restrict__ kpool, const PT* __restrict__ vpool,
             const float* __restrict__ kscale,
             const float* __restrict__ vscale,
             const int32_t* __restrict__ table,
             const int32_t* __restrict__ steps, int KV, int G, int GB,
             int hd, int ps, int P, int C, int ppr, int chunk, float scale,
             OT* __restrict__ out) {
  constexpr int ESZ = (int)sizeof(PT);
  constexpr int E = 16 / ESZ;             // pool elements per 16-byte unit
  constexpr bool VMAX = QUANT && !INT8_POOL;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int nb = (G + GB - 1) / GB;       // blocks of heads per KV head
  const int b = blockIdx.x / C, kvh = blockIdx.y / nb, tid = threadIdx.x;
  const int g0 = (blockIdx.y % nb) * GB;  // the block's first query head
  const int Gl = min(GB, G - g0);         // and how many it serves
  const int lanes = ppr * ps;
  const int rb = hd * ESZ;                // bytes of one pool row
  Smem sm;
  smem_bytes(GB, hd, ESZ, INT8_POOL, QUANT, lanes, chunk, &sm, smem4);

  // The rank's live rows: local row li is row li % ps of page
  // r + (li / ps) * C. Lanes grow with li, so the live ones (l < valid)
  // are a prefix of nv rows; the exact pool with quantized attention
  // stages its live pages' every row (the |V| max reads them).
  const int step = steps[b];
  const int valid = min(step + 1, P * ps);
  const int last = valid > 0 ? (valid - 1) / ps : -1;   // last live page
  const int mine = r <= last ? (last - r) / C + 1 : 0;  // live pages owned
  const int n_rows = mine * ps;
  const int nv = (mine > 0 && last % C == r)
                     ? n_rows - ps + (valid - last * ps) : n_rows;
  const int ns = VMAX ? n_rows : nv;                    // rows staged
  const int n_chunks = (ns + chunk - 1) / chunk;
  const int32_t* trow = table + (long)b * P;
  const long qbase = ((long)b * KV + kvh) * G + g0;

  // Copy rows [c * chunk, ...) of the rank's live rows of pool (and their
  // scales into sbuf, when given) into buf.
  auto stage = [&](const PT* pool, unsigned char* buf, const float* scl,
                   float* sbuf, int c) {
    stage_rows(reinterpret_cast<const unsigned char*>(pool), rb, buf, scl,
               sbuf, trow, r, C, ps, KV, kvh, c * chunk,
               min(chunk, ns - c * chunk));
  };

  // 0. staging: K (and its scales) of chunk 0 in one group, V of chunk 0
  // (and every live lane's V scale) in a second; q meanwhile.
  if (n_chunks > 0)
    stage(kpool, sm.kbuf, kscale, INT8_POOL ? sm.ksc : nullptr, 0);
  copy_commit();
  if (n_chunks > 0) stage(vpool, sm.vbuf, nullptr, nullptr, 0);
  if constexpr (INT8_POOL)
    stage_rows(nullptr, rb, nullptr, vscale, sm.vsa, trow, r, C, ps, KV, kvh,
               0, nv);
  copy_commit();
  int vcur = 0;                           // the V chunk in vbuf
  if constexpr (QUANT) {
    const int32_t* qsrc = reinterpret_cast<const int32_t*>(q + qbase * hd);
    int32_t* q4 = reinterpret_cast<int32_t*>(sm.qf);
    for (int i = tid; i < Gl * hd / 4; i += kThreads) q4[i] = qsrc[i];
    if (tid < Gl) sm.qs[tid] = sq[qbase + tid];
  } else {
    for (int i = tid; i < Gl * hd; i += kThreads)
      sm.qf[i] = Elem<QT>::f(q[qbase * hd + i]);
  }
  // exact pool + quant, the last rank, when the table has dead entries:
  // page 0's rows (read there by the reference's gather) for the |V| max,
  // (part, d) pairs idx = tid and tid + kThreads (vparts parts of the rows
  // where hd < kThreads, each d once where hd > kThreads), loaded 8 rows
  // at a time while the copies fly
  const int vparts = hd < kThreads ? kThreads / hd : 1;
  const int vpairs = vparts * hd;         // <= max(kThreads, hd)
  float fold[2] = {0.f, 0.f};
  if constexpr (VMAX) {
    if (r == C - 1 && last >= 0 && last < P - 1) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int idx = tid + k * kThreads, d = idx % hd;
        if (idx >= vpairs) continue;
        for (int j0 = idx / hd; j0 < ps; j0 += 8 * vparts) {
          float f8[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = j0 + u * vparts;
            f8[u] = j < ps ? fabsf(Elem<PT>::f(
                                 vpool[((long)j * KV + kvh) * hd + d]))
                           : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) fold[k] = fmaxf(fold[k], f8[u]);
        }
      }
    }
  }
  copy_wait<1>();                         // own K copies of chunk 0
  __syncthreads();

  // 1. scores: under quantized attention TPL threads per lane, thread u
  // taking the K row's 16-byte units u, u + TPL, ...; one thread per lane
  // otherwise.
  const int units = rb / 16;
  const int tpl = QUANT ? threads_per_row(units) : 1;
  const int lpp = kThreads / tpl;         // lanes per pass
  for (int c = 0; c < n_chunks && c * chunk < nv; ++c) {
    if (c > 0) {
      __syncthreads();                    // chunk c-1's K rows are read
      stage(kpool, sm.kbuf, kscale, INT8_POOL ? sm.ksc : nullptr, c);
      copy_commit();
      copy_wait<0>();
      __syncthreads();
    }
    const int r0 = c * chunk, nr = min(chunk, nv - r0);
    for (int base = 0; base < nr; base += lpp) {
      const int i = base + tid / tpl, u = tid % tpl;
      const bool act = i < nr;
      const unsigned char* kr = sm.kbuf + (size_t)(act ? i : 0) * rb;
      if constexpr (QUANT) {
        int acc[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g] = 0;
        float sk;
        if constexpr (INT8_POOL) {
          const int32_t* q4 = reinterpret_cast<const int32_t*>(sm.qf);
          for (int w = u; w < units; w += tpl) {
            const int4 k4 = *reinterpret_cast<const int4*>(kr + w * 16);
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              if (g < Gl) {
                const int32_t* qg = q4 + (g * hd) / 4 + w * 4;
                acc[g] = __dp4a(qg[0], k4.x, acc[g]);
                acc[g] = __dp4a(qg[1], k4.y, acc[g]);
                acc[g] = __dp4a(qg[2], k4.z, acc[g]);
                acc[g] = __dp4a(qg[3], k4.w, acc[g]);
              }
            }
          }
          sk = sm.ksc[act ? i : 0];
        } else {
          // quantize_per_token of the K row in the pool dtype: the row's
          // |max| over the lane's threads, then its codes
          float amax = 0.f;
          for (int w = u; w < units; w += tpl) {
            float kf[E];
            load_f<PT, E>(kr + w * 16, kf);
#pragma unroll
            for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(kf[e]));
          }
          for (int o = tpl / 2; o > 0; o >>= 1)
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
          sk = Elem<PT>::rd(Elem<PT>::rd(fmaxf(amax, 1e-8f)) / 127.f);
          const int8_t* q8 = reinterpret_cast<const int8_t*>(sm.qf);
          for (int w = u; w < units; w += tpl) {
            float kf[E];
            load_f<PT, E>(kr + w * 16, kf);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int kc = (int)fminf(
                  fmaxf(rintf(Elem<PT>::rd(kf[e] / sk)), -128.f), 127.f);
#pragma unroll
              for (int g = 0; g < NG; ++g)
                if (g < Gl) acc[g] += (int)q8[g * hd + w * E + e] * kc;
            }
          }
        }
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < Gl)
            for (int o = tpl / 2; o > 0; o >>= 1)
              acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
        if (act && u == 0)
#pragma unroll
          for (int g = 0; g < NG; ++g)
            if (g < Gl)
              sm.row[g * lanes + r0 + i] =
                  (float)acc[g] * scale * sm.qs[g] * sk;
      } else {
        // one thread per lane, the dot in d order as the plain version's
        // (the exact pool rounds it to the pool dtype: the same order
        // keeps those roundings)
        float acc[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g] = 0.f;
        const float sk = INT8_POOL ? sm.ksc[act ? i : 0] : 1.f;
        for (int w = 0; w < rb / 16; ++w) {
          float kf[E];
          load_f<PT, E>(kr + w * 16, kf);
          if constexpr (INT8_POOL)
#pragma unroll
            for (int e = 0; e < E; ++e) kf[e] = kf[e] * sk;
#pragma unroll
          for (int g = 0; g < NG; ++g)
            if (g < Gl)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[g] = fmaf(sm.qf[g * hd + w * E + e], kf[e], acc[g]);
        }
        if (act)
#pragma unroll
          for (int g = 0; g < NG; ++g)
            if (g < Gl) {
              if constexpr (INT8_POOL)
                sm.row[g * lanes + r0 + i] = acc[g] * scale;
              else
                sm.row[g * lanes + r0 + i] = Elem<PT>::rd(acc[g]) * scale;
            }
      }
    }
  }
  copy_wait<0>();                         // V of chunk 0, the V scales
  __syncthreads();

  // exact pool + quant: this rank's |V| max per d, per (part, d) pair as
  // the page-0 fold above
  if constexpr (VMAX) {
    float m[2] = {0.f, 0.f};
    for (int c = 0; c < n_chunks; ++c) {
      if (c != vcur) {
        __syncthreads();
        stage(vpool, sm.vbuf, nullptr, nullptr, c);
        copy_commit();
        copy_wait<0>();
        __syncthreads();
        vcur = c;
      }
      const int nr = min(chunk, ns - c * chunk);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int idx = tid + k * kThreads, d = idx % hd;
        if (idx < vpairs)
          for (int i = idx / hd; i < nr; i += vparts)
            m[k] = fmaxf(m[k], fabsf(Elem<PT>::f(reinterpret_cast<const PT*>(
                                   sm.vbuf)[i * hd + d])));
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (tid + k * kThreads < vpairs)
        sm.vmxp[tid + k * kThreads] = fmaxf(m[k], fold[k]);
  }

  // a. the row max per head (and the |V| max per d)
  float v[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    v[g] = kNegInf;
    if (g < Gl)
      for (int li = tid; li < nv; li += kThreads)
        v[g] = fmaxf(v[g], sm.row[g * lanes + li]);
  }
  block_reduce<true>(v, Gl, sm.red, sm.stat);
  if constexpr (VMAX) {
    for (int d = tid; d < hd; d += kThreads) {
      float m = sm.vmxp[d];
      for (int p = 1; p < vparts; ++p) m = fmaxf(m, sm.vmxp[p * hd + d]);
      sm.vmxr[d] = m;
    }
  }
  cluster.sync();
  float pv_[kMaxCluster];
  if (tid < Gl) {
    from_peers(cluster, sm.stat, tid, C, pv_);
    float m = kNegInf;
    for (int p = 0; p < C; ++p) m = fmaxf(m, pv_[p]);
    sm.gst[tid] = m;
  }
  if constexpr (VMAX) {
    for (int d = tid; d < hd; d += kThreads) {
      from_peers(cluster, sm.vmxr, d, C, pv_);
      float m = 0.f;
      for (int p = 0; p < C; ++p) m = fmaxf(m, pv_[p]);
      sm.vsc[d] = Elem<PT>::rd(Elem<PT>::rd(m / 127.f) + 1e-8f);
    }
  }
  __syncthreads();

  // b. exp(x - max) and its sum per head
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    v[g] = 0.f;
    if (g < Gl) {
      const float m = sm.gst[g];
      for (int li = tid; li < nv; li += kThreads) {
        const float e = expf(sm.row[g * lanes + li] - m);
        sm.row[g * lanes + li] = e;
        v[g] += e;
      }
    }
  }
  block_reduce<false>(v, Gl, sm.red, sm.stat + kMaxG);
  cluster.sync();
  if (tid < Gl) {
    from_peers(cluster, sm.stat, kMaxG + tid, C, pv_);
    float s = 0.f;
    for (int p = 0; p < C; ++p) s += pv_[p];
    sm.gst[kMaxG + tid] = s;
  }
  __syncthreads();

  // c. P (and, quantized, its codes)
  if constexpr (QUANT) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      v[g] = 0.f;
      if (g < Gl) {
        const float sum = sm.gst[kMaxG + g];
        for (int li = tid; li < nv; li += kThreads) {
          float pv = sm.row[g * lanes + li] / sum;
          if constexpr (INT8_POOL) pv = pv * sm.vsa[li];
          sm.row[g * lanes + li] = pv;
          v[g] = fmaxf(v[g], fabsf(pv));
        }
      }
    }
    block_reduce<true>(v, Gl, sm.red, sm.stat + 2 * kMaxG);
    cluster.sync();
    if (tid < Gl) {
      from_peers(cluster, sm.stat, 2 * kMaxG + tid, C, pv_);
      float a = 0.f;
      for (int p = 0; p < C; ++p) a = fmaxf(a, pv_[p]);
      sm.gst[2 * kMaxG + tid] = fmaxf(a, 1e-8f) / 127.0f;
    }
    __syncthreads();
    for (int i = tid; i < Gl * nv; i += kThreads) {
      const int g = i / nv, li = i - g * nv;
      const float c = fminf(
          fmaxf(rintf(sm.row[g * lanes + li] / sm.gst[2 * kMaxG + g]),
                -128.f),
          127.f);
      sm.codes[g * lanes + li] = (int8_t)c;
    }
  } else {
    for (int i = tid; i < Gl * nv; i += kThreads) {
      const int g = i / nv, li = i - g * nv;
      const float p = sm.row[g * lanes + li] / sm.gst[kMaxG + g];
      if constexpr (INT8_POOL) sm.row[g * lanes + li] = p;
      else sm.row[g * lanes + li] = Elem<PT>::rd(p);   // P in the pool dtype
    }
  }
  __syncthreads();

  // d. P.V over the rank's live lanes: thread (part, 4 consecutive d);
  // where hd / 4 does not divide kThreads the threads past the last whole
  // part (pi == parts) sit this out.
  const int dq = hd / 4, parts = kThreads / dq;
  const int d0 = (tid % dq) * 4, pi = tid / dq;
  const bool pv_on = pi < parts;
  using Acc = typename std::conditional<QUANT, int, float>::type;
  Acc acc[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[g][k] = 0;
  float vs4[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (VMAX)
#pragma unroll
    for (int k = 0; k < 4; ++k) vs4[k] = sm.vsc[d0 + k];
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c = (vcur + ci) % n_chunks;   // the staged chunk first
    if (c * chunk >= nv) continue;
    if (c != vcur) {
      __syncthreads();
      stage(vpool, sm.vbuf, nullptr, nullptr, c);
      copy_commit();
      copy_wait<0>();
      __syncthreads();
      vcur = c;
    }
    const int r0 = c * chunk, nr = min(chunk, nv - r0);
    for (int i = pv_on ? pi : nr; i < nr; i += parts) {
      const int li = r0 + i;
      float vf[4];
      load_f<PT, 4>(sm.vbuf + (size_t)i * rb + d0 * ESZ, vf);
      if constexpr (QUANT) {
        int vc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (INT8_POOL)
            vc[k] = (int)vf[k];
          else
            vc[k] = (int)fminf(
                fmaxf(rintf(Elem<PT>::rd(vf[k] / vs4[k])), -128.f), 127.f);
        }
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < Gl) {
            const int pc = sm.codes[g * lanes + li];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[g][k] += pc * vc[k];
          }
      } else {
        if constexpr (INT8_POOL) {
          const float s = sm.vsa[li];
#pragma unroll
          for (int k = 0; k < 4; ++k) vf[k] = vf[k] * s;
        }
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (g < Gl) {
            const float p = sm.row[g * lanes + li];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[g][k] = fmaf(p, vf[k], acc[g][k]);
          }
      }
    }
  }
  // The K buffer is free (the last scores are behind several barriers):
  // it takes the partial sums per part, parts * Gl * hd values (at most
  // 16 * kThreads * GB bytes), which the block adds in part order.
  Acc* tmp = reinterpret_cast<Acc*>(sm.kbuf);
  if (pv_on)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (g < Gl)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          tmp[(pi * Gl + g) * hd + d0 + k] = acc[g][k];
  __syncthreads();
  // Each output's sum goes to the rank that owns it (rank e / share),
  // into that rank's inbox slot for this rank. After the barrier each
  // rank adds its inbox in rank order, scales and stores: no rank reads
  // another's shared memory after it, so none has to wait at the end.
  const int share = (Gl * hd + C - 1) / C;
  for (int i = tid; i < Gl * hd; i += kThreads) {
    Acc s = tmp[i];
    for (int p = 1; p < parts; ++p) s += tmp[p * Gl * hd + i];
    const int q = i / share;
    cluster.map_shared_rank(reinterpret_cast<Acc*>(sm.part), q)
        [r * share + i - q * share] = s;
  }
  cluster.sync();
  const Acc* inbox = reinterpret_cast<const Acc*>(sm.part);
  const int e0 = r * share, e_hi = min(e0 + share, Gl * hd);
  for (int e = e0 + tid; e < e_hi; e += kThreads) {
    Acc s = 0;
    for (int p = 0; p < C; ++p) s += inbox[p * share + e - e0];
    const int g = e / hd, d = e - g * hd;
    OT* dst = out + (qbase + g) * hd + d;
    if constexpr (QUANT && INT8_POOL) *dst = (float)s * sm.gst[2 * kMaxG + g];
    else if constexpr (QUANT)
      *dst = (float)s * sm.gst[2 * kMaxG + g] * sm.vsc[d];
    else if constexpr (INT8_POOL) *dst = s;
    else *dst = Elem<PT>::st(s);
  }
}

template <bool QUANT, bool INT8_POOL, typename PT, typename QT, typename OT>
int launch(const void* q, const void* sq, const void* kpool,
           const void* vpool, const void* kscale, const void* vscale,
           const void* table, const void* steps, int grid_x, int KV, int G,
           int hd, int ps, int P, float scale, int C, int ppr, int chunk,
           void* out, cudaStream_t st) {
  const int GB = heads_per_block(G), nb = (G + GB - 1) / GB;
  auto* kernel = GB == 1   ? paged_decode<QUANT, INT8_POOL, PT, QT, OT, 1>
                 : GB == 2 ? paged_decode<QUANT, INT8_POOL, PT, QT, OT, 2>
                 : GB == 3 ? paged_decode<QUANT, INT8_POOL, PT, QT, OT, 3>
                 : GB == 4 ? paged_decode<QUANT, INT8_POOL, PT, QT, OT, 4>
                           : paged_decode<QUANT, INT8_POOL, PT, QT, OT, 8>;
  const size_t smem = smem_bytes(GB, hd, (int)sizeof(PT), INT8_POOL, QUANT,
                                 ppr * ps, chunk, nullptr, nullptr);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid_x, (unsigned)(KV * nb), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const QT*)q, (const float*)sq, (const PT*)kpool,
      (const PT*)vpool, (const float*)kscale, (const float*)vscale,
      (const int32_t*)table, (const int32_t*)steps, KV, G, GB, hd, ps, P, C,
      ppr, chunk, scale, (OT*)out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

int paged_attention_threads() { return kThreads; }

// The dynamic shared memory of one block for a layout (see
// paged_attention_launch; G query heads per KV head, of which a block
// serves heads_per_block(G)), or 0 for an unknown layout / pool dtype.
size_t paged_attention_smem(int layout, int pool_dtype, int G, int hd,
                            int ps, int pages_per_rank, int chunk_rows) {
  const bool quant = layout == 0 || layout == 1;
  const bool int8_pool = layout == 0 || layout == 3;
  if (layout < 0 || layout > 3 || (!int8_pool && pool_dtype != 0 &&
                                   pool_dtype != 1))
    return 0;
  const int esz = int8_pool ? 1 : pool_dtype == 0 ? 4 : 2;
  return smem_bytes(heads_per_block(G), hd, esz, int8_pool, quant,
                    pages_per_rank * ps, chunk_rows, nullptr, nullptr);
}

// layout: 0 int8 pool + quantized attention, 1 exact pool + quantized
// attention, 2 exact pool + float attention, 3 int8 pool + float
// attention. pool_dtype (exact pools): 0 float32, 1 bfloat16.
//
// q (B, KV, G, hd): int8 codes with sq (B, KV, G) f32 under quantized
// attention; f32 in layout 3; the pool dtype in layout 2. k/v pools
// (n_pages, ps, KV, hd) int8 or the pool dtype, 16-byte aligned; ks/vs
// (n_pages, ps, KV) f32 in the int8 pool (else unused). table (B, P)
// int32; steps (B,) int32; out (B, KV, G, hd) f32, or the pool dtype in
// layout 2. Needs hd % 16 == 0, hd <= 256, G >= 1 (any; a block serves
// heads_per_block(G) of them, KV * ceil(G / that) <= 65535). cluster:
// blocks per (slot, KV head, block of heads), 1..min(8, P); grid_x =
// cluster * B (block x serves slot x / cluster); pages_per_rank * cluster
// >= P; chunk_rows in
// 1..pages_per_rank * ps (kernels/paged_attention.py::launch_plan chooses
// them).
int paged_attention_launch(int layout, int pool_dtype, const void* q,
                           const void* sq, const void* kpool,
                           const void* vpool, const void* kscale,
                           const void* vscale, const void* table,
                           const void* steps, int grid_x, int KV, int G,
                           int hd, int ps, int P, float scale, int cluster,
                           int pages_per_rank, int chunk_rows, void* out,
                           void* stream) {
  if (grid_x <= 0 || KV <= 0 || G <= 0 || hd <= 0 || hd % 16 ||
      hd > kMaxHd ||
      (long)KV * ((G + heads_per_block(G) - 1) / heads_per_block(G)) >
          65535 ||
      ps <= 0 || P <= 0 || cluster < 1 ||
      cluster > kMaxCluster || cluster > P || grid_x % cluster ||
      (long)pages_per_rank * cluster < P || chunk_rows < 1 ||
      chunk_rows > pages_per_rank * ps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
#define PA_ARGS q, sq, kpool, vpool, kscale, vscale, table, steps, grid_x, \
                KV, G, hd, ps, P, scale, cluster, pages_per_rank, chunk_rows, \
                out, st
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
