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
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn,
// no FMA), as the plain version's two torch ops are: the two agree bit
// for bit. The Pallas kernel's in-block doubling scan rounds differently
// from any sequential scan, so the reference is held within a tolerance.
//
// Bound on the card: x and a are read once and h written once, 3 * B*S*D
// elements against 2 flops each, so bytes over 3.35 TB/s bound it
// (0.1202 ms at B=4, S=2048, D=4096 in f32; 0.9616 ms at B=1, S=65,536).
// By Little's law 3.35 TB/s needs ~2-3 MB in flight, 15-20 KB per SM:
// far more than one thread per chain can hold in registers at B*D =
// 16,384 chains (B=4) or 4,096 (B=1).
//
// Design. The scan stays sequential in S: a chunked scan with a carry
// fix-up pass would round differently and lose the bit-equality. The
// parallelism comes from the chains and from prefetching deep along S.
// A block owns DT neighbouring chains of one b (DT in {32, 64, 128},
// chosen on the host so that the grid fills the card) and walks S:
//
//   rg_lru_ring (aligned instance): a ring of ns stages in shared memory,
//     each st steps x DT chains of a and of x. One producer thread keeps
//     the ring full with TMA: a 3-D tensor map over (D, S, B) with a box
//     of (DT, st, 1), so the hardware zero-fills past S and past D, and
//     no box crosses into the next b; each stage's bytes are counted on
//     an mbarrier ("full"). TMA, not cp.async, because one instruction
//     moves a whole tile with no registers, so a block can keep tens of
//     KB in flight. The consumer warps run the chains out of shared
//     memory, one lane per chain, reading batches of V = 16 steps into
//     registers one batch ahead (two register sets in turn, so no copy
//     and no shared-memory latency on the chain), and write each h over
//     its x in the tile: a global store on every step would sit on the
//     chain, and at B=1 one warp per SM runs it, so every instruction
//     of a step counts. When a stage is done, consumer thread 0 sends
//     the tile out with one TMA store (which writes nothing past S or
//     D) and frees the stage on a second mbarrier ("empty") once that
//     store has read it, checked a stage later so that it never waits. Each stage costs a fixed
//     hand-off, so kernels/rg_lru.py::launch_plan gives a block alone on
//     its SM long stages (128 steps) and blocks that share an SM ~8 KB
//     ones. TMA needs 16-byte aligned bases and rows (D * elem a
//     multiple of 16 bytes) for x, a and h.
//   rg_lru_regs (unaligned instance, any D and base): the same grid, one
//     thread per chain, U = 16 steps of a and x loaded into registers
//     while the previous 16 are computed (32 steps in flight per chain).
//     bf16 or f16 at an odd D cannot take even 4-byte copies, so this is
//     a declared second route, picked by the host from the shapes and
//     pointers alone, never a fallback.
//
// Each call is one launch: no memset, no scratch, no second pass. The
// tensor maps are encoded on the host for every call through the
// driver's cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint (so
// the library links no -lcuda), and passed as __grid_constant__ params.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int U = 16;              // rg_lru_regs: steps per register batch
constexpr int V = 16;              // rg_lru_ring: steps per register batch
constexpr int MAX_DT = 128;        // chains per block at most
constexpr int SMEM_LIMIT = 232448; // a block's shared memory on Hopper
constexpr int SMEM_SLACK = 128;    // to align the ring's base to 128 B

// Errors of this file's own, beside cudaError_t codes (rg_lru_error).
constexpr int ERR_ENTRY = -1;      // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -2;     // the driver refused the tensor map
constexpr int ERR_ALIGN = -3;      // aligned instance on unaligned data
constexpr int ERR_PLAN = -4;       // tiling out of range

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(double v) { return __double2float_rn(v); }

__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *reinterpret_cast<unsigned short*>(o) =
      __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void from_f(float v, __half* o) {
  *reinterpret_cast<unsigned short*>(o) = __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ void from_f(float v, double* o) { *o = (double)v; }

__device__ __forceinline__ float step(float h, float a, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One (c0, c1, c2) box of `map` into shared memory at dst, counted on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The box at src in shared memory into (c0, c1, c2) of `map`: the hardware
// writes only the part inside the tensor (nothing past S or past D).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Steps t .. t + V - 1 of a lane's a and x tiles (row stride DT), raw:
// each is converted to f32 only where the step uses it, so no conversion
// waits on a load the batch has just issued.
template <int DT, typename TX, typename TA>
__device__ __forceinline__ void load_batch(const TA* at, const TX* xt, int t,
                                           TA* ar, TX* xr) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    ar[u] = at[(t + u) * DT];
    xr[u] = xt[(t + u) * DT];
  }
}

// V steps from h over a batch, each h written over its x in the tile.
template <int DT, typename TX, typename TA>
__device__ __forceinline__ float run_batch(float h, const TA* ar,
                                           const TX* xr, TX* xt, int t) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    h = step(h, to_f(ar[u]), to_f(xr[u]));
    from_f(h, xt + (t + u) * DT);
  }
  return h;
}

// Block i owns chains d0 .. d0 + dt - 1 of b, with tiles_d = ceil(D / dt)
// blocks per b (kernels/rg_lru.py::LaunchPlan.chains mirrors this).
__device__ __forceinline__ void owner(int D, int dt, int* b, int* d0) {
  const int tiles_d = (D + dt - 1) / dt;
  *b = blockIdx.x / tiles_d;
  *d0 = (blockIdx.x - *b * tiles_d) * dt;
}

// The aligned instance: dt consumer threads (dt / 32 warps, one lane per
// chain) and one producer warp, of which one thread issues the TMA loads.
// Shared memory: ns stages of [a tile (st x dt TA) | x tile (st x dt TX)],
// then ns "full" and ns "empty" mbarriers. A lane overwrites its x in the
// tile with h (x's dtype: the same size), so no global store sits on the
// chain of dependent steps; when every lane is done, consumer thread 0
// sends the tile out with one TMA store, and frees the stage once that
// store has read it (it checks the previous stage's, one stage later).
template <typename TX, typename TA, int DT>
__global__ void __launch_bounds__(DT + 32)
rg_lru_ring(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_out,
            const float* __restrict__ h0, int S, int D, int st, int ns) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + (SMEM_SLACK - 1)) & ~(uint32_t)(SMEM_SLACK - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a_bytes = (uint32_t)(st * DT) * sizeof(TA);
  const uint32_t stage = a_bytes + (uint32_t)(st * DT) * sizeof(TX);
  const uint32_t full = base + (uint32_t)ns * stage;
  const uint32_t empty = full + 8u * ns;
  int b, d0;
  owner(D, DT, &b, &d0);
  const int nt = (S + st - 1) / st;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(full + 8u * i, 1);
      mbar_init(empty + 8u * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= DT) {                   // the producer warp
    if (threadIdx.x == DT) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      int s = 0, round = 0;
      for (int k = 0; k < nt; ++k) {
        if (round > 0) mbar_wait(empty + 8u * s, (round - 1) & 1);
        const uint32_t bar = full + 8u * s, dst = base + s * stage;
        mbar_expect_tx(bar, stage);
        tma_load_3d(dst, &map_a, bar, d0, k * st, b);
        tma_load_3d(dst + a_bytes, &map_x, bar, d0, k * st, b);
        if (++s == ns) { s = 0; ++round; }
      }
    }
    return;      // the consumers wait for every stage: the block lives on
  }
  const int lane = threadIdx.x;
  float h = d0 + lane < D ? h0[(size_t)b * D + d0 + lane] : 0.0f;
  int s = 0, round = 0, prev = -1;
  for (int k = 0; k < nt; ++k) {
    mbar_wait(full + 8u * s, round & 1);
    const TA* at = reinterpret_cast<const TA*>(smem + (size_t)s * stage) + lane;
    TX* xt = reinterpret_cast<TX*>(smem + (size_t)s * stage + a_bytes) + lane;
    const int n = min(st, S - k * st);
    // Batches of V steps read into registers one batch ahead, in two sets
    // of registers taken in turn, so the shared-memory latency stays off
    // the chain of dependent steps. Invariant at the loop's head: (ar, xr)
    // hold steps t .. t + V - 1 wherever t + V <= n.
    TA ar[V], an[V];
    TX xr[V], xn[V];
    int t = 0;
    if (n >= V) load_batch<DT>(at, xt, 0, ar, xr);
    for (; t + 2 * V <= n; t += 2 * V) {
      load_batch<DT>(at, xt, t + V, an, xn);
      h = run_batch<DT>(h, ar, xr, xt, t);
      if (t + 3 * V <= n) load_batch<DT>(at, xt, t + 2 * V, ar, xr);
      h = run_batch<DT>(h, an, xn, xt, t + V);
    }
    if (t + V <= n) {
      h = run_batch<DT>(h, ar, xr, xt, t);
      t += V;
    }
    for (; t < n; ++t) {
      h = step(h, to_f(at[t * DT]), to_f(xt[t * DT]));
      from_f(h, xt + t * DT);
    }
    // Every lane's h visible to the TMA store, then one thread sends it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(DT) : "memory");
    if (lane == 0) {
      tma_store_3d(&map_out, base + s * stage + a_bytes, d0, k * st, b);
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      if (prev >= 0) mbar_arrive(empty + 8u * prev);
    }
    prev = s;
    if (++s == ns) { s = 0; ++round; }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The unaligned instance: dt threads, one per chain; U steps of a and x
// in registers are loaded while the previous U are computed.
template <typename TX, typename TA>
__global__ void __launch_bounds__(MAX_DT)
rg_lru_regs(const TX* __restrict__ x, const TA* __restrict__ a,
            const float* __restrict__ h0, int S, int D, int dt,
            TX* __restrict__ out) {
  int b, d0;
  owner(D, dt, &b, &d0);
  const int d = d0 + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)b * S * D + d;
  const TA* ap = a + base;
  const TX* xp = x + base;
  TX* op = out + base;
  float h = h0[(size_t)b * D + d];
  TA ra[U], na[U];
  TX rx[U], nx[U];
  int t = 0;
  if (S >= U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ra[u] = ap[(size_t)u * D];
      rx[u] = xp[(size_t)u * D];
    }
  }
  for (; t + U <= S; t += U) {
    const bool more = t + 2 * U <= S;
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        na[u] = ap[(size_t)(t + U + u) * D];
        nx[u] = xp[(size_t)(t + U + u) * D];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = step(h, to_f(ra[u]), to_f(rx[u]));
      from_f(h, op + (size_t)(t + u) * D);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ra[u] = na[u];
        rx[u] = nx[u];
      }
    }
  }
  for (; t < S; ++t) {
    const size_t i = (size_t)t * D;
    h = step(h, to_f(ap[i]), to_f(xp[i]));
    from_f(h, op + i);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_entry() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous (B, S, D) tensor, dims innermost first,
// box (dt, st, 1); out-of-range elements read as zero.
int encode(CUtensorMap* map, const void* p, CUtensorMapDataType type,
           size_t elem, int B, int S, int D, int dt, int st) {
  EncodeTiled fn = encode_entry();
  if (fn == nullptr) return ERR_ENTRY;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elem,
                                 (cuuint64_t)S * D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)dt, (cuuint32_t)st, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = fn(map, type, 3, const_cast<void*>(p), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <typename T> struct MapType;
template <> struct MapType<float> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<__half> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};
template <> struct MapType<double> {
  static constexpr CUtensorMapDataType v = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};

bool aligned16(const void* p, int D, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (D * elem) % 16 == 0;
}

template <typename TX, typename TA, int DT>
int launch_ring(const CUtensorMap& map_a, const CUtensorMap& map_x,
                const CUtensorMap& map_out, const void* h0, int S, int D,
                int st, int ns, long blocks, size_t smem, cudaStream_t str) {
  cudaError_t c = cudaFuncSetAttribute(
      rg_lru_ring<TX, TA, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (c != cudaSuccess) return (int)c;
  rg_lru_ring<TX, TA, DT><<<(unsigned)blocks, DT + 32, smem, str>>>(
      map_a, map_x, map_out, (const float*)h0, S, D, st, ns);
  return (int)cudaGetLastError();
}

template <typename TX, typename TA>
int launch(const void* x, const void* a, const void* h0, int B, int S, int D,
           void* out, int dt, int st, int ns, int aligned, cudaStream_t str) {
  const long blocks = (long)B * ((D + dt - 1) / dt);
  if (blocks > INT_MAX) return ERR_PLAN;
  if (!aligned) {
    rg_lru_regs<TX, TA><<<(unsigned)blocks, dt, 0, str>>>(
        (const TX*)x, (const TA*)a, (const float*)h0, S, D, dt, (TX*)out);
    return (int)cudaGetLastError();
  }
  if (!aligned16(x, D, sizeof(TX)) || !aligned16(a, D, sizeof(TA)) ||
      !aligned16(out, D, sizeof(TX)))
    return ERR_ALIGN;
  if (st < 8 || st > 256 || st % 8 != 0 || ns < 2) return ERR_PLAN;
  const size_t smem = SMEM_SLACK +
                      (size_t)ns * st * dt * (sizeof(TX) + sizeof(TA)) +
                      16 * (size_t)ns;
  if (smem > (size_t)SMEM_LIMIT) return ERR_PLAN;
  CUtensorMap map_a, map_x, map_out;
  int e = encode(&map_a, a, MapType<TA>::v, sizeof(TA), B, S, D, dt, st);
  if (e == 0) e = encode(&map_x, x, MapType<TX>::v, sizeof(TX), B, S, D, dt, st);
  if (e == 0)
    e = encode(&map_out, out, MapType<TX>::v, sizeof(TX), B, S, D, dt, st);
  if (e != 0) return e;
  switch (dt) {
    case 32:
      return launch_ring<TX, TA, 32>(map_a, map_x, map_out, h0, S, D, st, ns,
                                     blocks, smem, str);
    case 64:
      return launch_ring<TX, TA, 64>(map_a, map_x, map_out, h0, S, D, st, ns,
                                     blocks, smem, str);
  }
  return launch_ring<TX, TA, 128>(map_a, map_x, map_out, h0, S, D, st, ns,
                                  blocks, smem, str);
}

template <typename TX>
int launch_a(const void* x, const void* a, int a_dtype, const void* h0,
             int B, int S, int D, void* out, int dt, int st, int ns,
             int aligned, cudaStream_t str) {
  switch (a_dtype) {
    case 0:
      return launch<TX, float>(x, a, h0, B, S, D, out, dt, st, ns, aligned,
                               str);
    case 1:
      return launch<TX, __nv_bfloat16>(x, a, h0, B, S, D, out, dt, st, ns,
                                       aligned, str);
    case 2:
      return launch<TX, __half>(x, a, h0, B, S, D, out, dt, st, ns, aligned,
                                str);
    case 3:
      return launch<TX, double>(x, a, h0, B, S, D, out, dt, st, ns, aligned,
                                str);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (B, S, D) in x's dtype. x, a, out contiguous (B, S, D); h0 (B, D)
// contiguous f32. Dtype codes for x and a: 0 float32, 1 bfloat16,
// 2 float16, 3 float64. dt chains per block (32, 64 or 128); aligned != 0
// runs rg_lru_ring with a ring of ns stages of st steps (st a multiple of
// 8 up to 256), else rg_lru_regs (st, ns unused): the host's
// kernels/rg_lru.py::launch_plan. Returns 0 on success, else a
// cudaError_t or one of this file's negative codes (rg_lru_error).
int rg_lru_launch(const void* x, int x_dtype, const void* a, int a_dtype,
                  const void* h0, int B, int S, int D, void* out, int dt,
                  int st, int ns, int aligned, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (dt != 32 && dt != 64 && dt != 128) return ERR_PLAN;
  cudaStream_t str = (cudaStream_t)stream;
  switch (x_dtype) {
    case 0:
      return launch_a<float>(x, a, a_dtype, h0, B, S, D, out, dt, st, ns,
                             aligned, str);
    case 1:
      return launch_a<__nv_bfloat16>(x, a, a_dtype, h0, B, S, D, out, dt, st,
                                     ns, aligned, str);
    case 2:
      return launch_a<__half>(x, a, a_dtype, h0, B, S, D, out, dt, st, ns,
                              aligned, str);
    case 3:
      return launch_a<double>(x, a, a_dtype, h0, B, S, D, out, dt, st, ns,
                              aligned, str);
  }
  return (int)cudaErrorInvalidValue;
}

const char* rg_lru_error(int code) {
  switch (code) {
    case ERR_ENTRY: return "the driver has no cuTensorMapEncodeTiled";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused the tensor map";
    case ERR_ALIGN:
      return "the ring instance needs 16-byte aligned bases and rows";
    case ERR_PLAN: return "tiling out of range (dt, st, ns, shared memory)";
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
