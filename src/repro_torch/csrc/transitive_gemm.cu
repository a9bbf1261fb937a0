// Doubling-LUT transitive GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/transitive_gemm.py
// (transitive_gemm_pallas, body _kernel). Same function as
// repro_torch.kernels.ref.transitive_matmul_grouped_ref, bit-exact:
//
//   out (M, G, N) int32 = per group gi: x[:, gi] (M, Kg) @ w[:, gi]^T
//
// with x (M, K) int8, w (N, K) int8 holding S-bit values (S = w_bits in
// 2..8) and K = G * Kg. G = 1 is the plain GEMM.
//
// Subtile width. The reference blocks K in T-wide subtiles (any T with
// Kg % T == 0) and builds a 2^T-entry LUT per subtile; T does not change
// the result (int32, wrapping mod 2^32), only how K is blocked. So every
// T runs here at a width W of the kernel's own, from K and G alone: W = 8
// where Kg % 8 == 0, else W = 4 where Kg % 4 == 0 (the aligned instances:
// every row and group starts on a W-byte boundary, and the bytes arrive
// by cp.async), else W = 4 in the unaligned instance (UNALIGNED): the
// bytes are staged by plain loads and each group's last subtile is
// zero-filled past Kg. A zero activation adds nothing to a subset sum
// (whatever the weight bits there), so the result stays exact.
//
// Dataflow (the paper's, with the complete Hasse graph): for each W-wide
// subtile of K, every subset sum of the W activations of a row is built
// by doubling (lut[2^b + q] = lut[q] + x[b]: one add per entry) — at
// W = 8 as two 16-entry nibble LUTs (the reference's split LUT), at W = 4
// as one. Each weight TransRow gathers its subset sum and the S bit
// planes shift-accumulate.
//
// TransRows come straight from the int8 weight: bit i of plane s's
// pattern is bit s of w[n, j*W + i] (in S-bit 2's complement the low S
// bits of the int8 are the value's bits). One 32-bit word holds four
// weights; ((word >> s) & 0x01010101) * 0x10204080 >> 28 collects bit s
// of its four bytes into a nibble with byte i at bit i (the four partial
// products land on distinct bits, so nothing carries).
//
// Signs. Plane S-1 weighs -2^(S-1). With its bit flipped (w + 2^(S-1),
// offset binary) every plane weighs +2^s and
//   x . w = sum_s 2^s L[pattern'_s] - 2^(S-1) * sum(x),
// so the gathers only ever add, and the row sum of x is subtracted once
// per block in int32 (the LUT builders sum their activations as they
// load them).
//
// Two rows per LUT word. A nibble-LUT entry is a sum of four int8 values,
// in [-512, 508]; biased by BIAS = 512 it is in [0, 1020] and fits a
// 16-bit half. One 32-bit shared-memory word holds rows 2p and 2p+1:
// (L_r0[q] + 512) | (L_r1[q] + 512) << 16. The build is doubling on the
// packed words (15 adds per nibble make both rows: a packed add of
// x_r0 + x_r1 * 2^16 is exact mod 2^32 because every entry's halves stay
// in range). One ld.shared.b32 then serves two rows, so a gather moves
// 2 bytes per row instead of 4.
//
// The overflow budget. The gathers of one subtile and plane add NL = W/4
// entries: at most GMAX = NL * 1020 per half (a zero-filled byte only
// lowers an entry). Planes are added into a
// packed accumulator as g << (s - s0), so after F subtiles a half holds at
// most F * GMAX * (2^(planes) - 1); it must stay below 2^16, or it
// carries into the other row. The low segment takes planes 0..PA-1, PA
// the most planes that fit one subtile (W = 8: 2040 * 31 = 63,240 <
// 65,536, 2040 * 63 does not, so PA = 5; W = 4: 1020 * 63 = 64,260, PA =
// 6); the high segment (w_bits > PA) takes the rest, weighted from 2^PA.
// Each segment is flushed into int32 accumulators every F subtiles, F the
// largest power of two (dividing the chunk of CH) within the budget:
// W = 8: S = 2..5 -> F = 8, 4, 2, 1; high segment at S = 6, 7, 8 -> 8, 8,
// 4. Schedule<W, S> computes this and static_asserts the bound; the CPU
// test tests/test_torch_ops.py emulates the same schedule on int64 and
// checks that no half ever leaves [0, 2^16).
//
// Design. One block per (128 columns n, BM rows m, group, K split), BM =
// 4, 8 or 16 (2, 4 or 8 row pairs). Each column has KT threads, each
// with BM int32 accumulators: KT = 4 at M <= 8, each taking a quarter of
// every chunk's subtiles, so a decode block runs 16 warps and its
// dependent gather chain is a quarter as long; KT = 1 at M > 8, where
// enough blocks are resident. The block walks its K range in chunks of
// CH = 8 subtiles, in a three-stage pipeline with one barrier per chunk:
// chunk c+2's bytes arrive by cp.async into a ring of ST = 3 chunk slots
// in shared memory and chunk c+1's packed LUTs are built (CH x NL x BM/2
// builder threads, one nibble LUT each, into one of two LUT buffers)
// while chunk c is gathered. The unaligned instance loads chunk c+2's
// bytes into registers before chunk c's gathers and stores them into the
// same ring slot after them. The weight copies are coalesced (8
// consecutive threads copy one column's 64 bytes of a chunk) and a
// column's 16-byte units are stored swizzled, so the 8 columns a quarter
// warp reads back land on 8 distinct bank groups. A gathering warp reads
// inside one 16-word LUT row, so the gathers are free of bank conflicts.
// After the loop the ring holds the KT partial sums, which the block adds
// with its corrections. Ragged M and N are masked here (the reference
// pads).
//
// K split. Where the output tiles are too few to fill the card (every
// decode shape), the wrapper asks for ksplit <= 8 blocks per output tile
// along K. They are launched as one thread block cluster (1, 1, ksplit):
// each block leaves its corrected int32 partial sums in its own shared
// memory, the cluster synchronises, and each rank reads its share of the
// tile from every rank through distributed shared memory, adds and
// stores it with plain stores (the loads of all ranks in flight at once);
// a second cluster barrier keeps every block resident until all have
// read. No memset, no atomics, one launch per call. A refused cluster
// launch returns its error; nothing falls back. The portable cluster
// size of 8 caps the split, so a decode block walks 2 (K = 576) or 3
// (K = 1536) chunks.
//
// Bound on the card: the weights are read once (N*K bytes), the
// activations once per column block. At decode (M <= 8) the kernel moves
// ~1 MB per linear against a few million adds: bound by latency (launch,
// one device-memory round trip, the chunk chain, two cluster barriers).
// At M = 512 the S*(W/4) gathers per (row pair, n, subtile) dominate:
// bound by the shared-memory pipe (one 128-byte wavefront per SM per
// clock), which this layout halves. Accumulation is unsigned and wraps
// mod 2^32 like the reference's int32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;           // threads per block = columns per block
constexpr int CH = 8;             // subtiles per chunk
constexpr int MAX_SPLIT = 8;      // blocks per cluster (portable maximum)
constexpr uint32_t BIAS = 512;    // -min of a nibble-LUT entry
constexpr uint32_t ENTRY_MAX = 1020;  // max of a biased entry (508 + 512)
constexpr uint32_t HALF_LIMIT = 1u << 16;

__host__ __device__ constexpr uint32_t planes_max(int planes) {
  return (1u << planes) - 1u;
}

// Largest power of two f <= CH with f * per_subtile < 2^16.
__host__ __device__ constexpr int flush_every(uint32_t per_subtile) {
  int f = 1;
  while (2 * f <= CH && (uint32_t)(2 * f) * per_subtile < HALF_LIMIT) f *= 2;
  return f;
}

template <int W, int S>
struct Schedule {
  static constexpr uint32_t GMAX = (W / 4) * ENTRY_MAX;  // one plane's gather
  static constexpr int PA = GMAX * planes_max(6) < HALF_LIMIT ? 6 : 5;
  static constexpr int SA = S < PA ? S : PA;       // planes in the low segment
  static constexpr int SB = S - SA;                // planes in the high one
  static constexpr int FA = flush_every(GMAX * planes_max(SA));
  static constexpr int FB = SB > 0 ? flush_every(GMAX * planes_max(SB)) : CH;
  static_assert(FA * GMAX * planes_max(SA) < HALF_LIMIT, "low half overflows");
  static_assert(FB * GMAX * planes_max(SB) < HALF_LIMIT, "high half overflows");
  static_assert(CH % FA == 0 && CH % FB == 0, "flushes must align to chunks");
};

__device__ __forceinline__ uint32_t pattern(uint32_t word, int s) {
  return (((word >> s) & 0x01010101u) * 0x10204080u) >> 28;
}

// cp.async of BYTES (4 or 8) into shared memory; src_bytes 0 zero-fills.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

// The first n (<= 4; none if n <= 0) bytes at p, little-endian, zero past
// them: the unaligned instance's staging load.
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p, int n) {
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < n) v |= (uint32_t)(uint8_t)p[b] << (8 * b);
  return v;
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Threads per column (KT): 4 at M <= 8, each taking CH / 4 consecutive
// subtiles of every chunk; 1 at M > 8.
template <int BM>
__host__ __device__ constexpr int threads_per_column() {
  return BM <= 8 ? 4 : 1;
}

template <int W, int BM, int S, bool UNALIGNED>
__global__ void __launch_bounds__(NT * threads_per_column<BM>())
tgemm_lut(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M,
          int N, int K, int G, int ksplit, int chunks_per_split,
          uint32_t* __restrict__ out) {
  static_assert(!UNALIGNED || W == 4, "the unaligned instance is W = 4");
  using Sch = Schedule<W, S>;
  constexpr int KT = threads_per_column<BM>();
  constexpr int NL = W / 4;                        // nibble LUTs per subtile
  constexpr int P = BM / 2;                        // row pairs
  constexpr int NTASK = CH * NL * P;               // LUTs built per chunk
  constexpr int ST = 3;                            // ring slots (chunks)
  constexpr int U = CH / KT;                       // a thread's subtiles/chunk
  constexpr int WW = U * W / 4;                    // its weight words/chunk
  constexpr int FA = Sch::FA < U ? Sch::FA : U;    // flushes, in own subtiles
  constexpr int FB = Sch::FB < U ? Sch::FB : U;
  constexpr int CB = CH * W;                       // a column's bytes/chunk
  constexpr int NU = CB / 16;                      // its 16-byte units
  constexpr int TILE = BM * NT;
  constexpr int RING = ST * NT * CB;
  constexpr int PART = KT * TILE * 4;
  constexpr int NW = (NTASK + 31) / 32;            // warps with builders
  static_assert(NTASK <= NT * KT && CH % KT == 0 && WW >= 1, "tiling");
  __shared__ __align__(16) uint32_t lut[2][CH][NL][P][16];
  // The weight ring during the K loop; the partial sums after it.
  __shared__ __align__(16) unsigned char ring[RING > PART ? RING : PART];
  auto& part = *reinterpret_cast<uint32_t(*)[KT][TILE]>(ring);
  __shared__ __align__(16) uint2 xsm[ST][NTASK];   // a builder's two rows
  __shared__ int32_t xsum[NW][BM];                 // row sums of x per warp

  const int kg = K / G;
  const int jg = UNALIGNED ? (kg + W - 1) / W : kg / W;  // subtiles/group
  const int nchunks = (jg + CH - 1) / CH;
  const int gi = blockIdx.z / ksplit;
  const int ks = blockIdx.z % ksplit;
  const int c_lo = ks * chunks_per_split;
  const int c_hi = min(c_lo + chunks_per_split, nchunks);
  const int tc = threadIdx.x % NT;                 // column in the block
  const int kq = threadIdx.x / NT;                 // subtiles kq*U .. +U-1
  const int n = blockIdx.x * NT + tc;
  const int m0 = blockIdx.y * BM;
  const bool col = n < N;

  // This thread's LUT task (if any): chunk slot tj, nibble th, pair tp.
  const int task = threadIdx.x;
  const bool builder = task < NTASK;
  const int tp = task % P;
  const int th = (task / P) % NL;
  const int tj = task / (P * NL);
  const int r0 = m0 + 2 * tp;
  const int8_t* xr0 = x + (size_t)min(r0, M - 1) * K + gi * kg + 4 * th;
  const int8_t* xr1 = x + (size_t)min(r0 + 1, M - 1) * K + gi * kg + 4 * th;
  const int8_t* wg = w + gi * kg;
  const uint32_t flip = 0x01010101u << (S - 1);    // top plane, offset binary

  // A column's CB bytes of a chunk sit in one ring slot as NU 16-byte
  // units, unit v at position v ^ swz(column): the 8 columns a quarter
  // warp reads land on 8 distinct bank groups.
  auto unit_at = [](int column, int v) {
    return v ^ ((column / (8 / NU)) % NU);
  };
  // Copy chunk c into ring slot (c - c_lo) % ST. Weights: W bytes per
  // copy, consecutive threads on consecutive subtiles of one column, so a
  // warp reads whole 64-byte runs of the weight rows. Builders: their two
  // rows' 4 bytes, zero-filled where masked. One commit group per chunk,
  // empty past the block's range, so the wait counts stay fixed.
  auto issue = [&](int c) {
    if (c < c_hi) {
      unsigned char* slot = ring + ((c - c_lo) % ST) * NT * CB;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = threadIdx.x + u * NT * KT;   // < NT * CH
        const int cc = i / CH, jj = i % CH;
        const int nn = blockIdx.x * NT + cc;
        const int jl = c * CH + jj;
        const int byte = jj * W;
        if (nn < N && jl < jg)
          copy_async<W>(slot + cc * CB + unit_at(cc, byte / 16) * 16 +
                            byte % 16,
                        wg + (size_t)nn * K + jl * W, W);
      }
      if (builder) {
        const int jl = c * CH + tj;
        const bool ok = jl < jg;
        const int slot_x = (c - c_lo) % ST;
        copy_async<4>(&xsm[slot_x][task].x, ok ? xr0 + jl * W : x,
                      ok && r0 < M ? 4 : 0);
        copy_async<4>(&xsm[slot_x][task].y, ok ? xr1 + jl * W : x,
                      ok && r0 + 1 < M ? 4 : 0);
      }
    }
    copy_commit();
  };
  // The unaligned instance: fetch loads chunk c's bytes (the same ones, by
  // the same threads) into registers, zero past the group's Kg and past M;
  // stage stores them into the chunk's ring slot.
  uint32_t wst[U], xst[2];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT * KT;
      const int nn = blockIdx.x * NT + i / CH;
      const int k0 = (c * CH + i % CH) * W;
      wst[u] = c < c_hi && nn < N
                   ? load_bytes(wg + (size_t)nn * K + k0, kg - k0) : 0u;
    }
    if (builder) {
      const int k0 = (c * CH + tj) * W + 4 * th;
      xst[0] = c < c_hi && r0 < M ? load_bytes(xr0 + k0 - 4 * th, kg - k0)
                                  : 0u;
      xst[1] = c < c_hi && r0 + 1 < M
                   ? load_bytes(xr1 + k0 - 4 * th, kg - k0) : 0u;
    }
  };
  auto stage = [&](int c) {
    if (c >= c_hi) return;
    unsigned char* slot = ring + ((c - c_lo) % ST) * NT * CB;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT * KT;
      const int cc = i / CH, byte = (i % CH) * W;
      *reinterpret_cast<uint32_t*>(slot + cc * CB +
                                   unit_at(cc, byte / 16) * 16 + byte % 16) =
          wst[u];
    }
    if (builder) xsm[(c - c_lo) % ST][task] = make_uint2(xst[0], xst[1]);
  };
  // Build chunk c's packed nibble LUTs (builders only): doubling, 15 adds.
  int32_t xs0 = 0, xs1 = 0;
  auto build_luts = [&](int c) {
    if (!builder || c >= c_hi) return;
    const uint2 xw = xsm[(c - c_lo) % ST][task];
    uint32_t v[16];
    v[0] = BIAS | (BIAS << 16);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int32_t a0 = (int8_t)(xw.x >> (8 * b));
      const int32_t a1 = (int8_t)(xw.y >> (8 * b));
      xs0 += a0;
      xs1 += a1;
      const uint32_t d = (uint32_t)a0 + ((uint32_t)a1 << 16);
#pragma unroll
      for (int q = 0; q < (1 << b); ++q) v[(1 << b) + q] = v[q] + d;
    }
    uint4* dst = reinterpret_cast<uint4*>(&lut[(c - c_lo) & 1][tj][th][tp][0]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  };

  uint32_t acc[BM];
  uint32_t pa[P], pb[P];                           // packed segment sums
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0u;
#pragma unroll
  for (int p = 0; p < P; ++p) pa[p] = pb[p] = 0u;

  // Pipeline: chunk c+2's bytes are in flight and chunk c+1's LUTs are
  // built while chunk c is gathered; one barrier per chunk. After the
  // barrier closing chunk c, nobody reads chunk c's ring slot or LUT
  // buffer again, and chunk c+1's weights and LUTs are visible to all.
  if constexpr (UNALIGNED) {
    fetch(c_lo);
    stage(c_lo);
    fetch(c_lo + 1);
    stage(c_lo + 1);
  } else {
    issue(c_lo);
    issue(c_lo + 1);
    copy_wait<1>();                                // own copies of c_lo
  }
  build_luts(c_lo);
  __syncthreads();
  for (int c = c_lo; c < c_hi; ++c) {
    if constexpr (UNALIGNED) {
      fetch(c + 2);                                // lands during the gathers
    } else {
      issue(c + 2);                                // into chunk c-1's slot
      copy_wait<1>();                              // own copies of c+1
    }
    build_luts(c + 1);
    const int buf = (c - c_lo) & 1;
    if (col) {
      const unsigned char* mine = ring + ((c - c_lo) % ST) * NT * CB + tc * CB;
      uint32_t wv[WW];
      if constexpr (WW >= 4) {
#pragma unroll
        for (int v = 0; v < WW / 4; ++v) {
          const uint4 q = *reinterpret_cast<const uint4*>(
              mine + unit_at(tc, kq * (WW / 4) + v) * 16);
          wv[4 * v] = q.x;
          wv[4 * v + 1] = q.y;
          wv[4 * v + 2] = q.z;
          wv[4 * v + 3] = q.w;
        }
      } else if constexpr (WW == 2) {
        const int byte = kq * 8;
        const uint2 q = *reinterpret_cast<const uint2*>(
            mine + unit_at(tc, byte / 16) * 16 + byte % 16);
        wv[0] = q.x;
        wv[1] = q.y;
      } else {
        const int byte = kq * 4;
        wv[0] = *reinterpret_cast<const uint32_t*>(
            mine + unit_at(tc, byte / 16) * 16 + byte % 16);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = kq * U + u;
        if (c * CH + jj < jg) {
          const uint32_t lo = wv[u * NL] ^ flip;
          const uint32_t hi = NL == 2 ? wv[u * NL + NL - 1] ^ flip : 0u;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const uint32_t plo = pattern(lo, s);
            const uint32_t phi = NL == 2 ? pattern(hi, s) : 0u;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              uint32_t g = lut[buf][jj][0][p][plo];
              if (NL == 2) g += lut[buf][jj][NL - 1][p][phi];
              if (s < Sch::SA) pa[p] += g << s;
              else pb[p] += g << (s - Sch::SA);
            }
          }
        }
        if ((u + 1) % FA == 0) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[2 * p] += pa[p] & 0xFFFFu;
            acc[2 * p + 1] += pa[p] >> 16;
            pa[p] = 0u;
          }
        }
        if (Sch::SB > 0 && (u + 1) % FB == 0) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[2 * p] += (pb[p] & 0xFFFFu) << Sch::SA;
            acc[2 * p + 1] += (pb[p] >> 16) << Sch::SA;
            pb[p] = 0u;
          }
        }
      }
    }
    if constexpr (UNALIGNED) stage(c + 2);         // into chunk c-1's slot
    __syncthreads();
  }
  if constexpr (!UNALIGNED) copy_wait<0>();  // empty groups past the range
  // The ring becomes the partial sums: every read of it is behind the
  // last barrier.

  // Corrections in int32: the bias of every gathered entry (NL per plane
  // and subtile, weighted 2^S - 1 over the planes) and the offset-binary
  // top plane, -2^(S-1) * sum(x) over this block's K range. The builders'
  // row sums are added across the lanes of one row pair (lane % P) by
  // shuffles; lane p of each builder warp keeps rows 2p and 2p+1.
#pragma unroll
  for (int r = 0; r < BM; ++r) part[kq][r * NT + tc] = acc[r];
  if (threadIdx.x < NW * 32) {
#pragma unroll
    for (int off = P; off < 32; off <<= 1) {
      xs0 += __shfl_xor_sync(0xffffffffu, xs0, off);
      xs1 += __shfl_xor_sync(0xffffffffu, xs1, off);
    }
    const int lane = threadIdx.x % 32;
    if (lane < P) {
      xsum[threadIdx.x / 32][2 * lane] = xs0;
      xsum[threadIdx.x / 32][2 * lane + 1] = xs1;
    }
  }
  __syncthreads();
  const int subtiles = max(0, min(c_hi * CH, jg) - c_lo * CH);
  const uint32_t bias = NL * BIAS * planes_max(S) * (uint32_t)subtiles;
  for (int e = threadIdx.x; e < TILE; e += NT * KT) {
    uint32_t v = 0u, rs = 0u;
#pragma unroll
    for (int q = 0; q < KT; ++q) v += part[q][e];
#pragma unroll
    for (int q = 0; q < NW; ++q) rs += (uint32_t)xsum[q][e / NT];
    part[0][e] = v - bias - (rs << (S - 1));
  }

  // Reduce the K split inside the cluster through distributed shared
  // memory: each rank adds every rank's sums for its share of the tile
  // (whole warps of sums) and stores them.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = ((TILE + ksplit - 1) / ksplit + 31) / 32 * 32;
  const int e_lo = (int)cluster.block_rank() * share;
  const int e_hi = min(e_lo + share, TILE);
  const uint32_t* peer[MAX_SPLIT];
#pragma unroll
  for (int q = 0; q < MAX_SPLIT; ++q)
    peer[q] = q < ksplit ? cluster.map_shared_rank(&part[0][0], q) : nullptr;
  for (int e = e_lo + threadIdx.x; e < e_hi; e += NT * KT) {
    uint32_t sum = 0u;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < ksplit) sum += peer[q][e];
    const int m = m0 + e / NT;
    const int nn = blockIdx.x * NT + e % NT;
    if (m < M && nn < N) out[((size_t)m * G + gi) * N + nn] = sum;
  }
  cluster.sync();               // peers stay resident until all have read
}

template <int W, int BM, int S, bool UNALIGNED>
cudaError_t launch(const int8_t* x, const int8_t* w, int M, int N, int K,
                   int G, int ksplit, uint32_t* out, cudaStream_t st) {
  const int jg = (K / G + W - 1) / W;
  const int nchunks = (jg + CH - 1) / CH;
  const int cps = (nchunks + ksplit - 1) / ksplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + NT - 1) / NT, (M + BM - 1) / BM, G * ksplit);
  cfg.blockDim = dim3(NT * threads_per_column<BM>(), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, tgemm_lut<W, BM, S, UNALIGNED>, x,
                                     w, M, N, K, G, ksplit, cps, out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int W, int BM, bool UNALIGNED>
cudaError_t by_bits(const int8_t* x, const int8_t* w, int M, int N, int K,
                    int G, int S, int ksplit, uint32_t* out, cudaStream_t st) {
  switch (S) {
    case 2:
      return launch<W, BM, 2, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
    case 3:
      return launch<W, BM, 3, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
    case 4:
      return launch<W, BM, 4, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
    case 5:
      return launch<W, BM, 5, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
    case 6:
      return launch<W, BM, 6, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
    case 7:
      return launch<W, BM, 7, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
    case 8:
      return launch<W, BM, 8, UNALIGNED>(x, w, M, N, K, G, ksplit, out, st);
  }
  return cudaErrorInvalidValue;
}

template <int W, bool UNALIGNED>
cudaError_t by_rows(const int8_t* x, const int8_t* w, int M, int N, int K,
                    int G, int S, int ksplit, uint32_t* out, cudaStream_t st) {
  if (M <= 4)
    return by_bits<W, 4, UNALIGNED>(x, w, M, N, K, G, S, ksplit, out, st);
  if (M <= 8)
    return by_bits<W, 8, UNALIGNED>(x, w, M, N, K, G, S, ksplit, out, st);
  return by_bits<W, 16, UNALIGNED>(x, w, M, N, K, G, S, ksplit, out, st);
}

}  // namespace

extern "C" {

// out (M, G, N) int32 = grouped x (M, K) int8 @ w (N, K) int8 ^T. x and w
// are contiguous device pointers, K % G == 0, S in [2, 8]. width is the
// kernel's subtile width W, 8 or 4: where (K / G) % width == 0 an aligned
// instance runs (x 4-byte and w width-byte aligned), else, at width 4
// only, the unaligned one (plain loads; no alignment needed). ksplit in
// [1, 8]: blocks per output tile along K, launched as one cluster (at
// most the number of chunks of CH subtiles per group). Rows per block: 4
// for M <= 4, 8 for M <= 8, else 16. Returns the cudaError_t of the
// launch (0 on success).
int transitive_gemm_launch(const void* x, const void* w, int M, int N, int K,
                           int G, int S, int width, int ksplit, void* out,
                           void* stream) {
  const bool unaligned = G > 0 && (K / G) % width != 0;
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || K % G ||
      (width != 4 && width != 8) || (unaligned && width != 4) || S < 2 ||
      S > 8 || ksplit < 1 || ksplit > MAX_SPLIT ||
      ksplit > ((K / G + width - 1) / width + CH - 1) / CH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  uint32_t* op = (uint32_t*)out;
  if (unaligned)
    return (int)by_rows<4, true>(xp, wp, M, N, K, G, S, ksplit, op, st);
  if (width == 8)
    return (int)by_rows<8, false>(xp, wp, M, N, K, G, S, ksplit, op, st);
  return (int)by_rows<4, false>(xp, wp, M, N, K, G, S, ksplit, op, st);
}

const char* transitive_gemm_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
