// Multilinear gather-draw for Hopper (sm_90a): every boolean deltam tier of
// one color that has no banding plan (the KBC class's dense tiers), the hub
// tier included, in one launch.
//
// Replaces: sampler_tpu/engine/multichain.py, color_delta_multilin with the
// Bernoulli draw of color_draw_tier, and hub_color_draw's chunk deltas,
// their segment sum onto the hub's rows and its draw.  The JAX package has
// no Pallas kernel there: XLA fuses the gather, the multilinear terms, the
// sum over the records and the draw into one computation of the jitted
// sweep, a tier at a time.
//
// For each tier of the launch (a table of tier descriptors: streams, rows,
// degree D, A1 = arity - 1 = 1 or 2 neighbour slots a record, where its
// draws go, its seed words), each row g and chain n:
//     delta[g, n] = base[g] + sum_d (b1·n1 + b2·n2 + bx·n1·n2)[g, d]
// with n1, n2 bit 0 of the world's values at the record's two neighbour
// positions (a position outside [0, P) reads 0), the b2/bx terms only when
// A1 == 2.  A hub row is one deep row: its chunks (rows[g] .. rows[g+1] of
// the tier's chunk streams, consecutive, chunk order then slot order) make
// (chunks x G) records, and its base is the sum of its chunks' bases in
// chunk order.  A record's term is rounded one operation at a time in the
// plain version's order (no contraction into FMAs).  The order of the sum
// is fixed: the records are cut into segments of kSeg, each segment is
// summed in the order of d, the segments are added in order
// (((seg0 + seg1) + seg2) + ...), then base.  A row of at most kSeg records
// is one segment: its order is d = 0..D-1.  The plain version sums in the
// same order, so delta equals it bit for bit.  The values of a boolean
// tier are 0 or 1: a term takes one of four values, which the kernel
// computes once a record.  Then, in the draw mode,
//     out[g, n] = u < sigmoid(delta[g, n])
// with u the 24-bit uniform of fused_dm_draw.cu's counter hash over fixed
// tiles of TB rows (counter (g % TB)*NC + n, seed words seed[t][0] and
// seed[t][1] ^ (g / TB)*0x9E3779B1 for tier t), tested as
// u * (1 + exp(-delta)) < 1 with the special-function unit's exponential:
// it can differ from the plain u < sigmoid(delta) only where u lies within
// about 1e-6 of sigmoid(delta).  In the delta mode a tier writes delta
// [B, NC] as float32 and draws nothing.
//
// What bounds it on the card: bytes.  Each record reads A1 neighbour rows
// of NC bytes; at the KBC cell (random_kbc_graph at 5e5 variables, 1024
// chains) a sweep gathers about 8.9 GB of rows, of which the distinct rows
// (about 1 GB) must come from HBM and the rest can come from L2, where RCM
// order and document windows put shared rows.  The arithmetic is a 4-way
// select and an add a (record, chain), and the hash and the draw a
// (row, chain).  A sweep's bound is 1.19 ms (the distinct rows, the
// streams and the draws at 3.35 TB/s; PERF.md, kernel table row 8).
//
// Design:
//   * One launch a color: rows of one color share no factor, across tiers
//     too, so every tier of the color is drawn from the same world in one
//     grid.  Each block belongs to one tier (a scan of the table's first
//     blocks), so the choice of body is block-uniform.  The deep tiers'
//     blocks come first in the grid: their rows are the longest chains of
//     dependent loads, and the wide tiers' blocks fill the card behind
//     them.
//   * Shallow rows (at most kSeg records: the KBC tiers of degree 5, 9, 16):
//     each thread draws VEC consecutive chains of one row (VEC = 16: one
//     16-byte load per neighbour row and one 16-byte store, when the chain
//     count and the pointers allow it; else 1).  Consecutive threads take
//     consecutive chain groups of the same row, so a warp's index and
//     coefficient loads are broadcasts and its row loads and stores are
//     coalesced.  The body is a template on D (1..kMaxD unrolled, one chunk;
//     5..kSeg in chunks) and on A1: a thread loads a chunk's indices and
//     its coefficients, then issues the chunk's row loads, which are
//     independent, together (kChunk records a chunk; 3 with two 16-byte
//     slots a record past D = 4).  The loop over chunks is not unrolled, so
//     no chunk's loads are hoisted over another's sums: at most 64
//     registers (4 blocks an SM).  D = 5..8 take the chunked body too: with
//     their count known to the compiler they spilled (24-264 bytes fully
//     unrolled, 8 bytes in chunks of 3), the loop over a count it reads
//     does not.
//   * Packed deep rows (a dense tier of more than kSeg records a row whose
//     segments x chain groups fit a warp: DeepDive's KBC graphs at 16
//     chains, rows of 24-53 records, most of them folded unary features
//     that read the dummy row).  Split across a block as below, such a row
//     kept 4-8 of 256 threads at work (2-4 segments x 2 groups of 8
//     chains), 0.95 ms a launch of 124k rows, one block a row.  Instead a
//     group of S lanes takes a row, S = segments x chain groups of VEC
//     chains rounded up to a power of two (2-4 at 16 chains), so 32 / S
//     rows share a warp and 256 / S a block.  Lane (segment k, chain
//     group) sums segment k in the order of d, two records' loads in
//     flight, as a shallow row's thread does (at kChunk the kernel
//     spilled); the group adds its chain
//     group's partials in segment order by __shfl_sync (no atomics, no
//     shared memory), adds base, spreads the hash and the draw of its
//     chains over the lanes, gathers the draw bits by shuffles and stores
//     VEC of them at once.  Hub rows and rows whose lanes would not fit a
//     warp (a 256-record row at 1024 chains) keep the block split.
//   * Other deep rows (more than kSeg records: the degree-256 tier, every
//     hub row) are split across a block: `lanes` lanes (16, 32 or 64) of
//     256 / lanes chain groups each, a group 8 chains (8-byte loads) where
//     the launch takes 16-byte rows.  In a wave, lane l sums segment
//     s0 + l of the row for its chain groups, in the order of d, and writes
//     the partial to shared memory (two buffers, one barrier a wave); then
//     thread i adds the wave's partials of chain i onto its running sum in
//     the order of the segments.  No atomics: the order is the plain
//     version's.  The thread of chain i adds base and draws it.
//   * World-write mode: the draws go straight into the world's rows of the
//     tier's block (`out` points at the block's first row of `values`), for
//     the rows the block's resample mask selects; no other row is drawn,
//     and none past the mask's length is written (a packed row that the
//     mask leaves out skips its loads and stores, but its lanes still take
//     part in their warp's shuffles).  The kernel reads the
//     world while it writes it.  No real neighbour of a row lies in a block
//     being drawn (the rows of one color share no factor); a pad slot names
//     the dummy row, outside every block, and its record's coefficients are
//     +0 or -0.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kMaxD = 4;       // D = 1..kMaxD are unrolled (one chunk)
constexpr int kChunk = 4;      // records a step
constexpr int kSeg = 16;       // records a segment of the fixed-order sum
constexpr int kMaxTiers = 8;   // tiers a launch
constexpr int kFields = 16;    // int64 fields a tier in the host table
constexpr uint32_t kKnuth = 0x9E3779B1u;

struct Tier {
  const int32_t* nbr;   // [R, A1] neighbour positions of the records
  const float* b1;      // [R]
  const float* b2;      // [R] (A1 == 2)
  const float* bx;      // [R] (A1 == 2)
  const float* base;    // [n_rows], or a hub's [chunks]
  const int32_t* rows;  // a hub's [n_rows + 1] chunk offsets, else null
  int8_t* out;          // row 0 of the draws, or null (the delta mode)
  float* delta;         // [n_rows, NC] or null
  const uint8_t* mask;  // [n_write] world-write row mask, or null
  int n_rows;
  int D;      // records a row (a hub's: a chunk)
  int A1;
  int n_write;
  int lanes;  // 1: a thread a row's VEC chains; else the deep split
  int pack;   // > 0: the packed layout, lanes a row (a power of two)
  int cols;   // deep: blocks a row (chain tiles)
  int seed;   // this tier's row of the seed words
  int block0; // its first block in the grid
};

struct Launch {
  Tier t[kMaxTiers];
  int n;
};

template <int VEC>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
};
template <>
struct Vec<8> {
  using T = uint2;
};
template <>
struct Vec<1> {
  using T = int8_t;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// A row slice as 32-bit words (a byte variant's one value in the low byte).
__device__ __forceinline__ void as_words(const uint4& v, uint32_t (&w)[4]) {
  memcpy(w, &v, sizeof(v));
}
__device__ __forceinline__ void as_words(const uint2& v, uint32_t (&w)[2]) {
  memcpy(w, &v, sizeof(v));
}
__device__ __forceinline__ void as_words(int8_t v, uint32_t (&w)[1]) {
  w[0] = static_cast<uint8_t>(v);
}

// A record's term for n1, n2 in {0, 1} (index n1 + 2*n2), rounded as the
// plain version rounds b1*n1 + b2*n2 + bx*(n1*n2).
template <int A1>
__device__ __forceinline__ void record_terms(float c1, float c2, float cx,
                                             float (&term)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float f1 = static_cast<float>(n & 1);
    const float f2 = static_cast<float>(n >> 1);
    float x = __fmul_rn(c1, f1);
    if constexpr (A1 == 2) {
      x = __fadd_rn(x, __fmul_rn(c2, f2));
      x = __fadd_rn(x, __fmul_rn(cx, __fmul_rn(f1, f2)));
    }
    term[n] = x;
  }
}

// The term of neighbour values n1, n2: term[n1 + 2*n2].
__device__ __forceinline__ float pick(const float (&term)[4], bool n1,
                                      bool n2) {
  return n2 ? (n1 ? term[3] : term[2]) : (n1 ? term[1] : term[0]);
}

// e^x by the special-function unit (ex2.approx, subnormals flushed).
__device__ __forceinline__ float fast_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(__fmul_rn(x, 0x1.715476p+0f)));
  return r;
}

// The draw bit of chain n of row g: u < sigmoid(delta).
__device__ __forceinline__ uint32_t draw_bit(float delta, uint32_t cnt,
                                             uint32_t s0, uint32_t tseed) {
  const uint32_t bits = mix32(mix32(cnt ^ s0) ^ tseed);
  const float u = static_cast<float>(bits >> 8) * 0x1p-24f + 0x1p-25f;
  // u < 1 / (1 + exp(-delta))  <=>  u * (1 + exp(-delta)) < 1
  return fmaf(u, fast_exp(-delta), u) < 1.0f ? 1u : 0u;
}

// acc[e] += the terms of records rs .. rs+cnt-1 of the tier, chain group cg
// (VEC chains), in the order of the records, CHM records in flight; acc
// starts at -0, so the first add gives the first term exactly.  CNT > 0:
// cnt == CNT, known here.  A tier's records of one color number less than
// 2^31 / A1 (the launcher checks it), so offsets are 32-bit; the streams
// are read through the tier's pointers at each use (the loop keeps no
// pointer of its own in registers).
template <int VEC, int A1, int CNT, int CHM = kChunk>
__device__ __forceinline__ void sum_records(float (&acc)[VEC],
                                            const int8_t* __restrict__ values,
                                            int NC, int P, const Tier& T,
                                            int rs, int cnt, unsigned cg) {
  using V = typename Vec<VEC>::T;
  constexpr int CH = CNT > 0 && CNT < CHM ? CNT : CHM;
  constexpr int NW = VEC >= 4 ? VEC / 4 : 1;  // 32-bit words a row slice
  const int n = CNT > 0 ? CNT : cnt;
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += CH) {
    // the chunk's indices and coefficients first: independent broadcasts
    // (a record past the end reads no row)
    int row[A1][CH];
    float c1[CH], c2[CH], cx[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool real = i0 + i < n;
      const int r = i0 + i;
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        const int j = real ? T.nbr[(rs + r) * A1 + a] : -1;
        row[a][i] = j >= 0 && j < P ? j : -1;
      }
      c1[i] = real ? T.b1[rs + r] : 0.0f;
      c2[i] = A1 == 2 && real ? T.b2[rs + r] : 0.0f;
      cx[i] = A1 == 2 && real ? T.bx[rs + r] : 0.0f;
    }
    // then the neighbour rows, all in flight together
    V v[A1][CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        v[a][i] = V{};
        if (row[a][i] >= 0) {
          v[a][i] = __ldg(reinterpret_cast<const V*>(
                              values + static_cast<size_t>(row[a][i]) * NC) +
                          cg);
        }
      }
    }
    // a 4-way select and an add a (chain, record), in the order of d
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i0 + i >= n) break;
      // n1, n2 of chain e: bit 0 of byte e of the two slots' rows
      uint32_t w1[NW], w2[NW] = {};
      as_words(v[0][i], w1);
      if constexpr (A1 == 2) as_words(v[A1 - 1][i], w2);
      float term[4];
      record_terms<A1>(c1[i], c2[i], cx[i], term);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t bit = 1u << (8 * (e & 3));
        acc[e] = __fadd_rn(acc[e],
                           pick(term, w1[e >> 2] & bit, w2[e >> 2] & bit));
      }
    }
  }
}

// Shallow rows: block `local` of the tier, VEC chains a thread.
template <int VEC, int DS, int A1>
__device__ __forceinline__ void shallow_rows(const Tier& T, unsigned local,
                                             const int8_t* __restrict__ values,
                                             int NC, int P,
                                             const int32_t* __restrict__ seed,
                                             int TB) {
  using V = typename Vec<VEC>::T;
  const unsigned ncv = static_cast<unsigned>(NC / VEC);
  const unsigned long long idx =
      static_cast<unsigned long long>(local) * kThreads + threadIdx.x;
  const unsigned long long gl = idx / ncv;
  if (gl >= static_cast<unsigned long long>(T.n_rows)) return;
  const int g = static_cast<int>(gl);
  // world-write mode: only rows of the block that the mask selects
  if (T.mask != nullptr && (g >= T.n_write || T.mask[g] == 0)) return;
  const unsigned cg = static_cast<unsigned>(idx - gl * ncv);
  const int D = DS > 0 ? DS : T.D;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = -0.0f;
  // three records in flight where two 16-byte slots a record and more
  // than four records would pass 64 registers
  constexpr int CHM =
      A1 == 2 && VEC == 16 && (DS == 0 || DS > kChunk) ? 3 : kChunk;
  sum_records<VEC, A1, DS, CHM>(acc, values, NC, P, T, g * D, D, cg);

  const float bs = T.base[g];
  const size_t o = static_cast<size_t>(g) * NC + static_cast<size_t>(cg) * VEC;
  float delta[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) delta[e] = __fadd_rn(acc[e], bs);
  if (T.delta != nullptr) {
    if constexpr (VEC == 1) {
      T.delta[o] = delta[0];
    } else {
      float4* dp = reinterpret_cast<float4*>(T.delta + o);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        dp[q] = make_float4(delta[4 * q], delta[4 * q + 1], delta[4 * q + 2],
                            delta[4 * q + 3]);
      }
    }
  }
  if (T.out == nullptr) return;  // the delta mode

  const int t = g / TB;
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t tseed =
      static_cast<uint32_t>(seed[1]) ^ (static_cast<uint32_t>(t) * kKnuth);
  const uint32_t cnt0 =
      static_cast<uint32_t>(g - t * TB) * static_cast<uint32_t>(NC) +
      static_cast<uint32_t>(cg * VEC);
  uint32_t packed[(VEC + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    packed[e >> 2] |= draw_bit(delta[e], cnt0 + e, s0, tseed) << (8 * (e & 3));
  }
  if constexpr (VEC == 1) {
    T.out[o] = static_cast<int8_t>(packed[0]);
  } else {
    V w;
    static_assert(sizeof(V) == sizeof(packed), "VEC bytes of draws");
    memcpy(&w, packed, sizeof(V));
    __stcs(reinterpret_cast<V*>(T.out + o), w);
  }
}

template <int VEC, int A1>
__device__ __forceinline__ void shallow_d(const Tier& T, unsigned local,
                                          const int8_t* values, int NC, int P,
                                          const int32_t* seed, int TB) {
  switch (T.D) {
    case 1: return shallow_rows<VEC, 1, A1>(T, local, values, NC, P, seed, TB);
    case 2: return shallow_rows<VEC, 2, A1>(T, local, values, NC, P, seed, TB);
    case 3: return shallow_rows<VEC, 3, A1>(T, local, values, NC, P, seed, TB);
    case 4: return shallow_rows<VEC, 4, A1>(T, local, values, NC, P, seed, TB);
    default: return shallow_rows<VEC, 0, A1>(T, local, values, NC, P, seed, TB);
  }
}
static_assert(kMaxD == 4, "shallow_d unrolls D = 1..4");

// A deep row: block `local` of the tier is (row, chain tile); lanes of
// 256 / lanes chain groups of DV chains (8-byte slices where the launch
// takes 16-byte rows) sum a segment each, a wave at a time, two records in
// flight: the lanes keep the loads in flight, at half the shallow rows'
// registers.
template <int VEC, int A1>
__device__ __forceinline__ void deep_row(const Tier& T, unsigned local,
                                         const int8_t* __restrict__ values,
                                         int NC, int P,
                                         const int32_t* __restrict__ seed,
                                         int TB, float* __restrict__ buf) {
  constexpr int DV = VEC == 16 ? 8 : 1;
  const int L = T.lanes;
  const int CGB = kThreads / L;     // chain groups a block
  const int CHN = CGB * DV;         // chains a block (L * CHN = 256 * DV)
  const int g = static_cast<int>(local / T.cols);
  const int tile = static_cast<int>(local - static_cast<unsigned>(g) * T.cols);
  // world-write mode: a row the mask leaves out is not drawn (block-uniform)
  if (T.mask != nullptr && (g >= T.n_write || T.mask[g] == 0)) return;
  const int col = threadIdx.x % CGB;
  const int lane = threadIdx.x / CGB;
  const unsigned ncv = static_cast<unsigned>(NC / DV);
  const unsigned cg = static_cast<unsigned>(tile * CGB + col);
  const bool active = cg < ncv;
  int r0, n_rec;
  if (T.rows != nullptr) {
    const int k0 = T.rows[g];
    r0 = k0 * T.D;
    n_rec = (T.rows[g + 1] - k0) * T.D;
  } else {
    r0 = g * T.D;
    n_rec = T.D;
  }
  const int nseg = (n_rec + kSeg - 1) / kSeg;

  float tot = -0.0f;  // chain threadIdx.x's sum of the segments so far
  for (int s0 = 0, w = 0; s0 < nseg; s0 += L, ++w) {
    float* part = buf + (w & 1) * (kThreads * DV);
    const int seg = s0 + lane;
    if (seg < nseg && active) {
      float acc[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[e] = -0.0f;
      const int cnt = min(kSeg, n_rec - seg * kSeg);
      sum_records<DV, A1, 0, 2>(acc, values, NC, P, T, r0 + seg * kSeg, cnt,
                                cg);
      float* mine = part + lane * CHN + col * DV;
      if constexpr (DV == 1) {
        mine[0] = acc[0];
      } else {
#pragma unroll
        for (int q = 0; q < DV / 4; ++q) {
          reinterpret_cast<float4*>(mine)[q] = make_float4(
              acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
        }
      }
    }
    __syncthreads();
    // the wave's segments onto the running sum, in their order (the other
    // buffer takes the next wave, so one barrier a wave suffices)
    if (static_cast<int>(threadIdx.x) < CHN) {
      const int nl = min(L, nseg - s0);
      const float* p = part + threadIdx.x;
      for (int l = 0; l < nl; ++l) tot = __fadd_rn(tot, p[l * CHN]);
    }
  }

  if (static_cast<int>(threadIdx.x) >= CHN) return;
  const int n = tile * CHN + static_cast<int>(threadIdx.x);
  if (n >= NC) return;
  float bs;
  if (T.rows != nullptr) {  // a hub row's chunk bases, in chunk order
    bs = -0.0f;
    for (int k = T.rows[g]; k < T.rows[g + 1]; ++k) {
      bs = __fadd_rn(bs, T.base[k]);
    }
  } else {
    bs = T.base[g];
  }
  const float delta = __fadd_rn(tot, bs);
  const size_t o = static_cast<size_t>(g) * NC + n;
  if (T.delta != nullptr) T.delta[o] = delta;
  if (T.out == nullptr) return;  // the delta mode
  const int t = g / TB;
  const uint32_t tseed = static_cast<uint32_t>(seed[1]) ^
                         (static_cast<uint32_t>(t) * kKnuth);
  const uint32_t cnt =
      static_cast<uint32_t>(g - t * TB) * static_cast<uint32_t>(NC) +
      static_cast<uint32_t>(n);
  T.out[o] = static_cast<int8_t>(
      draw_bit(delta, cnt, static_cast<uint32_t>(seed[0]), tseed));
}

// Packed deep rows: block `local` of the tier holds kThreads / S rows, a
// group of S = T.pack lanes (a power of two, so a group lies in one warp)
// a row.  Lane l of a group sums segment l % nseg of chain group l / nseg
// (VEC chains) in the order of d; lanes past nseg * ncv have no segment.
// The group's lanes then add the partials of their chain group in segment
// order by shuffles, each lane draws every nseg-th chain of its group, and
// the group's first lane of the chain group stores the VEC draws.  Every
// lane of the warp reaches every shuffle: a row past the tier or left out
// by the mask only skips its loads and stores.
template <int VEC, int A1>
__device__ __forceinline__ void packed_rows(const Tier& T, unsigned local,
                                            const int8_t* __restrict__ values,
                                            int NC, int P,
                                            const int32_t* __restrict__ seed,
                                            int TB) {
  constexpr unsigned kAll = 0xffffffffu;
  const int S = T.pack;
  const int l = static_cast<int>(threadIdx.x) & (S - 1);
  const unsigned long long gl =
      static_cast<unsigned long long>(local) * (kThreads / S) +
      threadIdx.x / S;
  const int g = static_cast<int>(gl);
  const int D = T.D;
  const int nseg = (D + kSeg - 1) / kSeg;
  const int ncv = NC / VEC;
  const int cg = min(l / nseg, ncv - 1);
  const int k = l - (l / nseg) * nseg;
  // world-write mode: only rows of the block that the mask selects
  const bool live =
      gl < static_cast<unsigned long long>(T.n_rows) &&
      (T.mask == nullptr || (g < T.n_write && T.mask[g] != 0));
  const bool mine = live && l < nseg * ncv;  // this lane has a segment

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = -0.0f;
  if (mine) {  // two records in flight: more spilled (72 bytes at 4)
    sum_records<VEC, A1, 0, 2>(acc, values, NC, P, T, g * D + k * kSeg,
                               min(kSeg, D - k * kSeg), cg);
  }
  // the chain group's segments in their order: (seg0 + seg1) + seg2 ...
  const int src = (static_cast<int>(threadIdx.x) & 31 & ~(S - 1)) + cg * nseg;
  const float bs = live ? T.base[g] : 0.0f;
  float delta[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) delta[e] = -0.0f;
  for (int j = 0; j < nseg; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      delta[e] = __fadd_rn(delta[e], __shfl_sync(kAll, acc[e], src + j));
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) delta[e] = __fadd_rn(delta[e], bs);
  const bool first = mine && k == 0;
  const size_t o = static_cast<size_t>(g) * NC + static_cast<size_t>(cg) * VEC;
  if (T.delta != nullptr && first) {
    if constexpr (VEC == 1) {
      T.delta[o] = delta[0];
    } else {
      float4* dp = reinterpret_cast<float4*>(T.delta + o);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        dp[q] = make_float4(delta[4 * q], delta[4 * q + 1], delta[4 * q + 2],
                            delta[4 * q + 3]);
      }
    }
  }
  if (T.out == nullptr) return;  // the delta mode (tier-uniform)

  // chains k, k + nseg, ... of the chain group; bit e of `bits` is chain e's
  uint32_t bits = 0;
  if (mine) {
    const int t = g / TB;
    const uint32_t s0 = static_cast<uint32_t>(seed[0]);
    const uint32_t tseed =
        static_cast<uint32_t>(seed[1]) ^ (static_cast<uint32_t>(t) * kKnuth);
    const uint32_t cnt0 =
        static_cast<uint32_t>(g - t * TB) * static_cast<uint32_t>(NC) +
        static_cast<uint32_t>(cg * VEC);
    for (int e = k; e < VEC; e += nseg) {
      float d = delta[0];
#pragma unroll
      for (int q = 1; q < VEC; ++q) d = q == e ? delta[q] : d;
      bits |= draw_bit(d, cnt0 + e, s0, tseed) << e;
    }
  }
  uint32_t all = 0;
  for (int j = 0; j < nseg; ++j) all |= __shfl_sync(kAll, bits, src + j);
  if (!first) return;
  if constexpr (VEC == 1) {
    T.out[o] = static_cast<int8_t>(all);
  } else {
    uint32_t packed[VEC / 4];
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      packed[q] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        packed[q] |= ((all >> (4 * q + i)) & 1u) << (8 * i);
      }
    }
    typename Vec<VEC>::T w;
    static_assert(sizeof(w) == sizeof(packed), "VEC bytes of draws");
    memcpy(&w, packed, sizeof(w));
    __stcs(reinterpret_cast<typename Vec<VEC>::T*>(T.out + o), w);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dm_gather_draw_kernel(const __grid_constant__ Launch L,
                          const int8_t* __restrict__ values, int NC, int P,
                          const int32_t* __restrict__ seeds, int TB) {
  __shared__ __align__(16) float buf[2 * kThreads * (VEC == 16 ? 8 : 1)];
  int t = 0;
  while (t + 1 < L.n && static_cast<int>(blockIdx.x) >= L.t[t + 1].block0) {
    ++t;
  }
  const Tier& T = L.t[t];
  const unsigned local = blockIdx.x - static_cast<unsigned>(T.block0);
  const int32_t* seed = seeds == nullptr ? nullptr : seeds + 2 * T.seed;
  if (T.lanes == 1) {
    if (T.A1 == 2) {
      shallow_d<VEC, 2>(T, local, values, NC, P, seed, TB);
    } else {
      shallow_d<VEC, 1>(T, local, values, NC, P, seed, TB);
    }
  } else if (T.pack > 0) {
    if (T.A1 == 2) {
      packed_rows<VEC, 2>(T, local, values, NC, P, seed, TB);
    } else {
      packed_rows<VEC, 1>(T, local, values, NC, P, seed, TB);
    }
  } else if (T.A1 == 2) {
    deep_row<VEC, 2>(T, local, values, NC, P, seed, TB, buf);
  } else {
    deep_row<VEC, 1>(T, local, values, NC, P, seed, TB, buf);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The lanes a row of a dense tier takes in the packed layout: its segments
// times its chain groups (ncv, of the launch's VEC chains) rounded up to a
// power of two, where the row has 2 or more segments and that product is
// at most 32; else 0 (the block split).  ops.fused.dm_packed_lanes is the
// same rule.
int packed_lanes(long long D, long long ncv) {
  const long long need = (D + kSeg - 1) / kSeg * ncv;
  if (D <= kSeg || ncv < 1 || need > 32) return 0;
  int S = 2;
  while (S < need) S *= 2;
  return S;
}

}  // namespace

// values int8 [P, NC]; table: host int64 [n_tiers, 16], a row a tier:
//   nbr, b1, b2, bx, base, rows, out, delta, mask (device pointers, 0 for
//   none), row0, n_rows, D, A1, n_write, lanes, records
// nbr int32 [R, A1] (global positions), b1, b2, bx f32 [R] (b2, bx only
// when A1 == 2), base f32; a dense tier: R = n_rows * D, base [n_rows],
// rows 0; a hub tier: R = chunks * D (D = the chunk's records), base
// [chunks], rows int32 [n_rows + 1] the chunk offsets of its rows;
// records the length R of its record streams (R * A1 < 2^31).  The
// draws of row g go to out + g * NC (out int8 [n_rows, NC]), or with
// row0 >= 0 to the world's row row0 + g (world-write mode: out 0, mask
// uint8 [n_write], a row drawn only where g < n_write and mask[g] != 0,
// delta 0); delta f32 [n_rows, NC] or 0; neither out nor row0: the delta
// mode.  lanes 1 takes a row a thread (at most 16 records a row, no
// rows), 16, 32 or 64 a deep row: a dense tier's rows take the packed
// layout where packed_lanes allows it, else each row is split across a
// block.  seeds int32
// [n_tiers, 2] on the device (null in the delta mode); TB the rows of a
// tile of the counter hash.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a table it does not take).
extern "C" int dm_gather_draw_launch(const void* values, int NC, int P,
                                     const void* table, int n_tiers,
                                     const void* seeds, int TB,
                                     void* stream) {
  if (NC == 0) return static_cast<int>(cudaSuccess);
  if (n_tiers < 1 || n_tiers > kMaxTiers || NC < 0 || P < 1 || TB < 1 ||
      static_cast<long long>(TB) * NC > (1ll << 32) || table == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f = static_cast<const long long*>(table);
  const auto* v = static_cast<const int8_t*>(values);
  bool wide = NC % 16 == 0 && aligned16(values);
  Tier tiers[kMaxTiers] = {};
  for (int i = 0; i < n_tiers; ++i) {
    const long long* x = f + static_cast<size_t>(i) * kFields;
    Tier& T = tiers[i];
    T.nbr = reinterpret_cast<const int32_t*>(x[0]);
    T.b1 = reinterpret_cast<const float*>(x[1]);
    T.b2 = reinterpret_cast<const float*>(x[2]);
    T.bx = reinterpret_cast<const float*>(x[3]);
    T.base = reinterpret_cast<const float*>(x[4]);
    T.rows = reinterpret_cast<const int32_t*>(x[5]);
    T.out = reinterpret_cast<int8_t*>(x[6]);
    T.delta = reinterpret_cast<float*>(x[7]);
    T.mask = reinterpret_cast<const uint8_t*>(x[8]);
    const long long row0 = x[9];
    const long long n_rows = x[10], D = x[11], A1 = x[12], n_write = x[13],
                    lanes = x[14], records = x[15];
    if (n_rows < 0 || n_rows >= INT_MAX || D < 1 || D >= INT_MAX ||
        records < 0 || records * A1 >= INT_MAX ||
        (T.rows == nullptr && records != n_rows * D) ||
        (A1 != 1 && A1 != 2) || n_write < 0 || n_write > n_rows ||
        (lanes != 1 && lanes != 16 && lanes != 32 && lanes != 64) ||
        (lanes == 1 && (T.rows != nullptr || D > kSeg)) ||
        T.nbr == nullptr || T.b1 == nullptr || T.base == nullptr ||
        (A1 == 2 && (T.b2 == nullptr || T.bx == nullptr)) ||
        (row0 >= 0 && (T.out != nullptr || T.mask == nullptr ||
                       T.delta != nullptr || row0 + n_write > P)) ||
        (row0 < 0 && T.mask != nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (row0 >= 0) T.out = const_cast<int8_t*>(v) + row0 * NC;
    if ((T.out == nullptr && T.delta == nullptr) ||
        (T.out != nullptr && seeds == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    wide = wide && aligned16(T.out) && aligned16(T.delta);
    T.n_rows = static_cast<int>(n_rows);
    T.D = static_cast<int>(D);
    T.A1 = static_cast<int>(A1);
    T.n_write = static_cast<int>(n_write);
    T.lanes = static_cast<int>(lanes);
    T.seed = i;
  }
  // the deep tiers' blocks first, then the shallow ones'
  const long long VEC = wide ? 16 : 1;
  const long long ncv = NC / VEC;
  Launch L = {};
  long long blocks = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < n_tiers; ++i) {
      Tier T = tiers[i];
      if ((T.lanes > 1) != (pass == 0)) continue;
      if (T.lanes > 1 && T.rows == nullptr) T.pack = packed_lanes(T.D, ncv);
      long long nb;
      if (T.lanes == 1) {
        nb = (T.n_rows * ncv + kThreads - 1) / kThreads;
      } else if (T.pack > 0) {
        const long long per = kThreads / T.pack;  // rows a block
        nb = (T.n_rows + per - 1) / per;
      } else {
        // the deep rows' chain groups: 8 chains (1 in byte rows)
        const long long cgb = kThreads / T.lanes, dv = wide ? 8 : 1;
        T.cols = static_cast<int>((NC / dv + cgb - 1) / cgb);
        nb = static_cast<long long>(T.n_rows) * T.cols;
      }
      if (nb == 0) continue;
      T.block0 = static_cast<int>(blocks);
      blocks += nb;
      if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
      L.t[L.n++] = T;
    }
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const auto* sd = static_cast<const int32_t*>(seeds);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (wide) {
    dm_gather_draw_kernel<16><<<grid, kThreads, 0, s>>>(L, v, NC, P, sd, TB);
  } else {
    dm_gather_draw_kernel<1><<<grid, kThreads, 0, s>>>(L, v, NC, P, sd, TB);
  }
  return static_cast<int>(cudaGetLastError());
}

// The lanes a row of D records takes in the packed layout at NC chains
// read vec (16 or 1) at a time, 0 for the block split: the launcher's rule,
// for a check of ops.fused.dm_packed_lanes on the card.
extern "C" int dm_gather_draw_packed_lanes(int D, int NC, int vec) {
  return vec == 16 || vec == 1 ? packed_lanes(D, NC / vec) : 0;
}
