// Multilinear gather-draw for Hopper (sm_90a): the boolean deltam tiers
// that have no banding plan (the KBC class's dense tiers) and the hub
// tier's chunks.
//
// Replaces: sampler_tpu/engine/multichain.py, color_delta_multilin with the
// Bernoulli draw of color_draw_tier, and the chunk deltas of
// hub_color_draw.  The JAX package has no Pallas kernel there: XLA fuses
// the gather, the multilinear terms, the sum over the records and the draw
// into one computation of the jitted sweep, a tier at a time.  Run as
// eager PyTorch passes, the same arithmetic wrote and read some fifteen
// [B, D, A1, NC] or [B, D, NC] temporaries a tier.
//
// For one color of one tier (B rows of D records, A1 = arity - 1 = 1 or 2
// neighbour slots a record, global positions in nbr [B, D, A1]), each row
// g and chain n:
//     delta[g, n] = base[g] + sum_d (b1·n1 + b2·n2 + bx·n1·n2)[g, d]
// with n1, n2 bit 0 of the world's values at the record's two neighbour
// positions (a position outside [0, P) reads 0), the b2/bx terms only when
// A1 == 2.  A record's term is rounded one operation at a time in the
// plain version's order (no contraction into FMAs), and the terms are
// summed in the order d = 0..D-1 before base is added, so delta equals
// the plain PyTorch version's bit for bit.  The values of a boolean tier
// are 0 or 1: a term takes one of four values, which the kernel computes
// once a record.  Then, in the draw mode,
//     out[g, n] = u < sigmoid(delta[g, n])
// with u the 24-bit uniform of fused_dm_draw.cu's counter hash over fixed
// tiles of TB rows (counter (g % TB)*NC + n, seed words seed[0] and
// seed[1] ^ (g / TB)*0x9E3779B1), tested as u * (1 + exp(-delta)) < 1 with
// the special-function unit's exponential: it can differ from the plain
// u < sigmoid(delta) only where u lies within about 1e-6 of
// sigmoid(delta).  In the delta mode (out null) the kernel writes delta
// [B, NC] as float32 and draws nothing: a hub tier's chunks, whose sums
// the caller adds onto their rows.
//
// What bounds it on the card: bytes.  Each record reads A1 neighbour rows
// of NC bytes; at the KBC cell (random_kbc_graph at 5e5 variables, 1024
// chains) a sweep gathers about 8.9 GB of rows, of which the distinct rows
// (about 1 GB) must come from HBM and the rest can come from L2, where RCM
// order and document windows put shared rows.  The arithmetic is a 4-way
// select and an add a (record, chain), and the hash and the draw a
// (row, chain).  The tiers are narrow where they are deep (88 rows of 256
// records, hub chunks of 512): their rows are few, and each thread walks
// its records in order, so those launches are latency bound.  A sweep's
// 55 launches there take 7.00 ms against a bound of 1.19 ms (the distinct
// rows, the streams and the draws at 3.35 TB/s), 2.65 ms to bring every
// gathered row from HBM, and 2.66 ms of SASS issue; the two wide tiers
// take 3.34 ms of it and the two narrow ones 3.13 (chip_smoke.py phase
// 15b, NVIDIA H100 80GB HBM3, power limit 700 W; PERF.md, kernel table
// row 8).
//
// Design: each thread draws VEC consecutive chains of one row (VEC = 16:
// one 16-byte load per neighbour row and one 16-byte store, when the chain
// count and the pointers allow it; else 1).  Consecutive threads take
// consecutive chain groups of the same row, so a warp's index and
// coefficient loads are broadcasts and its row loads and stores are
// coalesced.
//   * Indices first, then rows.  The kernel is a template on D (1..kMaxD
//     unrolled; any other D runs the same code over chunks of kChunk
//     records) and on A1: a thread loads a chunk's A1*kChunk indices and
//     its coefficients, then issues the chunk's row loads, which are
//     independent, together.
//   * No split of a row's records across threads: the sum keeps the plain
//     version's order, so the deltas are exact against it.
//   * World-write mode: the draws go straight into the world's rows of the
//     block (`out` points at the block's first row of `values`), for the
//     rows the block's resample mask selects; no other row is drawn, and
//     none past the block's length is written.  The kernel reads the world
//     while it writes it.  No real neighbour of a row lies in the block
//     being drawn (the rows of one color share no factor); a pad slot
//     names the dummy row, outside every block, and its record's
//     coefficients are +0 or -0.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kMaxD = 8;       // D = 1..kMaxD are unrolled
constexpr int kChunk = 4;      // records a step
constexpr uint32_t kKnuth = 0x9E3779B1u;

template <int VEC>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
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

// Rows g_begin + idx / ncv (n_launch of them) of the n_rows rows, VEC
// chains a thread.  DS > 0: D == DS, unrolled; DS == 0: any D, kChunk
// records a step.
template <int VEC, int DS, int A1>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dm_gather_draw_kernel(const int8_t* __restrict__ values, int NC, int P,
                          const int32_t* __restrict__ nbr,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2,
                          const float* __restrict__ bx,
                          const float* __restrict__ base,
                          const int32_t* __restrict__ seed, int g_begin,
                          int n_launch, int D, int TB,
                          int8_t* __restrict__ out,
                          float* __restrict__ delta_out,
                          const uint8_t* __restrict__ wmask, int n_write) {
  using T = typename Vec<VEC>::T;
  constexpr int CH = DS > 0 && DS < kChunk ? DS : kChunk;
  constexpr int NW = VEC == 16 ? 4 : 1;  // 32-bit words a row slice
  const unsigned ncv = static_cast<unsigned>(NC / VEC);
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  const unsigned gl = idx / ncv;
  if (gl >= static_cast<unsigned>(n_launch)) return;
  const int g = g_begin + static_cast<int>(gl);
  // world-write mode: only rows of the block that the mask selects
  if (wmask != nullptr && (g >= n_write || wmask[g] == 0)) return;
  const int lane = static_cast<int>(idx - gl * ncv);
  const int nd = DS > 0 ? DS : D;
  const int32_t* nbr_g = nbr + static_cast<size_t>(g) * nd * A1;
  const size_t cf0 = static_cast<size_t>(g) * nd;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int d0 = 0; d0 < nd; d0 += CH) {
    // the chunk's indices and coefficients first: independent broadcasts
    // (a record past D reads no row)
    int row[A1][CH];
    float c1[CH], c2[CH], cx[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool real = d0 + i < nd;
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        const int j = real ? nbr_g[(d0 + i) * A1 + a] : -1;
        row[a][i] = j >= 0 && j < P ? j : -1;
      }
      c1[i] = real ? b1[cf0 + d0 + i] : 0.0f;
      c2[i] = A1 == 2 && real ? b2[cf0 + d0 + i] : 0.0f;
      cx[i] = A1 == 2 && real ? bx[cf0 + d0 + i] : 0.0f;
    }
    // then the neighbour rows, all in flight together
    T v[A1][CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        v[a][i] = T{};
        if (row[a][i] >= 0) {
          v[a][i] = __ldg(reinterpret_cast<const T*>(
                              values + static_cast<size_t>(row[a][i]) * NC) +
                          lane);
        }
      }
    }
    // a 4-way select and an add a (chain, record), in the order of d
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (d0 + i >= nd) break;
      // n1, n2 of chain e: bit 0 of byte e of the two slots' rows
      uint32_t w1[NW], w2[NW] = {};
      as_words(v[0][i], w1);
      if constexpr (A1 == 2) as_words(v[A1 - 1][i], w2);
      float term[4];
      record_terms<A1>(c1[i], c2[i], cx[i], term);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t bit = 1u << (8 * (e & 3));
        const float x = pick(term, w1[e >> 2] & bit, w2[e >> 2] & bit);
        acc[e] = d0 + i == 0 ? x : __fadd_rn(acc[e], x);
      }
    }
  }

  const float bs = base[g];
  const size_t o =
      static_cast<size_t>(g) * NC + static_cast<size_t>(lane) * VEC;
  float delta[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) delta[e] = __fadd_rn(acc[e], bs);
  if (delta_out != nullptr) {
    if constexpr (VEC == 1) {
      delta_out[o] = delta[0];
    } else {
      float4* dp = reinterpret_cast<float4*>(delta_out + o);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        dp[q] = make_float4(delta[4 * q], delta[4 * q + 1], delta[4 * q + 2],
                            delta[4 * q + 3]);
      }
    }
  }
  if (out == nullptr) return;  // the delta mode

  const int t = g / TB;
  const int b = g - t * TB;
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t tseed =
      static_cast<uint32_t>(seed[1]) ^ (static_cast<uint32_t>(t) * kKnuth);
  const uint32_t cnt0 =
      static_cast<uint32_t>(b) * static_cast<uint32_t>(NC) +
      static_cast<uint32_t>(lane * VEC);
  uint32_t packed[(VEC + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const uint32_t bits = mix32(mix32((cnt0 + e) ^ s0) ^ tseed);
    const float u = static_cast<float>(bits >> 8) * 0x1p-24f + 0x1p-25f;
    // u < 1 / (1 + exp(-delta))  <=>  u * (1 + exp(-delta)) < 1
    const float x = fast_exp(-delta[e]);
    packed[e >> 2] |= (fmaf(u, x, u) < 1.0f ? 1u : 0u) << (8 * (e & 3));
  }
  if constexpr (VEC == 1) {
    out[o] = static_cast<int8_t>(packed[0]);
  } else {
    T w;
    static_assert(sizeof(T) == sizeof(packed), "VEC bytes of draws");
    memcpy(&w, packed, sizeof(T));
    __stcs(reinterpret_cast<T*>(out + o), w);
  }
}

template <int VEC, int DS, int A1>
int launch_rows(const int8_t* values, int NC, int P, const int32_t* nbr,
                const float* b1, const float* b2, const float* bx,
                const float* base, const int32_t* seed, int n_rows, int D,
                int TB, int8_t* out, float* delta_out, const uint8_t* wmask,
                int n_write, cudaStream_t s) {
  const long long ncv = NC / VEC;
  // rows a launch, so that its thread index stays inside 31 bits
  const long long per = INT_MAX / ncv;
  for (long long g = 0; g < n_rows; g += per) {
    const long long rows = n_rows - g < per ? n_rows - g : per;
    const long long threads = rows * ncv;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    dm_gather_draw_kernel<VEC, DS, A1><<<blocks, kThreads, 0, s>>>(
        values, NC, P, nbr, b1, b2, bx, base, seed, static_cast<int>(g),
        static_cast<int>(rows), D, TB, out, delta_out, wmask, n_write);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

#define SAMPLER_DGD_ARGS                                                    \
  values, NC, P, nbr, b1, b2, bx, base, seed, n_rows, D, TB, out, delta_out, \
      wmask, n_write, s

template <int VEC, int A1>
int launch_d(const int8_t* values, int NC, int P, const int32_t* nbr,
             const float* b1, const float* b2, const float* bx,
             const float* base, const int32_t* seed, int n_rows, int D,
             int TB, int8_t* out, float* delta_out, const uint8_t* wmask,
             int n_write, cudaStream_t s) {
  switch (D) {
    case 1: return launch_rows<VEC, 1, A1>(SAMPLER_DGD_ARGS);
    case 2: return launch_rows<VEC, 2, A1>(SAMPLER_DGD_ARGS);
    case 3: return launch_rows<VEC, 3, A1>(SAMPLER_DGD_ARGS);
    case 4: return launch_rows<VEC, 4, A1>(SAMPLER_DGD_ARGS);
    case 5: return launch_rows<VEC, 5, A1>(SAMPLER_DGD_ARGS);
    case 6: return launch_rows<VEC, 6, A1>(SAMPLER_DGD_ARGS);
    case 7: return launch_rows<VEC, 7, A1>(SAMPLER_DGD_ARGS);
    case 8: return launch_rows<VEC, 8, A1>(SAMPLER_DGD_ARGS);
    default: return launch_rows<VEC, 0, A1>(SAMPLER_DGD_ARGS);
  }
}
static_assert(kMaxD == 8, "launch_d unrolls D = 1..8");

template <int VEC>
int launch_vec(int A1, const int8_t* values, int NC, int P,
               const int32_t* nbr, const float* b1, const float* b2,
               const float* bx, const float* base, const int32_t* seed,
               int n_rows, int D, int TB, int8_t* out, float* delta_out,
               const uint8_t* wmask, int n_write, cudaStream_t s) {
  return A1 == 2 ? launch_d<VEC, 2>(SAMPLER_DGD_ARGS)
                 : launch_d<VEC, 1>(SAMPLER_DGD_ARGS);
}
#undef SAMPLER_DGD_ARGS

}  // namespace

// values int8 [P, NC]; nbr int32 [n_rows, D, A1] (this color's rows of
// cs_nbr, global positions); b1, b2, bx f32 [n_rows, D] (b2, bx null when
// A1 == 1); base f32 [n_rows]; seed int32 [2] on the device (null in the
// delta mode); TB the rows of a tile of the counter hash.  Draw mode (out
// not null): out int8 [n_rows, NC], and delta_out f32 [n_rows, NC] or
// null.  Delta mode (out null): delta_out f32 [n_rows, NC].  World-write
// mode (wmask not null): out is the world's row of the block's first row,
// wmask uint8 [n_write] the block's row mask, and row g is drawn and
// written only where g < n_write and wmask[g] != 0 (delta_out must be
// null).  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for A1 outside 1..2, D < 1, no output, a draw without a seed, a delta
// output in world-write mode, missing cross coefficients, or a counter
// tile of 2^32 (row, chain) pairs or more).
extern "C" int dm_gather_draw_launch(const void* values, int NC, int P,
                                     const void* nbr, const void* b1,
                                     const void* b2, const void* bx,
                                     const void* base, const void* seed,
                                     int n_rows, int D, int A1, int TB,
                                     void* out, void* delta_out,
                                     const void* wmask, int n_write,
                                     void* stream) {
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  if ((A1 != 1 && A1 != 2) || D < 1 || NC < 0 || n_rows < 0 || P < 1 ||
      TB < 1 || static_cast<long long>(TB) * NC > (1ll << 32) ||
      (out == nullptr && delta_out == nullptr) ||
      (out != nullptr && seed == nullptr) ||
      (wmask != nullptr && (out == nullptr || delta_out != nullptr)) ||
      (A1 == 2 && (b2 == nullptr || bx == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = NC % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(delta_out) % 16 == 0;
  const auto* v = static_cast<const int8_t*>(values);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* c2 = static_cast<const float*>(b2);
  const auto* cx = static_cast<const float*>(bx);
  const auto* bs = static_cast<const float*>(base);
  const auto* sd = static_cast<const int32_t*>(seed);
  auto* o = static_cast<int8_t*>(out);
  auto* dl = static_cast<float*>(delta_out);
  const auto* wm = static_cast<const uint8_t*>(wmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_vec<16>(A1, v, NC, P, nb, c1, c2, cx, bs, sd, n_rows,
                               D, TB, o, dl, wm, n_write, s)
              : launch_vec<1>(A1, v, NC, P, nb, c1, c2, cx, bs, sd, n_rows,
                              D, TB, o, dl, wm, n_write, s);
}
