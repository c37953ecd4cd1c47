// Fused multilinear color step for Hopper (sm_90a).
//
// Replaces: sampler_tpu/ops/fused.py, _dm_kernel / fused_dm_draw.
//
// For one color c of a banded boolean tier of arity <= 3 (A1 = arity - 1
// neighbour slots a record), each tile t of TB rows and each chain n:
//     delta[b, n] = base[t, b]
//                 + sum_d (b1·n1 + b2·n2 + bx·n1·n2)[t, d*TB + b]
// with n1, n2 the values of neighbour slots 0 and 1 of record (b, d), read
// through the tile's windows (see resolve_row), the b2/bx terms only when
// A1 == 2, then draws
//     out[t*TB + b, n] = u < sigmoid(delta[b, n])
// with u a 24-bit uniform from the counter hash of the TPU kernel's
// interpret mode (lowbias32 applied twice, counter b*NC + n, seed words
// seed[0] and seed[1] ^ t*0x9E3779B1), as in fused_color_draw.cu.  A
// record's term is rounded one operation at a time in the JAX kernel's
// order (no contraction into FMAs), and the terms are summed in the order
// d = 0..D-1, so delta equals the plain PyTorch version's.  The values of
// a boolean tier are 0 or 1, and the kernel reads bit 0 of each: a term
// then takes one of four values, which the kernel computes once a record
// with the plain version's formula.  The draw tests
// u * (1 + exp(-delta)) < 1 with the special-function unit's exponential
// and no division, as fused_color_draw.cu does; it can differ from the
// plain u < sigmoid(delta) only where u lies within about 1e-6 of
// sigmoid(delta).
//
// What bounds it on the card: instruction issue, then bytes.  Per color
// step it reads the other colors' rows of `values` (int8) once, the index
// and coefficient streams once, and writes one int8 per (row, chain): at
// the triple flagship (big_triple_grid(512, 512): 88,064 rows a color,
// D = 4, A1 = 2, two windows a tile, 1024 chains) 276 MB, 0.083 ms at
// 3.35 TB/s, while the 8 neighbour rows of every row come through L2
// (0.72 GB a launch).  Each (row, chain) takes the two hash rounds and the
// uniform (some 20 instructions), a table lookup, the exponential, the
// compare and the packing of the draws: its flagship variant's SASS is
// 85.5 instructions a (row, chain) (counting the single-window path it
// does not take), 0.23 ms of issue at 4 warp instructions a clock on each
// of 132 SMs at 1.98 GHz.  The kernel takes 0.246 ms there (0.522 before
// this design; chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, power limit
// 700 W; PERF.md, kernel table row 5).  The TPU kernel DMA'd Kw windows
// into VMEM and gathered both neighbour slots with a one-hot int8 matrix
// product on the MXU; a GPU reads the neighbour rows directly (from L2
// where rows of a tile share them), so that formulation is dropped.
//
// Design: each thread draws VEC consecutive chains of one row (VEC = 16:
// one 16-byte load per neighbour row and one 16-byte store, when the chain
// count and the pointers allow it; else 1).  Consecutive threads take
// consecutive chain groups of the same row, so a warp's index and
// coefficient loads are broadcasts and its row loads and stores are
// coalesced.
//   * Indices first, then rows.  The kernel is a template on D (1..kMaxD
//     unrolled; any other D runs the same code over chunks of kChunk
//     records) and on A1: a thread loads all A1*D indices and the
//     coefficients of its row, resolves the rows, then issues the A1*D
//     row loads, which are independent.
//   * A table a row.  Where a warp is one row (NC a multiple of 512) and
//     A1*D <= kTableBits, the warp builds the table of the row's delta
//     sums for all 2^(A1*D) neighbour values in shared memory, each summed
//     in the order of d, and each chain's sum is one lookup by the key its
//     A1*D bits make (one byte a chain, four chains a 32-bit word).
//     Elsewhere each record's term is a 4-way select and an add a chain.
//   * No division.  A multi-window index j (Kw >= 2) finds its window as
//     j >> log2(W) where W is a power of two, else as the high half of
//     j * ceil(2^32 / W), corrected by one.  Window starts are not
//     assumed to be aligned, and a row at or past P reads 0.
//   * ptxas gives the flagship variant 63 registers and no spills
//     (__launch_bounds__(256, 4): at most 64, 4 blocks an SM).
//   * World-write mode: the draws go straight into the world's rows of the
//     block (`out` points at the block's first row of `values`), for the
//     rows the block's resample mask selects; no other row is drawn, and
//     none past the block's length is written.  The kernel reads the world
//     while it writes it.  No real neighbour of a row lies in the block
//     being drawn (the rows of one color share no factor).  A pad slot
//     (the dummy row, a multi-window sentinel, a neighbour slot of a
//     factor of lower arity) can name any row, but its record's
//     coefficients are +0 or -0, so its four terms are one and the same
//     zero and the bit read there, old or new, cannot change a delta or a
//     table key's sum.  The table is built from coefficients only, never
//     from world rows.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kMaxD = 8;       // D = 1..kMaxD are unrolled
constexpr int kChunk = 4;      // records a step for any other D
constexpr int kTableBits = 8;  // a warp's table: at most 2^8 sums
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

// The windows of one tile, and how a multi-window index finds its window.
struct Windows {
  const int32_t* st;  // starts[t] (Kw == 1) or starts[t, 0..Kw-1]
  int st0, st1;       // the first two starts (Kw >= 2)
  int Kw, W, P;
  int shift;          // log2(W) where W is a power of two, else -1
  uint32_t magic;     // ceil(2^32 / W) where it is not
};

// The values row that index j of the tile reads, or -1 where it reads 0.
// kMulti false (Kw == 1): j is a global position inside [start,
// start + W).  kMulti true (Kw >= 2): j is remapped into the Kw windows of
// W rows laid end to end; Kw*W is the sentinel of a padded slot.
template <bool kMulti>
__device__ __forceinline__ int resolve_row(int j, const Windows& w) {
  bool in;
  int row;
  if constexpr (kMulti) {
    // window q = j / W: a shift, or the high half of j * ceil(2^32 / W)
    // corrected by one (exact for j < 2^31)
    const uint32_t u = static_cast<uint32_t>(j);
    uint32_t q = w.shift >= 0 ? u >> w.shift : __umulhi(u, w.magic);
    q -= q * static_cast<uint32_t>(w.W) > u ? 1u : 0u;
    int s = q == 0 ? w.st0 : w.st1;
    if (q >= 2 && q < static_cast<uint32_t>(w.Kw)) s = w.st[q];
    in = j >= 0 && j < w.Kw * w.W;
    row = s + static_cast<int>(u - q * static_cast<uint32_t>(w.W));
  } else {
    in = j - w.st0 >= 0 && j - w.st0 < w.W;
    row = j;
  }
  return in && row >= 0 && row < w.P ? row : -1;
}

// The rows that the CH*A1 indices idx read (-1 where they read 0).
template <int A1, int CH>
__device__ __forceinline__ void resolve_rows(int (&idx)[A1][CH],
                                             const Windows& w) {
  if (w.Kw == 1) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        idx[a][i] = resolve_row<false>(idx[a][i], w);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        idx[a][i] = resolve_row<true>(idx[a][i], w);
      }
    }
  }
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

// Rows g_begin + idx / ncv of the n_rows rows, VEC chains a thread.  DS > 0:
// D == DS, unrolled; DS == 0: any D, kChunk records a step.
template <int VEC, int DS, int A1, bool kTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_dm_draw_kernel(const int8_t* __restrict__ values, int NC, int P,
                         const int32_t* __restrict__ nbr,
                         const float* __restrict__ b1,
                         const float* __restrict__ b2,
                         const float* __restrict__ bx,
                         const float* __restrict__ base,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ seed, int g_begin,
                         int n_rows, int TB, int D, int W, int Kw, int shift,
                         uint32_t magic, int8_t* __restrict__ out,
                         float* __restrict__ delta_out,
                         const uint8_t* __restrict__ wmask, int n_write) {
  using T = typename Vec<VEC>::T;
  constexpr int CH = DS > 0 ? DS : kChunk;
  constexpr int NW = VEC == 16 ? 4 : 1;  // 32-bit words a row slice
  static_assert(!kTable || (VEC == 16 && DS > 0 && A1 * DS <= kTableBits),
                "a table variant has 16 chains a thread and D unrolled");
  __shared__ float table[kTable ? kThreads / 32 : 1]
                        [kTable ? 1 << (A1 * DS) : 1];
  const unsigned ncv = static_cast<unsigned>(NC / VEC);
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  const unsigned gl = idx / ncv;
  const int g = g_begin + static_cast<int>(gl);
  if (g >= n_rows) return;
  // world-write mode: only rows of the block that the mask selects (a warp
  // that builds a table is one row, so it leaves whole)
  if (wmask != nullptr && (g >= n_write || wmask[g] == 0)) return;
  const int lane = static_cast<int>(idx - gl * ncv);
  const int t = static_cast<int>(static_cast<unsigned>(g) /
                                 static_cast<unsigned>(TB));
  const int b = g - t * TB;
  const int nd = DS > 0 ? DS : D;
  const size_t R = static_cast<size_t>(nd) * TB;
  const int32_t* nbr_t = nbr + static_cast<size_t>(t) * A1 * R + b;
  const size_t cf0 = static_cast<size_t>(t) * R + b;
  Windows win;
  win.st = starts + static_cast<size_t>(t) * Kw;
  win.st0 = win.st[0];
  win.st1 = Kw >= 2 ? win.st[1] : 0;
  win.Kw = Kw;
  win.W = W;
  win.P = P;
  win.shift = shift;
  win.magic = magic;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int d0 = 0; d0 < nd; d0 += CH) {
    // the row's indices and coefficients first: independent broadcasts
    // (a record past D reads index -1, outside every window)
    int row[A1][CH];
    float c1[CH], c2[CH], cx[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool real = DS > 0 || d0 + i < nd;
      const size_t k = static_cast<size_t>(d0 + i) * TB;
#pragma unroll
      for (int a = 0; a < A1; ++a) {
        row[a][i] = real ? nbr_t[a * R + k] : -1;
      }
      c1[i] = real ? b1[cf0 + k] : 0.0f;
      c2[i] = A1 == 2 && real ? b2[cf0 + k] : 0.0f;
      cx[i] = A1 == 2 && real ? bx[cf0 + k] : 0.0f;
    }
    resolve_rows<A1, CH>(row, win);
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
    if constexpr (kTable) {
      // the warp's row: its table of the delta sums of all 2^(A1*D)
      // neighbour values, built in the order of d, then one lookup a chain
      float term[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        record_terms<A1>(c1[i], c2[i], cx[i], term[i]);
      }
      constexpr int kBits = A1 * CH;
      constexpr int kEntries = 1 << kBits;
      const int lane32 = static_cast<int>(threadIdx.x & 31u);
      float* tab = table[threadIdx.x >> 5];
#pragma unroll
      for (int j = 0; j < (kEntries + 31) / 32; ++j) {
        const int e = kEntries >= 32 ? lane32 | (j << 5)
                                     : lane32 & (kEntries - 1);
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int n = e >> (A1 * i);
          const float y = pick(term[i], n & 1, A1 == 2 && (n & 2));
          x = i == 0 ? y : __fadd_rn(x, y);
        }
        if (kEntries >= 32 || lane32 < kEntries) tab[e] = x;
      }
      // each chain's index: bit A1*d + a from slot a of record d
      uint32_t key[NW] = {};
#pragma unroll
      for (int i = 0; i < CH; ++i) {
#pragma unroll
        for (int a = 0; a < A1; ++a) {
          uint32_t w[NW];
          as_words(v[a][i], w);
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            key[q] |= (w[q] & 0x01010101u) << (A1 * i + a);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[e] = tab[(key[e >> 2] >> (8 * (e & 3))) & 0xFFu];
      }
    } else {
      // a 4-way select and an add a (chain, record)
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (DS == 0 && d0 + i >= nd) break;
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
  }

  const float bs = base[static_cast<size_t>(t) * TB + b];
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t tseed =
      static_cast<uint32_t>(seed[1]) ^ (static_cast<uint32_t>(t) * kKnuth);
  const uint32_t cnt0 =
      static_cast<uint32_t>(b) * static_cast<uint32_t>(NC) +
      static_cast<uint32_t>(lane * VEC);
  const size_t o = static_cast<size_t>(g) * NC + static_cast<size_t>(lane) * VEC;
  uint32_t packed[(VEC + 3) / 4] = {};
  float delta[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    delta[e] = nd > 0 ? __fadd_rn(acc[e], bs) : bs;
    const uint32_t bits = mix32(mix32((cnt0 + e) ^ s0) ^ tseed);
    const float u = static_cast<float>(bits >> 8) * 0x1p-24f + 0x1p-25f;
    // u < 1 / (1 + exp(-delta))  <=>  u * (1 + exp(-delta)) < 1
    const float x = fast_exp(-delta[e]);
    packed[e >> 2] |= (fmaf(u, x, u) < 1.0f ? 1u : 0u) << (8 * (e & 3));
  }
  if constexpr (VEC == 1) {
    out[o] = static_cast<int8_t>(packed[0]);
    if (delta_out != nullptr) delta_out[o] = delta[0];
  } else {
    T w;
    static_assert(sizeof(T) == sizeof(packed), "VEC bytes of draws");
    memcpy(&w, packed, sizeof(T));
    __stcs(reinterpret_cast<T*>(out + o), w);
    if (delta_out != nullptr) {
      float4* dp = reinterpret_cast<float4*>(delta_out + o);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        dp[q] = make_float4(delta[4 * q], delta[4 * q + 1], delta[4 * q + 2],
                            delta[4 * q + 3]);
      }
    }
  }
}

template <int VEC, int DS, int A1>
int launch_rows(const int8_t* values, int NC, int P, const int32_t* nbr,
                const float* b1, const float* b2, const float* bx,
                const float* base, const int32_t* starts,
                const int32_t* seed, int n_rows, int TB, int D, int W,
                int Kw, int shift, uint32_t magic, int8_t* out,
                float* delta_out, const uint8_t* wmask, int n_write,
                cudaStream_t s) {
  const long long ncv = NC / VEC;
  // the table variant where each warp is one row (32 | NC/16)
  constexpr bool kCanTable = VEC == 16 && DS > 0 && A1 * DS <= kTableBits;
  const bool table = kCanTable && ncv % 32 == 0;
  // rows a launch, so that its thread index stays inside 31 bits
  const long long per = INT_MAX / ncv;
  for (long long g = 0; g < n_rows; g += per) {
    const long long rows = n_rows - g < per ? n_rows - g : per;
    const long long threads = rows * ncv;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    if (table) {
      fused_dm_draw_kernel<VEC, DS, A1, kCanTable><<<blocks, kThreads, 0, s>>>(
          values, NC, P, nbr, b1, b2, bx, base, starts, seed,
          static_cast<int>(g), n_rows, TB, D, W, Kw, shift, magic, out,
          delta_out, wmask, n_write);
    } else {
      fused_dm_draw_kernel<VEC, DS, A1, false><<<blocks, kThreads, 0, s>>>(
          values, NC, P, nbr, b1, b2, bx, base, starts, seed,
          static_cast<int>(g), n_rows, TB, D, W, Kw, shift, magic, out,
          delta_out, wmask, n_write);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

#define SAMPLER_FDM_ARGS                                                     \
  values, NC, P, nbr, b1, b2, bx, base, starts, seed, n_rows, TB, D, W, Kw, \
      shift, magic, out, delta_out, wmask, n_write, s

template <int VEC, int A1>
int launch_d(const int8_t* values, int NC, int P, const int32_t* nbr,
             const float* b1, const float* b2, const float* bx,
             const float* base, const int32_t* starts, const int32_t* seed,
             int n_rows, int TB, int D, int W, int Kw, int shift,
             uint32_t magic, int8_t* out, float* delta_out,
             const uint8_t* wmask, int n_write, cudaStream_t s) {
  switch (D) {
    case 1: return launch_rows<VEC, 1, A1>(SAMPLER_FDM_ARGS);
    case 2: return launch_rows<VEC, 2, A1>(SAMPLER_FDM_ARGS);
    case 3: return launch_rows<VEC, 3, A1>(SAMPLER_FDM_ARGS);
    case 4: return launch_rows<VEC, 4, A1>(SAMPLER_FDM_ARGS);
    case 5: return launch_rows<VEC, 5, A1>(SAMPLER_FDM_ARGS);
    case 6: return launch_rows<VEC, 6, A1>(SAMPLER_FDM_ARGS);
    case 7: return launch_rows<VEC, 7, A1>(SAMPLER_FDM_ARGS);
    case 8: return launch_rows<VEC, 8, A1>(SAMPLER_FDM_ARGS);
    default: return launch_rows<VEC, 0, A1>(SAMPLER_FDM_ARGS);
  }
}
static_assert(kMaxD == 8, "launch_d unrolls D = 1..8");

template <int VEC>
int launch_vec(int A1, const int8_t* values, int NC, int P,
               const int32_t* nbr, const float* b1, const float* b2,
               const float* bx, const float* base, const int32_t* starts,
               const int32_t* seed, int n_rows, int TB, int D, int W, int Kw,
               int shift, uint32_t magic, int8_t* out, float* delta_out,
               const uint8_t* wmask, int n_write, cudaStream_t s) {
  return A1 == 2 ? launch_d<VEC, 2>(SAMPLER_FDM_ARGS)
                 : launch_d<VEC, 1>(SAMPLER_FDM_ARGS);
}
#undef SAMPLER_FDM_ARGS

}  // namespace

// values int8 [P, NC]; nbr int32 [>= ntiles, A1*D*TB] (this color's rows of
// bd_dmnbr); b1, b2, bx f32 [>= ntiles, D*TB] (b2, bx null when A1 == 1);
// base f32 [>= ntiles, TB]; starts int32 [ntiles, Kw]; seed int32 [2] on the
// device; out int8 [ntiles*TB, NC]; delta_out f32 [ntiles*TB, NC] or null.
// World-write mode (wmask not null): out is the world's row of the block's
// first row, wmask uint8 [n_write] the block's row mask, and row g is drawn
// and written only where g < n_write and wmask[g] != 0 (delta_out must be
// null).  Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// A1 outside 1..2, W < 1, Kw < 1, Kw*W past an int, a delta output in
// world-write mode, or rows whose index would not fit an int).
extern "C" int fused_dm_draw_launch(const void* values, int NC, int P,
                                    const void* nbr, const void* b1,
                                    const void* b2, const void* bx,
                                    const void* base, const void* starts,
                                    const void* seed, int ntiles, int TB,
                                    int D, int A1, int W, int Kw, void* out,
                                    void* delta_out, const void* wmask,
                                    int n_write, void* stream) {
  const long long n_rows = static_cast<long long>(ntiles) * TB;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  if ((A1 != 1 && A1 != 2) || W < 1 || Kw < 1 || D < 0 || NC < 0 ||
      static_cast<long long>(Kw) * W > INT_MAX ||
      n_rows > INT_MAX - kThreads ||
      (wmask != nullptr && delta_out != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = NC % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(delta_out) % 16 == 0;
  int shift = -1;
  uint32_t magic = 0;
  if ((W & (W - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < W) ++shift;
  } else {
    magic = static_cast<uint32_t>(((1ull << 32) + W - 1) / W);
  }
  const auto* v = static_cast<const int8_t*>(values);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* c2 = static_cast<const float*>(b2);
  const auto* cx = static_cast<const float*>(bx);
  const auto* bs = static_cast<const float*>(base);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* sd = static_cast<const int32_t*>(seed);
  auto* o = static_cast<int8_t*>(out);
  auto* dl = static_cast<float*>(delta_out);
  const auto* wm = static_cast<const uint8_t*>(wmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_rows);
  return wide ? launch_vec<16>(A1, v, NC, P, nb, c1, c2, cx, bs, st, sd, n,
                               TB, D, W, Kw, shift, magic, o, dl, wm,
                               n_write, s)
              : launch_vec<1>(A1, v, NC, P, nb, c1, c2, cx, bs, st, sd, n,
                              TB, D, W, Kw, shift, magic, o, dl, wm,
                              n_write, s);
}
