// Fused affine color step for Hopper (sm_90a).
//
// Replaces: sampler_tpu/ops/fused.py, _fused_kernel / fused_color_draw.
//
// For one color c of a pairwise all-boolean tier, each tile t of TB rows and
// each chain n:
//     delta[b, n] = base[t, b] + sum_d beta[t, d*TB + b] * values[nbr[t, d*TB + b], n]
// where a neighbour outside the tile's window [starts[t], starts[t] + W)
// contributes 0, then draws
//     out[t*TB + b, n] = u < sigmoid(delta[b, n])
// with u a 24-bit uniform from the counter hash of the TPU kernel's
// interpret mode (lowbias32 applied twice, counter b*NC + n, seed words
// seed[0] and seed[1] ^ t*0x9E3779B1), so this kernel, its plain PyTorch
// version and the JAX kernel in interpret mode draw with the same uniforms.
// The sum runs in f32 in the order d = 0..D-1, a neighbour outside the
// window adding +0.0f as in the plain version; each term is one FMA, which
// equals the plain version's rounded product and sum whenever beta * value
// is exact, so always on the sampler's 0/1 worlds.  The draw tests
// u * (1 + exp(-delta)) < 1 with the fast exponential (__expf) and no
// division; it can differ from the plain u < sigmoid(delta) only where u
// lies within about 1e-6 of sigmoid(delta).  The TPU kernel built a
// beta-scaled one-hot matrix and multiplied it against a DMA'd window on
// the MXU, a trick to reach the TPU's matrix unit; a GPU reads the D
// neighbour rows directly, so that formulation is dropped.
//
// What bounds it on the card: instruction issue.  Per color step it reads
// the other color's rows of `values` (int8) once, the nbr/beta/base streams
// once, and writes one int8 per (row, chain): at the 1024² Ising flagship
// (524,288 rows, D = 5, 512 chains) 0.56 GB, 0.167 ms at 3.35 TB/s.  But
// its D = 5 variant issues 1,000 SASS instructions a thread, some 62 a
// draw: the two rounds of the hash and the uniform (about 22), D byte
// conversions and FMAs, the exponential, the compare and the packing of
// the draws.  At 4 warp instructions a clock an SM (132 SMs, 1.98 GHz)
// that alone takes 0.50 ms; the kernel takes 0.614 ms (chip_smoke.py,
// NVIDIA H100 80GB HBM3, power limit 700 W).
//
// Design: each thread draws VEC consecutive chains of one row (VEC = 16: one
// 16-byte load per neighbour row and one 16-byte store, when the chain count
// and the pointers allow it; else 1).  Consecutive threads take consecutive
// chain groups of the same row (at 512 chains one warp is one row), so a
// warp's nbr/beta/base reads are broadcasts and its row loads and stores
// are coalesced.  The kernel is a template on D (1..kMaxD unrolled; any
// other D runs the same code over chunks of kChunk neighbours): a thread
// first loads all D indices and weights of its row, then issues the D row
// loads, which are independent, so 16*D bytes are in flight a thread.  The
// grid runs rows in order, so the blocks resident at one time read
// neighbouring windows and the rows that several rows read come from L2.
//
// World-write mode: the kernel writes its draws straight into the world's
// rows of the block (`out` points at the block's first row of `values`),
// for the rows the block's resample mask selects, and draws no other row;
// the rows past the block's length are neither drawn nor written.  It
// reads the world while it writes it.  That is safe because no real
// neighbour of a row lies in the block being drawn (the rows of one color
// share no factor); a pad record can name any row, but its weight is +0 or
// -0, and beta * value is then the same zero for a value of 0 or 1, so the
// value read there, old or new, cannot change a delta.  Each thread's
// loads of its neighbour rows come before its one store.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 8;   // D = 1..kMaxD are unrolled
constexpr int kChunk = 4;  // neighbours a step for any other D
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

// The VEC signed bytes of v as floats.
template <int VEC>
__device__ __forceinline__ void to_float(const typename Vec<VEC>::T& v,
                                         float (&f)[VEC]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = static_cast<float>(b[e]);
}

// Rows g_begin + idx / ncv of the n_rows rows, VEC chains a thread.  DS > 0:
// D == DS, unrolled; DS == 0: any D, kChunk neighbours a step.
template <int VEC, int DS>
__global__ void __launch_bounds__(kThreads)
    fused_color_draw_kernel(const int8_t* __restrict__ values, int NC,
                            const int32_t* __restrict__ nbr,
                            const float* __restrict__ beta,
                            const float* __restrict__ base,
                            const int32_t* __restrict__ starts,
                            const int32_t* __restrict__ seed, int g_begin,
                            int n_rows, int TB, int D, int W,
                            int8_t* __restrict__ out,
                            float* __restrict__ delta_out,
                            const uint8_t* __restrict__ wmask, int n_write) {
  using T = typename Vec<VEC>::T;
  constexpr int CH = DS > 0 ? DS : kChunk;
  const unsigned ncv = static_cast<unsigned>(NC / VEC);
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  const unsigned gl = idx / ncv;
  const int g = g_begin + static_cast<int>(gl);
  if (g >= n_rows) return;
  // world-write mode: only rows of the block that the mask selects
  if (wmask != nullptr && (g >= n_write || wmask[g] == 0)) return;
  const int lane = static_cast<int>(idx - gl * ncv);
  const int t = static_cast<int>(static_cast<unsigned>(g) /
                                static_cast<unsigned>(TB));
  const int b = g - t * TB;
  const int nd = DS > 0 ? DS : D;
  const int start = starts[t];
  const size_t rec0 = static_cast<size_t>(t) * nd * TB + b;

  // -0.0f, so that the first term's sum is that term exactly, sign of a
  // zero included, as in the plain version
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = -0.0f;
  for (int d0 = 0; d0 < nd; d0 += CH) {
    // the row's indices and weights first: independent broadcasts.  A
    // neighbour outside the window reads 0 with weight 0, so it adds +0.0f,
    // as in the plain version, with no branch.
    int row[CH];
    float bw[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      row[i] = -1;
      bw[i] = 0.0f;
      if (DS > 0 || d0 + i < nd) {
        const size_t k = rec0 + static_cast<size_t>(d0 + i) * TB;
        const int j = nbr[k];
        const int local = j - start;
        if (local >= 0 && local < W) {
          row[i] = j;
          bw[i] = beta[k];
        }
      }
    }
    // then the neighbour rows, all in flight together
    T v[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      v[i] = T{};
      if (row[i] >= 0) {
        v[i] = __ldg(reinterpret_cast<const T*>(
                         values + static_cast<size_t>(row[i]) * NC) +
                     lane);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      float f[VEC];
      to_float<VEC>(v[i], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(bw[i], f[e], acc[e]);
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
    delta[e] = __fadd_rn(acc[e], bs);
    const uint32_t bits = mix32(mix32((cnt0 + e) ^ s0) ^ tseed);
    const float u =
        static_cast<float>((bits >> 8) & 0xFFFFFFu) * 0x1p-24f + 0x1p-25f;
    // u < 1 / (1 + exp(-delta))  <=>  u * (1 + exp(-delta)) < 1
    const float x = __expf(-delta[e]);
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

template <int VEC, int DS>
int launch_rows(const int8_t* values, int NC, const int32_t* nbr,
                const float* beta, const float* base, const int32_t* starts,
                const int32_t* seed, int n_rows, int TB, int D, int W,
                int8_t* out, float* delta_out, const uint8_t* wmask,
                int n_write, cudaStream_t s) {
  const long long ncv = NC / VEC;
  // rows a launch, so that its thread index stays inside 31 bits
  const long long per = INT_MAX / ncv;
  for (long long g = 0; g < n_rows; g += per) {
    const long long rows = n_rows - g < per ? n_rows - g : per;
    const long long threads = rows * ncv;
    fused_color_draw_kernel<VEC, DS>
        <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
           kThreads, 0, s>>>(values, NC, nbr, beta, base, starts, seed,
                             static_cast<int>(g), n_rows, TB, D, W, out,
                             delta_out, wmask, n_write);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <int VEC>
int launch_vec(const int8_t* values, int NC, const int32_t* nbr,
               const float* beta, const float* base, const int32_t* starts,
               const int32_t* seed, int n_rows, int TB, int D, int W,
               int8_t* out, float* delta_out, const uint8_t* wmask,
               int n_write, cudaStream_t s) {
#define SAMPLER_FCD_CASE(DS)                                               \
  case DS:                                                                 \
    return launch_rows<VEC, DS>(values, NC, nbr, beta, base, starts, seed, \
                                n_rows, TB, D, W, out, delta_out, wmask,   \
                                n_write, s);
  switch (D) {
    SAMPLER_FCD_CASE(1)
    SAMPLER_FCD_CASE(2)
    SAMPLER_FCD_CASE(3)
    SAMPLER_FCD_CASE(4)
    SAMPLER_FCD_CASE(5)
    SAMPLER_FCD_CASE(6)
    SAMPLER_FCD_CASE(7)
    SAMPLER_FCD_CASE(8)
    default:
      return launch_rows<VEC, 0>(values, NC, nbr, beta, base, starts, seed,
                                 n_rows, TB, D, W, out, delta_out, wmask,
                                 n_write, s);
  }
#undef SAMPLER_FCD_CASE
}
static_assert(kMaxD == 8, "launch_vec unrolls D = 1..8");

}  // namespace

// values int8 [P, NC]; nbr int32 and beta f32 [>= ntiles, D*TB] (this
// color's rows, d-major within a tile); base f32 [>= ntiles, TB]; starts
// int32 [ntiles]; seed int32 [2] on the device; out int8 [ntiles*TB, NC];
// delta_out f32 [ntiles*TB, NC] or null.  World-write mode (wmask not
// null): out is the world's row of the block's first row, wmask uint8
// [n_write] the block's row mask, and row g is drawn and written only where
// g < n_write and wmask[g] != 0 (delta_out must be null).  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for D < 1, for a delta
// output in world-write mode, or for rows whose index would not fit an
// int).
extern "C" int fused_color_draw_launch(const void* values, int NC,
                                       const void* nbr, const void* beta,
                                       const void* base, const void* starts,
                                       const void* seed, int ntiles, int TB,
                                       int D, int W, void* out,
                                       void* delta_out, const void* wmask,
                                       int n_write, void* stream) {
  const long long n_rows = static_cast<long long>(ntiles) * TB;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  if (n_rows > INT_MAX - kThreads || NC < 0 || D < 1 ||
      (wmask != nullptr && delta_out != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = NC % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(delta_out) % 16 == 0;
  const auto* v = static_cast<const int8_t*>(values);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bs = static_cast<const float*>(base);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* sd = static_cast<const int32_t*>(seed);
  auto* o = static_cast<int8_t*>(out);
  auto* dl = static_cast<float*>(delta_out);
  const auto* wm = static_cast<const uint8_t*>(wmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_rows);
  return wide ? launch_vec<16>(v, NC, nb, bt, bs, st, sd, n, TB, D, W, o, dl,
                               wm, n_write, s)
              : launch_vec<1>(v, NC, nb, bt, bs, st, sd, n, TB, D, W, o, dl,
                              wm, n_write, s);
}
