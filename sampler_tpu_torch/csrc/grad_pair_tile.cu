// Moment-factored contrastive gradient of one color of an affine2 tier, for
// Hopper (sm_90a).
//
// Replaces: sampler_tpu/ops/grad.py, _grad_kernel / grad_pair_tile.
//
// For tile t of color c (own rows own0 + t*TB + b, b < TB) and its D*TB
// records r = d*TB + b (d-major), with sgn = +1 in the evidence world and -1
// in the free world, summed over the NC chains of each world:
//     So[b] = sum sgn*own[b]
//     Sn[r] = sum sgn*v[nbr[r]]
//     Sx[r] = sum sgn*own[b]*v[nbr[r]]
// where a neighbour outside [starts[t], starts[t] + W), or outside [0, P),
// contributes 0, and
//     out[t, w] = sum_r [wid[r] == w] * coef[r] * (ao[r]*So + an[r]*Sn + ax[r]*Sx)
// with a weight id outside [0, n_weights) adding nothing.  The caller sums
// out over the tiles and divides by NC.  The TPU kernel gathered the
// window with a one-hot matrix product on the MXU ([W, TB] products a tile,
// of which D*TB are needed) and wrote [nt, 8, 128] padded partials; here
// each needed neighbour row is read directly and the partials are [nt, W].
//
// What bounds it on the card.  Device-memory bytes: a launch at the 1024²
// Ising learning flagship (TB 128, D 5, 256 chains a world) reads the own
// rows of both worlds (268 MB), the in-window neighbour rows once (about
// 268 MB) and six 4-byte record streams (63 MB): 0.60 GB, 0.179 ms at
// 3.35 TB/s.  L2 -> SM bytes: every neighbour row is referenced by about 4
// records, mostly in other tiles, so the SMs read 1.1-1.4 GB from L2 (the
// repeats inside a tile served by L1 or not).  Instruction issue: the
// flagship variant issues 279 SASS instructions an own row (the moments
// are __dp4a, 4 a 16-byte chunk), 0.140 ms at 4 warp instructions a clock
// an SM (132 SMs, 1.98 GHz).  It takes 0.226 ms, 79% of its byte bound,
// with the SMs reading L2 at 5.0-6.2 TB/s (chip_smoke.py, NVIDIA H100
// 80GB HBM3, power limit 700 W).
//
// Design:
//   * streams staged once: each block copies its tile's D*TB records of the
//     six streams into shared memory with 16-byte cp.async (4-byte copies
//     where the slices are off the 16-byte grid), coalesced, and reads them
//     there as broadcasts.  A tile whose streams pass kStageBytes is staged
//     in groups of own rows.
//   * indices before rows: a warp takes one own row at a time; every lane
//     first reads the row's indices from shared memory and tests them
//     against the window, then issues the own chunk and all D neighbour
//     chunks of its world (16 bytes each, lanes 0..NC/16-1 the evidence
//     world, the next NC/16 lanes the free world, the pointer by a select
//     made once a tile where one pass of the lanes covers both worlds),
//     and only then any __dp4a.  The own chunk stays in registers across
//     the D records.  D = 1..kSlots is unrolled; any other D runs the same
//     code over chunks of kSlots records.
//   * moments reduced together: the 2*D integer moments (Sn, Sx of each
//     record) go through one reduce-scatter butterfly, in which each lane
//     sends its partner half of what it still holds, so that lane d ends
//     with record d's exact sums; So has its own butterfly.  At D = 5 that
//     is 23 shuffles an own row, against 55 for 2D + 1 separate
//     butterflies.  All int32, exact.
//   * coefficients on D lanes at once: lane d computes record d's value in
//     float64 in the plain version's order, coef*((ao*So + an*Sn) + ax*Sx),
//     and adds it to its own cell acc[warp][d][w] of a shared table (slot
//     d mod kSlots when D > kSlots, one chunk after another).  A cell sums
//     its records in own-row order; at the end the block sums the cells of
//     weight w over warps, then slots, in that fixed order and rounds once
//     to float32.  No atomics: two launches give the same bits, and the
//     result differs from the plain version only in float64 rounding.
//   * occupancy: 4 warps a block, at most 64 registers a thread (56 and
//     no spills in the flagship variant: 9 blocks, 36 warps an SM),
//     shared memory sized to the tile (16 KB at the flagship); a warp
//     takes every 4th own row, and blocks run in tile order, so vertically
//     adjacent tiles read their shared neighbour rows from L2 close
//     together in time.
// Window starts need not be aligned.  The byte variant (one byte a lane)
// takes chain counts that are not a multiple of 16 and worlds off the
// 16-byte grid.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWeights = 64;  // GRAD_W_MAX in ops/grad.py
constexpr int kSlots = 8;        // records reduced together; table slots
constexpr int kStreams = 6;      // nbr, wid, coef, ao, an, ax
constexpr int kStageBytes = 32768;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Chunk;
template <>
struct Chunk<16> {
  using T = int4;
};
template <>
struct Chunk<1> {
  using T = int8_t;
};

// sgn times the sum of the VEC signed bytes of x, plus s.
__device__ __forceinline__ int chunk_sum(const int4& x, int sgn, int s) {
  const int ones = sgn > 0 ? 0x01010101 : -1;  // -1: four bytes of -1
  s = __dp4a(x.x, ones, s);
  s = __dp4a(x.y, ones, s);
  s = __dp4a(x.z, ones, s);
  return __dp4a(x.w, ones, s);
}
__device__ __forceinline__ int chunk_sum(int8_t x, int sgn, int s) {
  return s + sgn * static_cast<int>(x);
}

// The dot product of the VEC signed bytes of x and y.
__device__ __forceinline__ int chunk_dot(const int4& x, const int4& y) {
  int s = __dp4a(x.x, y.x, 0);
  s = __dp4a(x.y, y.y, s);
  s = __dp4a(x.z, y.z, s);
  return __dp4a(x.w, y.w, s);
}
__device__ __forceinline__ int chunk_dot(int8_t x, int8_t y) {
  return static_cast<int>(x) * static_cast<int>(y);
}

__device__ __forceinline__ int4 load_chunk(const int8_t* p, int4) {
  return __ldg(reinterpret_cast<const int4*>(p));
}
__device__ __forceinline__ int8_t load_chunk(const int8_t* p, int8_t) {
  return __ldg(p);
}
// An own row is read once a launch: evict it first.
__device__ __forceinline__ int4 load_own(const int8_t* p, int4) {
  return __ldcs(reinterpret_cast<const int4*>(p));
}
__device__ __forceinline__ int8_t load_own(const int8_t* p, int8_t) {
  return __ldcs(p);
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Reduce-scatter of the U units (a[i], b[i]) over the warp: at the level of
// offset H each lane keeps the half of its units whose bit H matches its
// own, adds its partner's copy of that half and sends the other half.
// After the U/2, ..., 1 levels a lane holds unit lane % U, summed over the
// lanes that agree with it below bit U; the levels U, ..., 16 finish the
// sum.  Lane l then holds unit l % U in a[0], b[0].
template <int H, int U>
__device__ __forceinline__ void halve(int (&a)[U], int (&b)[U], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int sa = up ? a[i] : a[i + H];
      const int sb = up ? b[i] : b[i + H];
      const int ka = up ? a[i + H] : a[i];
      const int kb = up ? b[i + H] : b[i];
      a[i] = ka + __shfl_xor_sync(kFull, sa, H);
      b[i] = kb + __shfl_xor_sync(kFull, sb, H);
    }
    halve<H / 2, U>(a, b, lane);
  }
}
template <int U>
__device__ __forceinline__ void reduce_scatter(int (&a)[U], int (&b)[U],
                                               int lane) {
  halve<U / 2, U>(a, b, lane);
#pragma unroll
  for (int o = U; o < 32; o <<= 1) {
    a[0] += __shfl_xor_sync(kFull, a[0], o);
    b[0] += __shfl_xor_sync(kFull, b[0], o);
  }
}

struct Streams {
  const uint32_t* nbr;
  const uint32_t* wid;
  const uint32_t* coef;
  const uint32_t* ao;
  const uint32_t* an;
  const uint32_t* ax;
};

// Copy records [g0, g0 + rb) of each of the tile's nd record rows of the
// six streams to stage[s][d][0..rb): 16 bytes a copy where vec16 (every
// slice on the 16-byte grid), else 4.
__device__ __forceinline__ void stage_records(uint32_t* stage,
                                              const Streams& st, size_t rec0,
                                              int TB, int nd, int RB, int g0,
                                              int rb, bool vec16) {
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    const uint32_t* src = s == 0   ? st.nbr
                          : s == 1 ? st.wid
                          : s == 2 ? st.coef
                          : s == 3 ? st.ao
                          : s == 4 ? st.an
                                   : st.ax;
    src += rec0 + g0;
    uint32_t* dst = stage + static_cast<size_t>(s) * nd * RB;
    if (vec16) {
      const int q = rb / 4;  // copies a record row
      for (int p = threadIdx.x; p < nd * q; p += kThreads) {
        const int d = p / q;
        const int e = 4 * (p - d * q);
        cp_async16(dst + d * RB + e, src + static_cast<size_t>(d) * TB + e);
      }
    } else {
      for (int p = threadIdx.x; p < nd * rb; p += kThreads) {
        const int d = p / rb;
        const int e = p - d * rb;
        cp_async4(dst + d * RB + e, src + static_cast<size_t>(d) * TB + e);
      }
    }
  }
}

// One tile a block.  VEC: bytes a lane a chunk (16 or 1).  DS > 0: D == DS,
// unrolled; DS == 0: any D, kSlots records a step.  ONE: the 2*NC/VEC
// chunks of an own row's two worlds fit one pass of the warp's lanes.
template <int VEC, int DS, bool ONE>
__global__ void __launch_bounds__(kThreads, 8)
    grad_pair_tile_kernel(const int8_t* __restrict__ v_ev,
                          const int8_t* __restrict__ v_free, int NC, int P,
                          Streams st, const int32_t* __restrict__ starts,
                          int own0, int TB, int D, int W, int n_weights,
                          int RB, bool stage16, float* __restrict__ out) {
  using T = typename Chunk<VEC>::T;
  constexpr int CH = DS > 0 ? DS : kSlots;  // records reduced together
  constexpr int U = CH <= 1 ? 1 : CH <= 2 ? 2 : CH <= 4 ? 4 : 8;
  static_assert(CH <= kSlots, "a lane a record of a chunk");
  extern __shared__ double smem[];
  const int nd = DS > 0 ? DS : D;
  double* acc = smem;  // [kWarps][kSlots][n_weights]
  uint32_t* stage = reinterpret_cast<uint32_t*>(
      smem + kWarps * kSlots * n_weights);  // [kStreams][nd][RB]
  const uint32_t* s_nbr = stage;
  const uint32_t* s_wid = stage + static_cast<size_t>(1) * nd * RB;
  const float* s_coef = reinterpret_cast<const float*>(stage) + 2 * nd * RB;
  const float* s_ao = s_coef + nd * RB;
  const float* s_an = s_ao + nd * RB;
  const float* s_ax = s_an + nd * RB;

  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kSlots * n_weights; i += kThreads) {
    acc[i] = 0.0;
  }
  double* my_acc = acc + (warp * kSlots + (lane & (kSlots - 1))) * n_weights;

  const int start = starts[t];
  const int nchunk = NC / VEC;  // chunks of one world's row
  const int nk = 2 * nchunk;    // chunks of both worlds
  const size_t rec0 = static_cast<size_t>(t) * nd * TB;
  // where ONE, the lane's world and chunk hold for the whole tile
  const bool ev1 = lane < nchunk;
  const int8_t* const base1 =
      (ev1 ? v_ev : v_free) + (ev1 ? lane : lane - nchunk) * VEC;
  for (int g0 = 0; g0 < TB; g0 += RB) {
    const int rb = min(RB, TB - g0);
    __syncthreads();  // the table is zeroed, the last group's reads done
    stage_records(stage, st, rec0, TB, nd, RB, g0, rb, stage16);
    cp_async_wait_all();
    __syncthreads();
    const size_t orow0 =
        static_cast<size_t>(own0) + static_cast<size_t>(t) * TB + g0;
    for (int bl = warp; bl < rb; bl += kWarps) {
      const size_t orow = orow0 + bl;
      int so = 0;
      for (int d0 = 0; d0 < nd; d0 += CH) {
        // the records' indices first, tested against the window: broadcasts
        int row[CH];
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          row[i] = -1;
          if (DS > 0 || d0 + i < nd) {
            const int j = static_cast<int>(s_nbr[(d0 + i) * RB + bl]);
            if (static_cast<unsigned>(j - start) < static_cast<unsigned>(W) &&
                static_cast<unsigned>(j) < static_cast<unsigned>(P)) {
              row[i] = j;
            }
          }
        }
        int sn[U], sx[U];
#pragma unroll
        for (int i = 0; i < U; ++i) sn[i] = sx[i] = 0;
        for (int k0 = 0; k0 < (ONE ? 1 : nk); k0 += 32) {
          const int k = k0 + lane;
          const bool ev = ONE ? ev1 : k < nchunk;
          const bool live = k < nk;
          const int8_t* base =
              ONE ? base1
                  : (ev ? v_ev : v_free) + (ev ? k : k - nchunk) * VEC;
          const int sgn = ev ? 1 : -1;
          // then the own chunk and every neighbour chunk, all in flight
          T own{}, nb[CH];
          if (live) own = load_own(base + orow * NC, T{});
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            nb[i] = T{};
            if (live && row[i] >= 0) {
              nb[i] = load_chunk(base + static_cast<size_t>(row[i]) * NC, T{});
            }
          }
          if (d0 == 0) so = chunk_sum(own, sgn, so);
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            sn[i] = chunk_sum(nb[i], sgn, sn[i]);
            sx[i] += sgn * chunk_dot(own, nb[i]);
          }
        }
        if (d0 == 0) so = warp_sum(so);
        reduce_scatter<U>(sn, sx, lane);
        // lane i < CH: record d0 + i, in float64 in the plain order
        const int d = d0 + lane;
        if (lane < CH && d < nd) {
          const int r = d * RB + bl;
          const int w = static_cast<int>(s_wid[r]);
          if (static_cast<unsigned>(w) < static_cast<unsigned>(n_weights)) {
            const double v = __dmul_rn(
                static_cast<double>(s_coef[r]),
                __dadd_rn(__dadd_rn(__dmul_rn(static_cast<double>(s_ao[r]),
                                              static_cast<double>(so)),
                                    __dmul_rn(static_cast<double>(s_an[r]),
                                              static_cast<double>(sn[0]))),
                          __dmul_rn(static_cast<double>(s_ax[r]),
                                    static_cast<double>(sx[0]))));
            my_acc[w] = __dadd_rn(my_acc[w], v);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_weights; w += kThreads) {
    double s = 0.0;
    for (int q = 0; q < kWarps * kSlots; ++q) s += acc[q * n_weights + w];
    out[static_cast<size_t>(t) * n_weights + w] = static_cast<float>(s);
  }
}

struct Args {
  const int8_t* v_ev;
  const int8_t* v_free;
  int NC, P;
  Streams st;
  const int32_t* starts;
  int ntiles, own0, TB, D, W, n_weights, RB;
  bool stage16;
  size_t smem;
  float* out;
};

template <int VEC, int DS, bool ONE>
int launch_tiles(const Args& a, cudaStream_t s) {
  auto* kernel = grad_pair_tile_kernel<VEC, DS, ONE>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.ntiles, kThreads, a.smem, s>>>(
      a.v_ev, a.v_free, a.NC, a.P, a.st, a.starts, a.own0, a.TB, a.D, a.W,
      a.n_weights, a.RB, a.stage16, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <bool ONE>
int launch_wide(const Args& a, cudaStream_t s) {
#define SAMPLER_GPT_CASE(DS) \
  case DS:                   \
    return launch_tiles<16, DS, ONE>(a, s);
  switch (a.D) {
    SAMPLER_GPT_CASE(1)
    SAMPLER_GPT_CASE(2)
    SAMPLER_GPT_CASE(3)
    SAMPLER_GPT_CASE(4)
    SAMPLER_GPT_CASE(5)
    SAMPLER_GPT_CASE(6)
    SAMPLER_GPT_CASE(7)
    SAMPLER_GPT_CASE(8)
    default:
      return launch_tiles<16, 0, ONE>(a, s);
  }
#undef SAMPLER_GPT_CASE
}
static_assert(kSlots == 8, "launch_wide unrolls D = 1..8");

bool on_grid16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// v_ev, v_free int8 [P, NC]; nbr, wid int32 and coef, ao, an, ax f32
// [>= ntiles, D*TB] (this color's rows, d-major within a tile); starts int32
// [ntiles]; out f32 [ntiles, n_weights].  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for n_weights outside [1, 64], D < 0, or a
// tile whose staged records do not fit the shared memory of a block).
extern "C" int grad_pair_tile_launch(const void* v_ev, const void* v_free,
                                     int NC, int P, const void* nbr,
                                     const void* wid, const void* coef,
                                     const void* ao, const void* an,
                                     const void* ax, const void* starts,
                                     int ntiles, int own0, int TB, int D,
                                     int W, int n_weights, void* out,
                                     void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights || D < 0 || TB < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ntiles == 0 || TB == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.v_ev = static_cast<const int8_t*>(v_ev);
  a.v_free = static_cast<const int8_t*>(v_free);
  a.NC = NC;
  a.P = P;
  a.st = Streams{static_cast<const uint32_t*>(nbr),
                 static_cast<const uint32_t*>(wid),
                 static_cast<const uint32_t*>(coef),
                 static_cast<const uint32_t*>(ao),
                 static_cast<const uint32_t*>(an),
                 static_cast<const uint32_t*>(ax)};
  a.starts = static_cast<const int32_t*>(starts);
  a.ntiles = ntiles;
  a.own0 = own0;
  a.TB = TB;
  a.D = D;
  a.W = W;
  a.n_weights = n_weights;
  a.out = static_cast<float*>(out);
  // own rows a staged group: the whole tile where its records fit
  // kStageBytes, else the most that fit (a multiple of 4 where that is 4 or
  // more, so the group's slices stay on the 16-byte grid)
  const long long rec_bytes = 4LL * kStreams * (D > 0 ? D : 1);
  long long rb = kStageBytes / rec_bytes;
  if (rb >= 4) rb &= ~3LL;
  a.RB = static_cast<int>(rb >= TB ? TB : rb < 1 ? 1 : rb);
  a.smem = sizeof(double) * kWarps * kSlots * n_weights +
           static_cast<size_t>(rec_bytes) * a.RB;
  if (a.smem > 48 * 1024) {
    int dev = 0, smem_max = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&smem_max,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (a.smem > static_cast<size_t>(smem_max)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  a.stage16 = TB % 4 == 0 && a.RB % 4 == 0 && on_grid16(nbr) &&
              on_grid16(wid) && on_grid16(coef) && on_grid16(ao) &&
              on_grid16(an) && on_grid16(ax);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec16 = NC % 16 == 0 && on_grid16(v_ev) && on_grid16(v_free);
  if (!vec16) return launch_tiles<1, 0, false>(a, s);
  return 2 * (NC / 16) <= 32 ? launch_wide<true>(a, s)
                             : launch_wide<false>(a, s);
}
