// Banded gather for Hopper (sm_90a).
//
// Replaces: sampler_tpu/ops/banded.py, _band_kernel / banded_gather_pallas.
//
// Computes, for each tile t of R gathered rows and each chain n,
//     out[t*R + r, n] = values[nbr[t, r], n]   if starts[t] <= nbr[t, r] < starts[t] + W
//                     = 0                      otherwise.
// The index outside the window is how the sampler marks a padded slot (the
// dummy position P-1); window starts are not always 256-aligned, since the
// planner clips the last windows to P - W.  The TPU kernel made the gather
// a one-hot matrix product so that it ran on the MXU instead of the TPU's
// slow row gather; a GPU gathers rows directly, so that formulation is
// dropped.
//
// What bounds it on the card: bytes.  It does no arithmetic; it reads each
// needed row of `values` (int8 [P, NC]) and the int32 index stream, and
// writes R*NC int8 per tile.  At the 1024² Ising flagship (4096 tiles of
// 640 rows, 512 chains) that is 1.62 GB, 0.484 ms at 3.35 TB/s, and the
// 1.34 GB written is most of it.  The kernel takes 0.559 ms there
// (2.90 TB/s; index_select takes 1.58 ms; chip_smoke.py, NVIDIA H100 80GB
// HBM3, power limit 700 W).  One byte a thread cannot keep enough bytes in
// flight to reach that rate; 16 bytes and several rows a thread can.
//
// Design: each thread copies VEC consecutive chains (VEC = 16: one 16-byte
// load and one 16-byte store, when the chain count and the pointers allow
// it; else 1) of kRows consecutive gathered rows.  It loads the kRows
// indices and window starts first, then issues the kRows row loads, which
// are independent, and only then stores.  Consecutive threads take
// consecutive chain groups of the same rows, so a warp's index reads are
// broadcasts and its row loads and stores are coalesced (at 512 chains a
// warp moves one whole 512-byte row per instruction).  The grid runs rows
// in order, tile after tile, so the blocks resident at one time read
// neighbouring windows and rows read again come from L2; the output is
// stored with the evict-first hint so that it does not push them out.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // gathered rows a thread

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

// Gathered rows from g_begin on, as far as the grid reaches (below n_rows).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    banded_gather_kernel(const int8_t* __restrict__ values, int NC,
                         const int32_t* __restrict__ nbr,
                         const int32_t* __restrict__ starts, int g_begin,
                         int n_rows, int R, int W, int8_t* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const unsigned ncv = static_cast<unsigned>(NC / VEC);
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  const unsigned grp = idx / ncv;
  const int lane = static_cast<int>(idx - grp * ncv);
  const int g0 = g_begin + static_cast<int>(grp) * kRows;
  if (g0 >= n_rows) return;
  // indices first: kRows independent broadcasts
  int t = g0 / R;
  int r = g0 - t * R;
  int row[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row[i] = -1;
    if (g0 + i < n_rows) {
      const int j = nbr[g0 + i];
      const int local = j - starts[t];
      if (local >= 0 && local < W) row[i] = j;
    }
    if (++r == R) {
      r = 0;
      ++t;
    }
  }
  // then the row loads, all in flight before the first store
  T v[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    v[i] = T{};
    if (row[i] >= 0) {
      v[i] = __ldg(reinterpret_cast<const T*>(
                       values + static_cast<size_t>(row[i]) * NC) +
                   lane);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (g0 + i < n_rows) {
      T* o = reinterpret_cast<T*>(out + static_cast<size_t>(g0 + i) * NC) +
             lane;
      if constexpr (VEC == 16) {
        __stcs(o, v[i]);
      } else {
        *o = v[i];
      }
    }
  }
}

template <int VEC>
int launch_rows(const int8_t* values, int NC, const int32_t* nbr,
                const int32_t* starts, int n_rows, int R, int W, int8_t* out,
                cudaStream_t s) {
  const long long ncv = NC / VEC;
  // rows a launch, so that its thread index stays inside 31 bits
  const long long per = INT_MAX / ncv * kRows;
  for (long long g = 0; g < n_rows; g += per) {
    const long long rows = n_rows - g < per ? n_rows - g : per;
    const long long threads = (rows + kRows - 1) / kRows * ncv;
    banded_gather_kernel<VEC>
        <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
           kThreads, 0, s>>>(values, NC, nbr, starts, static_cast<int>(g),
                             n_rows, R, W, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// values int8 [P, NC]; nbr int32 [ntiles, R]; starts int32 [ntiles];
// out int8 [ntiles*R, NC].  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for gathered rows whose index would not fit an
// int).
extern "C" int banded_gather_launch(const void* values, int NC,
                                    const void* nbr, const void* starts,
                                    int ntiles, int R, int W, void* out,
                                    void* stream) {
  const long long n_rows = static_cast<long long>(ntiles) * R;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  if (n_rows > INT_MAX - kRows * kThreads || NC < 0 || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = NC % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* v = static_cast<const int8_t*>(values);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<int8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_rows);
  return wide ? launch_rows<16>(v, NC, nb, st, n, R, W, o, s)
              : launch_rows<1>(v, NC, nb, st, n, R, W, o, s);
}
