// Banded gather for Hopper (sm_90a).
//
// Replaces: sampler_tpu/ops/banded.py, _band_kernel / banded_gather_pallas.
//
// Computes, for each tile t of R gathered rows and each chain n,
//     out[t*R + r, n] = values[nbr[t, r], n]   if starts[t] <= nbr[t, r] < starts[t] + W
//                     = 0                      otherwise.
// The index outside the window is how the sampler marks a padded slot (the
// dummy position P-1); window starts are not always 256-aligned, since the
// planner clips the last windows to P - W.
//
// What bounds it on the card: bytes.  It does no arithmetic; it reads each
// needed row of `values` (int8 [P, NC]) and the int32 index stream, and
// writes R*NC int8 per tile.  The TPU kernel made the gather a one-hot
// matrix product so that it ran on the MXU instead of the TPU's slow row
// gather; a GPU gathers rows directly, so that formulation is dropped.
//
// Design: one thread per (row, chain), with neighbouring threads on
// neighbouring chains, so the loads of one values row by a warp are one
// coalesced segment and the store of one output row is too.  A tile's
// neighbours lie in one window of W rows, so rows read by several gathered
// rows are served from L2.  Each thread reads its index once; all threads of
// a warp read the same index (a broadcast).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 128;  // threads along the chain axis
constexpr int kRows = 4;      // gathered rows per block

__global__ void banded_gather_kernel(const int8_t* __restrict__ values,
                                     int NC,
                                     const int32_t* __restrict__ nbr,
                                     const int32_t* __restrict__ starts,
                                     int n_rows, int R, int W,
                                     int8_t* __restrict__ out) {
  const int n = blockIdx.y * kChains + threadIdx.x;
  const int g = blockIdx.x * kRows + threadIdx.y;
  if (n >= NC || g >= n_rows) return;
  const int j = nbr[g];
  const int local = j - starts[g / R];
  int8_t v = 0;
  if (local >= 0 && local < W) v = values[static_cast<size_t>(j) * NC + n];
  out[static_cast<size_t>(g) * NC + n] = v;
}

}  // namespace

// values int8 [P, NC]; nbr int32 [ntiles, R]; starts int32 [ntiles];
// out int8 [ntiles*R, NC].  Returns the cudaError_t of the launch.
extern "C" int banded_gather_launch(const void* values, int NC,
                                    const void* nbr, const void* starts,
                                    int ntiles, int R, int W, void* out,
                                    void* stream) {
  const int n_rows = ntiles * R;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kChains, kRows);
  const dim3 grid((n_rows + kRows - 1) / kRows, (NC + kChains - 1) / kChains);
  banded_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(values), NC,
      static_cast<const int32_t*>(nbr), static_cast<const int32_t*>(starts),
      n_rows, R, W, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
