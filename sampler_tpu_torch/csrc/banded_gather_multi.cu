// Multi-window banded gather for Hopper (sm_90a).
//
// Replaces: sampler_tpu/ops/banded.py, _band_kernel_multi /
// banded_gather_pallas_multi.
//
// Computes, for each tile t of R gathered rows and each chain n,
//     out[t*R + r, n] = values[starts[t, i / W] + i % W, n]   if 0 <= i < K*W
//                     = 0                                       otherwise
// with i = rnbr[t, r], an index remapped at compile time into the K windows
// of W rows laid end to end.  The sentinel K*W marks a padded slot.  A row at
// or past P also reads 0: window starts are not assumed to be 256-aligned or
// to leave a whole window inside [0, P).
//
// What bounds it on the card: bytes.  It does no arithmetic; it reads each
// needed row of `values` (int8 [P, NC]), the int32 index stream and the
// starts, and writes R*NC int8 per tile.  The TPU kernel DMA'd the K windows
// into VMEM and gathered with a one-hot matrix product on the MXU, to avoid
// the TPU's slow row gather; a GPU reads the rows directly, so that
// formulation is dropped.  A tile's reads lie in K windows of W rows, so a
// row that several gathered rows read is served from L2.
//
// Design: each thread copies VEC consecutive chains of one gathered row
// (VEC = 16, one 16-byte load and store, when the chain count and the
// pointers allow it; else 1).  Consecutive threads take consecutive chain
// groups of the same row, so a warp's loads and stores are coalesced and
// all its threads read the same index (a broadcast).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <int VEC>
__global__ void banded_gather_multi_kernel(const int8_t* __restrict__ values,
                                           int NC, int P,
                                           const int32_t* __restrict__ rnbr,
                                           const int32_t* __restrict__ starts,
                                           long long n_rows, int R, int K,
                                           int W, int8_t* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  const int ncv = NC / VEC;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n_rows * ncv) return;
  const long long g = idx / ncv;
  const int lane = static_cast<int>(idx - g * ncv);
  const long long t = g / R;
  const int i = rnbr[g];
  T v{};
  if (i >= 0 && i < K * W) {
    const int k = i / W;
    const long long row =
        static_cast<long long>(starts[t * K + k]) + (i - k * W);
    if (row >= 0 && row < P) {
      v = reinterpret_cast<const T*>(values + row * NC)[lane];
    }
  }
  reinterpret_cast<T*>(out + g * NC)[lane] = v;
}

}  // namespace

// values int8 [P, NC]; rnbr int32 [ntiles, R]; starts int32 [ntiles, K];
// out int8 [ntiles*R, NC].  Returns the cudaError_t of the launch.
extern "C" int banded_gather_multi_launch(const void* values, int NC, int P,
                                          const void* rnbr, const void* starts,
                                          int ntiles, int R, int K, int W,
                                          void* out, void* stream) {
  const long long n_rows = static_cast<long long>(ntiles) * R;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  const bool wide = NC % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads = n_rows * (wide ? NC / 16 : NC);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int8_t*>(values);
  const auto* rn = static_cast<const int32_t*>(rnbr);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<int8_t*>(out);
  if (wide) {
    banded_gather_multi_kernel<16><<<grid, kThreads, 0, s>>>(
        v, NC, P, rn, st, n_rows, R, K, W, o);
  } else {
    banded_gather_multi_kernel<1><<<grid, kThreads, 0, s>>>(
        v, NC, P, rn, st, n_rows, R, K, W, o);
  }
  return static_cast<int>(cudaGetLastError());
}
