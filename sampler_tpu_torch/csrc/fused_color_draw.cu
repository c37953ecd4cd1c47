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
// seed[0] and seed[1] ^ t*0x9E3779B1).  So this kernel, its plain PyTorch
// version and the JAX kernel in interpret mode draw the same bits.
//
// What bounds it on the card: bytes.  Per color step it reads the other
// color's rows of `values` (int8) once, the nbr/beta/base streams once, and
// writes one int8 per (row, chain); it does about 2*D + 30 operations per
// byte written, far below the card's ratio of operations to bandwidth.  The
// TPU kernel built a beta-scaled one-hot matrix and multiplied it against a
// DMA'd window on the MXU, a trick to reach the TPU's matrix unit; a GPU
// reads the D neighbour values directly, so that formulation is dropped.
//
// Design: one thread per (row, chain), with neighbouring threads on
// neighbouring chains, so the D loads of one neighbour row by a warp are
// coalesced and the nbr/beta/base entries of a row are warp-wide broadcasts.
// Neighbour rows shared by several rows of a tile come from L2 (a tile's
// reads lie in one window of W rows).  The sum runs in f32 in the order
// d = 0..D-1.  Window starts are not assumed to be aligned.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 128;  // threads along the chain axis
constexpr int kRows = 4;      // variable rows per block

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void fused_color_draw_kernel(const int8_t* __restrict__ values,
                                        int NC,
                                        const int32_t* __restrict__ nbr,
                                        const float* __restrict__ beta,
                                        const float* __restrict__ base,
                                        const int32_t* __restrict__ starts,
                                        const int32_t* __restrict__ seed,
                                        int n_rows, int TB, int D, int W,
                                        int8_t* __restrict__ out,
                                        float* __restrict__ delta_out) {
  const int n = blockIdx.y * kChains + threadIdx.x;
  const int g = blockIdx.x * kRows + threadIdx.y;
  if (n >= NC || g >= n_rows) return;
  const int t = g / TB;
  const int b = g - t * TB;
  const int start = starts[t];
  const size_t row0 = static_cast<size_t>(t) * D * TB + b;
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) {
    const size_t k = row0 + static_cast<size_t>(d) * TB;
    const int j = nbr[k];
    const int local = j - start;
    if (local >= 0 && local < W) {
      acc += beta[k] * static_cast<float>(values[static_cast<size_t>(j) * NC + n]);
    }
  }
  const float delta = acc + base[static_cast<size_t>(t) * TB + b];

  const uint32_t tseed = static_cast<uint32_t>(seed[1]) ^
                         (static_cast<uint32_t>(t) * 0x9E3779B1u);
  const uint32_t cnt = static_cast<uint32_t>(b) * static_cast<uint32_t>(NC) +
                       static_cast<uint32_t>(n);
  const uint32_t bits =
      mix32(mix32(cnt ^ static_cast<uint32_t>(seed[0])) ^ tseed);
  const float u = static_cast<float>((bits >> 8) & 0xFFFFFFu) * 0x1p-24f + 0x1p-25f;
  const float p = 1.0f / (1.0f + expf(-delta));
  const size_t o = static_cast<size_t>(g) * NC + n;
  out[o] = u < p ? 1 : 0;
  if (delta_out != nullptr) delta_out[o] = delta;
}

}  // namespace

// values int8 [P, NC]; nbr int32 and beta f32 [>= ntiles, D*TB] (this
// color's rows, d-major within a tile); base f32 [>= ntiles, TB]; starts
// int32 [ntiles]; seed int32 [2] on the device; out int8 [ntiles*TB, NC];
// delta_out f32 [ntiles*TB, NC] or null.  Returns the cudaError_t of the
// launch.
extern "C" int fused_color_draw_launch(const void* values, int NC,
                                       const void* nbr, const void* beta,
                                       const void* base, const void* starts,
                                       const void* seed, int ntiles, int TB,
                                       int D, int W, void* out,
                                       void* delta_out, void* stream) {
  const int n_rows = ntiles * TB;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kChains, kRows);
  const dim3 grid((n_rows + kRows - 1) / kRows, (NC + kChains - 1) / kChains);
  fused_color_draw_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(values), NC,
      static_cast<const int32_t*>(nbr), static_cast<const float*>(beta),
      static_cast<const float*>(base), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(seed), n_rows, TB, D, W,
      static_cast<int8_t*>(out), static_cast<float*>(delta_out));
  return static_cast<int>(cudaGetLastError());
}
