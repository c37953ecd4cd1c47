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
// where a neighbour outside [starts[t], starts[t] + W) contributes 0, and
//     out[t, w] = sum_r [wid[r] == w] * coef[r] * (ao[r]*So + an[r]*Sn + ax[r]*Sx).
// The caller sums out over the tiles and divides by NC.
//
// What bounds it on the card: bytes.  A launch reads the color's own rows of
// both worlds, the other color's rows of both worlds (each neighbour row is
// shared by several records and comes from L1/L2 after its first read) and
// six 4-byte streams over the records; the moments are int8 dot products,
// a few operations per byte read.
//
// Design: one block of kWarps warps per tile; a warp takes one own row at a
// time and reads the two worlds' rows through two pointers (no concatenated
// [P, 2NC] copy), 16 bytes a lane when NC is a multiple of 16 and both worlds
// are 16-byte aligned (at NC = 256 the 32 lanes cover both rows in one load
// each), else one byte a lane.  The moments are counted in int32 with
// __dp4a and reduced across the warp with shuffles; only the coefficient
// arithmetic is floating point.  The TPU kernel gathered the window with a
// one-hot matrix product on the MXU and wrote [nt, 8, 128] padded partials;
// here the neighbour row is read directly and the partials are [nt, W].
// Each warp adds its records' values in float64 to its own row of a
// shared-memory table (lane 0, in record order), and the block sums the
// warps' rows in a fixed order: no float atomics, so the result does not
// change from run to run.  Window starts are not assumed to be aligned.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxWeights = 64;  // GRAD_W_MAX in ops/grad.py

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of the VEC signed bytes at p.
template <int VEC>
__device__ __forceinline__ int chunk_sum(const int8_t* p) {
  if constexpr (VEC == 16) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    int s = __dp4a(x.x, 0x01010101, 0);
    s = __dp4a(x.y, 0x01010101, s);
    s = __dp4a(x.z, 0x01010101, s);
    return __dp4a(x.w, 0x01010101, s);
  } else {
    return static_cast<int>(__ldg(p));
  }
}

// Dot product of the VEC signed bytes at p and at q.
template <int VEC>
__device__ __forceinline__ int chunk_dot(const int8_t* p, const int8_t* q) {
  if constexpr (VEC == 16) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    const int4 y = __ldg(reinterpret_cast<const int4*>(q));
    int s = __dp4a(x.x, y.x, 0);
    s = __dp4a(x.y, y.y, s);
    s = __dp4a(x.z, y.z, s);
    return __dp4a(x.w, y.w, s);
  } else {
    return static_cast<int>(__ldg(p)) * static_cast<int>(__ldg(q));
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    grad_pair_tile_kernel(const int8_t* __restrict__ v_ev,
                          const int8_t* __restrict__ v_free, int NC, int P,
                          const int32_t* __restrict__ nbr,
                          const int32_t* __restrict__ wid,
                          const float* __restrict__ coef,
                          const float* __restrict__ ao,
                          const float* __restrict__ an,
                          const float* __restrict__ ax,
                          const int32_t* __restrict__ starts, int own0,
                          int TB, int D, int W, int n_weights,
                          float* __restrict__ out) {
  __shared__ double acc[kWarps][kMaxWeights];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kMaxWeights; i += blockDim.x) {
    (&acc[0][0])[i] = 0.0;
  }
  __syncthreads();

  const int start = starts[t];
  const int nchunk = NC / VEC;  // chunks of one world's row
  const size_t rec0 = static_cast<size_t>(t) * D * TB;
  for (int b = warp; b < TB; b += kWarps) {
    const size_t orow = static_cast<size_t>(own0) + static_cast<size_t>(t) * TB + b;
    const int8_t* own_ev = v_ev + orow * NC;
    const int8_t* own_free = v_free + orow * NC;
    // lane k < nchunk reads the evidence world's chunk k, lane
    // nchunk <= k < 2*nchunk the free world's chunk k - nchunk
    int so = 0;
    for (int k = lane; k < 2 * nchunk; k += 32) {
      so += k < nchunk ? chunk_sum<VEC>(own_ev + k * VEC)
                       : -chunk_sum<VEC>(own_free + (k - nchunk) * VEC);
    }
    so = warp_sum(so);
    for (int d = 0; d < D; ++d) {
      const size_t r = rec0 + static_cast<size_t>(d) * TB + b;
      const int j = nbr[r];
      const int local = j - start;
      int sn = 0, sx = 0;
      if (local >= 0 && local < W && j < P) {  // the same for the whole warp
        const int8_t* nb_ev = v_ev + static_cast<size_t>(j) * NC;
        const int8_t* nb_free = v_free + static_cast<size_t>(j) * NC;
        for (int k = lane; k < 2 * nchunk; k += 32) {
          if (k < nchunk) {
            sn += chunk_sum<VEC>(nb_ev + k * VEC);
            sx += chunk_dot<VEC>(own_ev + k * VEC, nb_ev + k * VEC);
          } else {
            const int kk = (k - nchunk) * VEC;
            sn -= chunk_sum<VEC>(nb_free + kk);
            sx -= chunk_dot<VEC>(own_free + kk, nb_free + kk);
          }
        }
        sn = warp_sum(sn);
        sx = warp_sum(sx);
      }
      const int w = wid[r];
      if (lane == 0 && w >= 0 && w < n_weights) {
        acc[warp][w] += static_cast<double>(coef[r]) *
                        (static_cast<double>(ao[r]) * so +
                         static_cast<double>(an[r]) * sn +
                         static_cast<double>(ax[r]) * sx);
      }
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_weights; w += blockDim.x) {
    double s = 0.0;
    for (int q = 0; q < kWarps; ++q) s += acc[q][w];
    out[static_cast<size_t>(t) * n_weights + w] = static_cast<float>(s);
  }
}

}  // namespace

// v_ev, v_free int8 [P, NC]; nbr, wid int32 and coef, ao, an, ax f32
// [>= ntiles, D*TB] (this color's rows, d-major within a tile); starts int32
// [ntiles]; out f32 [ntiles, n_weights].  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for n_weights outside [1, 64]).
extern "C" int grad_pair_tile_launch(const void* v_ev, const void* v_free,
                                     int NC, int P, const void* nbr,
                                     const void* wid, const void* coef,
                                     const void* ao, const void* an,
                                     const void* ax, const void* starts,
                                     int ntiles, int own0, int TB, int D,
                                     int W, int n_weights, void* out,
                                     void* stream) {
  if (n_weights < 1 || n_weights > kMaxWeights) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ntiles == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec16 = NC % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_ev) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_free) % 16 == 0;
  const dim3 grid(ntiles), block(kWarps * 32);
#define GRAD_ARGS                                                            \
  static_cast<const int8_t*>(v_ev), static_cast<const int8_t*>(v_free), NC,  \
      P, static_cast<const int32_t*>(nbr), static_cast<const int32_t*>(wid), \
      static_cast<const float*>(coef), static_cast<const float*>(ao),        \
      static_cast<const float*>(an), static_cast<const float*>(ax),          \
      static_cast<const int32_t*>(starts), own0, TB, D, W, n_weights,        \
      static_cast<float*>(out)
  if (vec16) {
    grad_pair_tile_kernel<16><<<grid, block, 0, s>>>(GRAD_ARGS);
  } else {
    grad_pair_tile_kernel<1><<<grid, block, 0, s>>>(GRAD_ARGS);
  }
#undef GRAD_ARGS
  return static_cast<int>(cudaGetLastError());
}
