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
// seed[0] and seed[1] ^ t*0x9E3779B1), as in fused_color_draw.cu.  The
// products and sums are rounded one at a time in the JAX kernel's order
// (no contraction into FMAs), so the delta equals the plain PyTorch
// version's.
//
// What bounds it on the card: bytes, with the operations close behind.  Per
// color step it reads the other colors' rows of `values` (int8) once, the
// index and coefficient streams once, and writes one int8 per (row, chain);
// it does about 7*D + 28 operations per byte written.  The TPU kernel DMA'd
// Kw windows into VMEM and gathered both neighbour slots with a one-hot
// int8 matrix product on the MXU; a GPU reads the neighbour rows directly
// (from L2 where rows of a tile share them), so that formulation is dropped.
//
// Design: each thread draws VEC consecutive chains of one row (VEC = 16,
// one 16-byte load per neighbour row and one 16-byte store, when the chain
// count and the pointers allow it; else 1).  Consecutive threads take
// consecutive chain groups of the same row, so a warp's row loads are
// coalesced and its index and coefficient loads are broadcasts.  Window
// starts are not assumed to be aligned, and a row at or past P reads 0.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The values row that index j of tile t reads, or -1 where it reads 0.
// Kw == 1: j is a global position inside [start, start + W).  Kw >= 2: j is
// remapped into the Kw windows of W rows laid end to end; Kw*W is the
// sentinel of a padded slot.
__device__ __forceinline__ long long resolve_row(int j,
                                                 const int32_t* st_t,
                                                 int Kw, int W, int P) {
  long long row;
  if (Kw == 1) {
    const int local = j - st_t[0];
    if (local < 0 || local >= W) return -1;
    row = j;
  } else {
    if (j < 0 || j >= Kw * W) return -1;
    const int k = j / W;
    row = static_cast<long long>(st_t[k]) + (j - k * W);
  }
  return (row >= 0 && row < P) ? row : -1;
}

template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ values,
                                         int NC, long long row, int lane,
                                         float (&v)[VEC]) {
  if (row < 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.0f;
    return;
  }
  const int8_t* p = values + row * NC + static_cast<long long>(lane) * VEC;
  if constexpr (VEC == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = static_cast<float>(b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = static_cast<float>(p[i]);
  }
}

template <int VEC, int A1>
__global__ void fused_dm_draw_kernel(
    const int8_t* __restrict__ values, int NC, int P,
    const int32_t* __restrict__ nbr, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ bx,
    const float* __restrict__ base, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ seed, long long n_rows, int TB, int D, int W,
    int Kw, int8_t* __restrict__ out, float* __restrict__ delta_out) {
  const int ncv = NC / VEC;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n_rows * ncv) return;
  const long long g = idx / ncv;
  const int lane = static_cast<int>(idx - g * ncv);
  const long long t = g / TB;
  const int b = static_cast<int>(g - t * TB);
  const long long R = static_cast<long long>(D) * TB;
  const int32_t* nbr_t = nbr + t * A1 * R;
  const int32_t* st_t = starts + t * Kw;

  float acc[VEC];
  float n1[VEC];
  float n2[VEC];
  for (int d = 0; d < D; ++d) {
    const long long k = static_cast<long long>(d) * TB + b;
    const float c1 = b1[t * R + k];
    load_row<VEC>(values, NC, resolve_row(nbr_t[k], st_t, Kw, W, P), lane,
                  n1);
    float c2 = 0.0f, cx = 0.0f;
    if constexpr (A1 == 2) {
      c2 = b2[t * R + k];
      cx = bx[t * R + k];
      load_row<VEC>(values, NC, resolve_row(nbr_t[R + k], st_t, Kw, W, P),
                    lane, n2);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float contrib = __fmul_rn(c1, n1[i]);
      if constexpr (A1 == 2) {
        contrib = __fadd_rn(contrib, __fmul_rn(c2, n2[i]));
        contrib = __fadd_rn(contrib, __fmul_rn(cx, __fmul_rn(n1[i], n2[i])));
      }
      acc[i] = d == 0 ? contrib : __fadd_rn(acc[i], contrib);
    }
  }
  const float bias = base[t * TB + b];
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t tseed = static_cast<uint32_t>(seed[1]) ^
                         (static_cast<uint32_t>(t) * 0x9E3779B1u);
  const int n0 = lane * VEC;
  alignas(16) int8_t drawn[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float delta = D > 0 ? __fadd_rn(acc[i], bias) : bias;
    const uint32_t cnt = static_cast<uint32_t>(b) * static_cast<uint32_t>(NC) +
                         static_cast<uint32_t>(n0 + i);
    const uint32_t bits = mix32(mix32(cnt ^ s0) ^ tseed);
    const float u =
        static_cast<float>((bits >> 8) & 0xFFFFFFu) * 0x1p-24f + 0x1p-25f;
    const float p = 1.0f / (1.0f + expf(-delta));
    drawn[i] = u < p ? 1 : 0;
    if (delta_out != nullptr) delta_out[g * NC + n0 + i] = delta;
  }
  int8_t* o = out + g * NC + n0;
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(drawn);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = drawn[i];
  }
}

template <int VEC>
cudaError_t launch_vec(int A1, dim3 grid, cudaStream_t s,
                       const int8_t* values, int NC, int P,
                       const int32_t* nbr, const float* b1, const float* b2,
                       const float* bx, const float* base,
                       const int32_t* starts, const int32_t* seed,
                       long long n_rows, int TB, int D, int W, int Kw,
                       int8_t* out, float* delta_out) {
  if (A1 == 2) {
    fused_dm_draw_kernel<VEC, 2><<<grid, kThreads, 0, s>>>(
        values, NC, P, nbr, b1, b2, bx, base, starts, seed, n_rows, TB, D, W,
        Kw, out, delta_out);
  } else {
    fused_dm_draw_kernel<VEC, 1><<<grid, kThreads, 0, s>>>(
        values, NC, P, nbr, b1, b2, bx, base, starts, seed, n_rows, TB, D, W,
        Kw, out, delta_out);
  }
  return cudaGetLastError();
}

}  // namespace

// values int8 [P, NC]; nbr int32 [>= ntiles, A1*D*TB] (this color's rows of
// bd_dmnbr); b1, b2, bx f32 [>= ntiles, D*TB] (b2, bx null when A1 == 1);
// base f32 [>= ntiles, TB]; starts int32 [ntiles, Kw]; seed int32 [2] on the
// device; out int8 [ntiles*TB, NC]; delta_out f32 [ntiles*TB, NC] or null.
// Returns the cudaError_t of the launch.
extern "C" int fused_dm_draw_launch(const void* values, int NC, int P,
                                    const void* nbr, const void* b1,
                                    const void* b2, const void* bx,
                                    const void* base, const void* starts,
                                    const void* seed, int ntiles, int TB,
                                    int D, int A1, int W, int Kw, void* out,
                                    void* delta_out, void* stream) {
  const long long n_rows = static_cast<long long>(ntiles) * TB;
  if (n_rows == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  if (A1 != 1 && A1 != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = NC % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads = n_rows * (wide ? NC / 16 : NC);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  const cudaError_t err =
      wide ? launch_vec<16>(A1, grid, s, v, NC, P, nb, c1, c2, cx, bs, st, sd,
                            n_rows, TB, D, W, Kw, o, dl)
           : launch_vec<1>(A1, grid, s, v, NC, P, nb, c1, c2, cx, bs, st, sd,
                           n_rows, TB, D, W, Kw, o, dl);
  return static_cast<int>(err);
}
