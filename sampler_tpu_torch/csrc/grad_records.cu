// Per-record contributions to the weight gradient for Hopper (sm_90a): one
// launch a tier, all its colors, of the chunked cs-stream gradient.
//
// Replaces: sampler_tpu/engine/multichain.py, the row-chunk body of
// mc_weight_gradient_cs (the fori_loop at :1002 of the jitted
// _learn_mc_from).  The JAX package has no Pallas kernel there: XLA fuses
// the neighbour gather, the literals, phi, the difference of the two
// worlds, the owner mask and the segment sum into one computation.  Run as
// eager PyTorch passes, the same arithmetic wrote and read about a dozen
// [rows, D, (A-1,) 2NC] temporaries a row chunk: 78% of a KBC learning
// epoch, 95% of a triple one and 96% of a Potts one (PERF.md, section 5).
//
// For each color c of one tier (B rows of D records of A slots, the slots
// permuted own-last, so slot A-1 is the row's own; the streams color-major,
// so the C * B * D records are one flat range and a record's color is its
// row's index over B), each record (c, r, d) and chain n of both worlds
// (v_ev, the evidence world, and v_free):
//   * a slot's value is the row's own value on `ismine` slots and on slots
//     >= A-1, else the world's value at the slot's neighbour position
//     nbr[r, d, a] (a position outside [0, P) reads 0, and so does an own
//     row outside it);
//   * its literal is (value == 1) == pos on all-boolean graphs, and
//     (value == eq) == pos elsewhere;
//   * nlit counts the true literals of the counted slots and head is the
//     literal of the `hmask` slot (compile marks at most one): counted are
//     the masked slots, and on all-boolean graphs only those that are own
//     or < A-1, the plain version's own-slot and neighbour-slot counts;
//     the head needs no mask there, as in the plain version;
//   * phi(nlit, head, arity, type) as potentials._phi_from_counts computes
//     it: a type outside the tier's present types is 0, and a tier with
//     one present type evaluates that type for every record;
// and then
//     out[c, r, d] = ((sum_n phi_ev - phi_free) * (1/NC)) * feat[c, r, d]
// where the owner mask gsel[c, r, d] is set, else +0.  The caller sums `out`
// per weight id (ops/weights.py segment_reduce, float64).
//
// Exactness: every phi but RATIO's log1p is a small integer, so a record's
// chain sum is an integer below 2^24 and exact in float32 in any order;
// the two multiplications are rounded one at a time, in the plain
// version's order, with 1/NC rounded to float32 first.  So on graphs
// without RATIO `out` equals the plain version's bit for bit.  RATIO sums
// log1pf values in this kernel's order and may differ in the last bits.
// The order is fixed by the launch geometry (a lane's chains in order,
// then a butterfly over the lanes of a record), so equal inputs give equal
// bytes.
//
// What bounds it on the card: the arithmetic, some 4A + 10 integer
// operations a (owner record, chain, world), at the int32 issue rate (64 a
// clock an SM); then the bytes of the world rows it gathers (A-1
// neighbour rows and the own row of each owner record, both worlds), most
// of them from L2; its streams are a few tens of bytes a record.  Records
// whose owner mask is clear (two of three records of an arity-3 factor,
// pad records) read nothing past the mask.  At the learning cells one
// gradient's launches took 1.58 ms on the KBC graph (5 launches, bound
// 0.304 ms), 1.01 on the triple grid (1, bound 0.264) and 1.63 on the
// Potts grid (1, bound 0.577): 19-35% of the bound, against 118.0, 47.3
// and 95.5 ms for a whole gradient on the eager route it replaced
// (chip_smoke.py phases 16b, 16, 9, 12; NVIDIA H100 80GB HBM3, power
// limit 700 W; PERF.md, kernel table row 9).  One launch takes all of a tier's
// colors, so a narrow tier's launch costs one host call (about 60 us)
// a gradient, not one a color.
//
// Design: a segment of L lanes (the least power of two >= the chain
// groups, at most 32) takes one record; each lane takes VEC consecutive
// chains of a group (VEC = 16 bytes of the world: 16 int8 chains or 4
// int32 ones, where the chain count and the pointers allow; else 1) and
// the groups lane, lane + L, ....  Records are independent outputs, so a
// record a segment (not a row a thread) keeps the narrow, deep tiers (hub
// chunks of 512 records, rows of 200+) as parallel as the wide ones.  A
// lane loads the record's stream bytes and indices first (broadcasts
// within the segment), then the own and neighbour rows of both worlds,
// all in flight together when the slot count is a template argument
// (A = 1, 2, 3; larger A loops over the slots).  The kernel is templated
// on the world's type (int8; int32 for cards above 127), on the eq
// stream's type (int16, int32, or none on all-boolean graphs) and on A.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// factor function codes (format_spec.py)
constexpr int kImplyNatural = 0;
constexpr int kOr = 1;
constexpr int kAnd = 2;
constexpr int kEqual = 3;
constexpr int kIsTrue = 4;
constexpr int kLinear = 7;
constexpr int kRatio = 8;
constexpr int kLogical = 9;
constexpr int kAndCategorical = 12;
constexpr int kImplyMln = 13;

// VEC chains of a world as one load
template <typename V, int VEC>
struct Load {
  using T = uint4;
};
template <typename V>
struct Load<V, 1> {
  using T = V;
};

template <typename V, int VEC>
__device__ __forceinline__ typename Load<V, VEC>::T load_group(
    const V* __restrict__ w, long long row, long long P, int NC, int grp) {
  using T = typename Load<V, VEC>::T;
  if (row < 0 || row >= P) return T{};
  return __ldg(reinterpret_cast<const T*>(w + row * NC) + grp);
}

template <typename V, int VEC>
__device__ __forceinline__ void unpack(const typename Load<V, VEC>::T& t,
                                       int (&x)[VEC]) {
  V tmp[VEC];
  static_assert(sizeof(tmp) == sizeof(t), "VEC values a load");
  memcpy(tmp, &t, sizeof(tmp));
#pragma unroll
  for (int e = 0; e < VEC; ++e) x[e] = static_cast<int>(tmp[e]);
}

// chain e of a load (an int8 world's byte sign-extended)
template <typename V, int VEC>
__device__ __forceinline__ int elem(const typename Load<V, VEC>::T& t,
                                    int e) {
  if constexpr (VEC == 1) {
    return static_cast<int>(t);
  } else {
    uint32_t w[4];
    static_assert(sizeof(w) == sizeof(t), "16 bytes a load");
    memcpy(w, &t, sizeof(w));
    if constexpr (sizeof(V) == 1) {
      return static_cast<int>(
          static_cast<int8_t>(w[e >> 2] >> (8 * (e & 3))));
    } else {
      return static_cast<int>(w[e]);
    }
  }
}

// phi from the counts, as potentials._phi_from_counts (ty < 0: 0)
__device__ __forceinline__ float phi_of(int ty, int nlit, bool head, int n) {
  const int nbody = nlit - (head ? 1 : 0);
  const int n_body = n - 1 > 0 ? n - 1 : 0;
  switch (ty) {
    case kAnd:
    case kAndCategorical:
    case kImplyNatural:
      return nlit == n ? 1.0f : 0.0f;
    case kOr:
      return nlit > 0 ? 1.0f : 0.0f;
    case kEqual:
      return nlit == 0 || nlit == n ? 1.0f : 0.0f;
    case kIsTrue:
      return head ? 1.0f : 0.0f;
    case kImplyMln:
      return nbody < n_body ? 1.0f : (head ? 1.0f : 0.0f);
    case kLinear:
    case kRatio:
    case kLogical: {
      int lin = head ? n_body : n_body - nbody;
      if (n == 1) lin = head ? 1 : 0;
      const float fl = static_cast<float>(lin);
      if (ty == kLinear) return fl;
      if (ty == kRatio) return log1pf(fl);
      return fl > 0.0f ? 1.0f : 0.0f;
    }
    default:
      return 0.0f;
  }
}

// one slot of a record: the value it compares, its flags, its row
struct Slot {
  long long row;  // the neighbour's position (unused on own slots)
  int tgt;        // 1 on all-boolean graphs, else eq
  bool own, pos, cnt, hm;
};

template <typename E, bool BOOL>
__device__ __forceinline__ Slot load_slot(
    long long rec, int a, int A, int A1, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ pos, const uint8_t* __restrict__ ismine,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ hmask,
    const E* __restrict__ eq) {
  const long long k = rec * A + a;
  const bool mine = ismine[k] != 0;
  const bool msk = mask[k] != 0;
  const bool hm = hmask[k] != 0;
  Slot s;
  s.own = mine || a >= A1;
  s.row = s.own ? -1 : static_cast<long long>(nbr[rec * A1 + a]);
  s.pos = pos[k] != 0;
  if constexpr (BOOL) {
    const bool seen = mine || a < A1;
    s.tgt = 1;
    s.cnt = msk && seen;
    s.hm = hm && seen;
  } else {
    s.tgt = static_cast<int>(eq[k]);
    s.cnt = msk;
    s.hm = hm && msk;
  }
  return s;
}

// one chain's literal of a slot, into its nlit and head
__device__ __forceinline__ void add_lit(const Slot& s, int x, int& nlit,
                                        bool& head) {
  const bool lit = (x == s.tgt) == s.pos;
  nlit += lit && s.cnt ? 1 : 0;
  head = head || (lit && s.hm);
}

// nlit and head of VEC chains from a slot's values
template <int VEC>
__device__ __forceinline__ void add_slot(const Slot& s, const int (&x)[VEC],
                                         int (&nlit)[VEC],
                                         bool (&head)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) add_lit(s, x[e], nlit[e], head[e]);
}

// AS > 0: A == AS, the slots unrolled and their rows loaded together;
// AS == 0: any A, a slot at a time
template <typename V, typename E, int VEC, int AS, bool BOOL>
__global__ void __launch_bounds__(kThreads) grad_records_kernel(
    const V* __restrict__ v_ev, const V* __restrict__ v_free, int NC,
    long long P, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ pos, const uint8_t* __restrict__ ismine,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ hmask,
    const E* __restrict__ eq, const int8_t* __restrict__ typ,
    const int16_t* __restrict__ arity, const float* __restrict__ feat,
    const uint8_t* __restrict__ gsel, long long own_base, long long cstride,
    const int32_t* __restrict__ own_idx, long long rows, long long n_rec,
    int D, int A, int present, int single, int L, float* __restrict__ out) {
  using T = typename Load<V, VEC>::T;
  const int seg = static_cast<int>(threadIdx.x) / L;
  const int sl = static_cast<int>(threadIdx.x) & (L - 1);
  const long long rec =
      static_cast<long long>(blockIdx.x) * (kThreads / L) + seg;
  if (rec >= n_rec) return;
  if (gsel[rec] == 0) {  // uniform over the segment
    if (sl == 0) out[rec] = 0.0f;
    return;
  }
  const int nA = AS > 0 ? AS : A;
  const int A1 = nA - 1;
  const long long r = rec / D;  // c * rows + the color's row
  const long long c = r / rows;
  const long long own =
      own_base + c * cstride +
      (own_idx != nullptr ? static_cast<long long>(own_idx[r])
                          : r - c * rows);
  const int t = typ[rec];
  const int ty = single >= 0 ? single
                 : (t >= 0 && t < 32 && ((present >> t) & 1)) ? t
                                                               : -1;
  const int n = arity[rec];
  const float f = feat[rec];

  constexpr int kS = AS > 0 ? AS : 1;
  Slot slot[kS];
  if constexpr (AS > 0) {
#pragma unroll
    for (int a = 0; a < AS; ++a) {
      slot[a] = load_slot<E, BOOL>(rec, a, AS, A1, nbr, pos, ismine, mask,
                                   hmask, eq);
    }
  }

  const int ncv = NC / VEC;
  float acc = 0.0f;
  for (int grp = sl; grp < ncv; grp += L) {
    const T o_ev = load_group<V, VEC>(v_ev, own, P, NC, grp);
    const T o_fr = load_group<V, VEC>(v_free, own, P, NC, grp);
    if constexpr (AS > 0) {
      // the neighbour rows of both worlds, all in flight together
      T x_ev[AS], x_fr[AS];
#pragma unroll
      for (int a = 0; a < AS; ++a) {
        x_ev[a] = slot[a].own ? o_ev
                              : load_group<V, VEC>(v_ev, slot[a].row, P, NC,
                                                   grp);
        x_fr[a] = slot[a].own ? o_fr
                              : load_group<V, VEC>(v_free, slot[a].row, P,
                                                   NC, grp);
      }
      // a chain at a time (few registers): phi_ev - phi_free, summed in
      // the order of the chains
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        int ne = 0, nf = 0;
        bool he = false, hf = false;
#pragma unroll
        for (int a = 0; a < AS; ++a) {
          add_lit(slot[a], elem<V, VEC>(x_ev[a], e), ne, he);
          add_lit(slot[a], elem<V, VEC>(x_fr[a], e), nf, hf);
        }
        acc = __fadd_rn(acc, __fsub_rn(phi_of(ty, ne, he, n),
                                       phi_of(ty, nf, hf, n)));
      }
    } else {
      int nl_ev[VEC], nl_fr[VEC];
      bool hd_ev[VEC], hd_fr[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        nl_ev[e] = nl_fr[e] = 0;
        hd_ev[e] = hd_fr[e] = false;
      }
      for (int a = 0; a < nA; ++a) {
        const Slot s = load_slot<E, BOOL>(rec, a, nA, A1, nbr, pos, ismine,
                                          mask, hmask, eq);
        const T xe = s.own ? o_ev : load_group<V, VEC>(v_ev, s.row, P, NC,
                                                       grp);
        const T xf = s.own ? o_fr : load_group<V, VEC>(v_free, s.row, P, NC,
                                                       grp);
        int x[VEC];
        unpack<V, VEC>(xe, x);
        add_slot<VEC>(s, x, nl_ev, hd_ev);
        unpack<V, VEC>(xf, x);
        add_slot<VEC>(s, x, nl_fr, hd_fr);
      }
      // the chains in order: phi_ev - phi_free, summed
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float pe = phi_of(ty, nl_ev[e], hd_ev[e], n);
        const float pf = phi_of(ty, nl_fr[e], hd_fr[e], n);
        acc = __fadd_rn(acc, __fsub_rn(pe, pf));
      }
    }
  }
  // a butterfly over the segment's lanes: every lane ends with one sum
  const unsigned lane = threadIdx.x & 31u;
  const unsigned seg_mask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane & ~(unsigned)(L - 1));
  for (int off = L / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(seg_mask, acc, off));
  }
  if (sl == 0) {
    const float inv = __frcp_rn(static_cast<float>(NC));
    out[rec] = __fmul_rn(__fmul_rn(acc, inv), f);
  }
}

#define SAMPLER_GR_ARGS                                                     \
  v_ev, v_free, NC, P, nbr, pos, ismine, mask, hmask, eq, typ, arity, feat, \
      gsel, own_base, cstride, own_idx, rows, n_rec, D, A, present, single

template <typename V, typename E, int VEC, int AS, bool BOOL>
int launch_one(const V* v_ev, const V* v_free, int NC, long long P,
               const int32_t* nbr, const uint8_t* pos,
               const uint8_t* ismine, const uint8_t* mask,
               const uint8_t* hmask, const E* eq, const int8_t* typ,
               const int16_t* arity, const float* feat, const uint8_t* gsel,
               long long own_base, long long cstride, const int32_t* own_idx,
               long long rows, long long n_rec, int D, int A, int present,
               int single, float* out, cudaStream_t s) {
  const int ncv = NC / VEC;
  int L = 1;
  while (L < ncv && L < 32) L <<= 1;
  const long long per_block = kThreads / L;
  const long long blocks = (n_rec + per_block - 1) / per_block;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  grad_records_kernel<V, E, VEC, AS, BOOL>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(SAMPLER_GR_ARGS, L,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename E, int VEC, bool BOOL>
int launch_a(const V* v_ev, const V* v_free, int NC, long long P,
             const int32_t* nbr, const uint8_t* pos, const uint8_t* ismine,
             const uint8_t* mask, const uint8_t* hmask, const E* eq,
             const int8_t* typ, const int16_t* arity, const float* feat,
             const uint8_t* gsel, long long own_base, long long cstride,
             const int32_t* own_idx, long long rows, long long n_rec, int D,
             int A, int present, int single, float* out, cudaStream_t s) {
  switch (A) {
    case 1: return launch_one<V, E, VEC, 1, BOOL>(SAMPLER_GR_ARGS, out, s);
    case 2: return launch_one<V, E, VEC, 2, BOOL>(SAMPLER_GR_ARGS, out, s);
    case 3: return launch_one<V, E, VEC, 3, BOOL>(SAMPLER_GR_ARGS, out, s);
    default: return launch_one<V, E, VEC, 0, BOOL>(SAMPLER_GR_ARGS, out, s);
  }
}

template <typename V, typename E, bool BOOL>
int launch_vec(bool wide, const V* v_ev, const V* v_free, int NC,
               long long P, const int32_t* nbr, const uint8_t* pos,
               const uint8_t* ismine, const uint8_t* mask,
               const uint8_t* hmask, const E* eq, const int8_t* typ,
               const int16_t* arity, const float* feat, const uint8_t* gsel,
               long long own_base, long long cstride, const int32_t* own_idx,
               long long rows, long long n_rec, int D, int A, int present,
               int single, float* out, cudaStream_t s) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(V));
  return wide ? launch_a<V, E, kWide, BOOL>(SAMPLER_GR_ARGS, out, s)
              : launch_a<V, E, 1, BOOL>(SAMPLER_GR_ARGS, out, s);
}

template <typename V>
int launch_eq(bool wide, int eq_bytes, const V* v_ev, const V* v_free,
              int NC, long long P, const int32_t* nbr, const uint8_t* pos,
              const uint8_t* ismine, const uint8_t* mask,
              const uint8_t* hmask, const void* eq_p, const int8_t* typ,
              const int16_t* arity, const float* feat, const uint8_t* gsel,
              long long own_base, long long cstride, const int32_t* own_idx,
              long long rows, long long n_rec, int D, int A, int present,
              int single, float* out, cudaStream_t s) {
  if (eq_bytes == 2) {
    const auto* eq = static_cast<const int16_t*>(eq_p);
    return launch_vec<V, int16_t, false>(wide, SAMPLER_GR_ARGS, out, s);
  }
  const auto* eq = static_cast<const int32_t*>(eq_p);
  return launch_vec<V, int32_t, false>(wide, SAMPLER_GR_ARGS, out, s);
}
#undef SAMPLER_GR_ARGS

}  // namespace

// v_ev, v_free [P, NC] of int8 (value_bytes 1) or int32 (4): the two
// worlds; the tier's streams, color-major: nbr int32 [C, B, D, A-1]
// (global positions), pos, ismine, mask, hmask bool [C, B, D, A], eq
// [C, B, D, A] of int16 (eq_bytes 2) or int32 (4), or null with eq_bytes 0
// on all-boolean graphs (int8 worlds only), typ int8, arity int16, feat
// f32, gsel bool, each [C, B, D]; row r of color c has its own value at
// position own_base + c * color_stride + own_idx[c, r] (own_idx int32
// [C, B]) or own_base + c * color_stride + r (own_idx null); present the
// tier's factor types as a bit mask (bit t: type t) and single the one
// type when there is only one, else -1.  Writes out f32 [C, B, D].
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for A < 1,
// D < 1, an unknown value or eq width, or an eq stream missing or given
// where it does not belong).
extern "C" int grad_records_launch(
    const void* v_ev, const void* v_free, int value_bytes, int NC,
    long long P, const void* nbr, const void* pos, const void* ismine,
    const void* mask, const void* hmask, const void* eq, int eq_bytes,
    const void* typ, const void* arity, const void* feat, const void* gsel,
    long long own_base, long long color_stride, const void* own_idx, int C,
    int B, int D, int A, int present, int single, void* out, void* stream) {
  if (B == 0 || C == 0) return static_cast<int>(cudaSuccess);
  if (A < 1 || D < 1 || B < 0 || C < 0 || NC < 1 || P < 1 ||
      color_stride < 0 || (value_bytes != 1 && value_bytes != 4) ||
      (eq_bytes != 0 && eq_bytes != 2 && eq_bytes != 4) ||
      (eq_bytes == 0) != (eq == nullptr) ||
      (eq_bytes == 0 && value_bytes != 1) || (A > 1 && nbr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = (static_cast<long long>(NC) * value_bytes) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_ev) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_free) % 16 == 0;
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* ps = static_cast<const uint8_t*>(pos);
  const auto* im = static_cast<const uint8_t*>(ismine);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* hm = static_cast<const uint8_t*>(hmask);
  const auto* ty = static_cast<const int8_t*>(typ);
  const auto* ar = static_cast<const int16_t*>(arity);
  const auto* ft = static_cast<const float*>(feat);
  const auto* gs = static_cast<const uint8_t*>(gsel);
  const auto* oi = static_cast<const int32_t*>(own_idx);
  auto* o = static_cast<float*>(out);
  const long long rows = B;
  const long long n_rec = static_cast<long long>(C) * B * D;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4) {
    const auto* ve = static_cast<const int32_t*>(v_ev);
    const auto* vf = static_cast<const int32_t*>(v_free);
    return launch_eq<int32_t>(wide, eq_bytes, ve, vf, NC, P, nb, ps, im, mk,
                              hm, eq, ty, ar, ft, gs, own_base, color_stride,
                              oi, rows, n_rec, D, A, present, single, o, s);
  }
  const auto* ve = static_cast<const int8_t*>(v_ev);
  const auto* vf = static_cast<const int8_t*>(v_free);
  if (eq_bytes == 0) {
    return launch_vec<int8_t, int16_t, true>(
        wide, ve, vf, NC, P, nb, ps, im, mk, hm, nullptr, ty, ar, ft, gs,
        own_base, color_stride, oi, rows, n_rec, D, A, present, single, o,
        s);
  }
  return launch_eq<int8_t>(wide, eq_bytes, ve, vf, NC, P, nb, ps, im, mk, hm,
                           eq, ty, ar, ft, gs, own_base, color_stride, oi,
                           rows, n_rec, D, A, present, single, o, s);
}
