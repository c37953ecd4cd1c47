// The weight gradient's records route for Hopper (sm_90a): the owner
// records' terms of every tier the route takes in one launch, then their
// sums by weight on the card.
//
// Replaces: sampler_tpu/engine/multichain.py, the row-chunk body of
// mc_weight_gradient_cs (the fori_loop at :1002 of the jitted
// _learn_mc_from).  The JAX package has no Pallas kernel there: XLA fuses
// the neighbour gather, the literals, phi, the difference of the two
// worlds, the owner mask and the segment sum into one computation.
//
// For each owner record (c, r, d) of a tier (B rows of D records of A
// slots, the slots permuted own-last, so slot A-1 is the row's own) and
// chain n of both worlds (v_ev, the evidence world, and v_free):
//   * a slot's value is the row's own value on `ismine` slots and on slots
//     >= A-1, else the world's value at the slot's neighbour position (a
//     position outside [0, P) reads 0, and so does an own row outside it);
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
// its term is
//     term = ((sum_n phi_ev - phi_free) * (1/NC)) * feat
// and the gradient of weight w is the float64 sum of the terms of its
// owner records, rounded to float32 once.
//
// Exactness: every phi but RATIO's log1p is a small integer, so a record's
// chain sum is an integer below 2^24 and exact in float32 in any order;
// the two multiplications are rounded one at a time, in the plain
// version's order, with 1/NC rounded to float32 first.  So off RATIO a
// term equals the plain version's bit for bit; RATIO sums log1pf values in
// this kernel's order and may differ in the last bits.  The sums by weight
// run in a fixed order (below), so equal inputs give equal bytes; they
// differ from the plain version's float64 index_add_ only in float64
// rounding, at most an ulp once rounded to float32.
//
// What bounds it on the card: the arithmetic, some 4A + 10 integer
// operations a (owner record, chain, world), at the int32 issue rate (64 a
// clock an SM); then the bytes of the world rows it gathers (A-1
// neighbour rows and the own row of each owner record, both worlds), most
// of them from L2; the plan is some 16 + 9A bytes a record.  At the
// learning cells a gradient takes 0.552 ms on the KBC graph (bound 0.304),
// 0.441 on the triple grid (0.264) and 0.928 on the Potts grid (0.577):
// 55-62% of the bound, against 2.92, 2.43 and 3.50 ms for the route it
// replaced in the same run (NVIDIA H100 80GB HBM3, power limit 700 W;
// chip_smoke.py phase 16b; PERF.md, kernel table row 9).
//
// Design.
//   * The plan (ops/grad.py record_plan, built once a graph and owner
//     mask) lists the owner records only, each with its own position, its
//     type and arity, feat, its slots' flags a byte each (the first four in
//     one word of a 16-byte head) and its neighbour positions and compared
//     values, so no lane spends a segment on a record whose mask is clear
//     (two of three records of an arity-3 factor) and a record's stream
//     reads are one 16-byte load and its A-1 positions.
//   * The terms kernel takes every tier of the route in one launch (a
//     __grid_constant__ table of kMaxTiers tier descriptors; a block's
//     records all of one tier, so its slot count A is one): a segment of L
//     lanes (the least power of two >= the chain groups, at most 32) a
//     record, each lane VEC consecutive chains of a group (16 bytes of the
//     world: 16 int8 chains or 4 int32 ones, where the chain count and the
//     pointers allow; else 1) and the groups lane, lane + L, ...; the
//     slots unrolled for A = 1, 2, 3 with their rows all in flight, a loop
//     above.  On int8 worlds of 16 chains a lane the literals of four
//     chains are a few word operations (swar_chains).  The segment's
//     butterfly sums its lanes; its first lane writes the term into the
//     terms buffer in record order.
//   * The pieces kernel: the terms in the order of a permutation sorted by
//     weight id (each weight's run in record order) cut into pieces of at
//     most RECORD_PIECE (2048), a warp a piece: its lanes' float64 sums of
//     the terms lane, lane + 32, ..., then a butterfly.  The weights
//     kernel: a warp a weight, its pieces' sums the same way, rounded to
//     float32 once.  The grids' 2 weights hold nearly all records: their
//     runs are many pieces, summed in parallel.
//   * Before this design (PR 16) a launch a tier wrote a term for every
//     record, zero off the mask, and the caller's segment_reduce (a
//     float64 index_add_, an atomic a record: on the grids onto 2
//     addresses) summed them: 19-35% of the bound with the reduction
//     beside it.  That per-record kernel stays below (grad_records_launch):
//     chip_smoke.py times the route before beside this one.
//
// The kernels are templated on the world's type (int8; int32 for cards
// above 127), on whether the graph is all-boolean (no compared values) and
// on VEC.

#include <climits>
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

// The per-record kernel of one tier (the route before the plan): a
// segment of L lanes a record of the tier's C * B * D, its term where the
// owner mask gsel is set, else +0, into out[c, r, d].
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

// ---------------------------------------------------------------------------
// The records route's gradient: owner records only, summed on the card
// ---------------------------------------------------------------------------

constexpr int kMaxTiers = 8;   // tiers a launch of the terms kernel
constexpr int kRecFields = 7;  // int64 fields a tier in the host table
// a slot's flags in the plan (ops/grad.py FLAG_*)
constexpr unsigned kPos = 1, kOwn = 2, kCnt = 4, kHead = 8;

struct RecTier {
  const int4* head;      // [n]: own position, type | arity << 8, feat's
                         // bits, the flags of slots 0..3
  const uint8_t* flags;  // [n, A] a slot's flags (the looped body)
  const int32_t* nbr;    // [n, A-1] neighbour positions
  const int32_t* eq;     // [n, A] compared values (null: all-boolean)
  float* terms;          // [n] the owner records' terms
  int n;
  int A;
  int block0;  // its first block in the grid
};

struct RecLaunch {
  RecTier t[kMaxTiers];
  int n;
};

template <bool BOOL>
__device__ __forceinline__ Slot plan_slot(unsigned fl, const RecTier& T,
                                          long long i, int a, int A) {
  Slot s;
  s.own = (fl & kOwn) != 0;
  s.pos = (fl & kPos) != 0;
  s.cnt = (fl & kCnt) != 0;
  s.hm = (fl & kHead) != 0;
  s.row = s.own ? -1
                : static_cast<long long>(__ldg(T.nbr + i * (A - 1) + a));
  s.tgt = BOOL ? 1 : __ldg(T.eq + i * A + a);
  return s;
}

// 0x80 in each byte of w that equals the byte of rep (rep a byte four
// times), else 0
__device__ __forceinline__ uint32_t bytes_equal(uint32_t w, uint32_t rep) {
  const uint32_t t = w ^ rep;
  return ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
}

// 16 int8 chains of a group, four chains a 32-bit word: a slot's literals
// of four chains in a few operations (bytes_equal), their counts a byte a
// chain, the head a bit a chain; then phi_ev - phi_free chain by chain, in
// the order of the chains, as the per-chain body sums them
template <int AS>
__device__ __forceinline__ float swar_chains(const Slot (&slot)[AS],
                                             const uint4 (&x_ev)[AS],
                                             const uint4 (&x_fr)[AS], int ty,
                                             int n, float acc) {
  uint32_t rep[AS];
  bool fits[AS];
#pragma unroll
  for (int a = 0; a < AS; ++a) {
    // a compared value outside int8 matches no chain of an int8 world
    fits[a] = slot[a].tgt ==
              static_cast<int>(static_cast<int8_t>(slot[a].tgt));
    rep[a] = 0x01010101u * (static_cast<uint32_t>(slot[a].tgt) & 0xFFu);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t nle = 0, nlf = 0, hde = 0, hdf = 0;
#pragma unroll
    for (int a = 0; a < AS; ++a) {
      const Slot& s = slot[a];
      const uint32_t we = q == 0 ? x_ev[a].x : q == 1 ? x_ev[a].y
                          : q == 2 ? x_ev[a].z : x_ev[a].w;
      const uint32_t wf = q == 0 ? x_fr[a].x : q == 1 ? x_fr[a].y
                          : q == 2 ? x_fr[a].z : x_fr[a].w;
      const uint32_t flip = s.pos ? 0u : 0x80808080u;
      const uint32_t le = (fits[a] ? bytes_equal(we, rep[a]) : 0u) ^ flip;
      const uint32_t lf = (fits[a] ? bytes_equal(wf, rep[a]) : 0u) ^ flip;
      if (s.cnt) {
        nle += le >> 7;
        nlf += lf >> 7;
      }
      if (s.hm) {
        hde |= le;
        hdf |= lf;
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int ne = static_cast<int>((nle >> (8 * b)) & 0xFFu);
      const int nf = static_cast<int>((nlf >> (8 * b)) & 0xFFu);
      const bool he = ((hde >> (8 * b + 7)) & 1u) != 0;
      const bool hf = ((hdf >> (8 * b + 7)) & 1u) != 0;
      acc = __fadd_rn(acc, __fsub_rn(phi_of(ty, ne, he, n),
                                     phi_of(ty, nf, hf, n)));
    }
  }
  return acc;
}

// owner record i of tier T on a segment of L lanes (this lane: sl)
template <typename V, bool BOOL, int VEC, int AS>
__device__ __forceinline__ void owner_term(const RecTier& T, long long i,
                                           int sl, int L,
                                           const V* __restrict__ v_ev,
                                           const V* __restrict__ v_free,
                                           int NC, long long P) {
  using Tq = typename Load<V, VEC>::T;
  const int4 h = __ldg(T.head + i);
  const long long own = h.x;
  const int ty = static_cast<int>(static_cast<int8_t>(h.y & 0xFF));
  const int n = h.y >> 8;
  const float f = __int_as_float(h.z);
  const unsigned fl = static_cast<unsigned>(h.w);
  const int nA = AS > 0 ? AS : T.A;

  constexpr int kS = AS > 0 ? AS : 1;
  Slot slot[kS];
  if constexpr (AS > 0) {
#pragma unroll
    for (int a = 0; a < AS; ++a) {
      slot[a] = plan_slot<BOOL>((fl >> (8 * a)) & 0xFFu, T, i, a, AS);
    }
  }

  const int ncv = NC / VEC;
  float acc = 0.0f;
  for (int grp = sl; grp < ncv; grp += L) {
    const Tq o_ev = load_group<V, VEC>(v_ev, own, P, NC, grp);
    const Tq o_fr = load_group<V, VEC>(v_free, own, P, NC, grp);
    if constexpr (AS > 0) {
      Tq x_ev[AS], x_fr[AS];
#pragma unroll
      for (int a = 0; a < AS; ++a) {
        x_ev[a] = slot[a].own ? o_ev
                              : load_group<V, VEC>(v_ev, slot[a].row, P, NC,
                                                   grp);
        x_fr[a] = slot[a].own ? o_fr
                              : load_group<V, VEC>(v_free, slot[a].row, P,
                                                   NC, grp);
      }
      if constexpr (sizeof(V) == 1 && VEC == 16) {
        acc = swar_chains<AS>(slot, x_ev, x_fr, ty, n, acc);
      } else {
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
      }
    } else {
      // kSub chains at a time, so the counts of a group of 16 stay few
      // registers; a slot's rows come again from L1 for each sub-group
      constexpr int kSub = VEC < 4 ? VEC : 4;
#pragma unroll
      for (int e0 = 0; e0 < VEC; e0 += kSub) {
        int nl_ev[kSub], nl_fr[kSub];
        bool hd_ev[kSub], hd_fr[kSub];
#pragma unroll
        for (int e = 0; e < kSub; ++e) {
          nl_ev[e] = nl_fr[e] = 0;
          hd_ev[e] = hd_fr[e] = false;
        }
        for (int a = 0; a < nA; ++a) {
          const Slot s = plan_slot<BOOL>(__ldg(T.flags + i * nA + a), T, i,
                                         a, nA);
          const Tq xe = s.own ? o_ev : load_group<V, VEC>(v_ev, s.row, P,
                                                          NC, grp);
          const Tq xf = s.own ? o_fr : load_group<V, VEC>(v_free, s.row, P,
                                                          NC, grp);
#pragma unroll
          for (int e = 0; e < kSub; ++e) {
            add_lit(s, elem<V, VEC>(xe, e0 + e), nl_ev[e], hd_ev[e]);
            add_lit(s, elem<V, VEC>(xf, e0 + e), nl_fr[e], hd_fr[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < kSub; ++e) {
          const float pe = phi_of(ty, nl_ev[e], hd_ev[e], n);
          const float pf = phi_of(ty, nl_fr[e], hd_fr[e], n);
          acc = __fadd_rn(acc, __fsub_rn(pe, pf));
        }
      }
    }
  }
  const unsigned lane = threadIdx.x & 31u;
  const unsigned seg_mask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane & ~(unsigned)(L - 1));
  for (int off = L / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(seg_mask, acc, off));
  }
  if (sl == 0) {
    const float inv = __frcp_rn(static_cast<float>(NC));
    T.terms[i] = __fmul_rn(__fmul_rn(acc, inv), f);
  }
}

// a segment of L lanes an owner record; a block's records of one tier
template <typename V, bool BOOL, int VEC>
__global__ void __launch_bounds__(kThreads) owner_terms_kernel(
    const __grid_constant__ RecLaunch R, const V* __restrict__ v_ev,
    const V* __restrict__ v_free, int NC, long long P, int L) {
  int t = 0;
  while (t + 1 < R.n && static_cast<int>(blockIdx.x) >= R.t[t + 1].block0) {
    ++t;
  }
  const RecTier& T = R.t[t];
  const int seg = static_cast<int>(threadIdx.x) / L;
  const int sl = static_cast<int>(threadIdx.x) & (L - 1);
  const long long i =
      static_cast<long long>(static_cast<int>(blockIdx.x) - T.block0) *
          (kThreads / L) + seg;
  if (i >= T.n) return;  // uniform over the segment
  switch (T.A) {
    case 1:
      owner_term<V, BOOL, VEC, 1>(T, i, sl, L, v_ev, v_free, NC, P);
      break;
    case 2:
      owner_term<V, BOOL, VEC, 2>(T, i, sl, L, v_ev, v_free, NC, P);
      break;
    case 3:
      owner_term<V, BOOL, VEC, 3>(T, i, sl, L, v_ev, v_free, NC, P);
      break;
    default:
      owner_term<V, BOOL, VEC, 0>(T, i, sl, L, v_ev, v_free, NC, P);
  }
}

// a warp a piece: the float64 sum of its terms over the weight-sorted
// permutation, a lane's terms in order, then a butterfly
__global__ void __launch_bounds__(kThreads) piece_sums_kernel(
    const float* __restrict__ terms, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ piece_start, int n_pieces,
    double* __restrict__ partial) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  if (w >= n_pieces) return;  // uniform over the warp
  const int b = __ldg(piece_start + w), e = __ldg(piece_start + w + 1);
  double s = 0.0;
  for (int j = b + lane; j < e; j += 32) {
    s = __dadd_rn(s, static_cast<double>(__ldg(terms + __ldg(perm + j))));
  }
  for (int off = 16; off > 0; off >>= 1) {
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  }
  if (lane == 0) partial[w] = s;
}

// a warp a weight: its pieces' sums in order, rounded to float32 once
__global__ void __launch_bounds__(kThreads) weight_sums_kernel(
    const double* __restrict__ partial,
    const int32_t* __restrict__ weight_piece, int W,
    float* __restrict__ out) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  if (w >= W) return;  // uniform over the warp
  const int b = __ldg(weight_piece + w), e = __ldg(weight_piece + w + 1);
  double s = 0.0;
  for (int p = b + lane; p < e; p += 32) s = __dadd_rn(s, __ldg(partial + p));
  for (int off = 16; off > 0; off >>= 1) {
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  }
  if (lane == 0) out[w] = __double2float_rn(s);
}

// the chains a lane reads as one load, and the lanes a record
int segment_lanes(bool wide, int value_bytes, int NC) {
  const int ncv = wide ? NC / (16 / value_bytes) : NC;
  int L = 1;
  while (L < ncv && L < 32) L <<= 1;
  return L;
}

template <typename V, bool BOOL>
int launch_terms(bool wide, const RecLaunch& R, long long blocks, int L,
                 const V* v_ev, const V* v_free, int NC, long long P,
                 cudaStream_t s) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(V));
  const unsigned grid = static_cast<unsigned>(blocks > 0 ? blocks : 1);
  if (wide) {
    owner_terms_kernel<V, BOOL, kWide>
        <<<grid, kThreads, 0, s>>>(R, v_ev, v_free, NC, P, L);
  } else {
    owner_terms_kernel<V, BOOL, 1>
        <<<grid, kThreads, 0, s>>>(R, v_ev, v_free, NC, P, L);
  }
  return static_cast<int>(cudaGetLastError());
}

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

// The records route's gradient of any number of tiers: v_ev, v_free
// [P, NC] of int8 (value_bytes 1) or int32 (4); table host int64
// [n_tiers, 7], a row a tier: head, flags, nbr, eq, terms (device
// pointers, 0 for none), n (its owner records), A (its slots): head int32
// [n, 4] (own position, type | arity << 8 with the type -1 outside the
// tier's present types, feat's bits, the flags of slots 0..3 a byte
// each), flags uint8 [n, A] (bit 0 the literal's sign, 1 own value, 2
// counted, 3 head), nbr int32 [n, A-1], eq int32 [n, A] (0 with
// all_boolean, int8 worlds only), terms f32 [n], written; the tiers'
// terms one buffer in table order, the first tier's at its start; perm
// int32 [N] the N terms' indices sorted by weight id, piece_start int32
// [n_pieces + 1] the pieces' offsets into perm, weight_piece int32 [W + 1]
// each weight's run of pieces, partial f64 [n_pieces] scratch; writes out
// f32 [W].  Launches the terms kernel once for every kMaxTiers tiers, then
// the pieces and the weights: always ceil(n_tiers / kMaxTiers) + 2
// launches.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for a table or sizes it does not take).
extern "C" int grad_records_sum_launch(
    const void* v_ev, const void* v_free, int value_bytes, int NC,
    long long P, const void* table, int n_tiers, int all_boolean,
    const void* perm, const void* piece_start, int n_pieces,
    const void* weight_piece, int W, void* partial, void* out,
    void* stream) {
  if (n_tiers < 1 || NC < 1 || P < 1 || W < 1 || n_pieces < 0 ||
      table == nullptr || piece_start == nullptr || weight_piece == nullptr ||
      out == nullptr || (value_bytes != 1 && value_bytes != 4) ||
      (all_boolean && value_bytes != 1) ||
      (n_pieces > 0 && (perm == nullptr || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f = static_cast<const long long*>(table);
  const bool wide = (static_cast<long long>(NC) * value_bytes) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_ev) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_free) % 16 == 0;
  const int L = segment_lanes(wide, value_bytes, NC);
  const long long per_block = kThreads / L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t0 = 0; t0 < n_tiers; t0 += kMaxTiers) {
    RecLaunch R = {};
    long long blocks = 0;
    for (int i = t0; i < n_tiers && i < t0 + kMaxTiers; ++i) {
      const long long* x = f + static_cast<size_t>(i) * kRecFields;
      RecTier T = {};
      T.head = reinterpret_cast<const int4*>(x[0]);
      T.flags = reinterpret_cast<const uint8_t*>(x[1]);
      T.nbr = reinterpret_cast<const int32_t*>(x[2]);
      T.eq = reinterpret_cast<const int32_t*>(x[3]);
      T.terms = reinterpret_cast<float*>(x[4]);
      const long long n = x[5], A = x[6];
      if (n < 0 || n >= INT_MAX || A < 1 || A >= 256 ||
          (n > 0 && (T.head == nullptr || T.flags == nullptr ||
                     T.terms == nullptr || (A > 1 && T.nbr == nullptr) ||
                     (all_boolean != 0) != (T.eq == nullptr)))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (n == 0) continue;
      T.n = static_cast<int>(n);
      T.A = static_cast<int>(A);
      T.block0 = static_cast<int>(blocks);
      blocks += (n + per_block - 1) / per_block;
      if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
      R.t[R.n++] = T;
    }
    int err;
    if (value_bytes == 4) {
      err = launch_terms<int32_t, false>(
          wide, R, blocks, L, static_cast<const int32_t*>(v_ev),
          static_cast<const int32_t*>(v_free), NC, P, s);
    } else if (all_boolean) {
      err = launch_terms<int8_t, true>(
          wide, R, blocks, L, static_cast<const int8_t*>(v_ev),
          static_cast<const int8_t*>(v_free), NC, P, s);
    } else {
      err = launch_terms<int8_t, false>(
          wide, R, blocks, L, static_cast<const int8_t*>(v_ev),
          static_cast<const int8_t*>(v_free), NC, P, s);
    }
    if (err != 0) return err;
  }
  const auto* terms = reinterpret_cast<const float*>(f[4]);
  const long long warps = kThreads / 32;
  const long long pb = (n_pieces + warps - 1) / warps;
  piece_sums_kernel<<<static_cast<unsigned>(pb > 0 ? pb : 1), kThreads, 0,
                      s>>>(terms, static_cast<const int32_t*>(perm),
                           static_cast<const int32_t*>(piece_start),
                           n_pieces, static_cast<double*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  weight_sums_kernel<<<static_cast<unsigned>((W + warps - 1) / warps),
                       kThreads, 0, s>>>(
      static_cast<const double*>(partial),
      static_cast<const int32_t*>(weight_piece), W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
