// Native host-side hot paths of sampler_tpu_torch (the port's own copy of
// the JAX package's native/sampler_native.cpp: the same functions, the
// same ABI version string).
//
// The reference implements its loader and graph compilation in C++
// (ref: src/binary_format.cc, src/factor_graph.cc — recalled paths); these
// are their equivalents here: the device compute path is CUDA, but
// parsing multi-GB factor files, greedy-coloring 10^8-variable graphs and
// filling the color-major streams are host work where Python loops would
// dominate end-to-end time.
//
// Host code, not a kernel: it is not among the .cu sources nvcc compiles.
// Exposed as a plain C ABI for ctypes.  Built at first use by
// sampler_tpu_torch/native.py (g++ -O3 -std=c++17 -fPIC -pthread -shared)
// into sampler_tpu_torch/_build/libsampler_native_<sha>.so.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#if defined(__GNUC__)
#define EXPORT extern "C" __attribute__((visibility("default")))
#else
#define EXPORT extern "C"
#endif

namespace {

inline uint16_t be16(const uint8_t* p) {
  return (uint16_t(p[0]) << 8) | uint16_t(p[1]);
}
inline uint64_t be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return v;
}
inline double bef64(const uint8_t* p) {
  uint64_t v = be64(p);
  double d;
  std::memcpy(&d, &v, 8);
  return d;
}

}  // namespace

// ---------------------------------------------------------------------------
// Factor-file parsing (variable-length records; see format_spec.py):
//   factorType:u16, arity:i64, arity*(vid:i64, isPositive:u8
//   [+ eqPred:i64 if categorical]), weightId:i64, featureValue:f64
// Two-phase: count() then parse() into caller-allocated arrays.
// Returns 0 on success, negative error codes on malformed input.
// ---------------------------------------------------------------------------

EXPORT int64_t sampler_count_factors(const uint8_t* buf, int64_t n_bytes,
                                     const uint8_t* is_categorical_type,
                                     int64_t n_types, int64_t* out_n_factors,
                                     int64_t* out_n_edges) {
  int64_t pos = 0, nf = 0, ne = 0;
  while (pos < n_bytes) {
    if (pos + 10 > n_bytes) return -1;
    uint16_t ftype = be16(buf + pos);
    int64_t arity = (int64_t)be64(buf + pos + 2);
    pos += 10;
    if (arity < 0 || arity > (int64_t)1e9) return -2;
    bool cat = ftype < n_types && is_categorical_type[ftype];
    int64_t rec = arity * (cat ? 17 : 9) + 16;
    if (pos + rec > n_bytes) return -3;
    pos += rec;
    nf += 1;
    ne += arity;
  }
  *out_n_factors = nf;
  *out_n_edges = ne;
  return 0;
}

EXPORT int64_t sampler_parse_factors(
    const uint8_t* buf, int64_t n_bytes, const uint8_t* is_categorical_type,
    int64_t n_types,
    int32_t* f_type, int32_t* f_wid, double* f_feat, int64_t* f_ptr,
    int64_t* e_vid, uint8_t* e_ispos, int64_t* e_eqpred) {
  int64_t pos = 0, fi = 0, ei = 0;
  f_ptr[0] = 0;
  while (pos < n_bytes) {
    uint16_t ftype = be16(buf + pos);
    int64_t arity = (int64_t)be64(buf + pos + 2);
    pos += 10;
    bool cat = ftype < n_types && is_categorical_type[ftype];
    for (int64_t a = 0; a < arity; ++a) {
      e_vid[ei] = (int64_t)be64(buf + pos);
      e_ispos[ei] = buf[pos + 8];
      pos += 9;
      if (cat) {
        e_eqpred[ei] = (int64_t)be64(buf + pos);
        pos += 8;
      } else {
        e_eqpred[ei] = 1;
      }
      ++ei;
    }
    f_type[fi] = ftype;
    f_wid[fi] = (int32_t)be64(buf + pos);
    f_feat[fi] = bef64(buf + pos + 8);
    pos += 16;
    ++fi;
    f_ptr[fi] = ei;
  }
  return fi;
}

// ---------------------------------------------------------------------------
// Greedy coloring of the variable-adjacency graph (variables adjacent iff
// they share a factor), largest-degree-first, LOAD-BALANCED: among the
// permissible existing colors the least-loaded one is chosen (first-fit
// only opens a NEW color when all current colors are forbidden).  Balance
// matters because the device layout pads every color block to the largest
// color's per-tier count — first-fit on KBC-shaped graphs put ~1e6
// variables in color 0 and ~8 in color 19, inflating the padded stream
// volume by the color count (the 4e6-var compile OOM'd a 125 GB host).
// ---------------------------------------------------------------------------

EXPORT int64_t sampler_greedy_color(int64_t n_vars, int64_t n_factors,
                                    const int64_t* f_ptr, const int64_t* e_vid,
                                    int32_t* colors /* out [n_vars] */) {
  // var -> incident factor CSR via counting sort
  std::vector<int64_t> vf_ptr(n_vars + 1, 0);
  int64_t n_edges = f_ptr[n_factors];
  for (int64_t e = 0; e < n_edges; ++e) vf_ptr[e_vid[e] + 1]++;
  for (int64_t v = 0; v < n_vars; ++v) vf_ptr[v + 1] += vf_ptr[v];
  std::vector<int64_t> vf(n_edges);
  {
    std::vector<int64_t> cursor(vf_ptr.begin(), vf_ptr.end() - 1);
    for (int64_t f = 0; f < n_factors; ++f)
      for (int64_t e = f_ptr[f]; e < f_ptr[f + 1]; ++e)
        vf[cursor[e_vid[e]]++] = f;
  }

  // degree bound (sum over incident factors of arity-1) for ordering
  std::vector<int64_t> deg(n_vars, 0);
  for (int64_t v = 0; v < n_vars; ++v)
    for (int64_t i = vf_ptr[v]; i < vf_ptr[v + 1]; ++i) {
      int64_t f = vf[i];
      deg[v] += (f_ptr[f + 1] - f_ptr[f]) - 1;
    }
  std::vector<int64_t> order(n_vars);
  for (int64_t v = 0; v < n_vars; ++v) order[v] = v;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return deg[a] > deg[b]; });

  int64_t max_deg = 0;
  for (int64_t v = 0; v < n_vars; ++v) max_deg = std::max(max_deg, deg[v]);
  std::vector<int64_t> stamp(max_deg + 2, -1);
  std::fill(colors, colors + n_vars, -1);

  int32_t max_color = -1;
  std::vector<int64_t> load;
  for (int64_t oi = 0; oi < n_vars; ++oi) {
    int64_t v = order[oi];
    // mark colors of co-members of incident factors
    for (int64_t i = vf_ptr[v]; i < vf_ptr[v + 1]; ++i) {
      int64_t f = vf[i];
      for (int64_t e = f_ptr[f]; e < f_ptr[f + 1]; ++e) {
        int64_t u = e_vid[e];
        if (u != v && colors[u] >= 0 && colors[u] <= max_deg)
          stamp[colors[u]] = oi;
      }
    }
    int32_t c = -1;
    int64_t best_load = INT64_MAX;
    for (int32_t k = 0; k <= max_color; ++k)
      if (stamp[k] != oi && load[k] < best_load) {
        best_load = load[k];
        c = k;
      }
    if (c < 0) {
      ++max_color;
      c = max_color;
      if ((int64_t)load.size() <= max_color) load.resize(max_color + 1, 0);
    }
    colors[v] = c;
    load[c]++;
  }
  return max_color + 1;  // number of colors
}

// ---------------------------------------------------------------------------
// Color-major incidence-stream builder — the multithreaded native twin of
// the chunked numpy loop in compile.py (ref analog: FactorGraph::compile()
// building the CompiledFactorGraph CSR — src/factor_graph.cc, recalled).
// One call fills every cs_* stream (own-last slot permutation included)
// and, for pairwise boolean graphs, the fused-path affine coefficients.
// The numpy loop is the plain version (compile_graph(native=False));
// tests assert element parity.
// ---------------------------------------------------------------------------

#include <cmath>
#include <functional>
#include <thread>

namespace {

// factor-function enum (format_spec.py)
enum {
  F_IMPLY_NAT = 0, F_OR = 1, F_AND = 2, F_EQUAL = 3, F_ISTRUE = 4,
  F_LINEAR = 7, F_RATIO = 8, F_LOGICAL = 9, F_AND_CAT = 12, F_IMPLY_MLN = 13,
};

inline float phi_eval(int type, int nlit, int head, int n) {
  switch (type) {
    case F_AND: case F_AND_CAT: case F_IMPLY_NAT:
      return nlit == n ? 1.f : 0.f;
    case F_OR:
      return nlit > 0 ? 1.f : 0.f;
    case F_EQUAL:
      return (nlit == 0 || nlit == n) ? 1.f : 0.f;
    case F_ISTRUE:
      return (float)head;
    case F_IMPLY_MLN: {
      int nbody = nlit - head, n_body = n > 1 ? n - 1 : 0;
      return nbody < n_body ? 1.f : (float)head;
    }
    case F_LINEAR: case F_RATIO: case F_LOGICAL: {
      int nbody = nlit - head, n_body = n > 1 ? n - 1 : 0;
      float lin = head ? (float)n_body : (float)(n_body - nbody);
      if (n == 1) lin = (float)head;
      if (type == F_LINEAR) return lin;
      if (type == F_RATIO) return log1pf(lin);
      return lin > 0 ? 1.f : 0.f;
    }
    default:
      return 0.f;
  }
}

struct StreamArgs {
  // A = columns emitted for this tier (tier max arity); Astride = row
  // stride of the global f_* arrays (global max arity).  Tier row r sits
  // at global position (r / Bt) * B_full + off_t + (r % Bt) — the
  // degree-tiered color-major layout (compile.py).
  int64_t n_rows, D, A, Astride, P, dummy_pos, B_full, Bt, off_t;
  int eq_is16, do_affine;
  const int32_t* v_fidx;
  const int32_t* f_vids;
  const uint8_t* f_ispos;
  const void* f_eqpred;
  const uint8_t* f_mask;
  const int8_t* f_type;
  const int16_t* f_arity;
  const int32_t* f_wid;
  const float* f_feat;
  const int32_t* f_minpos;
  const uint8_t* f_touch;
  int32_t* cs_nbr;
  uint8_t *cs_ismine, *cs_hmask, *cs_pos, *cs_mask;
  void* cs_eq;
  int8_t* cs_type;
  int16_t* cs_arity;
  int32_t* cs_wid;
  float* cs_feat;
  uint8_t *cs_gowner, *cs_gtouch;
  float *ab_a, *ab_b;
};

void build_rows(const StreamArgs& g, int64_t r0, int64_t r1) {
  const int64_t D = g.D, A = g.A, A1 = A - 1, AS = g.Astride;
  // slot permutation scratch (A is small)
  std::vector<int> perm(A);
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t p = (r / g.Bt) * g.B_full + g.off_t + (r % g.Bt);
    for (int64_t d = 0; d < D; ++d) {
      const int64_t fi = g.v_fidx[r * D + d];
      const int32_t* mv = g.f_vids + fi * AS;
      const uint8_t* msk = g.f_mask + fi * AS;
      const int16_t ar = g.f_arity[fi];
      // stable own-last: neighbor slots first, own slots after
      int np_ = 0;
      for (int a = 0; a < A; ++a)
        if (mv[a] != (int32_t)p) perm[np_++] = a;
      int n_nbr = np_;
      for (int a = 0; a < A; ++a)
        if (mv[a] == (int32_t)p) perm[np_++] = a;

      const int64_t rd = r * D + d;          // [rows, D] index
      const int64_t rda = rd * A;            // [rows, D, A] base
      for (int s = 0; s < A; ++s) {
        const int a = perm[s];
        const bool mine = mv[a] == (int32_t)p;
        g.cs_ismine[rda + s] = mine;
        g.cs_hmask[rda + s] = msk[a] && (a == ar - 1);
        g.cs_pos[rda + s] = g.f_ispos[fi * AS + a];
        g.cs_mask[rda + s] = msk[a];
        if (g.cs_eq) {
          if (g.eq_is16)
            ((int16_t*)g.cs_eq)[rda + s] =
                ((const int16_t*)g.f_eqpred)[fi * AS + a];
          else
            ((int32_t*)g.cs_eq)[rda + s] =
                ((const int32_t*)g.f_eqpred)[fi * AS + a];
        }
        if (s < A1)
          g.cs_nbr[rd * A1 + s] = mine ? (int32_t)g.dummy_pos : mv[a];
      }
      g.cs_type[rd] = g.f_type[fi];
      g.cs_arity[rd] = ar;
      g.cs_wid[rd] = g.f_wid[fi];
      g.cs_feat[rd] = g.f_feat[fi];
      const bool owner = g.f_minpos[fi] == (int32_t)p;
      g.cs_gowner[rd] = owner;
      g.cs_gtouch[rd] = owner && g.f_touch[fi];

      if (g.do_affine) {
        // delta-phi affine coefficients in the single neighbor value
        // (A <= 2; see ops/fused.py affine_pairwise)
        float ph[2][2];  // [k][v]
        const int type = g.cs_type[rd];
        int n = 0;
        for (int s = 0; s < A; ++s) n += g.cs_mask[rda + s] ? 1 : 0;
        for (int k = 0; k < 2; ++k)
          for (int v = 0; v < 2; ++v) {
            int nlit = 0, head = 0;
            for (int s = 0; s < A; ++s) {
              if (!g.cs_mask[rda + s]) continue;
              const int val = g.cs_ismine[rda + s] ? k : v;
              const int lit = (val == 1) == (g.cs_pos[rda + s] != 0);
              nlit += lit;
              if (lit && g.cs_hmask[rda + s]) head = 1;
            }
            ph[k][v] = phi_eval(type, nlit, head, n);
          }
        const float d0 = ph[1][0] - ph[0][0];
        g.ab_a[rd] = d0;
        g.ab_b[rd] = (ph[1][1] - ph[0][1]) - d0;
      }
      (void)n_nbr;
    }
  }
}

}  // namespace

EXPORT int64_t sampler_build_streams(
    int64_t n_rows, int64_t D, int64_t A, int64_t A_stride, int64_t P,
    int64_t dummy_pos, int64_t B_full, int64_t Bt, int64_t off_t,
    int64_t eq_is16, int64_t do_affine, int64_t n_threads,
    const int32_t* v_fidx, const int32_t* f_vids, const uint8_t* f_ispos,
    const void* f_eqpred, const uint8_t* f_mask, const int8_t* f_type,
    const int16_t* f_arity, const int32_t* f_wid, const float* f_feat,
    const int32_t* f_minpos, const uint8_t* f_touch,
    int32_t* cs_nbr, uint8_t* cs_ismine, uint8_t* cs_hmask, uint8_t* cs_pos,
    uint8_t* cs_mask, void* cs_eq, int8_t* cs_type, int16_t* cs_arity,
    int32_t* cs_wid, float* cs_feat, uint8_t* cs_gowner, uint8_t* cs_gtouch,
    float* ab_a, float* ab_b) {
  if (A < 1 || D < 1 || n_rows < 0 || A_stride < A || Bt < 1) return -1;
  if (do_affine && (A > 2 || !ab_a || !ab_b)) return -2;
  StreamArgs g{n_rows, D, A, A_stride, P, dummy_pos, B_full, Bt, off_t,
               (int)eq_is16, (int)do_affine,
               v_fidx, f_vids, f_ispos, f_eqpred, f_mask, f_type, f_arity,
               f_wid, f_feat, f_minpos, f_touch,
               cs_nbr, cs_ismine, cs_hmask, cs_pos, cs_mask, cs_eq,
               cs_type, cs_arity, cs_wid, cs_feat, cs_gowner, cs_gtouch,
               ab_a, ab_b};
  int64_t nt = n_threads > 0 ? n_threads
                             : (int64_t)std::thread::hardware_concurrency();
  nt = std::max<int64_t>(1, std::min<int64_t>(nt, 64));
  if (nt == 1 || n_rows < (int64_t)1 << 14) {
    build_rows(g, 0, n_rows);
    return 0;
  }
  std::vector<std::thread> ts;
  const int64_t step = (n_rows + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t r0 = t * step, r1 = std::min(n_rows, r0 + step);
    if (r0 >= r1) break;
    ts.emplace_back(build_rows, std::cref(g), r0, r1);
  }
  for (auto& th : ts) th.join();
  return 0;
}

EXPORT const char* sampler_native_version() { return "sampler-native-0.3"; }
