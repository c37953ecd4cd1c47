"""Compile a host FactorGraph into the padded, rectangular device layout.

Copy of the host part of sampler_tpu/compile.py (the port imports nothing
of the JAX package), the chunked-CSR hub tier included.  As in the JAX
package, the dense tiers' color-major streams are filled by the native
host library (``native.build_streams``, many threads) except on graphs
with sparse per-combination weights; the hub tier stays on numpy.  The
chunked numpy loop is the plain version the native fill is held to: it
runs with ``compile_graph(native=False)``, which also colors with the
numpy colorer.  to_device moves the streams to torch tensors.

Equivalent role to the reference's FactorGraph::compile() →
CompiledFactorGraph (ref: src/factor_graph.cc — recalled), but the layout is
TPU-shaped:

COLOR-MAJOR, DEGREE-TIERED VARIABLE LAYOUT.  Variables are permuted so that
each color's block occupies one contiguous slice of the assignment vector,
and within a color block variables are grouped into DEGREE TIERS — 1-4
contiguous segments, each padded to its OWN maximum incident-factor count
D_t and its own maximum incident arity A_t instead of the global maxima
(SURVEY.md §7 "bucketed by arity"; VERDICT.md r2 #1: a single degree-10^4
hub must not inflate every variable's stream row by 2500x).  Position
p = c * B + off_t + r holds the r-th tier-t variable of color c, where
B = Σ_t B_t.  A Gibbs color step then loops the (static, <= 4) tiers:

  * reads tier metadata as contiguous [B_t] slices (no gathers),
  * gathers only the small ``values`` vector at streamed member indices,
  * writes its updates with one contiguous dynamic_update_slice — there is
    NO scatter anywhere in the sweep (arbitrary-index scatter is
    pathologically slow on TPU XLA).

Sentinels instead of masks wherever possible:
  * pad positions inside a tier segment are fake variables (card 1,
    evidence role, value 0) — the slice update writes their old value back;
  * position C*B is the global dummy slot factor-edge padding points at;
  * a DUMMY FACTOR row at index F has feature 0.0 so its contribution to
    any sum is exactly 0.

All factor member ids (f_vids, cs_nbr) are stored as color-major POSITIONS,
not original variable ids; ``pos_of_vid`` maps back for user-facing output.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import format_spec as fs
from . import native as native_mod
from .coloring import greedy_coloring
from .graph import FactorGraph
from .observe import span, spanned


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class TierStreams(NamedTuple):
    """One degree tier's device arrays.

    Shapes: B = this tier's padded rows per color (TierInfo.block),
    D = tier max degree, A = tier max incident arity, C = colors,
    K = global max cardinality.  Conventions identical to the pre-tier
    layout (VERDICT r1/r2 reviews): own-last slot permutation, neighbor
    slots only in cs_nbr, [C, 1, ...] placeholders for disabled features.
    """

    # color-major incidence streams — the sweep's hot data.  One record per
    # (variable-of-tier, incident-factor-slot); contiguous streaming.
    # SLOTS ARE PERMUTED OWN-LAST per (variable, factor): the slots owned by
    # the updating variable sit at the tail of the A axis, so the values
    # gather touches ONLY the leading A-1 neighbor slots (cs_nbr) — the
    # gather is TPU-issue-rate bound (~11 ns/row regardless of row width),
    # so dropping the own slots halves its cost on pairwise graphs.
    cs_nbr: np.ndarray     # int32 [C, B, D, A-1] neighbor positions
    #                        (own/pad slots → dummy position)
    cs_ismine: np.ndarray  # bool  [C, B, D, A] slots owned by this variable
    cs_hmask: np.ndarray   # bool  [C, B, D, A] slot is the factor HEAD
    cs_pos: np.ndarray     # bool  [C, B, D, A]
    cs_eq: np.ndarray      # int16/int32 [C, B, D, A]; [C, 1, 1, 1]
    #                        placeholder when CompileInfo.all_boolean
    cs_mask: np.ndarray    # bool  [C, B, D, A]
    cs_type: np.ndarray    # int8  [C, B, D]
    cs_arity: np.ndarray   # int16 [C, B, D]
    cs_wid: np.ndarray     # int32 [C, B, D]
    cs_feat: np.ndarray    # float32 [C, B, D]
    # gradient ownership: each real factor is "owned" by exactly ONE
    # incidence record (its min-position member), so the contrastive-SGD
    # gradient can be evaluated on the cs streams without counting a factor
    # once per member
    cs_gowner: np.ndarray  # bool [C, B, D] this record owns its factor
    cs_gtouch: np.ndarray  # bool [C, B, D] owner & factor touches evidence
    # sparse per-combination weights (placeholders when has_sparse_cw off)
    cs_issparse: np.ndarray   # bool  [C, B, D]
    cs_cwbase: np.ndarray     # int32 [C, B, D]
    cs_cwstride: np.ndarray   # int32 [C, B, D, A] (own-last slot order)
    # banded-gather plan (ops/banded.py): per-tile window starts; [C, 1]
    # zeros when banding is off (TierInfo.band_w == 0).  Single-window
    # (band_k == 1): [C, ntiles]; multi-window (band_k >= 2, multi-color
    # graphs): [C, ntiles, K] DMA starts with bd_rnbr holding indices
    # remapped into the concatenated K*W window space
    bd_start: np.ndarray   # int32 [C, ntiles] or [C, ntiles, K]
    bd_rnbr: np.ndarray    # int32 [C, ntiles, R] remapped neighbor indices
    #                        ([C, 1, 1] unless band_k >= 2)
    # TRUE per-tile read bounds [lo, hi) over cs_nbr (dummy excluded;
    # empty tile -> lo=P, hi=0); valid iff TierInfo.bounds — the
    # halo-exchange plan (parallel/graph_shard.py) derives from these
    bd_lo: np.ndarray      # int32 [C, ntiles] ([C, 1] when no bounds)
    bd_hi: np.ndarray      # int32 [C, ntiles] (exclusive)
    # fused affine color step (ops/fused.py; TierInfo.affine2):
    bd_nbr: np.ndarray     # int32 [C, ntiles, D*TB] neighbor positions,
    #                        d-major within tile ([C,1,1] when off)
    ab_a: np.ndarray       # f32 [C, B, D] delta-phi intercept ([C,1,1] off)
    ab_b: np.ndarray       # f32 [C, B, D] delta-phi slope in neighbor value
    # K-candidate fused color step (ops/fused.py; TierInfo.affinek —
    # categorical/mixed arity<=2 tiers; placeholders when off).  Kernel
    # streams are stored ROW-major d-major [C, ntiles, D*TB]: the last two
    # dims (ntiles, D*TB) are both large, so the (8, 128) HBM tile padding
    # is negligible (a trailing dim of 1 would pad 128x, a middle dim of 1
    # 8x — both measured; round-4/5 layout fixes).  Kernels index blocks
    # (1, 1, R) at (c, t, 0) with the color passed as a scalar prefetch, so
    # the hot loop never materializes a per-color slice copy.
    cs_cka: np.ndarray     # f32 [C, B, D] pre-weight candidate coefficient
    cs_ckb: np.ndarray     # f32 [C, B, D] pre-weight e-slope coefficient
    bd_eqo: np.ndarray     # int32 [C, ntiles, D*TB] own eq predicate
    #                        ([C,1,1] when off)
    bd_eqn: np.ndarray     # int32 [C, ntiles, D*TB] neighbor eq pred
    # moment-factored gradient kernel streams (ops/grad.py; built with
    # affine2 — pairwise boolean banded tiers; [C,1,1] placeholders
    # otherwise).  φ of a record is bilinear in the binary (own, nbr)
    # values: φ(o, n) = p00 + ao·o + an·n + ax·o·n, with ao == ab_a and
    # ax == ab_b (the affine-analysis streams) and an the only new
    # coefficient; all literal/negation/head/mask semantics live in these
    # compile-time floats (row d-major like bd_eqo).
    gd_wid: np.ndarray     # int32 [C, ntiles, D*TB] weight id
    gd_cown: np.ndarray    # f32 [C, ntiles, D*TB] feat * gowner
    gd_ctch: np.ndarray    # f32 [C, ntiles, D*TB] feat * gtouch
    gd_ao: np.ndarray      # f32 [C, ntiles, D*TB] φ(1,0) − φ(0,0)
    gd_an: np.ndarray      # f32 [C, ntiles, D*TB] φ(0,1) − φ(0,0)
    gd_ax: np.ndarray      # f32 [C, ntiles, D*TB] φ(1,1)−φ(1,0)−φ(0,1)+φ(0,0)
    # multilinear delta-φ streams (TierInfo.deltam — boolean tiers with
    # arity <= 3 that DON'T run a fused Pallas step, i.e. the irregular
    # KBC/arity-3 classes).  On {0,1}^k corners the multilinear
    # interpolant is EXACT for ANY φ (incl. RATIO's log1p), so
    # delta(n1, n2) = φ(1,·)−φ(0,·) folds to 4 compile-time coefficients
    # per record and the runtime delta path becomes ~6 elementwise ops
    # instead of the ~40-op counts/select evaluation — the measured
    # per-chain VPU bound of the KBC class (round-5 probe).  Pre-weight;
    # fold_deltam scales by wf at weights-change time.
    dm_a: np.ndarray       # f32 [C, B, D] d(0,0)
    dm_b1: np.ndarray      # f32 [C, B, D] d(1,0) − d(0,0)
    dm_b2: np.ndarray      # f32 [C, B, D] d(0,1) − d(0,0)
    dm_x: np.ndarray       # f32 [C, B, D] d(1,1)−d(1,0)−d(0,1)+d(0,0)
    # fused multilinear draw kernel (TierInfo.fusedm — banded boolean
    # arity<=3 tiers the pairwise affine kernel can't serve: arity-3
    # and/or multi-window).  Neighbor stream in kernel block layout,
    # SLOT-major then d-major within tile: row (s, d, b) = s*D*TB + d*TB
    # + b, so the kernel's gathered [A1*D*TB, NC] accumulator splits into
    # per-slot planes acc[:R], acc[R:2R] that line up with the d-major
    # dm coefficient rows.  band_k >= 2 tiers store indices REMAPPED into
    # the concatenated K*W window space (like bd_rnbr); band_k == 1 tiers
    # store global positions (kernel subtracts the window start).
    bd_dmnbr: np.ndarray   # int32 [C, ntiles, A1*D*TB] ([C,1,1] when off)
    # precomputed draw masks (runtime comparisons against sliced metadata
    # trigger a pathological Mosaic lowering — ~400x slower — so these are
    # baked at compile time and streamed):
    cm_kmask: np.ndarray        # float32 [C, B, K]: 0 if k < card else -1e30
    cm_resample: np.ndarray     # bool [C, B]: query & not pad
    cm_resample_ev: np.ndarray  # bool [C, B]: not pad (sample_evidence mode)
    # HUB tier only (TierInfo.hub; [C, 1] placeholder otherwise): the cs_*
    # streams of a hub tier are CHUNKED CSR records [C, M, G, A] — M chunks
    # of G records each, every chunk owned by ONE tier-local variable row —
    # and hb_row maps chunk -> owning row (pad chunks -> block, a dummy
    # segment).  A power-law hub with degree 1e5 would inflate a dense
    # [B, D, A] tier by ~1e4x (the 4e6-var KBC compile needed 712 GB);
    # chunking keeps the stream O(edges) and turns the per-variable
    # reduction into chunk-sums + one short segment-sum.
    hb_row: np.ndarray          # int32 [C, M] chunk -> tier-local row


class DeviceGraph(NamedTuple):
    """Rectangular SoA arrays (numpy here; moved to device by to_device).

    Global fields plus a tuple of TierStreams (one per degree tier).
    Shapes:  P = C*B + 1 (color-major positions + dummy tail),
             F' = F+1 (dummy factor row),  A = padded GLOBAL max arity.
    """

    # factors (members as positions) ------------------------------ [F', A]
    f_vids: np.ndarray    # int32 member positions (pad → C*B)
    f_ispos: np.ndarray   # bool
    f_eqpred: np.ndarray  # int32
    f_mask: np.ndarray    # bool, True on real edges
    # factors ------------------------------------------------------ [F']
    f_type: np.ndarray    # int8
    f_wid: np.ndarray     # int32 (dummy → 0)
    f_feat: np.ndarray    # float32 (dummy → 0.0)
    f_arity: np.ndarray   # int16 (dummy → 1)
    # per-position variable metadata ------------------------------- [P]
    var_card: np.ndarray  # int32 (pads/dummy → 1)
    var_role: np.ndarray  # int32 (pads/dummy → ROLE_EVIDENCE)
    var_init: np.ndarray  # int32 (pads/dummy → 0)
    # original-id mapping ------------------------------------------- [V]
    pos_of_vid: np.ndarray  # int32: original vid → color-major position
    # weights ------------------------------------------------ [W + 1]
    # one reserved always-zero FIXED slot is appended at index W: sparse
    # combination-table misses point at it, so absent combinations
    # contribute exactly 0 without a mask
    w_init: np.ndarray    # float32
    w_fixed: np.ndarray   # bool
    # sparse per-combination weights (FUNC_AND_CATEGORICAL sparse variant;
    # placeholders of the same rank when CompileInfo.has_sparse_cw=False):
    cwt_wid: np.ndarray       # int32 [T] dense mixed-radix comb → wid table
    f_cwbase: np.ndarray      # int32 [F'] table base (-1 = not sparse)
    f_cwstride: np.ndarray    # int32 [F', A] mixed-radix stride per slot
    # the degree tiers (>= 1); see TierStreams
    tiers: tuple = ()

    # ---- single-tier convenience accessors (tests / simple callers) ----
    def _one(self) -> TierStreams:
        if len(self.tiers) != 1:
            raise AttributeError(
                "flat stream accessor used on a multi-tier DeviceGraph; "
                "iterate dg.tiers instead")
        return self.tiers[0]


def _add_tier_accessors():
    for _f in TierStreams._fields:
        setattr(DeviceGraph, _f,
                property(lambda self, _f=_f: getattr(self._one(), _f)))


_add_tier_accessors()


@dataclasses.dataclass(frozen=True)
class TierInfo:
    """Static (hashable) description of one degree tier."""
    off: int              # row offset within each color block
    block: int            # B_t: padded rows per color
    degree: int           # D_t: padded incident-factor slots
    arity: int            # A_t: padded member slots of incident factors
    band_w: int = 0       # banded-gather window width (0 = off)
    band_tb: int = 0      # banded-gather tile rows (0 = off)
    band_k: int = 0       # windows per tile (1 = single, >= 2 multi-window)
    bounds: bool = False  # bd_lo/bd_hi hold true read bounds
    affine2: bool = False  # fused affine color step available
    affinek: bool = False  # K-candidate fused color step available
    deltam: bool = False  # multilinear delta-phi streams available (dm_*)
    fusedm: bool = False  # fused multilinear draw kernel available
    hub: bool = False     # chunked-CSR hub tier (degree > hub_cap)
    chunks: int = 0       # M: padded chunks per color (hub tier)
    chunk_g: int = 0      # G: records per chunk (hub tier)
    present_funcs: tuple = ()  # factor-function ids in THIS tier's records


@dataclasses.dataclass(frozen=True)
class CompileInfo:
    n_vars: int
    n_factors: int
    n_weights: int
    n_colors: int
    max_arity: int
    max_degree: int
    max_card: int
    block_size: int             # B = sum of tier blocks
    present_funcs: tuple = ()   # sorted factor-function ids in this graph
    all_boolean: bool = False   # no categorical vars and all eqpred == 1
    band_w: int = 0             # max tier band_w (0 = no banded tier)
    band_tb: int = 0            # band tile rows (uniform across tiers)
    bounds: bool = False        # ALL tiers have true read bounds (halo ok)
    affine2: bool = False       # any tier runs the fused affine step
    affinek: bool = False       # any tier runs the K-candidate fused step
    fusedm: bool = False        # any tier runs the fused multilinear draw
    has_hub: bool = False       # a chunked-CSR hub tier is present
    has_sparse_cw: bool = False  # sparse per-combination weights present
    tiers: tuple = ()           # TierInfo per tier (ascending degree)


# ---------------------------------------------------------------------------
# degree-tier planning
# ---------------------------------------------------------------------------

def plan_tiers(degree: np.ndarray, max_inc_arity: np.ndarray,
               max_tiers: int = 4, min_gain: float = 0.25):
    """Partition variables into <= max_tiers degree tiers.

    Minimizes the padded stream volume Σ_t N_t · D_t · A_t by dynamic
    programming over (quantized) unique degree levels; falls back to a
    single tier when the best multi-tier split saves < ``min_gain`` of the
    single-tier volume (grids and other uniform graphs keep the exact
    pre-tier layout).  Returns (tier_of_var int32 [V], n_tiers).
    """
    V = len(degree)
    if V == 0 or max_tiers <= 1:
        return np.zeros(V, np.int32), 1
    degree = np.asarray(degree, np.int64)
    levels = np.unique(degree)
    if len(levels) <= 1:
        return np.zeros(V, np.int32), 1
    if len(levels) > 256:
        qs = np.quantile(degree, np.linspace(0.0, 1.0, 257)[1:])
        levels = np.unique(np.concatenate(
            [qs.astype(np.int64), [int(degree.max())]]))
    m = len(levels)
    bucket = np.searchsorted(levels, degree)          # first level >= degree
    cnt = np.bincount(bucket, minlength=m).astype(np.int64)
    ccnt = np.concatenate([[0], np.cumsum(cnt)])
    # per-bucket max incident arity (vectorized segment max)
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    sa = np.asarray(max_inc_arity, np.int64)[order]
    starts = np.searchsorted(sb, np.arange(m))
    amax_b = np.ones(m, np.int64)
    nonempty = cnt > 0
    if nonempty.any():
        red = np.maximum.reduceat(sa, np.minimum(starts, V - 1))
        amax_b = np.where(nonempty, red, 1)

    INF = float("inf")
    best = np.full((m + 1, max_tiers + 1), INF)
    cut = np.zeros((m + 1, max_tiers + 1), np.int32)
    best[0, 0] = 0.0
    for i in range(1, m + 1):
        for k in range(1, max_tiers + 1):
            seg_amax = 1
            for j in range(i - 1, -1, -1):
                seg_amax = max(seg_amax, int(amax_b[j]))
                n_seg = int(ccnt[i] - ccnt[j])
                cost = n_seg * int(levels[i - 1]) * seg_amax
                cand = best[j, k - 1] + cost
                if cand < best[i, k]:
                    best[i, k] = cand
                    cut[i, k] = j
    single = best[m, 1]
    k_best = int(np.argmin(best[m, 1:])) + 1
    if best[m, k_best] > (1.0 - min_gain) * single or k_best == 1:
        return np.zeros(V, np.int32), 1
    # reconstruct cuts -> per-bucket tier ids (drop empty segments)
    bounds = []
    i, k = m, k_best
    while k > 0:
        j = int(cut[i, k])
        bounds.append((j, i))
        i, k = j, k - 1
    bounds.reverse()
    tier_of_bucket = np.zeros(m, np.int32)
    t = 0
    for j, i in bounds:
        if ccnt[i] - ccnt[j] == 0:
            continue
        tier_of_bucket[j:i] = t
        t += 1
    if t <= 1:
        return np.zeros(V, np.int32), 1
    return tier_of_bucket[bucket], t


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

@spanned("compile.graph")
def compile_graph(graph: FactorGraph, colors: np.ndarray | None = None,
                  align: int = 8, band_tile: int = 128,
                  band_wmax: int = 8192,
                  band_min_block: int = 4096,
                  max_tiers: int = 4,
                  shards: int = 1,
                  order: np.ndarray | None = None,
                  hub_cap: int = 2048,
                  hub_chunk: int = 512,
                  native: bool = True) -> tuple[DeviceGraph, CompileInfo]:
    """Build the padded color-major, degree-tiered device layout.

    band_*: parameters of the banded (MXU one-hot matmul) gather plan — see
    ops/banded.py.  Tier blocks smaller than ``band_min_block`` skip banding
    (the plain gather is fine there and the tile padding would dominate).
    max_tiers: degree-tier cap (1 disables bucketing).
    shards: intended graph-axis size — banded tier blocks are rounded so
    every 1/shards slice keeps whole band tiles (parallel/graph_shard.py
    check_shardable).
    order: optional int ordering key per variable (smaller = earlier within
    its (color, tier) segment) — e.g. an RCM rank for bandwidth reduction;
    default keeps original-id order.
    hub_cap / hub_chunk: variables with more than ``hub_cap`` incident
    factors go to a chunked-CSR HUB tier (``hub_chunk`` records per chunk)
    instead of a dense [B, D, A] tier — a power-law head variable must not
    inflate the padded stream volume by its own degree (SURVEY.md §7
    hard-part 2).
    native: color (when ``colors`` is None) and fill the dense tiers'
    streams with the native host library (the default); False runs their
    numpy plain versions, which give the same streams.
    """
    with span("compile.layout"):
        graph.validate()
        V, F, E = graph.n_vars, graph.n_factors, graph.n_edges
        arity = graph.arities().astype(np.int64)
        A = int(arity.max())

        # --- coloring --------------------------------------------------------
        if colors is None:
            colors = greedy_coloring(graph, native=native)
        C = int(colors.max()) + 1 if V else 1

        # --- per-variable degree / max incident arity (factor-distinct) ------
        rows = np.repeat(np.arange(F), arity)
        pair_key = rows.astype(np.int64) * V + graph.e_vid
        uniq = np.unique(pair_key)
        uf = (uniq // V).astype(np.int32)        # incident factor per pair
        uv = (uniq % V).astype(np.int64)         # variable per pair
        degree_v = np.bincount(uv, minlength=V)
        vorder = np.argsort(uv, kind="stable")
        vstarts = np.searchsorted(uv[vorder], np.arange(V))
        maxA_v = np.ones(V, np.int64)
        if len(uv):
            red = np.maximum.reduceat(arity[uf[vorder]],
                                      np.minimum(vstarts, len(uv) - 1))
            maxA_v = np.where(degree_v > 0, red, 1)

        # --- degree tiers (hubs split off first) -----------------------------
        is_hub = degree_v > hub_cap
        n_hub = int(is_hub.sum())
        if n_hub:
            dense = ~is_hub
            tier_of_v = np.zeros(V, np.int32)
            td, T = plan_tiers(degree_v[dense], maxA_v[dense], max_tiers)
            tier_of_v[dense] = td
            tier_of_v[is_hub] = T          # hub tier is the LAST tier
            hub_tier = T
            T = T + 1
        else:
            tier_of_v, T = plan_tiers(degree_v, maxA_v, max_tiers)
            hub_tier = -1

        # --- per-(color, tier) counts -> padded tier blocks ------------------
        gidx = colors.astype(np.int64) * T + tier_of_v
        gcnt = np.bincount(gidx, minlength=C * T).reshape(C, T)
        Bt = np.zeros(T, np.int64)
        try_band_t = np.zeros(T, bool)
        for t in range(T):
            b = _round_up(max(int(gcnt[:, t].max()), 1), align)
            if band_tile > 0 and b >= band_min_block and t != hub_tier:
                # x8: the fused kernels read their [C, ntiles, R] streams in
                # (1, 8, R) blocks (Mosaic requires the penultimate block dim
                # divisible by 8), so ntiles must be a multiple of 8 — per
                # SHARD under graph sharding.  Pad rows are ordinary dummy
                # variables, so tiles stay uniform and shard-aligned.
                q = int(np.lcm(align, band_tile * 8 * max(shards, 1)))
                b = _round_up(b, q)
                try_band_t[t] = True
            Bt[t] = b
        off = np.concatenate([[0], np.cumsum(Bt)[:-1]])
        B = int(Bt.sum())
        P = C * B + 1                      # +1 global dummy tail
        DUMMY = C * B

        # --- permutation: (color, tier, order) -> positions ------------------
        order_key = np.arange(V, dtype=np.int64) if order is None \
            else np.asarray(order, np.int64)
        corder = np.lexsort((order_key, tier_of_v, colors)).astype(np.int64)
        sg = gidx[corder]
        gstarts = np.searchsorted(sg, np.arange(C * T))
        rank = np.arange(V) - gstarts[sg]
        positions = (colors[corder].astype(np.int64) * B
                     + off[tier_of_v[corder]] + rank)
        vid_of_pos = np.full(P, -1, np.int64)   # -1 = pad/dummy
        vid_of_pos[positions] = corder
        pos_of_vid = np.empty(V, np.int64)
        pos_of_vid[corder] = positions

        # --- factor → member edges (as positions), padded [F+1, A] -----------
        eq_dtype = (np.int16 if np.max(graph.e_eqpred, initial=0) < (1 << 15)
                    else np.int32)
        f_vids = np.full((F + 1, A), DUMMY, np.int32)
        f_ispos = np.zeros((F + 1, A), bool)
        f_eqpred = np.zeros((F + 1, A), eq_dtype)
        f_mask = np.zeros((F + 1, A), bool)
        cols = (np.arange(E, dtype=np.int64)
                - np.repeat(graph.f_ptr[:-1], arity))
        f_vids[rows, cols] = pos_of_vid[graph.e_vid]
        f_ispos[rows, cols] = graph.e_ispos
        f_eqpred[rows, cols] = graph.e_eqpred
        f_mask[rows, cols] = True

        f_type = np.concatenate([graph.f_type, [fs.FUNC_AND]]).astype(np.int8)
        f_wid = np.concatenate([graph.f_wid, [0]]).astype(np.int32)
        f_feat = np.concatenate([graph.f_feat, [0.0]]).astype(np.float32)
        f_arity = np.concatenate([arity, [1]]).astype(np.int16)

        # --- per-position metadata -------------------------------------------
        var_card = np.ones(P, np.int32)
        var_role = np.full(P, fs.ROLE_EVIDENCE, np.int32)
        var_init = np.zeros(P, np.int32)
        real = vid_of_pos >= 0
        var_card[real] = graph.var_card[vid_of_pos[real]]
        var_role[real] = graph.var_role[vid_of_pos[real]]
        var_init[real] = graph.var_init[vid_of_pos[real]]
        K = int(graph.var_card.max()) if V else 1

        # --- sparse per-combination weight TABLE (FUNC 12 sparse variant) ----
        # dense mixed-radix table per sparse factor: entry for combination
        # (v_0..v_{a-1}) lives at base_f + Σ_j v_j·stride_j; combinations with
        # no entry point at the reserved zero weight (index n_weights), so the
        # device lookup needs NO mask (SURVEY.md §7 hard-part 3: hash-free).
        ZERO_WID = graph.n_weights
        has_cw = graph.cw_fid is not None and len(graph.cw_fid) > 0
        if has_cw and n_hub:
            raise ValueError(
                f"sparse per-combination weights cannot combine with hub-tier "
                f"variables yet ({n_hub} variables exceed hub_cap={hub_cap}); "
                "raise hub_cap or use dense weights")
        if has_cw:
            f_cwbase_full = np.full(F + 1, -1, np.int64)
            f_cwstride_full = np.zeros((F + 1, A), np.int64)
            edge_cards = graph.var_card[graph.e_vid].astype(np.int64)
            sparse_f = np.unique(graph.cw_fid)
            sizes = np.zeros(F + 1, np.int64)
            for f in sparse_f:
                lo, hi = graph.f_ptr[f], graph.f_ptr[f + 1]
                cards = edge_cards[lo:hi]
                # row-major over edge order: stride_j = Π_{l>j} card_l
                strides = np.concatenate(
                    [np.cumprod(cards[::-1])[::-1][1:], [1]])
                f_cwstride_full[f, : hi - lo] = strides
                sizes[f] = int(np.prod(cards))
            Tcw = int(sizes.sum())
            if Tcw > (1 << 28):
                raise ValueError(
                    f"sparse combination tables too large ({Tcw} entries); "
                    "cap is 2^28 — split the factor or use dense weights")
            bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            f_cwbase_full[sparse_f] = bases[sparse_f]
            m = (graph.cw_cats.astype(np.int64)
                 * f_cwstride_full[graph.cw_fid, : graph.cw_cats.shape[1]]
                 ).sum(axis=1)
            cwt_wid = np.full(max(Tcw, 1), ZERO_WID, np.int32)
            cwt_wid[f_cwbase_full[graph.cw_fid] + m] = graph.cw_wid
            f_cwbase = f_cwbase_full.astype(np.int32)
            f_cwstride = f_cwstride_full.astype(np.int32)
        else:
            cwt_wid = np.full(1, ZERO_WID, np.int32)
            f_cwbase = np.full(1, -1, np.int32)
            f_cwstride = np.zeros((1, 1), np.int32)

        # --- shared per-factor derived arrays --------------------------------
        all_boolean = bool((graph.var_dtype == fs.DTYPE_BOOLEAN).all()
                           and (graph.e_eqpred == 1).all() and not has_cw)
        present_all = tuple(sorted(int(t) for t in np.unique(graph.f_type)))
        assert A < (1 << 15) and np.max(graph.f_type, initial=0) < (1 << 7)
        # factor -> min member position (dummy/pad factors -> P: never matches)
        f_minpos = np.where(f_mask, f_vids, np.int32(P)).min(axis=1)
        # factor -> touches an evidence variable
        f_touch = ((var_role[f_vids] == fs.ROLE_EVIDENCE) & f_mask).any(axis=1)

        # pair (factor, position) streams for per-tier incidence CSRs
        up = pos_of_vid[uv]                       # position per pair
        rloc = up % B                             # row within color block
        tier_of_pair = tier_of_v[uv]

    tiers = []
    tier_infos = []
    for t in range(T):
        sel = tier_of_pair == t
        if t == hub_tier:
            ts, ti = _build_hub_tier(
                int(off[t]), int(Bt[t]), C, B, P, DUMMY,
                up[sel], uf[sel], rloc[sel],
                f_vids, f_ispos, f_eqpred, f_mask, f_type, f_arity, f_wid,
                f_feat, f_minpos, f_touch,
                var_card, var_role,
                K, eq_dtype, all_boolean, hub_chunk, shards)
        else:
            ts, ti = _build_tier(
                t, int(off[t]), int(Bt[t]), C, B, P, DUMMY,
                up[sel], uf[sel], rloc[sel],
                f_vids, f_ispos, f_eqpred, f_mask, f_type, f_arity, f_wid,
                f_feat, f_minpos, f_touch, f_cwbase, f_cwstride,
                var_card, var_role,
                A, K, eq_dtype, all_boolean, has_cw,
                bool(try_band_t[t]), band_tile, band_wmax, native)
        tiers.append(ts)
        tier_infos.append(ti)

    dg = DeviceGraph(
        f_vids=f_vids, f_ispos=f_ispos, f_eqpred=f_eqpred, f_mask=f_mask,
        f_type=f_type, f_wid=f_wid, f_feat=f_feat, f_arity=f_arity,
        var_card=var_card, var_role=var_role, var_init=var_init,
        pos_of_vid=pos_of_vid.astype(np.int32),
        w_init=np.append(graph.w_init, 0.0).astype(np.float32),
        w_fixed=np.append(graph.w_fixed, True).astype(bool),
        cwt_wid=cwt_wid, f_cwbase=f_cwbase, f_cwstride=f_cwstride,
        tiers=tuple(tiers),
    )
    info = CompileInfo(
        n_vars=V, n_factors=F, n_weights=graph.n_weights, n_colors=C,
        max_arity=A, max_degree=int(degree_v.max()) if V else 1,
        max_card=K,
        block_size=B,
        present_funcs=present_all,
        all_boolean=all_boolean,
        band_w=max((ti.band_w for ti in tier_infos), default=0),
        band_tb=band_tile,
        bounds=all(ti.bounds for ti in tier_infos),
        affine2=any(ti.affine2 for ti in tier_infos),
        affinek=any(ti.affinek for ti in tier_infos),
        fusedm=any(ti.fusedm for ti in tier_infos),
        has_hub=n_hub > 0,
        has_sparse_cw=has_cw,
        tiers=tuple(tier_infos),
    )
    return dg, info


def _build_tier(t: int, off_t: int, Bt: int, C: int, B: int, P: int,
                DUMMY: int, up, uf, rloc,
                f_vids, f_ispos, f_eqpred, f_mask, f_type, f_arity, f_wid,
                f_feat, f_minpos, f_touch, f_cwbase, f_cwstride,
                var_card, var_role,
                A: int, K: int, eq_dtype, all_boolean: bool, has_cw: bool,
                try_band: bool, band_tile: int,
                band_wmax: int,
                native: bool) -> tuple[TierStreams, TierInfo]:
    """Assemble one tier's streams.

    (up, uf, rloc): this tier's (position, factor, row-in-color-block)
    incidence pairs; f_* arrays are the GLOBAL padded factor arrays with
    row stride A — this tier only reads the leading A_t columns (its
    incident factors all have arity <= A_t by construction).  ``native``:
    as ``fill_streams`` takes it.
    """
    # degree per tier-local row
    rows_t = (up // B) * Bt + (rloc - off_t)   # [n_pairs] in [0, C*Bt)
    deg_rows = np.bincount(rows_t, minlength=C * Bt)
    D = max(int(deg_rows.max()) if len(rows_t) else 1, 1)
    A_t = max(int(f_arity[uf].max()) if len(uf) else 1, 1)
    present_t = (tuple(sorted(int(x) for x in np.unique(f_type[uf])))
                 if len(uf) else ())

    # variable(row) → DISTINCT incident factors [C*Bt, D]
    v_fidx = np.full((C * Bt, D), f_vids.shape[0] - 1, np.int32)
    order = np.argsort(rows_t, kind="stable")
    sp, sf = rows_t[order], uf[order]
    starts = np.searchsorted(sp, np.arange(C * Bt))
    posn = np.arange(len(sp)) - starts[sp]
    v_fidx[sp, posn] = sf

    A1 = A_t - 1
    cs_nbr = np.empty((C, Bt, D, A1), np.int32)
    cs_ismine = np.empty((C, Bt, D, A_t), bool)
    cs_hmask = np.empty((C, Bt, D, A_t), bool)
    cs_pos = np.empty((C, Bt, D, A_t), bool)
    cs_mask = np.empty((C, Bt, D, A_t), bool)
    cs_eq = (np.ones((C, 1, 1, 1), eq_dtype) if all_boolean
             else np.empty((C, Bt, D, A_t), eq_dtype))
    cs_type = np.empty((C, Bt, D), np.int8)
    cs_arity = np.empty((C, Bt, D), np.int16)
    cs_wid = np.empty((C, Bt, D), np.int32)
    cs_feat = np.empty((C, Bt, D), np.float32)
    cs_gowner = np.empty((C, Bt, D), bool)
    cs_gtouch = np.empty((C, Bt, D), bool)
    if has_cw:
        cs_issparse = np.empty((C, Bt, D), bool)
        cs_cwbase = np.empty((C, Bt, D), np.int32)
        cs_cwstride = np.empty((C, Bt, D, A_t), np.int32)
    else:
        cs_issparse = np.zeros((C, 1, 1), bool)
        cs_cwbase = np.zeros((C, 1, 1), np.int32)
        cs_cwstride = np.zeros((C, 1, 1, 1), np.int32)

    affine_cand = bool(try_band and all_boolean and A_t == 2)
    ab_a = np.empty((C, Bt, D), np.float32) if affine_cand else None
    ab_b = np.empty((C, Bt, D), np.float32) if affine_cand else None

    outs = dict(cs_nbr=cs_nbr, cs_ismine=cs_ismine, cs_hmask=cs_hmask,
                cs_pos=cs_pos, cs_mask=cs_mask, cs_type=cs_type,
                cs_arity=cs_arity, cs_wid=cs_wid, cs_feat=cs_feat,
                cs_gowner=cs_gowner, cs_gtouch=cs_gtouch)
    if not all_boolean:
        outs["cs_eq"] = cs_eq
    if affine_cand:
        outs.update(ab_a=ab_a, ab_b=ab_b)
    if has_cw:
        outs.update(cs_issparse=cs_issparse, cs_cwbase=cs_cwbase,
                    cs_cwstride=cs_cwstride)
    with span("compile.fill_streams"):
        fill_streams(outs, native, v_fidx, f_vids, f_ispos, f_eqpred, f_mask,
                     f_type, f_arity, f_wid, f_feat, f_minpos, f_touch,
                     f_cwbase, f_cwstride, P, B, off_t, DUMMY, present_t)

    # --- banded-gather window plan / true read bounds ----------------------
    from .ops.banded import plan_banding, plan_banding_multi

    band_k = 0
    bd_rnbr = np.zeros((C, 1, 1), np.int32)
    with span("compile.banding"):
        if try_band:
            bd_start, band_w, bd_lo, bd_hi = plan_banding(
                cs_nbr, P, band_tile, band_wmax)
            if bd_start is not None:
                band_k = 1
            if C > 1 and A1 > 0 and band_k != 1:
                # single contiguous window failed (neighbors live in several
                # color blocks — any graph with >2 colors): one window per
                # source color block, gathered as one concatenated-window
                # one-hot matmul (ops/banded.py plan_banding_multi)
                st_m, w_m, k_m, rn_m, lo_m, hi_m = plan_banding_multi(
                    cs_nbr, P, band_tile, band_wmax)
                if st_m is not None and k_m >= 1:
                    bd_start, band_w, band_k = st_m, w_m, k_m
                    bd_rnbr = rn_m
                    bd_lo, bd_hi = lo_m, hi_m
        elif A1 > 0 and Bt >= 1:
            # bounds-only pass (single tile per color): keeps the halo plan
            # alive for tiers too small to band
            bd_start, band_w, bd_lo, bd_hi = plan_banding(cs_nbr, P, Bt, 0)
        else:
            # unary tier: reads nothing — empty bounds are exact
            bd_start, band_w = None, 0
            bd_lo = np.full((C, 1), P, np.int32)
            bd_hi = np.zeros((C, 1), np.int32)
    bounds = bd_lo is not None
    if bd_start is None:
        bd_start, band_w = np.zeros((C, 1), np.int32), 0
    if bd_lo is None:
        bd_lo = np.zeros((C, 1), np.int32)
        bd_hi = np.zeros((C, 1), np.int32)

    # --- fused affine color step (ops/fused.py) ----------------------------
    # single-window banding only: the fused kernel DMAs one window
    affine2 = bool(band_w > 0 and band_k == 1 and affine_cand)
    # K-candidate fused step: categorical/mixed arity<=2 tiers where every
    # real incident factor has exactly ONE own slot (repeated-variable
    # factors break the single [k == eq_own] form) and K is small enough
    # for the in-kernel candidate unroll
    cat_cand = bool(band_w > 0 and band_k == 1 and not all_boolean
                    and not has_cw and A_t == 2 and 2 <= K <= 32)
    if cat_cand:
        realrec = cs_mask.any(-1)
        cat_cand = bool(
            (cs_ismine.sum(-1)[realrec] == 1).all()) if realrec.any() \
            else False
    affinek = bool(cat_cand and not affine2)
    if affine2 or affinek:
        ntiles = bd_start.shape[1]
        TB = Bt // ntiles
        bd_nbr = (cs_nbr[..., 0].reshape(C, ntiles, TB, D)
                  .transpose(0, 1, 3, 2).reshape(C, ntiles, D * TB)
                  .copy())
    else:
        bd_nbr = np.zeros((C, 1, 1), np.int32)
    if not affine2 and not affine_cand:
        # ab_a/ab_b double as the pairwise multilinear-delta coefficients
        # (fold_deltam), so they are kept whenever the affine analysis ran
        # — even when banding failed and the fused kernel is unavailable
        ab_a = ab_b = np.zeros((C, 1, 1), np.float32)
    if affine2 or affinek:

        def _rowmaj(x):      # [C, Bt, D] -> [C, ntiles, D*TB] d-major
            return (np.ascontiguousarray(
                x.reshape(C, ntiles, TB, D).transpose(0, 1, 3, 2))
                .reshape(C, ntiles, D * TB))

    if affinek:
        from .ops.fused import affine_cat

        cka, ckb = affine_cat(cs_pos, cs_mask, cs_ismine, cs_hmask,
                              cs_type, present_t)
        cs_cka, cs_ckb = cka, ckb
        bd_eqo = _rowmaj(cs_eq[..., A_t - 1].astype(np.int32))
        bd_eqn = _rowmaj(cs_eq[..., 0].astype(np.int32))
    else:
        cs_cka = cs_ckb = np.zeros((C, 1, 1), np.float32)
        bd_eqo = bd_eqn = np.zeros((C, 1, 1), np.int32)
    if affine2:
        # moment-factored gradient kernel streams (ops/grad.py): φ(o, n)
        # is bilinear in the binary (own, neighbor) values, so the kernel
        # only needs the three moment coefficients.  ao/ax ARE the affine
        # draw analysis (ab_a/ab_b); an comes from the same φ table.  Pad
        # slots and arity-1 records get an = ax = 0 by construction (the
        # masked-pad-literal bug class of the round-4 in-kernel φ cannot
        # exist here — tests/test_grad_kernel.py unary cases).
        from .ops.fused import _phi_np

        def _gphi(o, nv):
            val = np.where(cs_ismine, o, nv)
            lits = ((val == 1) == cs_pos) & cs_mask
            nlit = lits.sum(-1, dtype=np.int32)
            na = cs_mask.sum(-1, dtype=np.int32)
            head = (lits & cs_hmask).any(-1)
            return _phi_np(nlit, head, na, cs_type, present_t)

        gd_an = _rowmaj((_gphi(0, 1) - _gphi(0, 0)).astype(np.float32))
        gd_ao = _rowmaj(ab_a.astype(np.float32))
        gd_ax = _rowmaj(ab_b.astype(np.float32))
        gd_wid = _rowmaj(cs_wid)
        gd_cown = _rowmaj(np.where(cs_gowner, cs_feat, 0.0)
                          .astype(np.float32))
        gd_ctch = _rowmaj(np.where(cs_gtouch, cs_feat, 0.0)
                          .astype(np.float32))
    else:
        gd_wid = np.zeros((C, 1, 1), np.int32)
        gd_cown = gd_ctch = np.zeros((C, 1, 1), np.float32)
        gd_ao = gd_an = gd_ax = np.zeros((C, 1, 1), np.float32)

    # --- multilinear delta-φ streams: EVERY boolean arity<=3 tier gets
    # them (the fused Pallas step takes precedence at draw time when on),
    # so the non-fused float path is identical whether or not banding
    # compiled in — bitwise parity across band modes/compilations.  The
    # KBC / arity-3 classes, where the ~40-op counts/select φ evaluation
    # is the measured per-chain VPU bound, are the perf target.
    deltam = bool(all_boolean and 2 <= A_t <= 3 and not affinek)
    if deltam and A_t == 2 and affine_cand:
        # pairwise tiers: dm_a/dm_b1 ARE the affine-analysis streams —
        # fold_deltam reads ab_a/ab_b directly, so only placeholders are
        # stored (no duplicate device image)
        dm_a = dm_b1 = dm_b2 = dm_x = np.zeros((C, 1, 1), np.float32)
    elif deltam:
        dm_a, dm_b1, dm_b2, dm_x = _deltam_streams(
            cs_ismine, cs_pos, cs_mask, cs_hmask, cs_type, present_t, A_t)
    else:
        dm_a = dm_b1 = dm_b2 = dm_x = np.zeros((C, 1, 1), np.float32)

    # --- fused multilinear draw kernel (ops/fused.py fused_dm_draw): the
    # banded boolean tiers the pairwise affine kernel can't serve — arity-3
    # (cross term b_x·n1·n2 breaks the single-matmul affine form) and/or
    # multi-window (band_k >= 2).  The draw becomes one K-window DMA, one
    # [K·W, A1·D·TB] one-hot int8 MXU gather of BOTH neighbor slots, a
    # ~6-op VPU multilinear combine, and an on-core PRNG Bernoulli — no
    # [B, D, A1, NC] literal tensor ever touches HBM (the round-5 XLA
    # multilin path's remaining cost).
    fusedm = bool(deltam and not affine2 and band_w > 0 and band_k >= 1
                  and A1 >= 1)
    if fusedm:
        nt_f = bd_start.shape[1]
        fusedm = bool(nt_f % 8 == 0 and Bt % nt_f == 0
                      and Bt // nt_f == band_tile)
    if fusedm:
        TBf = band_tile
        src = bd_rnbr if band_k >= 2 else cs_nbr.reshape(C, Bt * D * A1)
        bd_dmnbr = (src.reshape(C, nt_f, TBf, D, A1)
                    .transpose(0, 1, 4, 3, 2)
                    .reshape(C, nt_f, A1 * D * TBf).copy())
    else:
        bd_dmnbr = np.zeros((C, 1, 1), np.int32)

    # --- draw masks ---------------------------------------------------------
    cm_view = lambda a: a[:-1].reshape(C, B)[:, off_t:off_t + Bt]
    cm_card = cm_view(var_card).copy()
    cm_role = cm_view(var_role).copy()
    cm_kmask = np.where(
        np.arange(K)[None, None, :] < cm_card[:, :, None], 0.0, -1e30
    ).astype(np.float32)
    cm_resample = (cm_role == 0) & (cm_card > 1)
    cm_resample_ev = cm_card > 1

    ts = TierStreams(
        cs_nbr=cs_nbr, cs_ismine=cs_ismine, cs_hmask=cs_hmask,
        cs_pos=cs_pos, cs_eq=cs_eq, cs_mask=cs_mask,
        cs_type=cs_type, cs_arity=cs_arity, cs_wid=cs_wid, cs_feat=cs_feat,
        cs_gowner=cs_gowner, cs_gtouch=cs_gtouch,
        cs_issparse=cs_issparse, cs_cwbase=cs_cwbase,
        cs_cwstride=cs_cwstride,
        bd_start=bd_start, bd_rnbr=bd_rnbr, bd_lo=bd_lo, bd_hi=bd_hi,
        bd_nbr=bd_nbr, ab_a=ab_a, ab_b=ab_b,
        cs_cka=cs_cka, cs_ckb=cs_ckb, bd_eqo=bd_eqo, bd_eqn=bd_eqn,
        gd_wid=gd_wid, gd_cown=gd_cown, gd_ctch=gd_ctch,
        gd_ao=gd_ao, gd_an=gd_an, gd_ax=gd_ax,
        dm_a=dm_a, dm_b1=dm_b1, dm_b2=dm_b2, dm_x=dm_x,
        bd_dmnbr=bd_dmnbr,
        cm_kmask=cm_kmask, cm_resample=cm_resample,
        cm_resample_ev=cm_resample_ev,
        hb_row=np.zeros((C, 1), np.int32),
    )
    ti = TierInfo(
        off=off_t, block=Bt, degree=D, arity=A_t,
        band_w=band_w, band_tb=band_tile if band_w else 0,
        band_k=band_k,
        bounds=bounds, affine2=affine2, affinek=affinek, deltam=deltam,
        fusedm=fusedm,
        present_funcs=present_t,
    )
    return ts, ti


def _build_hub_tier(off_t: int, Bt: int, C: int, B: int, P: int,
                    DUMMY: int, up, uf, rloc,
                    f_vids, f_ispos, f_eqpred, f_mask, f_type, f_arity,
                    f_wid, f_feat, f_minpos, f_touch,
                    var_card, var_role,
                    K: int, eq_dtype, all_boolean: bool,
                    G: int, shards: int = 1) -> tuple[TierStreams, TierInfo]:
    """Assemble the chunked-CSR hub tier.

    (up, uf, rloc): this tier's (position, factor, row-in-color-block)
    incidence pairs.  Records are laid out [C, M, G, A_h]: every chunk of
    G records belongs to ONE tier-local variable row (hb_row), chunks of a
    variable are consecutive, pads point at the dummy factor / row Bt.
    The engine evaluates chunks exactly like dense-tier rows (same stream
    conventions), then segment-sums chunk contributions to rows.
    """
    n = len(uf)
    A_h = max(int(f_arity[uf].max()) if n else 1, 1)
    A1 = A_h - 1
    present_t = (tuple(sorted(int(x) for x in np.unique(f_type[uf])))
                 if n else ())

    rows_t = (up // B) * Bt + (rloc - off_t)       # [n] in [0, C*Bt)
    order = np.argsort(rows_t, kind="stable")
    sp, sf, spos = rows_t[order], uf[order], up[order]
    starts = np.searchsorted(sp, np.arange(C * Bt))
    posn = np.arange(n, dtype=np.int64) - starts[sp]
    ck_in_row = posn // G
    slot = (posn % G).astype(np.int64)
    # global chunk ids -> per-color padded chunk index
    maxck = int(ck_in_row.max()) + 1 if n else 1
    cuid = sp * maxck + ck_in_row
    uniq, inv = np.unique(cuid, return_inverse=True)
    urow = uniq // maxck                            # [n_chunks] in [0,C*Bt)
    ucol = urow // Bt
    ckcnt = np.bincount(ucol, minlength=C)
    # chunk count padded so the graph axis can split each color's chunk
    # run evenly (pad chunks map to the dummy row Bt, a dropped segment)
    M = _round_up(max(int(ckcnt.max()), 1), max(shards, 1))
    ckstart = np.searchsorted(ucol, np.arange(C))
    ulocal = np.arange(len(uniq)) - ckstart[ucol]   # chunk rank in color
    # per-record destination (color, local chunk, slot)
    rcol = ucol[inv]
    rck = ulocal[inv]

    hb_row = np.full((C, M), Bt, np.int32)          # pad -> dummy row Bt
    hb_row[ucol, ulocal] = (urow % Bt).astype(np.int32)

    def full(shape, fill, dt):
        return np.full((C, M, G) + shape, fill, dt)

    cs_nbr = full((A1,), DUMMY, np.int32)
    cs_ismine = full((A_h,), False, bool)
    cs_hmask = full((A_h,), False, bool)
    cs_pos = full((A_h,), False, bool)
    cs_mask = full((A_h,), False, bool)
    cs_eq = (np.ones((C, 1, 1, 1), eq_dtype) if all_boolean
             else full((A_h,), 0, eq_dtype))
    cs_type = full((), fs.FUNC_AND, np.int8)
    cs_arity = full((), 1, np.int16)
    cs_wid = full((), 0, np.int32)
    cs_feat = full((), 0.0, np.float32)
    cs_gowner = full((), False, bool)
    cs_gtouch = full((), False, bool)

    CHUNK = max(1, (1 << 24) // max(A_h, 1))
    take = np.take_along_axis
    iota_a = np.arange(A_h, dtype=np.int16)[None, :]
    for r0 in range(0, n, CHUNK):
        r1 = min(r0 + CHUNK, n)
        f = sf[r0:r1]
        own = spos[r0:r1].astype(np.int32)[:, None]
        mv = f_vids[f][:, :A_h]                     # [m, A_h]
        ismine = mv == own
        ar = f_arity[f]
        msk = f_mask[f][:, :A_h]
        hm = (iota_a == ar[:, None] - 1) & msk
        pos = f_ispos[f][:, :A_h]
        eq = None if all_boolean else f_eqpred[f][:, :A_h]
        if A_h == 2:
            sw = (ismine[:, 0] & ~ismine[:, 1])[:, None]

            def permute(x):
                return np.where(sw, x[:, ::-1], x)
        else:
            perm = np.argsort(ismine, axis=-1, kind="stable")

            def permute(x):
                return take(x, perm, axis=-1)

        mv_p = permute(mv)
        ismine_p = permute(ismine)
        dst = (rcol[r0:r1], rck[r0:r1], slot[r0:r1])
        cs_nbr[dst] = np.where(ismine_p, np.int32(DUMMY), mv_p)[:, :A1]
        cs_ismine[dst] = ismine_p
        cs_hmask[dst] = permute(hm)
        cs_pos[dst] = permute(pos)
        cs_mask[dst] = permute(msk)
        if not all_boolean:
            cs_eq[dst] = permute(eq)
        cs_type[dst] = f_type[f]
        cs_arity[dst] = ar
        cs_wid[dst] = f_wid[f]
        cs_feat[dst] = f_feat[f]
        gown = f_minpos[f] == own[:, 0]
        cs_gowner[dst] = gown
        cs_gtouch[dst] = gown & f_touch[f]

    # multilinear delta-φ coefficients for the hub chunks (same corner
    # construction as the dense tiers; the hub draw segment-sums chunk
    # deltas onto rows, so per-chunk coefficients compose directly)
    deltam = bool(all_boolean and 2 <= A_h <= 3)
    if deltam:
        dm_a, dm_b1, dm_b2, dm_x = _deltam_streams(
            cs_ismine, cs_pos, cs_mask, cs_hmask, cs_type, present_t, A_h)
    else:
        dm_a = dm_b1 = dm_b2 = dm_x = np.zeros((C, 1, 1), np.float32)

    # row-level draw masks (rows off_t..off_t+Bt of each color block)
    cm_view = lambda a: a[:-1].reshape(C, B)[:, off_t:off_t + Bt]
    cm_card = cm_view(var_card).copy()
    cm_role = cm_view(var_role).copy()
    cm_kmask = np.where(
        np.arange(K)[None, None, :] < cm_card[:, :, None], 0.0, -1e30
    ).astype(np.float32)
    cm_resample = (cm_role == 0) & (cm_card > 1)
    cm_resample_ev = cm_card > 1

    z32 = np.zeros((C, 1), np.int32)
    ts = TierStreams(
        cs_nbr=cs_nbr, cs_ismine=cs_ismine, cs_hmask=cs_hmask,
        cs_pos=cs_pos, cs_eq=cs_eq, cs_mask=cs_mask,
        cs_type=cs_type, cs_arity=cs_arity, cs_wid=cs_wid, cs_feat=cs_feat,
        cs_gowner=cs_gowner, cs_gtouch=cs_gtouch,
        cs_issparse=np.zeros((C, 1, 1), bool),
        cs_cwbase=np.zeros((C, 1, 1), np.int32),
        cs_cwstride=np.zeros((C, 1, 1, 1), np.int32),
        bd_start=z32, bd_rnbr=np.zeros((C, 1, 1), np.int32),
        bd_lo=z32, bd_hi=z32,
        bd_nbr=np.zeros((C, 1, 1), np.int32),
        ab_a=np.zeros((C, 1, 1), np.float32),
        ab_b=np.zeros((C, 1, 1), np.float32),
        cs_cka=np.zeros((C, 1, 1), np.float32),
        cs_ckb=np.zeros((C, 1, 1), np.float32),
        bd_eqo=np.zeros((C, 1, 1), np.int32),
        bd_eqn=np.zeros((C, 1, 1), np.int32),
        gd_wid=np.zeros((C, 1, 1), np.int32),
        gd_cown=np.zeros((C, 1, 1), np.float32),
        gd_ctch=np.zeros((C, 1, 1), np.float32),
        gd_ao=np.zeros((C, 1, 1), np.float32),
        gd_an=np.zeros((C, 1, 1), np.float32),
        gd_ax=np.zeros((C, 1, 1), np.float32),
        dm_a=dm_a, dm_b1=dm_b1, dm_b2=dm_b2, dm_x=dm_x,
        bd_dmnbr=np.zeros((C, 1, 1), np.int32),
        cm_kmask=cm_kmask, cm_resample=cm_resample,
        cm_resample_ev=cm_resample_ev,
        hb_row=hb_row,
    )
    ti = TierInfo(
        off=off_t, block=Bt, degree=G, arity=A_h,
        hub=True, chunks=M, chunk_g=G, deltam=deltam,
        present_funcs=present_t,
    )
    return ts, ti


def fill_streams(outs: dict, native: bool, v_fidx, f_vids, f_ispos,
                 f_eqpred, f_mask, f_type, f_arity, f_wid, f_feat, f_minpos,
                 f_touch, f_cwbase, f_cwstride, P: int, B: int, off_t: int,
                 DUMMY: int, present_t: tuple) -> None:
    """Fill one tier's color-major streams ``outs`` (as in
    ``fill_streams_numpy``): with ``native``, on graphs without sparse
    per-combination weights, by the native library on many threads; else
    by ``fill_streams_numpy``, its plain version.  Both give the same
    arrays."""
    C, Bt, _, A_t = outs["cs_ismine"].shape
    if native and "cs_cwstride" not in outs:
        # tier rows index the GLOBAL position space: position of tier row
        # r = (r // Bt) * B + off_t + (r % Bt)
        native_mod.build_streams(
            v_fidx, f_vids, f_ispos, f_eqpred, f_mask, f_type, f_arity,
            f_wid, f_feat, np.ascontiguousarray(f_minpos, np.int32), f_touch,
            {k: a.reshape(C * Bt, *a.shape[2:]) for k, a in outs.items()},
            P, DUMMY, do_affine="ab_a" in outs, a_cols=A_t,
            row_to_pos=(B, Bt, off_t))
    else:
        fill_streams_numpy(v_fidx, f_vids, f_ispos, f_eqpred, f_mask,
                           f_type, f_arity, f_wid, f_feat, f_minpos, f_touch,
                           f_cwbase, f_cwstride, outs, B, off_t, DUMMY,
                           present_t)


def fill_streams_numpy(v_fidx, f_vids, f_ispos, f_eqpred, f_mask, f_type,
                       f_arity, f_wid, f_feat, f_minpos, f_touch, f_cwbase,
                       f_cwstride, outs: dict, B: int, off_t: int,
                       DUMMY: int, present_t: tuple) -> None:
    """The plain version of ``native.build_streams``: fill one tier's
    color-major streams ``outs`` ([C, Bt, D(, A)] arrays by field name;
    cs_eq only on graphs that are not all-boolean, ab_a/ab_b on affine
    candidates, cs_issparse/cs_cwbase/cs_cwstride on sparse-weight graphs)
    in numpy, a chunk of rows at a time."""
    C, Bt, D, A_t = outs["cs_ismine"].shape
    A1 = A_t - 1
    all_boolean = "cs_eq" not in outs
    has_cw = "cs_cwstride" in outs
    affine_cand = "ab_a" in outs
    if affine_cand:
        from .ops.fused import affine_pairwise

    def flat(name):
        a = outs[name]
        return a.reshape(C * Bt, *a.shape[2:])

    take = np.take_along_axis
    iota_a = np.arange(A_t, dtype=np.int16)[None, None, :]
    CHUNK = max(1, (1 << 24) // max(D * A_t, 1))
    n_rows = C * Bt
    for r0 in range(0, n_rows, CHUNK):
        r1 = min(r0 + CHUNK, n_rows)
        fi = v_fidx[r0:r1]                          # [n, D]
        mv = f_vids[fi][..., :A_t]                  # [n, D, A_t]
        c_of = np.arange(r0, r1, dtype=np.int64) // Bt
        own = (c_of * B + off_t
               + (np.arange(r0, r1, dtype=np.int64) % Bt)
               ).astype(np.int32)[:, None, None]
        ismine = mv == own
        ar = f_arity[fi]                            # [n, D] int16
        msk = f_mask[fi][..., :A_t]
        # head slot = original slot arity-1, pre-permutation
        hm = (iota_a == ar[..., None] - 1) & msk
        pos = f_ispos[fi][..., :A_t]
        eq = None if all_boolean else f_eqpred[fi][..., :A_t]
        cw = f_cwstride[fi][..., :A_t] if has_cw else None

        # permute each (variable, factor) slot list OWN-LAST (stable:
        # neighbor slots keep their relative order); slot A_t-1 is then
        # always own for real incident factors (n_own >= 1), so the
        # gather needs only slots :A_t-1
        if A_t == 2:
            # stable own-last = swap iff exactly slot 0 is own
            sw = (ismine[..., 0] & ~ismine[..., 1])[..., None]

            def permute(x):
                return np.where(sw, x[..., ::-1], x)
        else:
            perm = np.argsort(ismine, axis=-1, kind="stable")

            def permute(x):
                return take(x, perm, axis=-1)

        mv_p = permute(mv)
        ismine_p = permute(ismine)
        sl = slice(r0, r1)
        flat("cs_nbr")[sl] = np.where(ismine_p, np.int32(DUMMY),
                                      mv_p)[..., :A1]
        flat("cs_ismine")[sl] = ismine_p
        flat("cs_hmask")[sl] = permute(hm)
        flat("cs_pos")[sl] = permute(pos)
        flat("cs_mask")[sl] = permute(msk)
        if not all_boolean:
            flat("cs_eq")[sl] = permute(eq)
        flat("cs_type")[sl] = f_type[fi]
        flat("cs_arity")[sl] = ar
        flat("cs_wid")[sl] = f_wid[fi]
        flat("cs_feat")[sl] = f_feat[fi]
        flat("cs_gowner")[sl] = f_minpos[fi] == own[..., 0]
        flat("cs_gtouch")[sl] = flat("cs_gowner")[sl] & f_touch[fi]
        if has_cw:
            base_fi = f_cwbase[fi]
            flat("cs_issparse")[sl] = base_fi >= 0
            flat("cs_cwbase")[sl] = np.maximum(base_fi, 0)
            flat("cs_cwstride")[sl] = permute(cw)
        if affine_cand:
            aa, bb = affine_pairwise(
                flat("cs_pos")[sl], flat("cs_mask")[sl], ismine_p,
                flat("cs_hmask")[sl], flat("cs_type")[sl], present_t)
            flat("ab_a")[sl] = aa
            flat("ab_b")[sl] = bb


def _deltam_streams(cs_ismine, cs_pos, cs_mask, cs_hmask, cs_type,
                    present_t, A: int):
    """Multilinear delta-φ coefficients (dm_a, dm_b1, dm_b2, dm_x) from
    the 4 neighbor-value corners: delta(n1, n2) = φ(own=1,·) − φ(own=0,·)
    is exactly its multilinear interpolant on {0,1}^2 (any φ, log1p
    included).  For A == 2 the b2/x coefficients are identically zero and
    come back as [C, 1, 1] placeholders (fold_deltam skips them)."""
    from .ops.fused import _phi_np

    def dphi(n1, n2):
        sv = np.zeros(cs_mask.shape, np.int32)
        sv[..., 0] = n1
        if A >= 3:
            sv[..., 1] = n2

        def ph(o):
            val = np.where(cs_ismine, o, sv)
            lits = ((val == 1) == cs_pos) & cs_mask
            nlit = lits.sum(-1, dtype=np.int32)
            na = cs_mask.sum(-1, dtype=np.int32)
            head = (lits & cs_hmask).any(-1)
            return _phi_np(nlit, head, na, cs_type, present_t)

        return ph(1) - ph(0)

    C = cs_mask.shape[0]
    d00, d10 = dphi(0, 0), dphi(1, 0)
    if A < 3:
        return (d00.astype(np.float32), (d10 - d00).astype(np.float32),
                np.zeros((C, 1, 1), np.float32),
                np.zeros((C, 1, 1), np.float32))
    d01, d11 = dphi(0, 1), dphi(1, 1)
    return (d00.astype(np.float32), (d10 - d00).astype(np.float32),
            (d01 - d00).astype(np.float32),
            (d11 - d10 - d01 + d00).astype(np.float32))


def iter_arrays(dg: DeviceGraph):
    """Yield (name, array) over every array in the DeviceGraph, tiers
    included (names are 'tier{t}.{field}')."""
    for name in dg._fields:
        if name == "tiers":
            for t, ts in enumerate(dg.tiers):
                for f in ts._fields:
                    yield f"tier{t}.{f}", getattr(ts, f)
        else:
            yield name, getattr(dg, name)


# Per-record arrays stored FLAT (1-D) on device: XLA tiles the last two
# dims of every HBM array to (8, 128), so a [C, B, D, A]-class stream with
# small minor dims pads 43-205x at rest — the measured OOMs behind the
# round-4 KBC 5e5-var cap and the 4096^2 scale limit (README Limits).  A
# 1-D array has no minor dim to pad; the engine reslices + reshapes per
# use (tier_geom/_tc in engine.multichain), which XLA fuses into consumers
# without materializing the padded logical form.
FLAT_TIER_FIELDS = (
    "cs_nbr", "cs_ismine", "cs_hmask", "cs_pos", "cs_eq", "cs_mask",
    "cs_type", "cs_arity", "cs_wid", "cs_feat", "cs_gowner", "cs_gtouch",
    "cs_issparse", "cs_cwbase", "cs_cwstride", "ab_a", "ab_b", "cs_cka",
    "cs_ckb", "cm_kmask", "dm_a", "dm_b1", "dm_b2", "dm_x")
FLAT_TOP_FIELDS = ("f_vids", "f_ispos", "f_eqpred", "f_mask", "f_cwstride")


def tier_geom(ts: TierStreams, ti, C: int) -> tuple:
    """(rows, D, A) of one tier's [C, rows, D, A]-class streams.

    rows derives from the always-real cs_type array's SIZE, so it holds in
    every storage layout (flat 1-D, logical multi-D) and for numpy arrays
    and torch tensors alike."""
    D = ti.chunk_g if ti.hub else ti.degree
    return int(np.prod(ts.cs_type.shape)) // (C * D), D, ti.arity


def flatten_streams(dg: DeviceGraph) -> DeviceGraph:
    """Reshape the big per-record arrays to 1-D (host-side numpy views)."""
    tiers = tuple(
        ts._replace(**{f: getattr(ts, f).reshape(-1)
                       for f in FLAT_TIER_FIELDS})
        for ts in dg.tiers)
    return dg._replace(
        tiers=tiers,
        **{f: getattr(dg, f).reshape(-1) for f in FLAT_TOP_FIELDS})


def factor_records(dg: DeviceGraph) -> tuple:
    """(f_vids, f_ispos, f_eqpred, f_mask) in their logical [F', A] shapes,
    whatever the storage layout (flat on device, 2-D on host)."""
    Fp = dg.f_type.shape[0]

    def r2(a):
        return a if a.ndim == 2 else a.reshape(Fp, -1)

    return (r2(dg.f_vids), r2(dg.f_ispos), r2(dg.f_eqpred), r2(dg.f_mask))


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no card
    is present (the port never drifts to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@spanned("compile.to_device")
def to_device(dg: DeviceGraph, device="cuda") -> DeviceGraph:
    """Move every array to ``device`` as a torch tensor, storing the
    per-record streams FLAT (FLAT_TIER_FIELDS, FLAT_TOP_FIELDS)."""
    dev = resolve_device(device)

    def move(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    flat = flatten_streams(dg)
    tiers = tuple(TierStreams(*(move(x) for x in ts)) for ts in flat.tiers)
    return flat._replace(tiers=tiers, **{
        f: move(getattr(flat, f)) for f in flat._fields if f != "tiers"})
