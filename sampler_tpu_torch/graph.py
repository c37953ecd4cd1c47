"""Host-side factor-graph data model (NumPy structure-of-arrays).

Mirrors the reference's load-time model (ref: src/factor_graph.h FactorGraph —
recalled) but SoA from the start: variables, weights, and a CSR edge list.
`compile.py` turns this into the padded, rectangular device layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import format_spec as fs


@dataclasses.dataclass
class FactorGraph:
    """An unpadded factor graph.

    Edge arrays are CSR over factors: factor f's edges occupy
    ``e_*[f_ptr[f]:f_ptr[f+1]]``, ordered (body..., head).
    """

    # variables ------------------------------------------------------- [V]
    var_dtype: np.ndarray  # uint8, DTYPE_BOOLEAN | DTYPE_CATEGORICAL
    var_role: np.ndarray   # uint8, ROLE_QUERY | ROLE_EVIDENCE
    var_init: np.ndarray   # int32, initial / evidence value (dense index)
    var_card: np.ndarray   # int32, cardinality (2 for boolean)
    # weights --------------------------------------------------------- [W]
    w_init: np.ndarray     # float64 initial weight values
    w_fixed: np.ndarray    # bool, True = not learned
    # factors --------------------------------------------------------- [F]
    f_type: np.ndarray     # int32 factor-function enum
    f_wid: np.ndarray      # int32 weight id
    f_feat: np.ndarray     # float64 feature value
    f_ptr: np.ndarray      # int64 [F+1] CSR pointers into edge arrays
    # edges ----------------------------------------------------------- [E]
    e_vid: np.ndarray      # int32 variable id
    e_ispos: np.ndarray    # bool is_positive
    e_eqpred: np.ndarray   # int32 equal_predicate (1 for boolean edges)
    # optional: per-variable sparse-category value maps (io fidelity only)
    domains: Optional[Dict[int, np.ndarray]] = None
    # optional: SPARSE PER-COMBINATION WEIGHTS (FUNC_AND_CATEGORICAL sparse
    # variant — SURVEY.md §2b note / §7 hard-part 3).  A factor listed here
    # contributes w[cw_wid[e]]·feat when its members' joint assignment
    # equals cw_cats[e] (dense category indices, edge order), and 0 for any
    # combination with no entry; its f_wid is ignored.  [N entries total]
    cw_fid: Optional[np.ndarray] = None   # int64 factor id per entry
    cw_cats: Optional[np.ndarray] = None  # int32 [N, max_arity] (0-padded)
    cw_wid: Optional[np.ndarray] = None   # int32 weight id per entry

    # ------------------------------------------------------------------
    @property
    def n_vars(self) -> int:
        return len(self.var_card)

    @property
    def n_weights(self) -> int:
        return len(self.w_init)

    @property
    def n_factors(self) -> int:
        return len(self.f_type)

    @property
    def n_edges(self) -> int:
        return len(self.e_vid)

    def arities(self) -> np.ndarray:
        return np.diff(self.f_ptr)

    # ------------------------------------------------------------------
    def validate(self) -> "FactorGraph":
        V, W, F, E = self.n_vars, self.n_weights, self.n_factors, self.n_edges
        assert self.f_ptr[0] == 0 and self.f_ptr[-1] == E
        assert (np.diff(self.f_ptr) >= 1).all(), "factor with no edges"
        assert (self.e_vid >= 0).all() and (self.e_vid < V).all()
        assert (self.f_wid >= 0).all() and (self.f_wid < W).all()
        assert (self.var_card >= 2).all()
        assert (self.var_init >= 0).all()
        assert (self.var_init < self.var_card).all()
        bad_role = ~np.isin(self.var_role, (fs.ROLE_QUERY, fs.ROLE_EVIDENCE))
        if bad_role.any():
            v = int(np.nonzero(bad_role)[0][0])
            raise ValueError(
                f"unknown variable role {int(self.var_role[v])} on variable "
                f"{v} ({int(bad_role.sum())} total); known roles: "
                f"{fs.ROLE_QUERY}=query, {fs.ROLE_EVIDENCE}=evidence")
        bool_mask = self.var_dtype == fs.DTYPE_BOOLEAN
        assert (self.var_card[bool_mask] == 2).all()
        for t in np.unique(self.f_type):
            if int(t) not in fs.ALL_FACTOR_FUNCS:
                raise ValueError(f"unknown factor type {t}")
        if self.cw_fid is not None and len(self.cw_fid):
            arity = self.arities()
            assert (self.cw_fid >= 0).all() and (self.cw_fid < F).all()
            assert (self.cw_wid >= 0).all() and (self.cw_wid < W).all()
            assert (self.f_type[self.cw_fid] == fs.FUNC_AND_CATEGORICAL).all(), \
                "per-combination weights require FUNC_AND_CATEGORICAL"
            for e in range(len(self.cw_fid)):
                f = self.cw_fid[e]
                cats = self.cw_cats[e, : arity[f]]
                cards = self.var_card[self.e_vid[self.f_ptr[f]:self.f_ptr[f + 1]]]
                assert (cats >= 0).all() and (cats < cards).all()
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        var_card,
        factors,
        weights,
        var_role=None,
        var_init=None,
        var_dtype=None,
        w_fixed=None,
    ) -> "FactorGraph":
        """Convenience constructor from Python lists.

        ``factors`` is a list of tuples
        ``(ftype, weight_id, feature_value, edges)`` where ``edges`` is a
        list of ``(vid, ispos)`` or ``(vid, ispos, eqpred)``.  An optional
        5th element gives sparse per-combination weights as a list of
        ``(cats_tuple, weight_id)`` (FUNC_AND_CATEGORICAL only; the
        factor's own weight_id is then ignored).
        """
        var_card = np.asarray(var_card, np.int32)
        V = len(var_card)
        if var_dtype is None:
            var_dtype = np.where(var_card == 2, fs.DTYPE_BOOLEAN, fs.DTYPE_CATEGORICAL)
        if var_role is None:
            var_role = np.zeros(V, np.uint8)
        if var_init is None:
            var_init = np.zeros(V, np.int32)
        w_init = np.asarray(weights, np.float64)
        if w_fixed is None:
            w_fixed = np.zeros(len(w_init), bool)

        f_type, f_wid, f_feat, f_ptr = [], [], [], [0]
        e_vid, e_ispos, e_eqpred = [], [], []
        cw_fid, cw_cats, cw_wid = [], [], []
        for fac in factors:
            ftype, wid, feat, edges = fac[:4]
            f_type.append(ftype)
            f_wid.append(wid)
            f_feat.append(feat)
            for edge in edges:
                vid, ispos = edge[0], edge[1]
                eqpred = edge[2] if len(edge) > 2 else 1
                e_vid.append(vid)
                e_ispos.append(bool(ispos))
                e_eqpred.append(eqpred)
            f_ptr.append(len(e_vid))
            if len(fac) > 4 and fac[4]:
                for cats, cwid in fac[4]:
                    cw_fid.append(len(f_type) - 1)
                    cw_cats.append(tuple(cats))
                    cw_wid.append(cwid)
        if cw_fid:
            amax = max(len(c) for c in cw_cats)
            cats_arr = np.zeros((len(cw_cats), amax), np.int32)
            for i, c in enumerate(cw_cats):
                cats_arr[i, : len(c)] = c
            cw = dict(cw_fid=np.asarray(cw_fid, np.int64), cw_cats=cats_arr,
                      cw_wid=np.asarray(cw_wid, np.int32))
        else:
            cw = {}

        return FactorGraph(
            **cw,
            var_dtype=np.asarray(var_dtype, np.uint8),
            var_role=np.asarray(var_role, np.uint8),
            var_init=np.asarray(var_init, np.int32),
            var_card=var_card,
            w_init=w_init,
            w_fixed=np.asarray(w_fixed, bool),
            f_type=np.asarray(f_type, np.int32),
            f_wid=np.asarray(f_wid, np.int32),
            f_feat=np.asarray(f_feat, np.float64),
            f_ptr=np.asarray(f_ptr, np.int64),
            e_vid=np.asarray(e_vid, np.int32),
            e_ispos=np.asarray(e_ispos, bool),
            e_eqpred=np.asarray(e_eqpred, np.int32),
        ).validate()
