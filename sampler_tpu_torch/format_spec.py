"""Copy of sampler_tpu.format_spec (the port imports nothing of the JAX
package).

Single source of truth for the on-disk factor-graph format and enums.

The reference (HazyResearch/sampler, a.k.a. the DimmWitted Gibbs sampler —
see SURVEY.md §2a; the reference sources were unavailable, so byte widths
are centralized HERE so a later correction against real fixtures is a one-line
change) stores a factor graph in five big-endian binary files plus a one-line
metadata CSV:

    metadata CSV: numWeights,numVariables,numFactors,numEdges,
                  weightsFile,variablesFile,factorsFile,edgesFile
    weights:   weightId:i64, isFixed:u8, initialValue:f64
    variables: variableId:i64, role:u8 (0=query,1=evidence),
               initialValue:i64, dataType:u16 (0=bool,1=categorical),
               cardinality:i64
    factors:   factorType:u16, arity:i64,
               arity * (variableId:i64, isPositive:u8
                        [+ equalPredicate:i64 for categorical factor types]),
               weightId:i64, featureValue:f64
    domains:   variableId:i64, cardinality:i64, cardinality * value:i64
               (maps sparse category values to dense 0..k-1 indices)

All integers are BIG-ENDIAN (network order), matching the reference's
htobe/be64toh convention (ref: src/binary_format.cc — recalled path).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Byte-level dtypes (big-endian).  Change HERE if real fixtures disagree.
# ---------------------------------------------------------------------------
BE_I64 = np.dtype(">i8")
BE_U64 = np.dtype(">u8")
BE_U32 = np.dtype(">u4")
BE_U16 = np.dtype(">u2")
BE_U8 = np.dtype(">u1")
BE_F64 = np.dtype(">f8")

WEIGHT_RECORD = np.dtype([("wid", BE_I64), ("is_fixed", BE_U8), ("init", BE_F64)])
VARIABLE_RECORD = np.dtype(
    [
        ("vid", BE_I64),
        ("role", BE_U8),
        ("init", BE_I64),
        ("dtype", BE_U16),
        ("card", BE_I64),
    ]
)
# Factor records are variable-length (arity-dependent); see io/binary.py.

# OLD two-file layout (SURVEY.md §2a: "older revisions used a separate
# edges file").  When the metadata CSV names a non-empty edges file, the
# factors file holds fixed-width records and member edges live in their own
# file.  Field widths are [R, medium-confidence] like the rest — centralized
# here for one-line correction against real fixtures.
OLD_FACTOR_RECORD = np.dtype(
    [("ftype", BE_U16), ("arity", BE_I64), ("wid", BE_I64), ("feat", BE_F64)]
)
EDGE_RECORD = np.dtype(
    [
        ("vid", BE_I64),
        ("fid", BE_I64),
        ("position", BE_I64),
        ("ispos", BE_U8),
        ("eqpred", BE_I64),
    ]
)

# Sparse per-combination weights (FUNC_AND_CATEGORICAL sparse variant —
# SURVEY.md §2b note).  The reference's on-disk encoding was unverifiable
# (empty mount, §0), so the capability is exposed through an OPTIONAL sixth
# file "<factors>.cweights": per entry, factorIndex:i64, weightId:i64, then
# arity(factor) × categoryValue:i64 (sparse values, translated through the
# domains file like equal-predicates).
CWEIGHT_HEADER = np.dtype([("fid", BE_I64), ("wid", BE_I64)])

# ---------------------------------------------------------------------------
# Variable roles / data types
# ---------------------------------------------------------------------------
ROLE_QUERY = 0
ROLE_EVIDENCE = 1

DTYPE_BOOLEAN = 0
DTYPE_CATEGORICAL = 1

# ---------------------------------------------------------------------------
# Factor-function enum (ref: src/factor.h FACTOR_FUNCTION_TYPE — recalled).
# Semantics are specified exactly in factor_functions.py and enforced by
# truth-table tests; enum VALUES are the wire format.
# ---------------------------------------------------------------------------
FUNC_IMPLY_NATURAL = 0
FUNC_OR = 1
FUNC_AND = 2
FUNC_EQUAL = 3
FUNC_ISTRUE = 4
FUNC_LINEAR = 7
FUNC_RATIO = 8
FUNC_LOGICAL = 9
FUNC_AND_CATEGORICAL = 12
FUNC_IMPLY_MLN = 13

ALL_FACTOR_FUNCS = (
    FUNC_IMPLY_NATURAL,
    FUNC_OR,
    FUNC_AND,
    FUNC_EQUAL,
    FUNC_ISTRUE,
    FUNC_LINEAR,
    FUNC_RATIO,
    FUNC_LOGICAL,
    FUNC_AND_CATEGORICAL,
    FUNC_IMPLY_MLN,
)

# Factor types whose edges carry an equalPredicate field on disk.
CATEGORICAL_FUNCS = frozenset({FUNC_AND_CATEGORICAL})

FUNC_NAMES = {
    FUNC_IMPLY_NATURAL: "IMPLY_NATURAL",
    FUNC_OR: "OR",
    FUNC_AND: "AND",
    FUNC_EQUAL: "EQUAL",
    FUNC_ISTRUE: "ISTRUE",
    FUNC_LINEAR: "LINEAR",
    FUNC_RATIO: "RATIO",
    FUNC_LOGICAL: "LOGICAL",
    FUNC_AND_CATEGORICAL: "AND_CATEGORICAL",
    FUNC_IMPLY_MLN: "IMPLY_MLN",
}
