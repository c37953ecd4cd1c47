"""The port's native host library (counterpart of sampler_tpu/native.py).

``csrc/host/sampler_native.cpp`` parses factor files, colors the graph
greedily and fills the color-major streams on many threads.  It is host
code, built at first use by the host C++ compiler (``g++``, or ``$CXX``)
into ``sampler_tpu_torch/_build/libsampler_native_<sha>.so`` and loaded
with ``ctypes``; the sha covers the source and the flags, so an edited
source rebuilds.  As in ``ops/_build.py`` there is no lock file: the
library is written under a name of this process and renamed into place,
so processes that build at once each load a whole library.

Unlike the JAX package, nothing here falls back to numpy: a failed build
raises with the compiler's output.  The numpy routes stay as the plain
versions, and run only when a caller asks for them
(``greedy_coloring(native=False)``, ``compile_graph(native=False)``,
``io.binary.read_factors(native=False)``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

from . import format_spec as fs
from .observe import span

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host", "sampler_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")
ABI_VERSION = "sampler-native-0.3"
BUILD_TIMEOUT_S = 300

_P = ctypes.c_void_p
_L = ctypes.c_int64
# exported function -> (argtypes, restype)
FUNCTIONS = {
    "sampler_count_factors": ((_P, _L, _P, _L, _P, _P), _L),
    "sampler_parse_factors": ((_P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P),
                              _L),
    "sampler_greedy_color": ((_L, _L, _P, _P, _P), _L),
    "sampler_build_streams": ((_L,) * 12 + (_P,) * 25, _L),
    "sampler_native_version": ((), ctypes.c_char_p),
}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++ or $CXX) found: the "
                           "native host library cannot be built")
    return cxx


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libsampler_native_{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def build() -> tuple:
    """Compile (when the library for this source is missing) and load.

    Returns (ctypes.CDLL, build seconds: 0.0 when it was already built).
    Raises with the compiler's output when the build fails, and when the
    library reports another ABI version."""
    path = library_path()
    seconds = 0.0
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE]
        try:
            try:
                with span("build.native"):
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True, timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"building the native host library "
                                   f"failed: {' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the native host library failed "
                    f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in FUNCTIONS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    got = lib.sampler_native_version().decode()
    if got != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI {got}, expected {ABI_VERSION}")
    return lib, seconds


def version() -> str:
    return build()[0].sampler_native_version().decode()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _need(a, name: str, dtype, ndim: int | None = None) -> np.ndarray:
    """``a`` itself when it is a C-contiguous ``dtype`` array (of rank
    ``ndim``), what a pointer handed to the library must be; raises
    otherwise."""
    if not isinstance(a, np.ndarray) or a.dtype != np.dtype(dtype):
        raise TypeError(f"{name}: expected a numpy {np.dtype(dtype)} array, "
                        f"got {getattr(a, 'dtype', type(a))}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous")
    if ndim is not None and a.ndim != ndim:
        raise ValueError(f"{name} has shape {a.shape}, expected rank {ndim}")
    return a


def _cat_table() -> np.ndarray:
    t = np.zeros(max(fs.ALL_FACTOR_FUNCS) + 1, np.uint8)
    t[sorted(fs.CATEGORICAL_FUNCS)] = 1
    return t


def parse_factors(buf: bytes):
    """Parse a factors file's bytes: (f_type, f_wid, f_feat, f_ptr, e_vid,
    e_ispos, e_eqpred), the tuple of ``io.binary.read_factors``.  Returns
    None when the file is malformed (the library's return code is
    nonzero); the caller re-reads it with the plain reader for the error
    and its byte offset."""
    lib = build()[0]
    data = np.frombuffer(buf, np.uint8)
    cat = _cat_table()
    nf, ne = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.sampler_count_factors(_ptr(data), len(data), _ptr(cat),
                                   len(cat), ctypes.byref(nf),
                                   ctypes.byref(ne))
    if rc != 0:
        return None
    F, E = nf.value, ne.value
    f_type = np.empty(F, np.int32)
    f_wid = np.empty(F, np.int32)
    f_feat = np.empty(F, np.float64)
    f_ptr = np.empty(F + 1, np.int64)
    e_vid = np.empty(E, np.int64)
    e_ispos = np.empty(E, np.uint8)
    e_eq = np.empty(E, np.int64)
    lib.sampler_parse_factors(_ptr(data), len(data), _ptr(cat), len(cat),
                              _ptr(f_type), _ptr(f_wid), _ptr(f_feat),
                              _ptr(f_ptr), _ptr(e_vid), _ptr(e_ispos),
                              _ptr(e_eq))
    return (f_type, f_wid, f_feat, f_ptr, e_vid, e_ispos.astype(bool), e_eq)


def greedy_color(n_vars: int, f_ptr, e_vid) -> np.ndarray:
    """Greedy load-balanced coloring (largest degree first): int32 [V]."""
    f_ptr = np.ascontiguousarray(f_ptr, np.int64)
    e_vid = np.ascontiguousarray(e_vid, np.int64)
    if len(f_ptr) < 1 or f_ptr[-1] != len(e_vid):
        raise ValueError(f"f_ptr ends at {f_ptr[-1] if len(f_ptr) else None},"
                         f" {len(e_vid)} edges")
    if len(e_vid) and (e_vid.min() < 0 or e_vid.max() >= n_vars):
        raise ValueError(f"a variable id lies outside [0, {n_vars})")
    colors = np.empty(n_vars, np.int32)
    if n_vars == 0:
        return colors
    n = build()[0].sampler_greedy_color(n_vars, len(f_ptr) - 1, _ptr(f_ptr),
                                        _ptr(e_vid), _ptr(colors))
    if n <= 0:
        raise RuntimeError(f"native coloring failed ({n})")
    return colors


# the stream outputs, in the library's argument order, with their dtypes
# and ranks ([rows, D, A] or [rows, D]); cs_eq, ab_a and ab_b are optional
_STREAM_OUTS = (("cs_nbr", np.int32, 3), ("cs_ismine", np.bool_, 3),
                ("cs_hmask", np.bool_, 3), ("cs_pos", np.bool_, 3),
                ("cs_mask", np.bool_, 3), ("cs_eq", None, 3),
                ("cs_type", np.int8, 2), ("cs_arity", np.int16, 2),
                ("cs_wid", np.int32, 2), ("cs_feat", np.float32, 2),
                ("cs_gowner", np.bool_, 2), ("cs_gtouch", np.bool_, 2),
                ("ab_a", np.float32, 2), ("ab_b", np.float32, 2))


def build_streams(v_fidx, f_vids, f_ispos, f_eqpred, f_mask, f_type,
                  f_arity, f_wid, f_feat, f_minpos, f_touch, outs: dict,
                  P: int, dummy_pos: int, do_affine: bool, a_cols: int,
                  row_to_pos: tuple, n_threads: int = 0) -> None:
    """Fill one tier's color-major incidence streams on many threads.

    ``outs`` maps field name -> a preallocated C-contiguous array shaped
    [n_rows, D(, A)] (compile.py passes its [C, B_t, ...] outputs reshaped
    flat); ``cs_eq`` is absent on all-boolean graphs and ``ab_a``/``ab_b``
    unless ``do_affine``.  ``a_cols``: the columns emitted (the tier's
    arity; the f_* arrays keep their global-arity row stride).
    ``row_to_pos = (B_full, Bt, off_t)``: tier row r sits at global
    position (r // Bt) * B_full + off_t + (r % Bt).  Sparse-combination
    streams are not filled here (compile.py keeps them on numpy)."""
    v_fidx = _need(v_fidx, "v_fidx", np.int32, 2)
    n_rows, D = v_fidx.shape
    f_vids = _need(f_vids, "f_vids", np.int32, 2)
    Fp, A_stride = f_vids.shape
    if not 1 <= a_cols <= A_stride:
        raise ValueError(f"a_cols {a_cols} outside [1, {A_stride}]")
    if n_rows and (v_fidx.min() < 0 or v_fidx.max() >= Fp):
        raise ValueError(f"a factor index lies outside [0, {Fp})")
    ins = [("f_ispos", f_ispos, np.bool_, (Fp, A_stride)),
           ("f_mask", f_mask, np.bool_, (Fp, A_stride)),
           ("f_type", f_type, np.int8, (Fp,)),
           ("f_arity", f_arity, np.int16, (Fp,)),
           ("f_wid", f_wid, np.int32, (Fp,)),
           ("f_feat", f_feat, np.float32, (Fp,)),
           ("f_minpos", f_minpos, np.int32, (Fp,)),
           ("f_touch", f_touch, np.bool_, (Fp,))]
    args = {}
    for name, a, dtype, shape in ins:
        args[name] = _need(a, name, dtype)
        if a.shape != shape:
            raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    eq = outs.get("cs_eq")
    if eq is not None:
        if eq.dtype not in (np.int16, np.int32):
            raise TypeError(f"cs_eq has dtype {eq.dtype}")
        args["f_eqpred"] = _need(f_eqpred, "f_eqpred", eq.dtype, 2)
        if f_eqpred.shape != (Fp, A_stride):
            raise ValueError(f"f_eqpred has shape {f_eqpred.shape}")
    A1 = a_cols - 1
    out_ptrs = []
    for name, dtype, ndim in _STREAM_OUTS:
        a = outs.get(name)
        if a is None:
            if name == "cs_eq" or (name.startswith("ab_") and not do_affine):
                out_ptrs.append(None)
                continue
            raise ValueError(f"outs lacks {name}")
        _need(a, name, dtype or eq.dtype, ndim)
        want = ((n_rows, D, A1 if name == "cs_nbr" else a_cols) if ndim == 3
                else (n_rows, D))
        if a.shape != want:
            raise ValueError(f"{name} has shape {a.shape}, expected {want}")
        out_ptrs.append(_ptr(a))
    B_full, Bt, off_t = row_to_pos
    null = ctypes.c_void_p()
    rc = build()[0].sampler_build_streams(
        n_rows, D, a_cols, A_stride, P, dummy_pos, B_full, Bt, off_t,
        1 if eq is not None and eq.dtype == np.int16 else 0,
        1 if do_affine else 0, n_threads,
        _ptr(v_fidx), _ptr(f_vids), _ptr(args["f_ispos"]),
        _ptr(args["f_eqpred"]) if eq is not None else null,
        _ptr(args["f_mask"]), _ptr(args["f_type"]), _ptr(args["f_arity"]),
        _ptr(args["f_wid"]), _ptr(args["f_feat"]), _ptr(args["f_minpos"]),
        _ptr(args["f_touch"]), *(p if p is not None else null
                                 for p in out_ptrs))
    if rc != 0:
        raise RuntimeError(f"native build_streams failed (rc={rc})")
