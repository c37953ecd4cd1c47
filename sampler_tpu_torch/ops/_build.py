"""Build and load the port's CUDA kernels.

Every kernel source in ``sampler_tpu_torch/csrc/`` has a plain C launcher
(``extern "C"``, pointers and ints only, returning the ``cudaError_t`` of
the launch).  At first use every source is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into ``sampler_tpu_torch/_build/libsampler_kernels_<sha>.so`` (the sha
covers the sources and the flags, so an edited source rebuilds); the
library is loaded with ``ctypes``.  There is no PyTorch C++ extension, so a
build takes seconds, and no lock file, so an interrupted build cannot block
the next one: objects and the library are written under names of this
process and the library is renamed into place.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fused_color_draw.cu", "banded_gather.cu", "grad_pair_tile.cu",
           "banded_gather_multi.cu", "fused_dm_draw.cu", "fused_cat_draw.cu",
           "tally_counts.cu", "dm_gather_draw.cu", "grad_records.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# launcher name -> argtypes (every pointer and the stream as c_void_p)
LAUNCHERS = {
    "fused_color_draw_launch": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _P, _P, _P, _I, _P),
    "banded_gather_launch": (_P, _I, _P, _P, _I, _I, _I, _P, _P),
    "grad_pair_tile_launch": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P, _P),
    "banded_gather_multi_launch": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                                   _P),
    "fused_dm_draw_launch": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P, _P, _P, _I, _P),
    "fused_cat_draw_launch": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _P, _P, _P, _I, _P),
    "tally_counts_launch": (_P, _L, _I, _I, _P, _I, _P),
    "dm_gather_draw_launch": (_P, _I, _I, _P, _I, _P, _I, _P),
    "grad_records_launch": (_P, _P, _I, _I, _L, _P, _P, _P, _P, _P, _P, _I,
                            _P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I,
                            _I, _P, _P),
    "grad_records_sum_launch": (_P, _P, _I, _I, _L, _P, _I, _I, _P, _P, _I,
                                _P, _I, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libsampler_kernels_{h.hexdigest()[:16]}.so")


def _run(procs) -> str:
    """Wait for every (name, Popen) and return their joined output; raise
    with the output of the first that failed."""
    outputs, failed = [], None
    for name, proc in procs:
        try:
            out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outputs.append(out + err)
        if proc.returncode != 0 and failed is None:
            failed = (name, proc.returncode, out + err)
    if failed is not None:
        raise RuntimeError(f"nvcc failed on {failed[0]} ({failed[1]}):\n"
                           f"{failed[2]}")
    return "".join(outputs)


@functools.lru_cache(maxsize=None)
def build() -> tuple:
    """Compile (when the library for these sources is missing) and load.

    Returns (ctypes.CDLL, build seconds — 0.0 when it was already built,
    the ptxas lines of nvcc's report)."""
    path = library_path()
    seconds, report = 0.0, []
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        objs = [os.path.join(BUILD_DIR, f"{s[:-3]}.{tag}.o") for s in SOURCES]
        t0 = time.perf_counter()
        try:
            text = _run([(src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                 os.path.join(CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                for src, obj in zip(SOURCES, objs)])
            tmp = f"{path}.{tag}"
            _run([("link", subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", tmp, *objs],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
        report = [ln.strip() for ln in text.splitlines()
                  if "ptxas" in ln or "spill" in ln]
    lib = ctypes.CDLL(path)
    for name, argtypes in LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, seconds, report


def launch(name: str, *args) -> None:
    """Call launcher ``name`` and raise if it reports a CUDA error."""
    err = getattr(build()[0], name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check_tensor(t, name: str, dtype, device, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on ``device`` — what a launcher needs of each pointer it is given."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
