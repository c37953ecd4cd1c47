"""Build and load the port's CUDA kernels.

Every kernel source in ``sampler_tpu_torch/csrc/`` has a plain C launcher
(``extern "C"``, pointers and ints only, returning the ``cudaError_t`` of
the launch).  At first use all sources are compiled in ONE ``nvcc`` call
into ``sampler_tpu_torch/_build/libsampler_kernels_<sha>.so`` (the sha
covers the sources and the flags, so an edited source rebuilds) and the
library is loaded with ``ctypes``.  There is no PyTorch C++ extension, so a
build takes seconds, and no lock file, so an interrupted build cannot block
the next one: the library is written under a temporary name and renamed
into place.
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
SOURCES = ("fused_color_draw.cu", "banded_gather.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
# launcher name -> argtypes (every pointer and the stream as c_void_p)
LAUNCHERS = {
    "fused_color_draw_launch": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _P, _P, _P),
    "banded_gather_launch": (_P, _I, _P, _P, _I, _I, _I, _P, _P),
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


@functools.lru_cache(maxsize=None)
def build() -> tuple:
    """Compile (when the library for these sources is missing) and load.

    Returns (ctypes.CDLL, build seconds — 0.0 when it was already built,
    the ptxas lines of nvcc's report)."""
    path = library_path()
    seconds, report = 0.0, []
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, s) for s in SOURCES)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S, check=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed ({e.returncode}):\n{e.stdout}"
                               f"\n{e.stderr}") from e
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
        report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                  if "ptxas" in ln]
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
