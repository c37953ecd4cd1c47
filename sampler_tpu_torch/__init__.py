"""sampler_tpu_torch — the factor-graph Gibbs engine on PyTorch and CUDA.

A port of the JAX package ``sampler_tpu`` to PyTorch with kernels written
by hand for NVIDIA Hopper (``csrc/``, built with nvcc at first use).  It
imports nothing of the JAX package: the numpy host side (graph model,
coloring, compile, oracle, fixtures) is a copy.  The JAX package stays the
reference that the tests hold the port to.

Ported so far: multi-chain marginal inference on all-boolean graphs
(``engine.multichain.infer_mc``), with the ``fused_color_draw`` and
``banded_gather`` kernels, and multi-chain weight learning on the same
graphs (``engine.multichain.learn_mc``), with the ``grad_pair_tile``
kernel.
"""
from .graph import FactorGraph
from .compile import compile_graph, to_device, DeviceGraph, CompileInfo
from .convert import from_jax
from . import format_spec, fixtures, oracle, factor_functions

__all__ = [
    "FactorGraph", "compile_graph", "to_device", "DeviceGraph", "CompileInfo",
    "from_jax", "format_spec", "fixtures", "oracle", "factor_functions",
]
