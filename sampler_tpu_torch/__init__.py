"""sampler_tpu_torch — the factor-graph Gibbs engine on PyTorch and CUDA.

A port of the JAX package ``sampler_tpu`` to PyTorch with kernels written
by hand for NVIDIA Hopper (``csrc/``, built with nvcc at first use).  It
imports nothing of the JAX package: the numpy host side (graph model,
coloring, compile, oracle, fixtures) is a copy.  The JAX package stays the
reference that the tests hold the port to.

Ported so far: multi-chain marginal inference and weight learning
(``engine.multichain.infer_mc``, ``learn_mc``) on boolean, categorical,
mixed, arity-3, multi-window and hub-tier (KBC) graphs, with dense or
sparse per-combination weights, through nine CUDA kernels (``ops/``);
the single-chain ``engine.gibbs.infer`` and ``engine.learn.learn``; the
binary and text graph files (``io/``), checkpoints (``checkpoint``) and
the ``dw``-compatible command line (``python -m sampler_tpu_torch.cli``);
chain and graph sharding over ``torch.distributed`` (``parallel/``: a
mesh of ranks, one process a rank, NCCL or Gloo).
"""
from .graph import FactorGraph
from .compile import compile_graph, to_device, DeviceGraph, CompileInfo
from .convert import from_jax
from . import format_spec, fixtures, oracle, factor_functions

__all__ = [
    "FactorGraph", "compile_graph", "to_device", "DeviceGraph", "CompileInfo",
    "from_jax", "format_spec", "fixtures", "oracle", "factor_functions",
]
