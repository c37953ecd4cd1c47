"""The port stands alone: it imports no JAX and nothing of sampler_tpu, and
its entry points never drift to the CPU on their own.  Checked in fresh
interpreters, since this test process has imported both packages."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "sampler_tpu_torch", "sampler_tpu_torch.compile",
    "sampler_tpu_torch.coloring", "sampler_tpu_torch.convert",
    "sampler_tpu_torch.benchgraphs", "sampler_tpu_torch.fixtures",
    "sampler_tpu_torch.oracle", "sampler_tpu_torch.ops.banded",
    "sampler_tpu_torch.ops.fused", "sampler_tpu_torch.ops.weights",
    "sampler_tpu_torch.ops._build", "sampler_tpu_torch.engine.multichain",
    "sampler_tpu_torch.engine.learn", "sampler_tpu_torch.ops.grad",
    "sampler_tpu_torch.ops.tally",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_no_sampler_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'sampler_tpu' "
        "or m.startswith('sampler_tpu.'))\n"
        "print(bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|jaxlib|sampler_tpu)\b"
                     r"[^\n]*", src, flags=re.M)
    assert not bad, bad


def test_infer_mc_without_device_raises_without_card():
    code = (
        "import torch\n"
        "from sampler_tpu_torch import compile_graph, fixtures\n"
        "from sampler_tpu_torch.compile import to_device\n"
        "from sampler_tpu_torch.engine.multichain import infer_mc\n"
        "if torch.cuda.is_available():\n"
        "    print('card'); raise SystemExit(0)\n"
        "dg, info = compile_graph(fixtures.biased_coin())\n"
        "d = to_device(dg, 'cpu')\n"
        "try:\n"
        "    infer_mc(d, d.w_init, torch.Generator(), 1, 1, info, 4)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    if proc.stdout.startswith("card"):
        pytest.skip("a CUDA device is present")
    assert proc.stdout.startswith("raised no CUDA device"), proc.stdout


def test_learn_mc_without_device_raises_without_card():
    code = (
        "import torch\n"
        "from sampler_tpu_torch import compile_graph, fixtures\n"
        "from sampler_tpu_torch.compile import to_device\n"
        "from sampler_tpu_torch.engine.learn import LearnConfig\n"
        "from sampler_tpu_torch.engine.multichain import learn_mc\n"
        "if torch.cuda.is_available():\n"
        "    print('card'); raise SystemExit(0)\n"
        "dg, info = compile_graph(fixtures.labeled_coin_graph(20))\n"
        "d = to_device(dg, 'cpu')\n"
        "try:\n"
        "    learn_mc(d, d.w_init, torch.Generator(), LearnConfig(n_epochs=1),"
        " info, 4)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    if proc.stdout.startswith("card"):
        pytest.skip("a CUDA device is present")
    assert proc.stdout.startswith("raised no CUDA device"), proc.stdout


def test_every_kernel_source_is_built_and_bound():
    """Each CUDA source of the port is compiled by ops/_build.py, each
    launcher it binds is defined with a plain C interface in one of them,
    and no source names the JAX package."""
    from sampler_tpu_torch.ops import _build

    found = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert found == sorted(_build.SOURCES)
    text = {}
    for name in found:
        with open(os.path.join(_build.CSRC, name)) as f:
            text[name] = f.read()
    for launcher in _build.LAUNCHERS:
        hits = [n for n, src in text.items()
                if re.search(rf'extern "C" int {launcher}\(', src)]
        assert len(hits) == 1, (launcher, hits)
    for name, src in text.items():
        # a kernel names what it replaces: a Pallas kernel of ops/, or (the
        # tally) the engine code that XLA fused
        assert "sm_90a" in src, name
        assert re.search(r"Replaces: sampler_tpu/(ops|engine)/", src), name
        assert not re.search(r"#include\s*[<\"](torch|ATen|jax)", src), name


def test_categorical_entry_points_raise_without_card():
    """The categorical slice's functions import without JAX, and infer_mc
    on a categorical graph with the default device raises without a
    card."""
    code = (
        "import sys, torch\n"
        "from sampler_tpu_torch import compile_graph, fixtures\n"
        "from sampler_tpu_torch.compile import to_device\n"
        "from sampler_tpu_torch.engine.multichain import (\n"
        "    color_draw_categorical, color_logits_mc, infer_mc, tally,\n"
        "    values_dtype)\n"
        "from sampler_tpu_torch.ops.fused import (fold_affine_cat,\n"
        "    fused_cat_draw, fused_cat_draw_plain)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'sampler_tpu.'))"
        " for m in sys.modules)\n"
        "if torch.cuda.is_available():\n"
        "    print('card'); raise SystemExit(0)\n"
        "dg, info = compile_graph(fixtures.categorical_graph())\n"
        "d = to_device(dg, 'cpu')\n"
        "try:\n"
        "    infer_mc(d, d.w_init, torch.Generator(), 1, 1, info, 4)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    if proc.stdout.startswith("card"):
        pytest.skip("a CUDA device is present")
    assert proc.stdout.startswith("raised no CUDA device"), proc.stdout


def test_launcher_signatures_match_their_argtypes():
    """Every launcher's C signature has as many parameters as ctypes is
    told it has (a missing pointer would shift every later argument), and
    the categorical kernel is among them."""
    from sampler_tpu_torch.ops import _build

    assert "fused_cat_draw.cu" in _build.SOURCES
    assert "fused_cat_draw_launch" in _build.LAUNCHERS
    text = ""
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            text += f.read()
    for launcher, argtypes in _build.LAUNCHERS.items():
        m = re.search(rf'extern "C" int {launcher}\(([^)]*)\)', text)
        assert m, launcher
        assert len(m.group(1).split(",")) == len(argtypes), launcher
