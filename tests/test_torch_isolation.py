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
