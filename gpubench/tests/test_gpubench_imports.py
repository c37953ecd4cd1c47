"""Nothing in gpubench/ names jax, jaxlib or the JAX package at the top
level, and the reference and the roofline counts import nothing of the
program (top-level module names compared whole)."""
import ast
import os

import pytest

from gpubench_cells import ROOT

BENCH = os.path.join(ROOT, "gpubench")
FILES = sorted(os.path.relpath(os.path.join(d, f), BENCH)
               for d, _, fs in os.walk(BENCH) for f in fs
               if f.endswith(".py") and "out" not in d.split(os.sep))
PROGRAM_FREE = ("reference.py", "roofline.py", "judge.py", "graphs.py",
                "trace.py", os.path.join("generators", "ising_torus.py"))


def top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", FILES)
def test_no_jax(rel):
    assert not top_names(os.path.join(BENCH, rel)) & {"jax", "jaxlib",
                                                      "flax", "sampler_tpu"}


@pytest.mark.parametrize("rel", PROGRAM_FREE)
def test_reference_side_imports_no_program(rel):
    assert "sampler_tpu_torch" not in top_names(os.path.join(BENCH, rel))


def test_prefix_is_not_the_jax_package():
    assert "sampler_tpu_torch".split(".")[0] != "sampler_tpu"
