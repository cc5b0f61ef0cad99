"""No file under ``benchmark/`` imports JAX or the JAX package, and the
plain reference imports nothing of the port. Top-level names are compared
whole: ``quadruped_gym_tpu_torch`` begins with ``quadruped_gym_tpu``."""

import ast
import os

import pytest

from benchmark.tests._bench import ROOT

BENCH = os.path.join(ROOT, "benchmark")
BANNED = {"jax", "jaxlib", "flax", "quadruped_gym_tpu"}


def _files():
    for d, _, names in os.walk(BENCH):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(d, n)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_banned_import(path):
    names = set(top_level_imports(path))
    assert not names & BANNED, sorted(names & BANNED)
    if os.path.relpath(path, BENCH).startswith("reference" + os.sep):
        assert "quadruped_gym_tpu_torch" not in names
        assert "benchmark" not in names or path.endswith("__init__.py")


def test_checker_compares_whole_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import quadruped_gym_tpu_torch.ops\nfrom jax import numpy\n")
    assert sorted(top_level_imports(str(p))) == ["jax", "quadruped_gym_tpu_torch"]
