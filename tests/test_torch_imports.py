"""The PyTorch port stands alone: no module of ``quadruped_gym_tpu_torch``
nor ``chip_smoke.py`` imports jax, optax, mujoco or the JAX package. The check
reads the sources' import statements; it imports nothing."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(
    glob.glob(os.path.join(REPO, "quadruped_gym_tpu_torch", "**", "*.py"),
              recursive=True)
) + [os.path.join(REPO, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "optax", "mujoco", "quadruped_gym_tpu")


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_found():
    names = {os.path.relpath(p, REPO) for p in SOURCES}
    assert "quadruped_gym_tpu_torch/ops/cuda_engine.py" in names
    assert "chip_smoke.py" in names
    for mod in ("maths", "smooth", "collision", "constraints", "solver",
                "integrator", "sensors", "engine"):
        assert f"quadruped_gym_tpu_torch/physics/{mod}.py" in names
    for mod in ("rl/__init__", "rl/networks", "rl/ppo", "rl/train",
                "runtime/checkpoint", "utils/__init__", "utils/metrics"):
        assert f"quadruped_gym_tpu_torch/{mod}.py" in names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [name for name in _imported(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
