"""The PyTorch port stands alone: no module of ``quadruped_gym_tpu_torch``
nor ``chip_smoke.py`` imports jax, optax, mujoco or the JAX package. The check
reads the sources' import statements; it imports nothing. And each package
of the port re-exports what its JAX counterpart's ``__init__`` does, for
every name the port has (read from the JAX sources, imported from the
port)."""

import ast
import glob
import importlib
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
                "runtime/checkpoint", "utils/__init__", "utils/metrics",
                "envs/gym_env", "envs/rendering", "rl/evaluate",
                "utils/plot", "utils/server"):
        assert f"quadruped_gym_tpu_torch/{mod}.py" in names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [name for name in _imported(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# what a JAX package __init__ exports that the port does not have yet,
# with the ROADMAP.md item that brings it
NOT_PORTED = {
    "envs": set(),
    "ops": {"step", "control_step"},  # the lane engine's, A.10
    "rl": {"distributed"},  # A.14
    "solvers": {"ilqr", "sqp", "ILQRConfig", "ILQRResult", "SQPConfig",
                "SQPResult"},  # A.13
    "utils": set(),
}


def _jax_exports(pkg):
    """(name, module it comes from) of each name the JAX package's
    ``pkg/__init__.py`` imports from its own modules."""
    path = os.path.join(REPO, "quadruped_gym_tpu", pkg, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                yield a.name, node.module or a.name


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_package_exports_match_jax(pkg):
    port = importlib.import_module(f"quadruped_gym_tpu_torch.{pkg}")
    missing = set()
    exports = list(_jax_exports(pkg))
    assert exports
    for name, module in exports:
        src = os.path.join(REPO, "quadruped_gym_tpu_torch", pkg,
                           module + ".py")
        has = os.path.exists(src) and (
            module == name or hasattr(importlib.import_module(
                f"quadruped_gym_tpu_torch.{pkg}.{module}"), name))
        if has:
            assert hasattr(port, name), f"{pkg}.{name} is not exported"
        else:
            missing.add(name)
    assert missing == NOT_PORTED[pkg]
