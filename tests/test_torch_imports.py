"""The PyTorch port stands alone: no module of ``quadruped_gym_tpu_torch``
(``native/`` included), no ``examples/torch_*.py``, no
``scripts/torch_*.py``, not ``torch_bench.py`` and not ``chip_smoke.py``
imports jax, optax,
mujoco or the JAX package. The check
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
) + sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py"))) \
    + sorted(glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))) + [
    os.path.join(REPO, "torch_bench.py"), os.path.join(REPO, "chip_smoke.py")]
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
    assert "chip_smoke.py" in names and "torch_bench.py" in names
    for mod in ("maths", "smooth", "collision", "constraints", "solver",
                "integrator", "sensors", "engine"):
        assert f"quadruped_gym_tpu_torch/physics/{mod}.py" in names
    for mod in ("rl/__init__", "rl/networks", "rl/ppo", "rl/train",
                "runtime/checkpoint", "utils/__init__", "utils/metrics",
                "envs/gym_env", "envs/rendering", "rl/evaluate",
                "utils/plot", "utils/server", "solvers/ilqr", "solvers/sqp",
                "runtime/config", "rl/distributed", "parallel/__init__",
                "parallel/mesh", "parallel/multihost", "parallel/pipeline",
                "parallel/sharded_mpc", "utils/profiling", "native/__init__"):
        assert f"quadruped_gym_tpu_torch/{mod}.py" in names
    for example in ("torch_gait_sqp", "torch_closed_loop_gradient",
                    "torch_closed_loop_walk", "torch_scenario_sweep",
                    "torch_random_rollout", "torch_latency_demo"):
        assert f"examples/{example}.py" in names
    for script in ("torch_eval_report", "torch_kernel_roofline",
                   "torch_export_policy", "torch_latency_parts",
                   "torch_latency_report", "torch_latency_sweep",
                   "torch_diag_gait", "torch_full_plant_budget_study"):
        assert f"scripts/{script}.py" in names


# entry points of the JAX package that have no counterpart, and why
NOT_PORTED_ENTRY_POINTS = {
    # drives MuJoCo to calibrate the contact parameters that the port's
    # snapshots carry
    "scripts/calibrate_contacts.py",
    # the TPU benchmark harness's hook: its single-chip compile check is
    # what chip_smoke.py covers, its multi-device dry run what the port's
    # parallel tests run at 2-4 gloo ranks and chip_smoke's parallel phase
    # at one NCCL rank
    "__graft_entry__.py",
}


def test_every_jax_entry_point_has_its_counterpart():
    """Each script and example that imports the JAX package has a
    ``torch_`` namesake in its folder, and so has each such file at the
    repo's root (``bench.py`` -> ``torch_bench.py``), but for
    ``NOT_PORTED_ENTRY_POINTS`` and the port's own ``snapshot_torch_*``
    scripts, which write its references from the JAX package."""
    missing = []
    for folder in (".", "scripts", "examples"):
        for path in sorted(glob.glob(os.path.join(REPO, folder, "*.py"))):
            name = os.path.basename(path)
            rel = os.path.normpath(os.path.join(folder, name))
            if (name.startswith(("torch_", "snapshot_torch_"))
                    or rel in NOT_PORTED_ENTRY_POINTS):
                continue
            if "quadruped_gym_tpu" not in {
                    n.split(".")[0] for n in _imported(path)}:
                continue
            if not os.path.exists(os.path.join(REPO, folder,
                                               "torch_" + name)):
                missing.append(rel)
    assert missing == []
    assert os.path.exists(os.path.join(REPO, "bench.py"))
    for rel in NOT_PORTED_ENTRY_POINTS:
        assert os.path.exists(os.path.join(REPO, rel)), rel


def test_every_jax_module_has_its_counterpart():
    """Each module of the JAX package has a namesake in the port, but for
    the MuJoCo-oracle helpers (``testing.py``: the port's tests use the
    JAX package's) and the kernels' module (``ops/pallas_engine.py``,
    whose counterpart is ``ops/cuda_engine.py``)."""
    jax_root = os.path.join(REPO, "quadruped_gym_tpu")
    port = {os.path.relpath(p, REPO).split("/", 1)[1] for p in SOURCES
            if os.path.relpath(p, REPO).startswith("quadruped_gym_tpu_torch")}
    missing = sorted(
        os.path.relpath(p, jax_root)
        for p in glob.glob(os.path.join(jax_root, "**", "*.py"),
                           recursive=True)
        if os.path.relpath(p, jax_root) not in port)
    assert missing == ["ops/pallas_engine.py", "testing.py"]


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
    "ops": set(),
    "parallel": set(),
    "rl": set(),
    "solvers": set(),
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
