"""The port's research scripts (``scripts/torch_{latency_parts,
latency_report,latency_sweep,diag_gait,full_plant_budget_study}.py``) on
the CPU, held to the JAX package's scripts.

- Each ``main`` runs end to end at a tiny size with ``--cpu``; its report
  has the JAX script's keys (read from the JAX script's source), but for
  the differences named here.
- ``fit_slope_intercept`` against the JAX script's own fit and clamp
  (its statements read from its source and run on the same times); the
  budget verdict against the JAX script's verdict statements on the same
  synthetic rows; the budget study's ``run_case`` against the JAX
  ``run_case`` (read from its source) on one fixed closed-loop trace that
  stands in for ``mpc_runtime.closed_loop`` in both packages; the lane
  route's operation count, H (a S + c) exactly.
- ``torch_diag_gait`` at H=2 on the fast plant in float64, every stage
  against the JAX script's stages in ``tests/torch_diag_gait_refs.npz``
  (written by ``scripts/snapshot_torch_diag_gait_refs.py``: the jitted
  JAX stages compile for over two minutes) at 1e-9 (A, B, the cost
  expansion, F, Hqp, g), 1e-8 (du) and 1e-10 (the line search's costs),
  relative to each array's largest entry; the condensation and the QP
  against the live JAX functions on the file's inputs; the ``slow`` test
  recomputes the file."""

import ast
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.solvers import sqp as jsqp
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.solvers import sqp as tsqp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tolerances of the diag_gait stages, relative to each array's largest
# entry
STAGE_TOL = {**{k: 1e-9 for k in ("A", "B", "lx", "lxx", "lu", "luu", "F",
                                   "Hqp", "g")},
             "du": 1e-8, "line_search_costs": 1e-10}


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", os.path.join(REPO, folder, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tree(name):
    with open(os.path.join(REPO, "scripts", name + ".py")) as f:
        return ast.parse(f.read())


def _keys(node):
    """A dict literal's keys, nested: {key: its value's keys, or None}."""
    return {k.value: _keys(v) if isinstance(v, ast.Dict) else None
            for k, v in zip(node.keys, node.values)
            if isinstance(k, ast.Constant)}


def _assigned(tree, name):
    """The keys of the dict literal the JAX script assigns to ``name``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            return _keys(node.value)
    raise AssertionError(f"no dict assigned to {name}")


def _assert_keys(jax_keys, port, renamed=None, added=None, path=()):
    """``port``'s keys are the JAX script's, renamed and added to as
    given (``added`` by the path of the dict), at every level."""
    renamed, added = renamed or {}, added or {}
    want = {renamed.get(k, k) for k in jax_keys} | added.get(path, set())
    assert set(port) == want, path
    for k, sub in jax_keys.items():
        if sub is not None:
            k = renamed.get(k, k)
            _assert_keys(sub, port[k], renamed, added, path + (k,))


def _names(stmt):
    """The names a statement assigns."""
    targets = stmt.targets if isinstance(stmt, ast.Assign) else []
    return {n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)}


def _jax_code(script, first, last):
    """The statements of a function of the JAX script from the one that
    assigns ``first`` to the one that assigns ``last``, compiled to run in
    a namespace of the test's own (the script itself is never imported:
    it sets JAX's compilation cache at import)."""
    for fn in ast.walk(_jax_tree(script)):
        if not isinstance(fn, ast.FunctionDef):
            continue
        at = [i for i, st in enumerate(fn.body) if first in _names(st)]
        to = [i for i, st in enumerate(fn.body) if last in _names(st)]
        if at and to:
            body = fn.body[at[0]:to[-1] + 1]
            return compile(ast.Module(body=body, type_ignores=[]),
                           f"scripts/{script}.py", "exec")
    raise AssertionError(f"{script}: no statements {first} ... {last}")


def _jax_function(script, name, namespace):
    """The JAX script's top-level function ``name``, defined in
    ``namespace``."""
    tree = _jax_tree(script)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[fn], type_ignores=[]),
                 f"scripts/{script}.py", "exec"), namespace)
    return namespace[name]


def _finite(x):
    return bool(np.isfinite(np.asarray(x, dtype=np.float64)).all())


# --------------------------------------------------------------------------
# latency_parts


def test_latency_parts_main_has_the_jax_parts():
    report = _load("scripts", "torch_latency_parts").main(
        ["--cpu", "--k", "2", "--reps", "1", "--samples", "4", "--horizon",
         "1", "--seed", "0"])
    lines = [_keys(n) for n in ast.walk(_jax_tree("latency_parts"))
             if isinstance(n, ast.Dict)]
    names = [n.values[0].value for n in ast.walk(_jax_tree("latency_parts"))
             if isinstance(n, ast.Dict) and _keys(n) == {"part": None,
                                                         "ms": None}]
    assert names == ["aos_control_step_planner_budget",
                     "aos_control_step_plant_budget", "mppi_solve_1024xH50"]
    assert [p["part"] for p in report["parts"]] == [
        n.replace("1024xH50", "4xH1") for n in names]
    assert all(set(p) == {"part", "ms"} and p["ms"] > 0
               for p in report["parts"])
    assert {"sum_ms": None, "note": None} in lines
    assert set(report) == {"device", "k", "parts", "sum_ms", "note"}
    assert report["sum_ms"] == pytest.approx(
        sum(p["ms"] for p in report["parts"]), abs=2e-3)


# --------------------------------------------------------------------------
# latency_report


@pytest.mark.parametrize("ns,ts", [
    ((1, 2, 3), (1.5, 2.6, 3.4)),  # positive intercept: the free fit
    ((25, 50, 100), (3.0, 4.2, 9.9)),  # negative: clamped, refitted
], ids=["positive_intercept", "negative_intercept"])
def test_fit_slope_intercept_matches_polyfit_and_the_clamp(ns, ts):
    """The port's fit against the JAX script's fit statements (from
    ``A = np.array(ns ...)`` to ``per_step_s, intercept_s = ...``) run on
    the same times; the free fit's intercept is numpy's polyfit's."""
    fit = _load("scripts", "torch_latency_report").fit_slope_intercept
    a, b = fit(ns, ts)
    jax_ns = {"np": np, "ns": ns, "loop_s": dict(zip(ns, ts))}
    exec(_jax_code("latency_report", "A", "per_step_s"), jax_ns)
    assert (a, b) == (pytest.approx(jax_ns["per_step_s"], rel=1e-12),
                      pytest.approx(jax_ns["intercept_s"], rel=1e-12,
                                    abs=0.0))
    fb = np.polyfit(np.asarray(ns, float), np.asarray(ts, float), 1)[1]
    assert b == (pytest.approx(fb, rel=1e-12) if fb >= 0 else 0.0)


def test_lane_operation_count_is_linear_in_samples_and_horizon():
    """The lane route's count is H (a S + c): a per rollout step and c per
    control step whatever S (the cost's command terms), with no part that
    depends on the data, so ``lane_count`` extends two small counts to
    any S and H exactly."""
    mod = _load("scripts", "torch_latency_report")
    m = tspec.get_planning_model()

    def ops(S, H):
        return mod.lane_cost_at(m, S, H).flops

    one, two, three = ops(4, 1), ops(8, 1), ops(12, 1)
    a, c = (two - one) / 4, one - (two - one)
    assert a > 0 and three == 12 * a + c
    assert ops(4, 2) == 2 * one
    assert ops(12, 3) == 3 * three
    assert mod.lane_count(m, 12, 3)[0] == ops(12, 3)
    # the fused kernel's plain version (the leg engine) does a fraction of
    # the lane engine's work on the same rollouts
    from quadruped_gym_tpu_torch.ops import cuda_engine

    assert cuda_engine.rollout_flops(m, 1, 5, 2, 4) < a


def test_latency_report_main_has_the_jax_keys(tmp_path):
    out = str(tmp_path / "budget.json")
    report = _load("scripts", "torch_latency_report").main(
        ["--cpu", "--ns", "1", "2", "--loop-reps", "1", "--warm", "0",
         "--k", "1", "--reps", "1", "--samples", "4", "--horizon", "1",
         "--roofline-samples", "4", "--seed", "0", "--out", out])
    _assert_keys(
        _assigned(_jax_tree("latency_report"), "report"), report,
        renamed={"tunnel": "launch_sync",
                 "trivial_dispatch_ms": "trivial_launch_sync_ms"},
        added={(): {"split_100hz"},
               ("fused_kernel_roofline",): {
                   "rollout_flops", "rollout_flops_fraction_of_f32_peak",
                   "bound"}})
    assert set(report["closed_loop_sim"]["loop_s_by_N"]) == {"1", "2"}
    split = report["split_100hz"]
    assert split["solve_ms"] == report["controller_realtime"]["solve_ms"]
    assert all(_finite(split[k]) and split[k] >= 0
               for k in ("predict_ms", "solve_ms", "plant_ms"))
    roof = report["fused_kernel_roofline"]
    assert roof["bound"] == "NVIDIA H100 SXM"
    assert roof["analytic_flops"] > roof["rollout_flops"] > 0
    with open(out) as f:
        assert f.read().startswith("{")


# --------------------------------------------------------------------------
# latency_sweep


def test_latency_sweep_main_rows():
    report = _load("scripts", "torch_latency_sweep").main(
        ["--cpu", "--samples", "4", "8", "--horizon", "1", "--k", "2",
         "--seed", "0"])
    row = _assigned(_jax_tree("latency_sweep"), "row")
    # the JAX block axis (a TPU tile) is replaced by the launch geometry
    want = (set(row) - {"block"}) | {"threads", "grid", "warps"}
    assert [r["samples"] for r in report["rows"]] == [4, 8]
    for r in report["rows"]:
        assert set(r) == want
        assert r["threads"] == 32 * r["warps"] and r["grid"] >= 1
        assert r["per_solve_ms"] > 0
    assert report["best"] == min(report["rows"],
                                 key=lambda r: r["per_solve_ms"])


# --------------------------------------------------------------------------
# full_plant_budget_study


def _row(err, flipped=False):
    return {"mean_vel_error": err, "flipped": flipped}


@pytest.mark.parametrize("rows,equivalent", [
    ([_row(0.05), _row(0.055), _row(0.046)], True),
    ([_row(0.05), _row(0.045), _row(0.061)], False),
    ([_row(0.05), _row(0.05), _row(0.05, flipped=True)], False),
], ids=["within", "spread", "flipped"])
def test_budget_verdict_on_synthetic_rows(rows, equivalent):
    """The port's verdict is the JAX script's verdict statements (from
    ``ref = results[0]`` to ``verdict = {...}``) run on the same rows."""
    v = _load("scripts", "torch_full_plant_budget_study").budget_verdict(
        rows)
    jax_ns = {"results": rows}
    exec(_jax_code("full_plant_budget_study", "ref", "verdict"), jax_ns)
    assert v == jax_ns["verdict"]
    assert v["equivalent"] is equivalent


@pytest.mark.parametrize("case", [(4, 8, 64), (2, 4, 64), (2, 4, 32)],
                         ids=["4_8_nsec64", "2_4_nsec64", "2_4_nsec32"])
def test_budget_study_run_case_matches_jax_on_one_trace(monkeypatch, case):
    """One fixed (ctrls, sensordata, costs) trace stands in for
    ``mpc_runtime.closed_loop`` in both packages; the port's ``run_case``
    and the JAX script's (read from its source, jitted as the script runs
    it) then read the same numbers from it: the warm-up slice, the
    position, velocity and z-axis sensors, the flip."""
    from quadruped_gym_tpu.runtime import mpc_runtime as jrt
    from quadruped_gym_tpu_torch.runtime import mpc_runtime as trt

    newton, ls, nsec = case
    n_steps, speed = 9, 0.15
    pm = tspec.get_fast_plant_model(n_secondary=nsec)
    rng = np.random.default_rng(11)
    ctrls = rng.uniform(-1.0, 1.0, (n_steps, pm.nu))
    sens = 0.3 * rng.standard_normal((n_steps, pm.nsensordata))
    costs = rng.standard_normal(n_steps)

    def jax_loop(m, cfg, cost_fn, carry, phys, cmd, n, plant_model=None):
        assert n == n_steps and plant_model is not None
        return carry, phys, tuple(map(jnp.asarray, (ctrls, sens, costs)))

    def torch_loop(m, cfg, cost_fn, carry, phys, cmd, n, plant_model=None):
        assert n == n_steps and plant_model is not None
        return carry, phys, tuple(map(torch.as_tensor, (ctrls, sens, costs)))

    monkeypatch.setattr(jrt, "closed_loop", jax_loop)
    monkeypatch.setattr(trt, "closed_loop", torch_loop)
    run_case = _jax_function("full_plant_budget_study", "run_case",
                             {"jax": jax, "jnp": jnp, "np": np,
                              "time": __import__("time")})
    want = run_case(newton, ls, nsec, n_steps, speed, jax.random.PRNGKey(0))
    got = _load("scripts", "torch_full_plant_budget_study").run_case(
        newton, ls, nsec, n_steps, speed, 0, torch.device("cpu"))
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "wall_s":
            continue
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-12, abs=1e-15), k
        else:
            assert got[k] == w, k


def test_budget_study_main_has_the_jax_rows(tmp_path):
    out = str(tmp_path / "study.json")
    report = _load("scripts", "torch_full_plant_budget_study").main(
        ["--cpu", "--steps", "1", "--samples", "4", "--horizon", "1",
         "--out", out])
    tree = _jax_tree("full_plant_budget_study")
    case = next(_keys(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Return) and isinstance(n.value,
                                                            ast.Dict))
    _assert_keys(_assigned(tree, "report"), report)
    assert [(r["budget"], r["n_secondary"]) for r in report["cases"]] == [
        ("4/8", 64), ("2/4", 64), ("2/4", 32)]
    for r in report["cases"]:
        assert set(r) == set(case)
        assert _finite([r[k] for k in case if k not in ("budget", "flipped")])
    assert os.path.exists(out)


# --------------------------------------------------------------------------
# diag_gait


def _refs():
    path = _load("scripts", "snapshot_torch_diag_gait_refs").OUT
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _close(name, got, want):
    tol = STAGE_TOL[name]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=name)


def test_diag_gait_stages_match_the_jax_stages():
    """``main`` at H=2, float64: the port's own settle and warm start (the
    same as JAX's to ~1e-15), then every stage against the JAX script's."""
    snap = _load("scripts", "snapshot_torch_diag_gait_refs")
    refs = _refs()
    report = _load("scripts", "torch_diag_gait").main(
        ["--cpu", "--f64", "--horizon", str(snap.CASE["horizon"])])
    stats = [c.args[0].value for c in ast.walk(_jax_tree("diag_gait"))
             if isinstance(c, ast.Call) and getattr(c.func, "id", "") ==
             "stat"]
    assert list(report["stats"]) == stats
    assert report["eps"] == snap.CASE["eps"] and report["linearize"] == "ad"
    got = report["arrays"]
    for name in STAGE_TOL:
        _close(name, got[name], refs[name])
    np.testing.assert_allclose(report["cost0"], refs["cost0"], rtol=1e-10)
    assert [r["alpha"] for r in report["line_search"]] == list(snap.ALPHAS)
    assert all(s["nan"] == 0 and s["inf"] == 0
               for s in report["stats"].values())
    assert len(report["A_product_norms"]) == snap.CASE["horizon"]


def test_diag_gait_condensation_and_qp_match_live_jax():
    """The condensation, ``_add_control_blocks`` and the box QP of the
    stages, on the JAX stages' A, B and cost expansion, against the JAX
    functions jitted as ``diag_gait.py`` runs them."""
    refs = _refs()
    t = {k: torch.as_tensor(refs[k]) for k in ("A", "B", "lx", "lxx", "lu",
                                               "luu")}
    F = tsqp.sensitivities(t["A"], t["B"])
    Hqp, g = tsqp._add_control_blocks(*tsqp.condense(F, t["lx"], t["lxx"]),
                                      t["lu"], t["luu"])
    j = {k: jnp.asarray(v) for k, v in refs.items()}
    jF = jax.jit(jsqp.sensitivities)(j["A"], j["B"])
    jH, jg = jax.jit(jsqp.condense)(jF, j["lx"], j["lxx"])
    jH, jg = jax.jit(jsqp._add_control_blocks)(jH, jg, j["lu"], j["luu"])
    for name, got, want in (("F", F, jF), ("Hqp", Hqp, jH), ("g", g, jg)):
        _close(name, got.numpy(), np.asarray(want))
    Hs = 0.5 * (Hqp + Hqp.T) + 1e-3 * torch.eye(Hqp.shape[0],
                                                 dtype=torch.float64)
    lo, hi = -1.0 - torch.as_tensor(refs["us0"]).reshape(-1), \
        1.0 - torch.as_tensor(refs["us0"]).reshape(-1)
    du = tsqp.admm_box_qp(Hs, g, lo, hi)
    jdu = jax.jit(jsqp.admm_box_qp)(jnp.asarray(Hs.numpy()), jg,
                                    jnp.asarray(lo.numpy()),
                                    jnp.asarray(hi.numpy()))
    _close("du", du.numpy(), np.asarray(jdu))


@pytest.mark.slow
def test_diag_gait_snapshot_matches_live_jax():
    """``tests/torch_diag_gait_refs.npz`` is what the JAX stages compute
    now (about two minutes of XLA compile)."""
    refs = _refs()
    live = _load("scripts", "snapshot_torch_diag_gait_refs").jax_stages()
    assert set(live) == set(refs)
    for k, v in live.items():
        np.testing.assert_allclose(v, refs[k], rtol=1e-10,
                                   atol=1e-10 * max(np.abs(refs[k]).max(),
                                                    1e-300), err_msg=k)
