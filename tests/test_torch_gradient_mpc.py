"""Closed-loop gradient MPC in the port: SQP and iLQR as receding-horizon
solvers (``runtime/mpc_runtime.py``), ``ad_linearize`` against a jitted
JAX probe (airborne and in contact), one SQP ``plan_and_act`` and 3 steps
of ``closed_loop`` against the JAX results committed in
``tests/torch_gradient_refs.npz``, the delayed loop, the two entry points
(``examples/torch_gait_sqp.py``, ``examples/torch_closed_loop_gradient.py``)
at a tiny size, and the guard: with no card and no device asked for,
nothing runs."""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_gradient_cases import (F64, JM, REPO, STEP_KW, TM, close,
                                  jstate, refs, snapshot_script,
                                  to_jax_states, to_torch_states, trajectory,
                                  tstate)
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.solvers import ilqr as jilqr
from quadruped_gym_tpu_torch.physics import engine
from quadruped_gym_tpu_torch.runtime import mpc_runtime
from quadruped_gym_tpu_torch.solvers import cem, ilqr, mppi, rollout, sqp
from quadruped_gym_tpu_torch.tasks import commands


@functools.lru_cache(maxsize=None)
def _jax_ad():
    def step_fn(s, u):
        return jengine.control_step(JM, s, u, 1, **STEP_KW)

    return jax.jit(lambda s0, s, u: jilqr.ad_linearize(JM, step_fn, s0, s, u))


@pytest.mark.parametrize("kind", ["airborne", "contact"])
def test_ad_linearize_matches_jax(kind):
    """AD through the contact Newton: one reverse pass over an engine
    batch of (H, nx), each step once per row of its Jacobian, against
    JAX's vmap over H of jacfwd, 1e-8 relative to max|A|; in the air it
    also agrees with central differences."""
    us, states = trajectory(kind)
    want = _jax_ad()(jstate(kind), to_jax_states(states), jnp.asarray(us))

    def step_fn(s, u):
        return engine.control_step(TM, s, u, 1, **STEP_KW)

    args = (tstate(kind), to_torch_states(states), torch.as_tensor(us))
    got = ilqr.ad_linearize(TM, step_fn, *args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g.numpy(), np.asarray(w), 1e-8)
    # the free base's rotation block of A is not lost (R3)
    assert float(got[0][:, 3:6, 3:6].abs().max()) > 0.5
    if kind == "airborne":
        fd = ilqr.fd_linearize(TM, step_fn, *args, 1e-6)
        for g, f in zip(got, fd):
            np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=2e-4,
                                       atol=2e-5)


def test_mpc_config_covers_gradient_solvers():
    rcfg = rollout.RolloutConfig(horizon=4, frame_skip=1)
    for name in ("mppi", "cem", "sqp", "ilqr"):
        cfg = mpc_runtime.MPCConfig(
            solver=name,
            sqp=sqp.SQPConfig(rollout=rcfg),
            ilqr=ilqr.ILQRConfig(rollout=rcfg),
        )
        assert isinstance(cfg.rollout, rollout.RolloutConfig)
    with pytest.raises(KeyError):
        _ = mpc_runtime.MPCConfig(solver="nope").rollout
    # the receding-horizon defaults of the JAX package
    cfg = mpc_runtime.MPCConfig()
    assert cfg.sqp == sqp.SQPConfig(iterations=1)
    assert cfg.ilqr == ilqr.ILQRConfig(iterations=2)
    with pytest.raises(ValueError):
        mpc_runtime.plan_and_act(TM, mpc_runtime.MPCConfig(solver="nope"),
                                 None, None, None, None)


def _mpc_case(solver="sqp"):
    """The snapshot script's receding-horizon case on the port: config,
    cost, command, the carry with the warm-start plan and the start state
    it saved."""
    case = snapshot_script()
    rcfg = rollout.RolloutConfig(**case.MPC_ROLLOUT)
    cfg = mpc_runtime.MPCConfig(
        solver=solver, sqp=sqp.SQPConfig(rollout=rcfg, **case.MPC_SQP),
        ilqr=ilqr.ILQRConfig(iterations=1, rollout=rcfg,
                             alphas=(1.0, 0.3, 0.0)),
        **case.MPC_PLANT)
    cost_fn = rollout.make_cost_fn(TM, vel_smooth_eps=case.MPC_SMOOTH_EPS)
    cmd = commands.make(torch.tensor([case.SPEED, 0.0], dtype=F64),
                        torch.tensor(0.0, dtype=F64))
    carry = mpc_runtime.init_carry(TM, cfg, case.MPC_ROLLOUT["horizon"],
                                   seed=0, dtype=F64, device="cpu")
    ref = refs()
    carry = carry._replace(mean=torch.as_tensor(ref["mpc_start_mean"]))
    phys = engine.State(*(torch.as_tensor(ref[f"mpc_start_{f}"])
                          for f in engine.State._fields))
    return case, cfg, cost_fn, cmd, carry, phys


def test_plan_and_act_and_closed_loop_match_jax_snapshot():
    """One receding-horizon SQP solve improves on its warm start as in
    the JAX package, and 3 steps of the loop apply the controls JAX
    applied and reach the state JAX reached."""
    case, cfg, cost_fn, cmd, carry, phys = _mpc_case()
    ref = refs()
    ctrl, carry1, info = mpc_runtime.plan_and_act(TM, cfg, cost_fn, carry,
                                                  phys, cmd)
    assert float(info["best_cost"]) < float(info["mean_cost"])
    assert not np.allclose(ctrl.numpy(), carry.mean[0].numpy())
    np.testing.assert_allclose(ctrl.numpy(), ref["mpc_plan_ctrl"], rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(carry1.mean.numpy(), ref["mpc_plan_mean"],
                               rtol=0, atol=1e-7)
    close(info["best_cost"].numpy(), ref["mpc_plan_best_cost"], 1e-7)
    close(info["mean_cost"].numpy(), ref["mpc_plan_mean_cost"], 1e-7)

    carry2, end, (ctrls, sens, costs) = mpc_runtime.closed_loop(
        TM, cfg, cost_fn, carry, phys, cmd, case.MPC_STEPS)
    assert ctrls.shape == (case.MPC_STEPS, TM.nu)
    np.testing.assert_allclose(ctrls.numpy(), ref["mpc_loop_ctrls"], rtol=0,
                               atol=1e-7)
    close(costs.numpy(), ref["mpc_loop_best_cost"], 1e-7)
    close(sens.numpy(), ref["mpc_loop_sensordata"], 1e-7)
    close(end.qpos.numpy(), ref["mpc_loop_qpos"], 1e-7)
    close(end.qvel.numpy(), ref["mpc_loop_qvel"], 1e-7)
    assert float(end.time) > float(phys.time)


@pytest.mark.parametrize("solver", ["sqp", "ilqr"])
def test_delayed_and_closed_loops_run(solver):
    """Both gradient solvers drive ``closed_loop`` and
    ``delayed_closed_loop`` (its predictor "auto" is the oracle engine for
    them; "lane" takes the rollout config's Newton budget)."""
    _, cfg, cost_fn, cmd, carry, phys = _mpc_case(solver)
    for loop, kw in ((mpc_runtime.closed_loop, {}),
                     (mpc_runtime.delayed_closed_loop, {}),
                     (mpc_runtime.delayed_closed_loop,
                      {"predictor": "lane"})):
        _, end, (ctrls, sens, costs) = loop(TM, cfg, cost_fn, carry, phys,
                                            cmd, 1, **kw)
        assert ctrls.shape == (1, TM.nu)
        for x in (ctrls, sens, costs, end.qpos):
            assert bool(torch.isfinite(x).all())
        if loop is mpc_runtime.delayed_closed_loop:
            torch.testing.assert_close(ctrls[0], carry.prev_ctrl)


def _example(name):
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gait_entry_point_runs_on_the_cpu(tmp_path):
    gait = _example("torch_gait_sqp")
    out = tmp_path / "gait.json"
    rep = gait.main(["--cpu", "--f64", "--horizon", "3", "--frame-skip", "1",
                     "--iterations", "1", "--settle-steps", "40", "--split",
                     "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    run = rep["runs"][0]
    assert rep["dtype"] == "float64" and rep["device"] == "cpu"
    assert run["final_cost"] < run["initial_cost"]
    assert run["ctrl_within_range"]
    assert set(run["split_s_per_iteration"]) == {
        "linearize", "quadratize", "qp", "line_search"}
    assert rep["condensation_ranks"] is None
    # the condensation over a horizon mesh of this process alone
    shard = gait.main(["--cpu", "--f64", "--shard", "--horizon", "3",
                       "--frame-skip", "1", "--iterations", "1",
                       "--settle-steps", "40", "--out",
                       str(tmp_path / "shard.json")])
    assert shard["condensation_ranks"] == 1
    assert shard["runs"][0]["final_cost"] < shard["runs"][0]["initial_cost"]
    assert not torch.distributed.is_initialized()


def test_closed_loop_entry_point_runs_on_the_cpu(tmp_path):
    loop = _example("torch_closed_loop_gradient")
    out = tmp_path / "loop.json"
    rep = loop.main(["--cpu", "--steps", "1", "--horizon", "2", "--out",
                     str(out)])
    assert json.loads(out.read_text())["control_steps"] == 1
    assert rep["all_finite"] and rep["solver"] == "sqp"


def test_nothing_runs_without_a_card_or_a_device(monkeypatch):
    """With no CUDA device and none asked for, the entry points and the
    solvers' callers raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("torch_gait_sqp").main(["--horizon", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("torch_closed_loop_gradient").main(["--steps", "1"])
    cfg = mpc_runtime.MPCConfig(solver="sqp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpc_runtime.init_carry(TM, cfg, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_state(TM)
    # the sampling solvers' configs are untouched by the new branches
    assert mpc_runtime.MPCConfig(solver="cem").rollout == \
        cem.CEMConfig().rollout
    assert mpc_runtime.MPCConfig().rollout == mppi.MPPIConfig().rollout
