"""MPPI and the receding-horizon runtime against the JAX package.

The two frameworks draw different noise from a seed, so the weighting
and mean update are held to JAX's ``mppi.plan`` on GIVEN sequences and
costs: the JAX plan runs with its rollout scoring replaced by a fixed
function of the sequences, and the port's ``weighted_update`` gets the
sequences JAX sampled and the same costs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.runtime import mpc_runtime as jrt
from quadruped_gym_tpu.solvers import cem as jcem
from quadruped_gym_tpu.solvers import mppi as jmppi
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics.engine import make_state
from quadruped_gym_tpu_torch.runtime import mpc_runtime as trt
from quadruped_gym_tpu_torch.solvers import cem as tcem
from quadruped_gym_tpu_torch.solvers import mppi as tmppi
from quadruped_gym_tpu_torch.solvers import rollout as trollout

CENTERS = np.array([0.0, 0.0, -0.5] * 4)


def _fake_costs(seqs):
    """A fixed cost per sequence; the last sample is made non-finite."""
    c = jnp.sum(jnp.square(seqs - 0.1), axis=(1, 2))
    return c.at[-1].set(jnp.nan)


@pytest.mark.parametrize("temperature", [1.0, 0.05])
def test_weighted_update_matches_jax_plan(monkeypatch, temperature):
    jm = jspec.get_planning_model()
    S, H = 64, 4
    cfg = jmppi.MPPIConfig(num_samples=S, sigma=0.3, temperature=temperature)
    monkeypatch.setattr(
        jmppi, "_rollout_costs",
        lambda m, cfg, cost_fn, state, seqs, cmd, prev: _fake_costs(seqs))
    mean0 = jnp.asarray(np.tile(CENTERS, (H, 1)) + 0.05)
    key = jax.random.PRNGKey(3)
    res = jmppi.plan(jm, cfg, None, None, mean0, None, None, key)
    # the sequences JAX sampled inside plan (one iteration)
    (k,) = jax.random.split(key, 1)
    eps = cfg.sigma * jax.random.normal(k, (S, H, 12), mean0.dtype)
    lo, hi = jmppi._ctrl_bounds(jm, mean0.dtype)
    seqs = np.array(jnp.clip(mean0[None] + eps, lo, hi))
    costs = np.array(_fake_costs(jnp.asarray(seqs)))
    mean, best, mean_c, ent = tmppi.weighted_update(
        torch.as_tensor(seqs), torch.as_tensor(costs), temperature)
    np.testing.assert_allclose(mean.numpy(), np.asarray(res.mean),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(best.item(), float(res.best_cost), rtol=1e-14)
    assert mean_c.item() == float(res.mean_cost) == np.inf
    np.testing.assert_allclose(ent.item(), float(res.weights_entropy),
                               rtol=1e-10)


def test_plan_on_cpu_runs_the_fused_plain_version():
    m = tspec.get_planning_model()
    H = 2
    cfg = tmppi.MPPIConfig(
        num_samples=8, rollout=trollout.RolloutConfig(horizon=H,
                                                      frame_skip=2),
        lane=True, lane_engine_impl="fused", lane_newton_iterations=2,
        lane_ls_iterations=4)
    st = make_state(m, dtype=torch.float64, device="cpu")
    mean = torch.as_tensor(np.tile(CENTERS, (H, 1)))
    cmd = convert.command(jcommands.make(jnp.asarray([0.2, 0.0]),
                                         jnp.asarray(0.0)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    res = tmppi.plan(m, cfg, trollout.make_cost_fn(m), st, mean, cmd,
                     torch.as_tensor(CENTERS), gen)
    assert res.mean.shape == (H, 12) and res.mean.dtype == torch.float64
    assert all(bool(torch.isfinite(x).all()) for x in res)
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    assert np.all(res.mean.numpy() >= lo) and np.all(res.mean.numpy() <= hi)
    # lane=False scores the same samples through the oracle engine
    oracle = tmppi.plan(
        m, tmppi.MPPIConfig(num_samples=8, lane=False,
                            rollout=trollout.RolloutConfig(
                                horizon=H, frame_skip=2, max_contacts=4,
                                solver_iterations=2)),
        trollout.make_cost_fn(m), st, mean, cmd, torch.as_tensor(CENTERS),
        torch.Generator().manual_seed(0))
    assert oracle.mean.shape == (H, 12) and oracle.mean.dtype == torch.float64
    assert all(bool(torch.isfinite(x).all()) for x in oracle)
    # the same noise, nearly the same physics: nearly the same plan
    torch.testing.assert_close(oracle.mean, res.mean, rtol=0, atol=0.05)


def test_mpc_config_refuses_unported_solvers():
    """Every solver of the JAX package is ported now: each name builds and
    an unknown one is refused as the JAX package refuses it (``rollout``
    raises ``KeyError``)."""
    assert trt.MPCConfig().solver == "mppi"
    assert trt.MPCConfig(solver="cem").rollout == tcem.CEMConfig().rollout
    for solver in ("sqp", "ilqr"):
        cfg = trt.MPCConfig(solver=solver)
        assert cfg.rollout == getattr(cfg, solver).rollout
    with pytest.raises(KeyError):
        trt.MPCConfig(solver="nope").rollout


def test_init_carry_matches_jax():
    jm, tm = jspec.get_planning_model(), tspec.get_planning_model()
    jc = jrt.init_carry(jm, jrt.MPCConfig(), 5, jax.random.PRNGKey(0),
                        dtype=jnp.float64)
    tc = trt.init_carry(tm, trt.MPCConfig(), 5, seed=0, dtype=torch.float64,
                        device="cpu")
    for f in ("mean", "sigma", "prev_ctrl"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    # sigma comes from the CEM config, as in the JAX package
    wide = trt.init_carry(tm, trt.MPCConfig(cem=tcem.CEMConfig(
        init_sigma=0.7)), 5, seed=0, dtype=torch.float64, device="cpu")
    jwide = jrt.init_carry(jm, jrt.MPCConfig(cem=jcem.CEMConfig(
        init_sigma=0.7)), 5, jax.random.PRNGKey(0), dtype=jnp.float64)
    np.testing.assert_array_equal(wide.sigma.numpy(), np.asarray(jwide.sigma))
    assert float(wide.sigma[0, 0]) == 0.7
    via = convert.mpc_carry(jc, seed=0, device="cpu")
    for f in ("mean", "sigma", "prev_ctrl"):
        np.testing.assert_array_equal(getattr(via, f).numpy(),
                                      getattr(tc, f).numpy())
    a = torch.randn(3, generator=tc.generator, dtype=torch.float64)
    b = torch.randn(3, generator=via.generator, dtype=torch.float64)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plan_and_act_shifts_the_plan(monkeypatch):
    m = tspec.get_planning_model()
    H = 3
    cfg = trt.MPCConfig(mppi=tmppi.MPPIConfig(
        num_samples=4, rollout=trollout.RolloutConfig(horizon=H),
        lane=True))
    carry = trt.init_carry(m, cfg, H, seed=1, dtype=torch.float64,
                           device="cpu")
    planned = torch.arange(H * 12, dtype=torch.float64).reshape(H, 12)
    one = torch.tensor(1.0, dtype=torch.float64)
    monkeypatch.setattr(
        tmppi, "plan",
        lambda *a: tmppi.PlanResult(mean=planned, best_cost=-one,
                                    mean_cost=one, weights_entropy=one))
    ctrl, new, info = trt.plan_and_act(m, cfg, None, carry, None, None)
    torch.testing.assert_close(ctrl, planned[0])
    torch.testing.assert_close(new.mean[:-1], planned[1:])
    torch.testing.assert_close(new.mean[-1], planned[-1])
    torch.testing.assert_close(new.prev_ctrl, planned[0])
    assert new.generator is carry.generator
    assert info["best_cost"].item() == -1.0


def test_lane_control_step_matches_jax():
    jm, tm = jspec.get_planning_model(), tspec.get_planning_model()
    rng = np.random.default_rng(4)
    st = jengine.make_state(jm, dtype=jnp.float64)
    st = st._replace(qvel=jnp.asarray(0.1 * rng.standard_normal(jm.nv)))
    ctrl = CENTERS + 0.1 * rng.standard_normal(12)
    with jax.disable_jit():
        want = jrt.lane_control_step(jm, st, jnp.asarray(ctrl), 2, 4, 8)
    got = trt.lane_control_step(tm, convert.state(st, device="cpu"),
                                torch.as_tensor(ctrl), 2, 4, 8)
    tol = {"qpos": 1e-12, "qvel": 1e-10, "act": 1e-14, "sensordata": 1e-10,
           "time": 1e-15}
    for f, rtol in tol.items():
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=rtol * 0.1, err_msg=f)
