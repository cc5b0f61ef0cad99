"""CEM and the CEM branch of the receding-horizon runtime against the JAX
package, float64 on the CPU.

The two frameworks draw different noise from a seed, so the distribution
update is held to JAX's ``cem.plan`` on GIVEN samples and costs: the JAX
plan runs with its rollout scoring replaced by a fixed function of the
sequences, and the port's ``refit`` gets the noise JAX drew and the same
costs, iteration by iteration. Tolerance: rtol 1e-12 (means and
population standard deviations of 6-8 elites, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.solvers import cem as jcem
from quadruped_gym_tpu.solvers import mppi as jmppi
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics.engine import State, make_state
from quadruped_gym_tpu_torch.runtime import mpc_runtime as trt
from quadruped_gym_tpu_torch.solvers import cem as tcem
from quadruped_gym_tpu_torch.solvers import rollout as trollout

CENTERS = np.array([0.0, 0.0, -0.5] * 4)


def _fake_costs(seqs):
    """A fixed cost per sequence; the last sample is made non-finite."""
    c = jnp.sum(jnp.square(seqs - 0.1), axis=(1, 2))
    return c.at[-1].set(jnp.nan)


@pytest.mark.parametrize("min_sigma,elites", [(0.02, 8), (0.25, 6)])
def test_refit_matches_jax_plan(monkeypatch, min_sigma, elites):
    jm = jspec.get_planning_model()
    S, H, iters = 48, 3, 2
    kw = dict(num_samples=S, num_elites=elites, iterations=iters,
              init_sigma=0.3, min_sigma=min_sigma, alpha=0.2)
    jcfg, tcfg = jcem.CEMConfig(**kw), tcem.CEMConfig(**kw)
    monkeypatch.setattr(
        jcem.rollout_mod, "batched_rollout_cost",
        lambda m, cfg, cost_fn, state, seqs, cmd, prev: _fake_costs(seqs))
    mean0 = jnp.asarray(np.tile(CENTERS, (H, 1)) + 0.05)
    key = jax.random.PRNGKey(5)
    res = jcem.plan(jm, jcfg, None, None, mean0, None, None, key)

    lo, hi = jmppi._ctrl_bounds(jm, mean0.dtype)
    lo, hi = torch.as_tensor(np.asarray(lo)), torch.as_tensor(np.asarray(hi))
    mean = torch.as_tensor(np.asarray(mean0))
    sigma = torch.full_like(mean, jcfg.init_sigma)
    for k in jax.random.split(key, iters):  # the noise JAX drew inside plan
        eps = torch.as_tensor(np.array(
            jax.random.normal(k, (S, H, 12), mean0.dtype)))
        seqs = torch.clamp(mean[None] + sigma[None] * eps, lo, hi)
        costs = torch.as_tensor(np.array(_fake_costs(jnp.asarray(
            seqs.numpy()))))
        assert bool(torch.isnan(costs[-1]))
        mean, sigma, best, mean_c = tcem.refit(seqs, costs, mean, sigma, tcfg)
    np.testing.assert_allclose(mean.numpy(), np.asarray(res.mean),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(res.sigma),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(best.item(), float(res.best_cost), rtol=1e-14)
    assert mean_c.item() == float(res.mean_cost) == np.inf
    assert float(sigma.min()) >= min_sigma
    if min_sigma == 0.25:  # the floor really binds somewhere
        assert float(sigma.min()) == min_sigma


def test_refit_takes_the_cheapest_and_the_population_std():
    cfg = tcem.CEMConfig(num_samples=5, num_elites=2, alpha=0.0,
                         min_sigma=0.0)
    seqs = torch.arange(5, dtype=torch.float64).reshape(5, 1, 1).expand(
        5, 2, 3).clone()
    costs = torch.tensor([3.0, 0.5, float("nan"), 0.25, float("inf")],
                         dtype=torch.float64)
    mean, sigma, best, _ = tcem.refit(seqs, costs, torch.zeros(2, 3).double(),
                                      torch.ones(2, 3).double(), cfg)
    # elites are samples 1 and 3: mean 2, population std 1 (not sqrt(2))
    torch.testing.assert_close(mean, torch.full((2, 3), 2.0).double())
    torch.testing.assert_close(sigma, torch.ones(2, 3).double())
    assert best.item() == 0.25


def _plan_inputs(H):
    m = tspec.get_planning_model()
    rng = np.random.default_rng(0)
    st = make_state(m, dtype=torch.float64, device="cpu")
    st = State(*st)._replace(qvel=torch.as_tensor(
        0.1 * rng.standard_normal(m.nv)))
    mean = torch.as_tensor(np.tile(CENTERS, (H, 1)))
    cmd = convert.command(jcommands.make(jnp.asarray([0.2, 0.0]),
                                         jnp.asarray(0.0)), device="cpu")
    return m, st, mean, cmd


def test_plan_runs_and_lowers_the_mean_cost():
    """A small solve through the per-control-step path with a custom cost:
    the refit distribution scores better than the initial one."""
    H = 2
    m, st, mean, cmd = _plan_inputs(H)
    base = dict(num_samples=16, num_elites=4, init_sigma=0.3,
                rollout=trollout.RolloutConfig(horizon=H, frame_skip=1),
                lane=True, lane_engine_impl="pallas",
                lane_newton_iterations=2, lane_ls_iterations=4)
    cost = trollout.make_cost_fn(m, vel_smooth_eps=0.02)
    prev = torch.as_tensor(CENTERS)

    def solve(iterations):
        gen = torch.Generator().manual_seed(3)
        return tcem.plan(m, tcem.CEMConfig(iterations=iterations, **base),
                         cost, st, mean, cmd, prev, gen)

    one, three = solve(1), solve(3)
    for res in (one, three):
        assert res.mean.shape == res.sigma.shape == (H, 12)
        assert all(bool(torch.isfinite(x).all()) for x in res)
    # one.mean_cost scores samples of the initial distribution,
    # three.mean_cost those of the twice-refit one
    assert three.mean_cost.item() < one.mean_cost.item()
    assert float(three.sigma.mean()) < float(one.sigma.mean()) < 0.3
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    assert np.all(three.mean.numpy() >= lo) and np.all(
        three.mean.numpy() <= hi)
    with pytest.raises(NotImplementedError, match="A.8"):
        tcem.plan(m, tcem.CEMConfig(lane=False), cost, st, mean, cmd, prev,
                  torch.Generator())


def test_plan_and_act_cem_carries_sigma_and_shifts_the_plan(monkeypatch):
    m = tspec.get_planning_model()
    H = 3
    cfg = trt.MPCConfig(solver="cem", cem=tcem.CEMConfig(
        num_samples=4, num_elites=2, init_sigma=0.4,
        rollout=trollout.RolloutConfig(horizon=H), lane=True))
    assert cfg.rollout.horizon == H
    carry = trt.init_carry(m, cfg, H, seed=1, dtype=torch.float64,
                           device="cpu")
    assert float(carry.sigma[0, 0]) == 0.4
    planned = torch.arange(H * 12, dtype=torch.float64).reshape(H, 12)
    refit_sigma = torch.full((H, 12), 0.11, dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    seen = {}

    def fake_plan(*a, sigma=None):
        seen["sigma"] = sigma
        return tcem.CEMResult(mean=planned, sigma=refit_sigma, best_cost=-one,
                              mean_cost=one)

    monkeypatch.setattr(tcem, "plan", fake_plan)
    ctrl, new, info = trt.plan_and_act(m, cfg, None, carry, None, None)
    assert seen["sigma"] is carry.sigma
    torch.testing.assert_close(ctrl, planned[0])
    torch.testing.assert_close(new.mean[:-1], planned[1:])
    torch.testing.assert_close(new.mean[-1], planned[-1])
    torch.testing.assert_close(new.prev_ctrl, planned[0])
    assert new.sigma is refit_sigma  # carried, not shifted (as in JAX)
    assert new.generator is carry.generator
    assert info["best_cost"].item() == -1.0 and info["mean_cost"].item() == 1.0


def test_plan_and_act_cem_end_to_end():
    H = 2
    m, st, _, cmd = _plan_inputs(H)
    cfg = trt.MPCConfig(solver="cem", cem=tcem.CEMConfig(
        num_samples=8, num_elites=3, iterations=2,
        rollout=trollout.RolloutConfig(horizon=H, frame_skip=1), lane=True,
        lane_engine_impl="pallas", lane_newton_iterations=2,
        lane_ls_iterations=4))
    carry = trt.init_carry(m, cfg, H, seed=2, dtype=torch.float64,
                           device="cpu")
    ctrl, new, info = trt.plan_and_act(
        m, cfg, trollout.make_cost_fn(m, 0.02), carry, st, cmd)
    assert ctrl.shape == (12,) and bool(torch.isfinite(ctrl).all())
    assert float((new.sigma - carry.sigma).abs().max()) > 0.0
    assert bool(torch.isfinite(info["best_cost"]))
