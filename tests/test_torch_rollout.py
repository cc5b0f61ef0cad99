"""Rollout scoring: the port's stage cost and the fused kernel's plain
version (``cuda_engine.fused_rollout_cost_reference``) against the JAX
package, float64 on the CPU.

The JAX side runs ``lane_batched_rollout_cost(engine_impl="leg")``
eagerly; tests/test_pallas_engine.py holds it equal to the Pallas fused
kernel at rtol 1e-8 on these shapes. Grounded rollouts are compared over
ONE control step only (contact makes bit-different programs diverge
chaotically over longer grounded horizons), airborne ones over H = 3.

The per-control-step path (``engine_impl="pallas"``: the substep kernel
and a caller's stage cost) is held to the same JAX path with the same
custom cost: the JAX package's own ``"pallas"`` path differs from its
``"leg"`` path only in the engine behind ``control_step``, which
tests/test_torch_substep.py compares on its own, and its interpret-mode
``pallas_call`` costs many minutes of XLA compile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.solvers import rollout as jrollout
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu.tasks import rewards as jrewards
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.physics.engine import make_state
from quadruped_gym_tpu_torch.solvers import rollout as trollout
from quadruped_gym_tpu_torch.tasks import rewards as trewards

S = 8
PREV = np.array([0.0, 0.0, -0.5] * 4)


def _case(name, airborne, H, seed):
    jm = getattr(jspec, f"get_{name}_model")()
    tm = getattr(tspec, f"get_{name}_model")()
    rng = np.random.default_rng(seed)
    st = jengine.make_state(jm, dtype=jnp.float64)
    # a moving start: from rest the base's planar velocity is ~0 and the
    # progress term's direction v/|v| is ill-conditioned, which amplifies
    # rounding differences far beyond what the engines' parity means
    st = st._replace(qvel=jnp.asarray(0.1 * rng.standard_normal(jm.nv)))
    if airborne:
        st = st._replace(qpos=st.qpos.at[2].add(0.5))
    seqs = np.clip(PREV + 0.2 * rng.standard_normal((S, H, 12)), -1.0, 1.0)
    cmd = jcommands.make(jnp.asarray([0.2, 0.1]), jnp.asarray(0.3))
    return jm, tm, st, seqs, cmd


def _dp(seed):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, S)  # noqa: E731
    return jspec.DomainParams(
        friction=u(0.4, 0.8), gain_scale=u(0.8, 1.2),
        base_mass_scale=u(0.9, 1.5), tilt_x=u(-0.1, 0.1),
        tilt_y=u(-0.1, 0.1), terrain_amp=u(0.0, 0.02),
        terrain_freq=u(15.0, 30.0))


@pytest.mark.parametrize("name,airborne,H,with_dp", [
    ("planning", False, 1, False),
    ("planning", True, 3, False),
    ("planning", False, 1, True),
    ("fast_plant", False, 1, False),
])
def test_fused_reference_matches_jax(name, airborne, H, with_dp):
    jm, tm, st, seqs, cmd = _case(name, airborne, H, seed=7 + H)
    cfg = jrollout.RolloutConfig(horizon=H, frame_skip=2)
    dp = _dp(3) if with_dp else None
    jdp = None if dp is None else jspec.DomainParams(
        *(jnp.asarray(v) for v in dp))
    with jax.disable_jit():
        want = jrollout.lane_batched_rollout_cost(
            jm, cfg, jrollout.make_cost_fn(jm), st, jnp.asarray(seqs),
            cmd, jnp.asarray(PREV), newton_iterations=4, ls_iterations=8,
            engine_impl="leg", dp=jdp)
    got = cuda_engine.fused_rollout_cost_reference(
        tm, convert.state(st, device="cpu"), torch.as_tensor(seqs),
        convert.command(cmd, device="cpu"), torch.as_tensor(PREV),
        cfg.frame_skip, 4, 8,
        dp=None if dp is None else convert.domain_params(dp, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-8)


@pytest.mark.parametrize("name,airborne,H,with_dp", [
    ("planning", False, 1, False),
    ("planning", True, 2, True),
])
def test_pallas_path_with_custom_cost_matches_jax(name, airborne, H, with_dp):
    """A stage cost the fused kernel refuses (vel_smooth_eps > 0), from a
    moving start: rtol = atol = 1e-8 against the JAX package, and equal to
    the port's own eager path to rounding."""
    jm, tm, st, seqs, cmd = _case(name, airborne, H, seed=17 + H)
    cfg = jrollout.RolloutConfig(horizon=H, frame_skip=2)
    dp = _dp(5) if with_dp else None
    jdp = None if dp is None else jspec.DomainParams(
        *(jnp.asarray(v) for v in dp))
    with jax.disable_jit():
        want = jrollout.lane_batched_rollout_cost(
            jm, cfg, jrollout.make_cost_fn(jm, vel_smooth_eps=0.02), st,
            jnp.asarray(seqs), cmd, jnp.asarray(PREV), newton_iterations=4,
            ls_iterations=8, engine_impl="leg", dp=jdp)
    tcfg = trollout.RolloutConfig(horizon=H, frame_skip=2)
    args = (tm, tcfg, trollout.make_cost_fn(tm, vel_smooth_eps=0.02),
            convert.state(st, device="cpu"), torch.as_tensor(seqs),
            convert.command(cmd, device="cpu"), torch.as_tensor(PREV))
    kw = dict(newton_iterations=4, ls_iterations=8,
              dp=None if dp is None else convert.domain_params(
                  dp, device="cpu"))
    cuda_engine.reset_launch_counts()
    got = trollout.lane_batched_rollout_cost(*args, engine_impl="pallas",
                                             **kw)
    assert cuda_engine.launch_counts["substep"] == 0  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-8)
    leg = trollout.lane_batched_rollout_cost(*args, engine_impl="leg", **kw)
    torch.testing.assert_close(got, leg, rtol=1e-12, atol=1e-12)
    exact = trollout.lane_batched_rollout_cost(
        args[0], args[1], trollout.make_cost_fn(tm), *args[3:],
        engine_impl="pallas", **kw)
    assert float((exact - got).abs().max()) > 1e-6  # the cost_fn is used


@pytest.mark.parametrize("eps", [0.0, 0.02])
def test_walking_stage_cost_matches_jax(eps):
    jm = jspec.get_planning_model()
    tm = tspec.get_planning_model()
    jsl = jrewards.SensorSlices.from_model(jm)
    tsl = trewards.SensorSlices.from_model(tm)
    rng = np.random.default_rng(1)
    sens = rng.standard_normal((S, jm.nsensordata))
    sens[0, tsl.vel:tsl.vel + 2] = 0.0
    sens[1, tsl.zaxis + 2] = -0.5  # flipped
    ctrl = rng.uniform(-1, 1, (S, 12))
    prev = rng.uniform(-1, 1, (S, 12))
    cmd = jcommands.make(jnp.asarray([0.2, 0.1]), jnp.asarray(0.3))
    want = jax.vmap(
        lambda s, c, p: jrollout.walking_stage_cost(jsl, s, c, p, cmd, eps)
    )(jnp.asarray(sens), jnp.asarray(ctrl), jnp.asarray(prev))
    tcmd = convert.command(cmd, device="cpu")
    got = trollout.walking_stage_cost(
        tsl, torch.as_tensor(sens.T.copy()), torch.as_tensor(ctrl.T.copy()),
        torch.as_tensor(prev.T.copy()), tcmd, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-12)
    one = trollout.walking_stage_cost(
        tsl, torch.as_tensor(sens[2]), torch.as_tensor(ctrl[2]),
        torch.as_tensor(prev[2]), tcmd, eps)
    np.testing.assert_allclose(one.item(), float(want[2]), rtol=1e-13)


def test_make_cost_fn_marker():
    m = tspec.get_planning_model()
    assert trollout.make_cost_fn(m)._is_walking_stage_cost is True
    assert trollout.make_cost_fn(m, 0.02)._is_walking_stage_cost is False


def _dispatch_args(m, H=1):
    st = make_state(m, dtype=torch.float64, device="cpu")
    seqs = torch.as_tensor(np.tile(PREV, (4, H, 1)))
    cmd = convert.command(jcommands.make(jnp.asarray([0.2, 0.0]),
                                         jnp.asarray(0.0)), device="cpu")
    return st, seqs, cmd, torch.as_tensor(PREV)


def test_dispatch_fused_on_cpu_equals_leg_path():
    m = tspec.get_planning_model()
    cfg = trollout.RolloutConfig(horizon=2, frame_skip=2)
    st, seqs, cmd, prev = _dispatch_args(m, H=2)
    seqs = seqs + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(seqs.shape))
    kw = dict(newton_iterations=2, ls_iterations=4)
    fused = trollout.lane_batched_rollout_cost(
        m, cfg, trollout.make_cost_fn(m), st, seqs, cmd, prev,
        engine_impl="fused", **kw)
    leg = trollout.lane_batched_rollout_cost(
        m, cfg, trollout.make_cost_fn(m), st, seqs, cmd, prev,
        engine_impl="leg", **kw)
    torch.testing.assert_close(fused, leg, rtol=1e-12, atol=1e-12)


def test_dispatch_refuses_what_is_not_ported():
    m = tspec.get_planning_model()
    cfg = trollout.RolloutConfig(horizon=1, frame_skip=1)
    st, seqs, cmd, prev = _dispatch_args(m)
    cost = trollout.make_cost_fn(m)
    with pytest.raises(ValueError, match="DomainParams require"):
        trollout.lane_batched_rollout_cost(
            m, cfg, cost, st, seqs, cmd, prev, engine_impl="lane",
            dp=convert.domain_params(_dp(0), device="cpu"))
    with pytest.raises(ValueError, match="unknown engine_impl"):
        trollout.lane_batched_rollout_cost(m, cfg, cost, st, seqs, cmd, prev,
                                           engine_impl="xla")
    with pytest.raises(ValueError, match="hard-wires"):
        trollout.lane_batched_rollout_cost(
            m, cfg, trollout.make_cost_fn(m, 0.02), st, seqs, cmd, prev,
            engine_impl="fused")


def test_dispatch_lane_equals_leg():
    """``"lane"`` runs the lane engine: on a leg-compatible model the leg
    engine's math without the leg folding."""
    m = tspec.get_planning_model()
    cfg = trollout.RolloutConfig(horizon=2, frame_skip=2)
    st, seqs, cmd, prev = _dispatch_args(m, H=2)
    st = st._replace(qvel=torch.as_tensor(
        0.1 * np.random.default_rng(1).standard_normal(m.nv)))
    seqs = seqs + 0.1 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(seqs.shape))
    kw = dict(newton_iterations=2, ls_iterations=4)
    lane, leg = (trollout.lane_batched_rollout_cost(
        m, cfg, trollout.make_cost_fn(m), st, seqs, cmd, prev,
        engine_impl=impl, **kw) for impl in ("lane", "leg"))
    torch.testing.assert_close(lane, leg, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("impl", ["leg", "pallas", "fused"])
def test_dispatch_falls_back_to_lane(impl):
    """A model that is not leg-compatible (``full`` with one shin heavier
    than the others) warns and runs on the lane engine."""
    from torch_models import incompatible_full

    m = incompatible_full()
    cfg = trollout.RolloutConfig(horizon=1, frame_skip=1)
    st, seqs, cmd, prev = _dispatch_args(m)
    cost = trollout.make_cost_fn(m)
    kw = dict(newton_iterations=2, ls_iterations=4)
    with pytest.warns(UserWarning, match="falling back to the slower lane"):
        got = trollout.lane_batched_rollout_cost(
            m, cfg, cost, st, seqs, cmd, prev, engine_impl=impl, **kw)
    want = trollout.lane_batched_rollout_cost(
        m, cfg, cost, st, seqs, cmd, prev, engine_impl="lane", **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
