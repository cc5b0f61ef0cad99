"""The port's leg-batched engine against the JAX package's, float64 on the
CPU: ``step`` airborne and grounded on both models, DomainParams, and
``control_step``. The JAX engine runs eagerly (``jax.disable_jit``) at a
small batch; its jitted form costs tens of seconds of compile.

Tolerances are those of tests/test_pallas_engine.py (kernel vs engine):
qpos rtol 1e-12, qvel 1e-10, act 1e-14, sensordata 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.ops import lane_engine as jlane
from quadruped_gym_tpu.ops import leg_engine as jleg
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.ops import lane_engine as tlane
from quadruped_gym_tpu_torch.ops import leg_engine as tleg

B = 8
TOL = {"qpos": (1e-12, 1e-13), "qvel": (1e-10, 1e-11),
       "act": (1e-14, 1e-15), "sensordata": (1e-10, 1e-11)}


def _models(name):
    return (getattr(jspec, f"get_{name}_model")(),
            getattr(tspec, f"get_{name}_model")())


def _inputs(m, seed, kind):
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0)[None] + 0.05 * rng.standard_normal((B, m.nq))
    if kind == "airborne":
        qpos[:, 2] += 0.5
    elif kind == "low":  # shins and ankle servos near the ground
        qpos[:, 2] = 0.03
    qvel = 0.1 * rng.standard_normal((B, m.nv))
    act = np.tile([0.0, 0.0, -0.5] * 4, (B, 1))
    if kind == "at_rest":  # servo forces inside their range
        qpos = np.tile(np.asarray(m.qpos0), (B, 1))
        act = np.zeros((B, m.na))
    ctrl = (np.array([0.1, -0.1, -0.5] * 4)[:, None]
            + 0.1 * rng.standard_normal((12, B)))
    return (qpos, qvel, act, np.zeros(B), np.zeros((B, m.nsensordata))), ctrl


def _dp_np(seed):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, B)  # noqa: E731
    return jspec.DomainParams(
        friction=u(0.4, 0.8), gain_scale=u(0.8, 1.2),
        base_mass_scale=u(0.9, 1.5), tilt_x=u(-0.1, 0.1),
        tilt_y=u(-0.1, 0.1), terrain_amp=u(0.0, 0.02),
        terrain_freq=u(15.0, 30.0))


def _run_both(name, kind, seed, frame_skip=None, dp=None):
    jm, tm = _models(name)
    batched, ctrl = _inputs(jm, seed, kind)
    jls = jlane.from_batched(*(jnp.asarray(x) for x in batched))
    tls = convert.lane_state(jls, device="cpu")
    jdp = None if dp is None else jspec.DomainParams(
        *(None if v is None else jnp.asarray(v) for v in dp))
    tdp = None if dp is None else convert.domain_params(dp, device="cpu")
    with jax.disable_jit():
        if frame_skip is None:
            want = jleg.step(jm, jls, jnp.asarray(ctrl), 4, 8, dp=jdp)
        else:
            want = jleg.control_step(jm, jls, jnp.asarray(ctrl), frame_skip,
                                     4, 8, dp=jdp)
    if frame_skip is None:
        got = tleg.step(tm, tls, torch.as_tensor(ctrl), 4, 8, dp=tdp)
    else:
        got = tleg.control_step(tm, tls, torch.as_tensor(ctrl), frame_skip,
                                4, 8, dp=tdp)
    return want, got


def _assert_close(want, got):
    for f, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    np.testing.assert_allclose(got.time.numpy(), np.asarray(want.time),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("name,kind", [
    ("planning", "airborne"), ("planning", "grounded"),
    ("planning", "at_rest"),
    ("fast_plant", "airborne"), ("fast_plant", "low"),
])
def test_step_matches_jax(name, kind):
    want, got = _run_both(name, kind, seed=sum(map(ord, name + kind)))
    _assert_close(want, got)


@pytest.mark.parametrize("name", ["planning", "fast_plant"])
def test_step_domain_params_match_jax(name):
    want, got = _run_both(name, "grounded", seed=11, dp=_dp_np(5))
    _assert_close(want, got)


def test_control_step_matches_jax():
    want, got = _run_both("planning", "grounded", seed=12, frame_skip=2,
                          dp=_dp_np(6))
    _assert_close(want, got)


def test_grounded_inputs_touch_the_ground():
    """The grounded cases above really exercise the contact solve."""
    _, tm = _models("planning")
    batched, ctrl = _inputs(tm, 3, "grounded")
    ls = tlane.from_batched(*(torch.as_tensor(x) for x in batched))
    free = tleg.step(tm, ls, torch.as_tensor(ctrl), 0, 0)
    solved = tleg.step(tm, ls, torch.as_tensor(ctrl), 4, 8)
    assert float((free.qvel - solved.qvel).abs().max()) > 1e-3


def test_is_compatible():
    for name in ("planning", "fast_plant"):
        jm, tm = _models(name)
        assert tleg.is_compatible(tm) == jleg.is_compatible(jm) is True
