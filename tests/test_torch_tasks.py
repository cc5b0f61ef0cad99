"""The task layer of the port (commands, rewards, estimator, Madgwick
filter, observations) against the JAX package, float64 on the CPU.

The JAX functions take one sample and are vmapped over a small batch
here; the port's take the batch directly (primitives with the component
axis first, composites and carries with it last). Inputs come from numpy
seeds. Tolerance: rtol 1e-12 / atol 1e-13 unless stated (the same
formulas, sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu.tasks import estimator as jest
from quadruped_gym_tpu.tasks import madgwick as jmad
from quadruped_gym_tpu.tasks import observations as jobs
from quadruped_gym_tpu.tasks import rewards as jrew
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.tasks import commands as tcommands
from quadruped_gym_tpu_torch.tasks import estimator as testim
from quadruped_gym_tpu_torch.tasks import madgwick as tmad
from quadruped_gym_tpu_torch.tasks import observations as tobs
from quadruped_gym_tpu_torch.tasks import rewards as trew

B = 6
RTOL, ATOL = 1e-12, 1e-13
JM, TM = jspec.get_planning_model(), tspec.get_planning_model()
JSL = jrew.SensorSlices.from_model(JM)
TSL = trew.SensorSlices.from_model(TM)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _batch(seed=0):
    """Sensordata, controls, commands and estimates for B samples; sample 0
    stands still, sample 1 is flipped."""
    rng = np.random.default_rng(seed)
    sens = rng.standard_normal((B, 33))
    sens[0, TSL.vel:TSL.vel + 3] = 0.0
    sens[0, TSL.linvel:TSL.linvel + 3] = 0.0
    sens[1, TSL.zaxis + 2] = -0.5
    ctrl = rng.uniform(-1, 1, (B, 12))
    vxy = rng.uniform(-0.5, 0.5, (B, 2))
    vxy[2] = 0.0  # a zero command
    theta = rng.uniform(-3, 3, B)
    jcmd = jax.vmap(jcommands.make)(jnp.asarray(vxy), jnp.asarray(theta))
    ideal = rng.standard_normal((B, 3))
    f_est = rng.uniform(0, 3, (B, 12))
    a_est = rng.uniform(0, 2, (B, 12))
    return sens, ctrl, jcmd, ideal, f_est, a_est


def _carries(seed=1):
    rng = np.random.default_rng(seed)
    flags = np.array([False, True, True, False, True, False])
    jc = jrew.RewardCarry(
        previous_ctrl=jnp.asarray(rng.uniform(-1, 1, (B, 12))),
        ctrl_cost_ref=jnp.asarray(rng.uniform(0, 2, B)),
        ctrl_cost_ref_set=jnp.asarray(flags),
        prev_rewards_to_derive=jnp.asarray(rng.standard_normal((B, 1))),
        has_prev_derive=jnp.asarray(~flags))
    return jc, convert.reward_carry(jc, device="cpu")


# --------------------------------------------------------------------------
# commands


def test_make_zero_from_speed_alpha_match_jax():
    rng = np.random.default_rng(0)
    vxy, theta = rng.standard_normal((B, 2)), rng.uniform(-3, 3, B)
    want = jax.vmap(jcommands.make)(jnp.asarray(vxy), jnp.asarray(theta))
    got = tcommands.make(_t(vxy), _t(theta))
    one = tcommands.make(_t(vxy[1]), _t(theta[1]))
    for f in tcommands.Command._fields:
        _close(getattr(got, f), getattr(want, f), msg=f)
        _close(getattr(one, f), getattr(want, f)[1], msg=f)
    speed, alpha = rng.uniform(0, 1, B), rng.uniform(-3, 3, B)
    want = jax.vmap(jcommands.from_speed_alpha)(
        jnp.asarray(speed), jnp.asarray(alpha), jnp.asarray(theta))
    got = tcommands.from_speed_alpha(_t(speed), _t(alpha), _t(theta))
    for f in tcommands.Command._fields:
        _close(getattr(got, f), getattr(want, f), msg=f)
    _close(tcommands.heading_theta(got), jax.vmap(jcommands.heading_theta)(
        want))
    for tf, jf in ((tcommands.velocity_speed_alpha,
                    jcommands.velocity_speed_alpha),
                   (tcommands.global_velocity_speed_alpha,
                    jcommands.global_velocity_speed_alpha)):
        for g, w in zip(tf(got), jax.vmap(jf)(want)):
            _close(g, w)
    z = tcommands.zero(torch.float64, "cpu", (B,))
    jz = jcommands.zero(jnp.float64)
    for f in tcommands.Command._fields:
        assert getattr(z, f).shape == (B, 3)
        _close(getattr(z, f)[0], getattr(jz, f))
    given = {"max_speed": 0.5, "fixed_speed": None, "fixed_heading_angle": 1}
    np.testing.assert_equal(tuple(tcommands.SampleOptions.from_dict(given)),
                            tuple(jcommands.SampleOptions.from_dict(given)))


def test_sample_ranges_and_fixed_values():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    opts = tcommands.SampleOptions(min_speed=0.2, max_speed=0.6)
    cmd = tcommands.sample(gen, opts, torch.float64, (n,))
    speed, alpha = tcommands.velocity_speed_alpha(cmd)
    theta = tcommands.heading_theta(cmd)
    assert cmd.velocity.shape == (n, 3) and cmd.velocity.dtype == torch.float64
    assert 0.2 <= float(speed.min()) < 0.21 and 0.59 < float(speed.max()) <= 0.6
    for ang in (alpha, theta):  # U(-pi, pi): both tails reached, mean ~ 0
        assert float(ang.min()) < -3.0 and float(ang.max()) > 3.0
        assert abs(float(ang.mean())) < 0.15
    assert abs(float(torch.corrcoef(torch.stack([alpha, theta]))[0, 1])) < 0.06
    torch.testing.assert_close(torch.linalg.vector_norm(cmd.heading, dim=-1),
                               torch.ones(n, dtype=torch.float64))
    gspeed, _ = tcommands.global_velocity_speed_alpha(cmd)
    torch.testing.assert_close(gspeed, speed)
    fixed = tcommands.sample(gen, tcommands.SampleOptions(
        fixed_heading_angle=0.5, fixed_velocity_angle=-1.0, fixed_speed=0.3),
        torch.float64, (3,))
    want = jcommands.sample(jax.random.PRNGKey(0), jcommands.SampleOptions(
        fixed_heading_angle=0.5, fixed_velocity_angle=-1.0, fixed_speed=0.3),
        jnp.float64)
    for f in tcommands.Command._fields:
        _close(getattr(fixed, f)[2], getattr(want, f), msg=f)
    single = tcommands.sample(gen, opts, torch.float32)
    assert single.velocity.shape == (3,) and single.velocity.dtype == \
        torch.float32


# --------------------------------------------------------------------------
# rewards


_SENS_CMD = ["progress_direction_reward_global", "progress_speed_cost_global",
             "progress_direction_reward_local", "progress_speed_reward_local",
             "progress_speed_cost_local", "progress_cost_local",
             "heading_reward"]
_SENS = ["orientation_reward", "body_height_cost", "flip_termination",
         "dummy_forward_reward", "dummy_no_drift_reward"]
_CTRL = ["joint_posture_cost", "control_frequency_cost",
         "control_amplitude_cost"]


@pytest.mark.parametrize("name", _SENS_CMD + _SENS + _CTRL + [
    "ideal_position_cost", "exp_dist", "alive_bonus", "time_termination"])
def test_reward_term_matches_jax(name):
    sens, ctrl, jcmd, ideal, f_est, _ = _batch()
    tcmd = convert.command(jcmd, device="cpu")
    tcmd_first = tcommands.Command(*(x.T for x in tcmd))
    jf, tf = getattr(jrew, name), getattr(trew, name)
    js, ts = jnp.asarray(sens), _t(sens.T.copy())
    if name in _SENS_CMD:
        want = jax.vmap(lambda s, c: jf(s, JSL, c))(js, jcmd)
        got = tf(ts, TSL, tcmd_first)
        # one shared (3,) command broadcasts over the lanes
        c0 = tcommands.Command(*(x[3] for x in tcmd))
        jc0 = jcommands.Command(*(x[3] for x in jcmd))
        _close(tf(ts, TSL, c0), jax.vmap(lambda s: jf(s, JSL, jc0))(js))
        _close(tf(ts[:, 4], TSL, c0), jf(js[4], JSL, jc0))
    elif name in _SENS:
        want = jax.vmap(lambda s: jf(s, JSL))(js)
        got = tf(ts, TSL)
    elif name in _CTRL:
        x = f_est if name != "joint_posture_cost" else ctrl
        want = jax.vmap(jf)(jnp.asarray(x))
        got = tf(_t(x.T.copy()))
        _close(tf(_t(x[2])), jf(jnp.asarray(x[2])))
    elif name == "ideal_position_cost":
        want = jax.vmap(lambda s, i: jf(s, JSL, i))(js, jnp.asarray(ideal))
        got = tf(ts, TSL, _t(ideal.T.copy()))
    elif name == "exp_dist":
        want, got = jf(js), tf(_t(sens))
    elif name == "alive_bonus":
        want, got = jf(jnp.float64), tf(torch.float64, "cpu")
    else:
        t = np.array([0.0, 4.99, 5.0, 7.0])
        want, got = jf(jnp.asarray(t), 5.0), tf(_t(t), 5.0)
    assert tuple(got.shape) == tuple(want.shape)
    if got.dtype == torch.bool:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def test_control_cost_and_carries_match_jax():
    _, ctrl, *_ = _batch()
    jc, tc = _carries()
    want = jax.vmap(jrew.control_cost)(jnp.asarray(ctrl), jc)
    got = trew.control_cost(_t(ctrl.T.copy()), trew._carry_first(tc))
    _close(got[0], want[0])
    _close(got[1].T, want[1])
    _close(got[2], want[2])
    ji = jrew.init_carry(jnp.float64)
    ti = trew.init_carry(torch.float64, "cpu", (B,))
    jr = jax.vmap(lambda c: jrew.episode_reset_carry(c, jnp.float64))(jc)
    tr = trew.episode_reset_carry(tc)
    for f in trew.RewardCarry._fields:
        assert getattr(ti, f).shape[0] == B
        np.testing.assert_array_equal(getattr(ti, f)[0].numpy(),
                                      np.asarray(getattr(ji, f)), f)
        assert getattr(tr, f).dtype == getattr(tc, f).dtype
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), f)


def test_input_control_reward_matches_jax():
    sens, ctrl, jcmd, ideal, f_est, a_est = _batch()
    jc, tc = _carries()
    want = jax.vmap(lambda s, c, cm, i, f, a, r: jrew.input_control_reward(
        s, c, cm, i, f, a, r, JSL, 0.008))(
            jnp.asarray(sens), jnp.asarray(ctrl), jcmd, jnp.asarray(ideal),
            jnp.asarray(f_est), jnp.asarray(a_est), jc)
    got = trew.input_control_reward(
        _t(sens), _t(ctrl), convert.command(jcmd, device="cpu"), _t(ideal),
        _t(f_est), _t(a_est), tc, TSL, 0.008)
    assert got.components.shape == (B, len(trew.REWARD_KEYS)) == (B, 11)
    assert trew.REWARD_KEYS == jrew.REWARD_KEYS
    _close(got.total, want.total)
    _close(got.components, want.components)
    # the derivative term is zero where there was no previous value
    assert np.all(got.components.numpy()[np.asarray(~jc.has_prev_derive), 10]
                  == 0.0)
    for f in trew.RewardCarry._fields:
        g, w = getattr(got.carry, f), getattr(want.carry, f)
        assert tuple(g.shape) == tuple(w.shape), f
        _close(g, w, msg=f)
    # one sample, no batch axis
    i = 3
    one = trew.input_control_reward(
        _t(sens[i]), _t(ctrl[i]),
        tcommands.Command(*(x[i] for x in convert.command(jcmd,
                                                          device="cpu"))),
        _t(ideal[i]), _t(f_est[i]), _t(a_est[i]),
        trew.RewardCarry(*(x[i] for x in tc)), TSL, 0.008)
    _close(one.total, want.total[i])
    _close(one.components, want.components[i])


def test_dummy_composite_matches_jax():
    sens, ctrl, *_ = _batch(3)
    jc, tc = _carries(4)
    want = jax.vmap(lambda s, c, r: jrew.dummy_composite(s, c, r, JSL))(
        jnp.asarray(sens), jnp.asarray(ctrl), jc)
    total, carry = trew.dummy_composite(_t(sens), _t(ctrl), tc, TSL)
    _close(total, want[0])
    for f in trew.RewardCarry._fields:
        _close(getattr(carry, f), getattr(want[1], f), msg=f)


@pytest.mark.parametrize("x", [[0.0, 0.0], [1e-8, -2e-8], [0.3, -0.4],
                               [2.0, 0.1, -0.5]])
def test_unit_gradient_matches_jax_jvp(x):
    """Forward and Jacobian, at 0, below the gradient guard and away from
    0: the port's autograd.Function against ``jax.jvp`` through the JAX
    package's ``custom_jvp``."""
    xj = jnp.asarray(x, jnp.float64)
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    _close(trew.unit(xt).detach(), jrew.unit(xj), rtol=1e-15, atol=0)
    jac_t = torch.autograd.functional.jacobian(trew.unit, xt)
    n = len(x)
    jac_j = np.stack([np.asarray(jax.jvp(jrew.unit, (xj,), (jnp.eye(
        n, dtype=jnp.float64)[i],))[1]) for i in range(n)], axis=1)
    _close(jac_t, jac_j, rtol=1e-13, atol=1e-15)
    if max(abs(v) for v in x) < 1e-6:
        assert float(jac_t.abs().max()) == 0.0
    else:
        assert float(jac_t.abs().max()) > 0.1
    # lanes: the gradient of a lane batch is per lane
    lanes = torch.tensor([x, x], dtype=torch.float64).T.clone()
    lanes.requires_grad_(True)
    w = torch.arange(1.0, n + 1, dtype=torch.float64)[:, None]
    (g,) = torch.autograd.grad((trew.unit(lanes) * w).sum(), lanes)
    _close(g[:, 0], jac_j.T @ w[:, 0].numpy(), rtol=1e-13, atol=1e-15)


# --------------------------------------------------------------------------
# estimator


def test_estimator_update_matches_jax_over_a_window():
    """More steps than the window holds, so the circular buffer wraps;
    plateaus (zero derivative) and sign changes both occur; each
    environment starts at its own buffer index."""
    C, dt_, N = 4, 0.1, 3
    W = testim.window_size(1.0, dt_)
    assert W == jest.window_size(1.0, dt_) == 20
    rng = np.random.default_rng(2)
    steps = W + 6
    xs = np.round(np.sin(0.9 * np.arange(steps))[:, None, None]
                  + 0.3 * rng.standard_normal((steps, N, C)), 1)
    xs[5] = xs[4]  # a plateau on every channel
    js = jax.vmap(lambda _: jest.init(C, W, jnp.float64))(jnp.arange(N))
    js = js._replace(buffer_index=jnp.asarray([0, 7, 19], jnp.int32))
    ts = convert.freq_amp_state(js, device="cpu")
    fresh = testim.init(C, W, torch.float64, "cpu", (N,))
    for f in testim.FreqAmpState._fields:
        assert getattr(fresh, f).shape == getattr(ts, f).shape, f
        assert getattr(fresh, f).dtype == getattr(ts, f).dtype, f
    jupd = jax.vmap(lambda s, x: jest.update(s, x, dt_, 0.8))
    for k in range(steps):
        js, jf, ja = jupd(js, jnp.asarray(xs[k]))
        ts, tf, ta = testim.update(ts, _t(xs[k]), dt_, 0.8)
        _close(tf, jf, msg=f"f_est step {k}")
        _close(ta, ja, msg=f"a_est step {k}")
        for f in testim.FreqAmpState._fields:
            _close(getattr(ts, f), getattr(js, f), msg=f"{f} step {k}")
    assert float(ts.f_est.max()) > 0.5 and float(ts.a_est.max()) > 0.5
    # one estimator, no batch axis
    s1 = testim.init(C, W, torch.float64, "cpu")
    j1 = jest.init(C, W, jnp.float64)
    for k in range(4):
        s1, f1, a1 = testim.update(s1, _t(xs[k, 0]), dt_)
        j1, jf1, ja1 = jest.update(j1, jnp.asarray(xs[k, 0]), dt_)
    _close(f1, jf1)
    _close(a1, ja1)


# --------------------------------------------------------------------------
# Madgwick filter and observations


def _imu_batch(seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] *= 1.3  # not normalized
    gyr = rng.standard_normal((B, 3))
    acc = rng.standard_normal((B, 3)) + np.array([0, 0, 9.81])
    gyr[0] = 0.0  # zero gyro: no update
    acc[1] = 0.0  # zero accel: gyro-only integration
    return q, gyr, acc


def test_madgwick_update_matches_jax():
    q, gyr, acc = _imu_batch()
    want = jax.vmap(lambda a, b, c: jmad.update_imu(a, b, c, 0.008))(
        jnp.asarray(q), jnp.asarray(gyr), jnp.asarray(acc))
    got = tmad.update_imu(_t(q), _t(gyr), _t(acc), 0.008)
    _close(got, want)
    np.testing.assert_array_equal(got[0].numpy(), q[0])
    _close(tmad.update_imu(_t(q[2]), _t(gyr[2]), _t(acc[2]), 0.008), want[2])
    _close(tmad.to_euler(got), jax.vmap(jmad.to_euler)(want))
    assert tmad.DEFAULT_GAIN == jmad.DEFAULT_GAIN


@pytest.mark.parametrize("settling", [0.0, 1.0])
def test_po_observation_matches_jax(settling):
    sens, ctrl, jcmd, *_ = _batch(6)
    q, _, _ = _imu_batch(7)
    time = np.array([0.0, 0.2, 0.5, 0.6, 1.0, 2.0])
    want = jax.vmap(lambda s, c, cm, mq, t: jobs.po_observation(
        JSL, s, c, cm, mq, t, settling, 0.008))(
            jnp.asarray(sens), jnp.asarray(ctrl), jcmd, jnp.asarray(q),
            jnp.asarray(time))
    got = tobs.po_observation(TSL, _t(sens), _t(ctrl),
                              convert.command(jcmd, device="cpu"), _t(q),
                              _t(time), settling, 0.008)
    assert got[0].shape == (B, tobs.PO_OBS_DIM) == (B, jobs.PO_OBS_DIM)
    _close(got[0], want[0])
    _close(got[1], want[1])
    if settling:  # the filter holds still until settling_time / 2 has passed
        np.testing.assert_array_equal(got[1][:3].numpy(), q[:3])
        assert float((got[1][3:] - _t(q)[3:]).abs().max()) > 0


def test_stack_push_fill_and_init_match_jax():
    rng = np.random.default_rng(8)
    buf = rng.standard_normal((B, 5, 26))
    obs = rng.standard_normal((B, 26))
    _close(tobs.stack_push(_t(buf), _t(obs)), jax.vmap(jobs.stack_push)(
        jnp.asarray(buf), jnp.asarray(obs)), rtol=0, atol=0)
    _close(tobs.stack_fill(_t(buf), _t(obs)), jax.vmap(jobs.stack_fill)(
        jnp.asarray(buf), jnp.asarray(obs)), rtol=0, atol=0)
    _close(tobs.stack_push(_t(buf[0]), _t(obs[0])),
           jobs.stack_push(jnp.asarray(buf[0]), jnp.asarray(obs[0])),
           rtol=0, atol=0)
    tc = tobs.po_init_carry(5, torch.float64, "cpu", (B,))
    jc = jobs.po_init_carry(5, jnp.float64)
    assert tc.buffer.shape == (B, 5, 26) and tc.mad_quat.shape == (B, 4)
    _close(tc.mad_quat[1], jc.mad_quat, rtol=0, atol=0)
    via = convert.po_obs_carry(jc, device="cpu")
    _close(via.buffer, jc.buffer, rtol=0, atol=0)
