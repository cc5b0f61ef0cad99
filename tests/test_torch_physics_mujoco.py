"""The port's oracle engine against CPU MuJoCo directly (float64): the
cases of tests/test_smooth_parity.py and tests/test_contact_parity.py that
are not slow, at those files' tolerances, on the port's ``full`` model
snapshot. Each loop state is its own case."""

import mujoco
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.testing import load_mj, random_airborne_state
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics import engine, smooth

PM = tspec.get_full_model()
DRAWS = range(5)


@pytest.fixture(scope="module")
def mjpair():
    return load_mj()


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _airborne(mjpair, seed, draw, vel_scale=1.0):
    """The ``draw``-th state of the JAX package's test with this seed."""
    mj, d = mjpair
    rng = np.random.default_rng(seed)
    for _ in range(draw + 1):
        random_airborne_state(mj, d, rng, vel_scale=vel_scale)
    return mj, d


def _smooth_pipeline(qpos, qvel, act):
    kin = smooth.fwd_position(PM, qpos)
    S = smooth.dof_subspace(PM, kin)
    cvel = smooth.body_velocities(PM, S, qvel)
    M = smooth.crba(PM, kin, S)
    bias = smooth.rne_bias(PM, kin, S, cvel, qvel)
    actu = smooth.actuation(PM, qpos, qvel, act)
    return kin, S, cvel, M, bias, actu


def _state_from(d):
    return engine.State(qpos=_t(d.qpos), qvel=_t(d.qvel), act=_t(d.act),
                        time=_t(d.time),
                        sensordata=torch.zeros(PM.nsensordata,
                                               dtype=torch.float64))


@pytest.mark.parametrize("draw", DRAWS)
def test_forward_kinematics(mjpair, draw):
    mj, d = _airborne(mjpair, 0, draw)
    kin = smooth.fwd_position(PM, _t(d.qpos))
    np.testing.assert_allclose(kin.xpos.numpy(), d.xpos, atol=1e-7)
    np.testing.assert_allclose(kin.xmat.numpy(), d.xmat.reshape(-1, 3, 3),
                               atol=1e-6)
    np.testing.assert_allclose(kin.xipos.numpy(), d.xipos, atol=1e-7)
    np.testing.assert_allclose(kin.ximat.numpy(), d.ximat.reshape(-1, 3, 3),
                               atol=1e-6)


@pytest.mark.parametrize("draw", DRAWS)
def test_mass_matrix_bias_actuation(mjpair, draw):
    mj, d = _airborne(mjpair, 1, draw, vel_scale=2.0)
    qpos, qvel, act = _t(d.qpos), _t(d.qvel), _t(d.act)
    _, _, _, M, bias, actu = _smooth_pipeline(qpos, qvel, act)
    Mref = np.zeros((mj.nv, mj.nv))
    mujoco.mj_fullM(mj, d, Mref)
    np.testing.assert_allclose(M.numpy(), Mref, atol=1e-12)
    np.testing.assert_allclose(bias.numpy(), d.qfrc_bias, atol=1e-10)
    np.testing.assert_allclose(actu.force.numpy(), d.actuator_force,
                               atol=1e-12)
    np.testing.assert_allclose(actu.qfrc.numpy(), d.qfrc_actuator, atol=1e-12)
    np.testing.assert_allclose(smooth.passive_force(PM, qvel).numpy(),
                               d.qfrc_passive, atol=1e-12)


@pytest.mark.parametrize("draw", DRAWS)
def test_smooth_qacc(mjpair, draw):
    mj, d = _airborne(mjpair, 2, draw)
    assert d.nefc == 0
    qpos, qvel, act = _t(d.qpos), _t(d.qvel), _t(d.act)
    _, _, _, M, bias, actu = _smooth_pipeline(qpos, qvel, act)
    qfrc_smooth = actu.qfrc + smooth.passive_force(PM, qvel) - bias
    np.testing.assert_allclose(qfrc_smooth.numpy(), d.qfrc_smooth, atol=1e-10)
    qacc = torch.linalg.solve(M, qfrc_smooth)
    np.testing.assert_allclose(qacc.numpy(), d.qacc, atol=1e-8)
    # the engine's own route to the same number, constraint-free
    fwd = engine.forward(PM, _state_from(d), _t(d.ctrl))
    np.testing.assert_allclose(fwd.qacc.numpy(), d.qacc, atol=1e-8)
    assert int(fwd.ncon_active) == 0


def test_standing_forward_parity(mjpair):
    mj, d = mjpair
    mujoco.mj_resetData(mj, d)
    d.qpos[:] = mj.qpos0
    d.ctrl[:] = np.array([0, 0, -0.5] * 4)
    for _ in range(300):
        mujoco.mj_step(mj, d)
    mujoco.mj_forward(mj, d)
    assert d.ncon == 4  # one support contact per foot

    fwd = engine.forward(PM, _state_from(d), _t(d.ctrl))
    assert int(fwd.ncon_active) == d.nefc
    np.testing.assert_allclose(fwd.qacc.numpy(), d.qacc, atol=1e-9)
    np.testing.assert_allclose(fwd.qfrc_constraint.numpy(),
                               d.qfrc_constraint, atol=1e-9)
    np.testing.assert_allclose(fwd.sensordata.numpy(), d.sensordata,
                               atol=1e-9)


def test_joint_limit_parity(mjpair):
    mj, d = mjpair
    mujoco.mj_resetData(mj, d)
    d.qpos[:] = mj.qpos0
    d.qpos[2] = 1.0
    d.qpos[7] = mj.jnt_range[1][0] - 0.013  # violate hip_1 lower limit
    d.qvel[:] = 0.3
    d.ctrl[:] = np.array([0.2, -0.3, 0.5] * 4)
    mujoco.mj_forward(mj, d)
    assert d.nefc == 1

    fwd = engine.forward(PM, _state_from(d), _t(d.ctrl))
    assert int(fwd.ncon_active) == 1
    np.testing.assert_allclose(fwd.qacc.numpy(), d.qacc, atol=1e-9)


def test_implicitfast_steps_airborne(mjpair):
    """40 contact-free ``engine.step`` calls against ``mj_step``: actuator
    saturation, the exact activation filter and the quaternion update."""
    mj, d = mjpair
    mujoco.mj_resetData(mj, d)
    d.qpos[:] = mj.qpos0
    d.qpos[0:3] = [0, 0, 2.0]
    d.ctrl[:] = np.array([0.3, -0.5, 0.8] * 4)
    st, ctrl = _state_from(d), _t(d.ctrl)
    for _ in range(40):
        mujoco.mj_step(mj, d)
        st = engine.step(PM, st, ctrl)
    assert d.ncon == 0, "test requires a contact-free trajectory"
    np.testing.assert_allclose(st.qpos.numpy(), d.qpos, atol=1e-12)
    np.testing.assert_allclose(st.qvel.numpy(), d.qvel, atol=1e-11)
    np.testing.assert_allclose(st.act.numpy(), d.act, atol=1e-13)
    np.testing.assert_allclose(st.time.item(), d.time, atol=1e-12)


def test_random_actuation_bounded_divergence(mjpair):
    """Contact-rich random flailing: multi-contact selection is calibrated,
    not bit-identical, so trajectories may diverge slowly; body position
    drift must stay within millimetres over 400 steps (0.8 s)."""
    mj, d = mjpair
    rng = np.random.default_rng(11)
    mujoco.mj_resetData(mj, d)
    d.qpos[:] = mj.qpos0
    d.ctrl[:] = np.array([0, 0, -0.5] * 4)
    st, ctrl = _state_from(d), _t(d.ctrl)
    for i in range(400):
        if i % 25 == 0:
            c = rng.uniform(mj.actuator_ctrlrange[:, 0],
                            mj.actuator_ctrlrange[:, 1])
            d.ctrl[:] = c
            ctrl = _t(c)
        mujoco.mj_step(mj, d)
        st = engine.step(PM, st, ctrl)
    body_err = np.abs(st.qpos[:3].numpy() - d.qpos[:3]).max()
    joint_err = np.abs(st.qpos[7:].numpy() - d.qpos[7:]).max()
    assert body_err < 5e-3, body_err
    assert joint_err < 5e-2, joint_err
