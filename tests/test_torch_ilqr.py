"""The port's iLQR (``solvers/ilqr.py``) against the JAX package, float64 on
the CPU: the tangent maps, the smooth sensors, the PSD projection and the
cost expansion piece by piece against live JAX (one jitted probe for the
expansion), the whole solve against the JAX results committed in
``tests/torch_gradient_refs.npz`` (a jitted JAX solve compiles for ~3
minutes; ``test_torch_sqp.py`` regenerates the file live under ``slow``).
Also the constants cache under ``torch.func`` transforms."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_gradient_cases import (F64, HOLD, JM, TM, close, jstate, refs,
                                  snapshot_script, to_jax_states,
                                  to_torch_states, trajectory, tstate)
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.solvers import ilqr as jilqr
from quadruped_gym_tpu.solvers import rollout as jrollout
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics import engine
from quadruped_gym_tpu_torch.solvers import ilqr, rollout
from quadruped_gym_tpu_torch.tasks import commands

NX = ilqr.tangent_dim(TM)
SMOOTH_EPS = 0.02


def _tcmd():
    return commands.make(torch.tensor([0.2, 0.1], dtype=F64),
                         torch.tensor(0.3, dtype=F64))


def _jcmd():
    return jcommands.make(jnp.asarray([0.2, 0.1]), jnp.asarray(0.3))


def test_tangent_dim_matches_jax():
    assert NX == jilqr.tangent_dim(JM) == 2 * TM.nv + TM.na == 48


@functools.lru_cache(maxsize=None)
def _jax_maps():
    def maps(st, dx):
        moved = jilqr.state_add(JM, st, dx)
        return moved, jilqr.state_diff(JM, moved, st)

    return jax.jit(maps)


@pytest.mark.parametrize("kind", ["contact", "tilted"])
def test_state_add_diff_match_jax(kind):
    dx = 0.05 * np.random.default_rng(2).standard_normal(NX)
    st = tstate(kind)
    got = ilqr.state_add(TM, st, torch.as_tensor(dx))
    want, jback = _jax_maps()(jstate(kind), jnp.asarray(dx))
    for f in ("qpos", "qvel", "act"):
        close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), 1e-12)
    back = ilqr.state_diff(TM, got, st).numpy()
    jback = np.asarray(jback)
    close(back, jback, 1e-12, atol_scale=1.0)
    close(back, dx, 1e-12, atol_scale=1.0)  # the round trip


def test_state_diff_jacobian_is_identity_at_zero():
    """R3: ``jacfwd(state_diff(state_add(st, dx), st))`` at dx = 0 is the
    identity, the rotation block included, with the base tilted. A
    literal port of the log map (a norm, then max(|v|, 1e-30)) gives a
    zero rotation block in torch."""
    st = tstate("tilted")
    J = torch.func.jacfwd(lambda dx: ilqr.state_diff(
        TM, ilqr.state_add(TM, st, dx), st))(torch.zeros(NX, dtype=F64))
    np.testing.assert_allclose(J.numpy(), np.eye(NX), rtol=0, atol=1e-12)
    # and as a batch: the same Jacobian for every row
    sts = engine.State(*(torch.stack([x, x]) for x in st))
    Jb = torch.func.vmap(lambda v: torch.func.jvp(
        lambda dx: ilqr.state_diff(TM, ilqr.state_add(TM, sts, dx), sts),
        (torch.zeros(2, NX, dtype=F64),), (v.expand(2, NX),))[1])(
        torch.eye(NX, dtype=F64))
    np.testing.assert_allclose(Jb.permute(1, 2, 0).numpy(),
                               np.stack([np.eye(NX)] * 2), rtol=0, atol=1e-12)


def test_smooth_sensordata_matches_jax():
    got = ilqr.smooth_sensordata(TM, tstate("contact")).numpy()
    want = np.asarray(jax.jit(lambda s: jilqr.smooth_sensordata(JM, s))(
        jstate("contact")))
    close(got, want, 1e-12)
    # the slots the planning cost reads equal the stepped sensors (which are
    # read before integration); only the accelerometer (12:15) differs
    stepped = engine.step(TM, tstate("contact"), torch.as_tensor(HOLD),
                          max_contacts=8, solver_iterations=2).sensordata
    mask = np.ones(TM.nsensordata, bool)
    mask[12:15] = False
    close(got[mask], stepped.numpy()[mask], 1e-12)


def test_psd_project_matches_jax():
    rng = np.random.default_rng(3)
    R = rng.standard_normal((5, 12, 12))
    S = R + R.transpose(0, 2, 1) - 2.0 * np.eye(12)  # indefinite
    got = ilqr.psd_project(torch.as_tensor(S)).numpy()
    want = np.asarray(jilqr.psd_project(jnp.asarray(S)))
    close(got, want, 1e-10)
    assert np.linalg.eigvalsh(got).min() > 0.0


@functools.lru_cache(maxsize=None)
def _jax_quadratize():
    cost = jrollout.make_cost_fn(JM, vel_smooth_eps=SMOOTH_EPS)
    cmd = _jcmd()
    return jax.jit(lambda s, u, p: jilqr.quadratize_cost(
        JM, cost, cmd, s, u, p, psd=False))


@pytest.mark.parametrize("psd", [False, True])
def test_quadratize_cost_matches_jax(psd):
    """(lx, lxx, lu, luu) at a moving state on the floor, 1e-8 relative;
    the PSD-projected Hessians are JAX's raw ones through JAX's
    ``psd_project``, as its ``quadratize_cost`` does."""
    us, states = trajectory("contact")
    want = list(_jax_quadratize()(to_jax_states(states), jnp.asarray(us),
                                  jnp.asarray(HOLD)))
    if psd:
        want[1] = jilqr.psd_project(want[1])
        want[3] = jilqr.psd_project(want[3])
    got = ilqr.quadratize_cost(
        TM, rollout.make_cost_fn(TM, vel_smooth_eps=SMOOTH_EPS), _tcmd(),
        to_torch_states(states), torch.as_tensor(us), torch.as_tensor(HOLD),
        psd=psd)
    for name, g, w in zip(("lx", "lxx", "lu", "luu"), got, want):
        assert g.shape == w.shape, name
        close(g.numpy(), np.asarray(w), 1e-8)
    assert float(got[0].abs().max()) > 1.0  # the state matters


def test_quadratize_cost_at_the_hold_is_finite_where_jax_is_nan():
    """A known difference: at controls equal to the standing hold, the
    posture cost |u - hold| has no derivative. JAX's norm gives NaN there
    (so its SQP step from a hold warm start is zeroed and the plan stays
    put); torch's gives 0, and the port's expansion is finite."""
    _, states = trajectory("contact")
    us = np.tile(HOLD, (2, 1))
    want = _jax_quadratize()(to_jax_states(states), jnp.asarray(us),
                             jnp.asarray(HOLD))
    got = ilqr.quadratize_cost(
        TM, rollout.make_cost_fn(TM, vel_smooth_eps=SMOOTH_EPS), _tcmd(),
        to_torch_states(states), torch.as_tensor(us), torch.as_tensor(HOLD),
        psd=False)
    assert np.isnan(np.asarray(want[2])).all()  # lu
    assert all(bool(torch.isfinite(x).all()) for x in got)
    # the state terms do not see the controls' kink
    close(got[0].numpy(), np.asarray(want[0]), 1e-8)
    close(got[1].numpy(), np.asarray(want[1]), 1e-8)


def _fresh_model():
    """A model object of its own: the constants cache lives on it."""
    return tspec.decimate_hulls(
        tspec.load_model(os.path.join(tspec.ASSETS_DIR, "feet.npz")))


def test_constants_cache_survives_transforms():
    """R1: the constants the engine caches on the model, built under the
    first caller's transform, must not escape into later calls at other
    transform levels: ``hessian``, then ``vmap(hessian)``, then
    ``jacfwd`` on one model object agree with each call on a fresh one."""
    st = tstate("contact")
    qs = torch.stack([st.qpos, st.qpos + 0.01])

    def sensors(m):
        return lambda q: ilqr.smooth_sensordata(m, st._replace(qpos=q))

    def cost(m):
        return lambda q: torch.sum(sensors(m)(q) ** 2)

    def calls(model):
        return [torch.func.hessian(cost(model()))(st.qpos),
                torch.func.vmap(torch.func.hessian(cost(model())))(qs),
                torch.func.jacfwd(sensors(model()))(st.qpos)]

    shared = _fresh_model()
    got = calls(lambda: shared)
    for g, w in zip(got, calls(_fresh_model)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # what the cache holds is plain tensors, with storage
    for c in shared._consts_cache.values():
        assert type(c.body_imat) is torch.Tensor
        assert c.body_imat.data_ptr() != 0


@functools.lru_cache(maxsize=None)
def _solve():
    """The port's iLQR at the JAX test's configuration (the snapshot
    script's case), from the reset state under the bad guess."""
    case = snapshot_script()
    m = tspec.get_mpc_plant_model()
    rcfg = rollout.RolloutConfig(**case.SOLVE_ROLLOUT)
    cfg = ilqr.ILQRConfig(rollout=rcfg, **case.ILQR)
    cmd = commands.make(torch.tensor([case.SPEED, 0.0], dtype=F64),
                        torch.tensor(0.0, dtype=F64))
    us0 = torch.as_tensor(np.tile(case.BAD_GUESS, (rcfg.horizon, 1)))
    st = engine.make_state(m, dtype=F64, device="cpu")
    return m, ilqr.solve(m, cfg, rollout.make_cost_fn(m), st, us0, cmd,
                         torch.as_tensor(case.HOLD))


def test_ilqr_solve_matches_jax_snapshot():
    _, res = _solve()
    ref = refs()
    close(res.cost_history.numpy(), ref["ilqr_cost_history"], 1e-7)
    close(res.cost.numpy(), ref["ilqr_cost"], 1e-7)
    close(res.initial_cost.numpy(), ref["ilqr_initial_cost"], 1e-7)
    np.testing.assert_allclose(res.ctrl_seq.numpy(), ref["ilqr_ctrl_seq"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(res.reg.numpy(), ref["ilqr_reg"], rtol=1e-12)


def test_ilqr_reduces_cost():
    m, res = _solve()
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < float(res.initial_cost) - 1.0
    hist = np.concatenate([[float(res.initial_cost)],
                           res.cost_history.numpy()])
    assert (np.diff(hist) <= 1e-9).all(), hist
    u = res.ctrl_seq.numpy()
    assert (u >= m.actuator_ctrlrange[:, 0]).all()
    assert (u <= m.actuator_ctrlrange[:, 1]).all()


def test_make_linearizer_names():
    assert ilqr.make_linearizer("fd") is ilqr.fd_linearize
    assert callable(ilqr.make_linearizer("ad"))
    with pytest.raises(ValueError, match="unknown linearize"):
        ilqr.make_linearizer("nope")
    assert ilqr.ILQRConfig() == ilqr.ILQRConfig(
        **{k: getattr(jilqr.ILQRConfig(), k) for k in (
            "iterations", "linearize", "fd_eps", "reg_init", "reg_factor",
            "reg_max", "alphas")})
