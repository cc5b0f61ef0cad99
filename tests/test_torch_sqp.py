"""The port's SQP (``solvers/sqp.py``) and both linearizations of
``solvers/ilqr.py`` against the JAX package, float64 on the CPU: the
condensation algebra and the box QP against live JAX on the JAX tests'
shapes, ``fd_linearize`` (airborne and in contact) and ``ad_linearize``
at the model's Newton budget against jitted JAX probes, and the whole
solve against the JAX results committed in ``tests/torch_gradient_refs.npz``
(the ``slow`` test here recomputes that file's results live). The sharded
condensation over 2 and 4 gloo ranks (``tests/torch_dist_workers.py``)
against JAX's under ``shard_map`` on as many virtual CPU devices, a
horizon the ranks divide and one they do not (zero-padded), 1e-12; and
``solve(mesh=)`` over those ranks against the unsharded solve, 1e-10."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_gradient_cases import (F64, HOLD, JM, STEP_KW, TM, close, jstate,
                                  refs, snapshot_script, to_jax_states,
                                  to_torch_states, trajectory, tstate)
import torch_dist_workers as W
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu import parallel as jparallel
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.solvers import ilqr as jilqr
from quadruped_gym_tpu.solvers import sqp as jsqp
from quadruped_gym_tpu_torch import parallel
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.parallel.mesh import group_scope
from quadruped_gym_tpu_torch.physics import engine
from quadruped_gym_tpu_torch.solvers import ilqr, rollout, sqp
from quadruped_gym_tpu_torch.tasks import commands

FD_EPS = 1e-5


def test_sensitivities_match_jax():
    H, nx, nu = 5, 3, 2
    rng = np.random.default_rng(0)
    A = 0.3 * rng.standard_normal((H, nx, nx))
    B = rng.standard_normal((H, nx, nu))
    got = sqp.sensitivities(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    want = np.asarray(jsqp.sensitivities(jnp.asarray(A), jnp.asarray(B)))
    assert got.shape == (H, nx, H * nu)
    close(got, want, 1e-12)
    # dx_{t+1}/du_s = A_t ... A_{s+1} B_s for s <= t, else 0
    blk = B[1]
    for r in (2, 3):
        blk = A[r] @ blk
    np.testing.assert_allclose(got[3][:, nu: 2 * nu], blk, rtol=1e-12)
    np.testing.assert_array_equal(got[1][:, 2 * nu:], 0.0)


def test_condense_matches_jax():
    H, nx, nu = 12, 6, 3
    rng = np.random.default_rng(1)
    F = rng.standard_normal((H, nx, H * nu))
    lx = rng.standard_normal((H, nx))
    R = rng.standard_normal((H, nx, nx))
    lxx = np.einsum("hij,hkj->hik", R, R)
    got = sqp.condense(*(torch.as_tensor(x) for x in (F, lx, lxx)))
    want = jsqp.condense(*(jnp.asarray(x) for x in (F, lx, lxx)))
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), 1e-12)
    lu = rng.standard_normal((H, nu))
    luu = rng.standard_normal((H, nu, nu))
    got = sqp._add_control_blocks(*got, torch.as_tensor(lu),
                                  torch.as_tensor(luu))
    want = jsqp._add_control_blocks(*want, jnp.asarray(lu), jnp.asarray(luu))
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), 1e-12)


def test_admm_box_qp_matches_jax():
    """The KKT case of tests/test_sqp.py (inputs from a numpy seed): the
    port's iterate equals JAX's at 1e-10 and satisfies the box KKT
    conditions."""
    n = 24
    rng = np.random.default_rng(2)
    R = rng.standard_normal((n, n))
    Hqp = R @ R.T + 0.5 * np.eye(n)
    g = 3.0 * rng.standard_normal(n)
    lo, hi = -0.4 * np.ones(n), 0.4 * np.ones(n)
    x = sqp.admm_box_qp(*(torch.as_tensor(v) for v in (Hqp, g, lo, hi)),
                        iterations=400).numpy()
    want = np.asarray(jsqp.admm_box_qp(
        *(jnp.asarray(v) for v in (Hqp, g, lo, hi)), iterations=400))
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-10)
    grad = Hqp @ x + g
    interior = (x > lo + 1e-9) & (x < hi - 1e-9)
    assert np.abs(grad[interior]).max() < 1e-5
    assert (grad[x <= lo + 1e-9] >= -1e-5).all()
    assert (grad[x >= hi - 1e-9] <= 1e-5).all()
    assert (x >= lo).all() and (x <= hi).all()
    assert interior.any() and (~interior).any()  # the box binds somewhere


def _jstep(budget):
    def step_fn(s, u):
        return jengine.control_step(JM, s, u, 1, max_contacts=8,
                                    solver_iterations=budget)
    return step_fn


@functools.lru_cache(maxsize=None)
def _jax_fd():
    return jax.jit(lambda s0, s, u: jilqr.fd_linearize(
        JM, _jstep(STEP_KW["solver_iterations"]), s0, s, u, FD_EPS))


@pytest.mark.parametrize("kind", ["airborne", "contact"])
def test_fd_linearize_matches_jax(kind):
    """All H x 2 x (nx + nu) perturbed steps in one engine batch, against
    JAX's vmap of them, 1e-8 relative to max|A|."""
    us, states = trajectory(kind)
    want = _jax_fd()(jstate(kind), to_jax_states(states), jnp.asarray(us))
    got = ilqr.fd_linearize(
        TM, lambda s, u: engine.control_step(TM, s, u, 1, **STEP_KW),
        tstate(kind), to_torch_states(states), torch.as_tensor(us), FD_EPS)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g.numpy(), np.asarray(w), 1e-8)
    if kind == "contact":
        ncon = engine.forward(TM, tstate(kind), torch.as_tensor(HOLD),
                              max_contacts=8).ncon_active
        assert int(ncon) >= 8


def test_ad_linearize_at_the_models_newton_budget():
    """R2: with ``solver_iterations=None`` (the model's budget, 100
    passes, where the Newton loop reads its ``done`` flags back to stop
    early) ``ad_linearize`` runs: the horizon and the Jacobian's rows are
    the engine's own batch dims and nothing is vmapped, so the primal is
    never a batched tensor. It matches JAX at 1e-8 relative."""
    kind = "contact"
    us, states = trajectory(kind)
    want = jax.jit(lambda s0, s, u: jilqr.ad_linearize(
        JM, _jstep(None), s0, s, u))(jstate(kind), to_jax_states(states),
                                     jnp.asarray(us))
    got = ilqr.ad_linearize(
        TM, lambda s, u: engine.control_step(TM, s, u, 1, max_contacts=8),
        tstate(kind), to_torch_states(states), torch.as_tensor(us))
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), 1e-8)


@functools.lru_cache(maxsize=None)
def _solve():
    """The port's SQP at the JAX test's configuration (the snapshot
    script's case), from the reset state under the bad guess."""
    case = snapshot_script()
    m = tspec.get_mpc_plant_model()
    rcfg = rollout.RolloutConfig(**case.SOLVE_ROLLOUT)
    cfg = sqp.SQPConfig(rollout=rcfg, **case.SQP)
    cmd = commands.make(torch.tensor([case.SPEED, 0.0], dtype=F64),
                        torch.tensor(0.0, dtype=F64))
    us0 = torch.as_tensor(np.tile(case.BAD_GUESS, (rcfg.horizon, 1)))
    st = engine.make_state(m, dtype=F64, device="cpu")
    return m, sqp.solve(m, cfg, rollout.make_cost_fn(m), st, us0, cmd,
                        torch.as_tensor(case.HOLD))


def test_sqp_solve_matches_jax_snapshot():
    _, res = _solve()
    ref = refs()
    close(res.cost_history.numpy(), ref["sqp_cost_history"], 1e-7)
    close(res.cost.numpy(), ref["sqp_cost"], 1e-7)
    close(res.initial_cost.numpy(), ref["sqp_initial_cost"], 1e-7)
    np.testing.assert_allclose(res.ctrl_seq.numpy(), ref["sqp_ctrl_seq"],
                               rtol=0, atol=1e-7)


def test_sqp_reduces_cost():
    m, res = _solve()
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < float(res.initial_cost) - 1.0
    hist = np.concatenate([[float(res.initial_cost)],
                           res.cost_history.numpy()])
    assert (np.diff(hist) <= 1e-9).all(), hist
    u = res.ctrl_seq.numpy()
    assert (u >= m.actuator_ctrlrange[:, 0]).all()
    assert (u <= m.actuator_ctrlrange[:, 1]).all()


def test_sharded_condensation_is_not_ported():
    """The sharded condensation runs: at one rank (a group of this process
    alone) it equals the unsharded one in every bit, and an ``axis_name``
    without the mesh that holds it raises. ``SQPConfig``'s defaults are
    the JAX package's."""
    F, lx, lxx = (torch.as_tensor(x) for x in W.condense_case(5))
    with pytest.raises(ValueError, match="needs the mesh"):
        sqp.condense(F, lx, lxx, axis_name="horizon")
    with group_scope():
        mesh = parallel.make_mesh(("horizon",), device="cpu")
        got = sqp._condense_sharded(F, lx, lxx, mesh, "horizon")
    for g, w in zip(got, sqp.condense(F, lx, lxx)):
        assert torch.equal(g, w)
    assert sqp.SQPConfig() == sqp.SQPConfig(
        **{k: getattr(jsqp.SQPConfig(), k) for k in (
            "iterations", "linearize", "fd_eps", "reg", "qp_iterations",
            "alphas")})


# horizons of the sharded condensation: one the ranks divide, one padded
SHARD_HORIZONS = (8, 5)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"sqp{world}")
    return world, W.run(W.sqp_body, world, tmp, SHARD_HORIZONS, True)


def _jax_sharded_condense(F, lx, lxx, world):
    """JAX's condensation under ``shard_map`` over ``world`` virtual CPU
    devices, H zero-padded to a multiple of them (jax sqp.py:213-227)."""
    from jax.sharding import PartitionSpec as P

    mesh = jparallel.make_mesh(jax.devices("cpu")[:world],
                               axis_names=("horizon",))
    pad = (-F.shape[0]) % world
    args = [jnp.pad(jnp.asarray(x), ((0, pad),) + ((0, 0),) * (x.ndim - 1))
            for x in (F, lx, lxx)]
    fn = jax.shard_map(
        lambda f, a, b: jsqp.condense(f, a, b, axis_name="horizon"),
        mesh=mesh, in_specs=(P("horizon"),) * 3, out_specs=(P(), P()))
    return fn(*args)


@pytest.mark.parametrize("H", SHARD_HORIZONS, ids=["divisible", "padded"])
def test_sharded_condense_matches_jax(sharded, H):
    world, outs = sharded
    F, lx, lxx = W.condense_case(H)
    want = _jax_sharded_condense(F, lx, lxx, world)
    for o in outs:
        assert o[H][0].shape == (H * 3, H * 3) and o[H][1].shape == (H * 3,)
        for g, w in zip(o[H], want):
            close(g.numpy(), np.asarray(w), 1e-12)
        for g, w in zip(o[H], outs[0][H]):
            assert torch.equal(g, w)


@functools.lru_cache(maxsize=None)
def _unsharded_solve():
    return sqp.solve(*W.sqp_problem())


def test_sharded_solve_matches_unsharded(sharded):
    """``solve(mesh=)`` over the ranks (H=3: over 4 ranks one condenses a
    zero block): the condensation cut over them, the rest replicated;
    equal to the unsharded solve (1e-10) and the same in every bit on
    every rank."""
    world, outs = sharded
    want = _unsharded_solve()
    assert float(want.cost) < float(want.initial_cost)
    for o in outs:
        for f, g, w in zip(sqp.SQPResult._fields, o["solve"], want):
            close(g.numpy(), w.numpy(), 1e-10)
        for g, w in zip(o["solve"], outs[0]["solve"]):
            assert torch.equal(g, w)


@pytest.mark.slow
def test_snapshot_matches_live_jax():
    """``tests/torch_gradient_refs.npz`` is what the JAX package computes
    now (each jitted solve compiles for ~3 minutes)."""
    live = snapshot_script().jax_results()
    ref = refs()
    assert set(live) == set(ref)
    for k, v in live.items():
        close(v, ref[k], 1e-12, atol_scale=1.0 + np.abs(ref[k]).max())
