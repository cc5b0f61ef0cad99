"""The oracle-engine paths of the solvers and the closed loops against the
JAX package, float64 on the CPU.

Two jitted JAX functions carry the comparisons (the oracle engine reaches
no Pallas kernel, so ``jax.jit`` is safe): ``batched_rollout_cost`` on
(4, 3, 12) sequences of the planning model, and one plant
``engine.control_step`` of the closed loops' budget on the ``mpc_plant``
model. The two frameworks draw different noise from a seed, so MPPI and
CEM get the standard normals JAX drew (``torch.randn`` is replaced for
the call) and JAX's ``plan`` gets the costs the jitted function gave for
the same sequences. The closed loops are driven on the port alone, and
the plant is then held to JAX under the controls the port applied.

Rollouts start from a MOVING state on the floor: from rest the stage
cost's direction v/|v| is ill-conditioned."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.solvers import cem as jcem
from quadruped_gym_tpu.solvers import mppi as jmppi
from quadruped_gym_tpu.solvers import rollout as jrollout
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics import engine
from quadruped_gym_tpu_torch.runtime import mpc_runtime as trt
from quadruped_gym_tpu_torch.solvers import cem as tcem
from quadruped_gym_tpu_torch.solvers import mppi as tmppi
from quadruped_gym_tpu_torch.solvers import rollout as trollout

CENTERS = np.array([0.0, 0.0, -0.5] * 4)
S, H = 4, 3
RKW = dict(horizon=H, frame_skip=2, max_contacts=8, solver_iterations=3)
JM, TM = jspec.get_planning_model(), tspec.get_planning_model()
JCMD = jcommands.make(jnp.asarray([0.2, 0.1]), jnp.asarray(0.3))
TCMD = convert.command(JCMD, device="cpu")
F64 = torch.float64


@functools.lru_cache(maxsize=None)
def _on_the_floor():
    """The robot on its feet and moving: the reset state (which hangs
    10 cm up) dropped for 0.4 s on the port's engine, then a velocity
    perturbation from a seed."""
    m = tspec.get_mpc_plant_model()
    st = engine.make_state(m, dtype=F64, device="cpu")
    st = engine.control_step(m, st, torch.as_tensor(CENTERS), 200,
                             max_contacts=8, solver_iterations=4)
    qvel = st.qvel.numpy() + 0.1 * np.random.default_rng(0).standard_normal(
        m.nv)
    return jengine.State(qpos=jnp.asarray(st.qpos.numpy()),
                         qvel=jnp.asarray(qvel),
                         act=jnp.asarray(st.act.numpy()),
                         time=jnp.asarray(0.0),
                         sensordata=jnp.asarray(st.sensordata.numpy()))


@functools.lru_cache(maxsize=None)
def _jax_costs_fn():
    cfg = jrollout.RolloutConfig(**RKW)
    cost = jrollout.make_cost_fn(JM)
    return jax.jit(lambda st, seqs, prev: jrollout.batched_rollout_cost(
        JM, cfg, cost, st, seqs, JCMD, prev))


def _jax_costs(seqs, prev=CENTERS):
    return np.asarray(_jax_costs_fn()(_on_the_floor(), jnp.asarray(seqs),
                                      jnp.asarray(prev)))


def _tstart():
    return convert.state(_on_the_floor(), device="cpu")


def _seqs(seed):
    rng = np.random.default_rng(seed)
    return np.clip(CENTERS + 0.3 * rng.standard_normal((S, H, 12)), -1, 1)


def test_start_state_is_on_the_floor_and_moving():
    st = _tstart()
    fwd = engine.forward(tspec.get_planning_model(), st,
                         torch.as_tensor(CENTERS), max_contacts=8)
    assert int(fwd.ncon_active) >= 8  # two feet or more: 4 rows a contact
    assert 0.05 < float(st.qpos[2]) < 0.2
    assert float(st.qvel.abs().max()) > 0.05


@pytest.mark.parametrize("seed", [1, 2])
def test_batched_rollout_cost_matches_jax(seed):
    seqs = _seqs(seed)
    want = _jax_costs(seqs)
    got = trollout.batched_rollout_cost(
        TM, trollout.RolloutConfig(**RKW), trollout.make_cost_fn(TM),
        _tstart(), torch.as_tensor(seqs), TCMD, torch.as_tensor(CENTERS))
    assert got.shape == (S,) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8)
    assert len(set(np.round(want, 6))) == S  # the sequences matter


def test_rollout_cost_is_one_row_of_the_batch():
    seqs = _seqs(1)
    want = _jax_costs(seqs)
    cfg, cost = trollout.RolloutConfig(**RKW), trollout.make_cost_fn(TM)
    for s in (0, 3):
        one = trollout.rollout_cost(TM, cfg, cost, _tstart(),
                                    torch.as_tensor(seqs[s]), TCMD,
                                    torch.as_tensor(CENTERS))
        assert one.shape == ()
        np.testing.assert_allclose(one.item(), want[s], rtol=1e-8, atol=1e-8)


def test_rollout_config_budgets_are_read():
    """``max_contacts`` and ``solver_iterations`` reach the engine: one
    Newton pass scores differently from three."""
    assert trollout.RolloutConfig().max_contacts == \
        jrollout.RolloutConfig().max_contacts == 12
    assert trollout.RolloutConfig().solver_iterations == \
        jrollout.RolloutConfig().solver_iterations == 8
    seqs, cost = torch.as_tensor(_seqs(1)), trollout.make_cost_fn(TM)
    args = (cost, _tstart(), seqs, TCMD, torch.as_tensor(CENTERS))
    base = trollout.batched_rollout_cost(
        TM, trollout.RolloutConfig(**RKW), *args)
    one_pass = trollout.batched_rollout_cost(
        TM, trollout.RolloutConfig(**dict(RKW, solver_iterations=1)), *args)
    one_contact = trollout.batched_rollout_cost(
        TM, trollout.RolloutConfig(**dict(RKW, max_contacts=1)), *args)
    assert float((base - one_pass).abs().max()) > 1e-6
    assert float((base - one_contact).abs().max()) > 1e-6


def _inject(monkeypatch, draws):
    """Make ``torch.randn`` hand out the standard normals JAX drew."""
    draws = iter(draws)

    def randn(shape, generator=None, dtype=None, device=None):
        z = torch.as_tensor(np.array(next(draws)), dtype=dtype, device=device)
        assert tuple(z.shape) == tuple(shape)
        return z

    monkeypatch.setattr(torch, "randn", randn)


def test_mppi_oracle_path_matches_jax(monkeypatch):
    kw = dict(num_samples=S, sigma=0.3, temperature=0.7, iterations=1,
              lane=False)
    jcfg = jmppi.MPPIConfig(rollout=jrollout.RolloutConfig(**RKW), **kw)
    tcfg = tmppi.MPPIConfig(rollout=trollout.RolloutConfig(**RKW), **kw)
    mean0 = np.tile(CENTERS, (H, 1)) + 0.05
    key = jax.random.PRNGKey(3)
    (k,) = jax.random.split(key, 1)
    z = jax.random.normal(k, (S, H, 12), jnp.float64)
    lo, hi = jmppi._ctrl_bounds(JM, jnp.float64)
    seqs = jnp.clip(jnp.asarray(mean0)[None] + jcfg.sigma * z, lo, hi)
    costs = jnp.asarray(_jax_costs(np.asarray(seqs)))
    with monkeypatch.context() as mp:
        # JAX's own plan, its scoring answered by the jitted JAX rollouts
        mp.setattr(jmppi, "_rollout_costs", lambda *a: costs)
        want = jmppi.plan(JM, jcfg, None, None, jnp.asarray(mean0), None,
                          None, key)
    _inject(monkeypatch, [z])
    got = tmppi.plan(TM, tcfg, trollout.make_cost_fn(TM), _tstart(),
                     torch.as_tensor(mean0), TCMD, torch.as_tensor(CENTERS),
                     torch.Generator())
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-8, atol=1e-8)
    for f in ("best_cost", "mean_cost", "weights_entropy"):
        np.testing.assert_allclose(getattr(got, f).item(),
                                   float(getattr(want, f)), rtol=1e-7,
                                   err_msg=f)


def test_cem_oracle_path_matches_jax(monkeypatch):
    kw = dict(num_samples=S, num_elites=2, iterations=1, init_sigma=0.3,
              lane=False)
    jcfg = jcem.CEMConfig(rollout=jrollout.RolloutConfig(**RKW), **kw)
    tcfg = tcem.CEMConfig(rollout=trollout.RolloutConfig(**RKW), **kw)
    mean0 = np.tile(CENTERS, (H, 1)) - 0.05
    key = jax.random.PRNGKey(4)
    (k,) = jax.random.split(key, 1)
    z = jax.random.normal(k, (S, H, 12), jnp.float64)
    lo, hi = jmppi._ctrl_bounds(JM, jnp.float64)
    seqs = jnp.clip(jnp.asarray(mean0)[None] + 0.3 * z, lo, hi)
    costs = jnp.asarray(_jax_costs(np.asarray(seqs)))
    with monkeypatch.context() as mp:
        mp.setattr(jcem.rollout_mod, "batched_rollout_cost",
                   lambda *a: costs)
        want = jcem.plan(JM, jcfg, None, None, jnp.asarray(mean0), None,
                         None, key)
    _inject(monkeypatch, [z])
    got = tcem.plan(TM, tcfg, trollout.make_cost_fn(TM), _tstart(),
                    torch.as_tensor(mean0), TCMD, torch.as_tensor(CENTERS),
                    torch.Generator())
    for f in ("mean", "sigma"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_allclose(got.best_cost.item(), float(want.best_cost),
                               rtol=1e-8)
    np.testing.assert_allclose(got.mean_cost.item(), float(want.mean_cost),
                               rtol=1e-8)


# --------------------------------------------------------------------------
# the closed loops (sizes of tests/test_solvers.py's runtime tests)

PLANT_KW = dict(plant_frame_skip=2, plant_max_contacts=8,
                plant_solver_iterations=3)
LOOP_H = 5


def _mpc(lane, samples=8, impl="fused"):
    return trt.MPCConfig(solver="mppi", mppi=tmppi.MPPIConfig(
        num_samples=samples, lane=lane, lane_engine_impl=impl,
        lane_newton_iterations=2, lane_ls_iterations=4,
        rollout=trollout.RolloutConfig(horizon=LOOP_H, frame_skip=2,
                                       max_contacts=8,
                                       solver_iterations=3)), **PLANT_KW)


@functools.lru_cache(maxsize=None)
def _jax_plant_step():
    plant = jspec.get_model(
        collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES)
    return jax.jit(lambda st, ctrl: jengine.control_step(
        plant, st, ctrl, 2, max_contacts=8, solver_iterations=3))


def _assert_plant_parity(ctrls, sens):
    """The JAX plant under the controls the port's loop applied."""
    st = _on_the_floor()
    for t in range(ctrls.shape[0]):
        st = _jax_plant_step()(st, jnp.asarray(ctrls[t].numpy()))
        np.testing.assert_allclose(sens[t].numpy(), np.asarray(st.sensordata),
                                   rtol=1e-8, atol=1e-8, err_msg=f"step {t}")


def _run(loop, lane, n_steps=3, seed=0, **kw):
    cfg = _mpc(lane)
    carry = trt.init_carry(TM, cfg, LOOP_H, seed=seed, dtype=F64,
                           device="cpu")
    return loop(TM, cfg, trollout.make_cost_fn(TM), carry, _tstart(), TCMD,
                n_steps, plant_model=tspec.get_mpc_plant_model(), **kw)


@pytest.mark.parametrize("lane", [False, True])
def test_closed_loop(lane):
    carry, phys, (ctrls, sens, costs) = _run(trt.closed_loop, lane)
    assert ctrls.shape == (3, 12) and sens.shape == (3, 33)
    assert costs.shape == (3,) and ctrls.dtype == F64
    assert all(bool(torch.isfinite(x).all()) for x in (ctrls, sens, costs))
    assert bool(phys.qpos[2] > 0.03)  # not fallen through the floor
    assert carry.mean.shape == (LOOP_H, 12)
    torch.testing.assert_close(carry.prev_ctrl, ctrls[-1], rtol=0, atol=0)
    torch.testing.assert_close(phys.sensordata, sens[-1], rtol=0, atol=0)
    np.testing.assert_allclose(phys.time.item(), 3 * 2 * TM.timestep,
                               rtol=1e-12)
    _assert_plant_parity(ctrls, sens)


@pytest.mark.parametrize("lane,plant_engine", [(False, "aos"),
                                               (True, "lane")])
def test_delayed_closed_loop(lane, plant_engine):
    carry, phys, (ctrls, sens, costs) = _run(
        trt.delayed_closed_loop, lane, plant_engine=plant_engine)
    assert ctrls.shape == (3, 12) and sens.shape == (3, 33)
    # step 0 applies the held standing control (the solve is in flight)
    np.testing.assert_allclose(ctrls[0].numpy(), CENTERS, atol=1e-6)
    assert float((ctrls[1] - ctrls[0]).abs().max()) > 1e-3
    assert all(bool(torch.isfinite(x).all()) for x in (ctrls, sens, costs))
    assert bool(phys.qpos[2] > 0.03)
    if plant_engine == "aos":
        _assert_plant_parity(ctrls, sens)


def test_delayed_loop_predictors():
    """``"auto"`` is ``"lane"`` when the planner scores through a lane
    engine and ``"aos"`` when it does not; the two predictors agree to
    1e-3 on what the loop applies and reads."""
    runs = {p: _run(trt.delayed_closed_loop, True, n_steps=2, predictor=p)
            for p in ("auto", "lane", "aos")}
    for a, b in zip(runs["auto"][2], runs["lane"][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b, name in zip(runs["lane"][2], runs["aos"][2],
                          ("ctrl", "sensordata", "best_cost")):
        if name == "best_cost":
            continue  # a minimum over 8 samples: not smooth in the state
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    assert float((runs["lane"][2][1] - runs["aos"][2][1]).abs().max()) > 0.0
    oracle = {p: _run(trt.delayed_closed_loop, False, n_steps=2, predictor=p)
              for p in ("auto", "aos")}
    for a, b in zip(oracle["auto"][2], oracle["aos"][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loops_refuse_unknown_engines():
    full = tspec.get_full_model()
    cfg = _mpc(False)
    carry = trt.init_carry(TM, cfg, LOOP_H, seed=0, dtype=F64, device="cpu")
    args = (TM, cfg, trollout.make_cost_fn(TM), carry, _tstart(), TCMD, 1)
    with pytest.raises(ValueError, match="unknown predictor"):
        trt.delayed_closed_loop(*args, predictor="xla")
    with pytest.raises(ValueError, match="unknown plant_engine"):
        trt.delayed_closed_loop(*args, plant_engine="xla")
    with pytest.raises(ValueError, match="leg-compatible plant"):
        trt.delayed_closed_loop(*args, plant_model=full, plant_engine="lane")
    assert trt.MPCConfig().plant_max_contacts == 24
    assert trt.MPCConfig().plant_solver_iterations is None
    if not torch.cuda.is_available():  # the card unless the caller says cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.init_carry(TM, cfg, LOOP_H, seed=0)
