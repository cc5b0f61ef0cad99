"""The port's oracle physics engine against the JAX package, function by
function, float64 on the CPU.

For each model (the ``full``, ``mpc_plant`` and ``planning`` snapshots) ONE
jitted JAX function evaluates the whole pipeline on a state and returns
every intermediate (the oracle engine reaches no Pallas kernel, so
``jax.jit`` is safe and far quicker than eager dispatch). Each function of
the port is then fed the JAX package's own intermediates as inputs,
carried across as numpy, and held to the JAX output at rtol = atol =
1e-10; ``engine.step`` at 1e-9 and a 25-substep ``control_step``
trajectory at 1e-6. The three states: airborne and moving, standing at
rest on its four feet, and a random pose pressed into the floor (contacts
of different depth); on the floor more slots are active than the budget
``MAXC`` keeps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.physics import collision as jcollision
from quadruped_gym_tpu.physics import constraints as jconstraints
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.physics import integrator as jintegrator
from quadruped_gym_tpu.physics import maths as jmaths
from quadruped_gym_tpu.physics import sensors as jsensors
from quadruped_gym_tpu.physics import smooth as jsmooth
from quadruped_gym_tpu.physics import solver as jsolver
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics import (collision, constraints, engine,
                                             integrator, maths, sensors,
                                             smooth, solver)

MODELS = ("full", "mpc_plant", "planning")
STATES = ("airborne", "standing", "contact")
MAXC = 3  # contact budget: below the active slots on the floor (4-5)
TOL = 1e-10
F64 = torch.float64

both = pytest.mark.parametrize("kind", STATES)
models = pytest.mark.parametrize("name", MODELS)


@functools.lru_cache(maxsize=None)
def _jmodel(name):
    return {
        "full": jspec.get_model,
        "mpc_plant": lambda: jspec.get_model(
            collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES),
        "planning": jspec.get_planning_model,
    }[name]()


def _tmodel(name):
    return getattr(tspec, f"get_{name}_model")()


@functools.lru_cache(maxsize=None)
def _settled():
    """(qpos, qvel, act) of the robot standing on its feet: 300 MuJoCo
    steps under the standing control from the reset state, which hangs
    10 cm above the floor."""
    import mujoco

    from quadruped_gym_tpu.testing import load_mj

    mj, d = load_mj()
    mujoco.mj_resetData(mj, d)
    d.qpos[:] = mj.qpos0
    d.ctrl[:] = np.array([0, 0, -0.5] * 4)
    for _ in range(300):
        mujoco.mj_step(mj, d)
    return d.qpos.copy(), d.qvel.copy(), d.act.copy()


def _inputs(jm, kind, seed=0):
    """(qpos, qvel, act, ctrl) as numpy, made from a seed."""
    rng = np.random.default_rng([seed, STATES.index(kind)])
    qpos, qvel, act = (x.copy() for x in _settled())
    if kind == "airborne":
        qpos[:3] += [0.3, -0.2, 0.5]
        quat = rng.standard_normal(4)
        qpos[3:7] = quat / np.linalg.norm(quat)
        qpos[7:] += 0.2 * rng.standard_normal(jm.nq - 7)
        qvel = 0.5 * rng.standard_normal(jm.nv)
        act = rng.uniform(-1, 1, jm.na)
    elif kind == "contact":
        qpos[7:] += 0.1 * rng.standard_normal(jm.nq - 7)
        qpos[2] -= 0.03
        quat = qpos[3:7] + 0.03 * rng.standard_normal(4)
        qpos[3:7] = quat / np.linalg.norm(quat)
        qvel = 0.3 * rng.standard_normal(jm.nv)
        act = rng.uniform(-1, 1, jm.na)
    ctrl = rng.uniform(-1.2, 1.2, jm.nu)  # partly outside ctrlrange
    return qpos, qvel, act, ctrl


@functools.lru_cache(maxsize=None)
def _probe_fn(name):
    jm = _jmodel(name)

    def probe(st, ctrl):
        qpos, qvel, act = st.qpos, st.qvel, st.act
        h = jm.timestep
        kin = jsmooth.fwd_position(jm, qpos)
        S = jsmooth.dof_subspace(jm, kin)
        cvel = jsmooth.body_velocities(jm, S, qvel)
        M = jsmooth.crba(jm, kin, S)
        bias = jsmooth.rne_bias(jm, kin, S, cvel, qvel)
        actu = jsmooth.actuation(jm, qpos, qvel, act)
        qfrc_smooth = actu.qfrc + jsmooth.passive_force(jm, qvel) - bias
        qacc_smooth = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(M, lower=True), qfrc_smooth)
        con = jcollision.collide(jm, kin)
        efc = jconstraints.make_constraints(jm, kin, S, con, qpos, qvel,
                                            max_contacts=MAXC)
        res = jsolver.solve(jm, M, qacc_smooth, efc)
        cacc = jsmooth.body_accelerations(jm, S, cvel, qvel, res.qacc)
        sens = jsensors.evaluate(jm, kin, cvel, cacc, qpos)
        qvel_new = jintegrator.implicit_velocity_update(
            jm, M, qvel, res.qacc, actu.vel_deriv, h)
        qpos_new = jintegrator.integrate_pos(jm, qpos, qvel_new, h)
        nxt = jengine.step(jm, st, ctrl, max_contacts=MAXC)
        return dict(kin=kin, S=S, cvel=cvel, M=M, bias=bias, actu=actu,
                    qacc_smooth=qacc_smooth, con=con, efc=efc, res=res,
                    cacc=cacc, sens=sens, qvel_new=qvel_new,
                    qpos_new=qpos_new, nxt=nxt,
                    passive=jsmooth.passive_force(jm, qvel),
                    act_new=jsmooth.act_filter_exact(
                        jm, act, jsmooth.clip_ctrl(jm, ctrl), h))

    return jax.jit(probe)


def _jstate(jm, qpos, qvel, act):
    return jengine.State(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                         act=jnp.asarray(act), time=jnp.asarray(0.25),
                         sensordata=jnp.zeros(jm.nsensordata))


@functools.lru_cache(maxsize=None)
def _probe(name, kind):
    """The JAX pipeline's intermediates on one state, as numpy leaves."""
    jm = _jmodel(name)
    qpos, qvel, act, ctrl = _inputs(jm, kind)
    out = _probe_fn(name)(_jstate(jm, qpos, qvel, act), jnp.asarray(ctrl))
    return jax.tree.map(np.asarray, out)


def _t(x):
    a = np.array(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64))
    return torch.as_tensor(a.astype(np.float64))


def _as(cls, src):
    """The port's NamedTuple ``cls`` from the JAX package's value."""
    return cls(**{f: _t(getattr(src, f)) for f in cls._fields})


def _tstate(name, kind):
    qpos, qvel, act, ctrl = _inputs(_jmodel(name), kind)
    st = engine.State(qpos=_t(qpos), qvel=_t(qvel), act=_t(act),
                      time=_t(0.25),
                      sensordata=torch.zeros(33, dtype=F64))
    return st, _t(ctrl)


def _close(got, want, tol=TOL, msg=""):
    assert got.dtype in (F64, torch.bool, torch.int64), (msg, got.dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _close_fields(got, want, tol=TOL):
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f)
        else:
            _close(g, w, tol, f)


# --------------------------------------------------------------------------
# function by function


@models
@both
def test_fwd_position(name, kind):
    p = _probe(name, kind)
    st, _ = _tstate(name, kind)
    _close_fields(smooth.fwd_position(_tmodel(name), st.qpos), p["kin"])


@models
@both
def test_dof_subspace(name, kind):
    p = _probe(name, kind)
    kin = _as(smooth.Kin, p["kin"])
    _close(smooth.dof_subspace(_tmodel(name), kin), p["S"])


@models
@both
def test_body_velocities_and_crba(name, kind):
    p = _probe(name, kind)
    tm = _tmodel(name)
    st, _ = _tstate(name, kind)
    kin, S = _as(smooth.Kin, p["kin"]), _t(p["S"])
    _close(smooth.body_velocities(tm, S, st.qvel), p["cvel"])
    _close(smooth.crba(tm, kin, S), p["M"])


@models
@both
def test_rne_bias(name, kind):
    p = _probe(name, kind)
    st, _ = _tstate(name, kind)
    got = smooth.rne_bias(_tmodel(name), _as(smooth.Kin, p["kin"]),
                          _t(p["S"]), _t(p["cvel"]), st.qvel)
    _close(got, p["bias"])


@models
@both
def test_actuation(name, kind):
    p = _probe(name, kind)
    tm = _tmodel(name)
    st, ctrl = _tstate(name, kind)
    _close_fields(smooth.actuation(tm, st.qpos, st.qvel, st.act), p["actu"])
    _close(smooth.passive_force(tm, st.qvel), p["passive"])
    _close(smooth.act_filter_exact(tm, st.act, smooth.clip_ctrl(tm, ctrl),
                                   tm.timestep), p["act_new"])
    assert float(smooth.clip_ctrl(tm, ctrl).abs().max()) <= 1.0


@models
@both
def test_collide(name, kind):
    p = _probe(name, kind)
    con = collision.collide(_tmodel(name), _as(smooth.Kin, p["kin"]))
    _close_fields(con, p["con"])
    n_active = int(con.active.sum())
    if kind == "airborne":
        assert n_active == 0
    else:
        assert n_active > MAXC  # the budget cuts some off


@models
@both
def test_make_constraints(name, kind):
    """Every row (so also which slots were chosen and in what order) and
    the slot order itself, against ``jax.lax.top_k``."""
    p = _probe(name, kind)
    tm = _tmodel(name)
    st, _ = _tstate(name, kind)
    con = _as(collision.Contacts, p["con"])
    efc = constraints.make_constraints(
        tm, _as(smooth.Kin, p["kin"]), _t(p["S"]), con, st.qpos, st.qvel,
        max_contacts=MAXC)
    _close_fields(efc, p["efc"])
    nlim = sum(tm.jnt_limited)
    assert efc.J.shape == (nlim + 4 * MAXC, tm.nv)
    # the chosen slots, in order: the deepest first, ties by lower index
    score = jnp.where(p["con"].active, -p["con"].dist, -jnp.inf)
    _, want_idx = jax.lax.top_k(score, MAXC)
    tscore = torch.where(con.active, -con.dist, -torch.inf)
    got_idx = torch.sort(tscore, descending=True, stable=True)[1][:MAXC]
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(efc.pos[nlim::4].numpy(),
                                  con.dist[got_idx].numpy())


@models
@both
def test_solve(name, kind):
    p = _probe(name, kind)
    res = solver.solve(_tmodel(name), _t(p["M"]), _t(p["qacc_smooth"]),
                       _as(constraints.ConstraintSet, p["efc"]))
    _close(res.qacc, p["res"].qacc)
    _close(res.qfrc_constraint, p["res"].qfrc_constraint)
    _close(res.efc_force, p["res"].efc_force)
    assert res.niter.dtype == torch.int64
    assert int(res.niter) == int(p["res"].niter)
    assert (int(res.niter) == 0) == (kind == "airborne")


@models
@both
def test_implicit_velocity_update(name, kind):
    p = _probe(name, kind)
    tm = _tmodel(name)
    st, _ = _tstate(name, kind)
    got = integrator.implicit_velocity_update(
        tm, _t(p["M"]), st.qvel, _t(p["res"].qacc), _t(p["actu"].vel_deriv),
        tm.timestep)
    _close(got, p["qvel_new"])


@models
@both
def test_integrate_pos(name, kind):
    p = _probe(name, kind)
    tm = _tmodel(name)
    st, _ = _tstate(name, kind)
    got = integrator.integrate_pos(tm, st.qpos, _t(p["qvel_new"]),
                                   tm.timestep)
    _close(got, p["qpos_new"])
    np.testing.assert_allclose(float(torch.linalg.vector_norm(got[3:7])), 1.0,
                               rtol=1e-15)


@models
@both
def test_sensors_evaluate(name, kind):
    p = _probe(name, kind)
    tm = _tmodel(name)
    st, _ = _tstate(name, kind)
    cacc = smooth.body_accelerations(tm, _t(p["S"]), _t(p["cvel"]), st.qvel,
                                     _t(p["res"].qacc))
    _close(cacc, p["cacc"])
    got = sensors.evaluate(tm, _as(smooth.Kin, p["kin"]), _t(p["cvel"]),
                           _t(p["cacc"]), st.qpos)
    assert got.shape == (tm.nsensordata,)
    _close(got, p["sens"])


@models
@both
def test_engine_step(name, kind):
    p = _probe(name, kind)
    st, ctrl = _tstate(name, kind)
    got = engine.step(_tmodel(name), st, ctrl, max_contacts=MAXC)
    _close_fields(got, p["nxt"], tol=1e-9)
    fwd = engine.forward(_tmodel(name), st, ctrl, max_contacts=MAXC)
    _close(fwd.qacc, p["res"].qacc, 1e-9)
    assert int(fwd.ncon_active) == int(p["efc"].active.sum())


# --------------------------------------------------------------------------
# trajectories, batches and the solver's corners


def test_control_step_trajectory():
    """25 substeps under one control from the in-contact state."""
    jm, tm = _jmodel("mpc_plant"), _tmodel("mpc_plant")
    qpos, qvel, act, ctrl = _inputs(jm, "contact", seed=3)
    want = jax.jit(lambda s, c: jengine.control_step(
        jm, s, c, 25, max_contacts=12, solver_iterations=4))(
            _jstate(jm, qpos, qvel, act), jnp.asarray(ctrl))
    st = engine.State(qpos=_t(qpos), qvel=_t(qvel), act=_t(act),
                      time=_t(0.25), sensordata=torch.zeros(33, dtype=F64))
    got = engine.control_step(tm, st, _t(ctrl), 25, max_contacts=12,
                              solver_iterations=4)
    _close_fields(got, want, tol=1e-6)
    np.testing.assert_allclose(got.time.item(), 0.25 + 25 * tm.timestep,
                               rtol=1e-12)


def _batch(name, seeds=(0, 1)):
    """Five states: airborne, standing and in contact, stacked."""
    jm = _jmodel(name)
    rows = [_inputs(jm, k, seed=s) for k, s in (
        ("airborne", seeds[0]), ("standing", 0), ("contact", seeds[0]),
        ("contact", seeds[1]), ("airborne", seeds[1]))]
    qpos, qvel, act, ctrl = (_t(np.stack(c)) for c in zip(*rows))
    st = engine.State(qpos=qpos, qvel=qvel, act=act,
                      time=torch.arange(5, dtype=F64) * 0.002,
                      sensordata=torch.zeros((5, 33), dtype=F64))
    return st, ctrl


@models
def test_batched_step_equals_per_sample(name):
    tm = _tmodel(name)
    st, ctrl = _batch(name)
    got = engine.control_step(tm, st, ctrl, 2, max_contacts=MAXC)
    assert got.qpos.shape == (5, tm.nq) and got.time.shape == (5,)
    for b in range(5):
        one = engine.control_step(tm, engine.State(*(x[b] for x in st)),
                                  ctrl[b], 2, max_contacts=MAXC)
        for f in got._fields:
            torch.testing.assert_close(getattr(got, f)[b], getattr(one, f),
                                       rtol=1e-12, atol=1e-12, msg=f)


def test_two_batch_dims():
    tm = _tmodel("planning")
    st, ctrl = _batch("planning")
    st6 = engine.State(*(torch.stack([x[:3], x[2:]]) for x in st))
    got = engine.step(tm, st6, torch.stack([ctrl[:3], ctrl[2:]]),
                      max_contacts=MAXC)
    flat = engine.step(tm, st, ctrl, max_contacts=MAXC)
    assert got.qpos.shape == (2, 3, tm.nq)
    torch.testing.assert_close(got.qvel[0], flat.qvel[:3], rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(got.sensordata[1], flat.sensordata[2:],
                               rtol=1e-12, atol=1e-12)


def _solver_inputs(name, kinds):
    ps = [_probe(name, k) for k in kinds]
    M = _t(np.stack([p["M"] for p in ps]))
    a = _t(np.stack([p["qacc_smooth"] for p in ps]))
    efc = constraints.ConstraintSet(**{
        f: _t(np.stack([getattr(p["efc"], f) for p in ps]))
        for f in constraints.ConstraintSet._fields})
    return ps, M, a, efc


@pytest.mark.parametrize("iterations", [100, 6])
def test_solver_done_samples_stay_frozen(iterations):
    """One sample (airborne) is done before the first pass, one converges
    in a pass or two, one takes longer: each keeps its own ``x`` and
    ``niter`` while the batch goes on, with the early exit (100 passes
    allowed) and without it (6)."""
    tm = _tmodel("mpc_plant")
    kinds = ("airborne", "standing", "contact")
    ps, M, a, efc = _solver_inputs("mpc_plant", kinds)
    res = solver.solve(tm, M, a, efc, iterations=iterations)
    want_niter = [int(p["res"].niter) for p in ps]
    assert want_niter[0] == 0 and len(set(want_niter)) > 1
    assert max(want_niter) <= 6
    np.testing.assert_array_equal(res.niter.numpy(), want_niter)
    torch.testing.assert_close(res.qacc[0], a[0], rtol=0, atol=0)
    for b, p in enumerate(ps):
        _close(res.qacc[b], p["res"].qacc)
        one = solver.solve(
            tm, M[b], a[b],
            constraints.ConstraintSet(*(x[b] for x in efc)),
            iterations=iterations)
        torch.testing.assert_close(res.qacc[b], one.qacc, rtol=1e-12,
                                   atol=1e-12)
        assert int(one.niter) == want_niter[b]


def test_solver_iteration_budget_is_kept():
    """With a budget below what convergence needs, every sample that is
    not done has run exactly that many passes."""
    tm = _tmodel("mpc_plant")
    ps, M, a, efc = _solver_inputs("mpc_plant", ("airborne", "contact"))
    assert int(ps[1]["res"].niter) > 1
    res = solver.solve(tm, M, a, efc, iterations=1)
    np.testing.assert_array_equal(res.niter.numpy(), [0, 1])
    assert float((res.qacc[1] - _t(ps[1]["res"].qacc)).abs().max()) > 1e-6


@pytest.mark.parametrize("batched", [False, True])
def test_solver_zero_iterations(batched):
    tm = _tmodel("planning")
    ps, M, a, efc = _solver_inputs("planning", ("contact", "standing"))
    if not batched:
        M, a = M[0], a[0]
        efc = constraints.ConstraintSet(*(x[0] for x in efc))
    res = solver.solve(tm, M, a, efc, iterations=0)
    assert res.qacc is a
    assert float(res.qfrc_constraint.abs().max()) == 0.0
    assert res.efc_force.shape == efc.aref.shape
    assert float(res.efc_force.abs().max()) == 0.0
    assert res.niter.shape == a.shape[:-1] and int(res.niter.sum()) == 0
    # and through the engine: the constraint-free step
    st, ctrl = _tstate("planning", "contact")
    free = engine.forward(tm, st, ctrl, solver_iterations=0)
    _close(free.qacc, ps[0]["qacc_smooth"])


# --------------------------------------------------------------------------
# maths


def _rand(rng, *shape):
    return rng.standard_normal(shape)


@pytest.mark.parametrize("fn", [
    "quat_mul", "quat_rotate", "quat_rotate_inv", "quat_to_mat",
    "quat_integrate", "axis_angle_to_quat", "skew", "motion_cross",
    "force_cross", "spatial_inertia_world", "quat_normalize", "quat_conj"])
def test_maths_matches_jax(fn):
    rng = np.random.default_rng(5)
    q = _rand(rng, 4, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    args = {
        "quat_mul": (q, q[::-1].copy()),
        "quat_rotate": (q, _rand(rng, 4, 3)),
        "quat_rotate_inv": (q, _rand(rng, 4, 3)),
        "quat_to_mat": (q,),
        "quat_integrate": (q, _rand(rng, 4, 3), 0.002),
        "axis_angle_to_quat": (_rand(rng, 4, 3), _rand(rng, 4)),
        "skew": (_rand(rng, 4, 3),),
        "motion_cross": (_rand(rng, 4, 6), _rand(rng, 4, 6)),
        "force_cross": (_rand(rng, 4, 6), _rand(rng, 4, 6)),
        "quat_normalize": (_rand(rng, 4, 4),),
        "quat_conj": (q,),
    }
    if fn == "spatial_inertia_world":
        # the JAX function takes one body; the port's takes any batch
        mass, diag = rng.uniform(0.1, 1, 4), rng.uniform(0.01, 0.1, (4, 3))
        imat = np.asarray(jmaths.quat_to_mat(jnp.asarray(q)))
        ipos = _rand(rng, 4, 3)
        got = maths.spatial_inertia_world(_t(mass), _t(diag), _t(imat),
                                          _t(ipos))
        for b in range(4):
            want = jmaths.spatial_inertia_world(
                jnp.asarray(mass[b]), jnp.asarray(diag[b]),
                jnp.asarray(imat[b]), jnp.asarray(ipos[b]))
            _close(got[b], want, 1e-14)
        return
    want = getattr(jmaths, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args[fn]))
    got = getattr(maths, fn)(*(_t(a) if isinstance(a, np.ndarray) else a
                               for a in args[fn]))
    _close(got, want, 1e-14)


def test_quat_integrate_at_zero_rate():
    """The value at omega = 0 is the input quaternion, and the Jacobian
    there is 0.5*dt*I on the vector part, finite everywhere (both
    ``where`` guards kept)."""
    h = 0.002
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64)
    zero = torch.zeros(3, dtype=F64)
    torch.testing.assert_close(maths.quat_integrate(q, zero, h), q, rtol=0,
                               atol=0)
    jac = torch.func.jacrev(lambda w: maths.quat_integrate(q, w, h))(zero)
    want = np.zeros((4, 3))
    want[1:] = 0.5 * h * np.eye(3)
    np.testing.assert_allclose(jac.numpy(), want, rtol=0, atol=1e-18)
    jwant = jax.jacfwd(lambda w: jmaths.quat_integrate(
        jnp.asarray(q.numpy()), w, h))(jnp.zeros(3))
    np.testing.assert_allclose(jac.numpy(), np.asarray(jwant), atol=1e-18)
    # a tiny but non-zero rate takes the exact branch and agrees
    w = torch.full((3,), 1e-4, dtype=F64)
    jac = torch.func.jacrev(lambda w: maths.quat_integrate(q, w, h))(w)
    assert bool(torch.isfinite(jac).all())
    np.testing.assert_allclose(jac.numpy()[1:], 0.5 * h * np.eye(3),
                               atol=1e-9)


# --------------------------------------------------------------------------
# dtype, constants, precision


def test_float32_far_from_the_origin():
    """Float32 with the base 6 m up and 40 m out: everything is measured
    from ``kin.origin``, so the step agrees with float64 to float32
    rounding (a world-origin formulation is off by orders of magnitude)."""
    tm = _tmodel("mpc_plant")
    st, ctrl = _tstate("mpc_plant", "airborne")
    qpos = st.qpos.clone()
    qpos[:3] = torch.tensor([40.0, -30.0, 6.0], dtype=F64)
    st = st._replace(qpos=qpos)
    want = engine.step(tm, st, ctrl)
    st32 = engine.State(*(x.to(torch.float32) for x in st))
    got = engine.step(tm, st32, ctrl.to(torch.float32))
    assert all(x.dtype == torch.float32 for x in got)
    np.testing.assert_allclose(got.qvel.numpy(), want.qvel.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.qpos.numpy(), want.qpos.numpy(),
                               rtol=1e-6, atol=1e-6)
    acc = slice(tm.sensor_adr("body_accel"), tm.sensor_adr("body_accel") + 3)
    np.testing.assert_allclose(got.sensordata[acc].numpy(),
                               want.sensordata[acc].numpy(), atol=2e-3)


def test_consts_are_made_once_per_model_dtype_device():
    tm = _tmodel("planning")
    a = smooth.consts(tm, F64, "cpu")
    assert smooth.consts(tm, F64, torch.device("cpu")) is a
    b = smooth.consts(tm, torch.float32, "cpu")
    assert b is not a and b.body_pos.dtype == torch.float32
    assert a.act_dadr.dtype == torch.int64
    assert a.ancestor_dof_mask.dtype == torch.bool
    assert smooth.consts(_tmodel("full"), F64, "cpu") is not a
    frame = collision.plane_frame(tm, F64, "cpu")
    np.testing.assert_allclose(
        frame.numpy(), np.asarray(jcollision.plane_frame(
            _jmodel("planning"), jnp.float64)), atol=0)
    assert collision.plane_frame(tm, F64, "cpu") is frame


def test_consts_die_with_their_model():
    import gc
    import weakref

    tm = dataclasses.replace(_tmodel("planning"), timestep=0.001)
    c = smooth.consts(tm, F64, "cpu")
    assert smooth.consts(tm, F64, "cpu") is c
    # a variant of the model shares nothing with it, and no module-level
    # table keeps either alive
    other = dataclasses.replace(tm, timestep=0.003)
    assert smooth.consts(other, F64, "cpu") is not c
    alive = weakref.ref(c.body_pos)
    del c, tm
    gc.collect()
    assert alive() is None


def test_true_fp32_restores_the_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for value in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = value
            with maths.true_fp32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is value
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ZeroDivisionError):
            with maths.true_fp32():
                1 / 0
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("entry", ["forward", "step", "control_step"])
def test_engine_enters_true_fp32_once_per_call(entry, monkeypatch):
    import contextlib

    entered = []

    @contextlib.contextmanager
    def counting():
        entered.append(entry)
        yield

    monkeypatch.setattr(maths, "true_fp32", counting)
    tm = _tmodel("planning")
    st, ctrl = _tstate("planning", "standing")
    extra = (2,) if entry == "control_step" else ()
    getattr(engine, entry)(tm, st, ctrl, *extra, max_contacts=4,
                           solver_iterations=1)
    assert entered == [entry]


def test_unknown_sensor_kind_raises():
    tm = _tmodel("planning")
    bogus = dataclasses.replace(
        tm, sensors=tm.sensors[:-1] + (dataclasses.replace(
            tm.sensors[-1], kind=99),))
    st, ctrl = _tstate("planning", "standing")
    with pytest.raises(NotImplementedError, match="sensor kind 99"):
        engine.forward(bogus, st, ctrl)


def test_make_state_device():
    tm = _tmodel("planning")
    st = engine.make_state(tm, dtype=F64, device="cpu")
    np.testing.assert_array_equal(st.qpos.numpy(), tm.qpos0)
    assert st.time.shape == () and st.sensordata.shape == (33,)
    if not torch.cuda.is_available():  # the card unless the caller says cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.make_state(tm)
