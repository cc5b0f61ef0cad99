"""Inputs shared by the gradient-solver parity tests of the PyTorch port
(``test_torch_ilqr.py``, ``test_torch_sqp.py``,
``test_torch_gradient_mpc.py``): the planning model at a small budget,
start states made on the port's engine from a seed (float64, numpy in
between), and the JAX-made reference file of the whole solves with the
script that writes it."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import torch

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
HOLD = np.array([0.0, 0.0, -0.5] * 4)
# one substep of the oracle engine at a small budget: the linearizations'
# step function
STEP_KW = dict(max_contacts=8, solver_iterations=2)
JM, TM = jspec.get_planning_model(), tspec.get_planning_model()


def snapshot_script():
    """``scripts/snapshot_torch_gradient_refs.py`` as a module."""
    path = os.path.join(REPO, "scripts", "snapshot_torch_gradient_refs.py")
    spec = importlib.util.spec_from_file_location("snapshot_refs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def refs() -> dict:
    """The committed JAX results of the whole solves."""
    with np.load(snapshot_script().OUT) as data:
        return {k: data[k] for k in data.files}


@functools.lru_cache(maxsize=None)
def start_arrays(kind: str):
    """(qpos, qvel, act) of a planning-model start state, float64 numpy:
    ``"airborne"`` is the reset state (10 cm up, at rest); ``"contact"``
    the reset state dropped for 0.4 s on the port's engine, then moving
    (a velocity perturbation from a seed); ``"tilted"`` that state with
    its base turned 120 degrees about (1, 1, 1), a quaternion that
    normalizes to itself in every bit (so a tangent of 0 gives a relative
    rotation of exactly 0)."""
    if kind == "airborne":
        st = engine.make_state(TM, dtype=F64, device="cpu")
        return st.qpos.numpy(), st.qvel.numpy(), st.act.numpy()
    qpos, qvel, act = _settled()
    rng = np.random.default_rng(0)
    qpos = qpos.copy()
    qvel = qvel + 0.1 * rng.standard_normal(TM.nv)
    if kind == "tilted":
        qpos[3:7] = 0.5
    return qpos, qvel, act


@functools.lru_cache(maxsize=None)
def _settled():
    st = engine.make_state(TM, dtype=F64, device="cpu")
    st = engine.control_step(TM, st, torch.as_tensor(HOLD), 200,
                             max_contacts=8, solver_iterations=4)
    return st.qpos.numpy(), st.qvel.numpy(), st.act.numpy()


def tstate(kind: str) -> engine.State:
    qpos, qvel, act = start_arrays(kind)
    zeros = np.zeros(TM.nsensordata)
    return engine.State(*(torch.as_tensor(x) for x in (
        qpos, qvel, act, np.float64(0.0), zeros)))


def jstate(kind: str) -> jengine.State:
    qpos, qvel, act = start_arrays(kind)
    return jengine.State(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                         act=jnp.asarray(act), time=jnp.asarray(0.0),
                         sensordata=jnp.zeros(TM.nsensordata))


def tstep(st, u):
    return engine.control_step(TM, st, u, 1, **STEP_KW)


def trajectory(kind: str, H: int = 2, seed: int = 1):
    """(controls (H, nu), the states after each step stacked over H) of a
    rollout from ``kind`` on the port, float64 numpy."""
    rng = np.random.default_rng(seed)
    us = np.clip(HOLD + 0.3 * rng.standard_normal((H, TM.nu)), -1.0, 1.0)
    st, out = tstate(kind), []
    for u in us:
        st = tstep(st, torch.as_tensor(u))
        out.append(st)
    states = tuple(np.stack([getattr(s, f).numpy() for s in out])
                   for f in engine.State._fields)
    return us, states


def to_torch_states(states) -> engine.State:
    return engine.State(*(torch.as_tensor(x) for x in states))


def to_jax_states(states) -> jengine.State:
    return jengine.State(*(jnp.asarray(x) for x in states))


def close(got, want, rtol, atol_scale=None):
    """|got - want| <= rtol * (|want| + atol_scale), with ``atol_scale``
    the largest |want| unless given: a relative tolerance that does not
    fail on entries that are zero in one and rounding in the other."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() if atol_scale is None else atol_scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
