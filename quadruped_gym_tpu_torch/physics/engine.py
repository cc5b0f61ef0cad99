"""The physics engine front-end: ``forward`` / ``step`` / ``control_step``.

Counterpart of ``quadruped_gym_tpu/physics/engine.py``: pure functions
over a ``State`` of tensors, the oracle ("AoS") engine that mirrors
MuJoCo's ``mj_step``. Every function takes any leading batch dims on the
state's fields and on ``ctrl`` (all of them the same): with none it steps
one robot, with some it is the JAX package's ``jax.vmap(step)``. It runs
on the device its tensors live on.

Step semantics mirror mj_step exactly: forward() evaluates dynamics and
sensors at the *current* state, then the integrator advances, so the
sensordata attached to the returned state is the pre-integration reading.

Float32 products are true FP32: each public function here enters
``maths.true_fp32()`` once, around all it does, which switches cuBLAS's
TF32 mode off for the call whatever the process-wide flag says (the JAX
package's ``default_matmul_precision("highest")``). That flag is the
process's, so two threads must not step engines while a third turns TF32
on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from . import (collision, constraints, integrator, maths, sensors, smooth,
               solver)


class State(NamedTuple):
    qpos: torch.Tensor  # (..., nq)
    qvel: torch.Tensor  # (..., nv)
    act: torch.Tensor  # (..., na)
    time: torch.Tensor  # (...)
    sensordata: torch.Tensor  # (..., nsensordata) reading at the last forward()


class Forward(NamedTuple):
    kin: smooth.Kin
    S: torch.Tensor
    cvel: torch.Tensor
    M: torch.Tensor
    qacc: torch.Tensor
    qfrc_smooth: torch.Tensor
    qfrc_constraint: torch.Tensor
    act_vel_deriv: torch.Tensor
    sensordata: torch.Tensor
    ncon_active: torch.Tensor


def make_state(m: PhysicsModel, dtype=torch.float32, device=None) -> State:
    """Default state: qpos0, zero velocity/activation (mj_resetData). The
    model's qpos0 is uploaded once (``smooth.consts``): no host-to-device
    copy after the first call."""
    device = resolve_device(device)
    return State(
        qpos=smooth.consts(m, dtype, device).qpos0.clone(),
        qvel=torch.zeros(m.nv, dtype=dtype, device=device),
        act=torch.zeros(m.na, dtype=dtype, device=device),
        time=torch.zeros((), dtype=dtype, device=device),
        sensordata=torch.zeros(m.nsensordata, dtype=dtype, device=device),
    )


def _forward(m, state, ctrl, max_contacts, solver_iterations) -> Forward:
    qpos, qvel, act = state.qpos, state.qvel, state.act

    kin = smooth.fwd_position(m, qpos)
    S = smooth.dof_subspace(m, kin)
    cvel = smooth.body_velocities(m, S, qvel)
    M = smooth.crba(m, kin, S)
    bias = smooth.rne_bias(m, kin, S, cvel, qvel)
    actu = smooth.actuation(m, qpos, qvel, act)
    qfrc_smooth = actu.qfrc + smooth.passive_force(m, qvel) - bias

    qacc_smooth = maths.cho_solve(M, qfrc_smooth)

    con = collision.collide(m, kin)
    efc = constraints.make_constraints(
        m, kin, S, con, qpos, qvel, max_contacts=max_contacts
    )
    res = solver.solve(m, M, qacc_smooth, efc, iterations=solver_iterations)

    cacc = smooth.body_accelerations(m, S, cvel, qvel, res.qacc)
    sens = sensors.evaluate(m, kin, cvel, cacc, qpos)

    return Forward(
        kin=kin,
        S=S,
        cvel=cvel,
        M=M,
        qacc=res.qacc,
        qfrc_smooth=qfrc_smooth,
        qfrc_constraint=res.qfrc_constraint,
        act_vel_deriv=actu.vel_deriv,
        sensordata=sens,
        ncon_active=torch.sum(efc.active, dim=-1),
    )


def forward(
    m: PhysicsModel,
    state: State,
    ctrl: torch.Tensor,
    max_contacts: int = 24,
    solver_iterations: Optional[int] = None,
) -> Forward:
    """Full dynamics evaluation at the current state (mj_forward)."""
    with maths.true_fp32():
        return _forward(m, state, ctrl, max_contacts, solver_iterations)


def _step(m, state, ctrl, max_contacts, solver_iterations) -> State:
    h = m.timestep
    ctrl_c = smooth.clip_ctrl(m, ctrl)
    fwd = _forward(m, state, ctrl_c, max_contacts, solver_iterations)
    qvel_new = integrator.implicit_velocity_update(
        m, fwd.M, state.qvel, fwd.qacc, fwd.act_vel_deriv, h
    )
    act_new = smooth.act_filter_exact(m, state.act, ctrl_c, h)
    qpos_new = integrator.integrate_pos(m, state.qpos, qvel_new, h)
    return State(
        qpos=qpos_new,
        qvel=qvel_new,
        act=act_new,
        time=state.time + h,
        sensordata=fwd.sensordata,
    )


def step(
    m: PhysicsModel,
    state: State,
    ctrl: torch.Tensor,
    max_contacts: int = 24,
    solver_iterations: Optional[int] = None,
) -> State:
    """One physics step (mj_step semantics, implicitfast integrator)."""
    with maths.true_fp32():
        return _step(m, state, ctrl, max_contacts, solver_iterations)


def control_step(
    m: PhysicsModel,
    state: State,
    ctrl: torch.Tensor,
    frame_skip: int,
    max_contacts: int = 24,
    solver_iterations: Optional[int] = None,
) -> State:
    """One *environment* step: frame_skip physics substeps under a constant
    control."""
    with maths.true_fp32():
        for _ in range(frame_skip):
            state = _step(m, state, ctrl, max_contacts, solver_iterations)
    return state
