"""Implicit-in-velocity integration (MuJoCo ``implicitfast`` semantics).

Counterpart of ``quadruped_gym_tpu/physics/integrator.py``. The scheme:

  * computes qacc through the normal forward pipeline (constraint solver
    included),
  * then updates velocity implicitly w.r.t. the velocity-dependent smooth
    forces:  (M - h·D) Δv = h·(M·qacc),  where D = ∂(passive+actuator)/∂qvel
    (the 'fast' variant omits the RNE Coriolis derivative),
  * updates activations with the exact first-order filter, and integrates
    positions with the *new* velocity (semi-implicit Euler in position).

D is diagonal for this robot (joint damping + affine actuator velocity
gain), so the implicit solve is a single extra 18x18 Cholesky.
"""

from __future__ import annotations

import torch

from ..models.spec import JNT_FREE, JNT_HINGE, PhysicsModel
from . import maths
from .maths import cho_solve, matvec
from .smooth import consts


def implicit_velocity_update(
    m: PhysicsModel,
    M: torch.Tensor,
    qvel: torch.Tensor,
    qacc: torch.Tensor,
    act_vel_deriv: torch.Tensor,
    h: float,
) -> torch.Tensor:
    """qvel_{t+h} from the implicitfast update."""
    damping = consts(m, qvel.dtype, qvel.device).dof_damping
    D = -damping + act_vel_deriv  # diag of d(qfrc_smooth)/d(qvel)
    Mhat = M - h * torch.diag_embed(D)
    # force consistent with the solved qacc: f = M @ qacc
    rhs = h * matvec(M, qacc)
    return qvel + cho_solve(Mhat, rhs)


def integrate_pos(
    m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor, h: float
) -> torch.Tensor:
    """mj_integratePos: world-frame linear, body-frame quaternion expmap.
    The new qpos is assembled joint by joint in address order; a run of
    consecutive hinges is one slice."""
    pieces = []
    j = 0
    while j < m.njnt:
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        assert qadr == sum(p.shape[-1] for p in pieces)
        if m.jnt_type[j] == JNT_FREE:
            pieces.append(qpos[..., qadr: qadr + 3]
                          + h * qvel[..., dadr: dadr + 3])
            pieces.append(maths.quat_integrate(
                qpos[..., qadr + 3: qadr + 7], qvel[..., dadr + 3: dadr + 6], h
            ))
            j += 1
            continue
        n = 0
        while j + n < m.njnt and m.jnt_type[j + n] != JNT_FREE:
            assert m.jnt_type[j + n] == JNT_HINGE
            assert m.jnt_qposadr[j + n] == qadr + n
            assert m.jnt_dofadr[j + n] == dadr + n
            n += 1
        pieces.append(qpos[..., qadr: qadr + n] + h * qvel[..., dadr: dadr + n])
        j += n
    return torch.cat(pieces, dim=-1)
