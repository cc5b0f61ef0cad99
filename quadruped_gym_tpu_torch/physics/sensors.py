"""Sensor evaluation: the exact 33-slot sensordata vector of the robot:
12 jointpos, accelerometer, gyro, framepos, framelinvel, framexaxis,
framezaxis, velocimeter.

Counterpart of ``quadruped_gym_tpu/physics/sensors.py``. Position and
velocity sensors read the current state; the accelerometer reads the
*proper* acceleration (gravity-offset spatial acceleration) at the site,
in the site frame. The engine injects no sensor noise, as MuJoCo does not.
"""

from __future__ import annotations

import torch

from ..models.spec import (
    SENSOR_ACCELEROMETER,
    SENSOR_FRAMELINVEL,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_GYRO,
    SENSOR_JOINTPOS,
    SENSOR_VELOCIMETER,
    PhysicsModel,
)
from . import maths
from .maths import matvec
from .smooth import Kin, site_frame


def evaluate(
    m: PhysicsModel,
    kin: Kin,
    cvel: torch.Tensor,
    cacc: torch.Tensor,
    qpos: torch.Tensor,
) -> torch.Tensor:
    """Full sensordata vector (..., nsensordata)."""
    sf = site_frame(m, kin)
    b = m.site_bodyid
    mat_t = sf.mat.transpose(-1, -2)

    w = cvel[..., b, :3]
    v0 = cvel[..., b, 3:]
    p = sf.pos - kin.origin
    v_site = v0 + maths.cross(w, p)

    alpha = cacc[..., b, :3]
    a0 = cacc[..., b, 3:]
    # material-point acceleration: a(p) = a_O + alpha x p + w x v(p)
    a_site = a0 + maths.cross(alpha, p) + maths.cross(w, v_site)

    pieces = {}
    for s in m.sensors:
        if s.kind == SENSOR_JOINTPOS:
            qadr = m.jnt_qposadr[s.objid]
            pieces[s.adr] = qpos[..., qadr: qadr + 1]
        elif s.kind == SENSOR_ACCELEROMETER:
            pieces[s.adr] = matvec(mat_t, a_site)
        elif s.kind == SENSOR_GYRO:
            pieces[s.adr] = matvec(mat_t, w)
        elif s.kind == SENSOR_FRAMEPOS:
            pieces[s.adr] = sf.pos
        elif s.kind == SENSOR_FRAMELINVEL:
            pieces[s.adr] = v_site
        elif s.kind == SENSOR_FRAMEXAXIS:
            pieces[s.adr] = sf.mat[..., :, 0]
        elif s.kind == SENSOR_FRAMEZAXIS:
            pieces[s.adr] = sf.mat[..., :, 2]
        elif s.kind == SENSOR_VELOCIMETER:
            pieces[s.adr] = matvec(mat_t, v_site)
        else:
            raise NotImplementedError(f"sensor kind {s.kind}")
    # the sensors tile the vector: assemble it in address order
    out, end = [], 0
    for adr in sorted(pieces):
        assert adr == end, "sensor addresses must tile sensordata"
        out.append(pieces[adr])
        end += pieces[adr].shape[-1]
    assert end == m.nsensordata
    return torch.cat(out, dim=-1)
