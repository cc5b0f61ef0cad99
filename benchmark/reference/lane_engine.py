# Frozen copy of the first part of quadruped_gym_tpu_torch/ops/lane_engine.py
# for the benchmark's plain reference: the lane state, its layouts and the
# per-model constants that the leg engine (leg_engine.py) builds on, with
# its imports pointed at this folder. The lane engine's own step is not
# copied: the reference steps the leg engine. Later changes to the port do
# not reach it.
"""The lane state (batch minor: a per-robot scalar is a (B,) lane vector)
and the model constants shared with the leg engine."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .spec import PhysicsModel


class LaneState(NamedTuple):
    """Batched state, batch minor: each row is one lane vector."""

    qpos: torch.Tensor  # (nq, B)
    qvel: torch.Tensor  # (nv, B)
    act: torch.Tensor  # (na, B)
    time: torch.Tensor  # (B,)
    sensordata: torch.Tensor  # (nsensordata, B)


def make_lane_state(m: PhysicsModel, batch: int, dtype=torch.float32,
                    device=None) -> LaneState:
    device = resolve_device(device)
    qpos0 = torch.as_tensor(np.asarray(m.qpos0), dtype=dtype, device=device)
    return LaneState(
        qpos=qpos0[:, None].expand(m.nq, batch).contiguous(),
        qvel=torch.zeros((m.nv, batch), dtype=dtype, device=device),
        act=torch.zeros((m.na, batch), dtype=dtype, device=device),
        time=torch.zeros((batch,), dtype=dtype, device=device),
        sensordata=torch.zeros((m.nsensordata, batch), dtype=dtype,
                               device=device),
    )


def from_batched(qpos, qvel, act, time, sensordata) -> LaneState:
    """Convert leading-batch tensors (B, dim) to lane layout (dim, B)."""
    return LaneState(
        qpos=qpos.T, qvel=qvel.T, act=act.T, time=time, sensordata=sensordata.T
    )


def to_batched(ls: LaneState):
    return (ls.qpos.T, ls.qvel.T, ls.act.T, ls.time, ls.sensordata.T)


# --------------------------------------------------------------------------
# static (host-side) model structure, cached per model


@dataclasses.dataclass(frozen=True)
class _Static:
    root: int
    dof_body: Tuple[int, ...]
    dof_parent: Tuple[int, ...]  # previous dof on the kinematic path, -1=root
    dof_chain: Tuple[Tuple[int, ...], ...]  # strict ancestors of each dof
    children: Tuple[Tuple[int, ...], ...]
    body_dofs: Tuple[Tuple[int, ...], ...]  # ancestor dofs per body (sorted)
    m_pairs: Tuple[Tuple[int, int], ...]  # (i, j), j < i, j ancestor of i
    plane_frame: Tuple[Tuple[float, float, float], ...]  # n, t1, t2
    plane_off: float


def _static(m: PhysicsModel) -> _Static:
    # cached ON the model: an id()-keyed dict could serve stale topology
    # to a new model reusing a garbage-collected model's address
    cached = getattr(m, "_lane_static_cache", None)
    if cached is not None:
        return cached
    root = next(b for b in range(1, m.nbody) if m.body_parentid[b] == 0)

    dof_body = []
    for b in range(1, m.nbody):
        dof_body += [b] * m.body_dofnum[b]
    dof_body = tuple(dof_body)

    def last_dof_of_ancestor(b):
        p = m.body_parentid[b]
        while p != 0:
            if m.body_dofnum[p]:
                return m.body_dofadr[p] + m.body_dofnum[p] - 1
            p = m.body_parentid[p]
        return -1

    dof_parent = []
    for b in range(1, m.nbody):
        da, dn = m.body_dofadr[b], m.body_dofnum[b]
        for k in range(dn):
            dof_parent.append(da + k - 1 if k else last_dof_of_ancestor(b))
    dof_parent = tuple(dof_parent)

    dof_chain = []
    for i in range(m.nv):
        chain, p = [], dof_parent[i]
        while p >= 0:
            chain.append(p)
            p = dof_parent[p]
        dof_chain.append(tuple(chain))
    dof_chain = tuple(dof_chain)

    children = tuple(
        tuple(c for c in range(1, m.nbody) if m.body_parentid[c] == b)
        for b in range(m.nbody)
    )

    body_dofs = []
    for b in range(m.nbody):
        dofs, x = [], b
        while x != 0:
            da, dn = m.body_dofadr[x], m.body_dofnum[x]
            dofs += list(range(da, da + dn))
            x = m.body_parentid[x]
        body_dofs.append(tuple(sorted(dofs)))
    body_dofs = tuple(body_dofs)

    m_pairs = tuple((i, j) for i in range(m.nv) for j in dof_chain[i])

    n = np.asarray(m.plane_normal, np.float64)
    ref = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0.0, 1, 0])
    t1 = np.cross(n, ref)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    s = _Static(
        root=root,
        dof_body=dof_body,
        dof_parent=dof_parent,
        dof_chain=dof_chain,
        children=children,
        body_dofs=body_dofs,
        m_pairs=m_pairs,
        plane_frame=(
            tuple(float(x) for x in n),
            tuple(float(x) for x in t1),
            tuple(float(x) for x in t2),
        ),
        plane_off=float(np.dot(n, np.asarray(m.plane_pos))),
    )
    object.__setattr__(m, "_lane_static_cache", s)
    return s


def _f(x) -> float:
    return float(x)


def _v3c(a) -> Tuple[float, float, float]:
    return (float(a[0]), float(a[1]), float(a[2]))


def _quatc(a) -> Tuple[float, float, float, float]:
    return (float(a[0]), float(a[1]), float(a[2]), float(a[3]))


def _np_quat_mat(qc) -> np.ndarray:
    w, x, y, z = (float(qc[0]), float(qc[1]), float(qc[2]), float(qc[3]))
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# --------------------------------------------------------------------------
# constraint impedance (MuJoCo solref/solimp)


def _impedance_np_params(solimp):
    return tuple(float(x) for x in solimp)


def _imp_lane(solimp, r):
    d0, dmax, width, mid, power = solimp
    x = torch.clamp(torch.abs(r) / max(width, 1e-15), 0.0, 1.0)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)
    y = torch.where(x < mid, a * x**power, 1.0 - b * (1.0 - x) ** power)
    return d0 + y * (dmax - d0)


def _kb_from_solref(solref, solimp):
    tc, dr = float(solref[0]), float(solref[1])
    dmax = float(solimp[1])
    if tc > 0:
        K = 1.0 / max(dmax**2 * tc**2 * dr**2, 1e-15)
        B = 2.0 / max(dmax * tc, 1e-15)
    else:
        K, B = -tc, -dr
    return K, B


# --------------------------------------------------------------------------
# stacked small-vector algebra: the vector dims come just before the lane
# dim, e.g. a 3-vector per body is (nbody, 3, B), a matrix (nbody, 3, 3, B)
