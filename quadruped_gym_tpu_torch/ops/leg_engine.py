"""Leg-batched engine: the four identical legs as a (4, B) lane dim.

Counterpart of ``quadruped_gym_tpu/ops/leg_engine.py``, in eager PyTorch
with the same math and the same operation order. The quadruped's
kinematic tree is one free base plus four structurally identical 3-dof
chains (only the hip mount pose differs per leg), so every leg quantity is
one (4, B) lane tensor:

  * dof order: free 0-5, then leg-major hinge dofs 6+3l+k (level k in
    {hip, knee, ankle});
  * the mass matrix splits into free-free (B,), free-leg (4, B) and
    within-leg (4, B) blocks with no leg-leg coupling; the tree-sparse
    LDLᵀ factors the four chains in parallel;
  * the contact Hessian M + JᵀWJ has the same block structure;
  * one hull per collision group serves all four legs. A group is a
    level of the leg chains (one geom a leg, the leg's body frame), or
    lies on the base: one geom a leg with a frame of its own each (the
    hip servos of ``full``, ``BASE``), or the base's own single geom
    (``full``'s frame, ``BASE_ONE``), carried in leg 0's lanes, the other
    legs' lanes of its slots never active. A base group's contact rows
    touch only the six free dofs.

Everything spatial is measured relative to ``kin.origin`` (the base
position): world-origin formulations cancel catastrophically in float32
far from the origin.

This engine is the plain version of the fused rollout kernel
(``ops/cuda_engine.py``) and what ``runtime.mpc_runtime.lane_control_step``
runs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.spec import (
    JNT_FREE,
    SENSOR_ACCELEROMETER,
    SENSOR_FRAMELINVEL,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_GYRO,
    SENSOR_JOINTPOS,
    SENSOR_VELOCIMETER,
    DomainParams,
    PhysicsModel,
)
from . import lane as L
from .lane_engine import (
    LaneState,
    _f,
    _imp_lane,
    _impedance_np_params,
    _kb_from_solref,
    _np_quat_mat,
    _quatc,
    _static,
    _v3c,
)

NLEG = 4
NLEV = 3  # hip, knee, ankle
# the level of a collision group on the base: one geom a leg, each with
# its own frame (BASE), or one geom that no leg carries (BASE_ONE)
BASE = -1
BASE_ONE = -2


@dataclasses.dataclass(frozen=True)
class _LegStatic:
    base: int  # body id of the free base
    leg_bodies: Tuple[Tuple[int, ...], ...]  # [level][leg] body ids
    leg_joints: Tuple[Tuple[int, ...], ...]  # [level][leg] joint ids
    # collision geoms, grouped into per-leg identical quadruples:
    # [(chain level, (geom id per leg))], the leg levels first; then the
    # base's: [(BASE, (geom id per leg))] and [(BASE_ONE, (geom id,))]
    col_groups: Tuple[Tuple[int, Tuple[int, ...]], ...]


class IncompatibleModelError(ValueError):
    """The model violates a leg-batching structural invariant."""


def _require(cond, msg: str) -> None:
    if not cond:
        raise IncompatibleModelError(msg)


def _leg_static(m: PhysicsModel) -> _LegStatic:
    cached = getattr(m, "_leg_static_cache", None)
    if cached is not None:
        return cached
    base = next(b for b in range(1, m.nbody) if m.body_parentid[b] == 0)
    _require(m.jnt_type[m.body_jntadr[base]] == JNT_FREE,
             "base joint is not free")
    hips = [b for b in range(1, m.nbody) if m.body_parentid[b] == base]
    _require(len(hips) == NLEG, f"expected 4 legs, got {len(hips)}")
    legs = []
    for h in hips:
        chain = [h]
        while True:
            kids = [b for b in range(1, m.nbody)
                    if m.body_parentid[b] == chain[-1]]
            if not kids:
                break
            _require(len(kids) == 1, "leg chain branches")
            chain.append(kids[0])
        _require(len(chain) == NLEV, "leg chain is not hip/knee/ankle")
        legs.append(chain)
    leg_bodies = tuple(tuple(legs[l][k] for l in range(NLEG))
                       for k in range(NLEV))
    leg_joints = tuple(
        tuple(m.body_jntadr[b] for b in leg_bodies[k]) for k in range(NLEV)
    )
    for k in range(NLEV):
        for field in ("body_mass", "body_inertia", "body_ipos", "body_iquat"):
            vals = np.asarray(getattr(m, field))[list(leg_bodies[k])]
            _require(np.allclose(vals, vals[0]), f"{field} differs across legs")
        for field in ("jnt_pos", "jnt_axis", "jnt_range", "jnt_solref",
                      "jnt_solimp", "jnt_margin"):
            vals = np.asarray(getattr(m, field))[list(leg_joints[k])]
            _require(np.allclose(vals, vals[0]), f"{field} differs across legs")
        if k > 0:
            for field in ("body_pos", "body_quat"):
                vals = np.asarray(getattr(m, field))[list(leg_bodies[k])]
                _require(np.allclose(vals, vals[0]),
                         f"{field} differs across legs")
        for l in range(NLEG):
            _require(m.jnt_dofadr[leg_joints[k][l]] == 6 + 3 * l + k,
                     "dof layout is not leg-major consecutive")
            _require(m.jnt_qposadr[leg_joints[k][l]] == 7 + 3 * l + k,
                     "qpos layout is not leg-major consecutive")
        _require(all(m.jnt_limited[j] for j in leg_joints[k]),
                 "leg joints must all be limited")
    for k in range(NLEV):
        q0s = [m.qpos0[m.jnt_qposadr[j]] for j in leg_joints[k]]
        _require(np.allclose(q0s, q0s[0]), "qpos0 differs across legs")
        iw = [m.dof_invweight0[m.jnt_dofadr[j]] for j in leg_joints[k]]
        _require(np.allclose(iw, iw[0]), "dof_invweight0 differs across legs")
    leg_dofs = [m.jnt_dofadr[leg_joints[k][l]]
                for k in range(NLEV) for l in range(NLEG)]
    for field in ("dof_armature", "dof_damping"):
        vals = [np.asarray(getattr(m, field))[d] for d in leg_dofs]
        _require(np.allclose(vals, vals[0]), f"{field} differs across leg dofs")
    _require(m.nu == NLEG * NLEV, "expected 12 actuators")
    for k in range(NLEV):
        for l in range(NLEG):
            _require(m.actuator_trnid[3 * l + k] == leg_joints[k][l],
                     "actuator order is not leg-major")
        us = [3 * l + k for l in range(NLEG)]
        for field in ("actuator_gainprm", "actuator_biasprm",
                      "actuator_gear", "actuator_forcerange",
                      "actuator_ctrlrange"):
            vals = np.asarray(getattr(m, field))[us]
            _require(np.allclose(vals, vals[0]), f"{field} differs across legs")
    dyn = np.asarray(m.actuator_dynprm)
    _require(np.allclose(dyn, dyn[0]),
             "actuator_dynprm differs across actuators")

    geoms_by_body: dict = {}
    for g, b in enumerate(m.col_geom_bodyid):
        geoms_by_body.setdefault(b, []).append(g)
    col_groups = []
    grouped = 0
    for k in range(NLEV):
        per_leg = [sorted(geoms_by_body.get(b, [])) for b in leg_bodies[k]]
        counts = {len(x) for x in per_leg}
        _require(len(counts) == 1, f"uneven geom counts across legs, level {k}")
        for j in range(counts.pop()):
            group = tuple(per_leg[l][j] for l in range(NLEG))
            col_groups.append((k, group))
            grouped += NLEG
    base_geoms = sorted(geoms_by_body.get(base, []))
    col_groups += _base_groups(m, base_geoms, leg_bodies[0])
    grouped += len(base_geoms)
    _require(grouped == len(m.col_geom_bodyid),
             "collision geoms outside the base and the leg chains are not "
             "supported")
    for level, group in col_groups:
        fields = ("col_friction", "col_solref", "col_solimp", "col_margin",
                  "col_gap", "col_theta2", "col_theta3")
        if level >= 0:  # a base group's members have frames of their own
            fields = ("col_geom_pos", "col_geom_quat") + fields
        for field in fields:
            vals = np.asarray(getattr(m, field))[list(group)]
            _require(np.allclose(vals, vals[0]), f"{field} differs across legs")
        for g in group[1:]:
            _require(np.array_equal(m.col_hull_verts[g],
                                    m.col_hull_verts[group[0]]),
                     "collision hulls differ across legs")
    s = _LegStatic(base=base, leg_bodies=leg_bodies, leg_joints=leg_joints,
                   col_groups=tuple(col_groups))
    object.__setattr__(m, "_leg_static_cache", s)
    return s


def _base_groups(m: PhysicsModel, geoms, hips) -> list:
    """The base's collision geoms as groups: four geoms with one hull and
    the same contact parameters, one nearest each leg's hip mount, make a
    ``BASE`` group (member l the one at leg l); every other geom is a
    ``BASE_ONE`` group of its own. ``BASE`` groups first, in geom order."""
    def key(g):
        params = [np.asarray(getattr(m, f))[g] for f in (
            "col_friction", "col_solref", "col_solimp", "col_margin",
            "col_gap", "col_theta2", "col_theta3")]
        return (np.asarray(m.col_hull_verts[g], np.float64).tobytes(),
                np.concatenate([np.ravel(p) for p in params]).tobytes())

    buckets: dict = {}
    for g in geoms:
        buckets.setdefault(key(g), []).append(g)
    mounts = np.asarray(m.body_pos)[list(hips)]
    per_leg, single = [], []
    for members in buckets.values():
        if len(members) == NLEG:
            pos = np.asarray(m.col_geom_pos)[members]
            near = [int(np.argmin(np.sum((mounts - p) ** 2, axis=1)))
                    for p in pos]
            if sorted(near) == list(range(NLEG)):
                per_leg.append((BASE, tuple(members[near.index(l)]
                                            for l in range(NLEG))))
                continue
        single += [(BASE_ONE, (g,)) for g in members]
    return (sorted(per_leg, key=lambda x: min(x[1]))
            + sorted(single, key=lambda x: x[1]))


def is_compatible(m: PhysicsModel) -> bool:
    """Whether the model satisfies the leg-batching invariants."""
    try:
        _leg_static(m)
        return True
    except (AssertionError, StopIteration, ValueError):
        return False


def _leg_const_col(col: np.ndarray, like: torch.Tensor):
    """One per-leg constant column -> float if shared, else a (4, 1)
    tensor that broadcasts against (4, B) leg lanes."""
    col = np.asarray(col, np.float64)
    if np.all(col == col[0]):
        return float(col[0])
    return torch.as_tensor(col, dtype=like.dtype, device=like.device)[:, None]


def _leg_const_vec(vals: np.ndarray, like: torch.Tensor):
    vals = np.asarray(vals, np.float64)
    return tuple(_leg_const_col(vals[:, c], like) for c in range(vals.shape[1]))


class _Kin(NamedTuple):
    base_pos: tuple  # Vec3 (B,)
    base_quat: tuple
    base_mat: tuple
    leg_pos: tuple  # [level] Vec3 of (4, B)
    leg_quat: tuple
    leg_mat: tuple
    origin: tuple


def _fk(m: PhysicsModel, q_free, q_leg):
    """q_free: list of 7 (B,); q_leg: [level] (4, B)."""
    ls = _leg_static(m)
    like = q_free[0]
    base_pos = (q_free[0], q_free[1], q_free[2])
    base_quat = L.quat_normalize((q_free[3], q_free[4], q_free[5], q_free[6]))

    leg_pos, leg_quat = [], []
    hip0 = list(ls.leg_bodies[0])
    pos = L.v3_add(base_pos, L.quat_rotate(
        base_quat, _leg_const_vec(np.asarray(m.body_pos)[hip0], like)))
    quat = L.quat_mul(base_quat,
                      _leg_const_vec(np.asarray(m.body_quat)[hip0], like))
    for k in range(NLEV):
        j0 = ls.leg_joints[k][0]
        if k > 0:
            b0 = ls.leg_bodies[k][0]
            pos = L.v3_add(pos, L.quat_rotate(quat, _v3c(m.body_pos[b0])))
            quat = L.quat_mul(quat, _quatc(m.body_quat[b0]))
        angle = q_leg[k] - _f(m.qpos0[m.jnt_qposadr[j0]])
        anchor_l = _v3c(m.jnt_pos[j0])
        anchor_w = L.v3_add(pos, L.quat_rotate(quat, anchor_l))
        quat = L.quat_mul(quat,
                          L.axis_angle_to_quat(_v3c(m.jnt_axis[j0]), angle))
        pos = L.v3_sub(anchor_w, L.quat_rotate(quat, anchor_l))
        leg_pos.append(pos)
        leg_quat.append(quat)

    return _Kin(
        base_pos=base_pos,
        base_quat=base_quat,
        base_mat=L.quat_to_mat(base_quat),
        leg_pos=tuple(leg_pos),
        leg_quat=tuple(leg_quat),
        leg_mat=tuple(L.quat_to_mat(qq) for qq in leg_quat),
        origin=base_pos,
    )


def _subspace(m: PhysicsModel, kin: _Kin):
    """Free rows (6 of mixed static/(B,)) + leg rows ([level] of (4, B))."""
    ls = _leg_static(m)
    S_free = []
    for k in range(3):
        e = [0.0, 0.0, 0.0]
        e[k] = 1.0
        S_free.append((0.0, 0.0, 0.0, e[0], e[1], e[2]))
    p = L.v3_sub(kin.base_pos, kin.origin)  # ~0 but keep general
    for k in range(3):
        a = L.mat_col(kin.base_mat, k)
        S_free.append(L.sv(a, L.v3_cross(p, a)))

    S_leg = []
    for k in range(NLEV):
        j0 = ls.leg_joints[k][0]
        anchor = L.v3_sub(
            L.v3_add(kin.leg_pos[k],
                     L.mat_vec(kin.leg_mat[k], _v3c(m.jnt_pos[j0]))),
            kin.origin,
        )
        axis = L.mat_vec(kin.leg_mat[k], _v3c(m.jnt_axis[j0]))
        S_leg.append(L.sv(axis, L.v3_cross(anchor, axis)))
    return tuple(S_free), tuple(S_leg)


def _body_velocities(m, S_free, S_leg, qv_free, qv_leg):
    v_base = (0.0,) * 6
    for d in range(6):
        v_base = L.sv_add(v_base, L.sv_scale(qv_free[d], S_free[d]))
    v_leg = []
    v = v_base
    for k in range(NLEV):
        v = L.sv_add(v, L.sv_scale(qv_leg[k], S_leg[k]))
        v_leg.append(v)
    return v_base, tuple(v_leg)


def _const_mat(qc):
    return tuple(tuple(float(v) for v in r) for r in _np_quat_mat(qc))


def _inertias(m: PhysicsModel, kin: _Kin, mass_scale=None):
    ls = _leg_static(m)
    b = ls.base
    xi_base = L.v3_add(kin.base_pos,
                       L.mat_vec(kin.base_mat, _v3c(m.body_ipos[b])))
    imat_b = L.mat_mul(kin.base_mat, _const_mat(m.body_iquat[b]))
    base_mass = _f(m.body_mass[b])
    base_inertia = _v3c(m.body_inertia[b])
    if mass_scale is not None:
        base_mass = L.mul(mass_scale, base_mass)
        base_inertia = tuple(L.mul(mass_scale, v) for v in base_inertia)
    I_base = L.spatial_inertia_world(
        base_mass, base_inertia, imat_b, L.v3_sub(xi_base, kin.origin))
    I_leg = []
    for k in range(NLEV):
        bk = ls.leg_bodies[k][0]
        xi = L.v3_add(kin.leg_pos[k],
                      L.mat_vec(kin.leg_mat[k], _v3c(m.body_ipos[bk])))
        imat = L.mat_mul(kin.leg_mat[k], _const_mat(m.body_iquat[bk]))
        I_leg.append(L.spatial_inertia_world(
            _f(m.body_mass[bk]), _v3c(m.body_inertia[bk]), imat,
            L.v3_sub(xi, kin.origin)))
    return I_base, tuple(I_leg)


def _sum_legs(x):
    """Reduce a (4, B) lane scalar over the leg axis -> (B,)."""
    if L.is_static(x):
        return 4.0 * x
    return (x[0] + x[1]) + (x[2] + x[3])


def _crba(m: PhysicsModel, S_free, S_leg, I_base, I_leg):
    """Block mass matrix: (Mff {(i,j<=i): (B,)}, Mfl {(i,k): (4,B)},
    Mll {(ki,kj<=ki): (4,B)})."""
    Ic = [None] * NLEV
    acc = I_leg[NLEV - 1]
    Ic[NLEV - 1] = acc
    for k in range(NLEV - 2, -1, -1):
        acc = tuple(tuple(L.add(I_leg[k][a][b], acc[a][b]) for b in range(6))
                    for a in range(6))
        Ic[k] = acc
    Ic_base = tuple(
        tuple(L.add(I_base[a][b], _sum_legs(Ic[0][a][b])) for b in range(6))
        for a in range(6)
    )

    F_free = [L.inertia_vec(Ic_base, S_free[i]) for i in range(6)]
    F_leg = [L.inertia_vec(Ic[k], S_leg[k]) for k in range(NLEV)]

    Mff, Mfl, Mll = {}, {}, {}
    for i in range(6):
        for j in range(i + 1):
            v = L.sv_dot(S_free[j], F_free[i])
            if i == j:
                v = L.add(v, _f(m.dof_armature[i]))
            Mff[(i, j)] = v
    for i in range(6):
        for k in range(NLEV):
            Mfl[(i, k)] = L.sv_dot(S_free[i], F_leg[k])
    arm = _f(m.dof_armature[6])  # all leg dofs share armature
    for ki in range(NLEV):
        for kj in range(ki + 1):
            v = L.sv_dot(S_leg[kj], F_leg[ki])
            if ki == kj:
                v = L.add(v, arm)
            Mll[(ki, kj)] = v
    return Mff, Mfl, Mll


def _rne_bias(m, kin, S_free, S_leg, v_base, v_leg, qv_free, qv_leg,
              I_base, I_leg):
    g = _v3c(m.gravity)
    base_acc0 = (0.0, 0.0, 0.0, -g[0], -g[1], -g[2])
    vJ_base = v_base[:3] + (
        L.sub(v_base[3], qv_free[0]),
        L.sub(v_base[4], qv_free[1]),
        L.sub(v_base[5], qv_free[2]),
    )
    acc_base = L.sv_add(base_acc0, L.motion_cross(v_base, vJ_base))
    acc = []
    prev_acc = acc_base
    for k in range(NLEV):
        vJ = L.sv_scale(qv_leg[k], S_leg[k])
        a = L.sv_add(prev_acc, L.motion_cross(v_leg[k], vJ))
        acc.append(a)
        prev_acc = a

    def body_force(I, v, a):
        return L.sv_add(L.inertia_vec(I, a),
                        L.force_cross(v, L.inertia_vec(I, v)))

    f_base = body_force(I_base, v_base, acc_base)
    f_leg = [body_force(I_leg[k], v_leg[k], acc[k]) for k in range(NLEV)]
    fsub = [None] * NLEV
    accf = f_leg[NLEV - 1]
    fsub[NLEV - 1] = accf
    for k in range(NLEV - 2, -1, -1):
        accf = L.sv_add(f_leg[k], accf)
        fsub[k] = accf
    fsub_base = tuple(L.add(f_base[i], _sum_legs(fsub[0][i]))
                      for i in range(6))
    bias_free = [L.sv_dot(S_free[i], fsub_base) for i in range(6)]
    bias_leg = [L.sv_dot(S_leg[k], fsub[k]) for k in range(NLEV)]
    return bias_free, bias_leg


def _level_actuator(m: PhysicsModel, k: int) -> int:
    j0 = _leg_static(m).leg_joints[k][0]
    return next(u for u in range(m.nu) if m.actuator_trnid[u] == j0)


def _actuation(m: PhysicsModel, q_leg, qv_leg, act_leg, gain_scale=None):
    """All actuators drive leg dofs; per level (4, B)."""
    qfrc, dvel = [], []
    for k in range(NLEV):
        u0 = _level_actuator(m, k)
        gear = _f(m.actuator_gear[u0])
        gp, bp = m.actuator_gainprm[u0], m.actuator_biasprm[u0]
        # gain_scale scales the servo stiffness kp: the gain and its
        # position-bias coupling; the velocity bias -kv stays nominal
        kp_term = L.mul(_f(gp[0]), act_leg[k])
        bias_q = L.mul(_f(bp[1]) * gear, q_leg[k])
        if gain_scale is not None:
            kp_term = L.mul(gain_scale, kp_term)
            bias_q = L.mul(gain_scale, bias_q)
        force = L.add(
            kp_term,
            L.add(_f(bp[0]),
                  L.add(bias_q, L.mul(_f(bp[2]) * gear, qv_leg[k]))),
        )
        lo = _f(m.actuator_forcerange[u0][0])
        hi = _f(m.actuator_forcerange[u0][1])
        clamped = torch.clamp(force, lo, hi)
        qfrc.append(L.mul(gear, clamped))
        in_range = (force > lo) & (force < hi)
        dvel.append(torch.where(in_range,
                                q_leg[k].new_tensor(gear * gear * _f(bp[2])),
                                0.0))
    return qfrc, dvel


# --------------------------------------------------------------------------
# block tree-sparse LDLᵀ


def _ldl_factor(Mff, Mfl, Mll):
    """Factor the block matrix; legs factor in parallel on the leg axis."""
    Hff, Hfl, Hll = dict(Mff), dict(Mfl), dict(Mll)
    Dinv_l, Lll, Lfl = {}, {}, {}
    for k in range(NLEV - 1, -1, -1):
        dinv = 1.0 / Hll[(k, k)]
        Dinv_l[k] = dinv
        for i in range(k - 1, -1, -1):  # leg-level ancestors
            a = Hll[(k, i)] * dinv  # (4,B)
            for j in range(i, -1, -1):
                Hll[(i, j)] = Hll[(i, j)] - a * Hll[(k, j)]
            for jf in range(6):
                Hfl[(jf, i)] = Hfl[(jf, i)] - a * Hfl[(jf, k)]
            Lll[(k, i)] = a
        for fi in range(5, -1, -1):  # free ancestors
            a = Hfl[(fi, k)] * dinv  # (4,B)
            for j in range(fi, -1, -1):
                # contributions from the four legs accumulate into ff
                Hff[(fi, j)] = Hff[(fi, j)] - torch.sum(a * Hfl[(j, k)], dim=0)
            Lfl[(k, fi)] = a
    # dense 6x6 free block (parents chain 5 <- 4 <- ... <- 0)
    Dinv_f, Lff = {}, {}
    for k in range(5, -1, -1):
        dinv = 1.0 / Hff[(k, k)]
        Dinv_f[k] = dinv
        for i in range(k - 1, -1, -1):
            a = Hff[(k, i)] * dinv
            for j in range(i, -1, -1):
                Hff[(i, j)] = Hff[(i, j)] - a * Hff[(k, j)]
            Lff[(k, i)] = a
    return (Dinv_f, Dinv_l, Lff, Lfl, Lll)


def _ldl_solve(fac, b_free, b_leg):
    Dinv_f, Dinv_l, Lff, Lfl, Lll = fac
    w_free = list(b_free)
    w_leg = list(b_leg)
    for k in range(NLEV - 1, -1, -1):
        for i in range(k - 1, -1, -1):
            w_leg[i] = w_leg[i] - Lll[(k, i)] * w_leg[k]
        for fi in range(5, -1, -1):
            w_free[fi] = w_free[fi] - torch.sum(Lfl[(k, fi)] * w_leg[k], dim=0)
    for k in range(5, -1, -1):
        for i in range(k - 1, -1, -1):
            w_free[i] = w_free[i] - Lff[(k, i)] * w_free[k]

    x_free = [w_free[k] * Dinv_f[k] for k in range(6)]
    x_leg = [w_leg[k] * Dinv_l[k] for k in range(NLEV)]
    for k in range(6):
        for i in range(k - 1, -1, -1):
            x_free[k] = x_free[k] - Lff[(k, i)] * x_free[i]
    for k in range(NLEV):
        acc = x_leg[k]
        for i in range(k - 1, -1, -1):
            acc = acc - Lll[(k, i)] * x_leg[i]
        for fi in range(6):
            acc = acc - Lfl[(k, fi)] * x_free[fi]
        x_leg[k] = acc
    return x_free, x_leg


def _sym_matvec(Mff, Mfl, Mll, x_free, x_leg):
    y_free = []
    for i in range(6):
        acc = 0.0
        for j in range(6):
            acc = L.add(acc, L.mul(Mff[(max(i, j), min(i, j))], x_free[j]))
        for k in range(NLEV):
            acc = L.add(acc, _sum_legs(Mfl[(i, k)] * x_leg[k]))
        y_free.append(acc)
    y_leg = []
    for ki in range(NLEV):
        acc = 0.0
        for kj in range(NLEV):
            acc = L.add(acc, L.mul(Mll[(max(ki, kj), min(ki, kj))], x_leg[kj]))
        for i in range(6):
            acc = L.add(acc, Mfl[(i, ki)] * x_free[i])
        y_leg.append(acc)
    return y_free, y_leg


# --------------------------------------------------------------------------
# collision + constraint rows (all leg-batched: slots are (4, B))


def _slot_budget(verts: np.ndarray, theta2: float, theta3: float) -> int:
    """How many of the 3 plane-convex contact slots can EVER activate for
    this hull: the 2nd slot needs an in-plane vertex separation >= theta2
    and the 3rd a perpendicular spread >= theta3, both bounded by the hull
    diameter, so slots beyond it are statically dead (bit-exact to skip)."""
    d2 = 0.0
    for i in range(len(verts)):
        d = np.sum((verts[i + 1:] - verts[i]) ** 2, axis=1)
        if d.size:
            d2 = max(d2, float(d.max()))
    diam = float(np.sqrt(d2))
    if diam < theta2:
        return 1
    return 2 if diam < theta3 else 3


def _geom_frame(m, kin, level, group):
    """World position and rotation of a group's geom: (4, B) lanes on a
    leg or ``BASE`` group (a ``BASE`` member's own frame as (4, 1)
    columns), (B,) lanes on a ``BASE_ONE`` group."""
    g0 = group[0]
    if level < 0:
        body_pos, body_mat = kin.base_pos, kin.base_mat
    else:
        body_pos, body_mat = kin.leg_pos[level], kin.leg_mat[level]
    if level == BASE:
        like = kin.base_pos[0]
        pos = _leg_const_vec(np.asarray(m.col_geom_pos)[list(group)], like)
        mats = np.stack([_np_quat_mat(m.col_geom_quat[g]) for g in group])
        rot = tuple(tuple(_leg_const_col(mats[:, r, c], like)
                          for c in range(3)) for r in range(3))
    else:
        pos, rot = _v3c(m.col_geom_pos[g0]), _const_mat(m.col_geom_quat[g0])
    gpos = L.v3_add(body_pos, L.mat_vec(body_mat, pos))
    gmat = L.mat_mul(body_mat, rot)
    return gpos, gmat


def _leg0_only(pos, dist, active):
    """A ``BASE_ONE`` slot's (B,) values as (4, B) lanes: leg 0 carries
    the slot, the other legs' copies are never active."""
    four = lambda x: x.expand((NLEG,) + x.shape)  # noqa: E731
    off = torch.zeros((NLEG - 1,) + active.shape, dtype=torch.bool,
                      device=active.device)
    return (tuple(four(x) for x in pos), four(dist),
            torch.cat([active[None], off]))


def _plane(m: PhysicsModel, dp):
    """((n, t1, t2), off): the ground-plane frame — static floats, or lane
    values when ``DomainParams.tilt_x/tilt_y`` tilt the ground per
    scenario (surface z = tilt_x*x + tilt_y*y through ``plane_pos``). The
    tangent construction replicates ``lane_engine._static`` (ref = ex,
    valid while |n_x| < 0.9)."""
    st = _static(m)
    if dp is None or (dp.tilt_x is None and dp.tilt_y is None):
        return st.plane_frame, st.plane_off
    tx = dp.tilt_x if dp.tilt_x is not None else 0.0
    ty = dp.tilt_y if dp.tilt_y is not None else 0.0
    inv = 1.0 / L.sqrt(tx * tx + ty * ty + 1.0)
    n = (L.mul(-1.0, L.mul(tx, inv)), L.mul(-1.0, L.mul(ty, inv)), inv)
    s = 1.0 / L.sqrt(n[1] * n[1] + n[2] * n[2])
    t1 = (torch.zeros_like(torch.as_tensor(s)), n[2] * s, -n[1] * s)
    t2 = L.v3_cross(n, t1)
    pp = np.asarray(m.plane_pos, np.float64)
    off = L.add(
        L.add(L.mul(n[0], float(pp[0])), L.mul(n[1], float(pp[1]))),
        L.mul(n[2], float(pp[2])),
    )
    return (n, t1, t2), off


def _terrain_surface(m: PhysicsModel, dp, x, y):
    """(z, gx, gy): terrain surface height and gradient at lane (x, y):
    ``z = pp_z + tilt_x*(x-pp_x) + tilt_y*(y-pp_y)
         + amp*sin(freq*(x-pp_x))*sin(freq*(y-pp_y))``."""
    pp = np.asarray(m.plane_pos, np.float64)
    tx = dp.tilt_x if dp.tilt_x is not None else 0.0
    ty = dp.tilt_y if dp.tilt_y is not None else 0.0
    xr = x - float(pp[0])
    yr = y - float(pp[1])
    z = tx * xr + ty * yr + float(pp[2])
    gx = tx * torch.ones_like(x)
    gy = ty * torch.ones_like(x)
    if dp.terrain_amp is not None:
        A, k = dp.terrain_amp, dp.terrain_freq
        sx, cx = torch.sin(k * xr), torch.cos(k * xr)
        sy, cy = torch.sin(k * yr), torch.cos(k * yr)
        z = z + A * sx * sy
        gx = gx + A * k * cx * sy
        gy = gy + A * k * sx * cy
    return z, gx, gy


def _local_plane(m: PhysicsModel, dp, gpos):
    """((n, t1, t2), off): the terrain's local tangent plane at the geom
    center's xy (exact for pure slope, first-order in curvature)."""
    x, y = gpos[0], gpos[1]
    z, gx, gy = _terrain_surface(m, dp, x, y)
    inv = 1.0 / torch.sqrt(gx * gx + gy * gy + 1.0)
    n = (-gx * inv, -gy * inv, inv)
    s = 1.0 / torch.sqrt(n[1] * n[1] + n[2] * n[2])
    t1 = (torch.zeros_like(s), n[2] * s, -n[1] * s)
    t2 = L.v3_cross(n, t1)
    off = n[0] * x + n[1] * y + n[2] * z
    return (n, t1, t2), off


def _terrain_active(dp) -> bool:
    if dp is None or dp.terrain_amp is None:
        return False
    if dp.terrain_freq is None:
        raise ValueError("DomainParams.terrain_amp requires terrain_freq")
    return True


def _collide_loop(m: PhysicsModel, kin: _Kin, plane_frame=None,
                  plane_off=None, dp=None):
    """Plane contacts for every collision group: up to 3 slots of (4, B)
    per group (see ``_slot_budget``), each tagged
    (pos, dist, active, level, g0, frame). The argmin/argmax vertex
    selections are select-loops over the hull vertices (strict ``<`` /
    ``>``, so the first index wins ties), the form the fused kernel runs;
    the JAX package's gather form (``_collide``) gives the same bits."""
    ls = _leg_static(m)
    st = _static(m)
    if plane_frame is None:
        plane_frame, plane_off = st.plane_frame, st.plane_off
    terrain = _terrain_active(dp)

    slots = []
    for level, group in ls.col_groups:
        g0 = group[0]
        gpos, gmat = _geom_frame(m, kin, level, group)
        verts = np.asarray(m.col_hull_verts[g0])
        V = verts.shape[0]

        if terrain:
            frame, off_g = _local_plane(m, dp, gpos)
            n = frame[0]
        else:
            frame, off_g = None, plane_off
            n = plane_frame[0]

        a = L.mat_tvec(gmat, n)
        base = L.sub(L.v3_dot(gpos, n), off_g)
        hs = [
            L.add(L.add(L.mul(float(verts[i, 0]), a[0]),
                        L.mul(float(verts[i, 1]), a[1])),
                  L.add(L.mul(float(verts[i, 2]), a[2]), base))
            for i in range(V)
        ]

        margin = _f(m.col_margin[g0])
        theta2 = _f(m.col_theta2[g0])
        theta3 = _f(m.col_theta3[g0])
        inc = _f(m.col_margin[g0] - m.col_gap[g0])
        nslot = _slot_budget(verts, theta2, theta3)

        # slot 0: deepest vertex (min height)
        b_h = hs[0]
        b_v = tuple(torch.full_like(hs[0], float(verts[0, c]))
                    for c in range(3))
        for i in range(1, V):
            take = hs[i] < b_h
            b_v = tuple(torch.where(take, float(verts[i, c]), b_v[c])
                        for c in range(3))
            b_h = torch.where(take, hs[i], b_h)
        h0, v0 = b_h, b_v
        p0 = L.v3_add(gpos, L.mat_vec(gmat, v0))
        a0 = h0 < margin
        emitted = [(p0, h0, a0)]

        if nslot >= 2:
            # slot 1: max in-plane distance from v0 among candidates
            vn2 = [float(np.sum(verts[i] ** 2)) for i in range(V)]
            v0n2 = L.v3_dot(v0, v0)
            neg = torch.full_like(h0, -1.0)
            b_s = neg
            b_v1 = tuple(torch.zeros_like(h0) for _ in range(3))
            b_h1 = torch.zeros_like(h0)
            for i in range(V):
                vdot0 = (float(verts[i, 0]) * v0[0]
                         + float(verts[i, 1]) * v0[1]
                         + float(verts[i, 2]) * v0[2])
                dv2 = vn2[i] - 2.0 * vdot0 + v0n2
                dplan = torch.sqrt(
                    torch.clamp_min(dv2 - (hs[i] - h0) ** 2, 0.0))
                s_i = torch.where(hs[i] < 2.0 * margin, dplan, neg)
                take = s_i > b_s
                b_s = torch.where(take, s_i, b_s)
                b_v1 = tuple(torch.where(take, float(verts[i, c]), b_v1[c])
                             for c in range(3))
                b_h1 = torch.where(take, hs[i], b_h1)
            d1, v1, h1 = b_s, b_v1, b_h1
            a1 = a0 & (d1 >= theta2)
            p1 = L.v3_add(gpos, L.mat_vec(gmat, v1))
            emitted.append((p1, h1, a1))

        if nslot >= 3:
            # slot 2: max perpendicular spread
            u1 = L.mat_vec(gmat, L.v3_sub(v1, v0))
            inv_d1 = 1.0 / torch.clamp_min(d1, 1e-12)
            dh = h1 - h0
            t = tuple(L.mul(L.sub(u1[i], L.mul(n[i], dh)), inv_d1)
                      for i in range(3))
            perp = L.v3_cross(n, t)
            gq = L.mat_tvec(gmat, perp)
            v0gq = L.v3_dot(v0, gq)
            b_s = neg
            b_v2 = tuple(torch.zeros_like(h0) for _ in range(3))
            b_h2 = torch.zeros_like(h0)
            for i in range(V):
                cdot = (float(verts[i, 0]) * gq[0]
                        + float(verts[i, 1]) * gq[1]
                        + float(verts[i, 2]) * gq[2])
                s_i = torch.where(hs[i] < 2.0 * margin,
                                  torch.abs(cdot - v0gq), neg)
                take = s_i > b_s
                b_s = torch.where(take, s_i, b_s)
                b_v2 = tuple(torch.where(take, float(verts[i, c]), b_v2[c])
                             for c in range(3))
                b_h2 = torch.where(take, hs[i], b_h2)
            c2, v2, h2 = b_s, b_v2, b_h2
            a2 = a1 & (c2 >= theta3)
            p2 = L.v3_add(gpos, L.mat_vec(gmat, v2))
            emitted.append((p2, h2, a2))

        for (pi, hi, ai) in emitted:
            pos = tuple(L.sub(pi[i], L.mul(0.5 * n[i], hi)) for i in range(3))
            active = ai & (hi < inc)
            if level == BASE_ONE:
                pos, hi, active = _leg0_only(pos, hi, active)
            slots.append((pos, hi, active, level, g0, frame))
    return slots


class _Rows(NamedTuple):
    lim_sign: tuple  # [level] (4, B)
    slot_J: tuple  # per slot: (Jn_free [6], Jn_leg [3], Jt1_..., Jt2_...);
    #                levels above the contact body's level (all three for
    #                a base group) are static 0.0
    slot_mu: tuple  # friction coefficient per contact slot
    aref: torch.Tensor  # (ngroups, 4, B): 3 limit groups + 4*nslot facets
    D: torch.Tensor


def _make_rows(m: PhysicsModel, kin: _Kin, S_free, S_leg, q_leg, qv_free,
               qv_leg, slots, friction=None, plane_frame=None):
    ls = _leg_static(m)
    st = _static(m)
    if plane_frame is None:
        plane_frame = st.plane_frame
    n, t1, t2 = plane_frame
    aref_rows, D_rows = [], []
    lim_sign = []

    # ---- joint limits: one group per level, rows (4, B) ----
    for k in range(NLEV):
        j0 = ls.leg_joints[k][0]
        lo, hi = _f(m.jnt_range[j0][0]), _f(m.jnt_range[j0][1])
        d_lo = q_leg[k] - lo
        d_hi = hi - q_leg[k]
        lower = d_lo <= d_hi
        dist = torch.where(lower, d_lo, d_hi)
        sign = torch.where(lower, 1.0, -1.0).to(dist.dtype)
        margin = _f(m.jnt_margin[j0])
        active = dist < margin
        r = dist - margin
        imp = _imp_lane(_impedance_np_params(m.jnt_solimp[j0]), r)
        K, B = _kb_from_solref(m.jnt_solref[j0], m.jnt_solimp[j0])
        vel = sign * qv_leg[k]
        aref_rows.append(-B * vel - K * imp * r)
        da0 = m.jnt_dofadr[j0]
        R = torch.clamp_min((1.0 - imp) / imp * _f(m.dof_invweight0[da0]),
                            1e-15)
        D_rows.append(torch.where(active, 1.0 / R, 0.0))
        lim_sign.append(sign)

    # ---- contact slots ----
    slot_J, slot_mu = [], []
    for (pos, dist, active, level, g0, frame) in slots:
        body0 = ls.base if level < 0 else ls.leg_bodies[level][0]
        nlev = max(level + 1, 0)  # the leg levels that move the contact
        n_s, t1_s, t2_s = frame if frame is not None else (n, t1, t2)
        # DomainParams.friction replaces the tangential coefficient of
        # every ground contact; the impedance weights keep the nominal
        # compile-time invweights
        mu = _f(m.col_friction[g0][0]) if friction is None else friction
        rel = L.v3_sub(pos, kin.origin)  # (4, B) Vec3

        def proj_rows(S_rows):
            Jn, Jt1, Jt2 = [], [], []
            for S in S_rows:
                c = L.v3_cross(L.sv_ang(S), rel)
                w = L.v3_add(c, L.sv_lin(S))
                Jn.append(L.v3_dot(w, n_s))
                Jt1.append(L.v3_dot(w, t1_s))
                Jt2.append(L.v3_dot(w, t2_s))
            return Jn, Jt1, Jt2

        Jn_f, Jt1_f, Jt2_f = proj_rows(S_free)
        # joints below the contact body on the chain do not move it, and
        # none moves a geom on the base
        Jn_l, Jt1_l, Jt2_l = proj_rows(S_leg[:nlev])
        pad = [0.0] * (NLEV - nlev)
        J = (tuple(Jn_f), tuple(Jn_l + pad), tuple(Jt1_f),
             tuple(Jt1_l + pad), tuple(Jt2_f), tuple(Jt2_l + pad))
        slot_J.append(J)
        slot_mu.append(mu)

        margin = _f(m.col_margin[g0] - m.col_gap[g0])
        r = dist - margin
        imp = _imp_lane(_impedance_np_params(m.col_solimp[g0]), r)
        K, B = _kb_from_solref(m.col_solref[g0], m.col_solimp[g0])
        diagA = 2.0 * _f(m.body_invweight0[body0][0]) * (1.0 + mu * mu)
        R = torch.clamp_min((1.0 - imp) / imp * diagA, 1e-15)
        Dslot = torch.where(active, 1.0 / R, 0.0)
        vn, v1_, v2_ = 0.0, 0.0, 0.0
        for i in range(6):
            vn = L.add(vn, L.mul(J[0][i], qv_free[i]))
            v1_ = L.add(v1_, L.mul(J[2][i], qv_free[i]))
            v2_ = L.add(v2_, L.mul(J[4][i], qv_free[i]))
        for k in range(NLEV):
            vn = L.add(vn, L.mul(J[1][k], qv_leg[k]))
            v1_ = L.add(v1_, L.mul(J[3][k], qv_leg[k]))
            v2_ = L.add(v2_, L.mul(J[5][k], qv_leg[k]))
        for sgn, vt in ((1.0, v1_), (-1.0, v1_), (1.0, v2_), (-1.0, v2_)):
            vel = L.add(vn, L.mul(sgn * mu, vt))
            aref_rows.append(L.sub(L.mul(-B, vel), K * imp * r))
            D_rows.append(Dslot)

    like = aref_rows[-1]
    return _Rows(
        lim_sign=tuple(lim_sign),
        slot_J=tuple(slot_J),
        slot_mu=tuple(slot_mu),
        aref=torch.stack([L.as_lane(x, like) for x in aref_rows]),
        D=torch.stack([L.as_lane(x, like) for x in D_rows]),
    )


def _rows_matvec(rows: _Rows, x_free, x_leg) -> torch.Tensor:
    """J x -> (ngroups, 4, B)."""
    out = [rows.lim_sign[k] * x_leg[k] for k in range(NLEV)]
    for J, mu in zip(rows.slot_J, rows.slot_mu):
        vn, v1, v2 = 0.0, 0.0, 0.0
        for i in range(6):
            vn = L.add(vn, L.mul(J[0][i], x_free[i]))
            v1 = L.add(v1, L.mul(J[2][i], x_free[i]))
            v2 = L.add(v2, L.mul(J[4][i], x_free[i]))
        for k in range(NLEV):
            vn = L.add(vn, L.mul(J[1][k], x_leg[k]))
            v1 = L.add(v1, L.mul(J[3][k], x_leg[k]))
            v2 = L.add(v2, L.mul(J[5][k], x_leg[k]))
        mv1 = L.mul(mu, v1)
        mv2 = L.mul(mu, v2)
        out += [L.add(vn, mv1), L.sub(vn, mv1), L.add(vn, mv2),
                L.sub(vn, mv2)]
    return torch.stack(out)


def _rows_tmatvec(rows: _Rows, y: torch.Tensor):
    """Jᵀ y -> (list of 6 (B,), list of NLEV (4, B))."""
    y_free = [0.0] * 6
    y_leg = [rows.lim_sign[k] * y[k] for k in range(NLEV)]
    for s, (J, mu) in enumerate(zip(rows.slot_J, rows.slot_mu)):
        r0 = NLEV + 4 * s
        yn = y[r0] + y[r0 + 1] + y[r0 + 2] + y[r0 + 3]
        y1 = mu * (y[r0] - y[r0 + 1])
        y2 = mu * (y[r0 + 2] - y[r0 + 3])
        for i in range(6):
            contrib = L.add(
                L.mul(J[0][i], yn),
                L.add(L.mul(J[2][i], y1), L.mul(J[4][i], y2)),
            )
            y_free[i] = L.add(y_free[i], _sum_legs(contrib))
        for k in range(NLEV):
            y_leg[k] = L.add(
                y_leg[k],
                L.add(L.mul(J[1][k], yn),
                      L.add(L.mul(J[3][k], y1), L.mul(J[5][k], y2))),
            )
    return y_free, y_leg


def _add_jwj(Mff, Mfl, Mll, rows: _Rows, w: torch.Tensor):
    """H = M + Jᵀ diag(w) J on the block pattern."""
    Hff, Hfl, Hll = dict(Mff), dict(Mfl), dict(Mll)
    for k in range(NLEV):  # limit rows: sign^2 == 1, per-leg diagonal
        Hll[(k, k)] = Hll[(k, k)] + w[k]
    for s, (J, mu) in enumerate(zip(rows.slot_J, rows.slot_mu)):
        r0 = NLEV + 4 * s
        w1, w2, w3, w4 = w[r0], w[r0 + 1], w[r0 + 2], w[r0 + 3]
        cnn = w1 + w2 + w3 + w4
        c11 = mu * mu * (w1 + w2)
        c22 = mu * mu * (w3 + w4)
        cn1 = mu * (w1 - w2)
        cn2 = mu * (w3 - w4)
        Jn_f, Jn_l, Jt1_f, Jt1_l, Jt2_f, Jt2_l = J

        def pairval(ni, t1i, t2i, nj, t1j, t2j):
            return (
                cnn * ni * nj + c11 * t1i * t1j + c22 * t2i * t2j
                + cn1 * (ni * t1j + t1i * nj) + cn2 * (ni * t2j + t2i * nj)
            )

        for i in range(6):
            for j in range(i + 1):
                Hff[(i, j)] = Hff[(i, j)] + torch.sum(
                    pairval(Jn_f[i], Jt1_f[i], Jt2_f[i],
                            Jn_f[j], Jt1_f[j], Jt2_f[j]),
                    dim=0,
                )
            for k in range(NLEV):
                Hfl[(i, k)] = Hfl[(i, k)] + pairval(
                    Jn_f[i], Jt1_f[i], Jt2_f[i], Jn_l[k], Jt1_l[k], Jt2_l[k]
                )
        for ki in range(NLEV):
            for kj in range(ki + 1):
                Hll[(ki, kj)] = Hll[(ki, kj)] + pairval(
                    Jn_l[ki], Jt1_l[ki], Jt2_l[ki],
                    Jn_l[kj], Jt1_l[kj], Jt2_l[kj],
                )
    return Hff, Hfl, Hll


def _newton_solve(m, Mff, Mfl, Mll, rows: _Rows, qa_free, qa_leg,
                  iterations, ls_iterations):
    x_free, x_leg = list(qa_free), list(qa_leg)
    for _ in range(iterations):
        jar = _rows_matvec(rows, x_free, x_leg) - rows.aref
        w = torch.where((jar < 0.0) & (rows.D > 0.0), rows.D, 0.0)
        gs_free, gs_leg = _sym_matvec(
            Mff, Mfl, Mll,
            [x_free[i] - qa_free[i] for i in range(6)],
            [x_leg[k] - qa_leg[k] for k in range(NLEV)],
        )
        jt_free, jt_leg = _rows_tmatvec(rows, w * jar)
        g_free = [L.add(gs_free[i], jt_free[i]) for i in range(6)]
        g_leg = [L.add(gs_leg[k], jt_leg[k]) for k in range(NLEV)]
        H = _add_jwj(Mff, Mfl, Mll, rows, w)
        fac = _ldl_factor(*H)
        dx_free, dx_leg = _ldl_solve(
            fac, [L.neg(g) for g in g_free], [L.neg(g) for g in g_leg]
        )

        Jdx = _rows_matvec(rows, dx_free, dx_leg)
        mdx_free, mdx_leg = _sym_matvec(Mff, Mfl, Mll, dx_free, dx_leg)
        g0 = sum(dx_free[i] * gs_free[i] for i in range(6)) + sum(
            _sum_legs(dx_leg[k] * gs_leg[k]) for k in range(NLEV)
        )
        h0 = sum(dx_free[i] * mdx_free[i] for i in range(6)) + sum(
            _sum_legs(dx_leg[k] * mdx_leg[k]) for k in range(NLEV)
        )

        t = torch.ones_like(x_free[0])
        for _ in range(ls_iterations):
            jar_t = jar + t[None, None] * Jdx
            w_t = torch.where((jar_t < 0.0) & (rows.D > 0.0), rows.D, 0.0)
            dphi = g0 + t * h0 + torch.sum(w_t * jar_t * Jdx, dim=(0, 1))
            ddphi = h0 + torch.sum(w_t * Jdx * Jdx, dim=(0, 1))
            t = torch.clamp(t - dphi / torch.clamp_min(ddphi, 1e-30), 0.0, 4.0)
        x_free = [x_free[i] + t * dx_free[i] for i in range(6)]
        x_leg = [x_leg[k] + t[None] * dx_leg[k] for k in range(NLEV)]

    jar = _rows_matvec(rows, x_free, x_leg) - rows.aref
    force = torch.where((jar < 0.0) & (rows.D > 0.0), -rows.D * jar, 0.0)
    qfrc_free, qfrc_leg = _rows_tmatvec(rows, force)
    return x_free, x_leg, qfrc_free, qfrc_leg


# --------------------------------------------------------------------------
# sensors (the IMU site lives on the base — no leg accelerations needed)


def _sensors(m: PhysicsModel, kin: _Kin, v_base, cacc_base, q_free, q_leg):
    b = m.site_bodyid
    ls = _leg_static(m)
    _require(b == ls.base, "IMU site must live on the base body")
    spos = L.v3_add(kin.base_pos, L.mat_vec(kin.base_mat, _v3c(m.site_pos)))
    smat = L.mat_mul(kin.base_mat, _const_mat(m.site_quat))
    w = L.sv_ang(v_base)
    v0 = L.sv_lin(v_base)
    p = L.v3_sub(spos, kin.origin)
    v_site = L.v3_add(v0, L.v3_cross(w, p))
    alpha = L.sv_ang(cacc_base)
    a0 = L.sv_lin(cacc_base)
    a_site = L.v3_add(a0, L.v3_add(L.v3_cross(alpha, p),
                                   L.v3_cross(w, v_site)))

    out = [None] * m.nsensordata
    for s in m.sensors:
        if s.kind == SENSOR_JOINTPOS:
            qa = m.jnt_qposadr[s.objid]
            lvl = (qa - 7) % 3
            leg = (qa - 7) // 3
            out[s.adr] = q_leg[lvl][leg]
        elif s.kind == SENSOR_ACCELEROMETER:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = L.mat_tvec(
                smat, a_site)
        elif s.kind == SENSOR_GYRO:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = L.mat_tvec(smat, w)
        elif s.kind == SENSOR_FRAMEPOS:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = spos
        elif s.kind == SENSOR_FRAMELINVEL:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = v_site
        elif s.kind == SENSOR_FRAMEXAXIS:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = L.mat_col(smat, 0)
        elif s.kind == SENSOR_FRAMEZAXIS:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = L.mat_col(smat, 2)
        elif s.kind == SENSOR_VELOCIMETER:
            out[s.adr], out[s.adr + 1], out[s.adr + 2] = L.mat_tvec(
                smat, v_site)
        else:
            raise NotImplementedError(f"sensor kind {s.kind}")
    like = out[18]  # framepos x — always a (B,) tensor
    return L.stack_lanes(out, like)


# --------------------------------------------------------------------------
# the step

# the dof layout is asserted identical for every compatible model
# (_leg_static: leg-major, consecutive)
_Q_IDX = [[7 + 3 * l + k for l in range(NLEG)] for k in range(NLEV)]
_V_IDX = [[6 + 3 * l + k for l in range(NLEG)] for k in range(NLEV)]
_A_IDX = [[3 * l + k for l in range(NLEG)] for k in range(NLEV)]


def _step_impl(m, ls, ctrl, solver_iterations, ls_iterations,
               compute_sensors=True, dp=None):
    if dp is None:
        dp = DomainParams()
    h = m.timestep

    q_free = [ls.qpos[i] for i in range(7)]
    qv_free = [ls.qvel[i] for i in range(6)]
    q_leg = [ls.qpos[_Q_IDX[k]] for k in range(NLEV)]  # (4, B)
    qv_leg = [ls.qvel[_V_IDX[k]] for k in range(NLEV)]
    act_leg = [ls.act[_A_IDX[k]] for k in range(NLEV)]
    u0s = [_level_actuator(m, k) for k in range(NLEV)]
    ctrl_leg = [
        torch.clamp(ctrl[_A_IDX[k]],
                    _f(m.actuator_ctrlrange[u0s[k]][0]),
                    _f(m.actuator_ctrlrange[u0s[k]][1]))
        for k in range(NLEV)
    ]

    kin = _fk(m, q_free, q_leg)
    S_free, S_leg = _subspace(m, kin)
    v_base, v_leg = _body_velocities(m, S_free, S_leg, qv_free, qv_leg)
    I_base, I_leg = _inertias(m, kin, mass_scale=dp.base_mass_scale)
    Mff, Mfl, Mll = _crba(m, S_free, S_leg, I_base, I_leg)
    bias_free, bias_leg = _rne_bias(
        m, kin, S_free, S_leg, v_base, v_leg, qv_free, qv_leg, I_base, I_leg
    )
    qfrc_act, dvel_leg = _actuation(m, q_leg, qv_leg, act_leg,
                                    gain_scale=dp.gain_scale)
    damp_leg = _f(m.dof_damping[6])
    qf_free = [
        L.sub(L.mul(-_f(m.dof_damping[i]), qv_free[i]), bias_free[i])
        for i in range(6)
    ]
    qf_leg = [
        L.sub(L.sub(qfrc_act[k], L.mul(damp_leg, qv_leg[k])), bias_leg[k])
        for k in range(NLEV)
    ]

    fac = _ldl_factor(Mff, Mfl, Mll)
    qa_free, qa_leg = _ldl_solve(fac, qf_free, qf_leg)

    if solver_iterations > 0:
        plane_frame, plane_off = _plane(m, dp)
        slots = _collide_loop(m, kin, plane_frame, plane_off, dp=dp)
        rows = _make_rows(m, kin, S_free, S_leg, q_leg, qv_free, qv_leg,
                          slots, friction=dp.friction,
                          plane_frame=plane_frame)
        x_free, x_leg, _, _ = _newton_solve(
            m, Mff, Mfl, Mll, rows, qa_free, qa_leg,
            solver_iterations, ls_iterations,
        )
    else:
        x_free, x_leg = qa_free, qa_leg

    # sensors (pre-integration, base site only)
    if compute_sensors:
        g = _v3c(m.gravity)
        vJ_base = v_base[:3] + (
            L.sub(v_base[3], qv_free[0]),
            L.sub(v_base[4], qv_free[1]),
            L.sub(v_base[5], qv_free[2]),
        )
        cacc_base = (0.0, 0.0, 0.0, -g[0], -g[1], -g[2])
        for d in range(6):
            cacc_base = L.sv_add(cacc_base, L.sv_scale(x_free[d], S_free[d]))
        cacc_base = L.sv_add(cacc_base, L.motion_cross(v_base, vJ_base))
        sens = _sensors(m, kin, v_base, cacc_base, q_free, q_leg)
    else:
        sens = ls.sensordata

    # implicitfast: (M - h diag(D)) dv = h M qacc
    Mff_h, Mfl_h, Mll_h = dict(Mff), dict(Mfl), dict(Mll)
    for i in range(6):
        Dv = -_f(m.dof_damping[i])
        if Dv:
            Mff_h[(i, i)] = L.sub(Mff_h[(i, i)], h * Dv)
    for k in range(NLEV):
        Dv = L.add(-damp_leg, dvel_leg[k])
        Mll_h[(k, k)] = Mll_h[(k, k)] - h * Dv
    fac_h = _ldl_factor(Mff_h, Mfl_h, Mll_h)
    Mq_free, Mq_leg = _sym_matvec(Mff, Mfl, Mll, x_free, x_leg)
    dv_free, dv_leg = _ldl_solve(
        fac_h, [h * v for v in Mq_free], [h * v for v in Mq_leg]
    )
    qv_free_new = [qv_free[i] + dv_free[i] for i in range(6)]
    qv_leg_new = [qv_leg[k] + dv_leg[k] for k in range(NLEV)]

    # activation exact filter (shared tau)
    tau = max(_f(m.actuator_dynprm[u0s[0]][0]), 1e-12)
    coef = 1.0 - float(np.exp(-h / tau))
    act_new = [act_leg[k] + (ctrl_leg[k] - act_leg[k]) * coef
               for k in range(NLEV)]

    # integrate positions with the new velocity
    base_pos_new = [q_free[i] + h * qv_free_new[i] for i in range(3)]
    quat_new = L.quat_integrate(
        (q_free[3], q_free[4], q_free[5], q_free[6]),
        (qv_free_new[3], qv_free_new[4], qv_free_new[5]),
        h,
    )
    q_leg_new = [q_leg[k] + h * qv_leg_new[k] for k in range(NLEV)]

    # repack (leg-major row order: 7 + 3l + k)
    def pack_levels(levels):  # NLEV of (4, B) -> (12, B) rows 3l+k
        return torch.stack(
            [levels[k][l] for l in range(NLEG) for k in range(NLEV)]
        )

    qpos = torch.cat([torch.stack(base_pos_new + list(quat_new)),
                      pack_levels(q_leg_new)])
    qvel = torch.cat([torch.stack(qv_free_new), pack_levels(qv_leg_new)])
    act = pack_levels(act_new)
    return LaneState(qpos=qpos, qvel=qvel, act=act, time=ls.time + h,
                     sensordata=sens)


def step(m: PhysicsModel, ls: LaneState, ctrl: torch.Tensor,
         solver_iterations: int = 4, ls_iterations: int = 8,
         dp=None) -> LaneState:
    """One physics step (mj_step semantics), leg-batched. ``dp`` is an
    optional ``DomainParams`` of per-sample (B,) overrides."""
    return _step_impl(m, ls, ctrl, solver_iterations, ls_iterations, dp=dp)


def control_step(m: PhysicsModel, ls: LaneState, ctrl: torch.Tensor,
                 frame_skip: int, solver_iterations: int = 4,
                 ls_iterations: int = 8, dp=None) -> LaneState:
    """frame_skip substeps under constant control (sensors on the last)."""
    for _ in range(frame_skip - 1):
        ls = _step_impl(m, ls, ctrl, solver_iterations, ls_iterations,
                        compute_sensors=False, dp=dp)
    return _step_impl(m, ls, ctrl, solver_iterations, ls_iterations, dp=dp)
