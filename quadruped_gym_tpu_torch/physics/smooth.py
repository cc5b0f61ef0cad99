"""Smooth (constraint-free) rigid-body dynamics in plain PyTorch.

Counterpart of ``quadruped_gym_tpu/physics/smooth.py``: what MuJoCo's C
engine computes inside ``mj_step`` before the constraint solver.

  * the kinematic tree is *static* topology (host tuples on
    ``PhysicsModel``), so the loops below are Python loops over the
    model's bodies and joints;
  * spatial algebra uses 6-vectors ``[angular; linear]`` measured at the
    floating base (``Kin.origin``), which keeps lever arms ~0.3 m and the
    engine float32-safe far from the world origin.

Every function takes any leading batch dims: ``qpos (..., nq)``,
``M (..., nv, nv)``. With none it is the per-sample function; with some
it is what ``jax.vmap`` makes of the JAX function. The model's arrays
live on the device as ``consts(m, dtype, device)``, made once per model,
dtype and device.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch
from torch._functorch.pyfunctorch import temporarily_clear_interpreter_stack

from ..models.spec import JNT_FREE, JNT_HINGE, PhysicsModel
from . import maths
from .maths import matvec


class Kin(NamedTuple):
    """Forward-kinematics results (world frame)."""

    xpos: torch.Tensor  # (..., nbody, 3) body frame origins
    xquat: torch.Tensor  # (..., nbody, 4)
    xmat: torch.Tensor  # (..., nbody, 3, 3)
    xipos: torch.Tensor  # (..., nbody, 3) com positions
    ximat: torch.Tensor  # (..., nbody, 3, 3) inertial frames
    origin: torch.Tensor  # (..., 3) spatial-algebra origin (robot base position)


# --- the model's arrays on the device --------------------------------------


def _dof_bodies(m: PhysicsModel):
    out = []
    for b in range(1, m.nbody):
        out += [b] * m.body_dofnum[b]
    return out


def _ancestors(m: PhysicsModel) -> np.ndarray:
    """anc[x, b] true iff body x is b or one of its ancestors (world
    excluded)."""
    anc = np.zeros((m.nbody, m.nbody), dtype=bool)
    for b in range(m.nbody):
        x = b
        while x != 0:
            anc[x, b] = True
            x = m.body_parentid[x]
    return anc


def _ancestor_dof_mask(m: PhysicsModel) -> np.ndarray:
    """mask[i, j] true iff dof i belongs to an ancestor-or-self body of dof
    j's body (static; computed once per model on the host)."""
    dof_body = np.asarray(_dof_bodies(m))
    return _ancestors(m)[dof_body[:, None], dof_body[None, :]]


def _actuator_maps(m: PhysicsModel):
    """Static gather/scatter indices: actuator -> (qposadr, dofadr)."""
    qadr = np.asarray([m.jnt_qposadr[j] for j in m.actuator_trnid])
    dadr = np.asarray([m.jnt_dofadr[j] for j in m.actuator_trnid])
    return qadr, dadr


def consts(m: PhysicsModel, dtype, device) -> types.SimpleNamespace:
    """Every array of ``m`` the engine reads, as tensors of ``dtype`` on
    ``device`` (index arrays as int64, masks as bool), uploaded once per
    (model, dtype, device), cached on ``m`` and shared by every later
    call; the tensors go when the model does."""
    cache = m.__dict__.setdefault("_consts_cache", {})
    key = (dtype, torch.device(device))
    if key not in cache:
        # built with every ``torch.func`` transform popped: a tensor made
        # under the first caller's transform would be wrapped at its level
        # and escape through the cache into later calls at other levels
        with temporarily_clear_interpreter_stack():
            cache[key] = _build_consts(m, dtype, device)
    return cache[key]


def _build_consts(m: PhysicsModel, dtype, device) -> types.SimpleNamespace:
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def mask(x):
        return torch.as_tensor(np.asarray(x, np.bool_), device=device)

    qadr, dadr = _actuator_maps(m)
    limited = [j for j in range(m.njnt) if m.jnt_limited[j]]
    lim_dadr = [m.jnt_dofadr[j] for j in limited]
    dof_body = _dof_bodies(m)
    anc = _ancestors(m)
    rep3 = lambda arr: np.repeat(np.asarray(arr), 3, axis=0)  # noqa: E731
    c = types.SimpleNamespace(
        quat_identity=f([1.0, 0.0, 0.0, 0.0]),
        eye3=f(np.eye(3)),
        body_pos=f(m.body_pos), body_quat=f(m.body_quat),
        body_ipos=f(m.body_ipos), body_mass=f(m.body_mass),
        body_inertia=f(m.body_inertia),
        qpos0=f(m.qpos0), jnt_pos=f(m.jnt_pos), jnt_axis=f(m.jnt_axis),
        gravity=f(m.gravity),
        armature_diag=f(np.diag(np.asarray(m.dof_armature))),
        dof_damping=f(m.dof_damping),
        ancestor_dof_mask=mask(_ancestor_dof_mask(m)),
        # actuators
        act_qadr=idx(qadr), act_dadr=idx(dadr),
        gear=f(m.actuator_gear),
        gain0=f(m.actuator_gainprm[:, 0]),
        bias0=f(m.actuator_biasprm[:, 0]), bias1=f(m.actuator_biasprm[:, 1]),
        bias2=f(m.actuator_biasprm[:, 2]),
        force_lo=f(m.actuator_forcerange[:, 0]),
        force_hi=f(m.actuator_forcerange[:, 1]),
        ctrl_lo=f(m.actuator_ctrlrange[:, 0]),
        ctrl_hi=f(m.actuator_ctrlrange[:, 1]),
        act_tau=f(np.maximum(m.actuator_dynprm[:, 0], 1e-12)),
        # site
        site_pos=f(m.site_pos),
        # collision
        plane_normal=f(m.plane_normal),
        col_geom_pos=f(m.col_geom_pos),
        col_hull_verts=[f(v) for v in m.col_hull_verts],
        col_hull_vnorm2=[f(np.sum(np.asarray(v) ** 2, axis=1))
                         for v in m.col_hull_verts],
        con_body=idx(rep3(np.asarray(m.col_geom_bodyid))),
        con_friction=f(rep3(m.col_friction[:, 0])),
        con_solref=f(rep3(m.col_solref)),
        con_solimp=f(rep3(m.col_solimp)),
        con_margin=f(rep3(m.col_margin - m.col_gap)),
        # joint limits, one row per limited joint
        lim_qadr=idx([m.jnt_qposadr[j] for j in limited]),
        lim_lo=f([m.jnt_range[j][0] for j in limited]),
        lim_hi=f([m.jnt_range[j][1] for j in limited]),
        lim_onehot=f(np.eye(m.nv)[lim_dadr].reshape(len(limited), m.nv)),
        lim_margin=f([m.jnt_margin[j] for j in limited]),
        lim_solref=f(np.asarray([m.jnt_solref[j] for j in limited])
                     .reshape(len(limited), 2)),
        lim_solimp=f(np.asarray([m.jnt_solimp[j] for j in limited])
                     .reshape(len(limited), 5)),
        lim_diag=f(np.asarray(m.dof_invweight0)[lim_dadr]),
        # (nbody, nv): dof i moves body b
        body_dof_mask=f(anc[np.asarray(dof_body)].T),
        body_invweight=f(m.body_invweight0[:, 0]),
    )
    # products of constants, made on the device in the engine's dtype as the
    # JAX package makes them at trace time
    c.body_imat = maths.quat_to_mat(f(m.body_iquat))
    c.col_geom_mat = maths.quat_to_mat(f(m.col_geom_quat))
    c.site_mat = maths.quat_to_mat(f(m.site_quat))
    return c


def _consts_like(m: PhysicsModel, x: torch.Tensor) -> types.SimpleNamespace:
    return consts(m, x.dtype, x.device)


# --- kinematics -------------------------------------------------------------


def fwd_position(m: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """Forward kinematics (mj_kinematics semantics: a hinge rotates its body
    about the joint anchor by ``qpos - qpos0``; the free joint sets the frame
    directly from qpos)."""
    c = _consts_like(m, qpos)
    nb = m.nbody
    batch = qpos.shape[:-1]

    xpos = [qpos.new_zeros(batch + (3,))] * nb
    xquat = [c.quat_identity.expand(batch + (4,))] * nb

    for b in range(1, nb):
        p = m.body_parentid[b]
        jadr = m.body_jntadr[b]
        if jadr >= 0 and m.jnt_type[jadr] == JNT_FREE:
            qadr = m.jnt_qposadr[jadr]
            xpos[b] = qpos[..., qadr: qadr + 3]
            xquat[b] = maths.quat_normalize(qpos[..., qadr + 3: qadr + 7])
            continue
        pos = xpos[p] + maths.quat_rotate(xquat[p], c.body_pos[b])
        quat = maths.quat_mul(xquat[p], c.body_quat[b])
        for k in range(m.body_jntnum[b]):
            j = jadr + k
            assert m.jnt_type[j] == JNT_HINGE, "engine supports free+hinge"
            qadr = m.jnt_qposadr[j]
            angle = qpos[..., qadr] - c.qpos0[qadr]
            local_anchor = c.jnt_pos[j]
            anchor_w = pos + maths.quat_rotate(quat, local_anchor)
            quat = maths.quat_mul(
                quat, maths.axis_angle_to_quat(c.jnt_axis[j], angle)
            )
            pos = anchor_w - maths.quat_rotate(quat, local_anchor)
        xpos[b] = pos
        xquat[b] = quat

    xpos = torch.stack(xpos, dim=-2)
    xquat = torch.stack(xquat, dim=-2)
    xmat = maths.quat_to_mat(xquat)
    xipos = xpos + matvec(xmat, c.body_ipos)
    ximat = xmat @ c.body_imat
    # Spatial-algebra origin: the floating base position. Measuring spatial
    # vectors at the world origin is exact in float64 but cancels
    # catastrophically in float32 once |xpos| >> robot size (terms scale
    # like m|p|^2). Re-origining at the base keeps lever arms ~0.3 m.
    origin = xpos[..., _root_body(m), :]
    return Kin(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        origin=origin,
    )


def _root_body(m: PhysicsModel) -> int:
    """First body hanging off the world (the floating base)."""
    for b in range(1, m.nbody):
        if m.body_parentid[b] == 0:
            return b
    return 0


def dof_subspace(m: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Motion subspace S: (..., nv, 6) spatial vectors
    [angular; linear-at-origin].

    MuJoCo free-joint conventions: translational dofs are world-aligned,
    rotational dofs act about the body frame origin with body-local axes.
    Hinge dofs act about the (world) joint anchor/axis.
    """
    c = _consts_like(m, kin.xpos)
    batch = kin.xpos.shape[:-2]
    rows = []
    for j in range(m.njnt):
        b = m.jnt_bodyid[j]
        xmat_b = kin.xmat[..., b, :, :]
        if m.jnt_type[j] == JNT_FREE:
            zero = kin.xpos.new_zeros(batch + (3,))
            for k in range(3):
                rows.append(torch.cat(
                    [zero, c.eye3[k].expand(batch + (3,))], dim=-1))
            p = kin.xpos[..., b, :] - kin.origin
            for k in range(3):
                a = xmat_b[..., :, k]  # body axis k in world
                rows.append(torch.cat([a, maths.cross(p, a)], dim=-1))
        else:
            anchor = (
                kin.xpos[..., b, :] + matvec(xmat_b, c.jnt_pos[j]) - kin.origin
            )
            axis = matvec(xmat_b, c.jnt_axis[j])
            rows.append(torch.cat([axis, maths.cross(anchor, axis)], dim=-1))
    return torch.stack(rows, dim=-2)  # (..., nv, 6)


def _dof_sum(S: torch.Tensor, q: torch.Tensor, da: int, dn: int) -> torch.Tensor:
    """S[da:da+dn].T @ q[da:da+dn] over the last axes: (..., 6)."""
    return matvec(S[..., da: da + dn, :].transpose(-1, -2), q[..., da: da + dn])


def body_velocities(m: PhysicsModel, S: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Spatial velocity of each body at the origin: (..., nbody, 6)."""
    v = [qvel.new_zeros(qvel.shape[:-1] + (6,))] * m.nbody
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        v[b] = v[p] + _dof_sum(S, qvel, m.body_dofadr[b], m.body_dofnum[b])
    return torch.stack(v, dim=-2)


def _body_spatial_inertias(m: PhysicsModel, kin: Kin) -> torch.Tensor:
    """(..., nbody, 6, 6) spatial inertia of every body at ``kin.origin``
    (row 0, the massless world, is zero)."""
    c = _consts_like(m, kin.xpos)
    return maths.spatial_inertia_world(
        c.body_mass, c.body_inertia, kin.ximat,
        kin.xipos - kin.origin[..., None, :],
    )


def _subtree_children(m: PhysicsModel):
    ch = {b: [] for b in range(m.nbody)}
    for b in range(1, m.nbody):
        ch[m.body_parentid[b]].append(b)
    return ch


def crba(m: PhysicsModel, kin: Kin, S: torch.Tensor) -> torch.Tensor:
    """Composite-rigid-body mass matrix M (..., nv, nv), armature included."""
    c = _consts_like(m, kin.xpos)
    children = _subtree_children(m)
    inertias = _body_spatial_inertias(m, kin)
    Ic = [None] * m.nbody
    for b in range(m.nbody - 1, 0, -1):  # leaf-to-root accumulation
        I = inertias[..., b, :, :]
        for ch in children[b]:
            I = I + Ic[ch]
        Ic[b] = I

    # F_j = Ic[body(j)] @ S_j ; CRBA: M[i, j] = S_i . F_j for i ancestor of j
    Icd = torch.stack([Ic[b] for b in _dof_bodies(m)], dim=-3)
    F = matvec(Icd, S)  # (..., nv, 6)
    M_full = S @ F.transpose(-1, -2)
    mask = c.ancestor_dof_mask
    M = torch.where(mask, M_full,
                    torch.where(mask.T, M_full.transpose(-1, -2),
                                torch.zeros_like(M_full)))
    return M + c.armature_diag


def _joint_bias_velocity(
    m: PhysicsModel, qvel: torch.Tensor, cvel: torch.Tensor, b: int
) -> torch.Tensor:
    """The part of the joint velocity v_b - v_p whose motion subspace rotates
    with a body (so that S-dot = v_b x S). Free-joint *translational* axes are
    world-fixed (S-dot = 0) and must be excluded from the velocity-product
    term."""
    p = m.body_parentid[b]
    vJ = cvel[..., b, :] - cvel[..., p, :]
    jadr = m.body_jntadr[b]
    if jadr >= 0 and m.jnt_type[jadr] == JNT_FREE:
        da = m.body_dofadr[b]
        lin = torch.cat([qvel.new_zeros(qvel.shape[:-1] + (3,)),
                         qvel[..., da: da + 3]], dim=-1)
        vJ = vJ - lin
    return vJ


def _gravity_base(m: PhysicsModel, like: torch.Tensor, on: bool = True):
    """(..., 6) spatial acceleration of the world: [0; -g], or zeros."""
    g = _consts_like(m, like).gravity
    base = torch.cat([torch.zeros_like(g), -g if on else 0 * g])
    return base.expand(like.shape[:-1] + (6,))


def rne_bias(
    m: PhysicsModel,
    kin: Kin,
    S: torch.Tensor,
    cvel: torch.Tensor,
    qvel: torch.Tensor,
) -> torch.Tensor:
    """Bias force C(q, v)·v + gravity term (matches mjData.qfrc_bias)."""
    children = _subtree_children(m)

    acc = [_gravity_base(m, qvel)] * m.nbody
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        # qacc = 0: only the S-dot velocity-product term remains
        acc[b] = acc[p] + maths.motion_cross(
            cvel[..., b, :], _joint_bias_velocity(m, qvel, cvel, b)
        )
    acc = torch.stack(acc, dim=-2)

    Ib = _body_spatial_inertias(m, kin)
    f = matvec(Ib, acc) + maths.force_cross(cvel, matvec(Ib, cvel))
    fsub = [None] * m.nbody
    for b in range(m.nbody - 1, 0, -1):
        fb = f[..., b, :]
        for ch in children[b]:
            fb = fb + fsub[ch]
        fsub[b] = fb

    fd = torch.stack([fsub[b] for b in _dof_bodies(m)], dim=-2)  # (..., nv, 6)
    return torch.sum(S * fd, dim=-1)


def body_accelerations(
    m: PhysicsModel,
    S: torch.Tensor,
    cvel: torch.Tensor,
    qvel: torch.Tensor,
    qacc: torch.Tensor,
    gravity_offset: bool = True,
) -> torch.Tensor:
    """Spatial accelerations (..., nbody, 6) at the origin given qacc.

    With ``gravity_offset`` the base 'accelerates' at -g, which makes the
    result a *proper* acceleration — exactly what an accelerometer measures
    (MuJoCo's cacc convention in mj_comAcc/mj_sensorAcc).
    """
    acc = [_gravity_base(m, qvel, gravity_offset)] * m.nbody
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        ab = acc[p] + _dof_sum(S, qacc, m.body_dofadr[b], m.body_dofnum[b])
        ab = ab + maths.motion_cross(
            cvel[..., b, :], _joint_bias_velocity(m, qvel, cvel, b)
        )
        acc[b] = ab
    return torch.stack(acc, dim=-2)


# --- actuation -----------------------------------------------------------


class Actuation(NamedTuple):
    force: torch.Tensor  # (..., nu) clamped scalar actuator forces
    qfrc: torch.Tensor  # (..., nv)
    vel_deriv: torch.Tensor  # (..., nv) diag d(qfrc)/d(qvel) for implicitfast


def actuation(
    m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor, act: torch.Tensor
) -> Actuation:
    """Position-servo forces (gaintype=fixed, biastype=affine, joint
    transmission): force = clamp(kp*act - kp*len - kv*vel), len = gear*q.
    """
    c = _consts_like(m, qpos)
    q = qpos[..., c.act_qadr]
    v = qvel[..., c.act_dadr]
    length = c.gear * q
    velocity = c.gear * v
    force = c.gain0 * act + (c.bias0 + c.bias1 * length + c.bias2 * velocity)
    clamped_force = torch.clamp(force, c.force_lo, c.force_hi)
    zeros = qvel.new_zeros(qvel.shape[:-1] + (m.nv,))
    qfrc = zeros.index_add(-1, c.act_dadr, c.gear * clamped_force)

    # d(qfrc)/d(qvel): gear^2 * biasprm[2], zeroed where the force saturates
    # (mjd_actuator_vel semantics).
    in_range = (force > c.force_lo) & (force < c.force_hi)
    gain = c.gear * c.gear * c.bias2
    dvel = zeros.index_add(
        -1, c.act_dadr, torch.where(in_range, gain, torch.zeros_like(gain)))
    return Actuation(force=clamped_force, qfrc=qfrc, vel_deriv=dvel)


def passive_force(m: PhysicsModel, qvel: torch.Tensor) -> torch.Tensor:
    return -_consts_like(m, qvel).dof_damping * qvel


def act_filter_exact(
    m: PhysicsModel, act: torch.Tensor, ctrl: torch.Tensor, h: float
) -> torch.Tensor:
    """Exact first-order filter activation update (dyntype=filterexact)."""
    tau = _consts_like(m, act).act_tau
    return act + (ctrl - act) * (1.0 - torch.exp(-h / tau))


def clip_ctrl(m: PhysicsModel, ctrl: torch.Tensor) -> torch.Tensor:
    c = _consts_like(m, ctrl)
    return torch.clamp(ctrl, c.ctrl_lo, c.ctrl_hi)


# --- site (IMU) kinematics ----------------------------------------------


class SiteFrame(NamedTuple):
    pos: torch.Tensor  # (..., 3)
    mat: torch.Tensor  # (..., 3, 3)


def site_frame(m: PhysicsModel, kin: Kin) -> SiteFrame:
    c = _consts_like(m, kin.xpos)
    b = m.site_bodyid
    xmat_b = kin.xmat[..., b, :, :]
    pos = kin.xpos[..., b, :] + matvec(xmat_b, c.site_pos)
    mat = xmat_b @ c.site_mat
    return SiteFrame(pos=pos, mat=mat)
