"""Constraint-row assembly: joint limits + pyramidal contact friction cones.

Counterpart of ``quadruped_gym_tpu/physics/constraints.py``: MuJoCo's
soft-constraint model (Todorov's convex formulation):

  impedance: solimp sigmoid  d(r) = d0 + y(|r|/width) * (dmax - d0)
  K = 1 / (dmax^2 tc^2 dr^2),  B = 2 / (dmax tc)      (positive solref)
  aref_i = -B * (J qvel)_i - K * d_i * (pos_i - margin_i)
  diagApprox: limits -> dof_invweight0;  pyramidal contact rows ->
              2 * (invw_t[b1] + invw_t[b2]) * (1 + mu_i^2)
  R_i = max(mjMINVAL, (1 - d_i)/d_i * diagApprox_i),  D_i = 1/R_i

Fixed-capacity layout: one limit row per limited joint (the violated side
is selected with a sign) followed by 4 rows per contact slot. Inactive
rows get D = 0 so they vanish from the solver's objective without
changing shapes. Leading batch dims pass through.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.spec import JNT_HINGE, PhysicsModel
from . import maths
from .collision import Contacts
from .maths import matvec
from .smooth import Kin, consts


class ConstraintSet(NamedTuple):
    J: torch.Tensor  # (..., nrow, nv)
    aref: torch.Tensor  # (..., nrow)
    D: torch.Tensor  # (..., nrow) inverse-R with activity folded in (0 = off)
    active: torch.Tensor  # (..., nrow) bool
    pos: torch.Tensor  # (..., nrow) violation (dist), for introspection
    margin: torch.Tensor  # (..., nrow)


def impedance(solimp: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """MuJoCo solimp sigmoid. solimp rows: (d0, dmax, width, mid, power)."""
    d0, dmax, width, mid, power = (
        solimp[..., 0], solimp[..., 1], solimp[..., 2], solimp[..., 3], solimp[..., 4]
    )
    x = torch.clamp(torch.abs(r) / torch.clamp_min(width, 1e-15), 0.0, 1.0)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(
        x < mid,
        a * torch.pow(x, power),
        1.0 - b * torch.pow(1.0 - x, power),
    )
    return d0 + y * (dmax - d0)


def _limit_rows(m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor):
    """One row per limited joint; sign selects the violated side. The rows
    of all limited joints are built at once from the model's constants."""
    for j in range(m.njnt):
        assert not m.jnt_limited[j] or m.jnt_type[j] == JNT_HINGE
    c = consts(m, qpos.dtype, qpos.device)
    q = qpos[..., c.lim_qadr]
    d_lo = q - c.lim_lo
    d_hi = c.lim_hi - q
    lower_side = d_lo <= d_hi
    dist = torch.where(lower_side, d_lo, d_hi)
    sign = lower_side.to(qpos.dtype) * 2.0 - 1.0  # +1 lower side, -1 upper
    J = sign[..., None] * c.lim_onehot
    return J, dist, c.lim_margin, c.lim_solref, c.lim_solimp, c.lim_diag


def make_constraints(
    m: PhysicsModel,
    kin: Kin,
    S: torch.Tensor,
    con: Contacts,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    max_contacts: int = 24,
) -> ConstraintSet:
    dt, dev = qpos.dtype, qpos.device
    c = consts(m, dt, dev)
    batch = qpos.shape[:-1]

    # ---- joint limits ----
    Jl, pos_l, mar_l, solref_l, solimp_l, diag_l = _limit_rows(m, qpos, qvel)
    act_l = pos_l < mar_l

    # ---- select the deepest max_contacts slots ----
    # A stable descending sort keeps the lower slot among equal scores
    # (every inactive slot scores -inf), which is the order of the JAX
    # package's top_k; torch.topk promises no order among ties.
    nslots = con.dist.shape[-1]
    k = min(max_contacts, nslots)
    score = torch.where(con.active, -con.dist, -math.inf)
    idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]
    c_pos = torch.take_along_dim(con.pos, idx[..., None], dim=-2)
    c_dist = torch.take_along_dim(con.dist, idx, dim=-1)
    c_act = torch.take_along_dim(con.active, idx, dim=-1)
    c_body = con.body[idx]
    c_mu = con.friction[idx]
    c_solref = con.solref[idx]
    c_solimp = con.solimp[idx]
    c_margin = con.margin[idx]

    # ---- contact Jacobians ----
    # For a direction d:
    #   Jp . d = J_lin . d + (J_ang x rel) . d = S . [rel x d; d]
    # so each projected row is one (nv, 6) x (6,) contraction masked by
    # kinematic ancestry (body_dof_mask[b, i]: dof i moves body b).
    cmask = c.body_dof_mask[c_body]  # (..., k, nv)
    rel = c_pos - kin.origin[..., None, :]  # (..., k, 3)
    n, t1, t2 = con.frame[0], con.frame[1], con.frame[2]
    St = S.transpose(-1, -2)

    def proj(d):
        q = torch.cat([maths.cross(rel, d), d.expand(rel.shape)], dim=-1)
        # (..., k, 6) = [rel x d; d] in S's [ang; lin] column order
        return cmask * (q @ St)

    Jn = proj(n)  # (..., k, nv)
    Jt1 = proj(t1)
    Jt2 = proj(t2)
    # pyramidal facets: [n + mu t1, n - mu t1, n + mu t2, n - mu t2]
    mu = c_mu[..., None]
    Jc = torch.stack(
        [Jn + mu * Jt1, Jn - mu * Jt1, Jn + mu * Jt2, Jn - mu * Jt2], dim=-2
    )  # (..., k, 4, nv)
    Jc = Jc.reshape(batch + (k * 4, m.nv))

    def rep4(x, dim=-1):
        return torch.repeat_interleave(x, 4, dim=dim)

    def lim(x):  # a limit-row constant, given the batch dims
        return x.expand(batch + x.shape)

    pos_c = rep4(c_dist)
    mar_c = rep4(c_margin)
    act_c = rep4(c_act)
    solref_c = rep4(c_solref, dim=-2)
    solimp_c = rep4(c_solimp, dim=-2)
    # world body invweight0 is 0
    diag_c = rep4(2.0 * c.body_invweight[c_body] * (1.0 + c_mu**2))

    # ---- assemble ----
    J = torch.cat([Jl, Jc], dim=-2)
    pos = torch.cat([pos_l, pos_c], dim=-1)
    margin = torch.cat([lim(mar_l), mar_c], dim=-1)
    active = torch.cat([act_l, act_c], dim=-1)
    solref = torch.cat([lim(solref_l), solref_c], dim=-2)
    solimp = torch.cat([lim(solimp_l), solimp_c], dim=-2)
    diagA = torch.cat([lim(diag_l), diag_c], dim=-1)

    r = pos - margin
    imp = impedance(solimp, r)
    tc, dr = solref[..., 0], solref[..., 1]
    dmax = solimp[..., 1]
    # positive solref: spring-damper parametrization
    K = 1.0 / torch.clamp_min(dmax**2 * tc**2 * dr**2, 1e-15)
    B = 2.0 / torch.clamp_min(dmax * tc, 1e-15)
    # negative solref: direct (stiffness, damping) = (-tc, -dr)
    K = torch.where(tc > 0, K, -tc)
    B = torch.where(tc > 0, B, -dr)

    vel = matvec(J, qvel)
    aref = -B * vel - K * imp * r
    R = torch.clamp_min((1.0 - imp) / imp * diagA, 1e-15)
    D = torch.where(active, 1.0 / R, torch.zeros_like(R))

    return ConstraintSet(J=J, aref=aref, D=D, active=active, pos=pos, margin=margin)
