"""The leg engine the operation counts of a model with collision groups
on the base (``full``: the hip servos and the frame) run through: the
frozen reference's leg engine (``benchmark/reference/leg_engine.py``,
which refuses such a model), loaded afresh, with the four functions that
base groups change replaced by those below. They are the port's
``ops/leg_engine.py`` as the ``full-4x8`` configuration's counts were
frozen from it, and they stay so: the yardstick does not follow later
changes to the port. It counts; no check steps it.

Replaced: ``_leg_static`` (the base's groups, ``_base_groups``),
``_geom_frame`` (a ``BASE`` member's own frame), ``_collide_loop``
(a ``BASE_ONE`` slot in leg 0's lanes, ``_leg0_only``) and ``_make_rows``
(a base group's rows touch only the free dofs). Everything else is the
frozen reference's own code.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "benchmark.reference._leg_engine_with_base_groups",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "reference", "leg_engine.py"))
_engine = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = _engine  # its dataclasses look their module up
_spec.loader.exec_module(_engine)
globals().update({k: v for k, v in vars(_engine).items()
                  if not k.startswith("__")})

# the level of a collision group on the base: one geom a leg, each with
# its own frame (BASE), or one geom that no leg carries (BASE_ONE)
BASE = -1
BASE_ONE = -2

def _leg_static(m: PhysicsModel) -> _LegStatic:
    # cached under a name of its own: the frozen engine's cache on the same
    # model object must still refuse it
    cached = getattr(m, "_leg_static_base_groups", None)
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
    object.__setattr__(m, "_leg_static_base_groups", s)
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


_engine.BASE, _engine.BASE_ONE = BASE, BASE_ONE
for _name in ("_leg_static", "_geom_frame", "_collide_loop", "_make_rows"):
    setattr(_engine, _name, globals()[_name])
