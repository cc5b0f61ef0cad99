"""Plane-convex collision detection, batched and branch-free.

Counterpart of ``quadruped_gym_tpu/physics/collision.py``: the robot's
convex mesh geoms against the ground plane, the only pairs the scene
produces.

Behavioral contract (reverse-engineered from CPU MuJoCo 3.10 by the JAX
package):
  * the deepest ("support") hull vertex yields a contact iff its height above
    the plane is < margin; contact pos is the midpoint between the vertex and
    its plane projection, dist = height;
  * additional vertices (height < 2*margin) can yield up to 2 more contacts,
    chosen by a farthest-point-then-farthest-from-line rule with per-mesh
    calibrated acceptance distances;
  * contacts only become constraints when dist < includemargin.

Shapes are fixed (3 slots per geom) with activity masks. ``argmin`` and
``argmax`` return the first index among ties here as in the JAX package,
and masked-out candidates score -1, below every distance, so the chosen
vertices are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.spec import PhysicsModel
from . import maths
from .maths import matvec
from .smooth import Kin, consts


class Contacts(NamedTuple):
    """Fixed-capacity contact set: n = ncol*3 slots (3 per collidable
    geom). ``pos``, ``dist`` and ``active`` carry the caller's batch dims;
    the per-slot constants are shared by the whole batch."""

    pos: torch.Tensor  # (..., n, 3) world contact positions
    dist: torch.Tensor  # (..., n) signed distances (height of the vertex)
    active: torch.Tensor  # (..., n) bool — becomes a constraint row
    body: torch.Tensor  # (n,) int64 body id of the robot geom
    friction: torch.Tensor  # (n,) tangential friction
    solref: torch.Tensor  # (n, 2)
    solimp: torch.Tensor  # (n, 5)
    margin: torch.Tensor  # (n,) includemargin
    frame: torch.Tensor  # (3, 3) shared contact frame rows [n; t1; t2]


def plane_frame(m: PhysicsModel, dtype, device) -> torch.Tensor:
    """Contact frame rows [normal; tangent1; tangent2], MuJoCo's
    mju_makeFrame convention (for n=+z: t1=(0,1,0), t2=(-1,0,0)). Kept
    with the model's other device constants."""
    c = consts(m, dtype, device)
    if not hasattr(c, "plane_frame"):
        n = np.asarray(m.plane_normal, dtype=np.float64)
        ref = (np.array([1.0, 0, 0]) if abs(n[0]) < 0.9
               else np.array([0.0, 1, 0]))
        t1 = np.cross(n, ref)
        t1 = t1 / np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        c.plane_frame = torch.as_tensor(np.stack([n, t1, t2]), dtype=dtype,
                                        device=device)
    return c.plane_frame


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] for an index tensor i of x's batch shape."""
    return torch.take_along_dim(x, i[..., None], dim=-1)[..., 0]


def collide(m: PhysicsModel, kin: Kin) -> Contacts:
    """Generate plane contacts for every collidable geom (3 slots each).

    Every per-vertex quantity is a (..., V) array built from
    ``verts @ <3-vector>`` contractions. Geom rotations are orthonormal, so
    ``|w_i - w_j| == |v_i - v_j|`` and in-plane distances reduce to static
    vertex-space norms plus height corrections.
    """
    dt, dev = kin.xpos.dtype, kin.xpos.device
    c = consts(m, dt, dev)
    n = c.plane_normal
    plane_off = float(np.dot(m.plane_normal, m.plane_pos))

    pos, dist, active = [], [], []
    ncol = len(m.col_geom_bodyid)
    for k in range(ncol):
        b = m.col_geom_bodyid[k]
        xmat_b = kin.xmat[..., b, :, :]
        gpos = kin.xpos[..., b, :] + matvec(xmat_b, c.col_geom_pos[k])
        gmat = xmat_b @ c.col_geom_mat[k]
        gmat_t = gmat.transpose(-1, -2)
        verts = c.col_hull_verts[k]  # (V, 3) static constant
        vnorm2 = c.col_hull_vnorm2[k]  # (V,) static
        # (..., V) heights
        h = matvec(verts, matvec(gmat_t, n)) + (gpos @ n - plane_off)[..., None]

        margin = float(m.col_margin[k])
        theta2 = float(m.col_theta2[k])
        theta3 = float(m.col_theta3[k])

        i0 = torch.argmin(h, dim=-1)
        h0 = _pick(h, i0)
        v0 = verts[i0]  # (..., 3) local support vertex
        p0 = gpos + matvec(gmat, v0)
        a0 = h0 < margin

        # candidates for extra points: height < 2*margin (oracle-calibrated)
        cand = h < 2.0 * margin
        # in-plane distance from support: |u_plan|^2 = |w - p0|^2 - (h-h0)^2
        # and |w - p0|^2 = |v - v0|^2 (rotation preserves norms)
        dv2 = (vnorm2 - 2.0 * matvec(verts, v0)
               + torch.sum(v0 * v0, dim=-1, keepdim=True))
        dplan = torch.sqrt(torch.clamp_min(dv2 - (h - h0[..., None]) ** 2, 0.0))
        d_masked = torch.where(cand, dplan, -1.0)
        i1 = torch.argmax(d_masked, dim=-1)
        d1 = _pick(d_masked, i1)
        a1 = a0 & (d1 >= theta2)
        v1 = verts[i1]
        p1 = gpos + matvec(gmat, v1)
        h1 = _pick(h, i1)

        # third point: farthest from the support->second line (in plane)
        u1 = matvec(gmat, v1 - v0)  # = w1 - p0
        t = (u1 - (h1 - h0)[..., None] * n) / torch.clamp_min(d1, 1e-12)[..., None]
        perp = maths.cross(n, t)
        # u_plan @ perp == (w - p0) @ perp   (n @ perp == 0)
        #              == (v - v0) @ (gmat.T @ perp)
        g = matvec(gmat_t, perp)
        c_masked = torch.where(
            cand,
            torch.abs(matvec(verts, g)
                      - torch.sum(v0 * g, dim=-1, keepdim=True)),
            -1.0)
        i2 = torch.argmax(c_masked, dim=-1)
        a2 = a1 & (_pick(c_masked, i2) >= theta3)
        v2 = verts[i2]
        p2 = gpos + matvec(gmat, v2)
        h2 = _pick(h, i2)

        # constraints require dist < includemargin (margin - gap)
        inc = float(m.col_margin[k] - m.col_gap[k])
        for (pi, hi, ai) in ((p0, h0, a0), (p1, h1, a1), (p2, h2, a2)):
            pos.append(pi - 0.5 * hi[..., None] * n)  # midpoint convention
            dist.append(hi)
            active.append(ai & (hi < inc))

    return Contacts(
        pos=torch.stack(pos, dim=-2),
        dist=torch.stack(dist, dim=-1),
        active=torch.stack(active, dim=-1),
        body=c.con_body,
        friction=c.con_friction,
        solref=c.con_solref,
        solimp=c.con_solimp,
        margin=c.con_margin,
        frame=plane_frame(m, dt, dev),
    )
