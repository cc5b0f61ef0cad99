# Frozen copy of quadruped_gym_tpu_torch/ops/lane.py for the benchmark's plain
# reference: the same code, with its imports pointed at this folder. Later
# changes to the port do not reach it.
"""Lane-batched ("structure-of-arrays") math primitives with static folding.

Counterpart of ``quadruped_gym_tpu/ops/lane.py``. The batch is the minor
dim of every tensor: a per-robot scalar is a (B,) (or (4, B)) lane tensor,
a vec3 a tuple of three, a quaternion a tuple of four, a matrix a nested
tuple. Small-dimension loops unroll in Python.

**Static folding**: a lane scalar may also be a Python ``float`` — a
model constant. The model is full of exact zeros and ones (world-aligned
joint axes, identity body quats, plane frames), so the helpers fold
``0 * x``, ``x + 0``, ``1 * x`` and const-const ops, exactly as the JAX
package does, which keeps the two engines' operation sequences alike.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]
Vec3 = Tuple  # (x, y, z) of lane scalars
Quat = Tuple  # (w, x, y, z)
Mat3 = Tuple  # nested 3x3


def is_static(x) -> bool:
    return isinstance(x, (int, float))


def mul(a: Scalar, b: Scalar) -> Scalar:
    if is_static(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return neg(b)
        if is_static(b):
            return float(a * b)
        return float(a) * b
    if is_static(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return neg(a)
        return a * float(b)
    return a * b


def add(a: Scalar, b: Scalar) -> Scalar:
    if is_static(a):
        if a == 0.0:
            return b
        if is_static(b):
            return float(a + b)
        return float(a) + b
    if is_static(b):
        if b == 0.0:
            return a
        return a + float(b)
    return a + b


def sub(a: Scalar, b: Scalar) -> Scalar:
    if is_static(b):
        if b == 0.0:
            return a
        if is_static(a):
            return float(a - b)
        return a - float(b)
    if is_static(a):
        if a == 0.0:
            return neg(b)
        return float(a) - b
    return a - b


def neg(a: Scalar) -> Scalar:
    return float(-a) if is_static(a) else -a


def sqrt(a: Scalar) -> Scalar:
    return math.sqrt(a) if is_static(a) else torch.sqrt(a)


def maximum(a: Scalar, lo: float) -> Scalar:
    return max(a, lo) if is_static(a) else torch.clamp_min(a, lo)


def as_lane(x: Scalar, like: torch.Tensor) -> torch.Tensor:
    """Materialize a possibly-static scalar as a lane tensor."""
    return torch.full_like(like, x) if is_static(x) else x


def stack_lanes(xs: Sequence[Scalar], like: torch.Tensor) -> torch.Tensor:
    return torch.stack([as_lane(x, like) for x in xs])


def v3(x, y, z) -> Vec3:
    return (x, y, z)


def v3_add(a: Vec3, b: Vec3) -> Vec3:
    return (add(a[0], b[0]), add(a[1], b[1]), add(a[2], b[2]))


def v3_sub(a: Vec3, b: Vec3) -> Vec3:
    return (sub(a[0], b[0]), sub(a[1], b[1]), sub(a[2], b[2]))


def v3_scale(s, a: Vec3) -> Vec3:
    return (mul(s, a[0]), mul(s, a[1]), mul(s, a[2]))


def v3_dot(a: Vec3, b: Vec3):
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]))


def v3_cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    )


def v3_norm(a: Vec3, eps=1e-30):
    return sqrt(maximum(v3_dot(a, a), eps))


def quat_mul(a: Quat, b: Quat) -> Quat:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        sub(sub(sub(mul(aw, bw), mul(ax, bx)), mul(ay, by)), mul(az, bz)),
        sub(add(add(mul(aw, bx), mul(ax, bw)), mul(ay, bz)), mul(az, by)),
        add(add(sub(mul(aw, by), mul(ax, bz)), mul(ay, bw)), mul(az, bx)),
        add(sub(add(mul(aw, bz), mul(ax, by)), mul(ay, bx)), mul(az, bw)),
    )


def quat_normalize(q: Quat, eps=1e-15) -> Quat:
    n2 = add(
        add(mul(q[0], q[0]), mul(q[1], q[1])),
        add(mul(q[2], q[2]), mul(q[3], q[3])),
    )
    inv = 1.0 / maximum(sqrt(n2), eps)
    return tuple(mul(inv, c) for c in q)


def quat_rotate(q: Quat, v: Vec3) -> Vec3:
    """v' = v + 2 w (u x v) + 2 u x (u x v)   (body-local -> world)."""
    w = q[0]
    u = (q[1], q[2], q[3])
    uv = v3_cross(u, v)
    uuv = v3_cross(u, uv)
    return tuple(
        add(v[i], mul(2.0, add(mul(w, uv[i]), uuv[i]))) for i in range(3)
    )


def quat_to_mat(q: Quat) -> Mat3:
    w, x, y, z = q

    def two(a, b):
        return mul(2.0, mul(a, b))

    return (
        (sub(1.0, add(two(y, y), two(z, z))), sub(two(x, y), two(w, z)),
         add(two(x, z), two(w, y))),
        (add(two(x, y), two(w, z)), sub(1.0, add(two(x, x), two(z, z))),
         sub(two(y, z), two(w, x))),
        (sub(two(x, z), two(w, y)), add(two(y, z), two(w, x)),
         sub(1.0, add(two(x, x), two(y, y)))),
    )


def axis_angle_to_quat(axis: Vec3, angle) -> Quat:
    half = angle * 0.5
    s = torch.sin(half)
    return (torch.cos(half), mul(axis[0], s), mul(axis[1], s),
            mul(axis[2], s))


def quat_integrate(q: Quat, omega_local: Vec3, dt) -> Quat:
    """Exact exponential-map integration (mju_quatIntegrate)."""
    angle = v3_norm(omega_local)
    inv = 1.0 / maximum(angle, 1e-30)
    axis = v3_scale(inv, omega_local)
    dq = axis_angle_to_quat(axis, angle * dt)
    return quat_normalize(quat_mul(q, dq))


def mat_vec(mat: Mat3, v: Vec3) -> Vec3:
    return tuple(
        add(add(mul(mat[i][0], v[0]), mul(mat[i][1], v[1])),
            mul(mat[i][2], v[2]))
        for i in range(3)
    )


def mat_tvec(mat: Mat3, v: Vec3) -> Vec3:
    """matᵀ v (world -> body-local for rotation matrices)."""
    return tuple(
        add(add(mul(mat[0][i], v[0]), mul(mat[1][i], v[1])),
            mul(mat[2][i], v[2]))
        for i in range(3)
    )


def mat_mul(a: Mat3, b: Mat3) -> Mat3:
    return tuple(
        tuple(
            add(add(mul(a[i][0], b[0][j]), mul(a[i][1], b[1][j])),
                mul(a[i][2], b[2][j]))
            for j in range(3)
        )
        for i in range(3)
    )


def mat_col(mat: Mat3, j: int) -> Vec3:
    return (mat[0][j], mat[1][j], mat[2][j])


# --- spatial algebra: 6-tuples [angular(3); linear(3)] at a common origin --


def sv(ang: Vec3, lin: Vec3):
    return (ang[0], ang[1], ang[2], lin[0], lin[1], lin[2])


def sv_ang(v) -> Vec3:
    return (v[0], v[1], v[2])


def sv_lin(v) -> Vec3:
    return (v[3], v[4], v[5])


def sv_add(a, b):
    return tuple(add(a[i], b[i]) for i in range(6))


def sv_scale(s, a):
    return tuple(mul(s, a[i]) for i in range(6))


def sv_dot(a, b):
    out = 0.0
    for i in range(6):
        out = add(out, mul(a[i], b[i]))
    return out


def motion_cross(v, m):
    """Spatial motion cross v x m."""
    w, u = sv_ang(v), sv_lin(v)
    mw, mu = sv_ang(m), sv_lin(m)
    top = v3_cross(w, mw)
    bot = v3_add(v3_cross(w, mu), v3_cross(u, mw))
    return sv(top, bot)


def force_cross(v, f):
    """Spatial force cross v x* f."""
    w, u = sv_ang(v), sv_lin(v)
    fm, fl = sv_ang(f), sv_lin(f)
    top = v3_add(v3_cross(w, fm), v3_cross(u, fl))
    bot = v3_cross(w, fl)
    return sv(top, bot)


def spatial_inertia_world(mass, inertia_diag, imat: Mat3, ipos: Vec3):
    """6x6 spatial inertia at the origin as a nested tuple.

    top-left  = R diag(I) Rᵀ + m (|c|² 1 - c cᵀ)
    top-right = m [c]x ;  bottom-left = m [c]xᵀ ;  bottom-right = m 1
    """
    i0, i1, i2 = inertia_diag
    ic = tuple(
        tuple(
            add(add(mul(mul(imat[a][0], i0), imat[b][0]),
                    mul(mul(imat[a][1], i1), imat[b][1])),
                mul(mul(imat[a][2], i2), imat[b][2]))
            for b in range(3)
        )
        for a in range(3)
    )
    cx, cy, cz = ipos
    c2 = add(add(mul(cx, cx), mul(cy, cy)), mul(cz, cz))
    c = (cx, cy, cz)
    eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    tl = tuple(
        tuple(
            add(ic[a][b],
                mul(mass, sub(mul(c2, eye[a][b]), mul(c[a], c[b]))))
            for b in range(3)
        )
        for a in range(3)
    )
    mcx = (
        (0.0, neg(mul(mass, cz)), mul(mass, cy)),
        (mul(mass, cz), 0.0, neg(mul(mass, cx))),
        (neg(mul(mass, cy)), mul(mass, cx), 0.0),
    )
    rows = []
    for a in range(3):
        rows.append(tuple(tl[a]) + tuple(mcx[a]))
    for a in range(3):
        rows.append(
            tuple(mcx[b][a] for b in range(3))
            + tuple(mul(mass, eye[a][b]) for b in range(3))
        )
    return tuple(rows)


def inertia_vec(I, v):
    """6x6 nested-tuple inertia times spatial 6-tuple."""
    out = []
    for a in range(6):
        acc = 0.0
        for b in range(6):
            acc = add(acc, mul(I[a][b], v[b]))
        out.append(acc)
    return tuple(out)
