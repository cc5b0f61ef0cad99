"""Quaternion / rotation / spatial-algebra primitives.

Counterpart of ``quadruped_gym_tpu/physics/maths.py``. Conventions match
MuJoCo:
  * quaternions are ``[w, x, y, z]``
  * rotation matrices map body-local vectors to world vectors
  * spatial vectors are ``[angular; linear]`` measured at a common origin

Every function works on the last axis (or the last two, for matrices) and
broadcasts over any leading batch dims; dtype and device come from the
inputs.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def true_fp32():
    """Float32 products inside this context are true FP32 on the card.

    The engine's small-matrix algebra (18 x 18 mass matrices, contact
    Jacobians) loses its meaning at TF32's 10-bit mantissa. PyTorch routes
    float32 ``matmul`` through cuBLAS, whose math mode follows the
    process-wide ``torch.backends.cuda.matmul.allow_tf32``; the engine's
    entry points do not trust that flag: they switch it off for the
    duration of the call and put the caller's value back. Everything else
    the engine launches (elementwise kernels, reductions, the cuSOLVER
    Cholesky) has no reduced-precision mode."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis; leading dims broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k) -> (..., n), batch dims broadcast."""
    return (a @ x[..., None])[..., 0]


def cho_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (..., n, n) and
    b (..., n) through a Cholesky factor. ``cholesky_ex`` does not read its
    ``info`` back, so there is no host synchronisation; a matrix that is
    not positive definite gives non-finite values, as in the JAX package."""
    L = torch.linalg.cholesky_ex(A, check_errors=False)[0]
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def quat_normalize(q: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b with [w,x,y,z] layout."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body-local -> world for body quats)."""
    w = q[..., :1]
    u = q[..., 1:]
    # v' = v + 2 w (u x v) + 2 u x (u x v)
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix R with v_world = R @ v_local."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = angle * 0.5
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Integrate quaternion by angular velocity expressed in the local frame
    over dt, matching MuJoCo's mju_quatIntegrate (exact exponential map).

    Differentiable at omega == 0: the exponential map is evaluated through
    a small-angle guard so ``d(dq_vec)/d(omega) == 0.5*dt*I`` there (the
    true Jacobian). A plain axis/angle where-guard would make that
    Jacobian identically zero and erase orientation gradients from the
    gradient solvers' cost expansions.

    The guard only activates where ``|omega|*dt/2 < 1e-9``, a region where
    ``sin(x) == x`` and ``cos(x) == 1.0`` bitwise in float32 and float64,
    so values are those of the exact branch; only the Jacobian differs."""
    n2 = torch.sum(omega_local * omega_local, dim=-1)
    small = n2 * (dt * dt) < 4e-18
    one = torch.ones_like(n2)
    # Double where: the untaken exact branch divides by sqrt(1.0), so its
    # (discarded) gradient stays finite and 0 * grad is 0, never 0 * nan.
    angle = torch.sqrt(torch.where(small, one, n2))
    half = 0.5 * dt * angle
    axis = omega_local / angle[..., None]
    vec = torch.where(
        small[..., None],
        omega_local * (0.5 * dt),
        axis * torch.sin(half)[..., None],
    )
    w = torch.where(small, one, torch.cos(half))
    dq = torch.cat([w[..., None], vec], dim=-1)
    return quat_normalize(quat_mul(q, dq))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix such that skew(v) @ u = v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


# --- spatial algebra (Featherstone, [angular; linear] at a common origin) ---


def spatial_inertia_world(mass, inertia_diag_world_frame, imat, ipos):
    """6x6 spatial inertia of bodies, expressed at the origin ``ipos`` is
    measured from.

    Args:
      mass: (...,) body mass
      inertia_diag_world_frame: (..., 3) principal inertia moments (about com)
      imat: (..., 3, 3) rotation from the principal-inertia frame to world
      ipos: (..., 3) com position
    """
    mass = mass[..., None, None]
    ic = imat @ (inertia_diag_world_frame[..., None] * imat.transpose(-1, -2))
    c = skew(ipos)
    top_left = ic + mass * (c @ c.transpose(-1, -2))
    top_right = mass * c
    bot_left = mass * c.transpose(-1, -2)
    eye = torch.eye(3, dtype=top_left.dtype, device=top_left.device)
    bot_right = (mass * eye).expand(top_left.shape)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m for [angular; linear] vectors."""
    w, u = v[..., :3], v[..., 3:]
    mw, mu = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mu) + cross(u, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f for [angular(moment); linear] forces."""
    w, u = v[..., :3], v[..., 3:]
    fm, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fm) + cross(u, fl), cross(w, fl)], dim=-1)
