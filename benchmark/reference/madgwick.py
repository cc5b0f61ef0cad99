# Frozen copy of quadruped_gym_tpu_torch/tasks/madgwick.py for the benchmark's plain
# reference: the same code, with its imports pointed at this folder. Later
# changes to the port do not reach it.
"""Madgwick IMU orientation filter (gradient-descent complementary filter).

Counterpart of ``quadruped_gym_tpu/tasks/madgwick.py``: the gyroscope
quaternion derivative corrected by a normalized gradient of the
gravity-alignment objective, default IMU gain 0.033. Any leading batch
axes; the component axis is the last.

Edge cases preserved: zero gyro -> no update; zero accel -> gyro-only
integration.
"""

from __future__ import annotations

import torch

DEFAULT_GAIN = 0.033


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, 1e-15)


def update_imu(q: torch.Tensor, gyr: torch.Tensor, acc: torch.Tensor,
               dt: float, gain: float = DEFAULT_GAIN) -> torch.Tensor:
    """One Madgwick IMU update. q: (..., 4) [w,x,y,z]; gyr rad/s (..., 3);
    acc m/s^2 (..., 3)."""
    gyr_norm = torch.linalg.vector_norm(gyr, dim=-1)
    q_dot = 0.5 * _quat_mul(
        q, torch.cat([torch.zeros_like(gyr[..., :1]), gyr], dim=-1))

    a_norm = torch.linalg.vector_norm(acc, dim=-1)
    a = acc / torch.clamp_min(a_norm, 1e-30)[..., None]
    qw, qx, qy, qz = _quat_normalize(q).unbind(-1)
    f = torch.stack([
        2.0 * (qx * qz - qw * qy) - a[..., 0],
        2.0 * (qw * qx + qy * qz) - a[..., 1],
        2.0 * (0.5 - qx * qx - qy * qy) - a[..., 2],
    ], dim=-1)
    zero = torch.zeros_like(qw)
    J = torch.stack([
        torch.stack([-2.0 * qy, 2.0 * qz, -2.0 * qw, 2.0 * qx], dim=-1),
        torch.stack([2.0 * qx, 2.0 * qw, 2.0 * qz, 2.0 * qy], dim=-1),
        torch.stack([zero, -4.0 * qx, -4.0 * qy, zero], dim=-1),
    ], dim=-2)  # (..., 3, 4)
    grad = torch.sum(J * f[..., None], dim=-2)  # J^T f
    grad = grad / torch.clamp_min(
        torch.linalg.vector_norm(grad, dim=-1, keepdim=True), 1e-30)
    use_acc = (a_norm > 0) & (torch.linalg.vector_norm(f, dim=-1) > 0)
    q_dot = torch.where(use_acc[..., None], q_dot - gain * grad, q_dot)

    q_new = _quat_normalize(q + q_dot * dt)
    return torch.where((gyr_norm > 0)[..., None], q_new, q)


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """ahrs Quaternion.to_angles convention: [roll, pitch, yaw]."""
    w, x, y, z = q.unbind(-1)
    phi = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    theta = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    psi = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([phi, theta, psi], dim=-1)
