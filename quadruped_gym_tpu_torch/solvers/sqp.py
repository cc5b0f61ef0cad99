"""SQP trajectory optimization with condensed horizon-block QPs.

Counterpart of ``quadruped_gym_tpu/solvers/sqp.py``. Where iLQR's Riccati
recursion is sequential in the horizon, SQP *condenses* the linearized
problem down to the controls and solves one dense box-constrained QP per
iteration:

    min_du  0.5 du' Hqp du + g' du,   lo <= u + du <= hi
    Hqp = sum_t F_t' lxx_t F_t + blkdiag(luu_t) + reg I
    g   = sum_t F_t' lx_t + [lu_t]

with F_t = d x_{t+1} / d(u_0..u_{H-1}) the state-control sensitivities
(dx_{t+1} = A_t dx_t + B_t du_t). The box QP solves by ADMM: one Cholesky
of Hqp + rho I, then a fixed count of triangular solves with a
closed-form box projection. The linearization and the cost expansion are
iLQR's. With a ``mesh``, the sum over t is cut over the ranks of its
``horizon`` axis: each rank condenses its contiguous slice of the blocks
and one SUM all-reduce assembles Hqp and g; everything else stays
replicated, as in the JAX package, where only the condensation sits in
``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..models.spec import PhysicsModel
from ..physics import maths
from ..physics.engine import State
from ..tasks.commands import Command
from . import ilqr as ilqr_mod
from . import rollout as rollout_mod

@dataclasses.dataclass(frozen=True)
class SQPConfig:
    iterations: int = 6
    rollout: rollout_mod.RolloutConfig = rollout_mod.RolloutConfig()
    linearize: str = "ad"  # 'ad' (exact branch tangents) | 'fd' (central FD)
    fd_eps: float = 1e-5
    reg: float = 1e-3  # Levenberg damping on the condensed Hessian
    qp_iterations: int = 25  # ADMM iterations per QP
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


class SQPResult(NamedTuple):
    ctrl_seq: torch.Tensor  # (H, nu) optimized, clamped
    cost: torch.Tensor
    initial_cost: torch.Tensor
    cost_history: torch.Tensor  # (iterations,) cost after each SQP iteration


def sensitivities(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """F (H, nx, H*nu): F[t] = d x_{t+1} / d u_flat.

    dx_0 = 0; dx_{t+1} = A_t dx_t + B_t du_t, so
    F[t] = A_t F[t-1] + e_t (x) B_t."""
    H, nx, nu = B.shape
    eye_H = torch.eye(H, dtype=B.dtype, device=B.device)
    F_t = B.new_zeros(nx, H, nu)
    Fs = []
    for t in range(H):
        F_t = (A[t] @ F_t.reshape(nx, H * nu)).reshape(nx, H, nu)
        F_t = F_t + B[t][:, None, :] * eye_H[t][None, :, None]
        Fs.append(F_t)
    return torch.stack(Fs).reshape(H, nx, H * nu)


def condense(
    F: torch.Tensor,  # (H, nx, H*nu)
    lx: torch.Tensor,  # (H, nx)
    lxx: torch.Tensor,  # (H, nx, nx)
    axis_name: Optional[str] = None,
    mesh=None,
):
    """(Hqp (H*nu, H*nu), g (H*nu,)): the horizon-block reduction of the
    state-cost terms (``_add_control_blocks`` adds the separable control
    blocks). The sum over t is one product over the stacked (H*nx) rows.

    With ``axis_name`` (an axis of ``mesh``), F, lx and lxx are this
    rank's blocks of the horizon and one SUM all-reduce over the axis's
    group assembles the whole system on every rank."""
    H, nx, HU = F.shape
    Fs = F.reshape(H * nx, HU)
    g = Fs.T @ lx.reshape(H * nx)
    Hqp = Fs.T @ (lxx @ F).reshape(H * nx, HU)
    if axis_name is not None:
        if mesh is None:
            raise ValueError(f"axis_name={axis_name!r} needs the mesh that "
                             "holds the axis")
        both = torch.cat([Hqp.reshape(-1), g])
        dist.all_reduce(both, dist.ReduceOp.SUM,
                        group=mesh.get_group(axis_name))
        Hqp, g = both[:HU * HU].reshape(HU, HU), both[HU * HU:]
    return Hqp, g


def _condense_sharded(F, lx, lxx, mesh, axis_name):
    """``condense`` with the horizon blocks cut over ``mesh[axis_name]``:
    H is zero-padded to a multiple of the axis size (a zero block adds
    nothing) and each rank takes its contiguous slice."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    H = F.shape[0]
    per = -(-H // n)
    pad = per * n - H
    r = mesh.get_local_rank(axis_name)

    def mine(x):
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x
        return x[r * per:(r + 1) * per]

    return condense(mine(F), mine(lx), mine(lxx), axis_name=axis_name,
                    mesh=mesh)


def _add_control_blocks(Hqp, g, lu, luu, t_offset=0):
    """Add the separable control-cost blocks blkdiag(luu), [lu]."""
    H, nu = lu.shape
    r0, r1 = t_offset * nu, (t_offset + H) * nu
    g = g.clone()
    g[r0:r1] += lu.reshape(-1)
    Hqp = Hqp.clone()
    Hqp[r0:r1, r0:r1] += torch.block_diag(*luu.unbind(0))
    return Hqp, g


def admm_box_qp(
    Hqp: torch.Tensor,  # (n, n) PSD
    g: torch.Tensor,  # (n,)
    lo: torch.Tensor,  # (n,) box on the decision variable
    hi: torch.Tensor,
    iterations: int = 25,
    rho: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """min 0.5 x'Hx + g'x  s.t. lo <= x <= hi, by ADMM.

    One Cholesky of (H + rho I), then fixed-count solves; the z-update is
    the closed-form box projection. No host read-back."""
    n = g.shape[0]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    diag = torch.diagonal(Hqp)
    if rho is None:
        rho = torch.clamp_min(torch.mean(diag), 1e-8)
    M = Hqp + rho * eye
    L = torch.linalg.cholesky_ex(M + 1e-9 * eye, check_errors=False)[0]
    z = torch.clamp(-g / torch.clamp_min(diag, 1e-8), lo, hi)
    w = torch.zeros_like(z)
    for _ in range(iterations):
        x = torch.cholesky_solve((rho * (z - w) - g)[:, None], L)[:, 0]
        z_new = torch.clamp(x + w, lo, hi)
        w = w + x - z_new
        z = z_new
    return z  # the feasible iterate


def solve(
    m: PhysicsModel,
    cfg: SQPConfig,
    cost_fn: rollout_mod.CostFn,
    state0: State,
    ctrl_seq: torch.Tensor,  # (H, nu) initial guess
    cmd: Command,
    prev_ctrl0: torch.Tensor,
    mesh=None,
    axis_name: str = "horizon",
    on_part: Optional[Callable[[str], None]] = None,
) -> SQPResult:
    """SQP from ``ctrl_seq``, on the device of its tensors, without a
    host read-back. With ``mesh`` (a ``parallel.make_mesh`` with an
    ``axis_name`` axis) every rank runs the solve on the same inputs and
    the condensation is cut over the axis's ranks. ``on_part``, if given, is called with the name of each part as it is
    issued ("rollout": the initial guess's, once; then per iteration
    "linearize", "quadratize", "qp": sensitivities, condensation and
    ADMM, "line_search"), for a caller that times them."""
    if mesh is None:
        condense_full = condense
    else:
        def condense_full(F, lx, lxx):
            return _condense_sharded(F, lx, lxx, mesh, axis_name)
    with maths.true_fp32():
        return _solve(m, cfg, cost_fn, state0, ctrl_seq, cmd, prev_ctrl0,
                      on_part or (lambda part: None), condense_full)


def _solve(m, cfg, cost_fn, state0, ctrl_seq, cmd, prev_ctrl0, on_part,
           condense_full):
    H, nu = ctrl_seq.shape
    dt, dev = ctrl_seq.dtype, ctrl_seq.device
    lo_u, hi_u = ilqr_mod._ctrl_range(m, ctrl_seq)
    step_fn = ilqr_mod._step_fn(m, cfg.rollout)
    linearize = ilqr_mod.make_linearizer(cfg.linearize)
    alphas = torch.as_tensor(cfg.alphas, dtype=dt, device=dev)
    eye = torch.eye(H * nu, dtype=dt, device=dev)

    def rollout(us):
        return ilqr_mod._traj_rollout(step_fn, cost_fn, state0, us,
                                      prev_ctrl0, cmd)

    us = torch.clamp(ctrl_seq, lo_u, hi_u)
    states, cost = rollout(us)
    on_part("rollout")
    cost0 = cost
    history = []
    for _ in range(cfg.iterations):
        A, B = linearize(m, step_fn, state0, states, us, cfg.fd_eps)
        on_part("linearize")
        lx, lxx, lu, luu = ilqr_mod.quadratize_cost(m, cost_fn, cmd, states,
                                                    us, prev_ctrl0)
        on_part("quadratize")
        F = sensitivities(A, B)
        Hqp, g = condense_full(F, lx, lxx)
        Hqp, g = _add_control_blocks(Hqp, g, lu, luu)
        Hqp = Hqp + cfg.reg * eye
        Hqp = 0.5 * (Hqp + Hqp.T)  # PSD safeguard: symmetric part only

        lo = lo_u.repeat(H) - us.reshape(-1)
        hi = hi_u.repeat(H) - us.reshape(-1)
        du = admm_box_qp(Hqp, g, lo, hi, iterations=cfg.qp_iterations)
        # an overflowed condensation NaNs the Cholesky; a zero step keeps
        # the incumbent instead of stalling on NaN comparisons
        du = torch.where(torch.isfinite(du), du, 0.0).reshape(H, nu)
        on_part("qp")

        cand_us = torch.clamp(us + alphas[:, None, None] * du, lo_u, hi_u)
        cand_states, cand_cost = rollout(cand_us)
        us, states, cost, _ = ilqr_mod._select_best(
            cand_us, cand_states, cand_cost, us, states, cost)
        on_part("line_search")
        history.append(cost)
    return SQPResult(
        ctrl_seq=us, cost=cost, initial_cost=cost0,
        cost_history=(torch.stack(history) if history
                      else cost0.new_zeros(0)),
    )
