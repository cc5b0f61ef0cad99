"""Primal Newton solver for MuJoCo's convex soft-constraint problem.

Counterpart of ``quadruped_gym_tpu/physics/solver.py``. Solves

  min_x  0.5 (x - a)' M (x - a) + 0.5 sum_i D_i [min(0, (Jx - aref)_i)]^2

over qacc, where every row (joint limits, pyramidal contact facets) is
one-sided. The problem is strictly convex (M is PD), so the minimizer is
unique: any solver converging to tolerance reproduces MuJoCo's Newton
solution at float64, independent of warmstart.

Exact Hessian with an 18x18 Cholesky per iteration and an inner 1-D Newton
line search over the piecewise-quadratic restriction. All shapes static;
inactive rows carry D=0. With leading batch dims every sample iterates
until its own gradient is small: a sample that is done keeps its ``x`` and
its ``niter`` while the others go on, which is what ``jax.vmap`` makes of
the JAX package's ``while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.spec import PhysicsModel
from .constraints import ConstraintSet
from .maths import cho_solve, matvec

# Below this many iterations the loop never asks the device whether every
# sample is done (a host synchronisation per pass); the closed loop's
# budgets of 3-8 passes run to the end.
_EARLY_EXIT_ABOVE = 8


class SolveResult(NamedTuple):
    qacc: torch.Tensor  # (..., nv)
    qfrc_constraint: torch.Tensor  # (..., nv)
    efc_force: torch.Tensor  # (..., nrow)
    niter: torch.Tensor  # (...) int64


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def solve(
    m: PhysicsModel,
    M: torch.Tensor,
    qacc_smooth: torch.Tensor,
    efc: ConstraintSet,
    iterations: Optional[int] = None,
    tolerance: Optional[float] = None,
    ls_iterations: int = 12,
) -> SolveResult:
    J, aref, D = efc.J, efc.aref, efc.D
    iterations = m.solver_iterations if iterations is None else iterations
    tolerance = tolerance if tolerance is not None else m.solver_tolerance
    batch = qacc_smooth.shape[:-1]
    dev = qacc_smooth.device

    if iterations == 0:  # constraint-free fast path (benchmarks/ablations)
        return SolveResult(
            qacc=qacc_smooth,
            qfrc_constraint=torch.zeros_like(qacc_smooth),
            efc_force=torch.zeros_like(aref),
            niter=torch.zeros(batch, dtype=torch.int64, device=dev),
        )

    Jt = J.transpose(-1, -2)
    zero_rows = torch.zeros_like(D)
    has_row = D > 0.0
    # scale for the termination criterion (mirrors MuJoCo's meaninertia-based
    # scaling loosely; exactness of the optimum does not depend on it)
    scale = torch.clamp_min(_norm(matvec(M, qacc_smooth)), 1.0)

    def grad_hess_parts(x):
        jar = matvec(J, x) - aref
        w = torch.where((jar < 0.0) & has_row, D, zero_rows)
        g = matvec(M, x - qacc_smooth) + matvec(Jt, w * jar)
        return jar, w, g

    def newton_step(x):
        jar, w, g = grad_hess_parts(x)
        H = M + (Jt * w[..., None, :]) @ J
        dx = -cho_solve(H, g)

        # exact-ish line search: phi'(t) is piecewise linear; 1-D Newton
        Jdx = matvec(J, dx)
        mdx = matvec(M, dx)
        g0 = torch.sum(dx * matvec(M, x - qacc_smooth), dim=-1)
        h0 = torch.sum(dx * mdx, dim=-1)

        t = torch.ones_like(g0)
        for _ in range(ls_iterations):
            jar_t = jar + t[..., None] * Jdx
            w_t = torch.where((jar_t < 0.0) & has_row, D, zero_rows)
            dphi = g0 + t * h0 + torch.sum(w_t * jar_t * Jdx, dim=-1)
            ddphi = h0 + torch.sum(w_t * Jdx * Jdx, dim=-1)
            t = torch.clamp(t - dphi / torch.clamp_min(ddphi, 1e-30), 0.0, 4.0)
        step = t[..., None] * dx
        x_new = x + step

        _, _, g_new = grad_hess_parts(x_new)
        done = _norm(g_new) < tolerance * scale
        # safeguard: no progress
        done = done | (_norm(step) < 1e-14)
        return x_new, done

    x = qacc_smooth
    _, _, g_start = grad_hess_parts(x)
    done = _norm(g_start) < tolerance * scale
    niter = torch.zeros(batch, dtype=torch.int64, device=dev)
    for _ in range(iterations):
        if iterations > _EARLY_EXIT_ABOVE and bool(done.all()):
            break
        x_new, done_new = newton_step(x)
        x = torch.where(done[..., None], x, x_new)
        niter = niter + (~done).to(torch.int64)
        done = done | done_new

    jar = matvec(J, x) - aref
    force = torch.where((jar < 0.0) & has_row, -D * jar, zero_rows)
    qfrc = matvec(Jt, force)
    return SolveResult(qacc=x, qfrc_constraint=qfrc, efc_force=force, niter=niter)
