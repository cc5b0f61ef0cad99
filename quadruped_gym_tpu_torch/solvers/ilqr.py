"""iLQR trajectory optimization over the contact dynamics.

Counterpart of ``quadruped_gym_tpu/solvers/ilqr.py``: linearize the full
step (contacts included) by AD through the fixed-budget contact Newton
(``ad_linearize``, the default) or by batched central finite differences
(``fd_linearize``), then run a regularized Riccati
backward pass and a forward line search over every step size at once.
Controls clamp to the actuator range in every rollout.

Where the JAX package ``vmap``s over the horizon, the step sizes, the FD
perturbations and the rows or columns of a Jacobian or Hessian, this
module puts them on the oracle engine's own leading batch dims: every
``physics`` function takes them natively. Derivatives come from one AD
pass over such a batch (``torch.autograd.grad`` for the dynamics,
``torch.func.grad`` and ``jvp`` for the cost); nothing is ``vmap``ped, so
the primal is never a batched tensor and the Newton loop's early exit (a
read-back of its ``done`` flags) stays legal at any iteration budget.

State tangent space: 2*nv + na dims. Quaternions perturb through the
exponential map (MuJoCo's mj_integratePos / mj_differentiatePos), and
actuator activations are part of the state (the position servos are
filtered, so controls act on the dynamics only through ``act``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.spec import JNT_FREE, PhysicsModel
from ..physics import engine, maths, sensors, smooth
from ..physics.engine import State
from ..tasks.commands import Command
from . import rollout as rollout_mod


# --- state tangent-space helpers (mj_integratePos / mj_differentiatePos) --


def tangent_dim(m: PhysicsModel) -> int:
    """2*nv + na: position tangent, velocity, and actuator activations.

    Activations MUST be part of the iLQR state: the position servos are
    filtered (dyntype=filterexact), so within one substep the control only
    moves ``act``; without it the control Jacobian B is identically zero."""
    return 2 * m.nv + m.na


def _joints_in_qpos_order(m: PhysicsModel):
    order = sorted(range(m.njnt), key=lambda j: m.jnt_qposadr[j])
    width = sum(7 if m.jnt_type[j] == JNT_FREE else 1 for j in order)
    assert width == m.nq, "tangent maps support free + 1-dof joints"
    return order


def _batch_shape(*xs) -> torch.Size:
    return torch.broadcast_shapes(*(x.shape[:-1] for x in xs))


def state_add(m: PhysicsModel, state: State, dx: torch.Tensor) -> State:
    """Perturb (qpos, qvel, act) by a tangent vector (..., 2*nv + na);
    the state's and ``dx``'s leading dims broadcast."""
    nv = m.nv
    dq, dv, da_ = dx[..., :nv], dx[..., nv: 2 * nv], dx[..., 2 * nv:]
    qpos = state.qpos
    batch = _batch_shape(qpos, dx)
    cols = []
    for j in _joints_in_qpos_order(m):
        qa, da = m.jnt_qposadr[j], m.jnt_dofadr[j]
        if m.jnt_type[j] == JNT_FREE:
            cols.append(qpos[..., qa: qa + 3] + dq[..., da: da + 3])
            cols.append(maths.quat_integrate(
                qpos[..., qa + 3: qa + 7], dq[..., da + 3: da + 6], 1.0))
        else:
            cols.append(qpos[..., qa: qa + 1] + dq[..., da: da + 1])
    qpos = torch.cat([c.expand(batch + c.shape[-1:]) for c in cols], dim=-1)
    return state._replace(qpos=qpos, qvel=state.qvel + dv,
                          act=state.act + da_)


def _quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion (..., 4) -> (..., 3), through
    a small-angle guard like ``maths.quat_integrate``'s.

    angle * axis = v * 2 atan2(|v|, w) / |v|. Written literally (norm,
    then ``max(|v|, 1e-30)``) its Jacobian at v == 0 is zero in torch,
    whose norm has derivative 0 there: every Jacobian would lose its
    rotation block. Below |v| = 1e-9 the factor is its limit 2 / w, which
    equals the exact factor to rounding (atan2(s, w) == s / w there), and
    the Jacobian at 0 is the true one, (2 / w) I."""
    w, v = q[..., 0], q[..., 1:]
    s2 = torch.sum(v * v, dim=-1)
    small = s2 < 1e-18
    # double where: the untaken exact branch divides by sqrt(1.0)
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    factor = torch.where(small, 2.0 / w, 2.0 * torch.atan2(s, w) / s)
    return v * factor[..., None]


def state_diff(m: PhysicsModel, a: State, b: State) -> torch.Tensor:
    """Tangent vector from b to a (a - b), (..., 2*nv + na)."""
    batch = _batch_shape(a.qpos, b.qpos)
    cols = [None] * m.njnt
    for j in range(m.njnt):
        qa = m.jnt_qposadr[j]
        if m.jnt_type[j] == JNT_FREE:
            # relative rotation b -> a in b's local frame (expmap log)
            qrel = maths.quat_mul(maths.quat_conj(b.qpos[..., qa + 3: qa + 7]),
                                  a.qpos[..., qa + 3: qa + 7])
            qrel = qrel * torch.sign(qrel[..., :1] + 1e-30)
            cols[j] = torch.cat([
                (a.qpos[..., qa: qa + 3] - b.qpos[..., qa: qa + 3])
                .expand(batch + (3,)),
                _quat_log(qrel).expand(batch + (3,))], dim=-1)
        else:
            cols[j] = (a.qpos[..., qa: qa + 1]
                       - b.qpos[..., qa: qa + 1]).expand(batch + (1,))
    dq = torch.cat([cols[j] for j in sorted(range(m.njnt),
                                             key=lambda j: m.jnt_dofadr[j])],
                   dim=-1)
    return torch.cat([dq, (a.qvel - b.qvel).expand(batch + (m.nv,)),
                      (a.act - b.act).expand(batch + (m.na,))], dim=-1)


# --- differentiable stage cost as a function of state --------------------


def smooth_sensordata(m: PhysicsModel, state: State) -> torch.Tensor:
    """Sensor vector from (qpos, qvel) alone: no contact solve, fully
    differentiable. Identical to the stepped sensordata for every slot the
    planning cost reads (positions, axes, velocities); only the
    accelerometer (which needs qacc and which no cost uses) is zeroed."""
    kin = smooth.fwd_position(m, state.qpos)
    S = smooth.dof_subspace(m, kin)
    cvel = smooth.body_velocities(m, S, state.qvel)
    return sensors.evaluate(m, kin, cvel, torch.zeros_like(cvel), state.qpos)


def _prev_states(state0: State, states: State) -> State:
    """(state0, states[:-1]): the state each step of the trajectory starts
    from, stacked over H."""
    return State(*(torch.cat([s0[None], s[:-1]], dim=0)
                   for s0, s in zip(state0, states)))


def _expand_state(st: State, shape) -> State:
    """Insert ``len(shape)`` dims after the leading one and broadcast the
    state over them: (H, n) -> (H, *shape, n)."""
    k = len(shape)

    def one(x):
        lead = x.shape[:1]
        tail = x.shape[1:]
        return x.reshape(lead + (1,) * k + tail).expand(lead + tuple(shape)
                                                         + tail)

    return State(*(one(x) for x in st))


def fd_linearize(m: PhysicsModel, step_fn, state0, states, us, eps):
    """A (H, nx, nx), B (H, nx, nu): central finite differences of
    ``step_fn`` around the incumbent trajectory. All H x 2 x (nx + nu)
    perturbed steps go through the engine as one batch."""
    nx = tangent_dim(m)
    H, nu = us.shape
    prev = _prev_states(state0, states)
    sign = torch.tensor([1.0, -1.0], dtype=us.dtype, device=us.device)
    dx = sign[:, None, None] * (eps * torch.eye(nx, dtype=us.dtype,
                                                device=us.device))
    du = sign[:, None, None] * (eps * torch.eye(nu, dtype=us.dtype,
                                                device=us.device))
    # state perturbations (controls as they are), then control
    # perturbations (the state as it is), along one axis of width nx + nu
    st_x = state_add(m, _expand_state(prev, (2, nx)), dx)
    st_u = _expand_state(prev, (2, nu))
    st = State(*(torch.cat([x, u], dim=2) for x, u in zip(st_x, st_u)))
    u = torch.cat([us[:, None, None, :].expand(H, 2, nx, nu),
                   us[:, None, None, :] + du], dim=2)
    nxt = step_fn(st, u)
    plus = State(*(x[:, 0] for x in nxt))
    minus = State(*(x[:, 1] for x in nxt))
    J = (state_diff(m, plus, minus) / (2 * eps)).transpose(-1, -2)
    return J[..., :nx], J[..., nx:]


def ad_linearize(m: PhysicsModel, step_fn, state0, states, us):
    """A (H, nx, nx), B (H, nx, nu) by AD through the full step, contact
    Newton included.

    Central FD across the contact solver's discrete structure (active-set
    selection, line-search winner switches) straddles jump
    discontinuities and plants O(1/eps) entries in A; AD differentiates
    the selected branch exactly. The H steps are independent, and so are
    the nx rows of each step's Jacobian: every step is replicated once per
    row along one batch dim of the engine, (H, nx), and ONE reverse pass
    with the identity as its cotangent gives every row of every A_t and
    B_t. (The JAX package takes ``jacfwd``; in PyTorch forward mode is
    dearer on the host: every operation that mixes a tangent with a
    constant routes that constant's zero tangent through a Python meta
    function.) The primal is never batched by a transform, so the Newton
    loop's early exit may read it back."""
    nx = tangent_dim(m)
    H, nu = us.shape
    prev = _prev_states(state0, states)
    ref = step_fn(prev, us)
    ref = State(*(x[:, None] for x in ref))
    rows = _expand_state(prev, (nx,))
    basis = torch.eye(nx, dtype=us.dtype, device=us.device).expand(H, nx, nx)
    with torch.enable_grad():
        dxu = us.new_zeros(H, nx, nx + nu, requires_grad=True)
        nxt = step_fn(state_add(m, rows, dxu[..., :nx]),
                      us[:, None] + dxu[..., nx:])
        # J[t, i, j] = d x_{t+1, i} / d (x_t, u_t)_j
        (J,) = torch.autograd.grad(state_diff(m, nxt, ref), dxu,
                                   grad_outputs=basis)
    return J[..., :nx], J[..., nx:]


def make_linearizer(method: str):
    """'ad' (forward-mode AD, default) or 'fd' (central differences, needs
    eps)."""
    if method == "ad":
        return lambda m, step_fn, s0, states, us, eps: ad_linearize(
            m, step_fn, s0, states, us
        )
    if method == "fd":
        return fd_linearize
    raise ValueError(f"unknown linearize method: {method!r}")


def psd_project(S: torch.Tensor, rel_floor: float = 1e-4) -> torch.Tensor:
    """PSD projection of (batched) symmetric matrices by eigenvalue floor.

    The walking task's stage cost is non-convex, so the exact per-step
    Hessians are indefinite at stance. Negative eigenvalues are clamped UP
    to ``rel_floor`` times the largest positive one: positive curvature is
    kept exactly, and the line search bounds the step in the formerly
    concave directions. The floor also bounds the condensed QP's
    condition number near 1/rel_floor."""
    S = 0.5 * (S + S.transpose(-1, -2))
    w, V = torch.linalg.eigh(S)
    wmax = torch.clamp_min(torch.max(w, dim=-1, keepdim=True).values, 1e-8)
    w = torch.maximum(w, rel_floor * wmax)
    return torch.einsum("...ij,...j,...kj->...ik", V, w, V)


def _grad_hess_rows(row_cost, z: torch.Tensor):
    """Per-row gradients (H, n) and Hessians (H, n, n) of ``row_cost`` at
    ``z`` (H, n), for a cost whose rows are independent. Each row is
    replicated once per basis vector, so ``row_cost`` gets (H, n, n); the
    JVP of the gradient of the sum, with the identity as its tangent,
    gives every Hessian column in one batch (no ``vmap``)."""
    H, n = z.shape
    basis = torch.eye(n, dtype=z.dtype, device=z.device).repeat(H, 1, 1)
    grad = torch.func.grad(lambda x: torch.sum(row_cost(x)))
    g, cols = torch.func.jvp(grad, (z[:, None, :].repeat(1, n, 1),),
                             (basis,))
    return g[:, 0], cols.transpose(-1, -2)


def quadratize_cost(m: PhysicsModel, cost_fn, cmd, states, us, prev_ctrl0,
                    psd: bool = True):
    """(lx, lxx, lu, luu) at each step by AD of the smooth stage cost.

    The Δctrl coupling to prev_u treats u_{t-1} as fixed (receding-horizon
    practice; exact for the quadratic Δu penalty's u_t block). The rows are
    independent, so each gradient is ``torch.func.grad`` of the sum over
    rows. With ``psd`` (the default) the per-step Hessians are projected
    (``psd_project``); ``psd=False`` gives the raw second-order expansion."""
    nx = tangent_dim(m)
    H, nu = us.shape
    prev_us = torch.cat([prev_ctrl0[None], us[:-1]], dim=0)

    def cost_rows(st, u, n):
        # the stage cost wants the component axis first; every row is
        # replicated n times along the second dim
        rows = (H, n, nu)
        return cost_fn(smooth_sensordata(m, st).movedim(-1, 0),
                       u.movedim(-1, 0),
                       prev_us[:, None].expand(rows).movedim(-1, 0), cmd)

    st_x = _expand_state(states, (nx,))
    lx, lxx = _grad_hess_rows(lambda dx: cost_rows(
        state_add(m, st_x, dx), us[:, None].expand(H, nx, nu), nx),
        us.new_zeros(H, nx))
    st_u = _expand_state(states, (nu,))
    lu, luu = _grad_hess_rows(lambda u: cost_rows(st_u, u, nu), us)
    if psd:
        lxx = psd_project(lxx)
        luu = psd_project(luu)
    return lx, lxx, lu, luu


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 8
    rollout: rollout_mod.RolloutConfig = rollout_mod.RolloutConfig()
    linearize: str = "ad"  # 'ad' (exact branch tangents) | 'fd' (central FD)
    fd_eps: float = 1e-5
    reg_init: float = 1e-4
    reg_factor: float = 4.0
    reg_max: float = 1e3
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.0)


class ILQRResult(NamedTuple):
    ctrl_seq: torch.Tensor  # (H, nu) optimized, clamped
    cost: torch.Tensor  # () final trajectory cost
    initial_cost: torch.Tensor
    reg: torch.Tensor
    cost_history: torch.Tensor  # (iterations,) cost after each iteration


def _ctrl_range(m: PhysicsModel, like: torch.Tensor):
    rng = torch.as_tensor(np.asarray(m.actuator_ctrlrange), dtype=like.dtype,
                          device=like.device)
    return rng[:, 0], rng[:, 1]


def _clamp(m: PhysicsModel, u: torch.Tensor) -> torch.Tensor:
    lo, hi = _ctrl_range(m, u)
    return torch.clamp(u, lo, hi)


def _step_fn(m: PhysicsModel, rcfg: rollout_mod.RolloutConfig):
    def step_fn(st: State, u: torch.Tensor) -> State:
        return engine.control_step(
            m, st, u, rcfg.frame_skip,
            max_contacts=rcfg.max_contacts,
            solver_iterations=rcfg.solver_iterations,
        )

    return step_fn


def _stage_cost(cost_fn, st: State, u, prev_u, cmd):
    """Stage cost of a batch of rows (..., n) -> (...)."""
    return cost_fn(st.sensordata.movedim(-1, 0), u.movedim(-1, 0),
                   prev_u.movedim(-1, 0), cmd)


def _stack_states(sts, dim: int) -> State:
    return State(*(torch.stack(xs, dim=dim) for xs in zip(*sts)))


def _traj_rollout(step_fn, cost_fn, state0: State, us: torch.Tensor,
                  prev_ctrl0, cmd):
    """Rollouts of (..., H, nu) control sequences from ``state0``: the
    states stacked over H (at the dim of H) and the (...) total costs."""
    batch = us.shape[:-2]
    st = State(*(x.expand(batch + x.shape) for x in state0))
    prev = prev_ctrl0.expand(batch + prev_ctrl0.shape)
    total = us.new_zeros(batch)
    sts = []
    for t in range(us.shape[-2]):
        u = us[..., t, :]
        st = step_fn(st, u)
        total = total + _stage_cost(cost_fn, st, u, prev, cmd)
        sts.append(st)
        prev = u
    return _stack_states(sts, len(batch)), total


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading it back to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _select_best(cand_us, cand_states: State, cand_cost, us, states, cost):
    """The line search's winner where it beats ``cost``, else the
    incumbent. NaN candidates (diverged rollouts) lose the argmin."""
    cand_cost = torch.where(torch.isnan(cand_cost), torch.inf, cand_cost)
    best = torch.argmin(cand_cost)
    best_cost = _take(cand_cost, best)
    improved = best_cost < cost
    us_new = torch.where(improved, _take(cand_us, best), us)
    cost_new = torch.where(improved, best_cost, cost)
    # the winning rollout already produced the new trajectory: carry it
    states_new = State(*(torch.where(improved, _take(c, best), o)
                         for c, o in zip(cand_states, states)))
    return us_new, states_new, cost_new, improved


def _backward(A, B, lx, lxx, lu, luu, reg):
    """Riccati recursion; the stage cost is evaluated at the POST-step
    state x_{t+1}, so (lx, lxx) fold into the cost-to-go at x_{t+1}
    before pulling back through (A_t, B_t). The stage cost is separable in
    (x, u), so the cross block lux is zero. Returns k (H, nu), K (H, nu, nx)."""
    H, nx, nu = B.shape
    dt, dev = B.dtype, B.device
    eye_u = torch.eye(nu, dtype=dt, device=dev)
    Vx = torch.zeros(nx, dtype=dt, device=dev)
    Vxx = torch.zeros(nx, nx, dtype=dt, device=dev)
    ks, Ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        A_t, B_t = A[t], B[t]
        Gx = lx[t] + Vx
        Gxx = lxx[t] + Vxx
        Qx = A_t.T @ Gx
        Qu = lu[t] + B_t.T @ Gx
        Qxx = A_t.T @ Gxx @ A_t
        Quu = luu[t] + B_t.T @ Gxx @ B_t
        Qux = B_t.T @ Gxx @ A_t
        L = torch.linalg.cholesky_ex(Quu + reg * eye_u + 1e-9 * eye_u,
                                     check_errors=False)[0]
        k_t = -torch.cholesky_solve(Qu[:, None], L)[:, 0]
        K_t = -torch.cholesky_solve(Qux, L)
        Vx = Qx + K_t.T @ Quu @ k_t + K_t.T @ Qu + Qux.T @ k_t
        Vxx = Qxx + K_t.T @ Quu @ K_t + K_t.T @ Qux + Qux.T @ K_t
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks[t], Ks[t] = k_t, K_t
    return torch.stack(ks), torch.stack(Ks)


def solve(
    m: PhysicsModel,
    cfg: ILQRConfig,
    cost_fn: rollout_mod.CostFn,
    state0: State,
    ctrl_seq: torch.Tensor,  # (H, nu) initial guess
    cmd: Command,
    prev_ctrl0: torch.Tensor,
    on_part: Optional[Callable[[str], None]] = None,
) -> ILQRResult:
    """iLQR from ``ctrl_seq``, on the device of its tensors. The loop
    never reads a tensor back: the line search's winner is chosen with
    ``torch.where``. ``on_part``, if given, is called with the name of
    each part as it is issued ("rollout": the initial guess's, once; then
    per iteration "linearize", "quadratize", "backward", "line_search"),
    for a caller that times them."""
    with maths.true_fp32():
        return _solve(m, cfg, cost_fn, state0, ctrl_seq, cmd, prev_ctrl0,
                      on_part or (lambda part: None))


def _solve(m, cfg, cost_fn, state0, ctrl_seq, cmd, prev_ctrl0, on_part):
    rcfg = cfg.rollout
    step_fn = _step_fn(m, rcfg)
    linearize = make_linearizer(cfg.linearize)
    dt, dev = ctrl_seq.dtype, ctrl_seq.device
    alphas = torch.as_tensor(cfg.alphas, dtype=dt, device=dev)

    def forward_passes(states, us, k, K):
        """Every step size's closed-loop rollout, batched over alphas."""
        nom = _prev_states(state0, states)
        st = State(*(x.expand(alphas.shape + x.shape) for x in state0))
        prev = prev_ctrl0.expand(alphas.shape + prev_ctrl0.shape)
        total = alphas.new_zeros(alphas.shape)
        cand_us, sts = [], []
        for t in range(us.shape[0]):
            dx = state_diff(m, st, State(*(x[t] for x in nom)))
            u = _clamp(m, us[t] + alphas[:, None] * k[t]
                       + maths.matvec(K[t], dx))
            st = step_fn(st, u)
            total = total + _stage_cost(cost_fn, st, u, prev, cmd)
            cand_us.append(u)
            sts.append(st)
            prev = u
        return torch.stack(cand_us, dim=1), _stack_states(sts, 1), total

    us = _clamp(m, ctrl_seq)
    states, cost = _traj_rollout(step_fn, cost_fn, state0, us, prev_ctrl0,
                                 cmd)
    on_part("rollout")
    cost0 = cost
    reg = torch.as_tensor(cfg.reg_init, dtype=dt, device=dev)
    history = []
    for _ in range(cfg.iterations):
        A, B = linearize(m, step_fn, state0, states, us, cfg.fd_eps)
        on_part("linearize")
        lx, lxx, lu, luu = quadratize_cost(m, cost_fn, cmd, states, us,
                                           prev_ctrl0)
        on_part("quadratize")
        k, K = _backward(A, B, lx, lxx, lu, luu, reg)
        on_part("backward")
        cand_us, cand_states, cand_cost = forward_passes(states, us, k, K)
        us, states, cost, improved = _select_best(
            cand_us, cand_states, cand_cost, us, states, cost)
        on_part("line_search")
        reg = torch.where(
            improved,
            torch.clamp_min(reg / cfg.reg_factor, 1e-6),
            torch.clamp_max(reg * cfg.reg_factor, cfg.reg_max),
        )
        history.append(cost)
    return ILQRResult(
        ctrl_seq=us, cost=cost, initial_cost=cost0, reg=reg,
        cost_history=(torch.stack(history) if history
                      else cost0.new_zeros(0)),
    )
