"""Instrumented dissection of one SQP iteration of the gait solve, with the
PyTorch port.

Counterpart of ``scripts/diag_gait.py`` for ``quadruped_gym_tpu_torch``,
on the card unless ``--cpu`` is given. It runs each stage of
``solvers/sqp.py``'s iteration separately on the fast plant from the
settled stance (``examples/torch_gait_sqp.py``'s ``settle_state``) and a
trot-phased sine warm start (or the standing hold), in order:

1. the rollout of the warm start (its states and cost);
2. the linearization (``--linearize ad|fd``): A, B and the spectral norm
   of the products A_t ... A_0 (the sensitivity propagation's growth);
3. the quadratization of the stage cost (lx, lxx, lu, luu);
4. the sensitivities F, the condensation and ``_add_control_blocks``,
   then the eigenvalues and condition number of the QP's Hessian;
5. ``admm_box_qp`` at a regularization of 1e-3: ||du|| and the predicted
   decrease g'du;
6. the line search over six step sizes (all six rollouts as one batch).

It prints each array's shape, largest magnitude and NaN / Inf counts, so
the failing stage is identified instead of guessed, and ``main`` returns
every stage's arrays as well (float64 numpy). The JAX script's eps of the
FD linearization is kept: 1e-3 in float32, 1e-5 in float64.

Run:  python scripts/torch_diag_gait.py --horizon 12 [--f64] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quadruped_gym_tpu_torch._device import (  # noqa: E402
    card_line, repo_module, resolve_device)
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine, maths  # noqa: E402
from quadruped_gym_tpu_torch.physics.engine import State  # noqa: E402
from quadruped_gym_tpu_torch.solvers import ilqr, rollout, sqp  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402

ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
REG = 1e-3



def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--horizon", type=int, default=12)
    p.add_argument("--frame-skip", type=int, default=5)
    p.add_argument("--linearize", choices=("ad", "fd"), default="ad")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--smooth-eps", type=float, default=0.02)
    p.add_argument("--init", choices=("sine", "hold"), default="sine")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def stat(name, x) -> dict:
    """Print and return the shape, largest magnitude and NaN / Inf counts
    of ``x``."""
    x = np.asarray(x)
    s = {"shape": list(x.shape), "max_abs": float(np.abs(x).max()),
         "nan": int(np.isnan(x).sum()), "inf": int(np.isinf(x).sum())}
    print(f"  {name}: shape={x.shape} |max|={s['max_abs']:.3e} "
          f"nan={s['nan']} inf={s['inf']}", flush=True)
    return s


def _np(x):
    return x.detach().to("cpu", torch.float64).numpy()


def stages(m, rcfg, cost_fn, cmd, prev, state0, us0, linearize, eps,
           sync=lambda: None) -> dict:
    """Every stage of one SQP iteration from ``state0`` and the warm start
    ``us0`` (H, nu), in order, each printed as it is done: the arrays
    (float64 numpy), their statistics and each stage's seconds."""
    H, nu = us0.shape
    dt, dev = us0.dtype, us0.device
    out = {"arrays": {}, "stats": {}, "seconds": {}}
    arrays, stats, secs = out["arrays"], out["stats"], out["seconds"]
    step_fn = ilqr._step_fn(m, rcfg)

    def keep(name, x):
        arrays[name] = _np(x)
        stats[name] = stat(name, arrays[name])

    def traj_rollout(us):
        """(..., H, nu) controls -> states stacked over H, (...) costs."""
        batch = us.shape[:-2]
        st = State(*(x.expand(batch + x.shape) for x in state0))
        pv = prev.expand(batch + prev.shape)
        total, sts = us.new_zeros(batch), []
        for t in range(H):
            u = us[..., t, :]
            st = step_fn(st, u)
            total = total + cost_fn(st.sensordata.movedim(-1, 0),
                                    u.movedim(-1, 0), pv.movedim(-1, 0), cmd)
            sts.append(st)
            pv = u
        return State(*(torch.stack(x, dim=len(batch)) for x in zip(*sts))), \
            total

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return res

    states, cost0 = timed("rollout", lambda: traj_rollout(us0))
    out["cost0"] = float(cost0)
    arrays["states_qpos"], arrays["states_qvel"] = (_np(states.qpos),
                                                    _np(states.qvel))
    print(f"rollout {secs['rollout']:.1f}s  cost0={out['cost0']:.3f}",
          flush=True)

    lin = ilqr.make_linearizer(linearize)
    A, B = timed("linearize", lambda: lin(m, step_fn, state0, states, us0,
                                          eps))
    print(f"linearize ({linearize}) {secs['linearize']:.1f}s", flush=True)
    keep("A", A)
    keep("B", B)
    # spectral growth of the A-products (the sensitivity propagation)
    Pn, norms = np.eye(A.shape[1]), []
    for t in range(H):
        Pn = arrays["A"][t] @ Pn
        norms.append(float(np.linalg.norm(Pn, 2)))
    out["A_product_norms"] = norms
    print(f"  ||A_t...A_0||_2 per t: {['%.1e' % n for n in norms]}",
          flush=True)

    lx, lxx, lu, luu = timed("quadratize", lambda: ilqr.quadratize_cost(
        m, cost_fn, cmd, states, us0, prev))
    print(f"quadratize {secs['quadratize']:.1f}s", flush=True)
    for name, x in (("lx", lx), ("lxx", lxx), ("lu", lu), ("luu", luu)):
        keep(name, x)

    def condensed():
        F = sqp.sensitivities(A, B)
        Hqp, g = sqp.condense(F, lx, lxx)
        return (F,) + sqp._add_control_blocks(Hqp, g, lu, luu)

    F, Hqp, g = timed("condense", condensed)
    keep("F", F)
    print(f"condense {secs['condense']:.1f}s", flush=True)
    keep("Hqp", Hqp)
    keep("g", g)
    Hs = 0.5 * (arrays["Hqp"] + arrays["Hqp"].T)
    ev = np.linalg.eigvalsh(Hs)
    out["eig_min"], out["eig_max"] = float(ev.min()), float(ev.max())
    out["cond"] = float(ev.max() / max(ev.min(), 1e-30))
    print(f"  eig(Hqp): min={ev.min():.3e} max={ev.max():.3e} "
          f"cond={out['cond']:.2e}", flush=True)

    box = torch.as_tensor(np.asarray(m.actuator_ctrlrange), dtype=dt,
                          device=dev)
    lo_u, hi_u = box[:, 0], box[:, 1]
    Hreg = (torch.as_tensor(Hs, dtype=dt, device=dev)
            + REG * torch.eye(H * nu, dtype=dt, device=dev))
    lo = lo_u.repeat(H) - us0.reshape(-1)
    hi = hi_u.repeat(H) - us0.reshape(-1)
    du = timed("qp", lambda: sqp.admm_box_qp(Hreg, g, lo, hi))
    keep("du", du)
    du_z = torch.where(torch.isfinite(du), du, 0.0).reshape(H, nu)
    out["du_norm"] = float(torch.linalg.norm(du_z))
    out["pred_decrease"] = float(g @ du_z.reshape(-1))
    print(f"  ||du|| = {out['du_norm']:.3e}  pred decrease g'du = "
          f"{out['pred_decrease']:.3e}", flush=True)

    alphas = torch.as_tensor(ALPHAS, dtype=dt, device=dev)
    cand = torch.clamp(us0 + alphas[:, None, None] * du_z, lo_u, hi_u)
    _, costs = timed("line_search", lambda: traj_rollout(cand))
    arrays["line_search_costs"] = _np(costs)
    out["line_search"] = []
    print(f"  line search (cost0 = {out['cost0']:.4f}):", flush=True)
    for a, c in zip(ALPHAS, arrays["line_search_costs"]):
        accept = bool(c < out["cost0"])
        out["line_search"].append({"alpha": a, "cost": float(c),
                                   "accept": accept})
        print(f"    alpha={a:5.2f}: cost={c:.4f}  "
              f"{'ACCEPT' if accept else 'reject'}", flush=True)
    return out


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    gait = repo_module("examples", "torch_gait_sqp")
    HOLD, settle_state = gait.HOLD, gait.settle_state
    dtype = torch.float64 if args.f64 else torch.float32

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    m = spec.get_fast_plant_model()
    H = args.horizon
    rcfg = rollout.RolloutConfig(horizon=H, frame_skip=args.frame_skip,
                                 max_contacts=12, solver_iterations=4)
    cost_fn = rollout.make_cost_fn(m, vel_smooth_eps=args.smooth_eps)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=dtype, device=device),
                        torch.tensor(0.0, dtype=dtype, device=device))
    prev = torch.as_tensor(HOLD, dtype=dtype, device=device)
    us0 = (gait.sine_warm_start(H, args.frame_skip * m.timestep, dtype, device)
           if args.init == "sine" else prev.repeat(H, 1))
    t0 = time.perf_counter()
    state0 = settle_state(dtype, device, gait.SETTLE_STEPS)
    sync()
    settle_s = time.perf_counter() - t0
    card = card_line(device)
    print(f"dtype={str(dtype).split('.')[-1]} H={H} settled "
          f"z={float(state0.qpos[2]):.4f} ({settle_s:.1f}s); {card}",
          flush=True)
    eps = 1e-5 if args.f64 else 1e-3
    with maths.true_fp32():
        report = stages(m, rcfg, cost_fn, cmd, prev, state0, us0,
                        args.linearize, eps, sync)
    report.update(device=card, dtype=str(dtype).split(".")[-1], horizon=H,
                  linearize=args.linearize, eps=eps, init=args.init,
                  settled_z=float(state0.qpos[2]), settle_s=settle_s)
    return report


if __name__ == "__main__":
    main()
