"""Host time and kernels of one oracle-engine substep against the batch
shape, on the card.

    python scripts/oracle_batch_scaling.py

For each batch shape: one ``physics.engine.step`` of the fast-plant model
(12 contacts, 4 Newton passes, float32) in the air and on the floor, the
host clock around it (synchronised, median of 3 after a warm-up), and the
kernels and device time one traced call ran (``torch.profiler``). Then
both linearizations of the gait's 50 steps (one substep each) and the
plain step at their batch shape, and ``torch.linalg.cholesky_ex`` and
``torch.cholesky_solve`` of 18 x 18 systems alone at every shape. The
gradient solvers batch the oracle engine over (H, 48) rows, (H, 2, 60)
perturbations and (alphas,) step sizes; PPO over (2048,) envs.
Prints one line per case and the card's name and power limit.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPES = [(1,), (6,), (2048,), (2400,), (50, 48), (6000,), (50, 2, 60)]


def traced(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = {}
    for e in ev:
        names[e.name] = names.get(e.name, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
    return 1e-6 * sum(e.time_range.elapsed_us() for e in ev), len(ev), top


def host_s(fn, reps=3):
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def main():
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.physics import engine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"linalg {torch.backends.cuda.preferred_linalg_library()}", flush=True)
    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_fast_plant_model()
    hold = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=dt, device=dev)
    air = engine.make_state(m, dt, dev)
    # on its feet: the reset state dropped for 0.3 s at 4 Newton passes
    ground = engine.control_step(m, air, hold, 150, max_contacts=12,
                                 solver_iterations=4)
    for label, st0 in (("in the air", air), ("on the floor", ground)):
        shapes(m, st0, hold, label, card)
    linearizers(m, ground, hold, card)
    linalg(card)


def shapes(m, st0, hold, label, card):
    from quadruped_gym_tpu_torch.physics import engine

    for shape in SHAPES:
        st = engine.State(*(x.expand(shape + x.shape).contiguous()
                            for x in st0))
        u = hold.expand(shape + hold.shape).contiguous()

        def step():
            return engine.step(m, st, u, max_contacts=12, solver_iterations=4)

        s = host_s(step)
        dev_s, n, top = traced(step)
        ncon = int(engine.forward(m, engine.State(*(x.reshape((-1,) + x.shape[
            len(shape):])[0] for x in st)), hold, max_contacts=12).ncon_active)
        print(f"step {label}, batch {shape}: {1e3 * s:.1f} ms host, {n} "
              f"kernels and copies, {1e3 * dev_s:.2f} ms on the card, {ncon} "
              f"active rows per robot; most launched: "
              f"{[(k[:90], v) for k, v in top]}; card: {card}", flush=True)


def linearizers(m, st0, hold, card):
    """Both linearizations of the gait's H=50 steps from ``st0``, and the
    plain engine at their batch shapes from the same states."""
    from quadruped_gym_tpu_torch.physics import engine, maths
    from quadruped_gym_tpu_torch.solvers import ilqr, rollout

    H, dev, dt = 50, hold.device, hold.dtype
    rcfg = rollout.RolloutConfig(horizon=H, frame_skip=1, max_contacts=12,
                                 solver_iterations=4)
    step_fn = ilqr._step_fn(m, rcfg)
    us = hold.repeat(H, 1)
    st = engine.State(*(x.expand((H,) + x.shape).contiguous() for x in st0))
    with maths.true_fp32():
        for name, fn in (
                ("ad_linearize", lambda: ilqr.ad_linearize(
                    m, step_fn, st0, st, us)),
                ("fd_linearize", lambda: ilqr.fd_linearize(
                    m, step_fn, st0, st, us, 3e-4)),
                ("step (50, 48) expanded", lambda: step_fn(
                    ilqr._expand_state(st, (48,)), us[:, None].expand(
                        H, 48, 12))),
                ("step (50, 48) contiguous", lambda: step_fn(
                    engine.State(*(x.contiguous() for x in ilqr._expand_state(
                        st, (48,)))), us[:, None].expand(H, 48, 12)))):
            s = host_s(fn, reps=1)
            dev_s, n, top = traced(fn)
            print(f"{name} (one substep of H={H} steps on the floor): "
                  f"{1e3 * s:.1f} ms host, {n} kernels and copies, "
                  f"{1e3 * dev_s:.2f} ms on the card; most launched: "
                  f"{[(k[:90], v) for k, v in top]}; card: {card}",
                  flush=True)


def linalg(card):
    dev, dt = torch.device("cuda"), torch.float32
    for shape in SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        R = torch.randn(shape + (18, 18), generator=g, device=dev, dtype=dt)
        A = R @ R.transpose(-1, -2) + 18 * torch.eye(18, device=dev, dtype=dt)
        b = torch.randn(shape + (18, 1), generator=g, device=dev, dtype=dt)
        L = torch.linalg.cholesky_ex(A)[0]
        s_c = host_s(lambda: torch.linalg.cholesky_ex(A))
        s_s = host_s(lambda: torch.cholesky_solve(b, L))
        _, n_c, _ = traced(lambda: torch.linalg.cholesky_ex(A))
        _, n_s, _ = traced(lambda: torch.cholesky_solve(b, L))
        print(f"linalg batch {shape}: cholesky_ex {1e3 * s_c:.2f} ms host, "
              f"{n_c} kernels; cholesky_solve {1e3 * s_s:.2f} ms, {n_s} "
              f"kernels; card: {card}", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    main()
