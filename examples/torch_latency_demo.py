"""Real-time MPC loop latency measurement with the PyTorch port
(BASELINE: <10 ms replan @100 Hz).

Counterpart of ``examples/latency_demo.py`` for
``quadruped_gym_tpu_torch``, the controller on the card unless ``--cpu``
is given. Two processes talk over the native shared-memory ``ControlBus``
(``native/control_bus.cc``), reproducing the onboard wiring:

  * PLANT process — the behavioural oracle stepping the robot in wall-clock
    time: every control period it applies the latest control read from the
    bus and publishes qpos/qvel back. The JAX example steps live CPU
    MuJoCo; this package carries no MuJoCo, so the plant steps the port's
    own oracle engine (``physics/engine.py``) on the ``full`` model (every
    collision geom of the robot, 24 contacts, the model's Newton budget)
    in float64 on the CPU (``device="cpu"``), after settling
    ``--settle-steps`` physics steps (400) under the standing control. It
    leaves the card to the controller. On the CPU a period of the oracle
    takes longer than the 10 ms it simulates: the plant runs behind wall
    time and says how far in its line.
  * CONTROLLER process (this one) — MPPI in the delayed-pipeline pattern
    (``mpc_runtime.delayed_closed_loop`` semantics): while control u_t
    actuates, the solve for u_{t+1} runs against the one-period state
    prediction (the oracle engine's ``control_step`` on the planning
    model, 12 contacts, 2 Newton passes); each period it reads the plant
    state, writes the previously-solved control, and solves the next. The
    samples are scored by the fused rollout kernel (``lane=True``,
    ``"fused"``, Newton/line-search 2/4; the JAX example scores them on
    its oracle engine, which is host-bound on the card).

Per-solve latency is recorded two ways:

  * ``sync_ms`` — wall clock around a fully synchronised solve;
  * ``pipelined_ms`` — amortized wall clock of K solves issued
    back-to-back with distinct inputs and synchronised once. The
    difference of the two is the host's launch and synchronisation
    overhead a solve does not overlap with the card's work.

Writes ``artifacts/torch_latency_report.json`` (or ``--out``) with
p50/p90/p99 of both, plus the achieved loop rate of the two-process
100 Hz drive; the JAX example's ``artifacts/latency_report.json`` is
never touched.

Run:  python examples/torch_latency_demo.py [--samples 1024] [--seconds 5]
          [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quadruped_gym_tpu_torch._device import (  # noqa: E402
    card_line, resolve_device)
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.native import ControlBus  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.runtime import mpc_runtime  # noqa: E402
from quadruped_gym_tpu_torch.solvers import mppi, rollout  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402

CTRL_DT = 0.01  # 100 Hz
HOLD = np.array([0.0, 0.0, -0.5] * 4)
DTYPE = torch.float32
PLANT_LIVE_TIMEOUT_S = 600.0

_PLANT = r"""
import os, sys, time
sys.path.insert(0, os.environ["QG_REPO"])
import torch
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.native import ControlBus
from quadruped_gym_tpu_torch.physics import engine

torch.set_num_threads(1)  # the host's other cores feed the controller
f64, cpu = torch.float64, "cpu"
m = spec.get_full_model()
st = engine.make_state(m, dtype=f64, device=cpu)
hold = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=f64)
for _ in range(int(os.environ["QG_SETTLE"])):  # settle before going live
    st = engine.step(m, st, hold)


def publish(st):
    bus.write_sensor(torch.cat([st.qpos, st.qvel]).numpy(), t=float(st.time))


bus = ControlBus.open(os.environ["QG_BUS"])
publish(st)  # live
dt = float(os.environ["QG_CTRL_DT"])
nsub = int(round(dt / m.timestep))
t_start = time.perf_counter()
t_end = t_start + float(os.environ["QG_SECONDS"])
steps = 0
next_t = time.perf_counter()
while time.perf_counter() < t_end:
    _seq, ctrl, _t = bus.read_ctrl()
    u = torch.clamp(torch.as_tensor(ctrl, dtype=f64), -1.0, 1.0)
    st = engine.control_step(m, st, u, nsub)
    publish(st)
    steps += 1
    next_t += dt
    sleep = next_t - time.perf_counter()
    if sleep > 0:
        time.sleep(sleep)
wall = time.perf_counter() - t_start
bus.close()
print(f"plant: {steps} periods, sim time {float(st.time):.2f}s in {wall:.2f}s "
      f"wall ({steps * dt / wall:.3f}x real time), base z "
      f"{float(st.qpos[2]):.3f}", flush=True)
"""


def mpc_config(samples: int = 1024,
               horizon: int = 50) -> mpc_runtime.MPCConfig:
    """The controller's MPPI: ``samples`` rollouts of ``horizon`` control
    steps through the fused kernel at Newton/line-search 2/4, and the
    predictor's contact and Newton budgets."""
    return mpc_runtime.MPCConfig(
        solver="mppi",
        mppi=mppi.MPPIConfig(
            num_samples=samples, lane=True, lane_engine_impl="fused",
            lane_newton_iterations=2, lane_ls_iterations=4,
            rollout=rollout.RolloutConfig(
                horizon=horizon, frame_skip=5,
                max_contacts=12, solver_iterations=2,
            ),
        ),
    )


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--measure-iters", type=int, default=50)
    p.add_argument("--settle-steps", type=int, default=400,
                   help="physics steps the plant settles before going live")
    p.add_argument("--cpu", action="store_true",
                   help="run the controller on the CPU instead of the card")
    p.add_argument("--out", default=os.path.join(
        _REPO, "artifacts", "torch_latency_report.json"))
    return p


def stats(xs) -> dict:
    xs = np.asarray(xs)
    return {
        "p50_ms": float(np.percentile(xs, 50)),
        "p90_ms": float(np.percentile(xs, 90)),
        "p99_ms": float(np.percentile(xs, 99)),
        "mean_ms": float(xs.mean()),
        "n": int(xs.size),
    }


def main(argv=None) -> dict:
    """Measure, drive the two-process loop, write the report; returns it.
    The bus is unlinked and the plant stopped however the drive ends."""
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    m = spec.get_planning_model()
    cfg = mpc_config(args.samples, args.horizon)
    cost_fn = rollout.make_cost_fn(m)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    st0 = engine.make_state(m, dtype=DTYPE, device=device)

    def solve(carry, qpos, qvel):
        phys = st0._replace(qpos=qpos.to(DTYPE), qvel=qvel.to(DTYPE))
        # one-period prediction (pipeline pattern) + plan
        pred = engine.control_step(
            m, phys, carry.prev_ctrl, cfg.plant_frame_skip,
            max_contacts=cfg.rollout.max_contacts,
            solver_iterations=cfg.rollout.solver_iterations,
        )
        ctrl, carry, info = mpc_runtime.plan_and_act(
            m, cfg, cost_fn, carry, pred, cmd)
        return ctrl, carry, info["best_cost"]

    def on_device(x):
        return torch.as_tensor(np.asarray(x), dtype=DTYPE, device=device)

    carry = mpc_runtime.init_carry(m, cfg, args.horizon, seed=0, dtype=DTYPE,
                                   device=device)
    qp0 = st0.qpos.double().cpu().numpy()
    qv0 = st0.qvel.double().cpu().numpy()
    card = card_line(device)

    print(f"first solve on {card}...", flush=True)
    t0 = time.perf_counter()
    ctrl, carry, _ = solve(carry, on_device(qp0), on_device(qv0))
    sync()
    print(f"first solve {time.perf_counter() - t0:.1f}s (kernel build and "
          f"model upload included)", flush=True)

    # --- (1) synchronised per-solve latency ---
    rng = np.random.default_rng(time.time_ns() % 2**32)

    def perturbed_qpos():
        return qp0 + np.concatenate([rng.normal(0, 1e-4, 7),
                                     rng.normal(0, 1e-3, 12)])

    sync_ms = []
    for _ in range(args.measure_iters):
        qp = perturbed_qpos()
        qv = qv0 + rng.normal(0, 1e-3, qv0.shape)
        t0 = time.perf_counter()
        ctrl, carry, _ = solve(carry, on_device(qp), on_device(qv))
        sync()
        sync_ms.append((time.perf_counter() - t0) * 1e3)

    # --- (2) pipelined / amortized latency ---
    K = args.measure_iters
    qps = [on_device(perturbed_qpos()) for _ in range(K)]
    qv = on_device(qv0)
    sync()
    t0 = time.perf_counter()
    for qp in qps:
        ctrl, carry, _ = solve(carry, qp, qv)
    sync()
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / K

    # --- (3) two-process 100 Hz drive over the shm bus ---
    name = f"/qgt_torch_latency_{os.getpid()}"  # one bus per process
    bus = ControlBus.create(name, nsensor=m.nq + m.nv, nctrl=m.nu)
    plant = None
    try:
        bus.write_ctrl(HOLD)
        bus.write_sensor(np.concatenate([qp0, qv0]))
        seq0 = bus.read_sensor()[0]
        env = dict(os.environ, QG_REPO=_REPO, QG_BUS=name,
                   QG_CTRL_DT=str(CTRL_DT), QG_SECONDS=str(args.seconds),
                   QG_SETTLE=str(args.settle_steps))
        plant = subprocess.Popen([sys.executable, "-c", _PLANT], env=env,
                                 stdout=subprocess.PIPE, text=True)
        # the plant imports torch and settles first: wait until it is live
        t_live = time.perf_counter()
        while bus.read_sensor()[0] == seq0:
            if plant.poll() is not None:
                raise RuntimeError(f"the plant exited ({plant.returncode}) "
                                   "before going live")
            if time.perf_counter() - t_live > PLANT_LIVE_TIMEOUT_S:
                raise RuntimeError("the plant did not go live")
            time.sleep(0.01)
        print(f"plant live after {time.perf_counter() - t_live:.1f}s "
              f"(start-up and {args.settle_steps} settling steps)",
              flush=True)

        loop_ms, deadline_misses, periods = [], 0, 0
        pending = on_device(HOLD)
        t_end = time.perf_counter() + args.seconds
        next_t = time.perf_counter()
        while time.perf_counter() < t_end:
            t0 = time.perf_counter()
            _seq, state, _t = bus.read_sensor()
            bus.write_ctrl(pending.double().cpu().numpy())
            ctrl, carry, _ = solve(carry, on_device(state[: m.nq]),
                                   on_device(state[m.nq:]))
            sync()
            pending = ctrl
            dt_ms = (time.perf_counter() - t0) * 1e3
            loop_ms.append(dt_ms)
            if dt_ms > CTRL_DT * 1e3:
                deadline_misses += 1
            periods += 1
            next_t += CTRL_DT
            sleep = next_t - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
            else:
                next_t = time.perf_counter()  # fell behind: resync
        plant_out, _ = plant.communicate(timeout=120 + args.seconds)
        if plant.returncode != 0:
            raise RuntimeError(f"the plant failed ({plant.returncode})")
    finally:
        if plant is not None and plant.poll() is None:
            plant.kill()
            plant.wait()
        bus.close()
        bus.unlink()

    report = {
        "config": {
            "solver": "mppi",
            "samples": args.samples,
            "horizon": args.horizon,
            "control_rate_hz": 1.0 / CTRL_DT,
            "device": str(device),
            "card": card,
            "scoring": "fused rollout kernel, Newton/line-search 2/4",
            "plant": "port oracle engine, full model, float64, CPU",
        },
        "sync_solve": stats(sync_ms),
        "pipelined_solve": {"amortized_ms": pipelined_ms, "k": K},
        "launch_sync_overhead_ms_estimate": float(
            np.percentile(sync_ms, 50) - pipelined_ms
        ),
        "two_process_loop": {
            **stats(loop_ms),
            "periods": periods,
            "deadline_misses": deadline_misses,
            "deadline_ms": CTRL_DT * 1e3,
            "plant_stdout": plant_out.strip(),
        },
        "note": (
            "sync_solve synchronises the card after every solve; "
            "pipelined_solve issues K solves back-to-back and synchronises "
            "once. Their difference estimates the host's launch and "
            "synchronisation overhead that a solve does not overlap with "
            "the card's work. A solve's one-period prediction steps the "
            "oracle engine at batch 1, host-bound."
        ),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["sync_solve"]))
    print(f"pipelined amortized: {pipelined_ms:.2f} ms/solve")
    print(f"two-process loop: p50 {report['two_process_loop']['p50_ms']:.1f} "
          f"ms, misses {deadline_misses}/{periods}")
    print(report["two_process_loop"]["plant_stdout"])
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
