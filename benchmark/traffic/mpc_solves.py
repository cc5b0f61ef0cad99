"""Traffic driver ``mpc_solves``: back-to-back MPPI solves through the
port's ``runtime.mpc_runtime.plan_and_act``, one controller warm-starting
each solve from the last.

Parameters (``benchmark/traffic/<traffic>.json``): ``num_samples`` (S),
``horizon`` (H), ``sigma`` and ``temperature`` of MPPI, ``command`` (the
forward velocity, m/s, and the heading, rad), ``bank`` (the name of a
file of start states in ``benchmark/banks/``) and ``warmup`` (solves
before the window).

Solve k starts from state ``k mod n`` of the bank, in an order drawn
from the seed (every seed has the same states), with the plan and the
previous control that solve k-1 returned (the shifted plan: the
receding-horizon warm start), solve 0 from the joint centres. Its noise
generator is seeded anew from (seed, k), so every solve's noise is the
benchmark's input. A solve ends when its control has been read back to
the host. Every seed gives the same sizes and the same amount of work.

The check: solves 0 and 1 and more drawn from the seed among those the
window finished, ``check_solves`` in all, recomputed from the same
inputs by the plain reference in float64 (``benchmark/reference/mpc.py``)
in one pass. Solve 0 starts from the benchmark's own plan; every other
checked solve from the program's shifted plan, which the reference
follows, and each checked solve's own shift is compared, so every stage
of the chain is held somewhere (solve 1 starts from solve 0's, held to
the reference's). Each checked solve is held to the workload's
``solve_limits``: ``cost_gap``, the larger relative gap of the best and
of the mean rollout cost (the mean is over all S rollouts), and
``plan_gap``, the widest gap, in control units, of the applied control
and of the shifted plan. The number compared, ``solves_off_share``, is
the share of the checked solves outside either limit: a solve whose plan
follows a rollout that bifurcates on rounding may read off, and the
workload's limit says how many may (a run that finished fewer solves than
``check_solves`` checks them all, and one off solve weighs more). The
widest and median gaps are printed beside it.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import List

import numpy as np
import torch

from quadruped_gym_tpu_torch.models import spec as program_spec
from quadruped_gym_tpu_torch.physics.engine import State
from quadruped_gym_tpu_torch.runtime import mpc_runtime
from quadruped_gym_tpu_torch.solvers import mppi, rollout
from quadruped_gym_tpu_torch.tasks import commands

from benchmark import harness
from benchmark.harness import Request

JOINT_CENTERS = [0.0, 0.0, -0.5] * 4


def noise_seed(seed: int, k: int) -> int:
    """The generator seed of solve k (warm-up solves have k < 0)."""
    return (seed * 0x9E3779B97F4A7C15 + (k + 1000) * 0xBF58476D1CE4E5B9) % 2**63


def bank(traffic: dict, seed: int) -> np.ndarray:
    """(n, nq + nv + na + nsens) float64 start states: the traffic's bank
    file, its rows in an order drawn from the seed."""
    states = np.asarray(harness.load_json(
        harness.BENCH_DIR, "banks", traffic["bank"] + ".json")["states"],
        dtype=np.float64)
    return states[np.random.default_rng([seed, 1]).permutation(len(states))]


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.dtype = getattr(torch, cfg["dtype"])
        self.S, self.H = tr["num_samples"], tr["horizon"]
        self.solves: List[tuple] = []

    def setup(self) -> None:
        cfg, tr, dev, dt = self.cell.config, self.cell.traffic, self.dev, self.dtype
        m = getattr(program_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        self.m = m
        self.mpc = mpc_runtime.MPCConfig(
            solver="mppi",
            mppi=mppi.MPPIConfig(
                num_samples=self.S, sigma=tr["sigma"],
                temperature=tr["temperature"], iterations=1,
                rollout=rollout.RolloutConfig(horizon=self.H,
                                              frame_skip=cfg["frame_skip"]),
                lane=True, lane_newton_iterations=cfg["newton"],
                lane_ls_iterations=cfg["line_search"],
                lane_engine_impl="fused"))
        self.cost_fn = rollout.make_cost_fn(m)
        v, heading = tr["command"]
        self.cmd = commands.make(torch.tensor([v, 0.0], dtype=dt, device=dev),
                                 torch.tensor(heading, dtype=dt, device=dev))
        rows = torch.as_tensor(bank(tr, self.seed), dtype=dt).to(dev)
        nq, nv, na = m.nq, m.nv, m.na
        zero = torch.zeros((), dtype=dt, device=dev)
        self.states = [State(qpos=r[:nq], qvel=r[nq:nq + nv],
                             act=r[nq + nv:nq + nv + na], time=zero,
                             sensordata=r[nq + nv + na:]) for r in rows]
        self.gen = torch.Generator(device=dev)
        centers = torch.tensor(JOINT_CENTERS, dtype=dt, device=dev)
        self.carry0 = mpc_runtime.MPCCarry(
            mean=centers[None].repeat(self.H, 1),
            sigma=torch.zeros((self.H, m.nu), dtype=dt, device=dev),
            prev_ctrl=centers, generator=self.gen)
        carry = self.carry0
        for k in range(-tr["warmup"], 0):
            carry, _ = self._solve(k, carry)

    def _solve(self, k: int, carry):
        """Solve k from ``carry``: (new carry, the request)."""
        self.gen.manual_seed(noise_seed(self.seed, k))
        state = self.states[k % len(self.states)]
        t0 = time.perf_counter()
        ctrl, new, info = mpc_runtime.plan_and_act(
            self.m, self.mpc, self.cost_fn, carry, state, self.cmd)
        ctrl.cpu()  # the control on the host: the solve is done
        t1 = time.perf_counter()
        if k >= 0:
            self.solves.append((k, carry, new, ctrl, info))
        return new, Request(t0, t1, self.S)

    def window(self, seconds: float, tracer=None) -> List[Request]:
        carry, reqs, k = self.carry0, [], 0
        t_begin = time.perf_counter()
        while True:
            carry, req = self._solve(k, carry)
            reqs.append(req)
            k += 1
            if tracer is not None:
                tracer.tick(len(reqs))
            if req.end - t_begin >= seconds and (tracer is None
                                                 or tracer.done(len(reqs))):
                return reqs

    def sample(self):
        """The checked solves, drawn from the seed among those the window
        finished: (inputs, program outputs, failed, attempted). The
        program's state goes here, before any reference runs."""
        from benchmark.reference import mpc as ref_mpc

        n = len(self.solves)
        finite = torch.stack([torch.isfinite(s[3]).all()
                              & torch.isfinite(s[4]["best_cost"])
                              for s in self.solves]).cpu()
        failed = int((~finite).sum())
        picked = pick(n, self.cell.workload["check_solves"], self.seed)
        inputs, outputs = [], []
        for i in picked:
            k, carry_in, new, ctrl, info = self.solves[i]
            st = self.states[k % len(self.states)]
            inputs.append(ref_mpc.SolveInput(
                qpos=st.qpos, qvel=st.qvel, act=st.act, time=st.time,
                sensordata=st.sensordata, mean=carry_in.mean,
                prev_ctrl=carry_in.prev_ctrl,
                noise_seed=noise_seed(self.seed, k)))
            outputs.append((ctrl, new.mean, info["best_cost"],
                            info["mean_cost"]))
        self.solves = []
        self.states = self.carry0 = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return inputs, outputs, failed, n

    def reference(self, inputs, dtype, lanes=None):
        """The plain reference's outputs for ``inputs``, computed in
        ``dtype``, ``lanes`` rollouts a pass (the workload's
        ``check_lanes``)."""
        from benchmark.reference import commands as ref_commands
        from benchmark.reference import mpc as ref_mpc
        from benchmark.reference import spec as ref_spec

        cfg, tr = self.cell.config, self.cell.traffic
        lanes = lanes or self.cell.workload["check_lanes"]
        rm = getattr(ref_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        v, heading = tr["command"]
        f64 = torch.float64
        cmd = ref_commands.make(torch.tensor([v, 0.0], dtype=f64),
                                torch.tensor(heading, dtype=f64))
        return ref_mpc.solve(
            rm, inputs, cmd, num_samples=self.S, sigma=tr["sigma"],
            temperature=tr["temperature"], frame_skip=cfg["frame_skip"],
            newton=cfg["newton"], line_search=cfg["line_search"],
            noise_dtype=self.dtype, dtype=dtype,
            block=max(1, lanes // self.S))

    def check(self) -> dict:
        inputs, outputs, failed, n = self.sample()
        ref = self.reference(inputs, torch.float64)
        return harness.judge(gaps(outputs, ref, self.cell.workload),
                             self.cell.workload["limits"], failed, n)


def reference_many(pairs, dtype, lanes=None) -> list:
    """The references of several drivers' samples (one per seed) in
    shared passes: the eager engine's time is its launches, whatever the
    lanes, so a pass over several seeds' solves costs about one."""
    drv = pairs[0][0]
    flat = drv.reference([x for _, inputs in pairs for x in inputs], dtype,
                         lanes)
    out, i = [], 0
    for _, inputs in pairs:
        out.append(flat[i:i + len(inputs)])
        i += len(inputs)
    return out


def pick(n: int, count: int, seed: int) -> list:
    """The indices of the checked solves among the window's ``n``: 0 and
    1, and the rest drawn from the seed."""
    head = list(range(min(2, n, count)))
    rest = np.random.default_rng([seed, 2]).choice(
        np.arange(len(head), n), size=min(count, n) - len(head), replace=False)
    return head + sorted(rest.tolist())


def per_solve(outputs, ref) -> list:
    """(cost gap, plan gap) of each checked solve: the larger relative gap
    of its best and mean rollout cost, and the widest gap of its applied
    control and shifted plan, in control units."""
    out = []
    for (ctrl, carry_mean, best, mean_cost), r in zip(outputs, ref):
        cost = 0.0
        for p, q in ((best, r.best_cost), (mean_cost, r.mean_cost)):
            p, q = float(p), float(q)
            cost = max(cost, abs(p - q) / abs(q) if math.isfinite(p) else math.inf)
        plan = max(float((p.double().to(q.device) - q.double()).abs().max())
                   for p, q in ((ctrl, r.ctrl), (carry_mean, r.carry_mean)))
        out.append((cost, plan if math.isfinite(plan) else math.inf))
    return out


def gaps(outputs, ref, workload: dict) -> dict:
    """The number compared, ``solves_off_share``: the share of the checked
    solves outside the workload's ``solve_limits`` (a NaN gap is outside). In every solve a
    few tenths of a percent of the rollouts bifurcate on rounding (any two
    float32 orders part by 1-16 % on them, B1 and the reference alike);
    where one of them weighs in MPPI's update the plan moves with it. The
    widest and median gaps are read beside it."""
    lim = workload["solve_limits"]
    cost, plan = zip(*per_solve(outputs, ref))
    off = sum(not (c <= lim["cost_gap"] and p <= lim["plan_gap"])
              for c, p in zip(cost, plan))
    return {"solves_off_share": off / len(cost), "solves_off": off,
            "solves_checked": len(cost),
            "cost_gap_widest": max(cost), "plan_gap_widest": max(plan),
            "cost_gap_median": statistics.median(cost),
            "plan_gap_median": statistics.median(plan)}
