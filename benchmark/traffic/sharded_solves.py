"""Traffic driver ``sharded_solves``: ``mpc_solves``' back-to-back,
warm-started receding-horizon MPPI solves, each with its samples sharded
over the ranks of the cell's group through the port's multi-rank entry
point, ``parallel.sharded_mppi_plan`` on ``parallel.make_mesh(("sample",))``.

Parameters (``benchmark/traffic/<traffic>.json``): ``mpc_solves``' and
``ranks``, the group's size. ``num_samples`` is ONE RANK'S share, the S
of one launch of the fused rollout kernel on each card: a solve scores
``ranks`` x ``num_samples`` rollouts, and the per-card readers
(``b1_roofline_pct``, ``mfu_pct``) read it as the S of the traced card's
launch. A total there would make them read ``ranks`` times too high.

Solve k is ``mpc_solves``' solve k: the same start state, the same warm
start (solve 0 from the joint centres, every other from the shifted plan
and the control that solve k-1 returned), and on every rank a generator
seeded with ``mpc_solves.noise_seed(seed, k)``, replicated, from which
``sharded_mppi_plan`` folds each rank's stream. The applied control and
the shift are ``plan_and_act``'s. Every rank runs every solve (the
harness's lockstep window); a solve ends when rank 0 holds its control on
the host. A request's work is ``ranks`` x ``num_samples`` rollouts.

The check: ``mpc_solves``' sample of the window's solves (solves 0, 1 and
more from the seed, ``check_solves``), held to the workload's
``solve_limits`` by the plain reference in float64
(``benchmark/reference/sharded_mpc.py``), spread as the program is: each
rank scores its own slice of every checked solve on its card, the costs
are gathered to rank 0, and rank 0 draws the slices again and does the
update. The number compared is ``solves_off_share``.
"""

from __future__ import annotations

import time
from typing import List

import torch

from quadruped_gym_tpu_torch import parallel
from quadruped_gym_tpu_torch.models import spec as program_spec
from quadruped_gym_tpu_torch.physics.engine import State
from quadruped_gym_tpu_torch.solvers import mppi, rollout
from quadruped_gym_tpu_torch.tasks import commands

from benchmark.harness import Request
from benchmark.traffic import mpc_solves
from benchmark.traffic.mpc_solves import gaps, noise_seed, pick  # noqa: F401


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, ranks):
        self.cell, self.seed, self.dev, self.ranks = cell, seed, device, ranks
        cfg, tr = cell.config, cell.traffic
        if tr["ranks"] != ranks.world:
            raise ValueError(f"the traffic asks for {tr['ranks']} ranks; the "
                             f"group has {ranks.world}")
        self.dtype = getattr(torch, cfg["dtype"])
        self.S, self.H = tr["num_samples"], tr["horizon"]
        self.solves: List[tuple] = []

    def setup(self) -> None:
        cfg, tr, dev, dt = self.cell.config, self.cell.traffic, self.dev, self.dtype
        m = getattr(program_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        self.m = m
        self.mesh = parallel.make_mesh((parallel.SAMPLE_AXIS,), device=dev)
        self.cfg = mppi.MPPIConfig(
            num_samples=self.S * self.ranks.world, sigma=tr["sigma"],
            temperature=tr["temperature"], iterations=1,
            rollout=rollout.RolloutConfig(horizon=self.H,
                                          frame_skip=cfg["frame_skip"]),
            lane=True, lane_newton_iterations=cfg["newton"],
            lane_ls_iterations=cfg["line_search"], lane_engine_impl="fused")
        self.cost_fn = rollout.make_cost_fn(m)
        v, heading = tr["command"]
        self.cmd = commands.make(torch.tensor([v, 0.0], dtype=dt, device=dev),
                                 torch.tensor(heading, dtype=dt, device=dev))
        rows = torch.as_tensor(mpc_solves.bank(tr, self.seed), dtype=dt).to(dev)
        nq, nv, na = m.nq, m.nv, m.na
        zero = torch.zeros((), dtype=dt, device=dev)
        self.states = [State(qpos=r[:nq], qvel=r[nq:nq + nv],
                             act=r[nq + nv:nq + nv + na], time=zero,
                             sensordata=r[nq + nv + na:]) for r in rows]
        self.gen = torch.Generator(device=dev)
        centers = torch.tensor(mpc_solves.JOINT_CENTERS, dtype=dt, device=dev)
        self.start = (centers[None].repeat(self.H, 1), centers)
        self.plan = self.start
        for k in range(-tr["warmup"], 0):
            self.request(k)

    def request(self, k: int) -> Request:
        """Solve k on this rank, from the plan solve k-1 left (solve 0
        from the joint centres)."""
        if k == 0:
            self.plan = self.start
        mean, prev = self.plan
        self.gen.manual_seed(noise_seed(self.seed, k))
        state = self.states[k % len(self.states)]
        t0 = time.perf_counter()
        res = parallel.sharded_mppi_plan(
            self.m, self.cfg, self.cost_fn, state, mean, self.cmd, prev,
            self.gen, self.mesh)
        ctrl = res.mean[0]
        shifted = torch.cat([res.mean[1:], res.mean[-1:]], dim=0)
        ctrl.cpu()  # the control on the host: the solve is done
        t1 = time.perf_counter()
        if k >= 0:
            self.solves.append((k, mean, prev, shifted, ctrl, res.best_cost,
                                res.mean_cost))
        self.plan = (shifted, ctrl)
        return Request(t0, t1, self.cfg.num_samples)

    def window(self, seconds: float, tracer=None) -> List[Request]:
        return self.ranks.window(self.request, seconds, tracer)

    def sample(self):
        """The checked solves, drawn from the seed among those the window
        finished: (inputs, program outputs, failed, attempted). Every rank
        holds the inputs; the outputs and the count of failed solves are
        rank 0's. The program's state goes here."""
        from benchmark.reference import mpc as ref_mpc

        n = len(self.solves)
        failed = int(sum(not (torch.isfinite(s[4]).all()
                              and torch.isfinite(s[5])) for s in self.solves))
        inputs, outputs = [], []
        for i in pick(n, self.cell.workload["check_solves"], self.seed):
            k, mean, prev, shifted, ctrl, best, mean_cost = self.solves[i]
            st = self.states[k % len(self.states)]
            inputs.append(ref_mpc.SolveInput(
                qpos=st.qpos, qvel=st.qvel, act=st.act, time=st.time,
                sensordata=st.sensordata, mean=mean, prev_ctrl=prev,
                noise_seed=noise_seed(self.seed, k)))
            outputs.append((ctrl, shifted, best, mean_cost))
        self.solves = []
        self.states = self.start = self.plan = self.mesh = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return inputs, outputs, failed, n

    def reference(self, inputs, dtype, lanes=None):
        """The plain reference's outputs for ``inputs`` on rank 0 (None on
        the others), computed in ``dtype``: this rank's slice of each
        solve, ``lanes`` rollouts a pass (the workload's ``check_lanes``),
        then, on rank 0, the update over every rank's slice."""
        from benchmark.reference import commands as ref_commands
        from benchmark.reference import sharded_mpc as ref_sharded
        from benchmark.reference import spec as ref_spec

        cfg, tr = self.cell.config, self.cell.traffic
        lanes = lanes or self.cell.workload["check_lanes"]
        rm = getattr(ref_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        v, heading = tr["command"]
        f64 = torch.float64
        cmd = ref_commands.make(torch.tensor([v, 0.0], dtype=f64),
                                torch.tensor(heading, dtype=f64))
        mine = ref_sharded.slice_costs(
            rm, inputs, self.ranks.rank, cmd, self.S, tr["sigma"],
            cfg["frame_skip"], cfg["newton"], cfg["line_search"],
            self.dtype, dtype, max(1, lanes // self.S))
        costs = self.ranks.all_gather(mine.to(f64))  # (ranks, solves, S)
        if self.ranks.rank != 0:
            return None
        return ref_sharded.update(rm, inputs, costs, self.S, tr["sigma"],
                                  tr["temperature"], self.dtype, dtype)

    def check(self) -> dict:
        """The verdict on rank 0, None on the others."""
        from benchmark import harness

        inputs, outputs, failed, n = self.sample()
        ref = self.reference(inputs, torch.float64)
        if ref is None:
            return None
        return harness.judge(gaps(outputs, ref, self.cell.workload),
                             self.cell.workload["limits"], failed, n)


def reference_many(pairs, dtype, lanes=None) -> list:
    """The references of several drivers' samples (one per seed) in
    shared passes, on rank 0 (Nones on the others)."""
    drv = pairs[0][0]
    flat = drv.reference([x for _, inputs in pairs for x in inputs], dtype,
                         lanes)
    out, i = [], 0
    for _, inputs in pairs:
        out.append(None if flat is None else flat[i:i + len(inputs)])
        i += len(inputs)
    return out
