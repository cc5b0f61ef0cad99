"""Traffic driver ``env_steps``: an RL rollout's env steps. The actor
(``rl.networks.sample_action``) picks the actions of ``num_envs`` walking
environments and ``envs.vector_env.batched_autoreset_step`` steps them
through the substep kernel (``engine_impl="pallas"``), with auto-reset.

Parameters (``benchmark/traffic/<traffic>.json``): ``num_envs``, ``env``
(the ``WalkingConfig``: ``max_time``, ``frame_skip``, ``obs_window``,
``partial_obs``, ``random_controls``, ``random_init`` and the command's
``reset_options``), ``actor`` (``hidden`` widths, ``init_log_std``,
``out_scale`` of the last layer, ``bias_scale``) and ``warmup`` (steps
before the window). The actor's weights are drawn from the seed on the
device, standard normals over the square root of the fan-in, and loaded
into the port's ``ActorCritic``. Before step k the action generator and
the reset generator are seeded anew from (seed, k): the noise and the
fresh states are the benchmark's inputs. A step ends with a
synchronise. Every seed gives the same sizes and the same work.

The check: the start (the environments' first reset), the first
``reset_steps`` steps of the window in which some environment's episode
ended, and ``check_steps`` steps drawn from the seed over the window (a
reservoir sample, so no step is kept that the check will not read), each
recomputed by the plain reference in float64
(``benchmark/reference/env.py``) from the state and observation the
program stepped from: the reference follows the program step by step,
and the start is held by itself. Whether a step ended an episode is read
from a copy of its ``done`` that the step puts on the host before its
synchronise. Numbers compared (``gaps``): ``action_gap``, the widest gap
of an action; ``envs_off_share``, the largest share of the environments
of one checked step whose state gap or task gap lies outside the
workload's ``env_limits``;
``reset_gap``, the widest gap over the environments that the start or a
checked step reset (on either side) of all that a reset draws afresh.
"""

from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from quadruped_gym_tpu_torch.envs import vector_env
from quadruped_gym_tpu_torch.models import spec as program_spec
from quadruped_gym_tpu_torch.rl import networks
from quadruped_gym_tpu_torch.tasks import walking

from benchmark import harness
from benchmark.harness import Request

def step_seed(seed: int, k: int, stream: int) -> int:
    """The generator seed of step k's actions (stream 0) or resets (1);
    the start's reset is k = -1000."""
    return (seed * 0x9E3779B97F4A7C15 + (k + 1000) * 0xBF58476D1CE4E5B9
            + stream * 0x94D049BB133111EB) % 2**63


def actor_weights(sizes, actor: dict, seed: int, dtype, device):
    """(weights, biases, log_std) of the actor, from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        gain = actor["out_scale"] if i == len(sizes) - 2 else 1.0
        ws.append(gain / math.sqrt(sizes[i]) * torch.randn(
            (sizes[i + 1], sizes[i]), generator=g, dtype=dtype, device=device))
        bs.append(actor["bias_scale"] * torch.randn(
            (sizes[i + 1],), generator=g, dtype=dtype, device=device))
    log_std = torch.full((sizes[-1],), actor["init_log_std"], dtype=dtype,
                         device=device)
    return ws, bs, log_std


def walking_config(module, cfg: dict, env: dict, dtype):
    """The task's ``WalkingConfig`` of ``module`` (the port's ``walking``
    or the reference's copy), in ``dtype``."""
    cmd_mod = module.commands
    return module.WalkingConfig(
        max_time=env["max_time"], frame_skip=env["frame_skip"],
        obs_window=env["obs_window"], partial_obs=env["partial_obs"],
        random_controls=env["random_controls"],
        random_init=env["random_init"],
        reset_options=cmd_mod.SampleOptions.from_dict(env["reset_options"]),
        solver_iterations=cfg["newton"], dtype=dtype)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.dtype = getattr(torch, cell.config["dtype"])
        self.N = cell.traffic["num_envs"]
        self.kept: List[tuple] = []

    @torch.no_grad()
    def setup(self) -> None:
        cfg, tr, dev, dt = self.cell.config, self.cell.traffic, self.dev, self.dtype
        if cfg["line_search"] != 8:
            raise ValueError("batched_autoreset_step runs 8 line-search steps")
        m = getattr(program_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        self.m = m
        self.wcfg = walking_config(walking, cfg, tr["env"], dt)
        obs_dim = walking.obs_size(self.wcfg, m)
        self.sizes = [obs_dim, *tr["actor"]["hidden"], m.nu]
        self.weights = actor_weights(self.sizes, tr["actor"], self.seed, dt, dev)
        self.net = networks.ActorCritic(networks.NetConfig(
            obs_dim=obs_dim, act_dim=m.nu, hidden=tuple(tr["actor"]["hidden"])),
            dt, dev)
        for lin, w, b in zip(self.net.linears("actor"), *self.weights[:2]):
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        self.net.log_std.copy_(self.weights[2])
        self.agen = torch.Generator(device=dev)
        self.egen = torch.Generator(device=dev)
        self.egen.manual_seed(step_seed(self.seed, -1000, 1))
        self.start = walking.reset(m, self.wcfg, self.N, self.egen)
        self.done_host = (torch.empty(self.N, dtype=torch.bool, pin_memory=True)
                          if dev.type == "cuda" else None)
        st, obs = self.start
        for k in range(-tr["warmup"], 0):
            st, obs, _, _ = self._step(k, st, obs)
        self.st0, self.obs0 = st, obs

    def _step(self, k: int, st, obs):
        self.agen.manual_seed(step_seed(self.seed, k, 0))
        self.egen.manual_seed(step_seed(self.seed, k, 1))
        t0 = time.perf_counter()
        action, _ = networks.sample_action(self.net, obs, self.agen)
        out = vector_env.batched_autoreset_step(
            self.m, self.wcfg, st, torch.clamp(action, -1.0, 1.0), self.egen,
            engine_impl="pallas")
        if self.done_host is not None:
            self.done_host.copy_(out.done, non_blocking=True)
            torch.cuda.synchronize(self.dev)
        return out.state, out.obs, (action, out), Request(t0, time.perf_counter(), self.N)

    def _ended(self, out) -> bool:
        """Whether the step whose output is ``out`` ended some episode."""
        done = self.done_host if self.done_host is not None else out[1].done
        return bool(done.any())

    @torch.no_grad()
    def window(self, seconds: float, tracer=None) -> List[Request]:
        K = self.cell.workload["check_steps"]
        R = self.cell.workload["reset_steps"]
        rng = np.random.default_rng([self.seed, 3])
        st, obs, reqs, k = self.st0, self.obs0, [], 0
        self.resets = []
        t_begin = time.perf_counter()
        while True:
            new_st, new_obs, out, req = self._step(k, st, obs)
            item = (k, st, obs, out)
            if len(self.resets) < R and self._ended(out):
                self.resets.append(item)
            if k < K:
                self.kept.append(item)
            else:
                j = int(rng.integers(0, k + 1))
                if j < K:
                    self.kept[j] = item
            st, obs = new_st, new_obs
            reqs.append(req)
            k += 1
            if tracer is not None:
                tracer.tick(len(reqs))
            if req.end - t_begin >= seconds and (tracer is None
                                                 or tracer.done(len(reqs))):
                self.attempted = k
                return reqs

    def sample(self):
        """(inputs, program outputs, failed, attempted) of the checked
        steps; the program's state goes here."""
        from benchmark.reference import env as ref_env

        kept = sorted({x[0]: x for x in self.kept + self.resets}.values(),
                      key=lambda x: x[0])
        inputs, outputs, failed = [], [], 0
        for k, st, obs, (action, out) in kept:
            inputs.append(ref_env.StepInput(
                state=st, obs=obs, action_seed=step_seed(self.seed, k, 0),
                reset_seed=step_seed(self.seed, k, 1)))
            outputs.append(ref_env.StepOutput(
                action=action, state=out.state, obs=out.obs, reward=out.reward,
                done=out.done, reward_components=out.reward_components))
            failed += int(not (bool(torch.isfinite(out.obs).all())
                               and bool(torch.isfinite(out.reward).all())))
        start = self.start
        self.kept, self.resets, self.st0, self.obs0 = [], [], None, None
        self.start, self.net = None, None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return inputs, (start, outputs), failed, self.attempted

    def reference(self, inputs, dtype, lanes=None):
        """The reference's (start, step outputs) for ``inputs``, in
        ``dtype``, ``lanes`` environments a pass."""
        from benchmark.reference import env as ref_env
        from benchmark.reference import spec as ref_spec
        from benchmark.reference import walking as ref_walking

        cfg, tr = self.cell.config, self.cell.traffic
        steps = inputs
        rm = getattr(ref_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        draw_cfg = walking_config(ref_walking, cfg, tr["env"], self.dtype)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(step_seed(self.seed, -1000, 1))
        ref_start = ref_walking.reset(rm, draw_cfg, self.N, gen)
        w = ref_env.ActorWeights(*self.weights)
        per = max(1, (lanes or self.cell.workload["check_lanes"]) // self.N)
        out = []
        for i in range(0, len(steps), per):
            out += ref_env.step(rm, draw_cfg, draw_cfg, w, steps[i:i + per],
                                cfg["newton"], cfg["line_search"], dtype)
        return ref_start, out

    def check(self) -> dict:
        inputs, outputs, failed, n = self.sample()
        ref = self.reference(inputs, torch.float64)
        return harness.judge(gaps(outputs, ref, self.cell.workload),
                             self.cell.workload["limits"], failed, n)


def reference_many(pairs, dtype, lanes=None) -> list:
    """The references of several drivers' samples, one driver at a time
    (a pass over one step's environments is cheap)."""
    return [drv.reference(inputs, dtype, lanes) for drv, inputs in pairs]


def per_env(pairs) -> torch.Tensor:
    """(N,) the widest gap of each environment over the (program,
    reference) pairs of (N, ...) tensors, each field's gap over its
    largest magnitude in the reference or 1; booleans differ by 1."""
    cols = []
    for p, q in pairs:
        p, q = p.double().cpu(), q.double().cpu()
        scale = max(1.0, float(q.abs().max())) if q.numel() else 1.0
        cols.append(((p - q).abs() / scale).reshape(p.shape[0], -1).amax(1))
    return torch.stack(cols).amax(0).nan_to_num(nan=math.inf)


def fresh(ws, obs) -> list:
    """What a reset draws afresh: every field of a walking state but the
    estimator's and the reward's carries, which survive it, and the
    observation."""
    return [*ws.phys, *ws.cmd, ws.ideal_position, *ws.obs, ws.applied_ctrl, obs]


def gaps(outputs, ref, workload: dict) -> dict:
    """The numbers compared over the start and the checked steps
    (``outputs`` and ``ref`` are each (start, step outputs)): the widest
    action gap; the largest share of the environments of one step whose
    state gap (physics state, sensors and whether the episode ended) or
    task gap (observation, reward and its components) lies outside the
    workload's ``env_limits``; and the widest gap of what a reset draws afresh, over
    the environments reset. A few environments of 2,048 a step part by up
    to ~0.1 between any two float32 orders (the fixed-budget Newton line
    search branches on rounding in violent contacts), the program and the
    float32 reference alike: ``envs_off_share`` allows for them. A reset
    environment's fresh state is drawn from the seed and bifurcates on
    nothing, so it is held at its widest."""
    lim = workload["env_limits"]
    (st, obs), steps = outputs
    (rst, robs), ref_steps = ref
    reset = per_env(zip(fresh(st, obs), fresh(rst, robs)))
    resets, off = [float(reset.max())], []
    n_reset = st.phys.qpos.shape[0]
    action_gap = 0.0
    state_w, task_w = [], []
    for p, r in zip(steps, ref_steps):
        a = float((p.action.double() - r.action.double().to(p.action.device)).abs().max())
        action_gap = max(action_gap, a if math.isfinite(a) else math.inf)
        ps, rs = p.state.phys, r.state.phys
        s = per_env([(ps.qpos, rs.qpos), (ps.qvel, rs.qvel), (ps.act, rs.act),
                     (ps.sensordata, rs.sensordata), (p.done, r.done)])
        k = per_env([(p.obs, r.obs), (p.reward[:, None], r.reward[:, None]),
                     (p.reward_components, r.reward_components)])
        off.append(int(((s > lim["state_gap"]) | (k > lim["task_gap"])).sum()) / s.numel())
        state_w.append(float(s.max()))
        task_w.append(float(k.max()))
        ended = (p.done.cpu() | r.done.cpu()).bool()
        if ended.any():
            g = per_env(zip(fresh(p.state, p.obs), fresh(r.state, r.obs)))
            resets.append(float(g[ended].max()))
            n_reset += int(ended.sum())
    return {"action_gap": action_gap, "envs_off_share": max(off, default=0.0),
            "reset_gap": max(resets), "resets_checked": n_reset,
            "steps_checked": len(off),
            "state_gap_widest": max(state_w, default=0.0),
            "task_gap_widest": max(task_w, default=0.0)}
