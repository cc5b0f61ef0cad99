"""Traffic driver ``full_env_steps``: ``env_steps``'s RL rollout (the same
parameters, the same window and the same check) on a model whose plain
reference steps the lane engine (``benchmark/reference/full_env.py``):
the ``full`` collision model, whose base and hip servos collide too.

At set-up the driver refuses, in one line, a program whose
``walking.batched_engine(m, "pallas")`` is not the substep kernel's
wrapper: such a program would step the model on an eager engine for the
whole window (and a traced run would hold millions of events).

The check adds one step to ``env_steps``'s: the pressed step. The
window's start states (after the warm-up) with every base put at a
height drawn from the seed, uniform in [0, ``press.height``), stepped by
the timed entry (the same CUDA graph, after the window) and held to the
reference. Pressed below ~3 cm the hip servos touch the ground, below
~1 cm the frame too, so a fault in the base's contact groups shows here
even where the window's robots stand. Compared: ``pressed_envs_off_share``,
the share of its environments past the workload's ``env_limits``; its
action and reset gaps join the window's. Read beside them: the share of
its environments in which the reference's collision finds the frame, a
hip servo, or any geom on the base, touching.
"""

from __future__ import annotations

import os
import sys

import torch

from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.tasks import walking

from benchmark import harness

env_steps = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "env_steps.py"),
    "bench_traffic_env_steps")
gaps = env_steps.gaps
reference_many = env_steps.reference_many

# the step index of the pressed step's seeds (the window's are >= -warmup,
# the start's -1000)
PRESS_K = -2000


def pressed(st, z):
    """The walking state ``st`` with each environment's base at height
    ``z`` (N,)."""
    qpos = st.phys.qpos.clone()
    qpos[:, 2] = z.to(qpos.dtype)
    return st._replace(phys=st.phys._replace(qpos=qpos))


def touching(st) -> dict:
    """The shares of the environments of ``st`` in which the reference's
    collision finds the frame, a hip servo, or any geom on the base in
    contact."""
    from benchmark.reference import lane_physics
    from benchmark.reference import spec as ref_spec

    m = ref_spec.get_full_model()
    q = st.phys.qpos.double().cpu()
    kin = lane_physics._fk(m, q.T.contiguous())
    G = len(m.col_geom_names)
    on = lane_physics._collide(m, kin).active.reshape(G, -1, q.shape[0]).any(1)
    base = lane_physics._static(m).root

    def share(pick):
        rows = [g for g in range(G) if pick(g)]
        return float(on[rows].any(0).double().mean())

    return {
        "pressed_frame_touch_share": share(
            lambda g: m.col_geom_names[g].startswith("FRAME")),
        "pressed_hip_touch_share": share(
            lambda g: m.col_geom_names[g].startswith("hip_servo")),
        "pressed_base_touch_share": share(
            lambda g: m.col_geom_bodyid[g] == base)}


class Driver(env_steps.Driver):
    @torch.no_grad()
    def setup(self) -> None:
        from quadruped_gym_tpu_torch.models import spec as program_spec

        cfg = self.cell.config
        m = getattr(program_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        if walking.batched_engine(m, "pallas") is not cuda_engine:
            print(f"benchmark: {cfg['model']['getter']}() does not take the "
                  "substep kernel (walking.batched_engine(m, 'pallas') is not "
                  "ops.cuda_engine); the cell needs it", file=sys.stderr)
            raise SystemExit(6)
        super().setup()

    @torch.no_grad()
    def press(self):
        """The pressed step, through the timed entry: (its input, its
        output, whether it failed). Run after the window, before
        ``sample`` lets go of the start states and the actor."""
        from benchmark.reference import env as ref_env

        gen = torch.Generator(device=self.dev)
        gen.manual_seed(env_steps.step_seed(self.seed, PRESS_K, 2))
        z = self.cell.workload["press"]["height"] * torch.rand(
            (self.N,), generator=gen, dtype=torch.float64, device=self.dev)
        st = pressed(self.st0, z)
        _, _, (action, out), _ = self._step(PRESS_K, st, self.obs0)
        x = ref_env.StepInput(
            state=st, obs=self.obs0,
            action_seed=env_steps.step_seed(self.seed, PRESS_K, 0),
            reset_seed=env_steps.step_seed(self.seed, PRESS_K, 1))
        y = ref_env.StepOutput(
            action=action, state=out.state, obs=out.obs, reward=out.reward,
            done=out.done, reward_components=out.reward_components)
        bad = not (bool(torch.isfinite(out.obs).all())
                   and bool(torch.isfinite(out.reward).all()))
        return x, y, bad

    def reference(self, inputs, dtype, lanes=None):
        """The reference's (start, step outputs) for ``inputs``, in
        ``dtype``, ``lanes`` environments a pass: ``env_steps``'s, with the
        physics through the reference's lane engine."""
        from benchmark.reference import env as ref_env
        from benchmark.reference import full_env
        from benchmark.reference import spec as ref_spec
        from benchmark.reference import walking as ref_walking

        cfg, tr = self.cell.config, self.cell.traffic
        rm = getattr(ref_spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
        draw_cfg = env_steps.walking_config(ref_walking, cfg, tr["env"], self.dtype)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(env_steps.step_seed(self.seed, -1000, 1))
        ref_start = ref_walking.reset(rm, draw_cfg, self.N, gen)
        w = ref_env.ActorWeights(*self.weights)
        per = max(1, (lanes or self.cell.workload["check_lanes"]) // self.N)
        out = []
        for i in range(0, len(inputs), per):
            out += full_env.step(rm, draw_cfg, draw_cfg, w, inputs[i:i + per],
                                 cfg["newton"], cfg["line_search"], dtype)
        return ref_start, out

    def check(self) -> dict:
        px, py, pbad = self.press()
        inputs, outputs, failed, n = self.sample()
        ref_start, ref_out = self.reference(inputs + [px], torch.float64)
        found = gaps(outputs, (ref_start, ref_out[:-1]), self.cell.workload)
        start = (px.state, px.obs)
        p = gaps((start, [py]), (start, ref_out[-1:]), self.cell.workload)
        for k in ("action_gap", "reset_gap"):
            found[k] = max(found[k], p[k])
        found["resets_checked"] += p["resets_checked"] - self.N
        found["pressed_envs_off_share"] = p["envs_off_share"]
        found["pressed_state_gap_widest"] = p["state_gap_widest"]
        found.update(touching(px.state))
        return harness.judge(found, self.cell.workload["limits"],
                             failed + int(pbad), n + 1)
