"""The check fails what it must, on the CPU at a size a test run holds:
the bfloat16 control (the reference put in the program's place in the
precision below the configuration's), and the faults a cell can have,
planted under a run whose look for a card is skipped."""

import argparse
import json

import pytest
import torch

from benchmark.tests._bench import TINY, TINY_ENV

from benchmark import control, harness
from quadruped_gym_tpu_torch.envs import vector_env
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.rl import networks
from quadruped_gym_tpu_torch.runtime import mpc_runtime
from quadruped_gym_tpu_torch.solvers import mppi

SIZES = {"planning-mppi-65k": TINY, "fast-plant-mppi-65k": TINY,
         "planning-replan-4k": TINY, "fast-plant-env-2k": TINY_ENV}


@pytest.mark.parametrize("cell", ["planning-mppi-65k", "fast-plant-mppi-65k"])
def test_control_reads_far_above_the_program(cell):
    c = harness.load_cell(cell, SIZES[cell])
    (r,) = control.readings(c, [2147483901], 1, 0.5, "cpu").values()
    lim = c.workload["limits"]
    prog, ctl = r["program"], r["control"]
    assert all(prog[k] <= lim[k] for k in lim)
    assert any(ctl[k] > lim[k] for k in lim)
    assert prog["solves_off"] == 0
    assert ctl["solves_off_share"] > lim["solves_off_share"]
    assert ctl["cost_gap_median"] > 10 * prog["cost_gap_median"]


def test_env_control_reads_far_above_the_program():
    c = harness.load_cell("fast-plant-env-2k", TINY_ENV)
    (r,) = control.readings(c, [2147483911], 1, 0.5, "cpu").values()
    lim = c.workload["limits"]
    prog, ctl = r["program"], r["control"]
    assert all(prog[k] <= lim[k] for k in lim)
    assert any(ctl[k] > lim[k] for k in lim)
    assert prog["envs_off_share"] == 0
    assert ctl["envs_off_share"] > lim["envs_off_share"]
    assert ctl["state_gap_widest"] > 10 * prog["state_gap_widest"]


def _unchanged(orig):
    def plan_and_act(m, cfg, cost_fn, carry, phys, cmd):
        _, _, info = orig(m, cfg, cost_fn, carry, phys, cmd)
        return carry.mean[0], carry, info
    return plan_and_act


def _ctrl_altered(orig):
    def plan_and_act(*args):
        ctrl, new, info = orig(*args)
        return ctrl + torch.tensor([0.02] + [0.0] * 11, dtype=ctrl.dtype), new, info
    return plan_and_act


def _half_batch(orig):
    def weighted_update(seqs, costs, temperature):
        n = seqs.shape[0] // 2
        return orig(seqs[:n], costs[:n], temperature)
    return weighted_update


def _costs_altered(orig):
    def fused_rollout_cost(*args, **kw):
        return orig(*args, **kw) * 1.01
    return fused_rollout_cost


def _physics_unchanged(orig):
    def control_step(m, ls, ctrl, frame_skip, *args, **kw):
        out = orig(m, ls, ctrl, frame_skip, *args, **kw)
        return ls._replace(time=out.time, sensordata=out.sensordata)
    return control_step


def _physics_half(orig):
    def control_step(m, ls, ctrl, frame_skip, *args, **kw):
        out = orig(m, ls, ctrl, frame_skip, *args, **kw)
        n = ls.qpos.shape[-1] // 2
        keep = lambda new, old: torch.cat([new[..., :n], old[..., n:]], -1)  # noqa: E731
        return out._replace(qpos=keep(out.qpos, ls.qpos), qvel=keep(out.qvel, ls.qvel),
                            act=keep(out.act, ls.act))
    return control_step


def _action_altered(orig):
    def sample_action(net, obs, generator):
        action, logp = orig(net, obs, generator)
        return action + torch.tensor([0.02] + [0.0] * 11, dtype=action.dtype), logp
    return sample_action


def _reset_skipped(orig):
    def select(done, fresh, old):
        return old
    return select


def _reset_shifted(orig):
    def autoreset(m, cfg, out, num_envs, generator):
        res = orig(m, cfg, out, num_envs, generator)
        phys = res.state.phys
        qpos = phys.qpos + 0.01 * res.done[:, None].to(phys.qpos.dtype)
        return res._replace(state=res.state._replace(phys=phys._replace(qpos=qpos)))
    return autoreset


FAULTS = {
    "state_unchanged": (mpc_runtime, "plan_and_act", _unchanged),
    "half_batch": (mppi, "weighted_update", _half_batch),
    "answer_altered_ctrl": (mpc_runtime, "plan_and_act", _ctrl_altered),
    "answer_altered_costs": (cuda_engine, "fused_rollout_cost", _costs_altered),
}
ENV_FAULTS = {
    "state_unchanged": (cuda_engine, "control_step", _physics_unchanged),
    "half_batch": (cuda_engine, "control_step", _physics_half),
    "answer_altered_action": (networks, "sample_action", _action_altered),
    "reset_skipped": (vector_env, "_select", _reset_skipped),
    "reset_shifted": (vector_env, "_autoreset", _reset_shifted),
}
CASES = ([(c, f, FAULTS[f]) for c in ("planning-mppi-65k", "planning-replan-4k")
          for f in sorted(FAULTS)]
         + [("fast-plant-env-2k", f, ENV_FAULTS[f]) for f in sorted(ENV_FAULTS)])


@pytest.mark.parametrize("cell,fault,plant", CASES, ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_fault_is_not_correct(cell, fault, plant, monkeypatch, capsys):
    mod, attr, make = plant
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    c = harness.load_cell(cell, SIZES[cell])
    if fault.startswith("reset_"):  # episodes of 2 steps: the window resets
        c.traffic["env"] = {**c.traffic["env"], "max_time": 0.03}
    args = argparse.Namespace(seed=2147483999, seconds=0.5, trace=0)
    assert harness.report(c, args, "cpu", 0.0) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


def test_sound_run_checks_its_resets(capsys):
    """Episodes of 2 steps: the window resets environments, the check
    holds their fresh states, and the program comes out correct."""
    c = harness.load_cell("fast-plant-env-2k", TINY_ENV)
    c.traffic["env"] = {**c.traffic["env"], "max_time": 0.03}
    args = argparse.Namespace(seed=2147483919, seconds=0.5, trace=0)
    assert harness.report(c, args, "cpu", 0.0) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["look"]["resets_checked"] > TINY_ENV["num_envs"]
    assert line["checks"]["reset_gap"]["value"] < 1e-6
