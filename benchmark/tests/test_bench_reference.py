"""The frozen reference agrees with the port's plain paths, in float64 at
small sizes on the CPU: the rollout costs, the MPPI update and a whole
solve through ``plan_and_act``."""

import numpy as np
import pytest
import torch

from benchmark.tests._bench import ROOT  # noqa: F401

from benchmark.counts import derive
from benchmark.reference import commands as rcommands
from benchmark.reference import lane_engine as rlane
from benchmark.reference import mpc as rmpc
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.physics.engine import State
from quadruped_gym_tpu_torch.runtime import mpc_runtime
from quadruped_gym_tpu_torch.solvers import mppi, rollout
from quadruped_gym_tpu_torch.tasks import commands

F64 = torch.float64
CONFIGS = ("planning-2x4", "fast-plant-4x8")


def _stance(cfg, seed):
    """A perturbed stance as (port State, the same as a reference input)."""
    st = cfg["stance"]
    rng = np.random.default_rng(seed)
    qvel = np.array(st["qvel"]) + 0.1 * rng.standard_normal(len(st["qvel"]))
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    return State(qpos=t(st["qpos"]), qvel=t(qvel), act=t(st["act"]),
                 time=torch.tensor(0.0, dtype=F64),
                 sensordata=t(st["sensordata"]))


def _models(name):
    cfg = derive.load(name)
    port = getattr(spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
    return cfg, port, derive.model(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_rollout_costs_match_port(name):
    cfg, m, rm = _models(name)
    st = _stance(cfg, 0)
    S, H = 6, 2
    g = torch.Generator().manual_seed(1)
    seqs = torch.clamp(torch.tensor([0.0, 0.0, -0.5] * 4, dtype=F64)
                       + 0.3 * torch.randn((S, H, 12), generator=g, dtype=F64),
                       -1.0, 1.0)
    prev = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=F64)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=F64), torch.tensor(0.0, dtype=F64))
    port = rollout.lane_batched_rollout_cost(
        m, rollout.RolloutConfig(horizon=H, frame_skip=cfg["frame_skip"]),
        rollout.make_cost_fn(m), st, seqs, cmd, prev,
        newton_iterations=cfg["newton"], ls_iterations=cfg["line_search"],
        engine_impl="leg")
    lanes = lambda x: x[:, None].expand(-1, S).contiguous()  # noqa: E731
    ls = rlane.LaneState(qpos=lanes(st.qpos), qvel=lanes(st.qvel),
                         act=lanes(st.act), time=st.time.expand(S),
                         sensordata=lanes(st.sensordata))
    rcmd = rcommands.make(torch.tensor([0.2, 0.0], dtype=F64), torch.tensor(0.0, dtype=F64))
    ref = rmpc.rollout_costs(rm, ls, seqs.permute(1, 2, 0).contiguous(),
                             lanes(prev), rcmd, cfg["frame_skip"],
                             cfg["newton"], cfg["line_search"])
    torch.testing.assert_close(ref, port, rtol=1e-12, atol=1e-9)


def test_weighted_update_matches_port():
    g = torch.Generator().manual_seed(2)
    seqs = torch.randn((64, 5, 12), generator=g, dtype=F64)
    costs = 3.0 * torch.randn(64, generator=g, dtype=F64)
    costs[7] = torch.inf
    costs[9] = torch.nan
    mean, best, mean_cost, _ = mppi.weighted_update(seqs, costs, 1.0)
    rmean, rbest, rmean_cost = rmpc.weighted_update(seqs, costs, 1.0)
    torch.testing.assert_close(rmean, mean, rtol=1e-12, atol=1e-14)
    assert float(rbest) == float(best) and float(rmean_cost) == float(mean_cost)


@pytest.mark.parametrize("name", CONFIGS)
def test_solve_matches_plan_and_act(name):
    """One solve as the benchmark's traffic drives it: the port's
    ``plan_and_act`` (MPPI over ``lane_engine_impl="fused"``, whose CPU
    path is the plain version) against the reference's solve."""
    cfg, m, rm = _models(name)
    S, H = 8, 2
    st = _stance(cfg, 3)
    mpc = mpc_runtime.MPCConfig(mppi=mppi.MPPIConfig(
        num_samples=S, sigma=0.3, temperature=1.0,
        rollout=rollout.RolloutConfig(horizon=H, frame_skip=cfg["frame_skip"]),
        lane=True, lane_newton_iterations=cfg["newton"],
        lane_ls_iterations=cfg["line_search"], lane_engine_impl="fused"))
    g = torch.Generator().manual_seed(4)
    mean = torch.clamp(torch.tensor([0.0, 0.0, -0.5] * 4, dtype=F64)
                       + 0.1 * torch.randn((H, 12), generator=g, dtype=F64), -1, 1)
    prev = mean[0] + 0.01
    gen = torch.Generator()
    gen.manual_seed(12345)
    carry = mpc_runtime.MPCCarry(mean=mean, sigma=torch.zeros_like(mean),
                                 prev_ctrl=prev, generator=gen)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=F64), torch.tensor(0.0, dtype=F64))
    ctrl, new, info = mpc_runtime.plan_and_act(m, mpc, rollout.make_cost_fn(m),
                                               carry, st, cmd)
    rcmd = rcommands.make(torch.tensor([0.2, 0.0], dtype=F64), torch.tensor(0.0, dtype=F64))
    (ref,) = rmpc.solve(rm, [rmpc.SolveInput(*st, mean=mean, prev_ctrl=prev,
                                             noise_seed=12345)],
                        rcmd, S, 0.3, 1.0, cfg["frame_skip"], cfg["newton"],
                        cfg["line_search"], noise_dtype=F64, dtype=F64)
    torch.testing.assert_close(ref.ctrl, ctrl, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(ref.carry_mean, new.mean, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(ref.best_cost, info["best_cost"], rtol=1e-12, atol=0)
    torch.testing.assert_close(ref.mean_cost, info["mean_cost"], rtol=1e-12, atol=0)


def test_env_step_matches_port():
    """One step of the batched walking env as the env traffic drives it
    (the actor's action, ``batched_autoreset_step`` through the substep
    kernel's path, the auto-reset), held in float64 against the reference,
    from a moving state with some environments at the time limit so that
    the auto-reset runs."""
    from benchmark.reference import env as renv
    from benchmark.reference import walking as rwalking
    from benchmark.traffic import env_steps
    from quadruped_gym_tpu_torch.envs import vector_env
    from quadruped_gym_tpu_torch.rl import networks
    from quadruped_gym_tpu_torch.tasks import walking

    cfg, m, rm = _models("fast-plant-4x8")
    tr = derive.load_traffic("env-2k")
    N = 6
    wcfg = env_steps.walking_config(walking, cfg, tr["env"], F64)
    rcfg = env_steps.walking_config(rwalking, cfg, tr["env"], F64)
    sizes = [walking.obs_size(wcfg, m), *tr["actor"]["hidden"], m.nu]
    ws, bs, log_std = env_steps.actor_weights(sizes, tr["actor"], 5, F64, "cpu")
    net = networks.ActorCritic(networks.NetConfig(sizes[0], m.nu, tuple(tr["actor"]["hidden"])), F64, "cpu")
    with torch.no_grad():
        for lin, w, b in zip(net.linears("actor"), ws, bs):
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        gen = torch.Generator().manual_seed(6)
        st, obs = walking.reset(m, wcfg, N, gen)
        for _ in range(2):  # moving, in contact
            action, _ = networks.sample_action(net, obs, gen)
            out = vector_env.batched_autoreset_step(m, wcfg, st, action.clamp(-1, 1), gen, "pallas")
            st, obs = out.state, out.obs
        phys = st.phys._replace(time=torch.where(torch.arange(N) % 2 == 0, 19.99, st.phys.time))
        st = st._replace(phys=phys)
        agen, egen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(8)
        action, _ = networks.sample_action(net, obs, agen)
        out = vector_env.batched_autoreset_step(m, wcfg, st, action.clamp(-1, 1), egen, "pallas")
    (ref,) = renv.step(rm, rcfg, rcfg, renv.ActorWeights(ws, bs, log_std),
                       [renv.StepInput(st, obs, 7, 8)], cfg["newton"],
                       cfg["line_search"], F64)
    assert out.done.tolist() == ref.done.tolist() and 0 < int(out.done.sum()) < N
    torch.testing.assert_close(ref.action, action, rtol=1e-10, atol=1e-12)
    for a, b in zip(ref.state.phys, out.state.phys):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    for a, b in ((ref.obs, out.obs), (ref.reward, out.reward),
                 (ref.reward_components, out.reward_components)):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
