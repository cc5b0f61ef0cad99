"""Rank bodies for the port's multi-process tests, and the helper that
runs them.

``run(body, world, tmp, *args)`` starts ``world`` processes with
``torch.multiprocessing.spawn``; each joins a gloo group on a ``file://``
store under ``tmp`` (no port to race for between test workers), runs one
thread, calls ``body(rank, world, *args)`` and saves what it returns.
``run`` returns the ranks' results in rank order. The bodies live here,
importable by the spawned processes, and import neither JAX nor the JAX
package: the parent test holds their results to it.

Inputs are made by the same functions in the parent and in the ranks,
float64 on the CPU: a robot lifted clear of the floor and moving (so the
stage cost's v/|v| is well conditioned), ``mpc_plant`` at 8 contacts and
2 Newton passes for the oracle engine, the planning model for the fused
route (its plain version on the CPU).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64
SEED = 7


def run(body, world: int, tmp, *args):
    os.makedirs(tmp, exist_ok=True)
    torch.multiprocessing.spawn(_main, args=(world, str(tmp), body, args),
                                nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _main(rank, world, tmp, body, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=240))
    try:
        out = body(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def clone(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def generator(seed: int = SEED) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


# --------------------------------------------------------------------------
# inputs


def problem(model: str = "mpc_plant", H: int = 2, frame_skip: int = 1):
    """(m, rollout config, cost_fn, state, cmd, prev_ctrl) in float64."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.solvers import rollout
    from quadruped_gym_tpu_torch.tasks.commands import make

    m = getattr(spec, f"get_{model}_model")()
    cfg = rollout.RolloutConfig(horizon=H, frame_skip=frame_skip,
                                max_contacts=8, solver_iterations=2)
    st = make_state(m, dtype=F64, device="cpu")
    qpos, qvel = st.qpos.clone(), st.qvel.clone()
    qpos[2] = 0.6
    qvel[0], qvel[1] = 0.2, 0.03
    st = st._replace(qpos=qpos, qvel=qvel)
    cmd = make(torch.tensor([0.2, 0.0], dtype=F64),
               torch.tensor(0.0, dtype=F64))
    prev = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=F64)
    return m, cfg, rollout.make_cost_fn(m), st, cmd, prev


def seqs(S: int, H: int, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    prev = np.array([0.0, 0.0, -0.5] * 4)
    return torch.as_tensor(np.clip(prev + 0.2 * rng.standard_normal(
        (S, H, 12)), -1.0, 1.0))


def mppi_config(S: int, model: str, iterations: int = 2, H: int = 2):
    from quadruped_gym_tpu_torch.solvers.mppi import MPPIConfig
    from quadruped_gym_tpu_torch.solvers.rollout import RolloutConfig

    rcfg = RolloutConfig(horizon=H, frame_skip=1, max_contacts=8,
                         solver_iterations=2)
    if model == "planning":  # the fused route: B1's plain version here
        return MPPIConfig(num_samples=S, sigma=0.2, iterations=iterations,
                          rollout=rcfg, lane=True, lane_engine_impl="fused",
                          lane_newton_iterations=2, lane_ls_iterations=4)
    return MPPIConfig(num_samples=S, sigma=0.2, iterations=iterations,
                      rollout=rcfg)


def scenarios(B: int):
    """B scenarios: the problem's state with each its own forward speed,
    commands 0.1-0.3 m/s, and a mean of the held posture."""
    from quadruped_gym_tpu_torch.physics.engine import State
    from quadruped_gym_tpu_torch.tasks.commands import Command, make

    m, cfg, cost_fn, st, _, prev = problem()
    states = State(*(x.expand((B,) + x.shape).clone() for x in st))
    states.qvel[:, 0] = torch.linspace(0.1, 0.3, B, dtype=F64)
    cmds = [make(torch.tensor([v, 0.0], dtype=F64),
                 torch.tensor(0.0, dtype=F64))
            for v in np.linspace(0.1, 0.3, B)]
    cmds = Command(*(torch.stack(x) for x in zip(*cmds)))
    means = prev.expand(B, cfg.horizon, 12).clone()
    return states, cmds, means, prev.expand(B, 12).clone()


# --------------------------------------------------------------------------
# rank bodies


def mpc_body(rank, world, S, batch_mesh):
    """Sharded rollout costs, sharded MPPI (oracle and fused routes) and
    sharded batch MPPI on a (data, sample) mesh of shape ``batch_mesh``."""
    from quadruped_gym_tpu_torch import parallel

    out = {}
    mesh = parallel.make_mesh(device="cpu")
    m, cfg, cost_fn, st, cmd, prev = problem()
    n = S // world
    out["costs"] = parallel.sharded_rollout_costs(
        m, cfg, cost_fn, st, seqs(S, cfg.horizon)[rank * n:(rank + 1) * n],
        cmd, prev, mesh)
    for model in ("mpc_plant", "planning"):
        m, cfg, cost_fn, st, cmd, prev = problem(model)
        gen = generator()
        res = parallel.sharded_mppi_plan(
            m, mppi_config(S, model), cost_fn, st,
            prev.expand(cfg.horizon, 12), cmd, prev, gen, mesh)
        out[model] = tuple(res)
        out[model + " generator"] = gen.get_state()
    m, cfg, cost_fn, *_ = problem()
    mesh2 = parallel.make_mesh((parallel.DATA_AXIS, parallel.SAMPLE_AXIS),
                               batch_mesh, device="cpu")
    states, cmds, means, prevs = scenarios(2 * batch_mesh[0])
    d = mesh2.get_local_rank(parallel.DATA_AXIS)
    b = states.qpos.shape[0] // batch_mesh[0]

    def mine(x):
        return x[d * b:(d + 1) * b]

    out["batch"] = parallel.sharded_batch_mppi_plan(
        m, mppi_config(S, "mpc_plant"), cost_fn,
        type(states)(*map(mine, states)), mine(means),
        type(cmds)(*map(mine, cmds)), mine(prevs), generator(), mesh2)
    return out


def pipeline_body(rank, world, S, H, microbatches):
    from quadruped_gym_tpu_torch import parallel

    mesh = parallel.make_mesh((parallel.STAGE_AXIS,), device="cpu")
    m, cfg, cost_fn, st, cmd, prev = problem(H=H)
    out = {M: parallel.pipelined_rollout_cost(
        m, cfg, cost_fn, st, seqs(S, H), cmd, prev, mesh,
        num_microbatches=M) for M in microbatches}
    mcfg = mppi_config(S, "mpc_plant", iterations=1, H=H)
    out["plan"] = parallel.pipelined_mppi_plan(
        m, mcfg, cost_fn, st, prev.expand(H, 12), cmd, prev, generator(),
        mesh)
    errors = []
    for bad_h, bad_m in ((world + 1, None), (H, 3)):
        try:
            parallel.pipelined_rollout_cost(
                m, cfg, cost_fn, st, seqs(S, bad_h), cmd, prev, mesh,
                num_microbatches=bad_m)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def condense_case(H, nx=6, nu=3, seed=0):
    """F, lx, lxx of a condensation of H blocks (lxx PSD), float64."""
    rng = np.random.default_rng(seed + H)
    F = rng.standard_normal((H, nx, H * nu))
    lx = rng.standard_normal((H, nx))
    R = rng.standard_normal((H, nx, nx))
    return F, lx, np.einsum("hij,hkj->hik", R, R)


def sqp_problem():
    """(m, SQPConfig, cost_fn, state, ctrl_seq, cmd, prev) of a small
    SQP solve on the planning model, float64."""
    from quadruped_gym_tpu_torch.solvers import sqp

    m, cfg, cost_fn, st, cmd, prev = problem("planning", H=3)
    us0 = torch.clamp(prev + 0.1 * seqs(1, 3, seed=4)[0] - 0.1 * prev,
                      -1.0, 1.0)
    return (m, sqp.SQPConfig(iterations=1, rollout=cfg), cost_fn, st, us0,
            cmd, prev)


def sqp_body(rank, world, horizons, solve):
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.solvers import sqp

    mesh = parallel.make_mesh(("horizon",), device="cpu")
    out = {H: sqp._condense_sharded(
        *(torch.as_tensor(x) for x in condense_case(H)), mesh, "horizon")
        for H in horizons}
    if solve:
        out["solve"] = tuple(sqp.solve(*sqp_problem(), mesh=mesh))
    return out


# --------------------------------------------------------------------------
# data-parallel PPO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARGS = ["--num-envs", "4", "--num-steps", "4",
              "--timesteps-per-iteration", "16", "--frame-skip", "2",
              "--max-contacts", "8", "--solver-iterations", "2",
              "--obs-window", "2", "--no-eval"]


def snapshot_script():
    """``scripts/snapshot_torch_parallel_refs.py`` as a module."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "snapshot_torch_parallel_refs.py")
    spec = importlib.util.spec_from_file_location("parallel_refs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inject(normals, perms):
    """``torch.randn`` / ``torch.randperm`` hand out what JAX drew, in
    order, in this process."""
    normals, perms = iter(normals), iter(perms)

    def randn(shape, generator=None, dtype=None, device=None):
        z = torch.as_tensor(next(normals), dtype=dtype, device=device)
        assert tuple(z.shape) == tuple(shape)
        return z

    def randperm(n, generator=None, device=None):
        p = torch.as_tensor(next(perms), dtype=torch.int64, device=device)
        assert p.shape == (n,)
        return p

    torch.randn, torch.randperm = randn, randperm


def _net(ts):
    return [x.detach().clone() for x in ts.net.state_dict().values()]


def ppo_body(rank, world):
    """Two data-parallel updates from one seed, small and float64."""
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.rl import distributed

    env_cfg, cfg = snapshot_script().port_configs()
    m = spec.get_mpc_plant_model()
    mesh = parallel.make_mesh((parallel.DATA_AXIS,), device="cpu")
    ts = distributed.init_distributed_train_state(m, env_cfg, cfg, 0, mesh,
                                                  device="cpu")
    update = distributed.make_distributed_update(m, env_cfg, cfg, mesh)
    out = {"params": [_net(ts)], "metrics": []}
    for _ in range(2):
        ts, metrics = update(ts)
        out["params"].append(_net(ts))
        out["metrics"].append(tuple(metrics))
    out["generator"] = ts.generator.get_state()
    out["update_idx"] = int(ts.update_idx)
    out["obs"] = ts.obs
    return out


def jax_snapshot_body(rank, world):
    """The snapshot's start, this rank's slice of it and its shard's
    draws, through one ``make_distributed_update``."""
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.rl import distributed, ppo
    from quadruped_gym_tpu_torch.runtime import checkpoint

    script = snapshot_script()
    env_cfg, cfg = script.port_configs()
    m = spec.get_mpc_plant_model()
    with np.load(script.OUT) as data:
        ref = {k: data[k] for k in data.files}
    example = ppo.init_train_state(m, env_cfg, cfg, script.SEED,
                                   device="cpu")
    n = sum(k.startswith("init/") for k in ref)
    ts = checkpoint._rebuild(example,
                             iter(ref[f"init/leaf_{i}"] for i in range(n)))
    mesh = parallel.make_mesh((parallel.DATA_AXIS,), device="cpu")
    ts = distributed.local_slice(ts, mesh)
    _inject([ref[f"normals/{rank}/{t}"] for t in range(cfg.num_steps)],
            [ref[f"perms/{rank}/{e}"] for e in range(cfg.epochs)])
    ts, metrics = distributed.make_distributed_update(m, env_cfg, cfg,
                                                      mesh)(ts)
    return {"params": _net(ts), "metrics": metrics._asdict()}


def train_body(rank, world, tmp):
    """``rl.train.main --distributed`` for 1 iteration then resumed for 1
    more, and for 2 uninterrupted, on this group."""
    from quadruped_gym_tpu_torch.rl import train

    def main(out, iterations):
        return train.main(["--distributed", "--output", os.path.join(tmp, out),
                           "--iterations", str(iterations)] + TRAIN_ARGS,
                          device="cpu")

    def kept(ts):
        return {"net": _net(ts), "obs": ts.obs,
                "phys": list(ts.env_state.phys),
                "generator": ts.generator.get_state()}

    main("resumed", 1)
    resumed, its = main("resumed", 1)
    whole, _ = main("whole", 2)
    return {"index": [it.index for it in its], "resumed": kept(resumed),
            "whole": kept(whole), "group_kept": dist.is_initialized()}
