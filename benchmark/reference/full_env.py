"""The plain reference of one step of the batched walking environment on
the ``full`` collision model: ``env.py``'s step with the physics through
the lane engine (``lane_physics.py``: every body, dof and contact slot
stacked, each slot a masked row), whose structure differs from the
leg-batched formulation the substep kernel runs. The actor, the task
layer, the auto-reset and the draws are ``env.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from . import env, lane_physics, walking
from .spec import PhysicsModel
from .state import State


def physics(m: PhysicsModel, frame_skip: int, newton: int, line_search: int,
            clock_dtype):
    """``physics(phys, ctrl)`` for ``walking._task_step``: the lane engine,
    with the clock advanced in ``clock_dtype``."""

    def fn(phys: State, ctrl: torch.Tensor) -> State:
        ls = lane_physics.from_batched(*phys)
        ls = lane_physics.control_step(m, ls, ctrl.T, frame_skip,
                                       solver_iterations=newton,
                                       ls_iterations=line_search)
        t = phys.time.to(clock_dtype)
        for _ in range(frame_skip):
            t = t + m.timestep
        return State(*lane_physics.to_batched(
            ls._replace(time=t.to(ls.qpos.dtype))))

    return fn


def step(m: PhysicsModel, cfg: walking.WalkingConfig, draw_cfg,
         weights: env.ActorWeights, inputs: Sequence[env.StepInput],
         newton: int, line_search: int, dtype) -> List[env.StepOutput]:
    """``env.step`` with the lane engine's physics: the steps' outputs,
    computed in ``dtype``, every step's envs in one batch."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = inputs[0].obs.device
    w = weights.to(dtype)
    nu = w.log_std.shape[0]
    actions, states = [], []
    for x in inputs:
        N = x.obs.shape[0]
        eps = env.draw(x.action_seed, (N, nu), draw_cfg.dtype, dev).to(dtype)
        actions.append(env.actor_mean(w, x.obs.to(dtype))
                       + torch.exp(w.log_std) * eps)
        states.append(env._cast(x.state, dtype))
    cat = lambda *xs: (torch.cat(xs) if isinstance(xs[0], torch.Tensor)  # noqa: E731
                       else type(xs[0])(*(cat(*ys) for ys in zip(*xs))))
    action = torch.cat(actions)
    out = walking._task_step(
        m, cfg, cat(*states), torch.clamp(action, -1.0, 1.0),
        physics(m, cfg.frame_skip, newton, line_search, draw_cfg.dtype))
    res, i0 = [], 0
    for x in inputs:
        N = x.obs.shape[0]
        sl = slice(i0, i0 + N)
        i0 += N
        part = lambda t: (t[sl] if isinstance(t, torch.Tensor)  # noqa: E731
                          else type(t)(*(part(y) for y in t)))
        st = part(out.state)
        gen = torch.Generator(device=dev)
        gen.manual_seed(x.reset_seed)
        fresh, fresh_obs = walking.reset(m, draw_cfg, N, gen,
                                         persistent=(st.est, st.rew))
        done = out.terminated[sl]
        res.append(env.StepOutput(
            action=action[sl], state=env._select(done, fresh, st),
            obs=env._select(done, fresh_obs, out.obs[sl]),
            reward=out.reward[sl], done=done,
            reward_components=out.reward_components[sl]))
    return res
