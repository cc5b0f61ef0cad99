"""The plain reference of one step of the batched walking environment, as
the benchmark's env traffic drives it.

The actor's action (a tanh MLP, the mean plus ``exp(log_std)`` times the
step's noise), the physics through the leg engine (``frame_skip``
substeps at a fixed Newton / line-search budget, sensors on the last),
the walking task layer (``walking._task_step``: the estimator, rewards,
termination and the partial observation) and the auto-reset (fresh
states drawn from the step's reset seed, chosen where the step ended an
episode; the estimator and the control-cost reference survive it), all
over the frozen copies in this folder.

The draws are the configuration's: the noise and the reset are drawn in
its type (float32) on the inputs' device from the seeds the benchmark
handed the program, and the episode clock is a float32 counter, advanced
a timestep a substep as the configuration keeps it. Everything else is
computed in the type asked for.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from . import lane_engine, leg_engine, walking
from .spec import PhysicsModel
from .state import State


class ActorWeights(NamedTuple):
    """The actor's layers, (out, in) weights and (out,) biases, and the
    (act_dim,) log standard deviation."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    log_std: torch.Tensor

    def to(self, dtype) -> "ActorWeights":
        return ActorWeights([w.to(dtype) for w in self.weights],
                            [b.to(dtype) for b in self.biases],
                            self.log_std.to(dtype))


class StepInput(NamedTuple):
    state: walking.WalkingState  # before the step, leading axis N
    obs: torch.Tensor  # (N, obs_dim) what the actor saw
    action_seed: int  # the seed of the action noise's generator
    reset_seed: int  # the seed of the auto-reset's generator


class StepOutput(NamedTuple):
    action: torch.Tensor  # (N, nu) before the clamp
    state: walking.WalkingState  # after the step and the auto-reset
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    reward_components: torch.Tensor


def actor_mean(w: ActorWeights, obs: torch.Tensor) -> torch.Tensor:
    x = obs
    for i, (W, b) in enumerate(zip(w.weights, w.biases)):
        x = x @ W.T + b
        if i < len(w.weights) - 1:
            x = torch.tanh(x)
    return x


def draw(seed: int, shape, dtype, device, kind="randn") -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fn = torch.randn if kind == "randn" else torch.rand
    return fn(shape, generator=gen, dtype=dtype, device=device)


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    return type(x)(*(_cast(y, dtype) for y in x))


def _select(done: torch.Tensor, fresh, old):
    if isinstance(fresh, torch.Tensor):
        mask = done.reshape(done.shape + (1,) * (fresh.dim() - 1))
        return torch.where(mask, fresh.to(old.dtype), old)
    return type(fresh)(*(_select(done, a, b) for a, b in zip(fresh, old)))


def physics(m: PhysicsModel, frame_skip: int, newton: int, line_search: int,
            clock_dtype):
    """``physics(phys, ctrl)`` for ``walking._task_step``: the leg engine,
    with the clock advanced in ``clock_dtype``."""

    def fn(phys: State, ctrl: torch.Tensor) -> State:
        ls = lane_engine.from_batched(*phys)
        ls = leg_engine.control_step(m, ls, ctrl.T, frame_skip,
                                     solver_iterations=newton,
                                     ls_iterations=line_search)
        t = phys.time.to(clock_dtype)
        for _ in range(frame_skip):
            t = t + m.timestep
        return State(*lane_engine.to_batched(ls._replace(time=t.to(ls.qpos.dtype))))

    return fn


def step(m: PhysicsModel, cfg: walking.WalkingConfig, draw_cfg, weights: ActorWeights,
         inputs: Sequence[StepInput], newton: int, line_search: int,
         dtype) -> List[StepOutput]:
    """The steps' outputs, computed in ``dtype``, every step's envs in one
    batch. ``cfg`` is the task's configuration in ``dtype``; ``draw_cfg``
    the same in the configuration's own type, in which the resets are
    drawn."""
    import dataclasses

    cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = inputs[0].obs.device
    w = weights.to(dtype)
    nu = w.log_std.shape[0]
    actions, states, obs = [], [], []
    for x in inputs:
        N = x.obs.shape[0]
        eps = draw(x.action_seed, (N, nu), draw_cfg.dtype, dev).to(dtype)
        actions.append(actor_mean(w, x.obs.to(dtype)) + torch.exp(w.log_std) * eps)
        states.append(_cast(x.state, dtype))
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
        res.append(StepOutput(
            action=action[sl], state=_select(done, fresh, st),
            obs=_select(done, fresh_obs, out.obs[sl]), reward=out.reward[sl],
            done=done, reward_components=out.reward_components[sl]))
    return res
