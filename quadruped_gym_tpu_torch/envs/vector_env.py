"""Vectorized walking environment with auto-reset.

Counterpart of ``quadruped_gym_tpu/envs/vector_env.py``: thousands of
environments on one card; auto-reset keeps the batch dense. Persistent
carries behave as in the reference: the frequency estimator and the
frozen control-cost reference survive episode boundaries.
``autoreset_step`` (``lane_physics=False``) steps the physics on the
oracle engine, ``batched_autoreset_step`` (``lane_physics=True``) through
the batch-minor engines.

On the substep kernel's route (CUDA tensors, ``engine_impl="pallas"`` on
a leg-compatible model, nothing that requires grad, no capture under
way) ``batched_autoreset_step`` is one CUDA graph replay: the first call
of a step shape runs eagerly, the second captures the whole step (task
layer, layout conversions, B2's launch, the auto-reset with its draws)
and replays it, every later one replays it. ``graph_counts`` counts the
three kinds of call. During a replay no Python of the step runs, so its
inner spans (``walking.task_step``, ``vector_env.autoreset``, ...) are
recorded on eager and capturing calls only; a replay records
``vector_env.graph_replay``.
"""

from __future__ import annotations

import collections
from typing import List, NamedTuple

import torch
from torch.utils import _pytree as pytree

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..tasks import walking
from ..utils import profiling


class VectorStepOutput(NamedTuple):
    state: walking.WalkingState  # leading axis N
    obs: torch.Tensor  # (N, obs_dim)
    reward: torch.Tensor  # (N,)
    done: torch.Tensor  # (N,) bool
    reward_components: torch.Tensor  # (N, 11)


def _select(done: torch.Tensor, fresh, old):
    """Per leaf: ``fresh`` where the env is done, else ``old``; the (N,)
    mask is reshaped to each leaf's rank."""
    if isinstance(fresh, torch.Tensor):
        mask = done.reshape(done.shape + (1,) * (fresh.dim() - 1))
        return torch.where(mask, fresh, old)
    return type(fresh)(*(_select(done, a, b) for a, b in zip(fresh, old)))


def _autoreset(m, cfg, out: walking.StepOutput, num_envs: int,
               generator: torch.Generator) -> VectorStepOutput:
    """Reset the environments whose step ``out`` ended their episode. As in
    the JAX package, fresh states are drawn for every environment each
    step (from ``generator``) and selected by ``done``; the estimator and
    the frozen control-cost reference survive the reset."""
    with profiling.span("vector_env.autoreset"):
        fresh, fresh_obs = walking.reset(
            m, cfg, num_envs, generator,
            persistent=(out.state.est, out.state.rew))
        done = out.terminated
        return VectorStepOutput(
            state=_select(done, fresh, out.state),
            obs=_select(done, fresh_obs, out.obs),
            reward=out.reward,
            done=done,
            reward_components=out.reward_components,
        )


def autoreset_step(
    m: PhysicsModel, cfg: walking.WalkingConfig, st: walking.WalkingState,
    action: torch.Tensor, generator: torch.Generator,
) -> VectorStepOutput:
    """One step of every environment on the oracle engine
    (``walking.step``) with auto-reset on termination. The returned
    reward/done describe the step that just happened; the state and obs
    are post-reset where the episode ended."""
    out = walking.step(m, cfg, st, action)
    return _autoreset(m, cfg, out, action.shape[0], generator)


def _batched_autoreset_step(m, cfg, st, action, generator, engine_impl):
    out = walking.batched_step(m, cfg, st, action, engine_impl=engine_impl)
    return _autoreset(m, cfg, out, action.shape[0], generator)


def batched_autoreset_step(
    m: PhysicsModel, cfg: walking.WalkingConfig, st: walking.WalkingState,
    action: torch.Tensor, generator: torch.Generator,
    engine_impl: str = "auto",
) -> VectorStepOutput:
    """``autoreset_step`` with the physics through a batch-minor engine
    (see ``walking.batched_step`` for ``engine_impl``): the
    training-throughput path. On the substep kernel's route it replays a
    CUDA graph of the step (module docstring); the returned tensors are
    the caller's own either way."""
    from ..ops import cuda_engine

    with profiling.span("vector_env.batched_autoreset_step"):
        if walking.batched_engine(m, engine_impl) is cuda_engine:
            leaves, spec = pytree.tree_flatten((st, action))
            if _capturable(leaves, generator):
                return _graph_step(m, cfg, leaves, spec, generator)
        graph_counts["eager"] += 1
        return _batched_autoreset_step(m, cfg, st, action, generator,
                                       engine_impl)


# --------------------------------------------------------------------------
# the step as a CUDA graph

# calls of batched_autoreset_step by kind: "captures" (captured, then
# replayed once), "replays", "eager" (every other call, a step shape's
# first on the graph route included); a run sets them to 0 and reads them
graph_counts = {"captures": 0, "replays": 0, "eager": 0}

# the captured steps by ``graph_key``, the most recently used last; a key
# seen once holds None (its first call ran eagerly, the warm-up)
_MAX_GRAPHS = 4
_graphs: "collections.OrderedDict[tuple, list]" = collections.OrderedDict()


def reset_graph_counts() -> None:
    for k in graph_counts:
        graph_counts[k] = 0


def _capturable(leaves, generator) -> bool:
    """Whether a step on the substep kernel can be captured as it is
    called: CUDA tensors on one device with the generator, nothing that
    requires grad, no capture under way."""
    dev, gdev = leaves[-1].device, generator.device
    return (dev.type == "cuda" and gdev.type == "cuda"
            and gdev.index in (None, dev.index)
            and all(x.device == dev and not x.requires_grad for x in leaves)
            and not torch.cuda.is_current_stream_capturing())


def graph_key(m, cfg, leaves, generator) -> tuple:
    """What fixes the captured work: the model (by identity; the cache
    entry holds it, so the id is not reused), the task configuration, the
    number of envs, the device, every input's shape and dtype (the action
    last) and the generator."""
    action = leaves[-1]
    return (id(m), cfg, action.shape[0], action.device,
            tuple((tuple(x.shape), x.dtype) for x in leaves), generator)


def _by_dtype(tensors) -> List[List[torch.Tensor]]:
    """``tensors`` in one list per dtype, the dtypes in order of first
    appearance."""
    groups = {}
    for x in tensors:
        groups.setdefault(x.dtype, []).append(x)
    return list(groups.values())


class _Packed:
    """A list of tensors as views of one flat buffer per dtype."""

    def __init__(self, tensors):
        self.shapes = [x.shape for x in tensors]
        self.dtypes = list(dict.fromkeys(x.dtype for x in tensors))
        self.index = [[i for i, x in enumerate(tensors) if x.dtype == d]
                      for d in self.dtypes]
        self.sizes = [[self.shapes[i].numel() for i in idx]
                      for idx in self.index]

    def views(self, flats) -> List[torch.Tensor]:
        out = [None] * len(self.shapes)
        for flat, idx, sizes in zip(flats, self.index, self.sizes):
            for i, part in zip(idx, torch.split_with_sizes(flat, sizes)):
                out[i] = part.view(self.shapes[i])
        return out


class _StepGraph:
    """One captured step: static inputs (the state's leaves and the
    action), the graph, and its outputs packed inside the graph into one
    flat buffer per dtype."""

    def __init__(self, m, cfg, leaves, spec, generator):
        static = [torch.empty_like(x) for x in leaves]
        self.static = _by_dtype(static)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            st, action = pytree.tree_unflatten(static, spec)
            outs, self.out_spec = pytree.tree_flatten(
                _batched_autoreset_step(m, cfg, st, action, generator,
                                        "pallas"))
            self.outputs = _Packed(outs)
            self.out_flats = [torch.cat([x.reshape(-1) for x in group])
                              for group in _by_dtype(outs)]

    def __call__(self, leaves) -> VectorStepOutput:
        """Copy the inputs in, replay, copy the outputs out: a multi-tensor
        copy and a clone per dtype around the replay."""
        for dst, src in zip(self.static, _by_dtype(leaves)):
            torch._foreach_copy_(dst, src)
        self.graph.replay()
        fresh = [flat.clone() for flat in self.out_flats]
        return pytree.tree_unflatten(self.outputs.views(fresh), self.out_spec)


def _graph_step(m, cfg, leaves, spec, generator) -> VectorStepOutput:
    key = graph_key(m, cfg, leaves, generator)
    with torch.cuda.device(leaves[-1].device):
        if key not in _graphs:  # the warm-up: lazy set-up happens here
            _graphs[key] = [m, None]  # m held: its id is in the key
            while len(_graphs) > _MAX_GRAPHS:
                _graphs.popitem(last=False)
            graph_counts["eager"] += 1
            st, action = pytree.tree_unflatten(leaves, spec)
            return _batched_autoreset_step(m, cfg, st, action, generator,
                                           "pallas")
        _graphs.move_to_end(key)
        entry = _graphs[key]
        if entry[1] is None:
            entry[1] = _StepGraph(m, cfg, leaves, spec, generator)
            graph_counts["captures"] += 1
        else:
            graph_counts["replays"] += 1
        with profiling.span("vector_env.graph_replay"):
            return entry[1](leaves)


class VectorWalkingEnv:
    """Batched auto-resetting environment. It holds the generator that
    draws reset states and commands, on ``device`` (the card unless
    ``device="cpu"``), seeded with ``seed``. ``lane_physics=False`` (the
    default, as in the JAX package) steps on the oracle engine,
    ``lane_physics=True`` through the batch-minor engines."""

    def __init__(self, m: PhysicsModel, cfg: walking.WalkingConfig,
                 num_envs: int, lane_physics: bool = False, seed: int = 0,
                 device=None):
        self.m = m
        self.cfg = cfg
        self.num_envs = num_envs
        self.lane_physics = lane_physics
        self.obs_size = walking.obs_size(cfg, m)
        self.generator = torch.Generator(device=resolve_device(device))
        self.generator.manual_seed(seed)

    def reset(self):
        return walking.reset(self.m, self.cfg, self.num_envs, self.generator)

    def step(self, state, actions: torch.Tensor) -> VectorStepOutput:
        step = batched_autoreset_step if self.lane_physics else autoreset_step
        return step(self.m, self.cfg, state, actions, self.generator)
