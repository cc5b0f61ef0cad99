"""Device meshes over the ranks of a ``torch.distributed`` group.

Counterpart of ``quadruped_gym_tpu/parallel/mesh.py``. JAX's ``shard_map``
is one SPMD program over many devices in one process; here each device is
a process, a rank of a ``torch.distributed`` group, and a mesh axis is a
dimension of a ``DeviceMesh`` whose collectives run on
``mesh.get_group(axis)``. The axes:

- ``sample``: MPC rollout samples (one MIN and a few SUM all-reduces at
  the weighting, ``sharded_mpc.py``);
- ``data``: scenario batches of MPC and the env batch of RL training
  (gradients averaged over it, ``rl/distributed.py``);
- ``horizon``: SQP's condensation (``solvers/sqp.py``, one SUM);
- ``stage``: the GPipe horizon pipeline (``pipeline.py``, boundary
  states handed to the next rank).

Every sharded function runs on each rank and takes and returns that
rank's local tensors: replicated inputs in full, sharded inputs as the
rank's slice. The backend follows the device: NCCL for the card, gloo for
``device="cpu"``. With no group running, ``make_mesh`` starts a world-1
group on an in-process ``HashStore`` (no network); with one running it
reuses it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from .._device import resolve_device

SAMPLE_AXIS = "sample"
DATA_AXIS = "data"


def backend_for(device: torch.device) -> str:
    """"nccl" for the card, "gloo" for the CPU. A CUDA build without NCCL
    raises: a card never runs its collectives through gloo."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: the card's "
                               "collectives cannot run")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def check_backend(device: torch.device) -> None:
    """Raise unless the running group's backend is the one ``device``
    needs."""
    want = backend_for(device)
    have = str(dist.get_backend())
    if want not in have:
        raise RuntimeError(f"the running process group is {have!r}; tensors "
                           f"on {device} need {want!r}")


def start_world_one(device: torch.device) -> None:
    """A group of this process alone, on an in-process store."""
    kw = {}
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1, **kw)


@contextlib.contextmanager
def group_scope():
    """Leave the process's group as it was: a group started inside the
    block (by ``make_mesh`` or ``multihost.initialize``) is destroyed when
    the block ends, one that ran before is kept."""
    had = dist.is_initialized()
    try:
        yield
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(axis_names: Sequence[str] = (SAMPLE_AXIS,),
              shape: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """A mesh over every rank of the running group (a world-1 group is
    started if none runs), on the card unless ``device="cpu"``.

    With no ``shape`` all ranks go on the first axis and the other axes
    get size 1, as in the JAX package."""
    device = resolve_device(device)
    if not dist.is_initialized():
        start_world_one(device)
    check_backend(device)
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not hold the {world} rank(s) of the group")
    return init_device_mesh(device.type, shape, mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def replicated(mesh: DeviceMesh) -> List:
    """DTensor placements of a tensor held in full by every rank."""
    return [Replicate()] * mesh.ndim


def sharded_on(mesh: DeviceMesh, axis: str, ndim: int, dim: int = 0) -> List:
    """DTensor placements that cut tensor dimension ``dim`` (of ``ndim``)
    over mesh axis ``axis`` and replicate it over the others."""
    if not -ndim <= dim < ndim:
        raise ValueError(f"dim {dim} of a {ndim}-dimensional tensor")
    out = replicated(mesh)
    out[mesh.mesh_dim_names.index(axis)] = Shard(dim % ndim)
    return out


def fold_in(generator: torch.Generator, idx: int) -> torch.Generator:
    """A fresh generator on ``generator``'s device for stream ``idx``:
    the port's ``jax.random.fold_in``. One seed is drawn from
    ``generator`` (which, replicated, advances the same way on every
    rank) and mixed with ``idx`` through ``numpy.random.SeedSequence``.
    Two calls give different streams, and so do two ``idx``."""
    draw = int(torch.randint(2 ** 62, (), generator=generator,
                             device=generator.device))
    seed = np.random.SeedSequence([draw, int(idx)]).generate_state(
        1, np.uint64)[0]
    out = torch.Generator(device=generator.device)
    out.manual_seed(int(seed))
    return out
