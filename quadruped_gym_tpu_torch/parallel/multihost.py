"""Multi-process setup: one ``torch.distributed`` group over every rank of
every host, and the global mesh.

Counterpart of ``quadruped_gym_tpu/parallel/multihost.py``. The recipe:

    from quadruped_gym_tpu_torch import parallel
    parallel.multihost.initialize()          # once per process, all hosts
    mesh = parallel.multihost.global_mesh()  # every rank of every host

and a launcher that starts one process per card, e.g.
``torchrun --nnodes 2 --nproc-per-node 8 ...``. Keep the ``data``
(scenario) axis outermost so that each host's scenarios stay on its own
cards and only the small plan and metric reductions cross hosts.

A single process works unchanged: ``initialize`` returns False when no
coordinator is configured, and ``make_mesh`` then starts a world-1 group.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .._device import resolve_device
from .mesh import (DATA_AXIS, SAMPLE_AXIS, backend_for, check_backend,
                   make_mesh, start_world_one)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Start the process group; True when it holds more than one process.

    The configuration comes from the arguments, else from torchrun's
    variables: ``MASTER_ADDR``/``MASTER_PORT`` for the coordinator
    ("host:port"), ``WORLD_SIZE`` and ``RANK``. Those variables are the
    counterpart of the JAX package's ``JAX_*`` variables and of its TPU-pod
    auto-detection (``TPU_WORKER_HOSTNAMES``): a GPU launcher sets them for
    every process. The rank's card is ``cuda:LOCAL_RANK`` (NCCL); with
    ``device="cpu"`` the group is gloo.

    An explicit configuration that fails raises: a misconfigured launch
    must stop at start-up, not go on as independent single-process runs
    that overwrite each other's checkpoints. A group that is already
    running is kept."""
    if dist.is_initialized():
        check_backend(resolve_device(device))
        return dist.get_world_size() > 1
    addr = coordinator_address
    if addr is None and {"MASTER_ADDR", "MASTER_PORT"} <= set(os.environ):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    nproc = num_processes if num_processes is not None \
        else os.environ.get("WORLD_SIZE")
    pid = process_id if process_id is not None else os.environ.get("RANK")
    if not (addr and nproc is not None and pid is not None):
        return False
    nproc, pid = int(nproc), int(pid)
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id {pid} outside 0..{nproc - 1}")
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {addr!r} is not host:port")
    device = resolve_device(device)
    kw = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", pid % max(
            1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend_for(device), init_method=f"tcp://{addr}",
                            world_size=nproc, rank=pid, **kw)
    return nproc > 1


def global_mesh(
    axis_names: Tuple[str, ...] = (DATA_AXIS, SAMPLE_AXIS),
    data_parallel_per_host: bool = True,
    device=None,
):
    """Mesh over every rank of every host.

    With ``data_parallel_per_host`` the data axis equals the host count
    (ranks over torchrun's ``LOCAL_WORLD_SIZE``, ranks a host; one host
    when it is not set), so the scenario fan-out never crosses hosts and
    the sample reductions stay inside one."""
    device = resolve_device(device)
    if not dist.is_initialized():
        start_world_one(device)
    world = dist.get_world_size()
    if len(axis_names) == 1:
        return make_mesh(axis_names, (world,), device=device)
    nhosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    ndata = nhosts if data_parallel_per_host and world % nhosts == 0 else 1
    return make_mesh(axis_names, (ndata, world // ndata), device=device)
