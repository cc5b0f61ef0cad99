"""``parallel/multihost.py`` of the port in two real processes: the
counterpart of the JAX package's ``tests/test_multihost.py``.

Two OS processes configured only through torchrun's variables
(``MASTER_ADDR``/``MASTER_PORT`` on a free local port, ``WORLD_SIZE``,
``RANK``, and ``LOCAL_WORLD_SIZE=1``: one rank a host) start a gloo group
with ``initialize(device="cpu")``; ``global_mesh`` puts the two hosts on
the data axis, and a SUM all-reduce over it adds the ranks. With no
configuration ``initialize`` starts nothing; a bad explicit one raises."""

import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from quadruped_gym_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE")

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["QG_REPO"])
import torch
import torch.distributed as dist

from quadruped_gym_tpu_torch.parallel import multihost

torch.set_num_threads(1)
assert multihost.initialize(device="cpu"), "no multi-process group"
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = multihost.global_mesh(device="cpu")
assert mesh.mesh_dim_names == ("data", "sample"), mesh.mesh_dim_names
assert mesh.shape == (2, 1), mesh.shape  # one rank a host: data = hosts
x = torch.tensor([float(dist.get_rank())])
dist.all_reduce(x, group=mesh.get_group("data"))
assert float(x) == 1.0, float(x)
assert multihost.initialize(device="cpu")  # a running group is kept
dist.destroy_process_group()
print(f"rank {os.environ['RANK']}: all_reduce ok")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_all_reduce():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_WORLD_SIZE="1",
                   QG_REPO=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: all_reduce ok" in out


def test_no_configuration_starts_nothing(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("addr, nproc, pid", [
    ("127.0.0.1:notaport", 2, 0),
    ("127.0.0.1", 2, 0),
    ("127.0.0.1:1", 2, 2),
], ids=["port", "no-port", "rank"])
def test_bad_explicit_configuration_raises(addr, nproc, pid):
    with pytest.raises(ValueError):
        multihost.initialize(addr, nproc, pid, device="cpu")
    assert not dist.is_initialized()
