"""The ranks of a cell on more than one card: one process a card, one
``torch.distributed`` group, rank 0 the process the benchmark's command
started.

``spmd`` runs one function on every rank: rank 0 starts ranks 1 to N-1
as child processes (``benchmark/run.py --rank <r> --job <dir>``), each
joins the group on a ``FileStore`` in a temporary directory (NCCL, one
card a rank, ``device_id`` given so that it binds at once; gloo on the
CPU), and each calls the job's function with its ``Ranks``. Rank 0's
return value is ``spmd``'s; the others' are dropped.

Rank 0 watches the others. A rank that exits with another code than 0,
or that has not reached the point of the run at which rank 0 waits for
it within ``WATCH_S`` seconds, fails the run: rank 0 prints one line on
standard error that names it, kills every rank it started and ends with
``RankFailed`` (or, where its own thread is held in a collective that
will not return, exits with ``EXIT_RANK_FAILED`` at once). A rank whose
parent has died exits. So no run outlives its set-up and window by more
than ``WATCH_S``, which is below the group's own ``GROUP_TIMEOUT_S``.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import importlib
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional

GROUP_TIMEOUT_S = 300.0
WATCH_S = 240.0  # the watcher acts before the group's own timeout
EXIT_RANK_FAILED = 7
STOP = -1  # the request index that ends the window
_POLL_S = 0.2
_GRACE_S = 10.0  # rank 0's own thread, after its peers were killed


class RankFailed(RuntimeError):
    """Another rank raised, died or was late; the message names it."""


class Ranks:
    """This process's rank in the group, and the group's few operations
    that the harness and the drivers use. ``device`` is this rank's: card
    ``rank`` on the card, the CPU with gloo."""

    def __init__(self, rank: int, world: int, device, progress_path: str):
        import torch

        self.rank, self.world, self.device = rank, world, device
        self._steps = 0
        self._fd = os.open(progress_path, os.O_RDWR)
        self._index = torch.zeros(1, dtype=torch.int64, device=device)
        with self._sync():  # joined
            pass

    @contextlib.contextmanager
    def _sync(self, hold: bool = False):
        """Around each call that waits for the other ranks: count it in
        this rank's progress (one int64 a rank in a file that rank 0's
        watcher reads when a rank is late). ``hold``: the wait goes on
        past the call's return (the request that follows it)."""
        self._steps += 1
        os.pwrite(self._fd, struct.pack("<q", self._steps), 8 * self.rank)
        yield

    def lead(self, k: int) -> None:
        """Rank 0: send the next request's index (or ``STOP``)."""
        import torch.distributed as dist

        with self._sync(hold=k != STOP):
            self._index.fill_(k)
            dist.broadcast(self._index, 0)

    def follow(self) -> Optional[int]:
        """Ranks 1 to N-1: the next request's index, None at ``STOP``."""
        import torch.distributed as dist

        with self._sync():
            dist.broadcast(self._index, 0)
            k = int(self._index.item())
        return None if k == STOP else k

    def barrier(self) -> None:
        """Return once every rank has called it: an all-reduce read back
        on the host."""
        import torch
        import torch.distributed as dist

        with self._sync():
            one = torch.ones(1, dtype=torch.int64, device=self.device)
            dist.all_reduce(one)
            n = int(one.item())
        if n != self.world:
            raise RuntimeError(f"barrier counted {n} ranks "
                               f"of {self.world}")

    def all_gather(self, t):
        """Every rank's ``t`` (same shape and type on each), in rank
        order, as one tensor with a leading rank axis."""
        import torch
        import torch.distributed as dist

        out = [torch.empty_like(t) for _ in range(self.world)]
        with self._sync():
            dist.all_gather(out, t.contiguous())
        return torch.stack(out)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        import torch.distributed as dist

        out = [None] * self.world
        with self._sync():
            dist.all_gather_object(out, obj)
        return out

    def window(self, request, seconds: float, tracer=None) -> list:
        """The lockstep window. Rank 0 alone keeps the clock: before each
        request it sends the request's index, and after the window
        ``STOP``; the other ranks follow, request by request, so every
        rank runs the same collectives and the window ends on a whole
        request. ``request(k)`` runs request k on this rank and returns
        its ``Request``. Rank 0 returns its requests, the others []."""
        if self.rank != 0:
            while True:
                k = self.follow()
                if k is None:
                    return []
                request(k)
        reqs, k = [], 0
        t_begin = time.perf_counter()
        while True:
            self.lead(k)
            req = request(k)
            reqs.append(req)
            k += 1
            if tracer is not None:
                tracer.tick(len(reqs))
            if req.end - t_begin >= seconds and (tracer is None
                                                 or tracer.done(len(reqs))):
                self.lead(STOP)
                return reqs

    def close(self) -> None:
        os.close(self._fd)


def _progress(path: str, world: int) -> list:
    with open(path, "rb") as f:
        data = f.read(8 * world)
    return list(struct.unpack(f"<{world}q", data))


def _join_group(rank: int, world: int, device_kind: str, job_dir: str):
    """Join the group as ``rank``; this rank's device."""
    import torch
    import torch.distributed as dist

    kw = {}
    if device_kind == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        kw["device_id"] = device
        backend = "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
    store = dist.FileStore(os.path.join(job_dir, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    return device


def _function(name: str):
    """"<module>:<function>" as the function."""
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


class _Watcher:
    """Rank 0's watch over ranks 1 to N-1 (a thread)."""

    def __init__(self, procs, job_dir: str, world: int):
        self.procs, self.job_dir, self.world = procs, job_dir, world
        self.failed: Optional[str] = None
        self.lock = threading.Lock()
        self.deadline: Optional[float] = None
        self.done = threading.Event()
        self.main_returned = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def expect(self, steps: int) -> None:
        """Rank 0 is about to wait at its ``steps``-th synchronising call:
        every rank has to reach it within ``WATCH_S``."""
        self.deadline = time.monotonic() + WATCH_S
        self.steps = steps

    def dead_rank(self) -> Optional[str]:
        """How the first rank that exited with another code than 0 ended,
        or None."""
        for r, p in self.procs.items():
            rc = p.poll()
            if rc is not None and rc != 0:
                how = (f"was killed by signal {-rc}" if rc < 0
                       else f"exited with code {rc}")
                return f"rank {r} {how}"
        return None

    def _run(self) -> None:
        while not self.done.wait(_POLL_S):
            dead = self.dead_rank()
            if dead:
                return self.fail(dead)
            if self.deadline is not None and time.monotonic() > self.deadline:
                prog = _progress(os.path.join(self.job_dir, "progress"),
                                 self.world)
                late = [r for r in range(1, self.world) if prog[r] < self.steps]
                who = ", ".join(map(str, late)) if late else "1 to N-1"
                self.dump_stacks()
                return self.fail(
                    f"rank(s) {who} did not reach rank 0's synchronising "
                    f"call {self.steps} within {WATCH_S:.0f} s "
                    f"(calls entered, by rank: {prog})")

    def dump_stacks(self) -> None:
        """Every rank's Python stacks on standard error: where each
        waits."""
        for p in self.procs.values():
            if p.poll() is None:
                os.kill(p.pid, signal.SIGUSR1)
        faulthandler.dump_traceback(all_threads=True)
        time.sleep(2.0)

    def fail(self, why: str, wait: bool = True) -> None:
        """Name the failed rank (once), kill every rank started, and, from
        the watcher's thread, end the process if its main thread does not
        come back: gloo's pending operations fail at once when the peers
        go, an NCCL kernel waits for them for ever."""
        with self.lock:
            if self.failed is None:
                self.failed = why
                print(f"benchmark: {why}", file=sys.stderr, flush=True)
        _kill(self.procs)
        if wait and not self.main_returned.wait(_GRACE_S):
            shutil.rmtree(self.job_dir, ignore_errors=True)
            os._exit(EXIT_RANK_FAILED)


def _kill(procs) -> None:
    for p in procs.values():
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs.values():
        p.wait(timeout=60)


def spmd(world: int, device_kind: str, entry: str, kwargs: dict,
         plant: Optional[str] = None):
    """Run ``entry``, "<module>:<function>", on ``world`` ranks, this
    process rank 0: the function is called as ``fn(ranks, **kwargs)`` on
    each (``kwargs`` go to the others as JSON). ``plant``, another
    "<module>:<function>", is called with ``setattr`` in ranks 1 to N-1
    before they join: the faults the benchmark's CPU tests plant (rank
    0's are the caller's to plant). Returns rank 0's value; raises
    ``RankFailed`` where another rank failed."""
    from benchmark import harness

    job_dir = tempfile.mkdtemp(prefix="bench-ranks-")
    progress = os.path.join(job_dir, "progress")
    with open(progress, "wb") as f:
        f.write(b"\0" * 8 * world)
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump({"world": world, "device": device_kind, "entry": entry,
                   "kwargs": kwargs, "plant": plant,
                   "parent": os.getpid()}, f)
    if device_kind == "cuda":
        # the bootstrap of NCCL's rings on this host's loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    run_py = os.path.join(harness.BENCH_DIR, "run.py")
    procs, watcher, ranks, clean = {}, None, None, False
    try:
        for r in range(1, world):
            procs[r] = subprocess.Popen(
                [sys.executable, run_py, "--rank", str(r), "--job", job_dir],
                stdout=2, start_new_session=True)
        watcher = _Watcher(procs, job_dir, world)
        watcher.expect(1)  # every rank joins the group
        device = _join_group(0, world, device_kind, job_dir)
        ranks = _WatchedRanks(0, world, device, progress, watcher)
        out = _function(entry)(ranks, **kwargs)
        # every rank leaves the group together: an NCCL communicator
        # comes down only with all its ranks
        watcher.expect(ranks._steps + 1)
        _leave_group()
        for p in procs.values():
            p.wait()
        watcher.deadline = None
        if watcher.failed:
            raise RankFailed(watcher.failed)
        clean = True
        return out
    except BaseException as exc:
        if watcher is not None:
            # a collective fails on rank 0 as soon as a peer goes: give
            # the peer's exit a moment to show, and name the peer
            time.sleep(1.0)
            dead = watcher.failed or watcher.dead_rank()
            if dead:
                watcher.fail(dead, wait=False)
                raise RankFailed(watcher.failed) from exc
        print(f"benchmark: rank 0 failed: {exc!r}", file=sys.stderr,
              flush=True)
        raise
    finally:
        _kill(procs)
        # an NCCL group whose peers went may not come down: leave it to
        # the process's end
        if clean or device_kind != "cuda":
            _leave_group()
        if watcher is not None:
            watcher.main_returned.set()
            watcher.done.set()
        if ranks is not None:
            ranks.close()
        shutil.rmtree(job_dir, ignore_errors=True)


class _WatchedRanks(Ranks):
    """Rank 0's ``Ranks``: a wait at one of its calls arms the watcher."""

    def __init__(self, rank, world, device, progress_path, watcher):
        self._watcher = watcher
        super().__init__(rank, world, device, progress_path)

    @contextlib.contextmanager
    def _sync(self, hold: bool = False):
        with super()._sync():
            self._watcher.expect(self._steps)
            yield
        if not hold:
            self._watcher.deadline = None


def _leave_group() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _watch_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(0.5)


def child_main(rank: int, job_dir: str) -> int:
    """Ranks 1 to N-1: join the group, run the job's function, leave."""
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    threading.Thread(target=_watch_parent, args=(job["parent"],),
                     daemon=True).start()
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    try:
        if job["plant"]:
            _function(job["plant"])(setattr)
        device = _join_group(rank, job["world"], job["device"], job_dir)
        ranks = Ranks(rank, job["world"], device,
                      os.path.join(job_dir, "progress"))
        _function(job["entry"])(ranks, **job["kwargs"])
        ranks.close()
        _leave_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    return 0
