"""Tracing / profiling / roofline accounting on the card.

Counterpart of ``quadruped_gym_tpu/utils/profiling.py``:

- ``trace(log_dir)``: context manager around ``torch.profiler`` (the
  card's activity where CUDA is present, else the host's); on exit a
  Chrome trace, ``trace.json``, is written into ``log_dir`` (Perfetto or
  chrome://tracing), with the spans the session recorded on a host track
  of their own above the kernels they issued. It yields the profiler.
- ``span(name)``: a context manager around one layer of the port. It
  records only while a ``torch.profiler`` session runs (``trace`` above,
  or any other caller's, in the thread that started it); otherwise it
  costs one check and records nothing. No switch turns it on. A span
  holds its name, its start and end on ``time.perf_counter_ns`` (the
  clock the benchmark times requests on), its parent and its root (the
  spans of one request share the root); a root also holds a clock
  anchor, its start on ``time.time_ns()``'s clock, through which the
  profiler's timestamps (Unix ns) map onto ``perf_counter`` request by
  request (``to_unix_ns``). Spans live in host memory: ``spans()`` reads
  them, ``clear_spans()`` empties them. A span issues no device
  operation, synchronise or device allocation and is no
  ``record_function`` (an annotation range would cost ~15 us with no
  profiler running and can come back as a device event). The spans, by
  layer (roots first):

  * MPC: ``plan_and_act`` (root), ``mppi.plan``, ``mppi.sample`` (the
    control bounds, the noise, the clamp),
    ``rollout.lane_batched_rollout_cost``,
    ``cuda_engine.fused_rollout_cost`` (the wrapper: checks, uploads, the
    (H, nu, S) copy, the launch geometry), ``cuda_engine.launch`` (the
    ctypes call of a kernel alone), ``mppi.weighted_update``;
  * env: ``networks.sample_action`` (root),
    ``vector_env.batched_autoreset_step`` (root), ``walking.task_step``,
    ``walking.physics`` (the layout conversions and the engine's control
    step), ``cuda_engine.control_step`` (B2's wrapper, with its
    ``cuda_engine.launch``), ``vector_env.autoreset`` (the fresh draw and
    the select);
  * either kernel's first call on a model: ``cuda_engine.pack_model``
    (the model's constants packed and uploaded, once per model, type and
    device).

  Beside the spans, ``ops.cuda_engine.geometry`` holds, by kernel, what
  the wrapper's last launch (an eager call or a CUDA graph's capture)
  got: the model's slots and packed vertices, the block, grid and shared
  bytes, and the registers, local bytes and resident blocks the CUDA
  runtime reports for the built kernel at that size.
- ``cost_summary(fn, *args)``: the operations and bytes of ``fn(*args)``
  run eagerly under a dispatch mode (``ops.cuda_engine.count_cost``),
  with the roofline bound for the card.
- ``measure(fn, *args)``: wall clock of the call (warm-up excluded, the
  card synchronised around the timed calls when the result is on it) and
  the achieved fraction of the roofline.

The only spec is the H100's: no TPU number is the port's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import List, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers used for roofline accounting."""

    name: str
    peak_flops_f32: float  # FLOP/s
    peak_hbm_bytes: float  # B/s


# the published H100 SXM peaks (NVIDIA data sheet): FP32 outside the
# tensor cores, an FMA counted as two operations (as ``count_ops`` counts
# it), and the HBM3 bandwidth
H100 = ChipSpec(name="NVIDIA H100 SXM", peak_flops_f32=67e12,
                peak_hbm_bytes=3.35e12)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with profiling.trace("/tmp/trace") as prof: ...``;
    ``log_dir/trace.json`` is written on exit."""
    from torch.profiler import ProfilerActivity, profile

    # the card's activity alone: traced with the host's ops as well, the
    # card's events went missing on an H100 once earlier profiler sessions
    # had run in the process (13, then 4, then 0 kernels and copies of one
    # launch). With the card's activity alone a short trace late in such a
    # process still saw none once: trace in a fresh process to be sure.
    on_card = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    first = len(_records)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _export_spans(path, spans(), first)


# --------------------------------------------------------------------------
# spans


class Span(NamedTuple):
    """One recorded span (see the module's docstring). ``start_ns`` and
    ``end_ns`` are ``time.perf_counter_ns()`` readings (``end_ns`` is None
    while the span is open); ``parent`` and ``root`` are indices into
    ``spans()`` (``parent`` -1 on a root, whose ``root`` is its own
    index); ``unix_ns`` is a root's clock anchor, ``start_ns`` on
    ``time.time_ns()``'s clock (read between two ``perf_counter_ns``
    readings just before it), and 0 on every other span."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    root: int
    unix_ns: int


# (name, start, end, parent, root, unix) a span, in the order they opened
# (end None while open), and (index, root) of each open one. Plain tuples
# of numbers and a string: the collector stops tracking them, so a long
# trace does not slow Python's garbage collection. Only the thread that
# started the profiler sees it running, so one thread records at a time.
_records: List[tuple] = []
_stack: List[tuple] = []
_profiler_enabled = torch._C._autograd._profiler_enabled
# a root's clock anchor is read again (up to _ANCHOR_TRIES times) where its
# two perf_counter readings lie more than _ANCHOR_NS apart
_ANCHOR_TRIES = 3
_ANCHOR_NS = 20_000


class _Idle:
    """The span of a process that no profiler traces."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_IDLE = _Idle()


class _Recorded:
    __slots__ = ("name", "index", "start", "parent", "root", "unix")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        i = self.index = len(_records)
        if _stack:
            self.parent, self.root = _stack[-1]
            self.unix = 0
        else:
            # the anchor: the wall clock read between two perf_counter
            # readings, again where the thread lost the processor between
            for _ in range(_ANCHOR_TRIES):
                p0 = time.perf_counter_ns()
                unix = time.time_ns()
                p1 = time.perf_counter_ns()
                if p1 - p0 <= _ANCHOR_NS:
                    break
            self.parent, self.root = -1, i
        _stack.append((i, self.root))
        self.start = time.perf_counter_ns()
        if self.parent < 0:
            self.unix = unix + self.start - (p0 + p1) // 2
        _records.append(self._record(None))
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack.pop()
        if self.index < len(_records):  # not cleared while open
            _records[self.index] = self._record(end)
        return False

    def _record(self, end):
        return (self.name, self.start, end, self.parent, self.root, self.unix)


def span(name: str):
    """``with profiling.span("layer.part"): ...``: record the block as a
    span while a ``torch.profiler`` session runs, else nothing."""
    return _Recorded(name) if _profiler_enabled() else _IDLE


def spans() -> List[Span]:
    """The spans recorded since the last ``clear_spans()``, in the order
    they opened."""
    return [Span(*r) for r in _records]


def clear_spans() -> None:
    """Forget the recorded spans (call it between requests: a span still
    open keeps indices into what was cleared)."""
    _records.clear()


def to_unix_ns(t_ns: int, root: Span) -> int:
    """``t_ns``, a ``perf_counter_ns`` reading inside ``root``'s request,
    on the profiler's clock (Unix ns), through ``root``'s anchor."""
    return root.unix_ns + (t_ns - root.start_ns)


def _export_spans(path: str, recorded: List[Span], first: int) -> None:
    """Add the spans from index ``first`` on to the Chrome trace ``path``:
    complete events on a host track of their own (the thread "spans" of
    this process), on the trace's clock (``ts`` in us after its
    ``baseTimeNanoseconds``)."""
    new = [s for s in recorded[first:] if s.end_ns is not None]
    if not new:
        return
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), "spans"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "spans"}})
    for s in new:
        root = recorded[s.root]
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tid,
            "ts": (to_unix_ns(s.start_ns, root) - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"parent": s.parent, "root": s.root}})
    with open(path, "w") as f:
        json.dump(doc, f)


@dataclasses.dataclass
class CostSummary:
    flops: float
    bytes_accessed: float
    flop_time_s: float  # time if compute-bound at peak
    mem_time_s: float  # time if bandwidth-bound at peak
    bound: str  # "compute" | "memory"

    @property
    def roofline_s(self) -> float:
        return max(self.flop_time_s, self.mem_time_s)


def roofline(flops: float, bytes_accessed: float,
             chip: ChipSpec = H100) -> CostSummary:
    """The bound of ``flops`` operations moving ``bytes_accessed`` bytes."""
    ft = flops / chip.peak_flops_f32
    mt = bytes_accessed / chip.peak_hbm_bytes
    return CostSummary(
        flops=float(flops), bytes_accessed=float(bytes_accessed),
        flop_time_s=ft, mem_time_s=mt,
        bound="compute" if ft >= mt else "memory",
    )


def cost_summary(fn, *args, chip: ChipSpec = H100) -> CostSummary:
    """Operations and bytes of ``fn(*args)`` run eagerly, with the
    roofline bound.

    Operations are ``ops.cuda_engine.count_ops``'s (one per elementwise
    output, one or two per reduced input, 2K per output of a contraction
    of size K). Bytes are every dispatched op's tensor inputs and outputs,
    views excluded: the traffic of the unfused program, an upper bound on
    what a fused kernel of the same function moves. It is not XLA's
    post-fusion "bytes accessed", so it cannot be compared with the JAX
    package's numbers. A kernel wrapper launches its kernel outside
    PyTorch's dispatcher: count its plain version instead."""
    from ..ops.cuda_engine import count_cost

    _, flops, byts = count_cost(fn, *args)
    return roofline(flops, byts, chip)


@dataclasses.dataclass
class Measurement:
    wall_s: float
    cost: Optional[CostSummary]

    @property
    def speed_of_light(self) -> Optional[float]:
        """Achieved fraction of the roofline bound (1.0 == at the roof)."""
        if self.cost is None or self.wall_s <= 0:
            return None
        return self.cost.roofline_s / self.wall_s


def _sync(out) -> None:
    """Wait for the card if any tensor of ``out`` lives on it."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _sync(x)


def measure(fn, *args, iters: int = 10, chip: ChipSpec = H100,
            with_cost: bool = True,
            cost: Optional[CostSummary] = None) -> Measurement:
    """Wall clock of ``fn(*args)`` per call (a warm-up call excluded).

    ``cost`` is the roofline to hold the time against; without it, and
    with ``with_cost``, ``cost_summary(fn, *args)`` (which cannot see
    inside a kernel: give a kernel wrapper the count of its plain
    version)."""
    out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    wall = (time.perf_counter() - t0) / iters
    if cost is None and with_cost:
        cost = cost_summary(fn, *args, chip=chip)
    return Measurement(wall_s=wall, cost=cost)
