"""Tracing / profiling / roofline accounting on the card.

Counterpart of ``quadruped_gym_tpu/utils/profiling.py``:

- ``trace(log_dir)``: context manager around ``torch.profiler`` (the
  card's activity where CUDA is present, else the host's); on exit a
  Chrome trace, ``trace.json``, is written into ``log_dir`` (Perfetto or
  chrome://tracing). It yields the profiler.
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
import os
import time
from typing import Optional

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
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
