"""The benchmark's harness: one cell of ``BENCHMARK.json`` for one seed.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` (the repo's root): the cell's configuration and
  traffic names and which metrics it reports;
* ``benchmark/workloads/<cell>.json``: the cell's check (how many answers
  are sampled, the limits of the numbers compared);
* ``benchmark/configs/<config>.json``: the model, its budget and type, and
  the frozen operation and byte counts;
* ``benchmark/traffic/<traffic>.json``: the traffic's parameters and the
  name of the driver that generates it, ``benchmark/traffic/<driver>.py``;
* ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(ctx)``,
  which returns the number or None where it finds nothing to read.

A run: set-up (the driver builds the program's objects and warms up the
cell's own shapes), a window of ``--seconds`` of back-to-back requests
(with ``--trace 1`` under ``torch.profiler``, the card's activity alone),
then the check of a sample of the window's answers against the plain
reference in ``benchmark/reference/``, and one JSON line.

A cell whose ``chips`` is more than 1 runs on as many ranks, one process
a card (``benchmark/ranks.py``): the process the command started is rank
0, keeps the clock, traces and prints the line; the others follow it
request by request. Its driver takes the ``Ranks`` as a fourth argument
and runs the window through ``Ranks.window``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules that may not be loaded in a run: the JAX package the
# port was made from, and JAX itself
BANNED = ("jax", "jaxlib", "flax", "quadruped_gym_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    """The banned top-level names that ``sys.modules`` holds, compared
    whole (``quadruped_gym_tpu_torch`` is not ``quadruped_gym_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(BANNED))


class Cell(NamedTuple):
    name: str
    chips: int
    workload: dict  # benchmark/workloads/<cell>.json
    config: dict  # benchmark/configs/<config>.json
    traffic: dict  # benchmark/traffic/<traffic>.json
    end_to_end: List[dict]  # BENCHMARK.json's entries this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files;
    ``overrides`` replaces traffic parameters (the CPU tests shrink the
    sizes with it)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    traffic = load_json(BENCH_DIR, "traffic", entry["traffic"] + ".json")
    traffic.update(overrides or {})
    return Cell(
        name=name, chips=entry["chips"],
        workload=load_json(BENCH_DIR, "workloads", name + ".json"),
        config=load_json(BENCH_DIR, "configs", entry["config"] + ".json"),
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


class Request(NamedTuple):
    """One request of the window: host clock (s) from the call to its
    answer on the host, and the work it completed (rollouts)."""

    start: float
    end: float
    work: int


class DeviceEvent(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    events: List[DeviceEvent]  # the card's kernels, copies and sets
    window_s: float  # host clock from the first request to the last answer

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card: the length of
        the union of the events' intervals."""
        busy, end = 0.0, -float("inf")
        for ev in sorted(self.events, key=lambda e: e.start_us):
            if ev.end_us > end:
                busy += ev.end_us - max(ev.start_us, end)
                end = ev.end_us
        return busy * 1e-6

    def kernels(self, name: str) -> List[DeviceEvent]:
        return [ev for ev in self.events if name in ev.name]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps named by the operations on either side of them (the host
        was issuing what came next)."""
        total: dict = {}
        for ev in self.events:
            total[ev.name] = total.get(ev.name, 0.0) + (ev.end_us - ev.start_us) * 1e-6
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        evs = sorted(self.events, key=lambda e: e.start_us)
        gaps, end, last = [], None, None
        for ev in evs:
            if end is not None and ev.start_us > end:
                gaps.append((f"{_short(last)} -> {_short(ev.name)}",
                             (ev.start_us - end) * 1e-6))
            if end is None or ev.end_us > end:
                end, last = ev.end_us, ev.name
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [list(o) for o in ops],
                "idle_gaps": [list(g) for g in gaps[:n]]}


def _short(name: str) -> str:
    return name.split("(")[0].split("<")[0][:60]


class Context(NamedTuple):
    """What a metric reader reads."""

    cell: Cell
    seed: int
    setup_s: float
    requests: List[Request]
    trace: Optional[Trace]
    peaks: dict

    @property
    def window_s(self) -> float:
        return self.requests[-1].end - self.requests[0].start


def device_events(prof) -> List[DeviceEvent]:
    """The card's activities in a ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    return [DeviceEvent(ev.name, float(ev.time_range.start),
                        float(ev.time_range.end))
            for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def kernel_roofline(ctx: Context, kernel: str, ops: float,
                    nbytes: float) -> Optional[float]:
    """Share (%) of the roofline: the least time of one call, the larger
    of ``ops`` over the FP32 peak and ``nbytes`` over the HBM peak, times
    the calls the trace saw, over their device time. None where the trace
    saw no call of ``kernel``."""
    if ctx.trace is None:
        return None
    evs = ctx.trace.kernels(kernel)
    if not evs:
        return None
    bound = max(ops / ctx.peaks["fp32_flops"],
                nbytes / ctx.peaks["hbm_bytes_per_s"])
    busy = sum(ev.end_us - ev.start_us for ev in evs) * 1e-6
    return 100.0 * len(evs) * bound / busy


class Tracer:
    """``torch.profiler`` over a part of the window. The harness calls
    ``tick(0)`` before the window and each driver ``tick(n)`` after its
    n-th request: requests ``skip`` to ``skip + count`` are traced (the
    workload's ``trace``; without one, the whole window, the profiler
    started before the window's clock). A driver's window runs on past
    ``--seconds`` until ``done``: the profiler's first start takes seconds,
    which may not eat the traced part."""

    def __init__(self, skip: int, count: Optional[int], device):
        self.skip, self.count, self.dev = skip, count, device
        self.prof, self.running = None, False

    def _sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def tick(self, n: int) -> None:
        if n == self.skip and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.dev.type == "cuda"
                else ProfilerActivity.CPU])
            self.prof.start()
            self._sync()
            self.running = True
        elif self.count is not None and n == self.skip + self.count:
            self.close()

    def done(self, n: int) -> bool:
        return n > self.skip if self.count is None else n >= self.skip + self.count

    def close(self) -> None:
        if self.running:
            self._sync()
            self.prof.stop()
            self.running = False

    def traced(self, requests: List[Request]) -> List[Request]:
        end = None if self.count is None else self.skip + self.count
        return requests[self.skip:end]


def judge(gaps: dict, limits: dict, failed: int, attempted: int) -> dict:
    """A check's verdict: every number that has a limit is compared with
    it (a NaN fails), the others are read beside them."""
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "checks": checks,
            "look": {k: v for k, v in gaps.items() if k not in limits}}


def rate(ctx: "Context") -> float:
    """All the work the window completed over all its time, from the
    first request's call to the last one's answer."""
    return sum(r.work for r in ctx.requests) / ctx.window_s


def b1_roofline_pct(ctx: "Context") -> Optional[float]:
    """The fused rollout kernel's share (%) of its roofline in an MPC
    cell: per call S x H x the configuration's operations a rollout step,
    and the true bytes S x (H x ctrl bytes a step + the fixed bytes)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    S, H = tr["num_samples"], tr["horizon"]
    return kernel_roofline(
        ctx, "fused_rollout_kernel", S * H * cfg["ops_per_rollout_step"],
        S * (H * cfg["ctrl_bytes_per_step"] + cfg["fixed_bytes_per_rollout"]))


def idle_pct(ctx: "Context") -> Optional[float]:
    """Share (%) of the traced window in which no kernel, copy or set ran
    on the card; None without a trace that saw the card."""
    if ctx.trace is None or not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def mfu_pct(ctx: "Context", ops_per_request: float) -> Optional[float]:
    """The frozen operations of the requests completed in the traced
    window over its time times the FP32 peak (%)."""
    if ctx.trace is None or not ctx.trace.events:
        return None
    return (100.0 * len(ctx.requests) * ops_per_request
            / (ctx.trace.window_s * ctx.peaks["fp32_flops"]))


def _driver(cell: Cell, seed: int, dev, *ranks):
    mod = load_module(
        os.path.join(BENCH_DIR, "traffic", cell.traffic["driver"] + ".py"),
        "bench_traffic_" + cell.traffic["driver"])
    return mod.Driver(cell, seed, dev, *ranks)


def _tracer(cell: Cell, trace: bool, dev) -> Optional[Tracer]:
    if not trace:
        return None
    part = cell.workload.get("trace", {"skip": 0, "requests": None})
    tracer = Tracer(part["skip"], part["requests"], dev)
    tracer.tick(0)
    return tracer


def _readings(cell: Cell, seed: int, setup_s: float, requests, tracer,
              trace: bool):
    """The window's metrics: (the trace or None, metrics, the names of
    those its readers found nothing for)."""
    tr = None
    if tracer is not None:
        requests = tracer.traced(requests)
        if tracer.prof is None or not requests:
            raise RuntimeError("the window ended before its traced part")
        tr = Trace(device_events(tracer.prof),
                   requests[-1].end - requests[0].start)
        tracer.prof = None
    ctx = Context(cell=cell, seed=seed, setup_s=setup_s, requests=requests,
                  trace=tr, peaks=load_json(BENCH_DIR, "peaks.json"))
    metrics, missing = {}, []
    for entry in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(
            os.path.join(BENCH_DIR, "metrics", entry["name"] + ".py"),
            "bench_metric_" + entry["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is None:
            missing.append(entry["name"])
        else:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    return tr, metrics, missing


def _result(check: dict, metrics: dict, missing: list, tr, dev, count: int,
            memory_peak: int) -> dict:
    import torch

    on_card = dev.type == "cuda"
    result = {
        "correct": check["correct"],
        "attempted": check["attempted"],
        "failed": check["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": count,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["missing"] = missing
    result["look"] = check["look"]
    result["checks"] = check["checks"]
    return result


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, plant: Optional[str] = None) -> dict:
    """Set-up, window, metrics and check of one run: the result line's
    object, with the checks under ``checks``. A cell on more than one
    card runs ``run_rank`` on as many ranks (``benchmark/ranks.py``;
    ``plant`` is the faults its CPU tests plant in ranks 1 to N-1)."""
    import torch

    if cell.chips > 1:
        from benchmark import ranks

        return ranks.spmd(
            cell.chips, torch.device(device).type, "benchmark.harness:run_rank",
            {"cell": cell._asdict(), "seed": seed, "seconds": seconds,
             "trace": trace, "t_start": t_start}, plant)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    drv = _driver(cell, seed, dev)
    drv.setup()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    tracer = _tracer(cell, trace, dev)
    requests = drv.window(seconds, tracer)
    if tracer is not None:
        tracer.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    tr, metrics, missing = _readings(cell, seed, setup_s, requests, tracer,
                                     trace)
    check = drv.check()
    return _result(check, metrics, missing, tr, dev, 1, memory_peak)


def run_rank(ranks, cell: dict, seed: int, seconds: float, trace: bool,
             t_start: float) -> Optional[dict]:
    """``run_cell`` on one rank of a cell on several cards: every rank
    sets up its driver and waits for the others (``setup_s``, rank 0's
    clock from its first line, counts the ranks' start); the window runs
    in lockstep; rank 0 alone traces and reads the metrics; the check is
    the driver's, on every rank; rank 0 gathers every rank's memory peak
    and the banned modules each loaded. Rank 0's result, None on the
    others."""
    import torch

    cell = Cell(**cell)
    dev = ranks.device
    on_card = dev.type == "cuda"
    lead = ranks.rank == 0
    drv = _driver(cell, seed, dev, ranks)
    drv.setup()
    if on_card:
        torch.cuda.synchronize(dev)
    ranks.barrier()
    setup_s = time.perf_counter() - t_start

    tracer = _tracer(cell, trace and lead, dev)
    requests = drv.window(seconds, tracer)
    if tracer is not None:
        tracer.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    if lead:
        tr, metrics, missing = _readings(cell, seed, setup_s, requests,
                                         tracer, trace)
    check = drv.check()
    each = ranks.gather_objects((memory_peak, banned_modules()))
    if not lead:
        return None
    result = _result(check, metrics, missing, tr, dev, ranks.world,
                     max(peak for peak, _ in each))
    result["banned_by_rank"] = {r: bad for r, (_, bad) in enumerate(each)
                                if r and bad}
    return result


def _parser():
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv, t_start: float) -> int:
    """The command: look for the card the cell needs, then run it. With
    ``--rank <r> --job <dir>``, rank r of a cell on several cards, which
    rank 0 started (``benchmark/ranks.py``)."""
    if argv[:1] == ["--rank"]:
        from benchmark import ranks

        p = argparse.ArgumentParser(description="One rank of a cell.")
        p.add_argument("--rank", type=int, required=True)
        p.add_argument("--job", required=True)
        child = p.parse_args(argv)
        return ranks.child_main(child.rank, child.job)
    args = _parser().parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {seen}", file=sys.stderr)
        return 3
    return report(cell, args, "cuda", t_start)


def report(cell: Cell, args, device, t_start: float,
           plant: Optional[str] = None) -> int:
    """Run the cell on ``device`` and print its result; the exit code."""
    from benchmark.ranks import EXIT_RANK_FAILED, RankFailed

    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, t_start, plant)
    except RankFailed:
        return EXIT_RANK_FAILED  # the line that names the rank is out
    bad = banned_modules()
    found = [", ".join(bad)] if bad else []
    found += [f"{', '.join(b)} (rank {r})"
              for r, b in result.pop("banned_by_rank", {}).items()]
    if found:
        print(f"benchmark: the run loaded {'; '.join(found)}", file=sys.stderr)
        return 4
    missing = result.pop("missing")
    if missing:
        print("benchmark: no reading of " + ", ".join(missing)
              + " (the trace saw none of what they read)", file=sys.stderr)
        return 5
    if result["device"]["platform"] == "gpu":
        result["device"]["card"] = card_line()
    for name, value in result["look"].items():
        print(f"read {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = result.pop("checks")  # the last key of the line
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them (a card
    set below its maximum runs slower under load)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0]
