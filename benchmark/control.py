"""The readings a cell's limits are set from, on the card, in one process
(one a rank for a cell on several cards).

    python3 benchmark/control.py --workload <cell> --seeds <a,b,...> \
        --control-seeds <n> --seconds <s> [--lanes <rollouts a pass>]

For each seed: the cell's set-up, a short window at the cell's own load
and sizes, and the sample of answers its check draws, exactly as
``benchmark/run.py`` does. Then, once for all seeds together, the plain
reference in float64, and for the first ``--control-seeds`` seeds the
control: the same reference put in the program's place and computed in
bfloat16, the precision below the configuration's float32 that a later
change would be tempted by (the physics is elementwise FP32 with no
matrix product, so TF32 would change nothing in it). Prints one JSON line
a seed with the program's numbers and, where run, the control's, each
against the float64 reference. The benchmark's own runs do not run it.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def readings(cell, seeds, control_seeds, seconds, device, lanes=None,
             plant=None):
    """{seed: {"failed": n, "program": gaps, "control": gaps or None}}. A
    cell on several cards reads on as many ranks (``benchmark/ranks.py``;
    ``plant`` as in ``harness.run_cell``)."""
    import torch

    if cell.chips > 1:
        from benchmark import ranks

        return ranks.spmd(
            cell.chips, torch.device(device).type, "benchmark.control:rank_readings",
            {"cell": cell._asdict(), "seeds": list(seeds),
             "control_seeds": control_seeds, "seconds": seconds,
             "lanes": lanes}, plant)
    return _readings(cell, seeds, control_seeds, seconds,
                     torch.device(device), lanes)


def rank_readings(ranks, cell, seeds, control_seeds, seconds, lanes):
    """``readings`` on one rank: rank 0's, None on the others."""
    return _readings(harness.Cell(**cell), seeds, control_seeds, seconds,
                     ranks.device, lanes, ranks)


def _readings(cell, seeds, control_seeds, seconds, device, lanes=None,
              ranks=None):
    import torch

    mod = harness.load_module(
        os.path.join(harness.BENCH_DIR, "traffic",
                     cell.traffic["driver"] + ".py"),
        "bench_traffic_" + cell.traffic["driver"])
    group = () if ranks is None else (ranks,)
    runs = []
    for seed in seeds:
        drv = mod.Driver(cell, seed, device, *group)
        drv.setup()
        drv.window(seconds)
        inputs, outputs, failed, _ = drv.sample()
        runs.append((seed, drv, inputs, outputs, failed))
    refs = mod.reference_many([(d, x) for _, d, x, _, _ in runs],
                              torch.float64, lanes)
    ctls = mod.reference_many([(d, x) for _, d, x, _, _ in runs[:control_seeds]],
                              torch.bfloat16, lanes) if control_seeds else []
    if ranks is not None and ranks.rank != 0:
        return None
    out = {}
    for i, (seed, _, _, outputs, failed) in enumerate(runs):
        out[seed] = {
            "failed": failed,
            "program": mod.gaps(outputs, refs[i], cell.workload),
            "control": (mod.gaps(ctls[i], refs[i], cell.workload)
                        if i < len(ctls) else None),
        }
    return out


def main(argv=None):
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--lanes", type=int, default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"control: the cell needs {cell.chips} CUDA device(s); torch "
              f"sees {seen}", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    res = readings(cell, [int(s) for s in args.seeds.split(",")],
                   args.control_seeds, args.seconds, "cuda", args.lanes)
    for seed, r in res.items():
        print(json.dumps({"workload": args.workload, "seed": seed, **r}))
    print(json.dumps({"workload": args.workload, "seconds": time.perf_counter() - t0,
                      "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
