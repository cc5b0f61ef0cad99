"""A multi-rank cell at a tiny size on the CPU, over gloo ranks, with this
process rank 0: what the benchmark's CPU tests run in a process of their
own, so that each has a time limit and a failure ends no test process.

    python benchmark/tests/_ranks_run.py run <world> <seed> <seconds> <trace> [<plant>]
    python benchmark/tests/_ranks_run.py control <world> <seed> [<plant>]

``run`` prints what ``benchmark/run.py`` prints and exits with its code;
``control`` prints ``control.readings`` (one seed, its control) as JSON.
``plant`` ("<module>:<function>", ``benchmark/tests/_rank_faults.py``) is
planted in every rank."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import control, harness, ranks  # noqa: E402
from benchmark.tests._bench import TINY  # noqa: E402

CELL = "planning-mppi-4rank"


def cell(world: int) -> harness.Cell:
    return harness.load_cell(CELL, {**TINY, "ranks": world})._replace(chips=world)


def main(argv) -> int:
    mode, world, seed, *rest = argv
    world, seed = int(world), int(seed)
    if mode == "run":
        seconds, trace, *plant = rest
        args = argparse.Namespace(seed=seed, seconds=float(seconds),
                                  trace=int(trace))
    else:
        plant = rest
    plant = plant[0] if plant else None
    if plant:
        ranks._function(plant)(setattr)
    if mode == "run":
        return harness.report(cell(world), args, "cpu", T_START, plant)
    out = control.readings(cell(world), [seed], 1, 0.5, "cpu", plant=plant)
    print(json.dumps(out[seed]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
