"""Shared helpers of the benchmark's CPU tests."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the sizes a CPU test runs a cell at: the cell's own code path, S and H cut
TINY = {"num_samples": 16, "horizon": 3, "warmup": 1}
TINY_ENV = {"num_envs": 8, "warmup": 1}
MPC_CELLS = ("planning-mppi-65k", "fast-plant-mppi-65k", "planning-replan-4k",
             "planning-mppi-4rank")
