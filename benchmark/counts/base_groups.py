"""The frozen numbers of a configuration whose model has collision groups
on the base (``full``: the hip servos and the frame), derived on the CPU
by ``derive.py``'s rules over ``leg_engine.py`` here, the leg-batched
formulation with base groups that the substep kernel runs (the
reference's frozen leg engine refuses such a model).

* ``ops_per_substep`` and ``ops_sensors``: ``derive.substep_ops`` with
  this folder's leg engine;
* ``b2_bytes_per_lane``: ``derive.true_bytes`` (the state and control in,
  the state and sensors out, float32).

Run ``python benchmark/counts/base_groups.py <config>`` to print the
numbers the file should hold; the tests hold the file to them.
"""

from __future__ import annotations

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.counts import derive, leg_engine  # noqa: E402
from benchmark.reference import lane_engine  # noqa: E402


def substep_ops(cfg: dict, lanes: int = 4) -> dict:
    """One substep without the sensors, and what the sensors add, a lane."""
    m = derive.model(cfg)
    dt = torch.float64
    ls = lane_engine.make_lane_state(m, lanes, dtype=dt, device="cpu")
    ctrl = torch.zeros((m.nu, lanes), dtype=dt)
    n = {}
    for sens in (False, True):
        _, n[sens] = derive.count_ops(leg_engine._step_impl, m, ls, ctrl,
                                      cfg["newton"], cfg["line_search"], sens)
    return {"ops_per_substep": n[False] // lanes,
            "ops_sensors": (n[True] - n[False]) // lanes}


def derive_counts(cfg: dict) -> dict:
    out = substep_ops(cfg)
    out["b2_bytes_per_lane"] = derive.true_bytes(cfg)["b2_bytes_per_lane"]
    return out


if __name__ == "__main__":
    print(json.dumps(derive_counts(derive.load(sys.argv[1]))))
