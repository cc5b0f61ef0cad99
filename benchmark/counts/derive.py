"""The frozen numbers of a configuration file, derived on the CPU from the
plain reference (``benchmark/reference/``) alone.

* ``ops_per_rollout_step``: the operations of ONE rollout control step
  (``frame_skip`` leg-engine substeps at the configuration's Newton /
  line-search budget, then the walking stage cost), counted per aten op
  as the rules below say, over 4 lanes and divided by 4. The work has no
  data-dependent branch (fixed budgets, full vertex loops), so every
  rollout step of a solve does exactly this much.
* ``ops_per_substep`` and ``ops_sensors``: one leg-engine substep without
  the sensors, and what the sensors add; a control step of the substep
  kernel (B2) at ``frame_skip`` f is ``f * ops_per_substep + ops_sensors``.
* ``b2_bytes_per_lane``: the true bytes of B2 a lane: the state and the
  control in, the state and the sensors out, float32.
* ``ctrl_bytes_per_step`` and ``fixed_bytes_per_rollout``: the true bytes
  of the fused rollout kernel, S rollouts of H steps moving
  ``S * (H * ctrl_bytes_per_step + fixed_bytes_per_rollout)``: the
  controls in, the start state in and out and the cost out, in float32
  (the formula of ``scripts/torch_kernel_roofline.py::true_bytes``).
* ``stance``: the start state every solve's state is drawn around: the
  model's initial state settled on the floor under the joint centres,
  ``settle_steps`` control steps through the reference in float64 at the
  configuration's budget.

And of a traffic file that drives an actor, ``actor_ops_per_env``: the
operations of the actor's mean for one observation (the matrix products,
the biases and the tanh).

Run ``python benchmark/counts/derive.py <config> [<traffic>]`` to print
the numbers the files should hold; the tests hold the files to them.
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

from benchmark.reference import commands, lane_engine, leg_engine, mpc, rewards, spec  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(HERE), "configs")

# aten ops by how they are counted, as the port's operation count counts
# them: one operation per output element (compares and selects included;
# three for a cross product), one or two per input element of a
# reduction, one per added element of a scatter-add, 2 K per output
# element of a contraction of inner size K (an FMA is two operations, as
# the FP32 peak counts it). Transcendentals count one.
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "reciprocal", "sqrt",
    "rsqrt", "pow", "square", "exp", "log", "sin", "cos", "tanh", "atan2",
    "sign", "floor", "clamp", "clamp_min", "clamp_max", "minimum", "maximum",
    "where", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and",
    "bitwise_or", "bitwise_not", "logical_and", "logical_or", "logical_not"})
_PER_OUTPUT = {"linalg_cross": 3}
_REDUCTIONS = {"sum": 1, "prod": 1, "mean": 1, "amax": 1, "amin": 1,
               "argmax": 1, "argmin": 1, "linalg_vector_norm": 2}
_SCATTER_ADDS = frozenset({"index_add"})
_CONTRACTIONS = frozenset({"dot", "mv", "mm", "bmm"})
_DATA = frozenset({
    "select", "slice", "index", "index_select", "gather", "stack", "cat",
    "view", "_unsafe_view", "reshape", "expand", "permute", "t",
    "transpose", "unsqueeze", "squeeze", "alias", "as_strided", "split",
    "split_with_sizes", "unbind", "clone", "copy", "_to_copy", "detach",
    "lift_fresh", "lift_fresh_copy", "scalar_tensor", "_local_scalar_dense",
    "empty", "empty_like", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "fill", "new_zeros", "new_full", "new_empty",
    "arange", "repeat", "diagonal", "index_copy"})


def _op_count(func, args, out) -> int:
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _DATA:
        return 0
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(o, torch.Tensor)]
    if name in _ELEMENTWISE:
        return sum(o.numel() for o in outs)
    if name in _PER_OUTPUT:
        return _PER_OUTPUT[name] * sum(o.numel() for o in outs)
    if name in _REDUCTIONS:
        return _REDUCTIONS[name] * args[0].numel()
    if name in _SCATTER_ADDS:
        return args[3].numel()
    if name in _CONTRACTIONS:
        return 2 * args[0].shape[-1] * outs[0].numel()
    raise NotImplementedError(f"aten op {name!r} is not classified")


def count_ops(fn, *args):
    """(result, operations) of ``fn(*args)`` run eagerly on the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            count[0] += _op_count(func, args, out)
            return out

    with _Count():
        result = fn(*args)
    return result, count[0]


def model(cfg: dict):
    """The reference's own model of a configuration file."""
    return getattr(spec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])


def ops_per_rollout_step(cfg: dict, lanes: int = 4) -> int:
    m = model(cfg)
    dt = torch.float64
    ls = lane_engine.make_lane_state(m, lanes, dtype=dt, device="cpu")
    seqs = torch.zeros((1, m.nu, lanes), dtype=dt)
    prev = torch.zeros((m.nu, lanes), dtype=dt)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=dt),
                        torch.tensor(0.0, dtype=dt))
    _, n = count_ops(mpc.rollout_costs, m, ls, seqs, prev, cmd,
                     cfg["frame_skip"], cfg["newton"], cfg["line_search"])
    if n % lanes:
        raise ValueError(f"{n} operations do not split over {lanes} lanes")
    return n // lanes


def substep_ops(cfg: dict, lanes: int = 4) -> dict:
    m = model(cfg)
    dt = torch.float64
    ls = lane_engine.make_lane_state(m, lanes, dtype=dt, device="cpu")
    ctrl = torch.zeros((m.nu, lanes), dtype=dt)
    n = {}
    for sens in (False, True):
        _, n[sens] = count_ops(leg_engine._step_impl, m, ls, ctrl, cfg["newton"],
                               cfg["line_search"], sens)
    return {"ops_per_substep": n[False] // lanes,
            "ops_sensors": (n[True] - n[False]) // lanes}


def true_bytes(cfg: dict) -> dict:
    m = model(cfg)
    state_bytes = 4 * (m.nq + m.nv + m.na + 1 + m.nsensordata)
    return {"ctrl_bytes_per_step": 4 * m.nu,
            "fixed_bytes_per_rollout": 2 * state_bytes + 4,
            "b2_bytes_per_lane": 4 * (2 * (m.nq + m.nv + m.na) + m.nu
                                      + m.nsensordata)}


def actor_ops(traffic: dict, obs_dim: int, nu: int = 12, rows: int = 4) -> int:
    from benchmark.reference import env

    sizes = [obs_dim, *traffic["actor"]["hidden"], nu]
    dt = torch.float64
    w = env.ActorWeights([torch.zeros((b, a), dtype=dt) for a, b in zip(sizes, sizes[1:])],
                         [torch.zeros(b, dtype=dt) for b in sizes[1:]],
                         torch.zeros(nu, dtype=dt))
    _, n = count_ops(env.actor_mean, w, torch.zeros((rows, obs_dim), dtype=dt))
    return n // rows


def stance(cfg: dict, settle_steps: int) -> dict:
    """The initial state settled on the floor under the joint centres, in
    float64."""
    m = model(cfg)
    dt = torch.float64
    ls = lane_engine.make_lane_state(m, 1, dtype=dt, device="cpu")
    ctrl = rewards.joint_centers(dt, "cpu")[:, None]
    for _ in range(settle_steps):
        ls = leg_engine.control_step(m, ls, ctrl, cfg["frame_skip"],
                                     solver_iterations=cfg["newton"],
                                     ls_iterations=cfg["line_search"])
    return {k: [float(v) for v in getattr(ls, k)[:, 0]]
            for k in ("qpos", "qvel", "act", "sensordata")}


def derive(cfg: dict) -> dict:
    out = {"ops_per_rollout_step": ops_per_rollout_step(cfg)}
    out.update(substep_ops(cfg))
    out.update(true_bytes(cfg))
    out["stance"] = stance(cfg, cfg["settle_steps"])
    return out


def load(name: str) -> dict:
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(os.path.join(os.path.dirname(HERE), "traffic", name + ".json")) as f:
        return json.load(f)


def obs_dim(traffic: dict) -> int:
    from benchmark.reference import observations

    return observations.PO_OBS_DIM * traffic["env"]["obs_window"]


if __name__ == "__main__":
    if len(sys.argv) > 2:
        tr = load_traffic(sys.argv[2])
        print(json.dumps({"actor_ops_per_env": actor_ops(tr, obs_dim(tr))}))
    else:
        print(json.dumps(derive(load(sys.argv[1]))))
