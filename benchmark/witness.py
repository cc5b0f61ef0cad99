"""A second witness for a cell's check, on the card: where the program and
the float64 reference part, does the reference in the program's own type
(float32) side with the program or with float64?

    python3 benchmark/witness.py --workload <cell> --seed <n> --seconds <s>

Runs the cell's set-up, window and sample as ``benchmark/run.py`` does,
then, for the MPC cells, every checked solve's rollout costs three ways:
the program's fused rollout kernel (B1) on the solve's own sequences, the
reference in float64 and the reference in float32. For the env cell, each
checked step's outputs of the program, and the reference's in float64 and
float32. Prints one JSON line a solve or step: the gaps between each pair,
as distributions over the rollouts or environments. The benchmark's own
runs do not run it.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def _dist(g):
    import torch

    g = g.double().flatten()
    q = torch.quantile(g.cpu(), torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return {"median": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "max": float(g.max()), "over_1e-3": int((g > 1e-3).sum())}


def mpc(cell, drv, inputs):
    import torch

    from benchmark.reference import commands as rc
    from benchmark.reference import mpc as rmpc
    from benchmark.reference import spec as rspec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import State

    cfg, tr = cell.config, cell.traffic
    rm = getattr(rspec, cfg["model"]["getter"])(**cfg["model"]["kwargs"])
    f64 = torch.float64
    cmd = rc.make(torch.tensor([tr["command"][0], 0.0], dtype=f64),
                  torch.tensor(tr["command"][1], dtype=f64))
    kw = dict(num_samples=drv.S, sigma=tr["sigma"], frame_skip=cfg["frame_skip"],
              newton=cfg["newton"], line_search=cfg["line_search"],
              noise_dtype=drv.dtype, block=max(1, 65536 // drv.S))
    r64 = list(rmpc.sample_costs(rm, inputs, cmd, dtype=f64, **kw))
    r32 = list(rmpc.sample_costs(rm, inputs, cmd, dtype=torch.float32, **kw))
    pcmd = drv.cmd
    for x, (s64, c64), (s32, c32) in zip(inputs, r64, r32):
        st = State(x.qpos, x.qvel, x.act, x.time, x.sensordata)
        b1 = cuda_engine.fused_rollout_cost(
            drv.m, st, s32.contiguous(), pcmd, x.prev_ctrl, cfg["frame_skip"],
            cfg["newton"], cfg["line_search"])

        def pair(a, b):
            rel = (a.double() - b.double()).abs() / b.double().abs()
            return {**_dist(rel), "argmin_same": bool(int(a.argmin()) == int(b.argmin())),
                    "best_rel": float(abs(float(a.min()) - float(b.min())) / abs(float(b.min())))}

        top = torch.topk(-c64, 3).indices
        print(json.dumps({"noise_seed": x.noise_seed, "b1_vs_64": pair(b1, c64),
                          "r32_vs_64": pair(c32, c64), "b1_vs_r32": pair(b1, c32),
                          "top3_64": [(int(i), float(c64[i]), float(b1[i]), float(c32[i]))
                                      for i in top]}), flush=True)


def env(cell, drv, inputs, outputs):
    import torch

    ref64 = drv.reference(inputs, torch.float64)
    ref32 = drv.reference(inputs, torch.float32)

    def per_env(a, b):
        """(N,) widest gap of an env over its state and sensors, each field
        over its largest magnitude or 1."""
        cols = []
        for x, y in zip(a, b):
            x, y = x.double(), y.double().to(x.device)
            scale = max(1.0, float(y.abs().max()))
            cols.append(((x - y).abs() / scale).reshape(x.shape[0], -1).amax(1))
        return torch.stack(cols).amax(0)

    for k, (p, r, q) in enumerate(zip(outputs[1], ref64[1], ref32[1])):
        fields = lambda o: (o.state.phys.qpos, o.state.phys.qvel,  # noqa: E731
                            o.state.phys.sensordata)
        print(json.dumps({"step": k, "program_vs_64": _dist(per_env(fields(p), fields(r))),
                          "r32_vs_64": _dist(per_env(fields(q), fields(r))),
                          "program_vs_r32": _dist(per_env(fields(p), fields(q))),
                          "done": int(p.done.sum())}), flush=True)


def main(argv=None):
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("witness: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    mod = harness.load_module(
        os.path.join(harness.BENCH_DIR, "traffic", cell.traffic["driver"] + ".py"),
        "bench_traffic_" + cell.traffic["driver"])
    drv = mod.Driver(cell, args.seed, torch.device("cuda"))
    drv.setup()
    drv.window(args.seconds)
    inputs, outputs, _, _ = drv.sample()
    with torch.no_grad():
        if cell.traffic["driver"] == "mpc_solves":
            mpc(cell, drv, inputs)
        else:
            env(cell, drv, inputs, outputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
