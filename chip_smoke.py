#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases build,check  # build + kernel checks only

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi).
2. build: every CUDA kernel from ``quadruped_gym_tpu_torch/ops/csrc``,
   all nvcc processes at once; build seconds, ptxas registers/spills, and
   for each main-path launch its block size, dynamic shared memory and
   the blocks the runtime says an SM holds.
3. check: each kernel against its plain PyTorch version on the card, on
   the same inputs, at the tolerances stated below: the fused rollout's
   costs, and the substep kernel's qpos, qvel, act and all 33 sensors;
   widths the block size does not divide included. B2 at the env's
   width and B1 at the replan's and the closed loop's, at every split of
   replicas (1, 2, 4), must agree in every bit; each split is timed. A
   launch the card must refuse (too much shared memory) has to raise.
   The oracle engine
   (plain PyTorch, no kernel): ``physics.engine.step`` on the card
   against the CPU in float64 (a state in contact and one in the air,
   1e-9) on the plant model (``mpc_plant``) and on the gym env's
   (``full``, 24 contacts, the model's Newton budget), in float32 with
   the base far from the world origin against float64, and its float32
   products are true FP32 even while the process-wide TF32 flag is on.
   The gradient solvers (plain PyTorch through ``torch.func``): the
   forward-mode and finite-difference linearizations of H=2 steps from a
   planning-model state in contact (1e-9), and one SQP iteration at H=4
   (its controls and cost, 1e-8), card against CPU in float64. The lane
   engine (plain PyTorch, no kernel): ``lane_engine.step`` at 4/8 on the
   card against the CPU in float64 (256 lanes in contact, 256 in the
   air, 1e-9) on ``mpc_plant`` and on ``full``; and against the leg
   engine on the card, float64, through ``lane_batched_rollout_cost``
   (``"lane"`` against ``"leg"``, ``mpc_plant``, H=2, 1e-8). B1 at the
   parallel phase's batch width (S=4,096, H=50, 2/4, 2 m up) too, at
   the tools phase's: the scenario sweep's (S=16,384, 4/8, DomainParams
   with terrain at its ranges) and the latency demo's planner (S=1,024,
   2/4), and at the research phase's budget study's new model (the fast
   plant with ``n_secondary`` 32, S=1,024, 2/4), each grounded over one
   control step, float32. And both kernels on the hulls the model
   getters' keywords decimate otherwise than the defaults: B1 (S=1,024,
   4/8) and B2 (B=2,048, frame_skip 5, 4/8) on
   ``get_fast_plant_model(n_secondary=None)``, B1 (S=1,024, 2/4) on
   ``get_planning_model(n_directions=64)``, float32, each with its slot
   budgets and launch geometry. Both kernels on ``full``, whose base
   (the frame and the hip servos) collides too: float64 from the base
   pressed to 3 cm (the hip servos touch) and to the floor (the frame
   too, with DomainParams), float32 at the env's width from a standing
   start and from 3 cm (B2: at most 6 of 2,048 lanes may part, as the
   plain version's float32 parts from its float64). The observation
   kernel (``cuda_engine.po_window``) at the env's width and at one env,
   float32 and float64, the window pushed and filled, against its plain
   version: copies equal in every bit, the rest within a few ulp; then
   it and its plain version timed at the env's width.
4. main: the first slice's path at full bench width: ``init_carry`` and 3
   receding-horizon periods of MPPI ``plan_and_act`` (65,536 rollouts,
   H=50, frame_skip 5, fused kernel, Newton/line-search 2/4, float32) on
   the planning model, each followed by ``lane_control_step``; then one
   fused solve on the fast-plant model at 4/8.
5. plan: custom-cost planning through the substep kernel at the same
   width: 3 periods of MPPI ``plan_and_act`` with
   ``lane_engine_impl="pallas"`` and a stage cost the fused kernel
   refuses (``make_cost_fn(m, vel_smooth_eps=0.02)``), each followed by
   ``lane_control_step``; then one CEM ``plan_and_act`` (65,536 samples,
   64 elites, 3 iterations).
6. env: the batched walking env at the width PPO uses: 2,048 envs on the
   fast-plant model, partial observation over 10 frames, ``reset`` and 50
   ``batched_autoreset_step(engine_impl="pallas")`` under random actions:
   one eager step, one capture of the step's CUDA graph, 48 replays.
7. lane: the lane engine, the engine of every model that is not
   leg-compatible and the reference of another structure for those that
   are. (a) The JAX package's own unfused configuration
   (``scripts/latency_report.py``): ``lane_batched_rollout_cost(
   engine_impl="lane")`` on the planning model, S=4,096, H=50,
   frame_skip 5, 2/4, float32, one warm solve timed (synchronised), then
   the fused kernel on the same inputs (the costs' relative difference
   is printed, not gated). (b) ``VectorWalkingEnv(full,
   lane_physics=True)`` at the trainer's width: 2,048 envs, frame_skip
   10, 4 Newton passes, PO window 10, random commands, float32, through
   ``batched_autoreset_step(engine_impl="pallas")``, which on ``full``
   takes B2 and the step's CUDA graph (no fallback warning; one eager
   step, one capture, replays); reset, 5 steps, the replays timed; obs,
   rewards and qpos finite; then B2 against the lane engine on the
   env's states on the card, one substep in float64 (1e-8) and the
   env's control step in float32 (the gap printed, not gated). (c) One lane substep on ``full`` at 2,048
   envs traced (``torch.profiler``): kernels, device time, idle share.
8. parallel: the parallel paths at one rank, a group of this process
   alone over NCCL (started here and destroyed at the end), each held to
   its unsharded counterpart: (a) ``sharded_mppi_plan`` at the main
   phase's width (planning, 65,536 samples, H=50, fused, 2/4), 3 solves
   timed, against ``mppi.plan`` with ``fold_in(generator, 0)`` (mean
   within 1e-6, best cost equal); (b) ``sharded_batch_mppi_plan`` on a
   (1, 1) data x sample mesh, 16 scenarios (commands 0.1-0.3 m/s) x
   4,096 samples, H=50, fused: 16 launches of B1, against 16
   ``mppi.plan`` calls with the fold structure (1e-5); (c)
   ``sharded_rollout_costs`` and ``pipelined_rollout_cost`` (1 stage, 2
   microbatches) against ``batched_rollout_cost``, ``mpc_plant`` on the
   oracle engine, 1,024 x H=4, float32; (d) ``sqp.condense`` on a
   ``horizon`` mesh against the unsharded one at H=50 and the fast
   plant's widths, float64 (1e-12), and ``sqp.solve(mesh=)`` at H=4
   against the unsharded solve; (e) ``rl.train.main --distributed`` at
   2,048 envs, one update of 2 env steps; (f) one
   ``make_distributed_update`` against ``ppo.update_fn`` from the same
   state and rank stream: equal parameters in every bit.
9. loop: the closed loop through ``examples/torch_closed_loop_walk.py``'s
   ``main`` (the JAX package's ``examples/closed_loop_walk.py``): MPPI
   (1,024 samples, H=20, 2 iterations, fused kernel) on the planning
   model driving the oracle
   engine on the ``mpc_plant`` model (feet, shins and ankle servos with
   full hulls) for 150 control steps of ``closed_loop`` (of the
   example's 200) under a 0.15 m/s
   forward command, float32. The walk must be finite, upright and go
   forward (limits at ``WALK_LIMITS``). Then 2 steps of
   ``delayed_closed_loop`` with the oracle plant and 2 with the
   leg-engine plant, the period's split into plan and plant over 1
   period after a first, timed with a synchronise after each part, and one traced
   call of each (``torch.profiler``): the kernels the card ran and its
   idle share.
10. train: PPO at the trainer's defaults (2,048 envs x 32 steps, the
   ``mpc_plant`` model on the oracle engine at frame_skip 10, 12
   contacts, 4 Newton passes, partial observation over 10 frames,
   hidden (256, 256, 128), 4 epochs x 8 minibatches, float32) through
   ``rl.train.main``: 1 iteration of one update into a temporary
   directory, then a resume that continues at iteration 1 with one
   fine-tune update (log_std <= -1.2). Metrics finite,
   32 CSV rows an update, the checkpoint's step after each call, the
   parameters on the card. Then one update timed in two parts (rollout,
   learning), a synchronise after each, one traced update
   (``torch.profiler``: kernels per env step, device time, idle share;
   its rollout cut to 2 env steps, which launch what every step does),
   one ``--lane-physics`` update cut to 2 env steps (the eager leg engine
   takes seconds an env step at this width), and the committed policy
   (``artifacts/walk_r5/policy_params``) on 2,048 of the run's
   observations: card float32 against CPU float64. Neither kernel runs
   on this path (as in the JAX package: the trainer's physics is the
   oracle engine or the eager leg engine). The run's folder (checkpoint,
   reward CSV) is kept for the tools phase.
11. eval: the trainer's per-iteration eval. The committed policy through
   ``rl.evaluate.eval_rollout`` on the card in float32
   (``POWalkingQuadrupedEnv`` on ``full``, obs window 10, frame_skip 10,
   24 contacts, the model's Newton budget), its 20 s episode cut to 0.3
   s (half the JAX test's 0.6 s: 15 control steps) and held to that
   test's limits;
   a control step timed after landing (host clock, synchronised) and one
   substep of its physics traced (``torch.profiler``: kernels, device
   time, idle share); the 20 s episode's cost extrapolated, beside the
   train phase's update; and ``rl.train.main`` at 2,048 envs with the eval on,
   cut to one update of 2 env steps and a 0.1 s eval episode, its
   ``logs/eval_metrics.jsonl`` row, plots and video checked. Neither
   kernel runs on this path (the gym env steps the oracle engine).
12. grad: the gradient solvers through their entry points, float32:
   ``examples/torch_gait_sqp.py``'s ``main`` at its defaults (fast plant,
   H=50, frame_skip 5, 12 contacts, 4 Newton passes, the stance settled
   for 400 steps, the sine warm start) with SQP (1 of 10 iterations; it
   must descend) and iLQR (1 iteration at H=20; never above its initial
   cost):
   costs, the seconds of each part of an iteration, the re-rollout's walk
   (no gait iteration with the FD linearization here: the research phase
   runs ``fd_linearize`` on the fast plant at H=4 in float32, and the
   check phase holds it, card against CPU, on the planning model in
   float64);
   ``examples/torch_closed_loop_gradient.py``'s ``main`` with SQP and
   iLQR (1 of 100 control steps) and the plant's share of a period; 1
   step of ``delayed_closed_loop`` with SQP; one gait SQP iteration
   traced in parts around the settled stance (``torch.profiler``:
   kernels, device time, idle share). Neither kernel runs on this path.
13. tools: the ported examples and scripts through their entry points.
   (a) ``utils.profiling.measure`` of B1 at the main width (S=65,536,
   H=50, 2/4, float32) against its roofline (``cost_summary`` of the plain
   version, equal to ``rollout_flops``; the kernel's true bytes), one
   launch traced into ``chiprun_out/tools_trace_b1`` in a process of its
   own, which must see the kernel on the card; (b)
   ``examples/torch_scenario_sweep.py`` at 16,384 scenarios (one B1 launch
   with DomainParams, timed cold and warm); (c)
   ``scripts/torch_kernel_roofline.py``: the saturation curve over S =
   1,024 ... 65,536, the bounds, registers and occupancy, a trace; (d)
   ``examples/torch_random_rollout.py``, 50 oracle substeps; (e)
   ``examples/torch_latency_demo.py``: synchronised and pipelined solves,
   then the two-process 100 Hz drive over the native ``ControlBus``
   against a plant process stepping the oracle engine on the CPU
   (deadline misses are reported, not gated); (f)
   ``scripts/torch_eval_report.py`` on the committed policy, one
   stochastic and one deterministic episode of 3 control steps; (g)
   ``scripts/torch_export_policy.py`` on the train phase's checkpoint,
   read back bit for bit; (h) the native library builds, a
   ``NativeRewardLogger`` writes 20,000 rows and drops none, and the train
   phase's reward CSV is the native writer's byte for byte. Every cut is
   at ``TOOLS_MEASURE_ITERS`` ... ``TOOLS_EVAL_MAX_TIME`` below.
14. research: the JAX package's research scripts through the port's
   ``main``s, float32, each cut at a ``RESEARCH_*`` constant below: (a)
   ``scripts/torch_latency_parts.py`` (the oracle ``control_step`` at the
   planner's and at the plant's budget, one MPPI solve over B1; K=2, one
   repetition); (b) ``scripts/torch_latency_report.py``
   (``delayed_closed_loop`` with the leg-engine plant at N = 2/3/4, one
   timed call each after one warm-up, the line fit, the controller's work
   and the 100 Hz split, B1 at S=4,096 against the lane route's operation
   count; K=2, one repetition); (c) ``scripts/torch_latency_sweep.py``
   (B1 at S = 1,024 ... 16,384, K=5), beside the tools phase's curve; (d)
   ``scripts/torch_diag_gait.py`` at H=4, once with each linearization
   (AD, then FD from the same cached stance; every stage finite); (e)
   ``scripts/torch_full_plant_budget_study.py``, 20 steps a case (the
   verdict reported, not gated; every case finite and upright).
15. time: ``torch_bench.py`` (the port's ``bench.py``): fused rollouts/s
   of both plants at S=65,536, H=50, float32 through
   ``lane_batched_rollout_cost(engine_impl="fused")`` (synchronised per
   solve, 5 solves after a warm-up; its JSON line printed); the kernel's
   own time per solve (CUDA events); the substep kernel's ``control_step``
   per launch at B=65,536 and B=2,048; each kernel's plain version and
   bound; B1's bound at the closed loop's shape; the custom-cost solve and
   the env's steps/s as phases 5 and 6 measured them.

Phases 4 to 15 each set the launch counters to 0 just before driving
their path and read them just after.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. With no CUDA device, or with any
failure, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from quadruped_gym_tpu_torch._device import card_line, repo_module
from quadruped_gym_tpu_torch.utils.profiling import H100

PHASES = ("device", "build", "check", "main", "plan", "env", "lane",
          "parallel", "loop", "train", "eval", "grad", "tools", "research",
          "time")
S_MAIN = 65536
H_MAIN = 50
FRAME_SKIP = 5
BUDGET = {"planning": (2, 4), "fast_plant": (4, 8)}
N_ENVS = 2048  # PPOConfig.num_envs of the JAX package
ENV_FRAME_SKIP = 4
REPLAN_S = 4096  # the replan cell's rollouts (benchmark/traffic/replan-4k)
# the published H100 SXM peaks (utils/profiling.py's H100: FP32 outside
# the tensor cores in FLOP/s, an FMA counted two as cuda_engine.count_ops
# counts it; HBM3 bandwidth)
PEAK_FP32 = H100.peak_flops_f32
PEAK_BYTES = H100.peak_hbm_bytes
F64_TOL = 1e-8
# float32: ~6e-8 rounding per operation, amplified through the Newton
# contact solve over 5 substeps; a wrong kernel misses by far more
F32_TOL = 1e-4
ROLLOUT = "fused_rollout_cost"
SUBSTEP = "substep"
# the oracle engine on the card against the CPU, float64, one substep, on
# each model and engine options a path steps it with
ORACLE_F64_TOL = 1e-9
ORACLE_CASES = {"mpc_plant": dict(max_contacts=12, solver_iterations=4),
                "full": dict(max_contacts=24, solver_iterations=None)}
# the closed-loop walk: 150 control steps = 1.5 s of simulated time under a
# 0.15 m/s command (cut from the example's 200 for the script's time
# limit; the research phase's budget study walks the same closed loop).
# The JAX package's example typically travels ~0.32 m forward in 200 steps
# with < 3 cm of drift and uprightness > 0.98; the noise streams differ,
# so the limits are loose.
WALK_STEPS = 150
WALK_SPEED = 0.15
WALK_LIMITS = {"forward_m": 0.15, "sideways_m": 0.10, "upright": 0.9}
# the delayed loop, on each plant engine (cut from 20 steps: its lane
# plant takes ~5 s a period; the research phase's latency report drives it
# too); the loop split's periods (cut from 5: each runs the lane plant too)
DELAYED_STEPS = 2
SPLIT_PERIODS = 1
# the train phase: rl.train.main's defaults, one update an iteration
TRAIN_ARGS = ["--timesteps-per-iteration", "65536", "--no-eval"]
LANE_TRAIN_STEPS = 2
# env steps of the traced rollout: a whole one (32 steps, 1.27M kernels)
# kept the profiler busy for ~10 minutes on the H100's host
TRACE_ENV_STEPS = 2
REPO = os.path.dirname(os.path.abspath(__file__))
POLICY = os.path.join(REPO, "artifacts", "walk_r5", "policy_params")
# the network on the card in float32 against float64 on the CPU, relative
# to the largest output: FP32 rounding over 4 layers of <= 260 inputs is
# ~1e-6; TF32 products would miss by ~1e-3
POLICY_TOL = 1e-5
# the eval phase: the committed policy through rl.evaluate.eval_rollout on
# the gym env's model (full), cut from the trainer's 20 s episode to half
# the JAX package's test episode (tests/test_walk_policy.py: 0.6 s, 30
# control steps at frame_skip 10 in float64) for the script's time limit,
# and held to that test's limits
EVAL_MAX_TIME = 0.3
EVAL_EPISODE_S = 20.0  # rl.train's --max-time: the episode it evals
EVAL_LIMITS = {"upright": 0.9, "tracking": 0.5}
EVAL_WARM_STEPS = 8
EVAL_TIMED_STEPS = 2
# rl.train.main at its defaults (2,048 envs), cut to one update of 2 env
# steps and an eval episode of 0.2 s (10 control steps)
EVAL_TRAIN_MAX_TIME = 0.1
EVAL_TRAIN_ARGS = ["--num-steps", "2", "--timesteps-per-iteration", "4096",
                   "--iterations", "1", "--max-time", str(EVAL_TRAIN_MAX_TIME)]
# the gradient solvers against the CPU, float64: A and B of both
# linearizers, and one SQP iteration's controls and cost
GRAD_LIN_TOL = 1e-9
GRAD_SQP_TOL = 1e-8
# the grad phase: examples/torch_gait_sqp.py at its defaults (H=50,
# frame_skip 5, fast plant, float32), cut from 10 iterations;
# examples/torch_closed_loop_gradient.py cut from 100 control steps; the
# delayed loop with SQP. On the card every rollout of H=50 control steps
# takes ~15-18 s (250 host-bound substeps), and a solve makes one per
# iteration plus its initial guess's. (A gait iteration with the FD
# linearization, ~52 s, is no longer run: the research phase's diag_gait
# runs fd_linearize on the fast plant in float32, and check_gradient holds
# it, card against CPU, in float64.)
GAIT_ITERS = {"sqp": 1, "ilqr": 1}
# the iLQR gait's horizon, cut from 50 for the script's time limit (the
# SQP gait times an H=50 iteration; iLQR runs at H=20 in the loops too)
GAIT_ILQR_H = 20
GRAD_LOOP_STEPS = 1
GRAD_DELAYED_STEPS = 1
# the lane engine on the card against the CPU, float64, one step at 4/8,
# and against the leg engine through the rollout dispatch (same math,
# another grouping of the sums)
LANE_F64_TOL = 1e-9
LANE_LEG_TOL = 1e-8
LANE_CHECK_B = 256
# the lane phase: (a) the JAX package's unfused-engine configuration
# (scripts/latency_report.py), (b) the trainer's env width on ``full``
LANE_S, LANE_H, LANE_BUDGET = 4096, 50, (2, 4)
LANE_ENV_FRAME_SKIP = 10
LANE_ENV_STEPS = 5
LANE_ENV_BUDGET = (4, 8)
# B2 against the lane engine on the env's states: one substep in float64
# (the two engines group the same sums otherwise: ~1e-10 on the CPU)
LANE_B2_F64_TOL = 1e-8
LANE_B2_B = 256
# base heights of start states on ``full``: the hip servos touch at 3 cm
# ("low"), the frame too with the base on the floor ("belly")
BASE_HEIGHTS = {"low": 0.03, "belly": 0.0}
# B2 in float32 on ``full`` from "low" at 2,048 lanes, frame_skip 4: the
# lanes that may part from the plain version past F32_TOL. On an H100
# (seeds 29-31) the kernel parted in 1, 1, 0 lanes, the plain version in
# float32 from itself in float64 in 1, 2, 3; a base group that is wrong
# parts in the ~600 lanes whose hip servos touch. The limit is the
# benchmark's envs_off_share, 0.3 % of 2,048.
F32_FULL_LOW_LANES_OFF = 6
# the parallel phase, at one rank over NCCL: (a) the main phase's solve
# through sharded_mppi_plan, 3 solves; (b) BASELINE config 3's 4,096
# rollouts a scenario over 16 scenarios on a (1, 1) data x sample mesh;
# (c) oracle rollouts of mpc_plant, sharded and pipelined (1 stage, 2
# microbatches); (d) the condensation at the gait's horizon, then an SQP
# solve at H=4; (e) the trainer at its 2,048 envs, one update of 2 env
# steps; (f) one distributed update against update_fn
PAR_SOLVES = 3
PAR_B, PAR_S = 16, 4096
PAR_ROLLOUT_S, PAR_ROLLOUT_H, PAR_MICROBATCHES = 1024, 4, 2
# (a): the softmax is an exp over a SUM all-reduce here, another rounding
# of the weights (~1e-7 in float32), relative to the largest control (at
# least 1); (b) the dryrun's atol
PAR_MEAN_TOL = 1e-6
PAR_BATCH_TOL = 1e-5
PAR_CONDENSE_TOL = 1e-12
PAR_TRAIN_ARGS = ["--distributed", "--num-steps", "2",
                  "--timesteps-per-iteration", "4096", "--iterations", "1",
                  "--no-eval"]
# the tools phase (the ported examples and scripts of the JAX package):
# (a) profiling.measure of B1 at the main width; (b) the scenario sweep at
# its default width; (c) the roofline curve, its repetitions cut from 10;
# (d) the random rollout cut from 10 s to 0.1 s (50 oracle substeps); (e)
# the latency demo, its measurements cut from 50 to 5 solves, its drive
# from 5 s to 2 s, the plant's settling from 400 to 200 steps; (f) the eval
# report on the committed policy, one seed, its 20 s episode cut to 3
# control steps; (g) the export of the train phase's checkpoint; (h) the
# native logger at 20,000 rows
TOOLS_MEASURE_ITERS = 3
# (a)'s traced launch runs in a process of its own (``trace_b1``)
TRACE_TIMEOUT_S = 300
SWEEP_S, SWEEP_SEED = 16384, 0
ROOFLINE_REPS = 3
RANDOM_ROLLOUT_S = 0.1
LATENCY_ARGS = ["--measure-iters", "5", "--seconds", "2",
                "--settle-steps", "200"]
TOOLS_EVAL_MAX_TIME = 0.06
NATIVE_ROWS = 20000
# the research phase (the JAX package's research scripts): (a) the latency
# parts' K cut from 20 to 2 and their repetitions from 3 to 1 (the
# plant-budget part runs all 100 Newton passes in float32 once the robot
# is down: ~0.5 s a call); (b) the latency
# report's closed loops cut from N = 25/50/100 x 5 repetitions (a period
# with the leg-engine predictor and plant takes seconds) to N = 2/3/4 x 1
# after one warm-up, its K-call timings from K=20 x 3 to K=2 x 1; (c) the
# sweep's K cut from 20 to 5; (d) diag_gait's horizon cut from 12 to 4,
# run with each linearization;
# (e) the budget study cut from 200 to 20 steps a case
RESEARCH_K = 2
RESEARCH_PARTS_ARGS = ["--k", str(RESEARCH_K), "--reps", "1"]
RESEARCH_REPORT_NS = (2, 3, 4)
RESEARCH_REPORT_ARGS = ["--ns", *map(str, RESEARCH_REPORT_NS), "--loop-reps",
                        "1", "--warm", "1", "--k", str(RESEARCH_K), "--reps",
                        "1"]
RESEARCH_SWEEP_K = 5
RESEARCH_DIAG_H = 4
RESEARCH_STUDY_STEPS = 20
EVAL_KEYS = {"episode_return", "steps", "survived", "mean_tracking_error",
             "final_tracking_error", "mean_uprightness", "command_speed",
             "iteration"}


def log(*args):
    print(*args, flush=True)




# --------------------------------------------------------------------------
# inputs


def start_state(m, kind: str, rng, dtype, device):
    """A shared start state near ``qpos0`` (perturbed so the base moves
    from the first substep), grounded, 0.5 m up, 2 m up ("high": in
    the air for a whole H=50 rollout, whose 0.5 s fall 1.23 m), or the
    base at a height of ``BASE_HEIGHTS``."""
    from quadruped_gym_tpu_torch.physics.engine import State

    qpos = np.asarray(m.qpos0, np.float64) + 0.02 * rng.standard_normal(m.nq)
    if kind == "airborne":
        qpos[2] += 0.5
    elif kind == "high":
        qpos[2] += 2.0
    elif kind in BASE_HEIGHTS:
        qpos[2] = BASE_HEIGHTS[kind]
    qvel = 0.1 * rng.standard_normal(m.nv)
    act = np.array([0.0, 0.0, -0.5] * 4)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return State(qpos=t(qpos), qvel=t(qvel), act=t(act),
                 time=t(0.0), sensordata=t(np.zeros(m.nsensordata)))


def command(dtype, device, vx=0.2, vy=0.0, heading=0.0):
    from quadruped_gym_tpu_torch.tasks.commands import make

    return make(torch.tensor([vx, vy], dtype=dtype, device=device),
                torch.tensor(heading, dtype=dtype, device=device))


def prev_ctrl(dtype, device):
    return torch.tensor([0.0, 0.0, -0.5] * 4, dtype=dtype, device=device)


def random_seqs(gen, S, H, dtype, device, scale):
    prev = prev_ctrl(dtype, device)
    noise = torch.randn((S, H, 12), generator=gen, dtype=dtype, device=device)
    return torch.clamp(prev + scale * noise, -1.0, 1.0)


# --------------------------------------------------------------------------
# phases


def phase_device(rec):
    name = torch.cuda.get_device_name(0)
    rec["card"] = card_line("cuda")
    rec["kind"] = name
    log(f"device: {name} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {rec['card']}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")


def phase_build(rec):
    from quadruped_gym_tpu_torch.ops import _build

    sources = _build.kernel_sources()
    t0 = time.perf_counter()
    _build.build_all(sources, ("float32", "float64"))
    rec["build_s"] = time.perf_counter() - t0
    log(f"build: {rec['build_s']:.1f} s for float32 + float64 of "
        f"{', '.join(sources)} (nvcc in parallel)")
    for source in sources:
        for dtype in ("float32", "float64"):
            report = _build.ptxas_report(source, dtype)
            rec[f"ptxas_{source}_{dtype}"] = report
            log(f"ptxas {source} {dtype}:\n{report}")
    launch_report(rec)


def geometry_of(source, m, dtype, n):
    """``launch_geometry`` as the wrapper of ``source``'s kernel takes it
    for ``n`` robots of ``m``."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    kernel = SUBSTEP if source == cuda_engine.SUBSTEP_SOURCE else ROLLOUT
    return cuda_engine.launch_geometry(
        cuda_engine.model_slots(m), dtype, n,
        cuda_engine.scheduler_warps(kernel, m))


def launch_report(rec):
    """Block size, grid and dynamic shared memory of every main-path
    launch, with the registers, local bytes and resident blocks per SM
    the CUDA runtime reports for the built kernel at that shape."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    f32 = torch.float32
    rec["launch"] = {}
    for label, source, model, n in (
            ("B1 planning", cuda_engine.KERNEL_SOURCE, "planning", S_MAIN),
            ("B1 replan", cuda_engine.KERNEL_SOURCE, "planning", REPLAN_S),
            ("B1 fast_plant", cuda_engine.KERNEL_SOURCE, "fast_plant", S_MAIN),
            ("B2 planning", cuda_engine.SUBSTEP_SOURCE, "planning", S_MAIN),
            ("B2 fast_plant", cuda_engine.SUBSTEP_SOURCE, "fast_plant",
             S_MAIN),
            ("B2 env", cuda_engine.SUBSTEP_SOURCE, "fast_plant", N_ENVS),
            ("B1 full", cuda_engine.KERNEL_SOURCE, "full", S_MAIN),
            ("B2 full env", cuda_engine.SUBSTEP_SOURCE, "full", N_ENVS)):
        m = getattr(spec, f"get_{model}_model")()
        nslot = cuda_engine.model_slots(m)
        geo = geometry_of(source, m, f32, n)
        info = cuda_engine.kernel_info(source, f32, geo.threads,
                                       geo.smem_bytes, geo.split)
        info.update(grid=geo.grid, nslot=nslot, n=n)
        rec["launch"][label] = info
        log(f"launch {label}: n={n}, {nslot} slots a leg, float32: split "
            f"{geo.split}, grid "
            f"{geo.grid} x {geo.threads} threads, {geo.smem_bytes} B dynamic "
            f"shared a block; {info['registers']} registers and "
            f"{info['local_bytes']} B local a thread; "
            f"{info['blocks_per_sm']} blocks = "
            f"{info['blocks_per_sm'] * geo.threads // 32} warps resident "
            f"per SM (CUDA occupancy API)")


def model_of(model):
    """``model`` itself, or the model a name selects (``spec.SNAPSHOTS``)."""
    from quadruped_gym_tpu_torch.models import spec

    return spec.get_snapshot(model) if isinstance(model, str) else model


def check_case(rec, label, model, kind, S, H, fs, budget, dtype, tol,
               dp_ranges=None, seed=0):
    """Kernel vs plain version on the card, on the same inputs; ``model``
    is a model or names one (``model_of``)."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev = torch.device("cuda")
    m = model_of(model)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = start_state(m, kind, rng, dtype, dev)
    seqs = random_seqs(gen, S, H, dtype, dev, 0.3)
    cmd = command(dtype, dev, 0.2, 0.1, 0.3)
    prev = prev_ctrl(dtype, dev)
    dp = None
    if dp_ranges is not None:
        dp = spec.sample_domain_params(gen, S, dtype=dtype, **dp_ranges)
    it, lsi = budget
    got = cuda_engine.fused_rollout_cost(m, state, seqs, cmd, prev, fs, it,
                                         lsi, dp=dp)
    torch.cuda.synchronize()
    ref = cuda_engine.fused_rollout_cost_reference(m, state, seqs, cmd, prev,
                                                   fs, it, lsi, dp=dp)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel costs")
    err = (got - ref).abs()
    bad = err > tol + tol * ref.abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
    log(f"check {label}: S={S} H={H} frame_skip={fs} budget {it}/{lsi} "
        f"{dtype}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
        f"(rtol=atol={tol:g}); {int(bad.sum())} of {S} outside; "
        f"card: {rec['card']}")
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version ({int(bad.sum())} rollouts)")
    rec.setdefault("checks", {})[label] = {"max_abs_err": max_abs,
                                           "max_rel_err": max_rel}
    return max_abs


def lane_inputs(m, kind, B, rng, dtype, device):
    """A batch-minor ``LaneState`` of B lanes near ``qpos0``, each lane
    perturbed on its own and moving, grounded, 0.5 m up, or pressed to
    3 cm ("contact": the feet, shins and, on ``full``, the base and hips
    touch), and (12, B) controls."""
    from quadruped_gym_tpu_torch.ops.lane_engine import LaneState

    qpos = (np.asarray(m.qpos0, np.float64)[:, None]
            + 0.02 * rng.standard_normal((m.nq, B)))
    if kind == "airborne":
        qpos[2] += 0.5
    elif kind == "contact":
        qpos[2] = 0.03
    elif kind in BASE_HEIGHTS:
        qpos[2] = BASE_HEIGHTS[kind]
    qvel = 0.1 * rng.standard_normal((m.nv, B))
    act = np.tile(np.array([0.0, 0.0, -0.5] * 4)[:, None], (1, B))
    ctrl = np.clip(act + 0.3 * rng.standard_normal((m.nu, B)), -1.0, 1.0)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    ls = LaneState(qpos=t(qpos), qvel=t(qvel), act=t(act),
                   time=t(0.002 * np.arange(B)),
                   sensordata=t(np.ones((m.nsensordata, B))))
    return ls, t(ctrl)


def check_substep(rec, label, model, kind, B, nsub, budget, dtype, tol,
                  dp_ranges=None, seed=0, single_step=False, sensors=True,
                  lanes_off=0):
    """The substep kernel vs its plain version on the card, on the same
    inputs: qpos, qvel, act, time and every sensor; ``model`` as in
    ``check_case``. Up to ``lanes_off`` lanes may hold values outside
    ``tol`` (float32 contact that parts chaotically between two orders)."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev = torch.device("cuda")
    m = model_of(model)
    ls, ctrl = lane_inputs(m, kind, B, np.random.default_rng(seed), dtype,
                           dev)
    dp = None
    if dp_ranges is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dp = spec.sample_domain_params(gen, B, dtype=dtype, **dp_ranges)
    it, lsi = budget
    if single_step:
        got = cuda_engine.step(m, ls, ctrl, it, lsi, dp=dp,
                               compute_sensors=sensors)
        torch.cuda.synchronize()
        ref = cuda_engine.step_reference(m, ls, ctrl, it, lsi, dp=dp,
                                         compute_sensors=sensors)
    else:
        got = cuda_engine.control_step(m, ls, ctrl, nsub, it, lsi, dp=dp)
        torch.cuda.synchronize()
        ref = cuda_engine.control_step_reference(m, ls, ctrl, nsub, it, lsi,
                                                 dp=dp)
    torch.cuda.synchronize()
    errs, n_bad = {}, 0
    off = torch.zeros(B, dtype=torch.bool, device=dev)
    for f in got._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: {f} has a wrong shape or is "
                                 "not finite")
        err = (g - r).abs()
        out = err > tol + tol * r.abs()
        n_bad += int(out.sum())
        off |= out.reshape(-1, B).any(0)
        errs[f] = float(err.max())
    n_off = int(off.sum())
    if not sensors and float(got.sensordata.abs().max()) != 0.0:
        raise AssertionError(f"{label}: sensordata must be zeros")
    if sensors and float(got.sensordata.abs().min(dim=1).values.max()) == 0.0:
        raise AssertionError(f"{label}: a sensor row was left unwritten")
    what = "step" if single_step else f"control_step frame_skip={nsub}"
    log(f"check substep {label}: B={B} {what} sensors={sensors} budget "
        f"{it}/{lsi} {dtype}: max_abs_err "
        + " ".join(f"{f} {e:.3e}" for f, e in errs.items())
        + f" (rtol=atol={tol:g}); {n_bad} values outside, in {n_off} of "
        f"{B} lanes (at most {lanes_off}); card: {rec['card']}")
    if n_off > lanes_off:
        raise AssertionError(f"{label}: the substep kernel disagrees with "
                             f"its plain version ({n_bad} values in {n_off} "
                             "lanes)")
    rec.setdefault("checks", {})[f"substep {label}"] = errs
    return max(errs.values())


# the observation kernel against its plain version, as
# tests/test_torch_observation_kernel.py holds its host build: copies equal
# in every bit; the quaternion and the heading within a few ulp (the norms'
# order of summation, fused multiply-adds), the Euler angles within that
# over sqrt(1 - s**2), s the sine of the pitch (asin and the atan2s lose
# digits near gimbal lock), at most sqrt(2 tol)
OBS_TOL = {torch.float64: 1e-12, torch.float32: 8 * 2.0**-23}
OBS_WINDOW = 10  # the trainer's window
OBS_COMPUTED = [6, 7, 8, 25]  # the Euler angles and the heading
OBS_GRAPH_CALLS = 20


def observation_inputs(n, dtype, rng, dev):
    """``cuda_engine.po_window``'s arguments for ``n`` envs as the env step
    holds them (sensordata the transpose of a lane state's, the filter
    quaternion a view of qpos), times on both sides of settling_time / 2
    = 0.5; from 4 envs on, env 0 has zero gyro, env 1 zero accel, env 2
    both, env 3 sits at 0.5."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.tasks import commands, observations
    from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices

    sl = SensorSlices.from_model(spec.get_fast_plant_model())

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    lanes = rng.standard_normal((33, n))
    lanes[sl.accel + 2] += 9.81
    qpos = rng.standard_normal((n, 19))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    time = rng.uniform(0.0, 1.0, n)
    if n >= 4:
        lanes[sl.gyro:sl.gyro + 3, [0, 2]] = 0.0
        lanes[sl.accel:sl.accel + 3, [1, 2]] = 0.0
        time[:3] = 0.75
        time[3] = 0.5
    cmd = commands.make(t(rng.uniform(-0.5, 0.5, (n, 2))),
                        t(rng.uniform(-3.0, 3.0, n)))
    carry = observations.PoObsCarry(
        mad_quat=t(qpos)[:, 3:7],
        buffer=t(rng.standard_normal((n, OBS_WINDOW, 26))))
    return (sl, t(lanes).T, t(rng.uniform(-1, 1, (n, 12))), cmd, carry,
            t(time), 1.0, 0.02)


def check_observation(rec, seed=31, iters=50):
    """The observation kernel (``cuda_engine.po_window``) against its plain
    version on the card, at the env's width and at one env (the gym env),
    float32 and float64, the window pushed and filled; then both timed
    at the env's width in float32 (CUDA events, medians)."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        tol = OBS_TOL[dtype]
        for n in (N_ENVS, 1):
            for fill in (False, True):
                args = observation_inputs(n, dtype, rng, dev)
                before = cuda_engine.launch_counts["po_window"]
                got = cuda_engine.po_window(*args, fill=fill)
                torch.cuda.synchronize()
                if cuda_engine.launch_counts["po_window"] != before + 1:
                    raise AssertionError("po_window did not launch once")
                want = cuda_engine.po_window_reference(*args, fill=fill)
                frame, ref = got.buffer[:, -1], want.buffer[:, -1]
                copied = [k for k in range(26) if k not in OBS_COMPUTED]
                old = args[4].buffer
                kept = (torch.equal(got.buffer, frame[:, None].expand_as(old))
                        if fill else torch.equal(got.buffer[:, :-1],
                                                 old[:, 1:]))
                copies_equal = kept and torch.equal(frame[:, copied],
                                                    ref[:, copied])
                w, x, y, z = want.mad_quat.double().unbind(-1)
                s = 2.0 * (w * y - z * x)
                euler_room = tol / torch.sqrt(torch.clamp_min(1.0 - s * s,
                                                              tol / 2))
                room = torch.stack([euler_room] * 3 + [
                    torch.full_like(euler_room, tol)], dim=1)
                room = room + tol * ref[:, OBS_COMPUTED].double().abs()
                gap = (frame[:, OBS_COMPUTED]
                       - ref[:, OBS_COMPUTED]).double().abs()
                qgap = (got.mad_quat - want.mad_quat).abs()
                err = max(float(gap.max()), float(qgap.max()))
                ok = (copies_equal and bool((gap <= room).all())
                      and bool((qgap <= tol + tol * want.mad_quat.abs())
                               .all()))
                label = (f"{'fill' if fill else 'push'} n={n} "
                         f"{str(dtype).split('.')[-1]}")
                log(f"check observation {label}: copies equal "
                    f"{copies_equal}; max_abs_err of the computed entries "
                    f"{err:.3e} (tol {tol:.3g}, the Euler angles' scaled "
                    f"by their conditioning); card: {rec['card']}")
                if not ok:
                    raise AssertionError(f"observation {label}: the kernel "
                                         "disagrees with its plain version")
                rec.setdefault("checks", {})[f"observation {label}"] = err
                if dtype == torch.float32 and n == N_ENVS:
                    worst = max(worst, err)
    rec["observation_max_abs_err"] = worst
    # both timed at the env's width, float32, the window pushed: a call
    # eagerly (the wrapper's host time included) and a call inside a CUDA
    # graph of OBS_GRAPH_CALLS calls, as the env step's graph replays it
    args = observation_inputs(N_ENVS, torch.float32, rng, dev)
    times = {}
    for name, fn in (("", lambda: cuda_engine.po_window(*args)),
                     ("plain_", lambda: cuda_engine.po_window_reference(
                         *args))):
        times[f"{name}eager_ms"] = statistics.median(event_ms(fn, iters))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(OBS_GRAPH_CALLS):
                fn()
        times[f"{name}ms"] = statistics.median(
            event_ms(graph.replay, iters)) / OBS_GRAPH_CALLS
    # bytes: the window read and written, the 29 values an env reads
    # (gyro, accel, velocity, ctrl, the command's velocity and heading,
    # the quaternion, the time) and the 4 it writes besides
    nbytes = 4 * N_ENVS * (2 * OBS_WINDOW * 26 + 29 + 4)
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    rec["observation_timing"] = dict(times, bound_ms=bound_ms,
                                     bound_by="bytes")
    log(f"time observation: {N_ENVS} envs, window {OBS_WINDOW}, float32, "
        f"push: a call in a graph of {OBS_GRAPH_CALLS} kernel "
        f"{times['ms']:.5f} ms, plain version {times['plain_ms']:.5f} ms; "
        f"a call eagerly {times['eager_ms']:.4f} / "
        f"{times['plain_eager_ms']:.4f} ms (medians of {iters}, CUDA "
        f"events); bound {bound_ms:.5f} ms ({nbytes} bytes at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s): the kernel in a graph "
        f"{100 * bound_ms / times['ms']:.2f} % of it; grid "
        f"{-(-N_ENVS // 8)} x 256 threads; card: {rec['card']}")


def phase_check(rec):
    f64, f32 = torch.float64, torch.float32
    dp = dict(friction_range=(0.4, 0.8), gain_range=(0.8, 1.2),
              mass_range=(0.9, 1.5), tilt_range=(-0.1, 0.1),
              terrain_amp_range=(0.0, 0.02))
    check_case(rec, "f64 planning grounded", "planning", "grounded",
               4096, 1, 5, (4, 8), f64, F64_TOL, seed=1)
    check_case(rec, "f64 planning airborne", "planning", "airborne",
               4096, 3, 2, (4, 8), f64, F64_TOL, seed=2)
    check_case(rec, "f64 planning DomainParams", "planning", "grounded",
               4096, 1, 3, (4, 8), f64, F64_TOL, dp_ranges=dp, seed=3)
    check_case(rec, "f64 fast_plant grounded", "fast_plant", "grounded",
               4096, 1, 5, (4, 8), f64, F64_TOL, seed=4)
    # the full collision model: the hip servos, then the frame too, touch
    check_case(rec, "f64 full low", "full", "low", 4096, 1, 5, (4, 8), f64,
               F64_TOL, seed=23)
    check_case(rec, "f64 full belly DomainParams", "full", "belly", 1024, 1,
               3, (4, 8), f64, F64_TOL, dp_ranges=dp, seed=24)
    # S that no block size divides: the last block's spare quads run on a
    # clamped rollout and must store nothing
    check_case(rec, "f64 planning ragged S", "planning", "grounded",
               4001, 2, 2, (4, 8), f64, F64_TOL, seed=7)
    # the main path's width, type and budget; H cut to one control step
    # because grounded rollouts diverge chaotically across bit-different
    # programs over longer horizons
    # the closed loop's planner launches the same kernel at its own width
    # and budget (fewer blocks than the card has SMs), and so do the tools
    # phase's scenario sweep (DomainParams with terrain) and latency demo:
    # each taken from its example so the two cannot drift apart
    walk = _example("torch_closed_loop_walk").mpc_config().mppi
    sweep = _example("torch_scenario_sweep")
    demo = _example("torch_latency_demo").mpc_config().mppi
    # the research phase's budget study: the fast plant with its shin and
    # ankle-servo hulls at 32 support directions, at the 2/4 budget
    study = _script("torch_full_plant_budget_study").mpc_config(2, 4).mppi
    rec["max_abs_err_main_shape"] = max(
        check_case(rec, "f32 planning grounded (main-path width)",
                   "planning", "grounded", S_MAIN, 1, FRAME_SKIP,
                   BUDGET["planning"], f32, F32_TOL, seed=5),
        check_case(rec, "f32 fast_plant grounded (main-path width)",
                   "fast_plant", "grounded", S_MAIN, 1, FRAME_SKIP,
                   BUDGET["fast_plant"], f32, F32_TOL, seed=6),
        check_case(rec, "f32 planning grounded (loop width)",
                   "planning", "grounded", walk.num_samples, 1,
                   walk.rollout.frame_skip,
                   (walk.lane_newton_iterations, walk.lane_ls_iterations),
                   f32, F32_TOL, seed=8),
        check_case(rec, "f32 planning airborne (loop width and horizon)",
                   "planning", "airborne", walk.num_samples,
                   walk.rollout.horizon, walk.rollout.frame_skip,
                   (walk.lane_newton_iterations, walk.lane_ls_iterations),
                   f32, F32_TOL, seed=9),
        # the parallel phase's batch planner: S=4,096 a scenario, H=50,
        # in the air throughout (from 0.5 m up the robot lands within the
        # horizon, and float32 contact diverges chaotically between two
        # bit-different programs: 3 of 4,096 rollouts by up to 0.19 %)
        check_case(rec, "f32 planning high (parallel batch width)",
                   "planning", "high", PAR_S, H_MAIN, FRAME_SKIP,
                   BUDGET["planning"], f32, F32_TOL, seed=10),
        check_case(rec, "f32 planning grounded DomainParams (sweep width)",
                   "planning", "grounded", SWEEP_S, 1, sweep.FRAME_SKIP,
                   sweep.BUDGET, f32, F32_TOL, dp_ranges=sweep.DP_RANGES,
                   seed=19),
        check_case(rec, "f32 planning grounded (latency demo width)",
                   "planning", "grounded", demo.num_samples, 1,
                   demo.rollout.frame_skip,
                   (demo.lane_newton_iterations, demo.lane_ls_iterations),
                   f32, F32_TOL, seed=20),
        check_case(rec, "f32 fast_plant_nsec32 grounded (budget study "
                   "width)", "fast_plant_nsec32", "grounded",
                   study.num_samples, 1, study.rollout.frame_skip,
                   (study.lane_newton_iterations, study.lane_ls_iterations),
                   f32, F32_TOL, seed=22),
        check_case(rec, "f32 full grounded", "full", "grounded", 4096, 1,
                   FRAME_SKIP, BUDGET["fast_plant"], f32, F32_TOL, seed=27),
    )
    # the substep kernel: float64 at B around 4,096 (one B that 128 does
    # not divide), then float32 at the widths of its two main paths
    check_substep(rec, "f64 planning grounded", "planning", "grounded",
                  4096, 1, (4, 8), f64, F64_TOL, seed=11, single_step=True)
    check_substep(rec, "f64 planning airborne", "planning", "airborne",
                  4000, 3, (4, 8), f64, F64_TOL, seed=12)
    check_substep(rec, "f64 planning DomainParams", "planning", "grounded",
                  4096, 3, (4, 8), f64, F64_TOL, dp_ranges=dp, seed=13)
    check_substep(rec, "f64 fast_plant grounded", "fast_plant", "grounded",
                  4096, 5, (4, 8), f64, F64_TOL, seed=14)
    check_substep(rec, "f64 full low", "full", "low", 2048, 5, (4, 8), f64,
                  F64_TOL, seed=25)
    check_substep(rec, "f64 full belly DomainParams", "full", "belly", 1000,
                  3, (4, 8), f64, F64_TOL, dp_ranges=dp, seed=26)
    check_substep(rec, "f64 planning no sensors", "planning", "grounded",
                  1000, 1, (4, 8), f64, F64_TOL, seed=15, single_step=True,
                  sensors=False)
    rec["substep_max_abs_err_main_shape"] = max(
        check_substep(rec, "f32 planning grounded (planning width)",
                      "planning", "grounded", S_MAIN, FRAME_SKIP,
                      BUDGET["planning"], f32, F32_TOL, seed=16),
        check_substep(rec, "f32 fast_plant grounded (planning width)",
                      "fast_plant", "grounded", S_MAIN, FRAME_SKIP,
                      BUDGET["fast_plant"], f32, F32_TOL, seed=17),
        check_substep(rec, "f32 fast_plant grounded (env width)",
                      "fast_plant", "grounded", N_ENVS, ENV_FRAME_SKIP,
                      BUDGET["fast_plant"], f32, F32_TOL, seed=18),
        check_substep(rec, "f32 full grounded (env width)", "full",
                      "grounded", N_ENVS, ENV_FRAME_SKIP,
                      BUDGET["fast_plant"], f32, F32_TOL, seed=28),
    )
    # float32 on ``full`` with the base pressed to 3 cm, the hip servos in
    # contact in ~30 % of the lanes: B1 agrees everywhere; B2 at the env's
    # width parts in a few lanes, as the plain version in float32 parts
    # from itself in float64 (``F32_FULL_LOW_LANES_OFF``)
    check_case(rec, "f32 full low", "full", "low", 4096, 1, FRAME_SKIP,
               BUDGET["fast_plant"], f32, F32_TOL, seed=29)
    check_substep(rec, "f32 full low (env width)", "full", "low", N_ENVS,
                  ENV_FRAME_SKIP, BUDGET["fast_plant"], f32, F32_TOL,
                  seed=29, lanes_off=F32_FULL_LOW_LANES_OFF)
    check_split(rec)
    check_decimations(rec)
    check_refused_launch(rec)
    check_oracle(rec)
    check_gradient(rec)
    check_lane(rec)
    check_observation(rec)


def check_split(rec, seed=30, iters=5):
    """The kernels at every split (1, 2, 4 replicas a leg) through the
    wrappers' geometry arguments, on the same inputs: B2 at the env's
    width (the fast plant grounded, ``full`` with the base pressed to 3
    cm, frame_skip 4), B1 at the replan's S=4,096 (planning) and at 2,048
    (``full`` pressed), H=1, and B1 at the closed loop's shape (the
    ``loop`` phase's planner: planning 4/8, S=1,024, H=20) from a state
    settled on its feet, float32. Replicas split only the hull-vertex
    scans and keep the serial scan's winners, so the outputs must agree
    in every bit; ``geometry[...]["split"]`` says which split ran. Each
    split is timed (CUDA events, median of ``iters`` launches), and the
    split the wrapper takes is printed."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import State

    dev, dt = torch.device("cuda"), torch.float32
    rec["split_checks"] = {}

    def same(label, kernel, m, n, run):
        """run: geometry -> tuple of outputs"""
        nslot = cuda_engine.model_slots(m)
        chosen = cuda_engine.launch_geometry(
            nslot, dt, n, cuda_engine.scheduler_warps(kernel, m)).split
        outs, ms = {}, {}
        for split in sorted(cuda_engine.SPLITS):
            geo = cuda_engine._blocks(cuda_engine.ROW_VALS * nslot * 4, n,
                                      split)
            outs[split] = run(geo)
            torch.cuda.synchronize()
            if cuda_engine.geometry[kernel]["split"] != split:
                raise AssertionError(f"{label}: geometry[{kernel!r}] says "
                                     "another split than the launch's")
            ms[split] = float(np.median(event_ms(lambda: run(geo), iters)))
        differ = {k: sum(int((a != b).sum()) for a, b in zip(v, outs[1]))
                  for k, v in outs.items() if k != 1}
        log(f"check split {label}: n={n}, values differing in any bit from "
            f"split 1: {differ}; ms a launch by split (CUDA events, median "
            f"of {iters}): " + ", ".join(f"{k}: {v:.3f}" for k, v in
                                         ms.items())
            + f"; launch_geometry takes split {chosen}; card: {rec['card']}")
        if any(differ.values()):
            raise AssertionError(f"{label}: the splits disagree: {differ}")
        rec["split_checks"][label] = {"n": n, "split": chosen, "ms": ms}

    for label, model, kind in (("B2 fast_plant env", "fast_plant",
                                "grounded"),
                               ("B2 full env pressed", "full", "low")):
        m = getattr(spec, f"get_{model}_model")()
        ls, ctrl = lane_inputs(m, kind, N_ENVS, np.random.default_rng(seed),
                               dt, dev)
        same(label, SUBSTEP, m, N_ENVS,
             lambda geo: tuple(cuda_engine._launch_substeps(
                 m, ls, ctrl, ENV_FRAME_SKIP, *BUDGET["fast_plant"], None,
                 True, geometry=geo)))
    for label, model, kind, S, budget in (
            ("B1 planning replan", "planning", "grounded", REPLAN_S,
             BUDGET["planning"]),
            ("B1 full pressed", "full", "low", N_ENVS,
             BUDGET["fast_plant"])):
        m = getattr(spec, f"get_{model}_model")()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        state = start_state(m, kind, np.random.default_rng(seed), dt, dev)
        seqs = random_seqs(gen, S, 1, dt, dev, 0.3)
        cmd, prev = command(dt, dev, 0.2, 0.1, 0.3), prev_ctrl(dt, dev)
        same(label, ROLLOUT, m, S,
             lambda geo: (cuda_engine.fused_rollout_cost(
                 m, state, seqs, cmd, prev, FRAME_SKIP, *budget,
                 _geometry=geo),))

    # the closed loop's planner from a state settled on its feet: 300
    # control steps of 10 substeps (6 s) under the hold control
    walk = _example("torch_closed_loop_walk").mpc_config().mppi
    S, H, fs = walk.num_samples, walk.rollout.horizon, walk.rollout.frame_skip
    it, lsi = walk.lane_newton_iterations, walk.lane_ls_iterations
    m = spec.get_planning_model()
    ls, _ = lane_inputs(m, "grounded", 32, np.random.default_rng(seed), dt,
                        dev)
    hold = prev_ctrl(dt, dev)[:, None].expand(12, 32).contiguous()
    for _ in range(300):
        ls = cuda_engine.control_step(m, ls, hold, 10, it, lsi)
    state = State(*(x[..., 0].contiguous() for x in ls))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    seqs = random_seqs(gen, S, H, dt, dev, 0.2)
    cmd, prev = command(dt, dev, 0.2), prev_ctrl(dt, dev)
    same(f"B1 loop shape settled ({it}/{lsi}, H={H})", ROLLOUT, m, S,
         lambda geo: (cuda_engine.fused_rollout_cost(
             m, state, seqs, cmd, prev, fs, it, lsi, _geometry=geo),))


def check_decimations(rec, S=1024, B=2048):
    """The kernels on hulls that the getters' keywords decimate otherwise
    than the defaults: the fast plant with every hull at 128 support
    directions (``n_secondary=None``: the ankle servos' hulls grow from
    47 to 79 vertices) through B1 and B2, and the planning model at 64
    directions through B1, float32, each with its contact slots, launch
    geometry and the runtime's resident blocks."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    f32 = torch.float32
    every = spec.get_fast_plant_model(n_secondary=None)
    coarse = spec.get_planning_model(n_directions=64)
    rec["decimations"] = {}
    for label, m, source, n in (
            ("B1 fast_plant n_secondary=None", every,
             cuda_engine.KERNEL_SOURCE, S),
            ("B2 fast_plant n_secondary=None", every,
             cuda_engine.SUBSTEP_SOURCE, B),
            ("B1 planning n_directions=64", coarse,
             cuda_engine.KERNEL_SOURCE, S)):
        nslot = cuda_engine.model_slots(m)
        geo = geometry_of(source, m, f32, n)
        info = cuda_engine.kernel_info(source, f32, geo.threads,
                                       geo.smem_bytes, geo.split)
        row = {"n": n, "hull_verts": [len(v) for v in m.col_hull_verts],
               "slot_budgets": list(cuda_engine.slot_budgets(m)),
               "grid": geo.grid, "threads": geo.threads,
               "smem_bytes": geo.smem_bytes,
               "blocks_per_sm": info["blocks_per_sm"]}
        rec["decimations"][label] = row
        log(f"decimation {label}: n={n}, hull vertices "
            f"{row['hull_verts']}, slot budgets {row['slot_budgets']} "
            f"({nslot} slots a leg), float32: grid {geo.grid} x "
            f"{geo.threads} threads, {geo.smem_bytes} B dynamic shared a "
            f"block, {info['blocks_per_sm']} blocks per SM")
    check_case(rec, "f32 fast_plant n_secondary=None grounded (decimation)",
               every, "grounded", S, 1, FRAME_SKIP, BUDGET["fast_plant"],
               f32, F32_TOL, seed=23)
    check_substep(rec, "f32 fast_plant n_secondary=None grounded "
                  "(decimation)", every, "grounded", B, FRAME_SKIP,
                  BUDGET["fast_plant"], f32, F32_TOL, seed=24)
    check_case(rec, "f32 planning n_directions=64 grounded (decimation)",
               coarse, "grounded", S, 1, FRAME_SKIP, BUDGET["planning"],
               f32, F32_TOL, seed=25)


def oracle_states(m, dtype, device, **kw):
    """Two start states of the oracle engine and a control, made on the
    CPU in float64 from a seed: the robot on its feet and moving (the
    reset state hangs 10 cm above the floor, so it is dropped for 0.4 s
    first, under the engine options ``kw``), and in the air, tilted, 6 m
    up and 50 m from the world origin."""
    from quadruped_gym_tpu_torch.physics import engine

    rng = np.random.default_rng(20)
    f64 = torch.float64
    centers = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=f64)
    st = engine.make_state(m, dtype=f64, device="cpu")
    st = engine.control_step(m, st, centers, 200, **kw)
    contact = st._replace(
        qvel=st.qvel + 0.2 * torch.as_tensor(rng.standard_normal(m.nv)))
    qpos = st.qpos.clone()
    qpos[:3] = torch.tensor([40.0, -30.0, 6.0], dtype=f64)
    quat = rng.standard_normal(4)
    qpos[3:7] = torch.as_tensor(quat / np.linalg.norm(quat))
    qpos[7:] += 0.2 * torch.as_tensor(rng.standard_normal(m.nq - 7))
    airborne = st._replace(
        qpos=qpos, qvel=torch.as_tensor(0.5 * rng.standard_normal(m.nv)))
    ctrl = torch.as_tensor(rng.uniform(-1.0, 1.0, m.nu))

    def to(x):
        return type(x)(*(v.to(device=device, dtype=dtype) for v in x))

    return {"contact": to(contact), "airborne": to(airborne)}, ctrl.to(
        device=device, dtype=dtype)


def check_oracle(rec):
    """The oracle engine is plain PyTorch: the card must compute what the
    CPU computes (float64), stay accurate in float32 far from the world
    origin, and never drop to TF32. Float64 on both of its paths' models
    and options: the closed loop's and the trainer's plant (``mpc_plant``,
    12 contacts, 4 Newton passes) and the gym env's (``full``: 25 geoms,
    24 contacts, the model's Newton budget)."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.physics import engine, maths

    dev = torch.device("cuda")
    f64, f32 = torch.float64, torch.float32
    errs, cases = {}, {}
    for name, kw in ORACLE_CASES.items():
        m = spec.get_snapshot(name)
        on_cpu, ctrl_cpu = cases[name] = oracle_states(m, f64, "cpu", **kw)
        for kind, st in on_cpu.items():
            want = engine.step(m, st, ctrl_cpu, **kw)
            ncon = int(engine.forward(m, st, ctrl_cpu, **kw).ncon_active)
            if (ncon > 0) != (kind == "contact"):
                raise AssertionError(f"oracle {name} {kind}: {ncon} active "
                                     "rows")
            got = engine.step(m, type(st)(*(v.to(dev) for v in st)),
                              ctrl_cpu.to(dev), **kw)
            for f in got._fields:
                g, w = getattr(got, f).cpu(), getattr(want, f)
                if g.dtype != f64 or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"oracle {name} {kind}: {f} not "
                                         "finite float64")
                err = (g - w).abs()
                if bool((err > ORACLE_F64_TOL
                         + ORACLE_F64_TOL * w.abs()).any()):
                    raise AssertionError(
                        f"oracle {name} {kind}: {f} on the card differs from "
                        f"the CPU by {float(err.max()):.3e}")
                errs[f"{name} {kind} {f}"] = float(err.max())
            log(f"check oracle engine.step f64 {name} {kw} {kind} ({ncon} "
                "active rows): card vs CPU max_abs_err "
                + " ".join(f"{f} {errs[f'{name} {kind} {f}']:.2e}"
                           for f in got._fields)
                + f" (rtol=atol={ORACLE_F64_TOL:g})")
    # float32 and TF32 on the plant of the closed loop and the trainer
    m, kw = spec.get_mpc_plant_model(), ORACLE_CASES["mpc_plant"]
    on_cpu, ctrl_cpu = cases["mpc_plant"]

    # float32, 6 m up and 50 m out, against float64 on the card: spatial
    # vectors are measured from the base, so float32 rounding (6e-8 of
    # values near 1) is all there is; measured from the world origin the
    # mass matrix alone would be off by ~m|p|^2 * 6e-8 ~ 1e-4 of 2500.
    st64 = type(on_cpu["airborne"])(*(v.to(dev) for v in on_cpu["airborne"]))
    want = engine.step(m, st64, ctrl_cpu.to(dev), **kw)
    st32 = type(st64)(*(v.to(f32) for v in st64))
    ctrl32 = ctrl_cpu.to(device=dev, dtype=f32)
    got = engine.step(m, st32, ctrl32, **kw)
    acc = slice(m.sensor_adr("body_accel"), m.sensor_adr("body_accel") + 3)
    far = {"qvel": (got.qvel, want.qvel, 5e-4),
           "qpos": (got.qpos, want.qpos, 1e-5),
           "body_accel": (got.sensordata[acc], want.sensordata[acc], 5e-3)}
    for name, (g, w, tol) in far.items():
        if g.dtype != f32:
            raise AssertionError(f"oracle f32: {name} is {g.dtype}")
        err = float((g.double() - w).abs().max())
        errs[f"f32 far {name}"] = err
        if not err <= tol * (1.0 + float(w.abs().max())):
            raise AssertionError(f"oracle f32 far from the origin: {name} "
                                 f"off by {err:.3e} (tolerance {tol:g})")
    log("check oracle engine.step f32 at (40, -30, 6) m vs f64: max_abs_err "
        + " ".join(f"{k} {errs[f'f32 far {k}']:.2e} (tol {far[k][2]:g} "
                   "relative to 1 + max|x|)" for k in far))

    # true FP32 whatever the process-wide flag says: with the flag ON a
    # bare matmul is TF32 (logged, to show the flag bites on this card),
    # inside the engine's context it is FP32, and a whole step is the
    # same in every bit with the flag on and off
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    a = torch.randn((512, 512), generator=gen, device=dev, dtype=f32)
    b = torch.randn((512, 512), generator=gen, device=dev, dtype=f32)
    ref = a.double() @ b.double()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        bare = float(((a @ b).double() - ref).abs().max() / ref.abs().max())
        with maths.true_fp32():
            kept = float(((a @ b).double() - ref).abs().max()
                         / ref.abs().max())
        flagged = engine.step(m, st32, ctrl32, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    same = all(bool(torch.equal(x, y)) for x, y in zip(flagged, got))
    log(f"check oracle true FP32: with allow_tf32=True a bare 512x512 "
        f"matmul is off by {bare:.2e} of max|ref|, inside maths.true_fp32() "
        f"by {kept:.2e}; engine.step with the flag on equals the flag off "
        f"in every bit: {same}")
    if not kept < 1e-6:
        raise AssertionError(f"float32 matmul inside true_fp32() is off by "
                             f"{kept:.2e}: not FP32")
    if not same:
        raise AssertionError("engine.step changes with allow_tf32: its "
                             "float32 products are not pinned to FP32")
    rec["oracle_check"] = dict(errs, tf32_bare_rel_err=bare,
                               fp32_kept_rel_err=kept)


def check_gradient(rec):
    """The gradient solvers are plain PyTorch through ``torch.func``: on
    the card in float64 they must compute what the CPU computes. Both
    linearizations of H=2 steps from a planning-model state in contact,
    and one SQP iteration at H=4 from it."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.physics import engine
    from quadruped_gym_tpu_torch.solvers import ilqr, rollout, sqp

    f64 = torch.float64
    m = spec.get_planning_model()
    kw = dict(max_contacts=8, solver_iterations=4)
    sts, _ = oracle_states(m, f64, "cpu", **kw)
    st_cpu = sts["contact"]
    rng = np.random.default_rng(22)
    hold = prev_ctrl(f64, "cpu")
    errs = {}

    def on(x, dev):
        if isinstance(x, tuple):
            return type(x)(*(on(v, dev) for v in x))
        return x.to(dev)

    def step_fn(st, u):
        return engine.control_step(m, st, u, 2, **kw)

    us = torch.clamp(hold + 0.2 * torch.as_tensor(
        rng.standard_normal((2, m.nu))), -1.0, 1.0)
    traj = [step_fn(st_cpu, us[0])]
    traj.append(step_fn(traj[0], us[1]))
    states = type(st_cpu)(*(torch.stack(x) for x in zip(*traj)))
    ncon = int(engine.forward(m, st_cpu, hold, **kw).ncon_active)
    for name, lin in (("ad", lambda *a: ilqr.ad_linearize(m, step_fn, *a)),
                      ("fd", lambda *a: ilqr.fd_linearize(m, step_fn, *a,
                                                          1e-5))):
        want = lin(st_cpu, states, us)
        got = lin(on(st_cpu, "cuda"), on(states, "cuda"), on(us, "cuda"))
        for label, g, w in zip("AB", got, want):
            err = float((g.cpu() - w).abs().max())
            errs[f"{name}_linearize_{label}"] = err
            if not err <= GRAD_LIN_TOL * (1.0 + float(w.abs().max())):
                raise AssertionError(f"{name}_linearize {label}: the card "
                                     f"differs from the CPU by {err:.3e}")
    log(f"check gradient linearizers f64 planning H=2 frame_skip 2 "
        f"({ncon} active rows at the start): card vs CPU max_abs_err "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {GRAD_LIN_TOL:g} relative to 1 + max|A|)")

    cfg = sqp.SQPConfig(iterations=1, rollout=rollout.RolloutConfig(
        horizon=4, frame_skip=2, **kw))
    cost_fn = rollout.make_cost_fn(m, vel_smooth_eps=0.02)
    us0 = torch.clamp(hold + 0.2 * torch.as_tensor(
        rng.standard_normal((4, m.nu))), -1.0, 1.0)
    want = sqp.solve(m, cfg, cost_fn, st_cpu, us0, command(f64, "cpu"),
                     hold)
    got = sqp.solve(m, cfg, cost_fn, on(st_cpu, "cuda"), on(us0, "cuda"),
                    command(f64, "cuda"), on(hold, "cuda"))
    for f in ("ctrl_seq", "cost", "initial_cost", "cost_history"):
        g, w = getattr(got, f).cpu(), getattr(want, f)
        err = float((g - w).abs().max())
        errs[f"sqp_{f}"] = err
        if not err <= GRAD_SQP_TOL * (1.0 + float(w.abs().max())):
            raise AssertionError(f"sqp.solve {f}: the card differs from the "
                                 f"CPU by {err:.3e}")
    if not float(want.cost) < float(want.initial_cost):
        raise AssertionError("sqp.solve did not descend on the CPU")
    log(f"check gradient sqp.solve f64 planning H=4, 1 iteration: cost "
        f"{float(want.initial_cost):.6f} -> {float(got.cost):.6f}; card vs "
        f"CPU max_abs_err ctrl_seq {errs['sqp_ctrl_seq']:.2e} cost "
        f"{errs['sqp_cost']:.2e} (tol {GRAD_SQP_TOL:g} relative to 1 + "
        "max|x|)")
    rec["gradient_check"] = errs


def check_lane(rec):
    """The lane engine is plain PyTorch: on the card in float64 it must
    compute what the CPU computes, on the leg engine's model and on
    ``full``, in contact (active slots) and in the air (none); and on the
    card it must agree with the leg engine, the same math, through the
    rollout dispatch."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine, lane_engine
    from quadruped_gym_tpu_torch.physics.engine import State
    from quadruped_gym_tpu_torch.solvers import rollout

    dev, f64 = torch.device("cuda"), torch.float64
    errs = rec.setdefault("lane_check", {})
    for seed, (name, kind) in enumerate(
            (n, k) for n in ("mpc_plant", "full")
            for k in ("contact", "airborne")):
        m = spec.get_snapshot(name)
        ls, ctrl = lane_inputs(m, kind, LANE_CHECK_B,
                               np.random.default_rng(30 + seed), f64, "cpu")
        slots = lane_engine._collide(m, lane_engine._fk(m, ls.qpos))
        n_active = int(slots.active.sum())
        if (n_active > 0) != (kind == "contact"):
            raise AssertionError(f"lane {name} {kind}: {n_active} active "
                                 "slots")
        want = lane_engine.step(m, ls, ctrl, *LANE_ENV_BUDGET)
        got = lane_engine.step(m, type(ls)(*(x.to(dev) for x in ls)),
                               ctrl.to(dev), *LANE_ENV_BUDGET)
        for f in got._fields:
            g, w = getattr(got, f).cpu(), getattr(want, f)
            if g.dtype != f64 or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"lane {name} {kind}: {f} not finite "
                                     "float64")
            err = (g - w).abs()
            if bool((err > LANE_F64_TOL + LANE_F64_TOL * w.abs()).any()):
                raise AssertionError(
                    f"lane {name} {kind}: {f} on the card differs from the "
                    f"CPU by {float(err.max()):.3e}")
            errs[f"{name} {kind} {f}"] = float(err.max())
        log(f"check lane_engine.step f64 {name} {kind} at "
            f"{LANE_ENV_BUDGET[0]}/{LANE_ENV_BUDGET[1]}, B={LANE_CHECK_B} "
            f"({n_active} active slots): card vs CPU max_abs_err "
            + " ".join(f"{f} {errs[f'{name} {kind} {f}']:.2e}"
                       for f in got._fields)
            + f" (rtol=atol={LANE_F64_TOL:g})")

    # lane against leg on the card, through the dispatch
    m = spec.get_mpc_plant_model()
    ls, _ = lane_inputs(m, "contact", 1, np.random.default_rng(40), f64, dev)
    state = State(*(x[..., 0] for x in ls))
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    seqs = random_seqs(gen, 1024, 2, f64, dev, 0.3)
    cmd, prev = command(f64, dev, 0.2, 0.1, 0.3), prev_ctrl(f64, dev)
    cfg = rollout.RolloutConfig(horizon=2, frame_skip=FRAME_SKIP)
    before = dict(cuda_engine.launch_counts)
    costs = {impl: rollout.lane_batched_rollout_cost(
        m, cfg, rollout.make_cost_fn(m), state, seqs, cmd, prev,
        *LANE_ENV_BUDGET, engine_impl=impl) for impl in ("lane", "leg")}
    if cuda_engine.launch_counts != before:
        raise AssertionError("the lane and leg engines launched a kernel")
    err = (costs["lane"] - costs["leg"]).abs()
    rel = float((err / costs["leg"].abs().clamp_min(1e-30)).max())
    errs["lane vs leg costs"] = float(err.max())
    log(f"check lane vs leg engine f64 on the card, mpc_plant in contact, "
        f"lane_batched_rollout_cost S=1024 H=2 frame_skip {FRAME_SKIP} "
        f"{LANE_ENV_BUDGET[0]}/{LANE_ENV_BUDGET[1]}: max_abs_err "
        f"{float(err.max()):.3e} max_rel_err {rel:.3e} (rtol=atol="
        f"{LANE_LEG_TOL:g})")
    if bool((err > LANE_LEG_TOL + LANE_LEG_TOL * costs["leg"].abs()).any()):
        raise AssertionError("lane and leg engines disagree on the card")


def check_refused_launch(rec):
    """A launch the card refuses must raise in Python, and the next good
    launch must work: ask for more dynamic shared memory than a block may
    have, through the wrapper's private launch function."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    ls, ctrl = lane_inputs(m, "grounded", 256, np.random.default_rng(19), dt,
                           dev)
    too_much = cuda_engine.LaunchGeometry(8, 128, 300 * 1024)
    before = dict(cuda_engine.launch_counts)
    try:
        cuda_engine._launch_substeps(m, ls, ctrl, 1, 2, 4, None, True,
                                     geometry=too_much)
    except RuntimeError as e:
        log(f"check refused launch: raised as it must: {e}")
    else:
        raise AssertionError("a launch with 300 KB of dynamic shared memory "
                             "did not raise")
    if cuda_engine.launch_counts != before:
        raise AssertionError("a refused launch was counted")
    out = cuda_engine.step(m, ls, ctrl, 2, 4)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.qpos).all()):
        raise AssertionError("the launch after a refused one failed")
    rec["refused_launch_raises"] = True


def mpc_config(model: str):
    from quadruped_gym_tpu_torch.runtime.mpc_runtime import MPCConfig
    from quadruped_gym_tpu_torch.solvers.mppi import MPPIConfig
    from quadruped_gym_tpu_torch.solvers.rollout import RolloutConfig

    it, lsi = BUDGET[model]
    return MPCConfig(solver="mppi", mppi=MPPIConfig(
        num_samples=S_MAIN,
        rollout=RolloutConfig(horizon=H_MAIN, frame_skip=FRAME_SKIP),
        lane=True, lane_engine_impl="fused",
        lane_newton_iterations=it, lane_ls_iterations=lsi))


def phase_main(rec, periods=3):
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.runtime import mpc_runtime
    from quadruped_gym_tpu_torch.solvers.rollout import make_cost_fn

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    cfg = mpc_config("planning")
    cost_fn = make_cost_fn(m)
    carry = mpc_runtime.init_carry(m, cfg, H_MAIN, seed=0, dtype=dt,
                                   device=dev)
    phys = make_state(m, dtype=dt, device=dev)
    cmd = command(dt, dev)
    lo = torch.as_tensor(m.actuator_ctrlrange[:, 0], dtype=dt, device=dev)
    hi = torch.as_tensor(m.actuator_ctrlrange[:, 1], dtype=dt, device=dev)

    plan_s, step_s = [], []
    cuda_engine.reset_launch_counts()
    t0 = time.perf_counter()
    for p in range(periods):
        t1 = time.perf_counter()
        ctrl, carry, info = mpc_runtime.plan_and_act(m, cfg, cost_fn, carry,
                                                     phys, cmd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phys = mpc_runtime.lane_control_step(m, phys, ctrl,
                                             cfg.plant_frame_skip)
        torch.cuda.synchronize()
        plan_s.append(t2 - t1)
        step_s.append(time.perf_counter() - t2)
        vals = [info["best_cost"], info["mean_cost"], carry.mean, ctrl,
                phys.qpos, phys.qvel, phys.act, phys.sensordata]
        if not all(bool(torch.isfinite(v).all()) for v in vals):
            raise AssertionError(f"period {p}: non-finite cost/plan/state")
        if not bool(((ctrl >= lo) & (ctrl <= hi)).all()):
            raise AssertionError(f"period {p}: ctrl outside ctrlrange")
        log(f"main period {p}: best_cost {float(info['best_cost']):.4f} "
            f"mean_cost {float(info['mean_cost']):.4f} "
            f"base z {float(phys.qpos[2]):.4f}; plan_and_act "
            f"{plan_s[-1]:.4f} s, lane_control_step {step_s[-1]:.4f} s "
            f"(host clock, synchronised)")
    planning_launches = cuda_engine.launch_counts[ROLLOUT]
    substep_launches = cuda_engine.launch_counts[SUBSTEP]
    rec["main_s"] = time.perf_counter() - t0
    rec["plan_s"], rec["lane_control_step_s"] = plan_s, step_s
    if planning_launches != periods:
        raise AssertionError(f"fused kernel launched {planning_launches} "
                             f"times in {periods} periods")

    fp = spec.get_fast_plant_model()
    fcfg = mpc_config("fast_plant")
    fcarry = mpc_runtime.init_carry(fp, fcfg, H_MAIN, seed=1, dtype=dt,
                                    device=dev)
    fphys = make_state(fp, dtype=dt, device=dev)
    cuda_engine.reset_launch_counts()
    ctrl, fcarry, info = mpc_runtime.plan_and_act(
        fp, fcfg, make_cost_fn(fp), fcarry, fphys, cmd)
    torch.cuda.synchronize()
    fast_launches = cuda_engine.launch_counts[ROLLOUT]
    substep_launches += cuda_engine.launch_counts[SUBSTEP]
    if substep_launches != 0:
        raise AssertionError(f"the fused path launched the substep kernel "
                             f"{substep_launches} times")
    if fast_launches != 1:
        raise AssertionError(f"fast-plant solve launched the kernel "
                             f"{fast_launches} times")
    if not (bool(torch.isfinite(info["best_cost"]))
            and bool(torch.isfinite(fcarry.mean).all())):
        raise AssertionError("fast-plant solve: non-finite cost or plan")
    log(f"main fast_plant solve: best_cost {float(info['best_cost']):.4f}")
    counts = rec.setdefault("launches", {})
    counts[ROLLOUT] = (counts.get(ROLLOUT, 0) + planning_launches
                       + fast_launches)
    log(f"main: fused_rollout_cost launches {planning_launches} "
        f"(planning, {periods} periods) + {fast_launches} (fast plant); "
        f"{rec['main_s']:.2f} s for the planning periods "
        f"({sum(plan_s):.2f} s in plan_and_act, {sum(step_s):.2f} s in "
        f"lane_control_step)")


def planning_config(solver: str):
    """The custom-cost planner: per-control-step scoring through the
    substep kernel at the main path's width and budget."""
    from quadruped_gym_tpu_torch.runtime.mpc_runtime import MPCConfig
    from quadruped_gym_tpu_torch.solvers.cem import CEMConfig
    from quadruped_gym_tpu_torch.solvers.mppi import MPPIConfig
    from quadruped_gym_tpu_torch.solvers.rollout import RolloutConfig

    it, lsi = BUDGET["planning"]
    common = dict(num_samples=S_MAIN, lane=True, lane_engine_impl="pallas",
                  rollout=RolloutConfig(horizon=H_MAIN,
                                        frame_skip=FRAME_SKIP),
                  lane_newton_iterations=it, lane_ls_iterations=lsi)
    return MPCConfig(solver=solver, mppi=MPPIConfig(**common),
                     cem=CEMConfig(num_elites=64, iterations=3, **common))


def phase_plan(rec, periods=3):
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.runtime import mpc_runtime
    from quadruped_gym_tpu_torch.solvers.rollout import make_cost_fn

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    cost_fn = make_cost_fn(m, vel_smooth_eps=0.02)
    if cost_fn._is_walking_stage_cost:
        raise AssertionError("the smoothed cost must not pass for the "
                             "fused kernel's")
    cmd = command(dt, dev)
    lo = torch.as_tensor(m.actuator_ctrlrange[:, 0], dtype=dt, device=dev)
    hi = torch.as_tensor(m.actuator_ctrlrange[:, 1], dtype=dt, device=dev)

    def checked(tag, ctrl, carry, info, phys):
        vals = [info["best_cost"], info["mean_cost"], carry.mean, carry.sigma,
                ctrl, phys.qpos, phys.qvel, phys.act, phys.sensordata]
        if not all(bool(torch.isfinite(v).all()) for v in vals):
            raise AssertionError(f"{tag}: non-finite cost/plan/state")
        if not bool(((ctrl >= lo) & (ctrl <= hi)).all()):
            raise AssertionError(f"{tag}: ctrl outside ctrlrange")

    cfg = planning_config("mppi")
    carry = mpc_runtime.init_carry(m, cfg, H_MAIN, seed=2, dtype=dt,
                                   device=dev)
    phys = make_state(m, dtype=dt, device=dev)
    plan_s, step_s = [], []
    cuda_engine.reset_launch_counts()
    for p in range(periods):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ctrl, carry, info = mpc_runtime.plan_and_act(m, cfg, cost_fn, carry,
                                                     phys, cmd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phys = mpc_runtime.lane_control_step(m, phys, ctrl,
                                             cfg.plant_frame_skip)
        torch.cuda.synchronize()
        plan_s.append(t2 - t1)
        step_s.append(time.perf_counter() - t2)
        checked(f"plan period {p}", ctrl, carry, info, phys)
        log(f"plan period {p} (MPPI, custom cost): best_cost "
            f"{float(info['best_cost']):.4f} mean_cost "
            f"{float(info['mean_cost']):.4f} base z {float(phys.qpos[2]):.4f};"
            f" plan_and_act {plan_s[-1]:.4f} s, lane_control_step "
            f"{step_s[-1]:.4f} s (host clock, synchronised)")
    mppi_launches = cuda_engine.launch_counts[SUBSTEP]
    fused = cuda_engine.launch_counts[ROLLOUT]
    if mppi_launches != periods * H_MAIN or fused != 0:
        raise AssertionError(
            f"custom-cost MPPI: {mppi_launches} substep launches in "
            f"{periods} periods of H={H_MAIN} (want {periods * H_MAIN}), "
            f"{fused} fused launches (want 0)")

    ccfg = planning_config("cem")
    ccarry = mpc_runtime.init_carry(m, ccfg, H_MAIN, seed=3, dtype=dt,
                                    device=dev)
    cuda_engine.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctrl, ccarry2, info = mpc_runtime.plan_and_act(m, ccfg, cost_fn, ccarry,
                                                   phys, cmd)
    torch.cuda.synchronize()
    cem_s = time.perf_counter() - t1
    cem_launches = cuda_engine.launch_counts[SUBSTEP]
    fused = cuda_engine.launch_counts[ROLLOUT]
    checked("CEM solve", ctrl, ccarry2, info, phys)
    want = ccfg.cem.iterations * H_MAIN
    if cem_launches != want or fused != 0:
        raise AssertionError(f"CEM: {cem_launches} substep launches (want "
                             f"{want}), {fused} fused launches (want 0)")
    if not float(ccarry2.sigma.mean()) < float(ccarry.sigma.mean()):
        raise AssertionError("CEM did not narrow its distribution")
    log(f"plan CEM solve ({ccfg.cem.num_samples} samples, "
        f"{ccfg.cem.num_elites} elites, {ccfg.cem.iterations} iterations): "
        f"best_cost {float(info['best_cost']):.4f} mean_cost "
        f"{float(info['mean_cost']):.4f} mean sigma "
        f"{float(ccarry2.sigma.mean()):.4f}; {cem_s:.4f} s")
    rec["custom_plan_s"], rec["custom_lane_control_step_s"] = plan_s, step_s
    rec["cem_solve_s"] = cem_s
    launches = rec.setdefault("launches", {})
    launches[SUBSTEP] = launches.get(SUBSTEP, 0) + mppi_launches + cem_launches
    log(f"plan: substep launches {mppi_launches} (MPPI, {periods} periods x "
        f"H={H_MAIN}) + {cem_launches} (CEM, {ccfg.cem.iterations} "
        f"iterations x H={H_MAIN}); fused_rollout_cost launches 0")


def phase_env(rec, steps=50, warm=10):
    from quadruped_gym_tpu_torch.envs import vector_env
    from quadruped_gym_tpu_torch.envs.vector_env import VectorWalkingEnv
    from quadruped_gym_tpu_torch.envs.vector_env import batched_autoreset_step
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics import smooth
    from quadruped_gym_tpu_torch.tasks import walking

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_fast_plant_model()
    # max_time is cut from 10 s so that every episode ends inside the run
    # and the auto-reset branch is taken on the card too
    cfg = walking.WalkingConfig(max_time=0.3, frame_skip=ENV_FRAME_SKIP,
                                partial_obs=True, obs_window=10,
                                random_controls=True, random_init=True,
                                dtype=dt)
    env = VectorWalkingEnv(m, cfg, N_ENVS, lane_physics=True, seed=4)
    state, obs = env.reset()
    if obs.device.type != dev.type or obs.shape != (N_ENVS, 260):
        raise AssertionError(f"reset obs {tuple(obs.shape)} on {obs.device}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    n_done = torch.zeros((), dtype=torch.int64, device=dev)
    cuda_engine.reset_launch_counts()
    vector_env.reset_graph_counts()
    t0 = None
    for k in range(steps):
        if k == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        action = smooth.clip_ctrl(m, 0.5 * torch.randn(
            (N_ENVS, m.nu), generator=gen, dtype=dt, device=dev))
        out = batched_autoreset_step(m, cfg, state, action, env.generator,
                                     engine_impl="pallas")
        want_time = state.phys.time
        for _ in range(cfg.frame_skip):
            want_time = want_time + m.timestep
        late = (~out.done) & (out.state.phys.time != want_time)
        fresh = out.done & (out.state.phys.time != 0.0)
        for x in (out.obs, out.reward, out.reward_components,
                  out.state.phys.qpos, out.state.phys.qvel):
            bad = bad + (~torch.isfinite(x)).sum()
        bad = bad + late.sum() + fresh.sum()
        n_done = n_done + out.done.sum()
        state = out.state
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    # B2 runs once a step: launched by its wrapper on the eager and the
    # capturing call, inside the graph on every replay
    launches = cuda_engine.launch_counts[SUBSTEP]
    graphs = dict(vector_env.graph_counts)
    if (out.obs.shape != (N_ENVS, 260) or out.reward.shape != (N_ENVS,)
            or out.reward_components.shape != (N_ENVS, 11)
            or out.done.dtype != torch.bool or out.obs.dtype != dt):
        raise AssertionError("env step: wrong output shapes or types")
    if int(bad) != 0:
        raise AssertionError(f"env: {int(bad)} non-finite values or lanes "
                             "whose time did not advance by a control step")
    if int(n_done) == 0:
        raise AssertionError("env: no episode ended, auto-reset not driven")
    # the observation kernel twice a step (the step's frame, the
    # auto-reset's), the same way
    obs_launches = cuda_engine.launch_counts["po_window"]
    if (graphs != {"captures": 1, "replays": steps - 2, "eager": 1}
            or launches != 2 or obs_launches != 4
            or cuda_engine.launch_counts[ROLLOUT] != 0):
        raise AssertionError(f"env: {launches} substep and {obs_launches} "
                             f"observation launches and calls {graphs} in "
                             f"{steps} steps")
    rec["env_steps_per_s"] = N_ENVS * (steps - warm) / elapsed
    rec["env_step_ms"] = 1e3 * elapsed / (steps - warm)
    counts = rec.setdefault("launches", {})
    counts[SUBSTEP] = counts.get(SUBSTEP, 0) + launches + graphs["replays"]
    log(f"env: {N_ENVS} envs x {steps} batched_autoreset_step (fast plant, "
        f"frame_skip {cfg.frame_skip}, PO window {cfg.obs_window}, float32): "
        f"obs {tuple(out.obs.shape)}, mean reward "
        f"{float(out.reward.mean()):.3f}, {int(n_done)} resets, mean base z "
        f"{float(out.state.phys.qpos[:, 2].mean()):.4f}; substep launches "
        f"{launches}, observation launches {obs_launches}, graph {graphs}; "
        f"{rec['env_steps_per_s']:.1f} env-steps/s, "
        f"{rec['env_step_ms']:.3f} ms per step over the last "
        f"{steps - warm} steps (host clock, one synchronise at the end); "
        f"card: {rec['card']}")


def phase_lane(rec):
    import warnings

    from quadruped_gym_tpu_torch.envs.vector_env import (
        VectorWalkingEnv, batched_autoreset_step)
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine, lane_engine
    from quadruped_gym_tpu_torch.physics import smooth
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.solvers import rollout
    from quadruped_gym_tpu_torch.tasks import walking

    dev, dt = torch.device("cuda"), torch.float32
    out = rec["lane"] = {}

    def launches():
        return (cuda_engine.launch_counts[ROLLOUT],
                cuda_engine.launch_counts[SUBSTEP])

    # (a) the JAX package's unfused configuration, then B1 on its inputs
    m = spec.get_planning_model()
    it, lsi = LANE_BUDGET
    rng = np.random.default_rng(50)
    state = make_state(m, dtype=dt, device=dev)
    state = state._replace(qvel=torch.as_tensor(
        0.1 * rng.standard_normal(m.nv), dtype=dt, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(51)
    seqs = random_seqs(gen, LANE_S, LANE_H, dt, dev, 0.2)
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    cfg = rollout.RolloutConfig(horizon=LANE_H, frame_skip=FRAME_SKIP)
    cost_fn = rollout.make_cost_fn(m)

    def score(impl, s=seqs):
        return rollout.lane_batched_rollout_cost(
            m, cfg, cost_fn, state, s, cmd, prev, it, lsi, engine_impl=impl)

    cuda_engine.reset_launch_counts()
    score("lane", seqs[:, :1].contiguous())  # constants and allocator warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lane_costs = score("lane")
    torch.cuda.synchronize()
    lane_s = time.perf_counter() - t0
    if launches() != (0, 0):
        raise AssertionError(f"lane (a): {launches()} kernel launches from "
                             "the lane engine (want none)")
    cuda_engine.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_costs = score("fused")
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    if launches() != (1, 0):
        raise AssertionError(f"lane (a): B1/B2 launched {launches()} times "
                             "(want 1, 0)")
    counts = rec.setdefault("launches", {})
    counts[ROLLOUT] = counts.get(ROLLOUT, 0) + 1
    for tag, c in (("lane", lane_costs), ("fused", fused_costs)):
        if c.shape != (LANE_S,) or not bool(torch.isfinite(c).all()):
            raise AssertionError(f"lane (a): {tag} costs not finite (S,)")
    rel = ((lane_costs - fused_costs).abs()
           / fused_costs.abs().clamp_min(1e-30)).double()
    out["rollout"] = {
        "lane_s": lane_s, "lane_rollouts_per_s": LANE_S / lane_s,
        "fused_s": fused_s, "fused_rollouts_per_s": LANE_S / fused_s,
        "rel_diff_median": float(rel.median()),
        "rel_diff_max": float(rel.max())}
    log(f"lane (a) lane_batched_rollout_cost planning S={LANE_S} H={LANE_H} "
        f"frame_skip {FRAME_SKIP} {it}/{lsi} float32 (scripts/"
        f"latency_report.py's unfused configuration): engine_impl='lane' "
        f"{lane_s:.3f} s = {LANE_S / lane_s:.1f} rollouts/s (one warm "
        f"solve, host clock, synchronised); 'fused' (B1, 1 launch) "
        f"{fused_s:.4f} s = {LANE_S / fused_s:.1f} rollouts/s; costs' "
        f"relative difference median {float(rel.median()):.3e}, max "
        f"{float(rel.max()):.3e} (not gated); card: {rec['card']}")

    # (b) VectorWalkingEnv(full, lane_physics=True) at the trainer's width:
    # B2 and the step's CUDA graph, held to the lane engine
    from quadruped_gym_tpu_torch.envs import vector_env

    m = spec.get_full_model()
    ecfg = walking.WalkingConfig(
        frame_skip=LANE_ENV_FRAME_SKIP, partial_obs=True, obs_window=10,
        random_controls=True, random_init=True,
        solver_iterations=LANE_ENV_BUDGET[0], dtype=dt)
    env = VectorWalkingEnv(m, ecfg, N_ENVS, lane_physics=True, seed=52)
    agen = torch.Generator(device=dev)
    agen.manual_seed(53)
    cuda_engine.reset_launch_counts()
    vector_env.reset_graph_counts()
    st, obs = env.reset()
    times, bad = [], torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for k in range(LANE_ENV_STEPS):
            action = smooth.clip_ctrl(m, 0.5 * torch.randn(
                (N_ENVS, m.nu), generator=agen, dtype=dt, device=dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = batched_autoreset_step(m, ecfg, st, action,
                                             env.generator,
                                             engine_impl="pallas")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if any("falling back" in str(w.message) for w in caught):
                raise AssertionError("lane (b): engine_impl='pallas' on full "
                                     "fell back")
            for x in (res.obs, res.reward, res.state.phys.qpos):
                bad = bad + (~torch.isfinite(x)).sum()
            st_before, action_before, st = st, action, res.state
    graphs = dict(vector_env.graph_counts)
    want = {"captures": 1, "replays": LANE_ENV_STEPS - 2, "eager": 1}
    if graphs != want or launches() != (0, 2):
        raise AssertionError(f"lane (b): graph counts {graphs}, B1/B2 "
                             f"wrapper launches {launches()} (want {want}, "
                             "(0, 2))")
    if int(bad) or res.obs.shape != (N_ENVS, env.obs_size):
        raise AssertionError(f"lane (b): {int(bad)} non-finite values or "
                             f"obs {tuple(res.obs.shape)}")
    # B2 once a step, as in the env phase (the comparison below not counted)
    counts = rec.setdefault("launches", {})
    counts[SUBSTEP] = counts.get(SUBSTEP, 0) + launches()[1] + graphs["replays"]
    step_s = float(np.median(times[2:]))
    # B2 against the lane engine on the last step's inputs
    ls32 = lane_engine.from_batched(*st_before.phys)
    ctrl32 = smooth.clip_ctrl(m, action_before.to(dt)).T.contiguous()
    sub = lambda x: type(x)(*(y[..., :LANE_B2_B].double().contiguous()  # noqa: E731
                              for y in x))
    ls64 = sub(ls32)
    ctrl64 = ctrl32[:, :LANE_B2_B].double().contiguous()
    got = cuda_engine.step(m, ls64, ctrl64, *LANE_ENV_BUDGET)
    ref = lane_engine.step(m, ls64, ctrl64, *LANE_ENV_BUDGET)
    torch.cuda.synchronize()
    n_bad, errs = 0, {}
    for f in ("qpos", "qvel", "act", "sensordata"):
        g, r = getattr(got, f), getattr(ref, f)
        e = (g - r).abs()
        n_bad += int((e > LANE_B2_F64_TOL + LANE_B2_F64_TOL * r.abs()).sum())
        errs[f] = float(e.max())
    if n_bad:
        raise AssertionError(f"lane (b): B2 against the lane engine, float64: "
                             f"{n_bad} values outside {LANE_B2_F64_TOL:g} "
                             f"({errs})")
    g32 = cuda_engine.control_step(m, ls32, ctrl32.contiguous(),
                                   LANE_ENV_FRAME_SKIP, *LANE_ENV_BUDGET)
    r32 = lane_engine.control_step(m, ls32, ctrl32.contiguous(),
                                   LANE_ENV_FRAME_SKIP, *LANE_ENV_BUDGET)
    gap32 = float((g32.qpos - r32.qpos).abs().max())
    out["env"] = {"step_s": times, "median_step_s": step_s,
                  "env_steps_per_s": N_ENVS / step_s, "graph_counts": graphs,
                  "b2_vs_lane_f64": errs, "b2_vs_lane_f32_qpos": gap32}
    log(f"lane (b) VectorWalkingEnv(full, lane_physics=True) {N_ENVS} envs, "
        f"frame_skip {LANE_ENV_FRAME_SKIP}, {LANE_ENV_BUDGET[0]} Newton "
        f"passes, PO window 10, float32, engine_impl='pallas': B2 through "
        f"the step's CUDA graph ({graphs}); {step_s:.4f} s per env step "
        f"(median of the replays, host clock, synchronised; each "
        + ", ".join(f"{x:.4f}" for x in times) + f" s) = "
        f"{N_ENVS / step_s:.1f} env-steps/s; mean reward "
        f"{float(res.reward.mean()):.3f}, mean base z "
        f"{float(st.phys.qpos[:, 2].mean()):.4f}; B2 against the lane "
        f"engine on {LANE_B2_B} of the env's states, one substep float64: "
        "max_abs_err " + " ".join(f"{f} {e:.3e}" for f, e in errs.items())
        + f" (rtol=atol={LANE_B2_F64_TOL:g}); the env's control step "
        f"float32, qpos gap {gap32:.3e} (not gated); card: {rec['card']}")

    # (c) one lane substep on full at this width, traced
    ls = lane_engine.from_batched(*st.phys)
    ctrl = smooth.clip_ctrl(m, torch.zeros((N_ENVS, m.nu), dtype=dt,
                                            device=dev)).T.contiguous()
    sub = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lane_engine.step(m, ls, ctrl, *LANE_ENV_BUDGET)
        torch.cuda.synchronize()
        sub.append(time.perf_counter() - t0)
    sub_s = float(np.median(sub))
    t0 = time.perf_counter()
    dev_s, n_dev, _ = traced(lambda: lane_engine.step(
        m, ls, ctrl, *LANE_ENV_BUDGET))
    trace_s = time.perf_counter() - t0
    if n_dev == 0:
        raise AssertionError("lane (c): the profiler saw no device activity")
    out["trace"] = {"substep_s": sub, "device_s": dev_s,
                    "device_activities": n_dev,
                    "idle_share": 1.0 - dev_s / sub_s}
    log(f"lane (c) one lane_engine.step on full, {N_ENVS} lanes, "
        f"{LANE_ENV_BUDGET[0]}/{LANE_ENV_BUDGET[1]}, float32: "
        f"{1e3 * sub_s:.2f} ms (median of 3, host clock, synchronised); "
        f"traced (torch.profiler): {n_dev} kernels and copies, "
        f"{1e3 * dev_s:.3f} ms on the card = {1e6 * dev_s / n_dev:.2f} us "
        f"each, the card idle {100 * out['trace']['idle_share']:.1f} % of "
        f"the substep (the trace took {trace_s:.1f} s); card: {rec['card']}")


def _clone(gen):
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def phase_parallel(rec):
    """The parallel paths (``parallel/``, ``rl/distributed.py``, SQP's
    sharded condensation) at one rank over NCCL, each held to its
    unsharded counterpart on the same inputs. The group is started here
    (a world of one on an in-process store) and destroyed at the end,
    unless the process had one before."""
    import torch.distributed as dist

    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.parallel.mesh import fold_in, group_scope

    out = rec["parallel"] = {}
    with group_scope():
        mesh = parallel.make_mesh(device="cuda")
        if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"parallel: a group of "
                                 f"{dist.get_world_size()} over "
                                 f"{dist.get_backend()}, want 1 over nccl")
        log(f"parallel: a world of {dist.get_world_size()} over "
            f"{dist.get_backend()} (NCCL {torch.cuda.nccl.version()}); "
            f"card: {rec['card']}")
        launches = parallel_mpc(rec, out, mesh, fold_in)
        counts = rec.setdefault("launches", {})
        counts[ROLLOUT] = counts.get(ROLLOUT, 0) + launches
        # (c)-(f) step the oracle engine: no kernel
        cuda_engine.reset_launch_counts()
        parallel_rollouts(rec, out, mesh)
        parallel_sqp(rec, out)
        parallel_ppo(rec, out, fold_in)
        if cuda_engine.launch_counts[ROLLOUT] or cuda_engine.launch_counts[
                SUBSTEP]:
            raise AssertionError(f"parallel (c)-(f): physics kernel launches "
                                 f"{cuda_engine.launch_counts} (want none)")
    if dist.is_initialized():
        raise AssertionError("parallel: the phase's group outlived it")


def parallel_mpc(rec, out, mesh, fold_in):
    """(a) ``sharded_mppi_plan`` at the bench width and (b)
    ``sharded_batch_mppi_plan`` over 16 scenarios, each against
    ``mppi.plan`` on the same inputs and streams. Returns B1's launches
    on the sharded paths (the comparisons' are not counted)."""
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import State, make_state
    from quadruped_gym_tpu_torch.solvers import mppi
    from quadruped_gym_tpu_torch.solvers.rollout import make_cost_fn
    from quadruped_gym_tpu_torch.tasks.commands import Command

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    cfg = mpc_config("planning").mppi
    cost_fn = make_cost_fn(m)
    rng = np.random.default_rng(60)
    state = make_state(m, dtype=dt, device=dev)
    state = state._replace(qvel=torch.as_tensor(
        0.1 * rng.standard_normal(m.nv), dtype=dt, device=dev))
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    mean = prev.expand(H_MAIN, m.nu)

    # (a) the main phase's solve through the sample axis
    gens = []
    for k in range(PAR_SOLVES):
        gens.append(torch.Generator(device=dev))
        gens[-1].manual_seed(61 + k)
    starts = [_clone(g) for g in gens]
    solve_s, results = [], []
    cuda_engine.reset_launch_counts()
    for g in gens:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(parallel.sharded_mppi_plan(
            m, cfg, cost_fn, state, mean, cmd, prev, g, mesh))
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
    n_a = cuda_engine.launch_counts[ROLLOUT]
    if n_a != PAR_SOLVES or cuda_engine.launch_counts[SUBSTEP]:
        raise AssertionError(f"parallel (a): launches "
                             f"{cuda_engine.launch_counts}, want "
                             f"{PAR_SOLVES} of B1")
    errs = []
    for res, g in zip(results, starts):
        want = mppi.plan(m, cfg, cost_fn, state, mean, cmd, prev,
                         fold_in(g, 0))
        if not all(bool(torch.isfinite(x).all()) for x in res):
            raise AssertionError("parallel (a): non-finite plan")
        err = float((res.mean - want.mean).abs().max())
        errs.append(err)
        if err > PAR_MEAN_TOL * max(1.0, float(want.mean.abs().max())):
            raise AssertionError(f"parallel (a): the mean differs from "
                                 f"mppi.plan's by {err:.3e}")
        if not torch.equal(res.best_cost, want.best_cost):
            raise AssertionError(f"parallel (a): best cost "
                                 f"{float(res.best_cost)} vs "
                                 f"{float(want.best_cost)}")
    out["mppi"] = {"solve_s": solve_s, "mean_max_abs_err": errs,
                   "best_cost": [float(r.best_cost) for r in results]}
    log(f"parallel (a) sharded_mppi_plan planning S={cfg.num_samples} "
        f"H={H_MAIN} frame_skip {FRAME_SKIP} "
        f"{cfg.lane_newton_iterations}/{cfg.lane_ls_iterations} fused "
        f"float32, 1 rank: " + ", ".join(f"{x:.4f}" for x in solve_s)
        + f" s a solve (host clock, synchronised) = "
        f"{cfg.num_samples / float(np.median(solve_s)):.1f} rollouts/s "
        f"(median); against mppi.plan with fold_in(generator, 0): mean "
        f"max_abs_err " + ", ".join(f"{e:.2e}" for e in errs)
        + f" (tol {PAR_MEAN_TOL:g} of max(1, max|mean|)), best cost equal "
        f"({', '.join(f'{c:.4f}' for c in out['mppi']['best_cost'])}); "
        f"card: {rec['card']}")

    # (b) scenarios x samples on a (1, 1) mesh
    mesh2 = parallel.make_mesh((parallel.DATA_AXIS, parallel.SAMPLE_AXIS),
                               (1, 1), device=dev)
    bcfg = dataclasses.replace(cfg, num_samples=PAR_S)
    vx = torch.linspace(0.1, 0.3, PAR_B, dtype=dt, device=dev)
    cmd_list = [command(dt, dev, vx=float(v)) for v in vx]
    cmds = Command(*(torch.stack(x) for x in zip(*cmd_list)))
    states = State(*(x.expand((PAR_B,) + x.shape) for x in state))
    means = prev.expand(PAR_B, H_MAIN, m.nu)
    prevs = prev.expand(PAR_B, m.nu)
    g = torch.Generator(device=dev)
    g.manual_seed(70)
    start = _clone(g)
    cuda_engine.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctrl, shifted, best = parallel.sharded_batch_mppi_plan(
        m, bcfg, cost_fn, states, means, cmds, prevs, g, mesh2)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    n_b = cuda_engine.launch_counts[ROLLOUT]
    if n_b != PAR_B * bcfg.iterations or cuda_engine.launch_counts[SUBSTEP]:
        raise AssertionError(f"parallel (b): launches "
                             f"{cuda_engine.launch_counts}, want {PAR_B}")
    rank_gen = fold_in(fold_in(start, 0), 0)
    berr = 0.0
    for b in range(PAR_B):
        want = mppi.plan(m, bcfg, cost_fn, state, means[b], cmd_list[b],
                         prev, fold_in(rank_gen, b))
        wshift = torch.cat([want.mean[1:], want.mean[-1:]])
        for got_x, want_x in ((ctrl[b], want.mean[0]), (shifted[b], wshift),
                              (best[b], want.best_cost)):
            e = float((got_x - want_x).abs().max())
            berr = max(berr, e)
            if not e <= PAR_BATCH_TOL * (1.0 + float(want_x.abs().max())):
                raise AssertionError(f"parallel (b) scenario {b}: differs "
                                     f"from mppi.plan by {e:.3e}")
    out["batch"] = {"s": batch_s, "max_abs_err": berr,
                    "best_cost": best.tolist()}
    log(f"parallel (b) sharded_batch_mppi_plan (1, 1) data x sample mesh: "
        f"B={PAR_B} scenarios (commands 0.1-0.3 m/s) x S={PAR_S}, H={H_MAIN},"
        f" fused float32, {n_b} B1 launches: {batch_s:.4f} s (host clock, "
        f"synchronised) = {PAR_B * PAR_S / batch_s:.1f} rollouts/s; against "
        f"{PAR_B} mppi.plan calls with the fold structure: max_abs_err "
        f"{berr:.2e} (tol {PAR_BATCH_TOL:g}, relative to 1 + max|x|); "
        f"best costs {float(best.min()):.4f}..{float(best.max()):.4f}; "
        f"card: {rec['card']}")
    return n_a + n_b


def parallel_rollouts(rec, out, mesh):
    """(c) ``sharded_rollout_costs`` and ``pipelined_rollout_cost`` (one
    stage, two microbatches) against ``batched_rollout_cost`` on the
    oracle engine."""
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.solvers import rollout

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_mpc_plant_model()
    cfg = rollout.RolloutConfig(horizon=PAR_ROLLOUT_H, frame_skip=FRAME_SKIP,
                                max_contacts=12, solver_iterations=4)
    cost_fn = rollout.make_cost_fn(m)
    state = start_state(m, "airborne", np.random.default_rng(80), dt, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(81)
    seqs = random_seqs(gen, PAR_ROLLOUT_S, PAR_ROLLOUT_H, dt, dev, 0.2)
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    stage_mesh = parallel.make_mesh((parallel.STAGE_AXIS,), device=dev)
    times, res = {}, {}
    for name, fn in (
            ("batched", lambda: rollout.batched_rollout_cost(
                m, cfg, cost_fn, state, seqs, cmd, prev)),
            ("sharded", lambda: parallel.sharded_rollout_costs(
                m, cfg, cost_fn, state, seqs, cmd, prev, mesh)),
            ("pipelined", lambda: parallel.pipelined_rollout_cost(
                m, cfg, cost_fn, state, seqs, cmd, prev, stage_mesh,
                num_microbatches=PAR_MICROBATCHES))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    want = res["batched"]
    if not bool(torch.isfinite(want).all()):
        raise AssertionError("parallel (c): non-finite costs")
    errs = {}
    for name in ("sharded", "pipelined"):
        err = (res[name] - want).abs()
        errs[name] = float(err.max())
        if res[name].shape != want.shape or bool(
                (err > F32_TOL + F32_TOL * want.abs()).any()):
            raise AssertionError(f"parallel (c): {name} costs differ from "
                                 f"batched_rollout_cost by {errs[name]:.3e}")
    out["rollouts"] = {"s": times, "max_abs_err": errs}
    log(f"parallel (c) mpc_plant oracle S={PAR_ROLLOUT_S} H={PAR_ROLLOUT_H} "
        f"frame_skip {FRAME_SKIP}, 12 contacts, 4 Newton passes, float32, "
        f"airborne: sharded_rollout_costs max_abs_err "
        f"{errs['sharded']:.2e}, pipelined_rollout_cost (1 stage, "
        f"{PAR_MICROBATCHES} microbatches) {errs['pipelined']:.2e} against "
        f"batched_rollout_cost (rtol=atol={F32_TOL:g}); "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
        + f" (host clock, synchronised); card: {rec['card']}")


def parallel_sqp(rec, out):
    """(d) ``sqp.condense`` on a world-1 ``horizon`` mesh against the
    unsharded one at H=50 and the fast plant's nx and nu, then
    ``sqp.solve(mesh=)`` at H=4 against the unsharded solve, float64."""
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.solvers import ilqr, rollout, sqp

    dev, f64 = torch.device("cuda"), torch.float64
    fp = spec.get_fast_plant_model()
    nx, nu = ilqr.tangent_dim(fp), fp.nu
    rng = np.random.default_rng(90)
    F = torch.as_tensor(rng.standard_normal((H_MAIN, nx, H_MAIN * nu)),
                        device=dev)
    lx = torch.as_tensor(rng.standard_normal((H_MAIN, nx)), device=dev)
    R = torch.as_tensor(rng.standard_normal((H_MAIN, nx, nx)), device=dev)
    lxx = R @ R.transpose(1, 2)
    hmesh = parallel.make_mesh(("horizon",), device=dev)
    got = sqp._condense_sharded(F, lx, lxx, hmesh, "horizon")
    want = sqp.condense(F, lx, lxx)
    cerr = max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))
    if not cerr <= PAR_CONDENSE_TOL:
        raise AssertionError(f"parallel (d): the sharded condensation "
                             f"differs by {cerr:.3e}")

    m = spec.get_planning_model()
    kw = dict(max_contacts=8, solver_iterations=4)
    sts, _ = oracle_states(m, f64, dev, **kw)
    hold = prev_ctrl(f64, dev)
    cfg = sqp.SQPConfig(iterations=1, rollout=rollout.RolloutConfig(
        horizon=4, frame_skip=2, **kw))
    cost_fn = rollout.make_cost_fn(m, vel_smooth_eps=0.02)
    us0 = torch.clamp(hold + 0.2 * torch.as_tensor(
        rng.standard_normal((4, m.nu)), device=dev), -1.0, 1.0)
    args = (m, cfg, cost_fn, sts["contact"], us0, command(f64, dev), hold)
    want = sqp.solve(*args)
    got = sqp.solve(*args, mesh=hmesh)
    serr = {}
    for f in ("ctrl_seq", "cost"):
        g, w = getattr(got, f), getattr(want, f)
        serr[f] = float((g - w).abs().max())
        if not serr[f] <= GRAD_SQP_TOL * (1.0 + float(w.abs().max())):
            raise AssertionError(f"parallel (d): sqp.solve(mesh=) {f} "
                                 f"differs by {serr[f]:.3e}")
    out["sqp"] = {"condense_rel_err": cerr, "solve_max_abs_err": serr}
    log(f"parallel (d) sqp.condense on a 1-rank horizon mesh, H={H_MAIN}, "
        f"nx={nx}, nu={nu}, float64: relative err {cerr:.2e} (tol "
        f"{PAR_CONDENSE_TOL:g}); sqp.solve(mesh=) planning H=4, 1 "
        f"iteration: cost {float(want.initial_cost):.6f} -> "
        f"{float(got.cost):.6f}, against the unsharded solve max_abs_err "
        f"ctrl_seq {serr['ctrl_seq']:.2e} cost {serr['cost']:.2e} (tol "
        f"{GRAD_SQP_TOL:g} relative to 1 + max|x|); card: {rec['card']}")


def parallel_ppo(rec, out, fold_in):
    """(e) ``rl.train.main --distributed`` at the trainer's 2,048 envs, one
    update of 2 env steps, and (f) one ``make_distributed_update`` against
    ``ppo.update_fn`` from the same TrainState and rank stream: at one
    rank the all-reduces are copies and the divisions by 1, so the
    parameters must agree in every bit."""
    from quadruped_gym_tpu_torch import parallel
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.rl import distributed, ppo, train

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, its = train_run(rec, os.path.join(tmp, "dist"), PAR_TRAIN_ARGS,
                           0, 1, 2)
        call_s = time.perf_counter() - t0
    out["train"] = {"update_s": its[0].seconds, "call_s": call_s}
    log(f"parallel (e) rl.train.main {' '.join(PAR_TRAIN_ARGS)}: "
        f"{its[0].seconds:.3f} s an update of {N_ENVS} x 2 env steps, the "
        f"call {call_s:.1f} s; card: {rec['card']}")

    args = train._parser().parse_args(PAR_TRAIN_ARGS)
    env_cfg = train.make_env_config(args)
    cfg = ppo.PPOConfig(num_envs=args.num_envs, num_steps=args.num_steps)
    m = spec.get_mpc_plant_model()
    mesh = parallel.make_mesh((parallel.DATA_AXIS,), device="cuda")
    ts_a = distributed.init_distributed_train_state(
        m, env_cfg, cfg, 3, mesh, device="cuda")
    ts_b = ppo.init_train_state(m, env_cfg, cfg, 3, device="cuda")
    ts_b = ts_b._replace(generator=fold_in(_clone(ts_b.generator), 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts_a, _ = distributed.make_distributed_update(m, env_cfg, cfg, mesh)(ts_a)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    ts_b, _ = ppo.update_fn(m, env_cfg, cfg)(ts_b)
    torch.cuda.synchronize()
    pa, pb = (list(t.net.state_dict().values()) for t in (ts_a, ts_b))
    same = [bool(torch.equal(a, b)) for a, b in zip(pa, pb)]
    diff = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    out["update_bitwise"] = all(same)
    log(f"parallel (f) make_distributed_update vs ppo.update_fn, {N_ENVS} "
        f"envs x 2 steps, 1 rank: parameters equal in every bit: "
        f"{all(same)} ({sum(same)} of {len(same)} leaves; max |diff| "
        f"{diff:.3e}); the distributed update {dist_s:.3f} s; card: "
        f"{rec['card']}")
    if not all(same):
        raise AssertionError("parallel (f): the distributed update at one "
                             "rank is not update_fn's")


def walk_check(walk):
    """Raises unless the walk's trajectories have their shapes and are
    finite, and the robot stayed upright and went forward."""
    n = walk["steps"]
    for name in ("ctrls", "sens", "costs"):
        if not bool(torch.isfinite(walk[name]).all()):
            raise AssertionError(f"walk: non-finite {name}")
    if walk["ctrls"].shape != (n, 12) or walk["sens"].shape != (n, 33):
        raise AssertionError("walk: wrong trajectory shapes")
    if not walk["upright_min"] > WALK_LIMITS["upright"]:
        raise AssertionError(f"walk: uprightness {walk['upright_min']:.3f}")
    if not walk["forward_m"] > WALK_LIMITS["forward_m"]:
        raise AssertionError(f"walk: only {walk['forward_m']:.3f} m forward")
    if not abs(walk["sideways_m"]) < WALK_LIMITS["sideways_m"]:
        raise AssertionError(f"walk: {walk['sideways_m']:.3f} m sideways")


def phase_loop(rec):
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics import engine
    from quadruped_gym_tpu_torch.runtime import mpc_runtime

    dev = torch.device("cuda")
    example = _example("torch_closed_loop_walk")
    iters = example.mpc_config().mppi.iterations

    def counted(tag, steps):
        got = (cuda_engine.launch_counts[ROLLOUT],
               cuda_engine.launch_counts[SUBSTEP])
        if got != (steps * iters, 0):
            raise AssertionError(
                f"{tag}: {got[0]} fused and {got[1]} substep launches in "
                f"{steps} steps of {iters} iterations (want {steps * iters} "
                "and 0)")
        counts = rec.setdefault("launches", {})
        counts[ROLLOUT] = counts.get(ROLLOUT, 0) + got[0]
        return got[0]

    # 1. the walk, through the example's main
    cuda_engine.reset_launch_counts()
    walk = example.main(WALK_STEPS, WALK_SPEED, device=dev, seed=0)
    n = counted("closed_loop", WALK_STEPS)
    walk_check(walk)
    carry, phys = walk.pop("carry"), walk.pop("phys")
    for name in ("ctrls", "sens", "costs"):
        walk.pop(name)
    walk["period_s"] = walk["wall_s"] / WALK_STEPS
    log(f"loop: torch_closed_loop_walk.main: closed_loop {WALK_STEPS} steps "
        f"in {walk['wall_s']:.1f} s, {n} fused_rollout_cost launches, 0 "
        f"substep launches; {walk['period_s']:.4f} s per control period "
        f"(host clock, one synchronise at the end); traveled "
        f"({walk['forward_m']:+.4f}, {walk['sideways_m']:+.4f}) m, "
        f"uprightness min {walk['upright_min']:.4f}; card: {rec['card']}")
    rec["walk"] = walk

    # 2. the delayed loop from the same start, oracle plant and lane plant
    rec["delayed"] = {}
    for plant_engine in ("aos", "lane"):
        pm, plant, cfg, cost_fn, cmd, carry0, phys0 = example.setup(
            dev, 1, WALK_SPEED)
        cuda_engine.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, end, (ctrls, sens, costs) = mpc_runtime.delayed_closed_loop(
            pm, cfg, cost_fn, carry0, phys0, cmd, DELAYED_STEPS,
            plant_model=plant, predictor="auto", plant_engine=plant_engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted(f"delayed_closed_loop plant_engine={plant_engine}",
                DELAYED_STEPS)
        if not bool((ctrls[0] == carry0.prev_ctrl).all()):
            raise AssertionError("delayed loop: step 0 did not apply the "
                                 "standing control")
        if not all(bool(torch.isfinite(x).all())
                   for x in (ctrls, sens, costs, end.qpos, end.qvel)):
            raise AssertionError("delayed loop: non-finite values")
        if not float(end.qpos[2]) > 0.03:
            raise AssertionError("delayed loop: the robot fell through")
        rec["delayed"][plant_engine] = {"period_s": wall / DELAYED_STEPS,
                                        "base_z": float(end.qpos[2])}
        log(f"loop: delayed_closed_loop {DELAYED_STEPS} steps, predictor "
            f"auto (lane), plant_engine {plant_engine}: step 0 applied the "
            f"standing control; {wall / DELAYED_STEPS:.4f} s per period "
            f"(predict + plan + plant; host clock); base z "
            f"{float(end.qpos[2]):.4f}; card: {rec['card']}")

    # 3. the period's parts, each followed by a synchronise, going on from
    # where the walk ended (not part of the counted run)
    pm, plant, cfg, cost_fn, cmd, _, _ = example.setup(dev, 0, WALK_SPEED)
    parts = {"plan_and_act": [], "oracle_control_step": [],
             "lane_control_step": []}
    lane_phys = phys
    for _ in range(SPLIT_PERIODS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl, carry, _ = mpc_runtime.plan_and_act(pm, cfg, cost_fn, carry,
                                                  phys, cmd)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        phys = engine.control_step(
            plant, phys, ctrl, cfg.plant_frame_skip,
            max_contacts=cfg.plant_max_contacts,
            solver_iterations=cfg.plant_solver_iterations)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lane_phys = mpc_runtime.lane_control_step(
            plant, lane_phys, ctrl, cfg.plant_frame_skip,
            solver_iterations=cfg.plant_solver_iterations,
            ls_iterations=2 * cfg.plant_solver_iterations)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["plan_and_act"].append(t1 - t0)
        parts["oracle_control_step"].append(t2 - t1)
        parts["lane_control_step"].append(t3 - t2)
    split = {k: float(np.median(v[1:])) for k, v in parts.items()}
    fs = cfg.plant_frame_skip
    rec["loop_split"] = dict(
        split, each=parts,
        oracle_substep_ms=1e3 * split["oracle_control_step"] / fs,
        lane_substep_ms=1e3 * split["lane_control_step"] / fs)
    log(f"loop split (median of {SPLIT_PERIODS} periods after the first, "
        f"host clock, synchronised after each part): plan_and_act "
        f"{split['plan_and_act']:.4f} s; oracle control_step "
        f"{split['oracle_control_step']:.4f} s = "
        f"{rec['loop_split']['oracle_substep_ms']:.2f} ms per substep; "
        f"lane_control_step (the plant of plant_engine='lane') "
        f"{split['lane_control_step']:.4f} s = "
        f"{rec['loop_split']['lane_substep_ms']:.2f} ms per substep; "
        f"card: {rec['card']}")

    # 4. what the card did in one period's parts: one traced call of each,
    # its device time held against the untraced medians above
    dev_s, n_dev, _ = traced(lambda: engine.control_step(
        plant, phys, ctrl, fs, max_contacts=cfg.plant_max_contacts,
        solver_iterations=cfg.plant_solver_iterations))
    plan_dev_s, plan_n_dev, _ = traced(lambda: mpc_runtime.plan_and_act(
        pm, cfg, cost_fn, carry, phys, cmd))
    if n_dev == 0 or plan_n_dev == 0:
        raise AssertionError("loop: the profiler saw no device activity")
    rec["loop_trace"] = {
        "oracle_device_s": dev_s, "oracle_device_activities": n_dev,
        "oracle_activities_per_substep": n_dev / fs,
        "oracle_idle_share": 1.0 - dev_s / split["oracle_control_step"],
        "plan_device_s": plan_dev_s, "plan_device_activities": plan_n_dev,
        "plan_idle_share": 1.0 - plan_dev_s / split["plan_and_act"]}
    log(f"loop trace (torch.profiler, one call each; device time over the "
        f"untraced median above): oracle control_step ran {n_dev} kernels "
        f"and copies = {n_dev / fs:.0f} per substep, {1e3 * dev_s:.3f} ms "
        f"on the card = {1e6 * dev_s / n_dev:.2f} us each, the card idle "
        f"{100 * rec['loop_trace']['oracle_idle_share']:.1f} % of the "
        f"{split['oracle_control_step']:.4f} s; plan_and_act ran "
        f"{plan_n_dev}, {1e3 * plan_dev_s:.3f} ms on the card, idle "
        f"{100 * rec['loop_trace']['plan_idle_share']:.1f} % of the "
        f"{split['plan_and_act']:.4f} s; card: {rec['card']}")


def train_run(rec, out, argv, first, n_iter, steps):
    """``rl.train.main(argv)`` into ``out`` on the card, checked: every
    metric finite, the iterations numbered on from ``first``, the
    checkpoint's step and one CSV row per policy step so far, the
    parameters on the card. Returns (train_state, iterations)."""
    from quadruped_gym_tpu_torch.rl import train
    from quadruped_gym_tpu_torch.runtime import checkpoint
    from quadruped_gym_tpu_torch.utils.metrics import read_reward_csv

    ts, its = train.main(["--output", out] + argv)
    torch.cuda.synchronize()
    if [it.index for it in its] != list(range(first, first + n_iter)):
        raise AssertionError(f"train: iterations {[it.index for it in its]}")
    for it in its:
        for name, x in zip(it.metrics._fields, it.metrics):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"train iteration {it.index}: {name} "
                                     "is not finite")
    where = {p.device.type for p in ts.net.parameters()}
    if where != {"cuda"} or ts.obs.device.type != "cuda":
        raise AssertionError(f"train: parameters on {where}")
    _, step = checkpoint.read(os.path.join(out, "policy"))
    if step != first + n_iter or int(ts.update_idx) != first + n_iter:
        raise AssertionError(f"train: checkpoint step {step}, update_idx "
                             f"{int(ts.update_idx)} after iteration "
                             f"{first + n_iter - 1}")
    rows, _, comp, _ = read_reward_csv(os.path.join(out,
                                                    "rewards_continuous.csv"))
    if list(rows) != list(range((first + n_iter) * steps)) \
            or not np.isfinite(comp).all():
        raise AssertionError(f"train: {len(rows)} CSV rows after "
                             f"{first + n_iter} updates of {steps} steps")
    for it in its:
        log(f"train iteration {it.index} ({' '.join(argv)}): "
            f"{it.seconds:.3f} s an update (host clock, ends in the metrics' "
            f"read-back), mean step reward "
            f"{float(it.metrics.mean_reward.mean()):.4f}, approx_kl "
            f"{float(it.metrics.approx_kl[-1]):.5f}; card: {rec['card']}")
    log(f"train: checkpoint step {step}, {len(rows)} CSV rows, log_std max "
        f"{float(ts.net.log_std.detach().max()):.4f} after the call")
    return ts, its


def phase_train(rec):
    from quadruped_gym_tpu_torch import convert
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.rl import networks, ppo, train

    cfg = ppo.PPOConfig()  # the trainer's defaults
    env_cfg = train.make_env_config(train._parser().parse_args(TRAIN_ARGS))
    m = spec.get_mpc_plant_model()
    n_env, n_step, fs = cfg.num_envs, cfg.num_steps, env_cfg.frame_skip
    out = {"num_envs": n_env, "num_steps": n_step, "frame_skip": fs}
    rec["train"] = out

    def no_kernels(tag):
        got = (cuda_engine.launch_counts[ROLLOUT],
               cuda_engine.launch_counts[SUBSTEP])
        if got != (0, 0):
            raise AssertionError(f"{tag}: {got[0]} fused and {got[1]} "
                                 "substep launches (want none)")

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) two iterations at the defaults, then a resume with one more
        # and one of fine-tune; the run's folder is kept for the tools
        # phase (its checkpoint and reward CSV)
        run_dir = os.path.join(rec["tmp"], "train_run")
        rec["train_run"] = run_dir
        cuda_engine.reset_launch_counts()
        # (cut from 2 + 1 + 1 updates: the fine-tune update resumes too)
        ts, its = train_run(rec, run_dir, TRAIN_ARGS + ["--iterations", "1"],
                            0, 1, n_step)
        ts, its2 = train_run(rec, run_dir, TRAIN_ARGS + [
            "--iterations", "0", "--finetune-iterations", "1"], 1, 1, n_step)
        no_kernels("train")
        if not float(ts.net.log_std.detach().max()) <= -1.2:
            raise AssertionError("train: the fine-tune left log_std above "
                                 "-1.2")
        out["update_s"] = [it.seconds for it in its + its2]

        # one more update in its two parts, a synchronise after each
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env_state, obs, traj = ppo._rollout(m, env_cfg, cfg, ts.net,
                                            ts.env_state, ts.obs,
                                            ts.generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ppo._optimize(cfg, ts.net, ts.opt, ts.generator, traj, obs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.update(rollout_s=t1 - t0, learn_s=t2 - t1)
        out["env_steps_per_s"] = n_env * n_step / (t2 - t0)
        out["substep_ms"] = 1e3 * out["rollout_s"] / (n_step * fs)
        log(f"train split (one update, host clock, a synchronise after "
            f"each part): rollout {out['rollout_s']:.3f} s = "
            f"{out['rollout_s'] / n_step:.4f} s an env step = "
            f"{out['substep_ms']:.2f} ms a substep ({n_env} envs, oracle "
            f"engine, mpc_plant, frame_skip {fs}); learning (GAE + "
            f"{cfg.epochs} x {cfg.num_minibatches} minibatches of "
            f"{cfg.batch_size // cfg.num_minibatches}) {out['learn_s']:.3f} "
            f"s; {out['env_steps_per_s']:.1f} env-steps/s; card: "
            f"{rec['card']}")

        # one traced update, its rollout cut to TRACE_ENV_STEPS env steps
        # (every env step launches the same kernels); the learning half
        # traced whole, on the rollout above
        cut = dataclasses.replace(cfg, num_steps=TRACE_ENV_STEPS)
        r_dev, r_n, _ = traced(lambda: ppo._rollout(
            m, env_cfg, cut, ts.net, env_state, obs, ts.generator))
        l_dev, l_n, _ = traced(lambda: ppo._optimize(
            cfg, ts.net, ts.opt, ts.generator, traj, obs))
        if r_n == 0 or l_n == 0:
            raise AssertionError("train: the profiler saw no device activity")
        step_s = out["rollout_s"] / n_step
        dev_step_s = r_dev / TRACE_ENV_STEPS
        out["trace"] = {
            "env_steps_traced": TRACE_ENV_STEPS,
            "rollout_device_s": r_dev, "rollout_activities": r_n,
            "activities_per_env_step": r_n / TRACE_ENV_STEPS,
            "rollout_idle_share": 1.0 - dev_step_s / step_s,
            "learn_device_s": l_dev, "learn_activities": l_n,
            "learn_idle_share": 1.0 - l_dev / out["learn_s"],
            "idle_share": 1.0 - (dev_step_s * n_step + l_dev) / (t2 - t0)}
        tr = out["trace"]
        log(f"train trace (torch.profiler; the rollout traced for "
            f"{TRACE_ENV_STEPS} env steps, the learning half whole; device "
            f"time over the untraced split above): an env step ran "
            f"{r_n / TRACE_ENV_STEPS:.0f} kernels and copies = "
            f"{r_n / (TRACE_ENV_STEPS * fs):.0f} a substep, "
            f"{1e3 * dev_step_s:.2f} ms on the card = {1e6 * r_dev / r_n:.2f} "
            f"us each, the card idle {100 * tr['rollout_idle_share']:.1f} % "
            f"of the rollout; the learning ran {l_n}, {1e3 * l_dev:.2f} ms on "
            f"the card, idle {100 * tr['learn_idle_share']:.1f} %; the update "
            f"idle {100 * tr['idle_share']:.1f} % ({n_step} env steps at the "
            f"traced rate); card: {rec['card']}")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        no_kernels("train split and trace")

        # (b) the leg-engine env, cut in depth
        lane_dir = os.path.join(tmp, "lane")
        _, lane = train_run(rec, lane_dir, TRAIN_ARGS + [
            "--lane-physics", "--iterations", "1", "--num-steps",
            str(LANE_TRAIN_STEPS), "--timesteps-per-iteration",
            str(n_env * LANE_TRAIN_STEPS)], 0, 1, LANE_TRAIN_STEPS)
        no_kernels("train --lane-physics")
        out["lane_update_s"] = lane[0].seconds
        log(f"train --lane-physics (cut to {LANE_TRAIN_STEPS} env steps from "
            f"{n_step}: the eager leg engine takes seconds an env step at "
            f"{n_env} envs): {lane[0].seconds:.3f} s for the update = at most "
            f"{lane[0].seconds / LANE_TRAIN_STEPS:.3f} s an env step "
            f"(learning included); card: {rec['card']}")

    # (c) the committed policy on the run's observations: float32 on the
    # card against float64 on the CPU
    with np.load(os.path.join(POLICY, "state.npz")) as data:
        net32 = convert.policy_params(data, torch.float32, "cuda")
        net64 = convert.policy_params(data, torch.float64, "cpu")
    obs = ts.obs
    errs = {}
    with torch.no_grad():
        for name, fn in (("actor_mean", networks.actor_mean),
                         ("value", networks.value)):
            got = fn(net32, obs).double().cpu()
            want = fn(net64, obs.double().cpu())
            errs[name] = float((got - want).abs().max() / want.abs().max())
    out["policy_rel_err"] = errs
    log(f"train policy check: {POLICY_TOL:g} allowed; artifacts/walk_r5 "
        f"policy on {obs.shape[0]} observations of the run, float32 on the "
        f"card vs float64 on the CPU: max error over max |output| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; card: {rec['card']}")
    if not max(errs.values()) <= POLICY_TOL:
        raise AssertionError(f"train: the policy on the card is off by "
                             f"{max(errs.values()):.2e}")
    log(f"train: peak device memory {out['peak_mem_gb']:.2f} GB; 0 "
        f"fused_rollout_cost and 0 substep launches; card: {rec['card']}")


def episode_steps(max_time, h, frame_skip, dtype=np.float32):
    """Control steps of an episode that ends at ``time >= max_time`` on a
    clock summing ``h`` in ``dtype``: in float32 the sum of 300 steps of
    0.002 s is just under 0.6, so that episode takes one step more than
    in float64."""
    t, n, end = dtype(0), 0, dtype(max_time)
    while not t >= end:
        for _ in range(frame_skip):
            t = dtype(t + dtype(h))
        n += 1
    return n


def phase_eval(rec):
    """The trainer's per-iteration eval: the committed policy through
    ``eval_rollout`` on the card (float32, the gym env on ``full``), the
    cost of its control step, and ``rl.train.main`` at its defaults with
    the eval on. No kernel runs on this path (the gym env steps the oracle
    engine, as in the JAX package)."""
    from quadruped_gym_tpu_torch import convert
    from quadruped_gym_tpu_torch.envs import gym_env, rendering
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics import engine
    from quadruped_gym_tpu_torch.rl import evaluate, networks, train
    from quadruped_gym_tpu_torch.utils import plot

    found = {"gymnasium": gym_env.gym is not None,
             "cv2": rendering.HAVE_CV2,
             "matplotlib": plot.have_matplotlib()}
    out = {"found": found}
    rec["eval"] = out
    log("eval: optional packages found: "
        + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in found.items()))
    with np.load(os.path.join(POLICY, "state.npz")) as data:
        net = convert.policy_params(data, torch.float32, "cuda")

    cuda_engine.reset_launch_counts()
    # (a) the committed policy, one episode cut to EVAL_MAX_TIME
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = evaluate.eval_rollout(net, obs_window=10, max_time=EVAL_MAX_TIME,
                               frame_skip=10, deterministic=True, seed=0)
    wall = time.perf_counter() - t0
    env = gym_env.POWalkingQuadrupedEnv(obs_window=10, max_time=EVAL_EPISODE_S,
                                        frame_skip=10)
    step_dt = env.pm.timestep * env.frame_skip
    want_steps = episode_steps(EVAL_MAX_TIME, env.pm.timestep, env.frame_skip)
    em.pop("rewards")
    out["rollout"] = dict(em, wall_s=wall, step_s=wall / em["steps"])
    log(f"eval: walk_r5 through eval_rollout on the card (float32, "
        f"POWalkingQuadrupedEnv on full, obs window 10, frame_skip 10, "
        f"{env._cfg.max_contacts} contacts, Newton budget "
        f"{env.pm.solver_iterations}): {em['steps']} steps, return "
        f"{em['episode_return']:.3f}, survived {em['survived']}, tracking "
        f"error {em['mean_tracking_error']:.4f} m/s, uprightness "
        f"{em['mean_uprightness']:.4f}; {wall:.3f} s = "
        f"{out['rollout']['step_s']:.4f} s a control step (host clock, "
        f"actor and read-backs included); card: {rec['card']}")
    if not (em["steps"] == want_steps and em["survived"]
            and np.isfinite(em["episode_return"])
            and em["mean_uprightness"] > EVAL_LIMITS["upright"]
            and em["mean_tracking_error"] < EVAL_LIMITS["tracking"]):
        raise AssertionError(f"eval: the policy does not walk ({em}; want "
                             f"{want_steps} steps, {EVAL_LIMITS})")

    # (b) one control step: host clock, each step synchronised, then one
    # traced step (the kernels of its substeps, device time, idle share);
    # the robot lands first (the reset state hangs 10 cm up: ~7 control
    # steps of free fall, which run no contact solve)
    env.control_inputs.set_orientation(0.0)
    env.control_inputs.set_velocity_speed_alpha(0.2, 0.0)
    obs, _ = env.reset()
    times = []
    for _ in range(EVAL_WARM_STEPS + EVAL_TIMED_STEPS):
        with torch.no_grad():
            a = networks.actor_mean(net, torch.as_tensor(
                obs, dtype=torch.float32, device="cuda")).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs, *_ = env.step(np.clip(a, -1.0, 1.0))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times[EVAL_WARM_STEPS:]))
    fs = env.frame_skip
    # the trace takes one substep of the env's physics (a whole control
    # step, ~217k kernels, kept the profiler ~2 minutes); the task layer
    # around it launches a few hundred a control step
    ctrl = torch.as_tensor(np.clip(a, -1.0, 1.0), dtype=torch.float32,
                           device="cuda")[None]
    t0 = time.perf_counter()
    dev_s, n_dev, _ = traced(lambda: engine.control_step(
        env.pm, env._state, ctrl, 1, max_contacts=env._cfg.max_contacts,
        solver_iterations=env._cfg.solver_iterations))
    trace_s = time.perf_counter() - t0
    if n_dev == 0:
        raise AssertionError("eval: the profiler saw no device activity")
    sub_s = step_s / fs
    out["step"] = {"each_s": times, "step_s": step_s,
                   "substep_ms": 1e3 * sub_s, "substep_device_s": dev_s,
                   "substep_device_activities": n_dev,
                   "idle_share": 1.0 - dev_s / sub_s}
    log(f"eval step (env.step on full at batch 1, median of "
        f"{EVAL_TIMED_STEPS} after {EVAL_WARM_STEPS} landing steps, host "
        f"clock, synchronised): "
        f"{step_s:.4f} s a control step = {1e3 * sub_s:.2f} ms a substep; "
        f"one traced substep (torch.profiler): {n_dev} kernels and copies, "
        f"{1e3 * dev_s:.3f} ms on the card = {1e6 * dev_s / n_dev:.2f} us "
        f"each, the card idle {100 * out['step']['idle_share']:.1f} % of "
        f"the substep (the trace took {trace_s:.1f} s); card: "
        f"{rec['card']}")

    # (c) what the trainer's eval costs an iteration: its 20 s episode at
    # the walking rate of (b), and at the whole cut episode's of (a) (its
    # first steps fall freely and are cheap), an extrapolation, beside the
    # train phase's update
    n_episode = episode_steps(EVAL_EPISODE_S, env.pm.timestep, fs)
    episode_s = n_episode * step_s
    update_s = rec.get("train", {}).get("update_s")
    out["episode_extrapolated_s"] = episode_s
    out["episode_extrapolated_s_from_a"] = n_episode * out["rollout"]["step_s"]
    log(f"eval extrapolation (not measured): the trainer's eval episode of "
        f"{EVAL_EPISODE_S:g} s = {n_episode} control steps at {step_s:.4f} s "
        f"(b) = {episode_s:.1f} s an iteration ("
        f"{out['episode_extrapolated_s_from_a']:.1f} s at the "
        f"{out['rollout']['step_s']:.4f} s of (a)), against an update of "
        + (f"{float(np.median(update_s)):.3f} s (train phase, median)"
           if update_s else "(train phase not run)")
        + f"; card: {rec['card']}")

    # (d) rl.train.main at the default 2,048 envs with the eval on
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        argv = ["--output", run] + EVAL_TRAIN_ARGS
        if not found["cv2"]:
            log("eval: no OpenCV on this host, so --no-eval-video (a video "
                "needs cv2, as in the JAX trainer)")
            argv.append("--no-eval-video")
        _, its = train.main(argv)
        with open(os.path.join(run, "logs", "eval_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        want = episode_steps(EVAL_TRAIN_MAX_TIME, env.pm.timestep,
                             env.frame_skip)
        if (len(rows) != 1 or set(rows[0]) != EVAL_KEYS
                or rows[0]["iteration"] != 0 or rows[0]["steps"] != want
                or not np.isfinite(rows[0]["episode_return"])):
            raise AssertionError(f"train eval: eval_metrics.jsonl holds "
                                 f"{rows}")
        made = {name: os.path.exists(os.path.join(run, *name.split("/")))
                for name in ("videos/run_0.mp4", "plots/reward_plot_0.png",
                             "plots/reward_components_0.html")}
        expect = {"videos/run_0.mp4": found["cv2"],
                  "plots/reward_plot_0.png": found["matplotlib"],
                  "plots/reward_components_0.html": True}
        if made != expect:
            raise AssertionError(f"train eval: files {made}, want {expect}")
        out["train"] = {"update_s": its[0].seconds,
                        "eval_s": its[0].eval_seconds, "row": rows[0]}
        log(f"eval: rl.train.main {' '.join(EVAL_TRAIN_ARGS)} (2,048 envs, "
            f"the eval on): update {its[0].seconds:.3f} s, eval episode "
            f"{its[0].eval_seconds:.3f} s for {rows[0]['steps']} steps "
            f"(video {'on' if found['cv2'] else 'off'}); "
            f"eval_metrics.jsonl {rows[0]}; files {made}; card: "
            f"{rec['card']}")

    got = (cuda_engine.launch_counts[ROLLOUT],
           cuda_engine.launch_counts[SUBSTEP])
    if got != (0, 0):
        raise AssertionError(f"eval: {got[0]} fused and {got[1]} substep "
                             "launches (want none)")
    log(f"eval: 0 fused_rollout_cost and 0 substep launches; card: "
        f"{rec['card']}")


def _example(name):
    return repo_module("examples", name)


def _script(name):
    return repo_module("scripts", name)


def gait_run(rec, gait, tmp, solver, iters, extra=()):
    """``torch_gait_sqp.main`` on the card, checked: finite costs, the
    controls inside the actuator box, never above the initial cost.
    Returns the report's run."""
    out = os.path.join(tmp, f"gait_{solver}_{len(os.listdir(tmp))}.json")
    argv = ["--solver", solver, "--iterations", str(iters), "--split",
            *extra, "--out", out]
    t0 = time.perf_counter()
    report = gait.main(argv)
    wall = time.perf_counter() - t0
    run = report["runs"][0]
    costs = [run["initial_cost"], *run["cost_history"]]
    if not (np.isfinite(costs).all() and np.isfinite(
            report["standing_hold_cost"])):
        raise AssertionError(f"gait {solver} {extra}: non-finite costs "
                             f"{costs}")
    if not run["ctrl_within_range"]:
        raise AssertionError(f"gait {solver}: controls outside the box")
    if not max(run["cost_history"]) <= run["initial_cost"]:
        raise AssertionError(f"gait {solver}: cost rose {costs}")
    split = run["split_s_per_iteration"]
    log(f"grad gait {solver} {' '.join(extra)} (torch_gait_sqp.main "
        f"{' '.join(argv[:-2])}; fast plant, H={report['horizon']}, "
        f"frame_skip {report['frame_skip']}, 12 contacts, 4 Newton passes, "
        f"float32, vel_smooth_eps {report['vel_smooth_eps']}): hold cost "
        f"{report['standing_hold_cost']:.2f}; cost {run['initial_cost']:.2f} "
        f"-> history {[round(c, 2) for c in run['cost_history']]}; "
        f"descended {run['final_cost'] < run['initial_cost']}; card: "
        f"{rec['card']}")
    log(f"grad gait {solver} {' '.join(extra)} time: solve "
        f"{run['solve_time_s']:.3f} s = {run['per_iteration_s']:.3f} s an "
        f"iteration (host clock, the first rollout included); the initial "
        f"guess's rollout {run['rollout_s']:.3f} s; split per iteration (a "
        f"synchronise after each part): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f"; the whole call {wall:.1f} s (settle, hold rollout, solve, "
        f"re-rollout); card: {rec['card']}")
    log(f"grad gait {solver} {' '.join(extra)} re-rollout: forward "
        f"{100 * run['forward_displacement_m']:.2f} cm, mean local vx "
        f"{run['mean_local_vx']:.4f} m/s, final height "
        f"{run['final_height']:.4f} m, min uprightness "
        f"{run['min_uprightness']:.4f}")
    return dict(run, hold_cost=report["standing_hold_cost"], call_s=wall)


def phase_grad(rec):
    """The gradient solvers through their two entry points on the card:
    gait SQP and iLQR at ``examples/gait_sqp.py``'s defaults (cut in
    iterations), the receding-horizon loops of
    ``examples/closed_loop_gradient.py`` (cut in steps), the delayed loop
    with SQP, and one gait SQP iteration traced in parts. No kernel runs
    on this path (the solvers step the oracle engine)."""
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics import engine, maths
    from quadruped_gym_tpu_torch.runtime import mpc_runtime
    from quadruped_gym_tpu_torch.solvers import ilqr, sqp

    gait = _example("torch_gait_sqp")
    loop = _example("torch_closed_loop_gradient")
    out = {}
    rec["grad"] = out
    cuda_engine.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # 1-2. the gait optimizations (one settle, shared)
        t0 = time.perf_counter()
        out["sqp"] = gait_run(rec, gait, tmp, "sqp", GAIT_ITERS["sqp"])
        out["first_call_s"] = time.perf_counter() - t0
        if not out["sqp"]["final_cost"] < out["sqp"]["initial_cost"]:
            raise AssertionError("grad: gait SQP did not descend")
        out["ilqr"] = gait_run(rec, gait, tmp, "ilqr", GAIT_ITERS["ilqr"],
                               ("--horizon", str(GAIT_ILQR_H)))
        log(f"grad gait: the first call (settle to stance, 400 steps at the "
            f"model's Newton budget, included) took {out['first_call_s']:.1f}"
            f" s; card: {rec['card']}")

        # 3. the receding-horizon loops, then one period split into plan
        # and plant, a synchronise after each
        for solver in ("sqp", "ilqr"):
            argv = ["--solver", solver, "--steps", str(GRAD_LOOP_STEPS),
                    "--out", os.path.join(tmp, f"loop_{solver}.json")]
            rep = loop.main(argv)
            if not rep["all_finite"]:
                raise AssertionError(f"grad loop {solver}: non-finite")
            # the plant's part of a period, timed alone (its plan is the
            # rest of the period)
            args = loop._parser().parse_args(argv)
            pm, cfg, cost_fn, cmd, phys, carry = loop.setup(args, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.control_step(pm, phys, carry.prev_ctrl,
                                cfg.plant_frame_skip,
                                max_contacts=cfg.plant_max_contacts,
                                solver_iterations=cfg.plant_solver_iterations)
            torch.cuda.synchronize()
            plant = time.perf_counter() - t0
            out[f"loop_{solver}"] = dict(rep, plant_s=plant,
                                         plan_s=rep["period_s"] - plant)
            log(f"grad loop {solver} (torch_closed_loop_gradient.main, "
                f"planning model H=20, {GRAD_LOOP_STEPS} of 100 steps, "
                f"0.15 m/s): {rep['period_s']:.3f} s a period (host clock, "
                f"one synchronise at the end): the plant {plant:.3f} s "
                f"(timed alone), the plan the other "
                f"{rep['period_s'] - plant:.3f} s; travelled "
                f"{rep['traveled_xy_m']} m, uprightness min "
                f"{rep['uprightness_min']:.4f}; card: {rec['card']}")

        args = loop._parser().parse_args(["--solver", "sqp"])
        pm, cfg, cost_fn, cmd, phys, carry = loop.setup(args, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, end, (ctrls, sens, costs) = mpc_runtime.delayed_closed_loop(
            pm, cfg, cost_fn, carry, phys, cmd, GRAD_DELAYED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(bool(torch.isfinite(x).all())
                   for x in (ctrls, sens, costs, end.qpos)):
            raise AssertionError("grad delayed loop: non-finite values")
        if not bool((ctrls[0] == carry.prev_ctrl).all()):
            raise AssertionError("grad delayed loop: step 0 did not apply "
                                 "the standing control")
        out["delayed_sqp_period_s"] = wall / GRAD_DELAYED_STEPS
        log(f"grad delayed_closed_loop sqp ({GRAD_DELAYED_STEPS} steps, "
            f"predictor auto = aos): {wall / GRAD_DELAYED_STEPS:.3f} s a "
            f"period; card: {rec['card']}")

    # 4. one gait SQP iteration traced in parts: the linearization, the
    # cost expansion, the QP and the line search, around the settled
    # stance held over the horizon (the kernels do not depend on the
    # trajectory; a rollout of the warm start would cost ~15 s); the
    # linearization and a line-search control step traced for one of
    # their frame_skip substeps (each substep launches the same kernels:
    # the profiler takes ~1-2 ms an event, so a whole iteration, ~1M
    # kernels, would keep it busy for ~20 minutes) and scaled
    t_trace = time.perf_counter()
    m, dt, dev = gait.spec.get_fast_plant_model(), torch.float32, "cuda"
    defaults = gait._parser().parse_args([])
    rcfg, cost_fn, cmd, prev = gait.problem(
        m, dt, torch.device(dev), defaults.horizon, defaults.frame_skip,
        defaults.speed, defaults.smooth_eps)
    cfg = sqp.SQPConfig(rollout=rcfg)
    st0 = gait.settle_state(dt, torch.device(dev))
    us = gait.sine_warm_start(rcfg.horizon, rcfg.frame_skip * m.timestep, dt,
                              dev)
    states = type(st0)(*(x.expand((rcfg.horizon,) + x.shape) for x in st0))
    fs = rcfg.frame_skip
    substep_fn = ilqr._step_fn(m, dataclasses.replace(rcfg, frame_skip=1))
    alphas = torch.as_tensor(cfg.alphas, dtype=dt, device=dev)
    cand0 = type(st0)(*(x.expand((len(cfg.alphas),) + x.shape) for x in st0))
    box = ilqr._ctrl_range(m, us)

    def qp(A, B, quad):
        lx, lxx, lu, luu = quad
        Hqp, g = sqp.condense(sqp.sensitivities(A, B), lx, lxx)
        Hqp, g = sqp._add_control_blocks(Hqp, g, lu, luu)
        H = rcfg.horizon
        return sqp.admm_box_qp(Hqp + cfg.reg * torch.eye(
            H * m.nu, dtype=dt, device=dev), g, box[0].repeat(H) - us.reshape(
            -1), box[1].repeat(H) - us.reshape(-1), cfg.qp_iterations)

    with maths.true_fp32():
        lin_dev, lin_n, (A, B) = traced(lambda: ilqr.ad_linearize(
            m, substep_fn, st0, states, us))
        quad_dev, quad_n, quad = traced(lambda: ilqr.quadratize_cost(
            m, cost_fn, cmd, states, us, prev))
        qp_dev, qp_n, _ = traced(lambda: qp(A, B, quad))
        ls_dev, ls_n, _ = traced(lambda: substep_fn(
            cand0, torch.clamp(us[0] + 0.0 * alphas[:, None], *box)))
    lin_dev, lin_n, ls_dev, ls_n = (fs * lin_dev, fs * lin_n, fs * ls_dev,
                                    fs * ls_n)
    split = out["sqp"]["split_s_per_iteration"]
    H = rcfg.horizon
    it_dev = lin_dev + quad_dev + qp_dev + H * ls_dev
    it_wall = sum(split.values())
    out["trace"] = {
        "linearize": [lin_dev, lin_n], "quadratize": [quad_dev, quad_n],
        "qp": [qp_dev, qp_n], "line_search_step": [ls_dev, ls_n],
        "iteration_device_s": it_dev,
        "iteration_kernels": lin_n + quad_n + qp_n + H * ls_n,
        "idle_share": 1.0 - it_dev / it_wall}
    tr = out["trace"]
    log(f"grad trace (torch.profiler, one gait SQP iteration in parts; device"
        f" time and kernels + copies; the linearization and the line-search "
        f"step from one substep x{fs}): linearize {1e3 * lin_dev:.2f} ms / "
        f"{lin_n} ({1 - lin_dev / split['linearize']:.3f} idle), quadratize "
        f"{1e3 * quad_dev:.2f} ms / {quad_n} "
        f"({1 - quad_dev / split['quadratize']:.3f} idle), qp "
        f"{1e3 * qp_dev:.2f} ms / {qp_n} ({1 - qp_dev / split['qp']:.3f} "
        f"idle), one line-search control step {1e3 * ls_dev:.2f} ms / {ls_n} "
        f"(x{H}: {1 - H * ls_dev / split['line_search']:.3f} idle); the "
        f"iteration {1e3 * it_dev:.1f} ms and {tr['iteration_kernels']} on "
        f"the card against {it_wall:.3f} s: the card idle "
        f"{100 * tr['idle_share']:.1f} % (the trace took "
        f"{time.perf_counter() - t_trace:.1f} s); card: {rec['card']}")
    got = (cuda_engine.launch_counts[ROLLOUT],
           cuda_engine.launch_counts[SUBSTEP])
    if got != (0, 0):
        raise AssertionError(f"grad: {got[0]} fused and {got[1]} substep "
                             "launches (want none)")
    log(f"grad: 0 fused_rollout_cost and 0 substep launches; card: "
        f"{rec['card']}")


def tools_counts(rec, tag, want, phase="tools"):
    """B1 launches since the last reset (substep launches must be none),
    held to ``want``; added to the kernels line's count and to
    ``rec[phase]``'s, and reset."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    got = (cuda_engine.launch_counts[ROLLOUT],
           cuda_engine.launch_counts[SUBSTEP])
    if got != (want, 0):
        raise AssertionError(f"{phase} {tag}: {got[0]} fused and {got[1]} "
                             f"substep launches (want {want} and 0)")
    counts = rec.setdefault("launches", {})
    counts[ROLLOUT] = counts.get(ROLLOUT, 0) + want
    rec[phase].setdefault("launches", {})[tag] = want
    cuda_engine.reset_launch_counts()


def trace_b1(trace_dir) -> int:
    """One B1 launch at the main width (after one untraced warm-up launch)
    under ``profiling.trace`` into ``trace_dir``; prints a JSON line with
    the card's activities the trace saw. ``tools_measure`` runs it in a
    process of its own: late in this script's process, after the earlier
    phases' profiler sessions, the trace of one launch saw 13, 4 and 0 of
    its kernels and copies in runs of the same code on the H100."""
    from torch.autograd import DeviceType

    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.utils import profiling

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    it, lsi = BUDGET["planning"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    state = make_state(m, dtype=dt, device=dev)
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    seqs = random_seqs(gen, S_MAIN, H_MAIN, dt, dev, 0.2)
    cuda_engine.fused_rollout_cost(m, state, seqs, cmd, prev, FRAME_SKIP,
                                   it, lsi)
    torch.cuda.synchronize()
    with profiling.trace(trace_dir) as prof:
        cuda_engine.fused_rollout_cost(m, state, seqs, cmd, prev, FRAME_SKIP,
                                       it, lsi)
    on_card = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    print(json.dumps({
        "device_activities": len(on_card),
        "rollout_kernels": sum("fused_rollout_kernel" in ev.name
                               for ev in on_card),
        "launches": cuda_engine.launch_counts[ROLLOUT]}))
    return 0


def tools_measure(rec, out):
    """(a) ``profiling.measure`` of B1 at the main width, held against its
    roofline (``torch_kernel_roofline.kernel_cost``: the plain version's
    operations by ``profiling.cost_summary``, the fused kernel's true
    bytes); one launch traced into ``chiprun_out/`` by ``trace_b1`` in a
    process of its own, which must see the kernel on the card."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.utils import profiling

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    it, lsi = BUDGET["planning"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    state = make_state(m, dtype=dt, device=dev)
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    seqs = random_seqs(gen, S_MAIN, H_MAIN, dt, dev, 0.2)

    def b1(s):
        return cuda_engine.fused_rollout_cost(m, state, s, cmd, prev,
                                              FRAME_SKIP, it, lsi)

    cost, unfused_step = _script("torch_kernel_roofline").kernel_cost(
        m, S_MAIN, H_MAIN, (it, lsi))
    ops_step = cost.flops / (S_MAIN * H_MAIN)
    nbytes = int(cost.bytes_accessed)
    meas = profiling.measure(b1, seqs, iters=TOOLS_MEASURE_ITERS, cost=cost)
    sol = meas.speed_of_light
    trace_dir = os.path.join(REPO, "chiprun_out", "tools_trace_b1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         f"sys.exit(chip_smoke.trace_b1({trace_dir!r}))"],
        cwd=REPO, capture_output=True, text=True, timeout=TRACE_TIMEOUT_S)
    trace_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"tools (a): the traced launch's process "
                             f"exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    if seen["launches"] != 2 or not seen["rollout_kernels"]:
        raise AssertionError(f"tools (a): the trace saw no B1 kernel on "
                             f"the card ({seen})")
    out["measure"] = {
        "wall_s": meas.wall_s, "speed_of_light": sol,
        "bound_s": cost.roofline_s, "bound": cost.bound,
        "ops_per_rollout_step": ops_step, "true_bytes": nbytes,
        "unfused_bytes_per_rollout_step": unfused_step,
        "trace_dir": trace_dir,
        "trace_device_activities": seen["device_activities"],
        "trace_rollout_kernels": seen["rollout_kernels"],
        "trace_process_s": trace_s}
    log(f"tools (a) profiling.measure B1: planning {it}/{lsi}, S={S_MAIN}, "
        f"H={H_MAIN}, float32: {1e3 * meas.wall_s:.3f} ms a call (host "
        f"clock, {TOOLS_MEASURE_ITERS} calls, synchronised around them); "
        f"roofline {1e3 * cost.roofline_s:.3f} ms ({cost.bound}-bound: "
        f"{ops_step:.0f} ops a rollout step from cost_summary = "
        f"rollout_flops; {nbytes} true bytes); speed_of_light "
        f"{100 * sol:.2f} % (PERF.md §6: 16.41 % from count_ops over CUDA "
        f"events); the plain version's unfused traffic "
        f"{unfused_step:.0f} B a rollout step (an upper bound "
        f"the kernel does not move); trace {trace_dir} "
        f"({seen['device_activities']} device activities, "
        f"{seen['rollout_kernels']} of them B1; its own process, "
        f"{trace_s:.1f} s); card: {rec['card']}")
    return 1 + TOOLS_MEASURE_ITERS


def phase_tools(rec):
    """The ported examples and scripts of the JAX package on the card,
    through their own entry points, and the native library."""
    from quadruped_gym_tpu_torch import native
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.rl import evaluate
    from quadruped_gym_tpu_torch.runtime import checkpoint
    from quadruped_gym_tpu_torch.tasks import walking
    from quadruped_gym_tpu_torch.tasks.rewards import REWARD_KEYS
    from quadruped_gym_tpu_torch.utils.metrics import read_reward_csv

    dev = torch.device("cuda")
    out = rec["tools"] = {}
    tmp = os.path.join(rec["tmp"], "tools")
    os.makedirs(tmp)
    cuda_engine.reset_launch_counts()

    # (a) profiling.measure of B1 at the main width
    tools_counts(rec, "measure", tools_measure(rec, out))

    # (b) the scenario sweep: one B1 launch with DomainParams, twice
    sweep = _example("torch_scenario_sweep").main(SWEEP_S, device=dev,
                                                  seed=SWEEP_SEED)
    costs = sweep.pop("costs")
    if costs.shape != (SWEEP_S,) or not np.isfinite(costs).all():
        raise AssertionError("tools (b): sweep costs of a wrong shape or "
                             "not finite")
    out["sweep"] = dict(sweep, cost_mean=float(costs.mean()),
                        cost_min=float(costs.min()),
                        cost_max=float(costs.max()))
    tools_counts(rec, "sweep", 2)
    log(f"tools (b) torch_scenario_sweep.main({SWEEP_S}): first "
        f"{sweep['first_s']:.3f} s, warm {1e3 * sweep['warm_s']:.3f} ms = "
        f"{sweep['rollouts_per_s']:.1f} scenario-rollouts/s (H=50, 4/8, "
        f"DomainParams with terrain; host clock, synchronised); costs mean "
        f"{costs.mean():.2f}, best {costs.min():.2f}, worst "
        f"{costs.max():.2f}; halves (low/high) "
        + ", ".join(f"{k} {a:.2f}/{b:.2f}"
                    for k, (a, b) in sweep["halves"].items())
        + f"; card: {rec['card']}")

    # (c) the roofline script: the saturation curve and the bounds
    roof_mod = _script("torch_kernel_roofline")
    roof = roof_mod.main([
        "--reps", str(ROOFLINE_REPS), "--seed", "11",
        "--out", os.path.join(tmp, "roofline.json"),
        "--trace", os.path.join(tmp, "roofline_trace")])
    curve = roof["saturation_curve"]
    if not all(np.isfinite(r["device_s"]) and r["device_s"] > 0
               for r in curve):
        raise AssertionError("tools (c): a non-finite time on the curve")
    out["roofline"] = roof
    tools_counts(rec, "roofline",
                 len(curve) * (1 + ROOFLINE_REPS) + 2)
    b = roof["bounds_at_best"]
    log(f"tools (c) torch_kernel_roofline (reps {ROOFLINE_REPS}, CUDA "
        f"events, median): "
        + ", ".join(f"S={r['samples']} {1e3 * r['device_s']:.3f} ms = "
                    f"{r['rollouts_per_s']:.1f}/s" for r in curve)
        + f"; best S={roof['best']['samples']}: "
        f"{100 * b['flop_fraction_of_f32_peak']:.2f} % of the FP32 peak, "
        f"{100 * b['hbm_fraction_true_traffic']:.4f} % of HBM on the true "
        f"{b['true_hbm_bytes_per_solve']} B; kernel "
        f"{roof['kernel'].get('registers')} registers, "
        f"{roof['kernel'].get('local_bytes')} B local, "
        f"{roof['kernel'].get('blocks_per_sm')} blocks/SM; card: "
        f"{rec['card']}")

    # (d) the random rollout: 50 oracle substeps on mpc_plant
    t0 = time.perf_counter()
    rr = _example("torch_random_rollout").main([
        "--seconds", str(RANDOM_ROLLOUT_S),
        "--plot", os.path.join(tmp, "joint_angles.png")])
    wall = time.perf_counter() - t0
    n_sub = rr["sensors"].shape[0]
    if rr["sensors"].shape != (int(round(RANDOM_ROLLOUT_S / 0.002)), 33) \
            or not np.isfinite(rr["sensors"]).all():
        raise AssertionError("tools (d): random rollout sensors of a wrong "
                             "shape or not finite")
    out["random_rollout"] = {"substeps": n_sub, "wall_s": wall,
                             "final_height": rr["final_height"]}
    tools_counts(rec, "random_rollout", 0)
    log(f"tools (d) torch_random_rollout --seconds {RANDOM_ROLLOUT_S}: "
        f"{n_sub} oracle substeps (mpc_plant, 12 contacts, 4 passes, "
        f"float32) in {wall:.2f} s = {1e3 * wall / n_sub:.2f} ms a substep "
        f"(host clock, the plot included); final base height "
        f"{rr['final_height']:.4f} m; card: {rec['card']}")

    # (e) the latency demo: the controller on the card, the plant process
    # on the CPU over the shm bus
    t0 = time.perf_counter()
    lat = _example("torch_latency_demo").main(
        LATENCY_ARGS + ["--out", os.path.join(tmp, "latency.json")])
    wall = time.perf_counter() - t0
    loop = lat["two_process_loop"]
    k = lat["pipelined_solve"]["k"]
    if not (np.isfinite(lat["sync_solve"]["p50_ms"])
            and np.isfinite(lat["pipelined_solve"]["amortized_ms"])
            and loop["periods"] > 0 and loop["plant_stdout"]):
        raise AssertionError("tools (e): latency report incomplete")
    out["latency"] = dict(lat, wall_s=wall)
    tools_counts(rec, "latency", 1 + 2 * k + loop["periods"])
    log(f"tools (e) torch_latency_demo {' '.join(LATENCY_ARGS)}: sync solve "
        f"p50 {lat['sync_solve']['p50_ms']:.2f} ms, p90 "
        f"{lat['sync_solve']['p90_ms']:.2f} ms; pipelined "
        f"{lat['pipelined_solve']['amortized_ms']:.2f} ms a solve (K={k}); "
        f"launch + synchronise overhead "
        f"{lat['launch_sync_overhead_ms_estimate']:.2f} ms; loop p50 "
        f"{loop['p50_ms']:.2f} ms over {loop['periods']} periods, "
        f"{loop['deadline_misses']} deadline misses of "
        f"{loop['deadline_ms']:.0f} ms; plant: {loop['plant_stdout']}; the "
        f"call {wall:.1f} s; card: {rec['card']}")

    # (f) the eval report on the committed policy, cut in time
    t0 = time.perf_counter()
    report = _script("torch_eval_report").main([
        "--policy", POLICY, "--out", os.path.join(tmp, "eval"),
        "--seeds", "0", "--max-time", str(TOOLS_EVAL_MAX_TIME)])
    wall = time.perf_counter() - t0
    eps = report["episodes"]
    if len(eps) != 2 or not all(np.isfinite(e["episode_return"])
                                for e in eps):
        raise AssertionError("tools (f): eval report incomplete")
    out["eval_report"] = {"episodes": eps, "wall_s": wall}
    tools_counts(rec, "eval_report", 0)
    log(f"tools (f) torch_eval_report --seeds 0 --max-time "
        f"{TOOLS_EVAL_MAX_TIME}: "
        + ", ".join(f"{e['mode']} return {e['episode_return']:.3f} in "
                    f"{e['steps']} steps" for e in eps)
        + f"; the call {wall:.1f} s; card: {rec['card']}")

    # (g) the export of a trainer checkpoint, read back bit for bit
    run = rec.get("train_run")
    if run is None:  # the train phase did not run: a short run of its own
        from quadruped_gym_tpu_torch.rl import train

        run = os.path.join(tmp, "train_run")
        train.main(["--output", run, "--iterations", "1", "--num-envs",
                    "64", "--num-steps", "2", "--timesteps-per-iteration",
                    "128", "--no-eval"])
    ckpt = os.path.join(run, "policy")
    params = os.path.join(tmp, "policy_params")
    _script("torch_export_policy").main(["--ckpt", ckpt, "--out", params])
    arrays, step = checkpoint.read(ckpt)
    exported, step2 = checkpoint.read(params)
    obs_dim = walking.obs_size(walking.WalkingConfig(obs_window=10,
                                                     partial_obs=True),
                               spec.get_mpc_plant_model())
    net = evaluate.load_policy(params, obs_dim, dev)
    if step2 != step or len(exported) != len(net.state_dict()) or not all(
            np.array_equal(exported[f"leaf_{i}"], arrays[f"leaf_{i}"])
            for i in range(len(exported))):
        raise AssertionError("tools (g): the export is not the trainer's "
                             "network")
    for i, v in enumerate(net.state_dict().values()):
        if not np.array_equal(v.cpu().numpy(), arrays[f"leaf_{i}"]):
            raise AssertionError("tools (g): the exported policy does not "
                                 "load back bit for bit")
    out["export"] = {"leaves": len(exported), "step": step}
    tools_counts(rec, "export", 0)
    log(f"tools (g) torch_export_policy: {len(exported)} leaves at "
        f"iteration {step} from the trainer's checkpoint, loaded back on the "
        f"card through rl.evaluate.load_policy equal in every bit")

    # (h) the native logger: built, 20,000 rows, and the trainer's CSV
    lib = native.load()
    if lib is None:
        raise AssertionError("tools (h): the native library did not build")
    rows = np.random.RandomState(0).randn(NATIVE_ROWS, len(REWARD_KEYS))
    path = os.path.join(tmp, "native.csv")
    t0 = time.perf_counter()
    lg = native.NativeRewardLogger(path, REWARD_KEYS)
    lg.log_many(0, rows)
    lg.flush()
    dropped = lg.dropped
    lg.close()
    wall = time.perf_counter() - t0
    steps, _, comp, _ = read_reward_csv(path)
    if dropped != 0 or list(steps) != list(range(NATIVE_ROWS)) or \
            not np.allclose(comp, rows, rtol=1e-9, atol=0):
        raise AssertionError(f"tools (h): native logger dropped {dropped} "
                             "rows or wrote other values")
    csv_path = os.path.join(run, "rewards_continuous.csv")
    if not native_written(csv_path):
        raise AssertionError("tools (h): the trainer's CSV was not written "
                             "by the native logger")
    out["native"] = {"rows": NATIVE_ROWS, "dropped": dropped, "wall_s": wall,
                     "library": native.library_path()}
    tools_counts(rec, "native", 0)
    log(f"tools (h) native: {native.library_path()} built and loaded; "
        f"NativeRewardLogger {NATIVE_ROWS} rows in {1e3 * wall:.1f} ms, "
        f"dropped {dropped}; the trainer's CSV ({csv_path}) is the native "
        f"writer's, byte for byte")
    log(f"tools: {sum(out['launches'].values())} fused_rollout_cost launches "
        f"({out['launches']}), 0 substep launches; card: {rec['card']}")


def phase_research(rec):
    """The JAX package's research scripts on the card through the port's
    ``main``s, each cut as the ``RESEARCH_*`` constants say, with the B1
    launches each must make."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    out = rec["research"] = {}
    tmp = os.path.join(rec["tmp"], "research")
    os.makedirs(tmp)
    cuda_engine.reset_launch_counts()

    # (a) the latency parts: the solve part launches B1 once a call
    parts_mod = _script("torch_latency_parts")
    reps = parts_mod._parser().parse_args(RESEARCH_PARTS_ARGS).reps
    t0 = time.perf_counter()
    parts = parts_mod.main(RESEARCH_PARTS_ARGS)
    wall = time.perf_counter() - t0
    if not all(np.isfinite(p["ms"]) and p["ms"] > 0 for p in parts["parts"]):
        raise AssertionError(f"research (a): a part's time {parts['parts']}")
    out["parts"] = dict(parts, wall_s=wall)
    tools_counts(rec, "parts", 1 + reps * RESEARCH_K, "research")
    log(f"research (a) torch_latency_parts {' '.join(RESEARCH_PARTS_ARGS)}: "
        + ", ".join(f"{p['part']} {p['ms']:.3f} ms" for p in parts["parts"])
        + f"; sum {parts['sum_ms']:.3f} ms (host clock, K={parts['k']} calls "
        f"a synchronise); the call {wall:.1f} s; card: {rec['card']}")

    # (b) the latency report: the closed-loop fit, the controller's work
    # and the 100 Hz split, B1 against the lane route's operations
    t0 = time.perf_counter()
    rep = _script("torch_latency_report").main(
        RESEARCH_REPORT_ARGS + ["--out", os.path.join(tmp, "budget.json")])
    wall = time.perf_counter() - t0
    loop, split = rep["closed_loop_sim"], rep["split_100hz"]
    roof = rep["fused_kernel_roofline"]
    if not (all(np.isfinite(v) and v > 0 for v in loop["loop_s_by_N"].values())
            and np.isfinite(loop["device_time_per_control_step_ms"])
            and all(np.isfinite(split[k]) for k in ("predict_ms", "solve_ms",
                                                    "plant_ms"))
            and roof["analytic_flops"] > roof["rollout_flops"] > 0):
        raise AssertionError("research (b): latency report incomplete")
    out["report"] = dict(rep, wall_s=wall)
    ns = RESEARCH_REPORT_NS
    # one solve a period: the warm-up at the first N, one timed loop at
    # each; the controller's, the solve's and B1's K calls (one repetition)
    # each after an untimed one; one blocking solve, its warm-up and 3
    # timed
    tools_counts(rec, "report", ns[0] + sum(ns) + 3 * (1 + RESEARCH_K) + 4,
                 "research")
    ctl = rep["controller_realtime"]
    fit = ", ".join(f"N={n} {t:.3f} s" for n, t in loop["loop_s_by_N"].items())
    log(f"research (b) torch_latency_report {' '.join(RESEARCH_REPORT_ARGS)}"
        f": T(N) {fit} -> slope "
        f"{loop['device_time_per_control_step_ms']:.2f} ms a period, "
        f"intercept {loop['dispatch_intercept_ms']:.2f} ms; controller "
        f"{ctl['work_per_period_ms']:.2f} ms a period (predict "
        f"{split['predict_ms']:.2f} + solve {split['solve_ms']:.2f}); 100 Hz "
        f"split against {split['budget_ms']:.0f} ms: predict "
        f"{split['predict_ms']:.2f}, solve {split['solve_ms']:.2f}, plant "
        f"{split['plant_ms']:.2f} ms ({split['within_budget']}); trivial "
        f"launch + synchronise "
        f"{rep['launch_sync']['trivial_launch_sync_ms']:.4f} ms, one "
        f"blocking solve {rep['launch_sync']['single_blocking_solve_ms']:.2f}"
        f" ms; B1 at S={roof['samples']}: {1e3 * roof['wall_s']:.3f} ms = "
        f"{roof['rollouts_per_s']:.1f} rollouts/s, "
        f"{100 * roof['rollout_flops_fraction_of_f32_peak']:.2f} % of the "
        f"FP32 peak on its plain version's (the leg engine's) "
        f"{roof['rollout_flops']:.4e} operations (on the JAX script's "
        f"unfused denominator, the lane route's "
        f"{roof['analytic_flops']:.4e}: "
        f"{100 * roof['mfu_fraction_of_f32_peak']:.2f} %); the call "
        f"{wall:.1f} s; card: {rec['card']}")

    # (c) the sweep, beside the tools phase's roofline curve
    t0 = time.perf_counter()
    sweep = _script("torch_latency_sweep").main(
        ["--k", str(RESEARCH_SWEEP_K)])
    wall = time.perf_counter() - t0
    rows = sweep["rows"]
    if not all(np.isfinite(r["per_solve_ms"]) and r["per_solve_ms"] > 0
               for r in rows):
        raise AssertionError("research (c): a non-finite time")
    out["sweep"] = dict(sweep, wall_s=wall)
    tools_counts(rec, "sweep", len(rows) * (1 + 3 * RESEARCH_SWEEP_K),
                 "research")
    curve = {r["samples"]: 1e3 * r["device_s"] for r in
             rec.get("tools", {}).get("roofline", {}).get(
                 "saturation_curve", [])}
    log(f"research (c) torch_latency_sweep --k {RESEARCH_SWEEP_K} (host "
        f"clock, median of 3): "
        + ", ".join(f"S={r['samples']} {r['per_solve_ms']:.3f} ms "
                    f"({r['grid']} x {r['threads']} threads"
                    + (f"; roofline {curve[r['samples']]:.3f}"
                       if r["samples"] in curve else "") + ")"
                    for r in rows)
        + f"; best S={sweep['best']['samples']} "
        f"{sweep['best']['rollouts_per_s']:.1f} rollouts/s; the call "
        f"{wall:.1f} s; card: {rec['card']}")

    # (d) diag_gait: one SQP iteration in stages (the oracle engine), with
    # each linearization; the FD run reuses the AD run's settled stance
    for lin in ("ad", "fd"):
        args = ["--horizon", str(RESEARCH_DIAG_H), "--linearize", lin]
        t0 = time.perf_counter()
        diag = _script("torch_diag_gait").main(args)
        wall = time.perf_counter() - t0
        bad = {k: s for k, s in diag["stats"].items()
               if s["nan"] or s["inf"]}
        if bad or not np.isfinite(diag["cost0"]) or not all(
                np.isfinite(r["cost"]) for r in diag["line_search"]):
            raise AssertionError(f"research (d) {lin}: non-finite stages "
                                 f"{bad}")
        key = f"diag_gait_{lin}"
        out[key] = {k: v for k, v in diag.items() if k != "arrays"}
        out[key]["wall_s"] = wall
        tools_counts(rec, key, 0, "research")
        log(f"research (d) torch_diag_gait {' '.join(args)} (fast plant, "
            f"float32, eps {diag['eps']:g}): cost0 {diag['cost0']:.3f}; |A| "
            f"{diag['stats']['A']['max_abs']:.3e}, |B| "
            f"{diag['stats']['B']['max_abs']:.3e}, ||A_t...A_0|| "
            f"{['%.1e' % n for n in diag['A_product_norms']]}; eig(Hqp) "
            f"{diag['eig_min']:.3e} .. {diag['eig_max']:.3e} (cond "
            f"{diag['cond']:.2e}); ||du|| {diag['du_norm']:.3e}, g'du "
            f"{diag['pred_decrease']:.3e}; line search "
            + ", ".join(f"{r['alpha']}: {r['cost']:.4f}"
                        for r in diag["line_search"])
            + "; stages " + ", ".join(f"{k} {v:.2f} s"
                                      for k, v in diag["seconds"].items())
            + f"; settle {diag['settle_s']:.1f} s; the call {wall:.1f} s; "
            f"card: {rec['card']}")

    # (e) the budget study, cut in steps: the verdict is reported, the
    # cases must be finite and upright
    study_mod = _script("torch_full_plant_budget_study")
    t0 = time.perf_counter()
    study = study_mod.main(["--steps", str(RESEARCH_STUDY_STEPS),
                            "--out", os.path.join(tmp, "study.json")])
    wall = time.perf_counter() - t0
    for r in study["cases"]:
        nums = [v for v in r.values() if isinstance(v, float)]
        if not np.isfinite(nums).all() or r["flipped"] or \
                r["min_uprightness"] <= WALK_LIMITS["upright"]:
            raise AssertionError(f"research (e): case {r}")
    out["study"] = dict(study, wall_s=wall)
    # one launch an MPPI iteration, each step of each case
    tools_counts(rec, "study", len(study_mod.CASES) * RESEARCH_STUDY_STEPS
                 * study_mod.mpc_config(2, 4).mppi.iterations, "research")
    v = study["verdict"]
    log(f"research (e) torch_full_plant_budget_study --steps "
        f"{RESEARCH_STUDY_STEPS}: "
        + "; ".join(f"{r['budget']} nsec {r['n_secondary']}: vel error "
                    f"{r['mean_vel_error']:.4f} m/s, forward "
                    f"{r['forward_m']:+.4f} m, upright min "
                    f"{r['min_uprightness']:.4f}, {r['wall_s']:.1f} s"
                    for r in study["cases"])
        + f"; verdict: spread {v['max_vel_error_spread_vs_4_8']:.4f} m/s, "
        f"equivalent {v['equivalent']} (not gated at this depth); the call "
        f"{wall:.1f} s; card: {rec['card']}")
    log(f"research: {sum(out['launches'].values())} fused_rollout_cost "
        f"launches ({out['launches']}), 0 substep launches; card: "
        f"{rec['card']}")


def native_written(path) -> bool:
    """Whether a reward CSV is the native writer's output, byte for byte:
    its rows printed again from the values they hold, the step as
    ``%llu`` and every number as ``%.10g`` (telemetry.cc), give the file.
    The Python logger prints each number's full repr instead."""
    with open(path) as f:
        lines = f.read().split("\n")
    if len(lines) < 3 or lines[-1] != "":
        return False
    for line in lines[1:-1]:
        step, *nums = line.split(",")
        again = ",".join([str(int(step))]
                         + ["%.10g" % float(x) for x in nums])
        if again != line:
            return False
    return True


def traced(fn):
    """(device seconds, device activities, ``fn()``) under
    ``torch.profiler``: the summed durations and the number of the kernels
    and copies the card ran for it. The profiler slows the host, so the
    wall time of a traced call is not used."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the card's activity only: recording every host op as well doubled
    # the events the profiler has to turn into Python objects
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    device_s = 1e-6 * sum(ev.time_range.elapsed_us() for ev in on_card)
    return device_s, len(on_card), out


def bound(m, it, lsi, S, H, fs=FRAME_SKIP):
    """(bound_ms, bound_by, ops per rollout step): the plain version's
    operations (``cuda_engine.count_ops``) over the FP32 peak vs the
    bytes in and out over the HBM rate."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    per_step = cuda_engine.rollout_flops(m, 1, fs, it, lsi)
    ops = per_step * H * S
    nbytes = 4 * (S * H * m.nu + S + m.nq + m.nv + m.na + m.nu + 5)
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", per_step)


def phase_time(rec, iters=5, plain_h=2, seed=7):
    """The headline rollouts/s of both plants from ``torch_bench.py``
    (host clock, through ``lane_batched_rollout_cost(engine_impl=
    "fused")``, its launches counted), then per plant the kernel's own
    time on the card (CUDA events around direct launches), its plain
    version and its bound."""
    import torch_bench
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state

    cuda_engine.reset_launch_counts()
    t0 = time.perf_counter()
    bench = torch_bench.main(["--plant", "both", "--seed", str(seed)])
    bench_s = time.perf_counter() - t0
    n_bench = cuda_engine.launch_counts[ROLLOUT]
    want = 2 * (torch_bench.ITERS + 1)
    if n_bench != want or cuda_engine.launch_counts[SUBSTEP]:
        raise AssertionError(f"torch_bench launched {cuda_engine.launch_counts}"
                             f", want {want} of {ROLLOUT} and none else")
    counts = rec.setdefault("launches", {})
    counts[ROLLOUT] = counts.get(ROLLOUT, 0) + n_bench
    rec["bench"] = bench
    log(f"time torch_bench: {bench_s:.1f} s, {n_bench} launches of "
        f"{ROLLOUT} (2 plants x (1 warm-up + {torch_bench.ITERS} solves))")

    dev, dt = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    rec["timing"] = {}
    for model, rps in (("planning", bench["value"]),
                       ("fast_plant", bench["full_plant_rollouts_per_s"])):
        m = getattr(spec, f"get_{model}_model")()
        it, lsi = BUDGET[model]
        state = make_state(m, dtype=dt, device=dev)

        def run(seqs, fn=cuda_engine.fused_rollout_cost):
            return fn(m, state, seqs, cmd, prev, FRAME_SKIP, it, lsi)

        all_seqs = [random_seqs(gen, S_MAIN, H_MAIN, dt, dev, 0.2)
                    for _ in range(iters + 1)]
        run(all_seqs[-1])  # warm-up
        torch.cuda.synchronize()
        dev_ms = []
        for seqs in all_seqs[:iters]:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            costs = run(seqs)
            e1.record()
            torch.cuda.synchronize()
            dev_ms.append(e0.elapsed_time(e1))
            if not bool(torch.isfinite(costs).all()):
                raise AssertionError(f"{model}: non-finite costs")
        # the plain version at a cut horizon, scaled to H=50
        short = all_seqs[0][:, :plain_h].contiguous()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        run(short, cuda_engine.fused_rollout_cost_reference)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1) * H_MAIN / plain_h
        bound_ms, bound_by, per_step = bound(m, it, lsi, S_MAIN, H_MAIN)
        row = {"rollouts_per_s": rps,
               "ms": float(np.median(dev_ms)), "ms_each": dev_ms,
               "plain_ms": plain_ms, "plain_h": plain_h,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ops_per_rollout_step": per_step, "budget": [it, lsi]}
        rec["timing"][model] = row
        log(f"time {model} ({it}/{lsi}): {rps:.1f} rollouts/s "
            f"(torch_bench: S={S_MAIN}, H={H_MAIN}, frame_skip {FRAME_SKIP}"
            f", float32; host clock, synchronised per solve); kernel "
            f"{row['ms']:.3f} ms median (CUDA events, {iters} direct "
            f"launches) = {S_MAIN / row['ms'] * 1e3:.1f} rollouts/s; plain "
            f"version {plain_ms:.1f} ms (H={plain_h} scaled "
            f"x{H_MAIN // plain_h}); bound {bound_ms:.3f} ms by {bound_by} "
            f"({per_step:.0f} ops per rollout step); card: {rec['card']}")
    phase_time_loop_shape(rec, gen, cmd, prev)
    phase_time_substep(rec)


def phase_time_loop_shape(rec, gen, cmd, prev, iters=5):
    """B1 at the closed loop's shape (the ``loop`` phase's planner: 1,024
    rollouts, H=20, budget 4/8, planning model), CUDA events per launch,
    against its bound."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state

    dev, dt = torch.device("cuda"), torch.float32
    walk = _example("torch_closed_loop_walk").mpc_config().mppi
    S, H, fs = walk.num_samples, walk.rollout.horizon, walk.rollout.frame_skip
    it, lsi = walk.lane_newton_iterations, walk.lane_ls_iterations
    m = spec.get_planning_model()
    state = make_state(m, dtype=dt, device=dev)
    seqs = random_seqs(gen, S, H, dt, dev, 0.2)
    ms = event_ms(lambda: cuda_engine.fused_rollout_cost(
        m, state, seqs, cmd, prev, fs, it, lsi), iters)
    bound_ms, bound_by, per_step = bound(m, it, lsi, S, H, fs)
    row = {"S": S, "H": H, "budget": [it, lsi], "ms": float(np.median(ms)),
           "ms_each": ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "ops_per_rollout_step": per_step}
    row["share"] = bound_ms / row["ms"]
    rec["timing"]["loop_shape"] = row
    log(f"time B1 at the loop's shape: planning {it}/{lsi}, S={S}, H={H}, "
        f"frame_skip {fs}, float32: {row['ms']:.3f} ms median of {iters} "
        f"launches (CUDA events); bound {bound_ms:.4f} ms by {bound_by} "
        f"({per_step:.0f} ops per rollout step): {100 * row['share']:.2f} % "
        f"of it; card: {rec['card']}")


def event_ms(fn, iters):
    """Per-call CUDA-event times of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def phase_time_substep(rec, iters=5, seed=8):
    """``control_step`` per launch at the widths of its two main paths,
    its plain version on the same inputs, and its bound."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev, dt = torch.device("cuda"), torch.float32
    rec["substep_timing"] = {}
    for label, model, B, fs in (("planning", "planning", S_MAIN, FRAME_SKIP),
                                ("fast_plant", "fast_plant", S_MAIN,
                                 FRAME_SKIP),
                                ("env", "fast_plant", N_ENVS,
                                 ENV_FRAME_SKIP)):
        m = getattr(spec, f"get_{model}_model")()
        it, lsi = BUDGET[model]
        ls, ctrl = lane_inputs(m, "grounded", B, np.random.default_rng(seed),
                               dt, dev)
        ms = event_ms(lambda: cuda_engine.control_step(m, ls, ctrl, fs, it,
                                                       lsi), iters)
        plain = event_ms(lambda: cuda_engine.control_step_reference(
            m, ls, ctrl, fs, it, lsi), 1)
        ops = cuda_engine.substep_flops(m, fs, it, lsi)
        geo = geometry_of(cuda_engine.SUBSTEP_SOURCE, m, dt, B)
        nbytes = 4 * B * (2 * (m.nq + m.nv + m.na) + m.nu + m.nsensordata)
        t_ops, t_bytes = B * ops / PEAK_FP32, nbytes / PEAK_BYTES
        row = {"B": B, "frame_skip": fs, "budget": [it, lsi],
               "ms": float(np.median(ms)), "ms_each": ms,
               "plain_ms": plain[0], "ops_per_lane": ops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "blocks": geo.grid, "threads": geo.threads}
        rec["substep_timing"][label] = row
        log(f"time substep {label}: {model} {it}/{lsi}, B={B}, frame_skip "
            f"{fs}, float32: control_step {row['ms']:.3f} ms median of "
            f"{iters} (CUDA events); plain version {plain[0]:.1f} ms; bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({ops:.0f} ops "
            f"and {nbytes // B} bytes per lane); {row['blocks']} blocks of "
            f"{geo.threads} threads on 132 SMs; card: {rec['card']}")
    for label in ("planning", "fast_plant"):
        fused = rec["timing"][label]["ms"] / H_MAIN
        per_launch = rec["substep_timing"][label]["ms"]
        log(f"time fused vs per-control-step, {label}: one control step of "
            f"{S_MAIN} rollouts takes {fused:.3f} ms inside the fused "
            f"kernel and {per_launch:.3f} ms as one substep-kernel launch; "
            f"card: {rec['card']}")
    k = rec["substep_timing"]["planning"]["ms"] * H_MAIN / 1e3
    if "custom_plan_s" in rec:
        solve = float(np.median(rec["custom_plan_s"][1:]))
        log(f"time custom-cost MPPI solve: {solve:.4f} s median of periods "
            f"1.. ({S_MAIN / solve:.1f} rollouts/s; S={S_MAIN}, H={H_MAIN}); "
            f"{H_MAIN} substep launches take {k:.4f} s of it "
            f"({100 * k / solve:.1f} %); CEM solve {rec['cem_solve_s']:.4f} s"
            f" for 3 iterations; card: {rec['card']}")
        rec["custom_solve_s"] = solve
        rec["custom_rollouts_per_s"] = S_MAIN / solve
    if "env_steps_per_s" in rec:
        e = rec["substep_timing"]["env"]["ms"]
        log(f"time env: {rec['env_steps_per_s']:.1f} env-steps/s at "
            f"{N_ENVS} envs ({rec['env_step_ms']:.3f} ms per step, of which "
            f"the kernel {e:.3f} ms, {100 * e / rec['env_step_ms']:.1f} %); "
            f"card: {rec['card']}")


def kernels_line(rec) -> dict:
    t = rec.get("timing", {}).get("planning", {})
    u = rec.get("substep_timing", {}).get("planning", {})
    launches = rec.get("launches", {})
    csrc = "quadruped_gym_tpu_torch/ops/csrc/"

    def row(name, source, replaces, err, times):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches.get(name),
                "max_abs_err": rec.get(err), "ms": times.get("ms"),
                "plain_ms": times.get("plain_ms"),
                "bound_ms": times.get("bound_ms"),
                "bound_by": times.get("bound_by"), "library_ms": None}

    return {"kernels": [
        row(ROLLOUT, "rollout_kernel.cu",
            "quadruped_gym_tpu/ops/pallas_engine.py:249",
            "max_abs_err_main_shape", t),
        row(SUBSTEP, "substep_kernel.cu",
            "quadruped_gym_tpu/ops/pallas_engine.py:86",
            "substep_max_abs_err_main_shape", u),
        row("po_window", "observation_kernel.cu", None,
            "observation_max_abs_err", rec.get("observation_timing", {})),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--json-out", default=None,
                    help="also write every number to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        rec = {"tmp": tmp}
        phase_device(rec)
        for name in PHASES[1:]:
            if name in phases:
                t0 = time.perf_counter()
                globals()[f"phase_{name}"](rec)
                log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    log(f"card: {rec['card']}")
    log(json.dumps(kernels_line(rec)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
