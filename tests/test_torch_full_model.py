"""The ``full`` collision model (every mesh of the MJCF with its hull: the
frame and four hip servos on the base, femurs, knee servos, shins, feet
and ankle servos) through the leg-batched engine, float64 on the CPU.

The leg engine takes the base's geoms as groups of their own (the hip
servos one geom a leg, each with its own frame; the frame one geom that
leg 0's lanes carry) whose rows touch only the free dofs. It is held to
the lane engine, a formulation of another structure, at 1e-10 from
states where the base's groups touch the ground; the models it took
before are held bit for bit to the frozen copy of the engine they ran
on (``benchmark/reference/leg_engine.py``); the kernels' plain versions
and routes take ``full`` without a fallback."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from benchmark.reference import leg_engine as frozen_leg
from benchmark.reference import spec as frozen_spec
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import cuda_engine, lane_engine
from quadruped_gym_tpu_torch.ops import leg_engine as LE
from quadruped_gym_tpu_torch.solvers import rollout
from quadruped_gym_tpu_torch.tasks import commands, walking
from torch_models import incompatible_full

F64 = torch.float64
FIELDS = ("qpos", "qvel", "act", "sensordata", "time")
HOLD = [0.0, 0.0, -0.5] * 4
M = spec.get_full_model()


def _state(m, B, z, seed, speed=0.1):
    """B lanes near ``qpos0``, moving, the base at height ``z`` (0.03: the
    hip servos touch; 0.0: the frame too)."""
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0)[:, None] + 0.05 * rng.standard_normal((m.nq, B))
    qpos[2] = z
    t = lambda x: torch.as_tensor(x, dtype=F64)  # noqa: E731
    ls = lane_engine.LaneState(
        t(qpos), t(speed * rng.standard_normal((m.nv, B))),
        t(np.tile(np.array(HOLD)[:, None], (1, B))), t(np.zeros(B)),
        t(np.zeros((m.nsensordata, B))))
    ctrl = t(np.array([0.1, -0.1, -0.5] * 4)[:, None]
             + 0.1 * rng.standard_normal((m.nu, B)))
    return ls, ctrl


def _active_base_slots(m, ls):
    """(hip-servo slots, frame slots) active in the leg engine's collision."""
    q_free = [ls.qpos[i] for i in range(7)]
    q_leg = [ls.qpos[LE._Q_IDX[k]] for k in range(3)]
    slots = LE._collide_loop(m, LE._fk(m, q_free, q_leg))
    count = lambda lv: sum(int(a.sum()) for _, _, a, level, _, _ in slots  # noqa: E731
                           if level == lv)
    return count(LE.BASE), count(LE.BASE_ONE)


def _assert_close(got, want, tol=1e-10, sensor_tol=None):
    """The state at ``tol``, the sensors at ``sensor_tol`` (``tol`` if
    None): the accelerometer reads a small difference of large contact
    and gravity accelerations in deep contact, where rounding shows at
    ~1e-9."""
    for f in FIELDS:
        t = sensor_tol if f == "sensordata" and sensor_tol else tol
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=t, atol=t, msg=f)


def test_groups_of_full():
    """Five leg groups, then the hip servos (member l at leg l's hip
    mount) and the frame; the JAX package's leg engine refuses it."""
    ls = LE._leg_static(M)
    assert [lv for lv, _ in ls.col_groups] == [0, 0, 1, 2, 2, LE.BASE,
                                              LE.BASE_ONE]
    hips = np.asarray(M.body_pos)[list(ls.leg_bodies[0])]
    _, servos = ls.col_groups[5]
    pos = np.asarray(M.col_geom_pos)[list(servos)]
    near = np.argmin(((pos[:, None, :2] - hips[None, :, :2]) ** 2).sum(-1), 1)
    assert list(near) == [0, 1, 2, 3]
    assert ls.col_groups[6][1] == (0,)  # the frame
    assert all(M.col_geom_bodyid[g] == ls.base for g in servos + (0,))
    assert cuda_engine.slot_budgets(M) == [2, 2, 2, 3, 2, 2, 2]
    assert cuda_engine.model_slots(M) == 15


def _branched(m):
    """Leg 1's ankle body hung under leg 0's knee body."""
    parent = list(m.body_parentid)
    parent[7] = 3
    return dataclasses.replace(m, body_parentid=tuple(parent))


def _geom_on_world(m):
    bodies = list(m.col_geom_bodyid)
    bodies[0] = 0
    return dataclasses.replace(m, col_geom_bodyid=tuple(bodies))


@pytest.mark.parametrize("make,match", [
    (incompatible_full, "body_mass differs across legs"),
    (lambda: _branched(M), "leg chain"),
    (lambda: _geom_on_world(M), "outside the base and the leg chains"),
])
def test_incompatible_models_are_refused(make, match):
    m = make()
    assert not LE.is_compatible(m)
    with pytest.raises(LE.IncompatibleModelError, match=match):
        LE._leg_static(m)


@pytest.mark.parametrize("name", ["planning", "fast_plant", "mpc_plant",
                                  "feet"])
def test_models_without_base_groups_are_bit_identical(name):
    """The engine's results on the models it took before are the frozen
    copy's in every bit, with and without DomainParams."""
    tm, rm = spec.get_snapshot(name), frozen_spec.get_snapshot(name)
    ls, ctrl = _state(tm, 6, 0.03, seed=len(name))
    dp = spec.sample_domain_params(
        torch.Generator().manual_seed(3), 6, friction_range=(0.4, 0.8),
        gain_range=(0.8, 1.2), mass_range=(0.9, 1.5), tilt_range=(-0.1, 0.1),
        terrain_amp_range=(0.0, 0.02), dtype=F64)
    for d in (None, dp):
        got = LE.control_step(tm, ls, ctrl, 2, 4, 8, dp=d)
        want = frozen_leg.control_step(rm, ls, ctrl, 2, 4, 8, dp=d)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (name, f)


def test_leg_engine_matches_lane_engine_on_full():
    """Three substeps from the lane engine's contact case of ``full``
    (pressed to 3 cm: hip servos, femurs and knee servos touch), and one
    from the base pressed to the floor (the frame touches too)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "snapshot_torch_lane_refs.py")
    sp = importlib.util.spec_from_file_location("snapshot_lane_refs", path)
    case = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(case)
    batched, ctrl = case.case_inputs("full_contact")
    ls = lane_engine.from_batched(*(torch.as_tensor(x) for x in batched))
    ctrl = torch.as_tensor(ctrl)
    assert _active_base_slots(M, ls)[0] > 0
    _assert_close(LE.control_step(M, ls, ctrl, 3, 4, 8),
                  lane_engine.control_step(M, ls, ctrl, 3, 4, 8))
    # pressed into the floor, 30 hip-servo slots active
    ls, ctrl = _state(M, 4, 0.0, seed=5, speed=0.02)
    servos, frame = _active_base_slots(M, ls)
    assert servos > 0 and frame > 0
    _assert_close(LE.step(M, ls, ctrl, 4, 8), lane_engine.step(M, ls, ctrl, 4, 8),
                  sensor_tol=1e-9)


def test_domain_params_on_full_match_an_edited_model():
    """DomainParams friction, base mass and tilt, one value for the batch,
    on the leg engine against the lane engine on the model those values
    describe (the lane engine takes no DomainParams; the terrain, which no
    model describes, is held to the kernel's host build in
    tests/test_torch_full_kernels.py)."""
    ls, ctrl = _state(M, 4, 0.03, seed=7)
    fr, mass, tx, ty = 0.6, 1.2, 0.05, -0.03
    full = lambda v: torch.full((4,), v, dtype=F64)  # noqa: E731
    dp = spec.DomainParams(friction=full(fr), base_mass_scale=full(mass),
                           tilt_x=full(tx), tilt_y=full(ty))
    b = LE._leg_static(M).base
    friction = np.array(M.col_friction, copy=True)
    friction[:, 0] = fr
    body_mass = np.array(M.body_mass, copy=True)
    body_mass[b] *= mass
    inertia = np.array(M.body_inertia, copy=True)
    inertia[b] *= mass
    n = np.array([-tx, -ty, 1.0]) / np.sqrt(tx * tx + ty * ty + 1.0)
    edited = dataclasses.replace(M, col_friction=friction, body_mass=body_mass,
                                 body_inertia=inertia, plane_normal=n)
    assert _active_base_slots(M, ls)[0] > 0
    _assert_close(LE.control_step(M, ls, ctrl, 2, 4, 8, dp=dp),
                  lane_engine.control_step(edited, ls, ctrl, 2, 4, 8),
                  sensor_tol=1e-9)


def test_kernels_plain_versions_match_lane_engine_on_full():
    """``cuda_engine.control_step`` and ``fused_rollout_cost`` on CPU
    tensors (the kernels' plain versions) against the lane engine's
    control step and rollouts, from a state where the hip servos touch."""
    ls, ctrl = _state(M, 4, 0.03, seed=9)
    _assert_close(cuda_engine.control_step(M, ls, ctrl, 2, 4, 8),
                  lane_engine.control_step(M, ls, ctrl, 2, 4, 8))
    from quadruped_gym_tpu_torch.physics.engine import State

    st = State(ls.qpos[:, 0], ls.qvel[:, 0], ls.act[:, 0], ls.time[0],
               ls.sensordata[:, 0])
    rng = np.random.default_rng(4)
    seqs = torch.as_tensor(np.clip(np.array(HOLD) + 0.3 * rng.standard_normal(
        (4, 2, 12)), -1, 1))
    cmd = commands.make(torch.tensor([0.2, 0.1], dtype=F64),
                        torch.tensor(0.3, dtype=F64))
    prev = torch.tensor(HOLD, dtype=F64)
    got = cuda_engine.fused_rollout_cost(M, st, seqs, cmd, prev, 2, 4, 8)
    cfg = rollout.RolloutConfig(horizon=2, frame_skip=2)
    want = rollout.lane_batched_rollout_cost(
        M, cfg, rollout.make_cost_fn(M), st, seqs, cmd, prev,
        engine_impl="lane", newton_iterations=4, ls_iterations=8)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_no_route_falls_back_on_full():
    """Every route takes the leg-batched engine or its kernels on
    ``full``, without a warning."""
    from quadruped_gym_tpu_torch.envs import vector_env
    from quadruped_gym_tpu_torch.ops import leg_engine

    assert walking.batched_engine(M, "pallas") is cuda_engine
    assert walking.batched_engine(M, "auto") is leg_engine
    cfg = walking.WalkingConfig(max_time=1.0, frame_skip=1,
                                solver_iterations=2, dtype=F64)
    st, _ = walking.reset(M, cfg, 2, torch.Generator().manual_seed(0))
    action = torch.zeros((2, 12), dtype=F64)
    ls, _ = _state(M, 2, 0.03, seed=1)
    from quadruped_gym_tpu_torch.physics.engine import State

    st0 = State(ls.qpos[:, 0], ls.qvel[:, 0], ls.act[:, 0], ls.time[0],
                ls.sensordata[:, 0])
    seqs = torch.as_tensor(np.tile(np.array(HOLD), (2, 1, 1)))
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=F64),
                        torch.tensor(0.0, dtype=F64))
    prev = torch.tensor(HOLD, dtype=F64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for impl in ("auto", "leg", "pallas"):
            vector_env.batched_autoreset_step(
                M, cfg, st, action, torch.Generator().manual_seed(1),
                engine_impl=impl)
        for impl in ("leg", "pallas", "fused"):
            rollout.lane_batched_rollout_cost(
                M, rollout.RolloutConfig(horizon=1, frame_skip=1),
                rollout.make_cost_fn(M), st0, seqs, cmd, prev,
                engine_impl=impl, newton_iterations=2, ls_iterations=4)
