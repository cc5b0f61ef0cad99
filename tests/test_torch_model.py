"""The port's model snapshots, commands and stage-cost primitives against
the JAX package (float64, CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu.tasks import rewards as jrewards
from quadruped_gym_tpu_torch import _device, convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.tasks import commands as tcommands
from quadruped_gym_tpu_torch.tasks import rewards as trewards

MODELS = ("planning", "fast_plant", "mpc_plant", "full", "fast_plant_nsec32",
          "feet")
# case -> (the JAX package's model, the port's): the snapshots by name, the
# decimated models through the getters' keywords
CASES = {
    "planning": (jspec.get_planning_model, tspec.get_planning_model),
    "planning_64": (lambda: jspec.get_planning_model(64),
                    lambda: tspec.get_planning_model(64)),
    "fast_plant": (jspec.get_fast_plant_model, tspec.get_fast_plant_model),
    "fast_plant_nsec16": (
        lambda: jspec.get_fast_plant_model(n_secondary=16),
        lambda: tspec.get_fast_plant_model(n_secondary=16)),
    "fast_plant_nsec_none": (
        lambda: jspec.get_fast_plant_model(n_secondary=None),
        lambda: tspec.get_fast_plant_model(n_secondary=None)),
    "fast_plant_ndir96": (
        lambda: jspec.get_fast_plant_model(n_directions=96),
        lambda: tspec.get_fast_plant_model(n_directions=96)),
    "mpc_plant": (lambda: jspec.get_model(
        collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES),
        tspec.get_mpc_plant_model),
    "full": (jspec.get_model, tspec.get_full_model),
    "fast_plant_nsec32": (
        lambda: jspec.get_fast_plant_model(n_secondary=32),
        lambda: tspec.get_fast_plant_model(n_secondary=32)),
    "feet": (lambda: jspec.get_model(
        collision_geom_prefixes=jspec.FEET_COLLISION_PREFIXES),
        lambda: tspec.get_snapshot("feet")),
}


def _pair(name):
    jax_model, port_model = CASES[name]
    return jax_model(), port_model()


def _assert_field_equal(name, a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert a.dtype.kind == b.dtype.kind, name
        assert np.array_equal(a, b), name
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_field_equal(f"{name}[{i}]", x, y)
    else:
        assert type(a) is type(b) or (
            isinstance(a, (int, float)) and isinstance(b, (int, float))), name
        assert a == b, name


@pytest.mark.parametrize("name", list(CASES))
def test_snapshot_equals_jax_model(name):
    """Field by field: the snapshots, and the decimated models the port
    derives from them with the JAX package's ``decimate_hulls``."""
    jm, tm = _pair(name)
    for f in dataclasses.fields(jspec.PhysicsModel):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if f.name == "sensors":
            assert [dataclasses.astuple(s) for s in a] == [
                dataclasses.astuple(s) for s in b]
        else:
            _assert_field_equal(f.name, a, b)
    assert [f.name for f in dataclasses.fields(jspec.PhysicsModel)] == [
        f.name for f in dataclasses.fields(tspec.PhysicsModel)]


def test_collision_sets():
    assert tspec.MPC_COLLISION_PREFIXES == jspec.MPC_COLLISION_PREFIXES
    assert tspec.FEET_COLLISION_PREFIXES == jspec.FEET_COLLISION_PREFIXES
    sizes = {name: (len(m.col_hull_verts),
                    sum(len(v) for v in m.col_hull_verts))
             for name, m in ((n, tspec.get_snapshot(n)) for n in MODELS)}
    assert sizes["mpc_plant"] == (12, 2272)
    assert sizes["full"] == (25, 6256)
    assert sizes["planning"][0] == 4 and sizes["fast_plant"][0] == 12
    plant = tspec.get_mpc_plant_model()
    assert all(n.startswith(tspec.MPC_COLLISION_PREFIXES)
               for n in plant.col_geom_names)
    assert tspec.get_full_model() is tspec.get_full_model()  # loaded once


def test_fast_plant_decimations():
    """``n_secondary`` decimates the shins and ankle servos: 32 shrinks only
    the ankle-servo hulls (47 -> 18 vertices); the feet and shins keep
    theirs, and so the contact slots a leg and the kernels' launch
    geometry stay. Any other count builds too (16: JAX's model)."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    m64, m32 = (tspec.get_fast_plant_model(n_secondary=n) for n in (64, 32))
    assert m64 is tspec.get_fast_plant_model()
    assert m32 is tspec.get_snapshot("fast_plant_nsec32")
    counts = {n: [len(v) for v in m.col_hull_verts]
              for n, m in ((64, m64), (32, m32))}
    for name, a, b in zip(m64.col_geom_names, counts[64], counts[32]):
        want = (47, 18) if name.startswith("ankle_servo") else (a, a)
        assert (a, b) == want, name
    assert cuda_engine.slot_budgets(m32) == cuda_engine.slot_budgets(m64)
    assert (cuda_engine.launch_geometry(cuda_engine.model_slots(m32),
                                        torch.float32, 1024)
            == cuda_engine.launch_geometry(cuda_engine.model_slots(m64),
                                           torch.float32, 1024))
    m16 = tspec.get_fast_plant_model(n_secondary=16)
    want = jspec.get_fast_plant_model(n_secondary=16)
    for a, b in zip(want.col_hull_verts, m16.col_hull_verts):
        assert np.array_equal(a, b)
    assert m16 is tspec.get_fast_plant_model(n_secondary=16)  # cached


def test_save_load_roundtrip(tmp_path):
    m = tspec.get_fast_plant_model()
    path = str(tmp_path / "m.npz")
    tspec.save_model(m, path)
    back = tspec.load_model(path)
    for f in dataclasses.fields(tspec.PhysicsModel):
        _assert_field_equal(f.name, getattr(m, f.name), getattr(back, f.name))
    assert back.sensor_adr("body_vel") == m.sensor_adr("body_vel")


def test_sample_domain_params():
    g = torch.Generator().manual_seed(0)
    dp = tspec.sample_domain_params(g, 64, tilt_range=(-0.1, 0.1),
                                    terrain_amp_range=(0.0, 0.02),
                                    dtype=torch.float64)
    ranges = dict(friction=(0.4, 0.8), gain_scale=(0.8, 1.2),
                  base_mass_scale=(0.9, 1.5), tilt_x=(-0.1, 0.1),
                  tilt_y=(-0.1, 0.1), terrain_amp=(0.0, 0.02),
                  terrain_freq=(15.0, 30.0))
    for f, (lo, hi) in ranges.items():
        v = getattr(dp, f)
        assert v.shape == (64,) and v.dtype == torch.float64, f
        assert bool((v >= lo).all() and (v <= hi).all()), f
    nominal = tspec.sample_domain_params(g, 8, friction_range=None)
    assert nominal.friction is None and nominal.tilt_x is None
    assert nominal.terrain_amp is None and nominal.terrain_freq is None
    assert nominal.gain_scale.dtype == torch.float32


def test_resolve_device(monkeypatch):
    assert _device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve_device(None)


@pytest.mark.parametrize("vel,theta", [((0.2, 0.1), 0.3), ((0.0, 0.0), 0.0),
                                       ((-0.4, 0.25), -2.0)])
def test_command_make(vel, theta):
    jc = jcommands.make(jnp.asarray(vel, jnp.float64),
                        jnp.asarray(theta, jnp.float64))
    tc = tcommands.make(torch.tensor(vel, dtype=torch.float64),
                        torch.tensor(theta, dtype=torch.float64))
    via = convert.command(jc, device="cpu")
    for f in tcommands.Command._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
        np.testing.assert_array_equal(getattr(via, f).numpy(),
                                      np.asarray(getattr(jc, f)))


def test_reward_primitives_match():
    jm, tm = _pair("planning")
    jsl, tsl = jrewards.SensorSlices.from_model(jm), \
        trewards.SensorSlices.from_model(tm)
    assert tuple(jsl) == tuple(tsl)
    np.testing.assert_array_equal(trewards.JOINT_CENTERS,
                                  jrewards.JOINT_CENTERS)
    rng = np.random.default_rng(0)
    B = 6
    sens = rng.standard_normal((B, jm.nsensordata))
    sens[0, tsl.vel:tsl.vel + 2] = 0.0  # the guarded zero-velocity branch
    ctrl = rng.uniform(-1, 1, (B, 12))
    jc = jcommands.make(jnp.asarray([0.2, 0.1]), jnp.asarray(0.3))
    tc = convert.command(jc, device="cpu")
    ts = torch.as_tensor(sens.T.copy())  # (33, B): lanes minor
    tu = torch.as_tensor(ctrl.T.copy())
    got = {
        "dir": trewards.progress_direction_reward_local(ts, tsl, tc),
        "speed": trewards.progress_speed_cost_local(ts, tsl, tc),
        "heading": trewards.heading_reward(ts, tsl, tc),
        "orient": trewards.orientation_reward(ts, tsl),
        "height": trewards.body_height_cost(ts, tsl, 0.13),
        "posture": trewards.joint_posture_cost(tu),
    }
    for b in range(B):
        s, u = jnp.asarray(sens[b]), jnp.asarray(ctrl[b])
        want = {
            "dir": jrewards.progress_direction_reward_local(s, jsl, jc),
            "speed": jrewards.progress_speed_cost_local(s, jsl, jc),
            "heading": jrewards.heading_reward(s, jsl, jc),
            "orient": jrewards.orientation_reward(s, jsl),
            "height": jrewards.body_height_cost(s, jsl, 0.13),
            "posture": jrewards.joint_posture_cost(u),
        }
        for k, v in want.items():
            np.testing.assert_allclose(got[k][b].item(), float(v),
                                       rtol=1e-14, atol=1e-15, err_msg=k)
    x = rng.standard_normal((2, B))
    x[:, 0] = 0.0
    for b in range(B):
        np.testing.assert_allclose(
            trewards.unit(torch.as_tensor(x[:, b])).numpy(),
            np.asarray(jrewards.unit(jnp.asarray(x[:, b]))), rtol=1e-15)
    np.testing.assert_allclose(
        trewards.exp_dist(torch.tensor(0.3, dtype=torch.float64)).item(),
        float(jrewards.exp_dist(jnp.asarray(0.3, jnp.float64))), rtol=1e-15)
    assert trewards.alive_bonus(torch.float64).item() == 1.0
