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

MODELS = ("planning", "fast_plant", "mpc_plant", "full")
# how the JAX package builds the model each snapshot holds
JAX_MODELS = {
    "planning": jspec.get_planning_model,
    "fast_plant": jspec.get_fast_plant_model,
    "mpc_plant": lambda: jspec.get_model(
        collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES),
    "full": jspec.get_model,
}


def _pair(name):
    return JAX_MODELS[name](), getattr(tspec, f"get_{name}_model")()


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


@pytest.mark.parametrize("name", MODELS)
def test_snapshot_equals_jax_model(name):
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
             for name, m in ((n, getattr(tspec, f"get_{n}_model")())
                             for n in MODELS)}
    assert sizes["mpc_plant"] == (12, 2272)
    assert sizes["full"] == (25, 6256)
    assert sizes["planning"][0] == 4 and sizes["fast_plant"][0] == 12
    plant = tspec.get_mpc_plant_model()
    assert all(n.startswith(tspec.MPC_COLLISION_PREFIXES)
               for n in plant.col_geom_names)
    assert tspec.get_full_model() is tspec.get_full_model()  # loaded once


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
