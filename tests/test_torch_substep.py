"""The substep kernel's wrappers (``cuda_engine.step`` / ``control_step``),
float64 on the CPU.

Three links hold the CUDA kernel to the JAX package's Pallas substep
kernel without a card:

* the port's wrappers, which on CPU tensors run the kernel's plain
  version, against the JAX kernel's body. ``pallas_engine._substep_kernel``
  is ``leg_engine._step_impl`` with ``collide_fn=_collide_loop`` and
  ``const_full=True`` on a state whose sensordata is zeros, and
  ``pallas_engine.step`` adds ``timestep`` to ``time`` outside it; the
  helper below runs exactly that, eagerly (the interpret-mode
  ``pallas_call`` itself costs many minutes of XLA compile, which is why
  tests/test_pallas_engine.py is in the slow tier). Tolerances are those
  of tests/test_torch_leg_engine.py: qpos rtol 1e-12, qvel 1e-10, act
  1e-14, sensordata 1e-10, time exact;
* the kernel's device code built for the host with g++
  (``tests/torch_host_rollout.cpp``) against the plain version, all 33
  sensors and the state: float64 rtol 1e-8, float32 1e-4;
* on a card, the kernel itself against the plain version
  (``chip_smoke.py``, and the ``cuda``-marked test in
  tests/test_torch_cuda_engine.py, which imports no JAX).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_lib
from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.ops import lane_engine as jlane
from quadruped_gym_tpu.ops import leg_engine as jleg
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.ops import leg_engine as tleg
from quadruped_gym_tpu_torch.ops.lane_engine import LaneState

B = 8
TOL = {"qpos": (1e-12, 1e-13), "qvel": (1e-10, 1e-11),
       "act": (1e-14, 1e-15), "sensordata": (1e-10, 1e-11)}


def _models(name):
    return (getattr(jspec, f"get_{name}_model")(),
            getattr(tspec, f"get_{name}_model")())


def _inputs(m, seed, kind, batch=B):
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0)[None] + 0.05 * rng.standard_normal(
        (batch, m.nq))
    if kind == "airborne":
        qpos[:, 2] += 0.5
    elif kind == "low":  # shins and ankle servos near the ground
        qpos[:, 2] = 0.03
    qvel = 0.1 * rng.standard_normal((batch, m.nv))
    act = np.tile([0.0, 0.0, -0.5] * 4, (batch, 1))
    ctrl = (np.array([0.1, -0.1, -0.5] * 4)[:, None]
            + 0.1 * rng.standard_normal((12, batch)))
    # a stale sensordata and a running clock: neither may leak through
    sens = rng.standard_normal((batch, m.nsensordata))
    time = 0.25 + 0.002 * np.arange(batch)
    return (qpos, qvel, act, time, sens), ctrl


def _dp_np(seed, batch=B):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, batch)  # noqa: E731
    return jspec.DomainParams(
        friction=u(0.4, 0.8), gain_scale=u(0.8, 1.2),
        base_mass_scale=u(0.9, 1.5), tilt_x=u(-0.1, 0.1),
        tilt_y=u(-0.1, 0.1), terrain_amp=u(0.0, 0.02),
        terrain_freq=u(15.0, 30.0))


def _jax_kernel_step(m, ls, ctrl, it, lsi, dp=None, compute_sensors=True):
    """What ``pallas_engine.step`` computes: ``_substep_kernel``'s body and
    the wrapper's time update (pallas_engine.py:86-109, 165-171)."""
    zeroed = ls._replace(time=jnp.zeros_like(ls.time),
                         sensordata=jnp.zeros_like(ls.sensordata))
    out = jleg._step_impl(m, zeroed, ctrl, it, lsi,
                          compute_sensors=compute_sensors,
                          collide_fn=jleg._collide_loop, const_full=True,
                          dp=dp if dp is not None else jspec.DomainParams())
    return out._replace(time=ls.time + m.timestep)


def _jax_kernel_control_step(m, ls, ctrl, fs, it, lsi, dp=None):
    """``pallas_engine.control_step`` (:174-196)."""
    for _ in range(fs - 1):
        ls = _jax_kernel_step(m, ls, ctrl, it, lsi, dp, compute_sensors=False)
    return _jax_kernel_step(m, ls, ctrl, it, lsi, dp)


def _both(name, kind, seed, dp=None):
    jm, tm = _models(name)
    batched, ctrl = _inputs(jm, seed, kind)
    jls = jlane.from_batched(*(jnp.asarray(x) for x in batched))
    tls = convert.lane_state(jls, device="cpu")
    jdp = None if dp is None else jspec.DomainParams(
        *(None if v is None else jnp.asarray(v) for v in dp))
    tdp = None if dp is None else convert.domain_params(dp, device="cpu")
    return jm, tm, jls, tls, jnp.asarray(ctrl), torch.as_tensor(ctrl), jdp, tdp


def _assert_close(want, got):
    for f, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    np.testing.assert_allclose(got.time.numpy(), np.asarray(want.time),
                               rtol=0, atol=0)


# --------------------------------------------------------------------------
# the wrappers (plain version on the CPU) against the JAX kernel's body


@pytest.mark.parametrize("name,kind,with_dp", [
    ("planning", "airborne", False), ("planning", "grounded", False),
    ("planning", "grounded", True), ("fast_plant", "low", False),
])
def test_step_matches_jax_kernel(name, kind, with_dp):
    dp = _dp_np(3) if with_dp else None
    jm, tm, jls, tls, jc, tc, jdp, tdp = _both(
        name, kind, sum(map(ord, name + kind)), dp)
    with jax.disable_jit():
        want = _jax_kernel_step(jm, jls, jc, 4, 8, jdp)
    got = cuda_engine.step(tm, tls, tc, 4, 8, dp=tdp)
    _assert_close(want, got)
    assert float(got.sensordata.abs().max()) > 0.0


def test_step_without_sensors_returns_zeros():
    """The TPU kernel returns zeros in sensordata, where the eager engine
    passes the old sensordata through."""
    jm, tm, jls, tls, jc, tc, _, _ = _both("planning", "grounded", 21)
    with jax.disable_jit():
        want = _jax_kernel_step(jm, jls, jc, 4, 8, compute_sensors=False)
    got = cuda_engine.step(tm, tls, tc, 4, 8, compute_sensors=False)
    _assert_close(want, got)
    assert float(jnp.abs(want.sensordata).max()) == 0.0
    assert float(got.sensordata.abs().max()) == 0.0
    eager = tleg._step_impl(tm, tls, tc, 4, 8, compute_sensors=False)
    assert float(eager.sensordata.abs().max()) > 0.0  # the stale one
    torch.testing.assert_close(got.qpos, eager.qpos, rtol=0, atol=0)


@pytest.mark.parametrize("name,kind,fs,with_dp", [
    ("planning", "grounded", 3, True), ("fast_plant", "low", 2, False),
])
def test_control_step_matches_jax_kernel(name, kind, fs, with_dp):
    dp = _dp_np(4) if with_dp else None
    jm, tm, jls, tls, jc, tc, jdp, tdp = _both(name, kind, 31 + fs, dp)
    with jax.disable_jit():
        want = _jax_kernel_control_step(jm, jls, jc, fs, 4, 8, jdp)
    got = cuda_engine.control_step(tm, tls, tc, fs, 4, 8, dp=tdp)
    _assert_close(want, got)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    _, tm, _, tls, _, tc, _, _ = _both("planning", "grounded", 5)
    cuda_engine.reset_launch_counts()
    got = cuda_engine.control_step(tm, tls, tc, 2, 2, 4)
    ref = cuda_engine.control_step_reference(tm, tls, tc, 2, 2, 4)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cuda_engine.launch_counts["substep"] == 0
    meta = LaneState(*(x.to("meta") for x in tls))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_engine.step(tm, meta, tc.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_engine.control_step(tm, meta, tc.to("meta"), 2)


def test_sensor_table_follows_the_model():
    """No sensor address is hard-wired: the packed table is the model's."""
    for name in ("planning", "fast_plant"):
        tm = _models(name)[1]
        P = cuda_engine.pack_model(tm, torch.float64)
        assert P.nsensordata == tm.nsensordata == 33
        assert P.nsensor == len(tm.sensors)
        for i, sn in enumerate(tm.sensors):
            assert (P.sens_kind[i], P.sens_adr[i]) == (sn.kind, sn.adr)
            if sn.kind == tspec.SENSOR_JOINTPOS:
                assert P.sens_joint[i] == tm.jnt_qposadr[sn.objid] - 7


def test_sensor_table_refuses_unknown_kinds():
    import dataclasses

    tm = _models("planning")[1]
    odd = list(tm.sensors)
    odd[12] = dataclasses.replace(odd[12], kind=99)  # the accelerometer
    bad = dataclasses.replace(tm, sensors=tuple(odd))
    with pytest.raises(tleg.IncompatibleModelError, match="not supported"):
        cuda_engine.pack_model(bad, torch.float64)
    gap = dataclasses.replace(tm, sensors=tm.sensors[:12] + tm.sensors[13:])
    with pytest.raises(tleg.IncompatibleModelError, match="tile sensordata"):
        cuda_engine.pack_model(gap, torch.float64)


def test_substep_flops():
    m = _models("planning")[1]
    one = cuda_engine.substep_flops(m, 1, 2, 4, sensors=False)
    with_sens = cuda_engine.substep_flops(m, 1, 2, 4, sensors=True)
    five = cuda_engine.substep_flops(m, 5, 2, 4, sensors=True)
    assert one > 1e4 and 0 < with_sens - one < 1000
    assert five == pytest.approx(4 * one + with_sens, rel=1e-12)
    # the fused rollout's control step is these substeps plus a stage cost
    assert 0 < cuda_engine.rollout_flops(m, 1, 5, 2, 4) - five < 1000
    assert cuda_engine.substep_flops(m, 1, 4, 8) > with_sens


# --------------------------------------------------------------------------
# the kernel's own source, built for the host


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_lib.build(tmp_path_factory.mktemp("host"))


def _host_substeps(lib, m, ls, ctrl, nsub, it, lsi, dp=None,
                   compute_sensors=True, n_store=None, split=1):
    """The substep kernel's body built for the host in the card's form:
    4 x ``split`` threads a robot (``split`` replicas of a quad), each
    replica's outputs along a leading axis; lanes from ``n_store`` on run
    but store nothing."""
    dt = ls.qpos.dtype
    P = cuda_engine.pack_model(m, dt)
    n = ls.qpos.shape[1]
    lanes = [None if dp is None else getattr(dp, k)
             for k in cuda_engine._DP_ORDER]
    lanes = [None if v is None else v.to(dt).contiguous() for v in lanes]
    ptrs = (ctypes.c_void_p * 7)(*[0 if v is None else v.data_ptr()
                                   for v in lanes])
    ins = [x.contiguous() for x in (ls.qpos, ls.qvel, ls.act, ctrl.to(dt))]
    outs = [torch.full((split,) + x.shape, float("nan"), dtype=dt)
            for x in ins[:3]]
    sens = torch.full((split, m.nsensordata, n), float("nan"), dtype=dt)
    name = "qg_host_substeps_{}".format(
        "f64" if dt == torch.float64 else "f32")
    err = getattr(lib, name)(
        ctypes.addressof(P), *[x.data_ptr() for x in ins], ptrs,
        *[x.data_ptr() for x in outs], sens.data_ptr(), n,
        n if n_store is None else n_store, nsub, it, lsi,
        int(compute_sensors), split)
    assert err == 0
    return outs[0], outs[1], outs[2], sens


def _lane_inputs(name, kind, seed, dtype, batch, with_dp):
    tm = _models(name)[1]
    batched, ctrl = _inputs(tm, seed, kind, batch)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)  # noqa: E731
    ls = LaneState(qpos=t(batched[0].T), qvel=t(batched[1].T),
                   act=t(batched[2].T), time=t(batched[3]),
                   sensordata=t(batched[4].T))
    dp = None
    if with_dp:
        dp = convert.domain_params(_dp_np(seed, batch), dtype=dtype,
                                   device="cpu")
    return tm, ls, t(ctrl), dp


@pytest.mark.parametrize("name,kind,nsub,with_dp", [
    ("planning", "grounded", 1, False),
    ("planning", "grounded", 4, False),
    ("planning", "airborne", 4, True),
    ("planning", "grounded", 1, True),
    ("fast_plant", "low", 1, False),
    ("fast_plant", "low", 4, True),
])
def test_host_substeps_match_plain_version(host_lib, name, kind, nsub,
                                           with_dp):
    """All 33 sensors and the state after ``nsub`` substeps, float64,
    rtol = atol = 1e-8 (the operation order differs in places)."""
    tm, ls, ctrl, dp = _lane_inputs(name, kind, 7 + nsub, torch.float64, 13,
                                    with_dp)
    ref = cuda_engine.control_step_reference(tm, ls, ctrl, nsub, 4, 8, dp)
    got = [x[0] for x in _host_substeps(host_lib, tm, ls, ctrl, nsub, 4, 8,
                                        dp)]
    for g, f in zip(got, ("qpos", "qvel", "act", "sensordata")):
        np.testing.assert_allclose(g.numpy(), getattr(ref, f).numpy(),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    assert float(got[3].abs().min()) >= 0.0  # no NaN left: every row written


def test_host_substeps_without_sensors(host_lib):
    tm, ls, ctrl, _ = _lane_inputs("planning", "grounded", 2, torch.float64,
                                   5, False)
    ref = cuda_engine.step_reference(tm, ls, ctrl, 4, 8,
                                     compute_sensors=False)
    got = [x[0] for x in _host_substeps(host_lib, tm, ls, ctrl, 1, 4, 8,
                                        compute_sensors=False)]
    np.testing.assert_allclose(got[1].numpy(), ref.qvel.numpy(), rtol=1e-8,
                               atol=1e-8)
    assert float(got[3].abs().max()) == 0.0 == float(
        ref.sensordata.abs().max())


@pytest.mark.parametrize("name,kind,budget", [
    ("planning", "grounded", (2, 4)), ("fast_plant", "grounded", (4, 8))])
def test_host_substeps_float32(host_lib, name, kind, budget):
    """float32 against the float32 plain version over one control step of
    4 substeps: rounding (~6e-8 an operation) amplified through the
    contact solve. The accelerometer reads the solved acceleration
    (hundreds of m/s^2 in contact), hence the relative part; rtol = atol =
    1e-4 is what chip_smoke.py holds the card to as well."""
    tm, ls, ctrl, _ = _lane_inputs(name, kind, 17, torch.float32, 16, False)
    ref = cuda_engine.control_step_reference(tm, ls, ctrl, 4, *budget)
    got = [x[0] for x in _host_substeps(host_lib, tm, ls, ctrl, 4, *budget)]
    for g, f in zip(got, ("qpos", "qvel", "act", "sensordata")):
        np.testing.assert_allclose(g.numpy(), getattr(ref, f).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("name,kind,nsub,with_dp,sensors,dtype", [
    ("planning", "grounded", 2, True, True, torch.float64),
    ("planning", "grounded", 1, False, False, torch.float64),
    ("fast_plant", "low", 2, False, True, torch.float64),
    ("fast_plant", "low", 2, True, True, torch.float32),
])
def test_host_quad_substeps_store_only_their_lanes(host_lib, name, kind,
                                                   nsub, with_dp, sensors,
                                                   dtype):
    """The card's form at split 1 (a quad of threads per lane: the base
    rows and base-site sensors written by the thread of leg 0, each
    joint's rows and position sensor by its leg's thread): the last two
    lanes run but must store nothing, as threads past the ragged edge of a
    block do, and the lanes before them equal those of a run that stores
    every lane in every bit, within 1e-8 (float64) or 1e-4 (float32) of
    the plain version."""
    n, keep = 6, 4
    tm, ls, ctrl, dp = _lane_inputs(name, kind, 23 + nsub, dtype, n, with_dp)
    every = [x[0] for x in _host_substeps(host_lib, tm, ls, ctrl, nsub, 4, 8,
                                          dp, sensors)]
    quad = [x[0] for x in _host_substeps(host_lib, tm, ls, ctrl, nsub, 4, 8,
                                         dp, sensors, n_store=keep)]
    for w, q in zip(every, quad):
        np.testing.assert_array_equal(q[:, :keep].numpy(),
                                      w[:, :keep].numpy())
        assert bool(torch.isnan(q[:, keep:]).all())
    if not sensors:
        assert float(quad[3][:, :keep].abs().max()) == 0.0
    _assert_plain(tm, ls, ctrl, nsub, dp, sensors, every)


def _assert_plain(tm, ls, ctrl, nsub, dp, sensors, got):
    """``got`` (qpos, qvel, act, sensordata) within 1e-8 (float64) or 1e-4
    (float32) of the plain version after ``nsub`` substeps; the sensors
    only when they were computed."""
    ref = cuda_engine.control_step_reference(tm, ls, ctrl, nsub, 4, 8, dp)
    tol = 1e-8 if ls.qpos.dtype == torch.float64 else 1e-4
    fields = ("qpos", "qvel", "act", "sensordata")[:4 if sensors else 3]
    for g, f in zip(got, fields):
        np.testing.assert_allclose(
            g.numpy(), getattr(ref, f)[:, :g.shape[1]].numpy(), rtol=tol,
            atol=tol, err_msg=f)


@pytest.mark.parametrize("name,kind,nsub,with_dp,sensors,dtype,split", [
    ("planning", "grounded", 2, True, True, torch.float64, 2),
    ("planning", "grounded", 1, False, False, torch.float64, 4),
    ("planning", "grounded", 2, False, True, torch.float32, 4),
    ("fast_plant", "low", 2, False, True, torch.float64, 4),
    ("fast_plant", "low", 1, True, True, torch.float64, 2),
    ("fast_plant", "low", 2, True, True, torch.float32, 2),
    ("fast_plant", "grounded", 2, False, True, torch.float32, 4),
])
def test_host_split_substeps_match_split_one(host_lib, name, kind, nsub,
                                             with_dp, sensors, dtype, split):
    """Replicas (``split`` quads a lane, each scanning a share of every
    hull and sharing the winners, every replica writing the same rows into
    its leg's one column): every replica's state and sensors equal split
    1's in every bit, so the card's outputs do not depend on the split,
    and split 1 is within 1e-8 (float64) or 1e-4 (float32) of the plain
    version. The last lane runs but stores nothing."""
    n, keep = 3, 2
    tm, ls, ctrl, dp = _lane_inputs(name, kind, 31 + split + nsub, dtype, n,
                                    with_dp)
    one = [x[0] for x in _host_substeps(host_lib, tm, ls, ctrl, nsub, 4, 8,
                                        dp, sensors, n_store=keep)]
    reps = _host_substeps(host_lib, tm, ls, ctrl, nsub, 4, 8, dp, sensors,
                          n_store=keep, split=split)
    for o, r in zip(one, reps):
        assert r.shape[0] == split
        for q in r:
            np.testing.assert_array_equal(q.numpy(), o.numpy())
            assert bool(torch.isnan(q[:, keep:]).all())
    _assert_plain(tm, ls, ctrl, nsub, dp, sensors,
                  [x[:, :keep] for x in one])
