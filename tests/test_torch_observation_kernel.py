"""The partial-observation kernel (``ops/csrc/observation_kernel.cu``) and
its wrapper ``cuda_engine.po_window``.

The kernel's device code (``csrc/po_observation.cuh``) is plain C++ over
one env and one block: ``tests/torch_host_observation.cpp`` compiles it
with g++ into a small library of its own, and the tests hold that build,
fed the wrapper's own views and strides (``_po_window_args``), to the
plain version: ``observations.po_observation`` and then ``stack_push`` or
``stack_fill``. The tests marked ``cuda`` run the kernel on a card."""

import numpy as np
import pytest
import torch

import torch_host_lib

from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.tasks import commands, observations
from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices

SL = SensorSlices.from_model(spec.get_planning_model())
SETTLING = 1.0  # the filter runs from time 0.5 on
DT = 0.02
W = 10  # the trainer's window

# Tolerances of the computed entries (the filter quaternion, the Euler
# angles and the heading; every other entry is a copy and must be equal).
# The kernel and the plain version do the same operations in the same
# order, but the plain version's 3- and 4-term norms are PyTorch
# reductions, which may sum in another order, and its atan2 and asin
# (vectorised on the CPU) may differ from the C library's by an ulp; the
# card besides fuses multiplies and adds. float64: that rounding, ~1e-16
# relative, through a normalisation and an atan2, stays far below 1e-12.
# float32: a few ulp (2**-23 ~ 1.2e-7), relative and, for angles near 0,
# absolute. The Euler angles take more where they are ill conditioned
# (``_euler_tol``).
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
       torch.float32: dict(rtol=8 * 2.0**-23, atol=8 * 2.0**-23)}


def _euler_tol(quat, dtype):
    """(N, 1) absolute tolerances of the Euler angles of unit quaternions
    ``quat``: ``atol`` / sqrt(1 - s**2), s = 2 (w y - z x) the sine of the
    pitch. That is how far a change of ``atol`` in s moves its asin, and
    in the atan2s of roll and yaw, whose arguments have the norm sqrt(1 -
    s**2). Near gimbal lock (|s| -> 1) the floor ``atol`` / 2 on 1 - s**2
    caps it at sqrt(2 atol), asin(1) - asin(1 - atol)."""
    a = TOL[dtype]["atol"]
    w, x, y, z = quat.double().unbind(-1)
    s = 2.0 * (w * y - z * x)
    return (a / torch.sqrt(torch.clamp_min(1.0 - s * s, a / 2.0)))[:, None]


def _inputs(n, dtype, seed, device="cpu"):
    """``po_window``'s arguments for N envs as the env step holds them:
    sensordata read through the transpose of the lane state's (33, N), the
    filter quaternion as the view ``qpos[:, 3:7]``, times on both sides of
    ``SETTLING / 2``. Where N >= 4: env 0 has zero gyro, env 1 zero accel,
    env 2 both, env 3 sits at exactly ``SETTLING / 2`` (the filter holds
    still), and env 4's quaternion is not normalised."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    lanes = rng.standard_normal((33, n))
    lanes[SL.accel + 2] += 9.81
    qpos = rng.standard_normal((n, 19))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    time = rng.uniform(0.0, 1.0, n)
    if n >= 4:
        lanes[SL.gyro:SL.gyro + 3, [0, 2]] = 0.0
        lanes[SL.accel:SL.accel + 3, [1, 2]] = 0.0
        time[:3] = 0.75
        time[3] = SETTLING / 2.0
        qpos[4 % n, 3:7] *= 1.3
    cmd = commands.make(t(rng.uniform(-0.5, 0.5, (n, 2))),
                        t(rng.uniform(-3.0, 3.0, n)))
    carry = observations.PoObsCarry(mad_quat=t(qpos)[:, 3:7],
                                    buffer=t(rng.standard_normal((n, W, 26))))
    return (SL, t(lanes).T, t(rng.uniform(-1, 1, (n, 12))), cmd, carry,
            t(time), SETTLING, DT)


def _host(lib, args, fill):
    sl, sens, ctrl, cmd, carry, time, settling, dt = args
    views, adr, window, quat_o, window_o = cuda_engine._po_window_args(
        sl, sens, ctrl, cmd, carry, time, fill)
    suffix = {torch.float32: "f32", torch.float64: "f64"}[sens.dtype]
    fn = getattr(lib, f"qg_host_po_window_{suffix}")
    assert fn(views, adr, settling / 2.0, dt,
              None if window is None else window.data_ptr(),
              quat_o.data_ptr(), window_o.data_ptr(), *window_o.shape[:2]) == 0
    return observations.PoObsCarry(mad_quat=quat_o, buffer=window_o)


COMPUTED = [6, 7, 8, 25]  # the Euler angles and the heading


def _assert_matches(got, want, args, fill, dtype):
    """Copies equal in every bit, computed entries within ``TOL``."""
    frame, want_frame = got.buffer[:, -1], want.buffer[:, -1]
    if fill:  # every slot holds the frame
        assert torch.equal(got.buffer, frame[:, None].expand_as(got.buffer))
    else:  # the push: the old window one frame on
        assert torch.equal(got.buffer[:, :-1], args[4].buffer[:, 1:])
    copied = [k for k in range(26) if k not in COMPUTED]
    assert torch.equal(frame[:, copied], want_frame[:, copied])
    torch.testing.assert_close(got.mad_quat, want.mad_quat, **TOL[dtype])
    torch.testing.assert_close(frame[:, 25], want_frame[:, 25], **TOL[dtype])
    gap = (frame[:, 6:9] - want_frame[:, 6:9]).double().abs()
    room = (_euler_tol(want.mad_quat, dtype)
            + TOL[dtype]["rtol"] * want_frame[:, 6:9].double().abs())
    assert bool((gap <= room).all()), float((gap / room).max())


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_lib.build_observation(tmp_path_factory.mktemp("obs"))


@pytest.mark.parametrize("n", [1, 13, 2048])
@pytest.mark.parametrize("fill", [False, True], ids=["push", "fill"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_host_po_window_matches_plain_version(host_lib, n, fill, dtype):
    args = _inputs(n, dtype, seed=n + 2 * fill)
    got = _host(host_lib, args, fill)
    want = cuda_engine.po_window_reference(*args, fill=fill)
    _assert_matches(got, want, args, fill, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_host_po_window_edge_cases(host_lib, dtype):
    """Zero gyro: no update; zero accel: the gyro alone moves the filter;
    before ``settling_time / 2`` (and at it) the filter holds still; the
    reset's expanded filter quaternion is read through its zero stride."""
    args = _inputs(16, dtype, seed=3)
    q = args[4].mad_quat
    got = _host(host_lib, args, False)
    assert torch.equal(got.mad_quat[[0, 2, 3]], q[[0, 2, 3]])
    assert not torch.equal(got.mad_quat[1], q[1])
    gyro_only = observations.madgwick.update_imu(
        q[1], args[1][1, SL.gyro:SL.gyro + 3], torch.zeros(3, dtype=dtype),
        DT)
    torch.testing.assert_close(got.mad_quat[1], gyro_only, **TOL[dtype])
    early = args[5] <= SETTLING / 2.0
    assert bool(early.any()) and bool((~early).any())
    assert torch.equal(got.mad_quat[early], q[early])
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype).expand(16, 4)
    reset = args[:4] + (args[4]._replace(mad_quat=q0),) + args[5:]
    _assert_matches(_host(host_lib, reset, True),
                    cuda_engine.po_window_reference(*reset, fill=True), reset,
                    True, dtype)


def test_po_window_takes_the_plain_version_only_on_the_cpu():
    args = _inputs(8, torch.float32, seed=4)
    cuda_engine.reset_launch_counts()
    for fill in (False, True):
        got = cuda_engine.po_window(*args, fill=fill)
        frame, quat = observations.po_observation(
            *args[:4], args[4].mad_quat, *args[5:])
        stack = observations.stack_fill if fill else observations.stack_push
        assert torch.equal(got.mad_quat, quat)
        assert torch.equal(got.buffer, stack(args[4].buffer, frame))
    assert cuda_engine.launch_counts["po_window"] == 0
    meta = args[:1] + (args[1].to("meta"),) + args[2:]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_engine.po_window(*meta)


@pytest.mark.parametrize("bad", ["ctrl", "dtype", "window", "grad", "sens"])
def test_po_window_args_refuse_what_the_kernel_does_not_take(bad):
    sl, sens, ctrl, cmd, carry, time, *_ = _inputs(8, torch.float64, seed=5)
    if bad == "ctrl":
        ctrl = ctrl[:, :11]
    elif bad == "dtype":
        time = time.float()
    elif bad == "window":
        carry = carry._replace(buffer=carry.buffer[:, :, :25])
    elif bad == "grad":
        ctrl = ctrl.clone().requires_grad_()
    else:
        sens = sens[:, :SL.vel + 1]
    with pytest.raises(ValueError):
        cuda_engine._po_window_args(sl, sens, ctrl, cmd, carry, time, False)


# --------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_version_on_card(dtype):
    dev = _card()
    for n in (1, 2048):
        for fill in (False, True):
            args = _inputs(n, dtype, seed=n + fill, device=dev)
            cuda_engine.reset_launch_counts()
            got = cuda_engine.po_window(*args, fill=fill)
            torch.cuda.synchronize()
            assert cuda_engine.launch_counts["po_window"] == 1
            want = cuda_engine.po_window_reference(*args, fill=fill)
            _assert_matches(got, want, args, fill, dtype)


@pytest.mark.cuda
def test_graph_route_launches_the_kernel_and_never_the_plain_version_on_card(
        monkeypatch):
    """On the env step's graph route the kernel is launched on the eager
    call and on the capturing call (twice each: the step's frame and the
    auto-reset's), and a replay runs it inside the graph; the plain
    ``po_observation`` is never called."""
    dev = _card()
    from quadruped_gym_tpu_torch.envs import vector_env as V
    from quadruped_gym_tpu_torch.tasks import walking

    m = spec.get_fast_plant_model(n_directions=128, n_secondary=64)
    cfg = walking.WalkingConfig(
        max_time=0.3, frame_skip=10, obs_window=W, partial_obs=True,
        random_controls=True, random_init=True, solver_iterations=4,
        dtype=torch.float32)

    def refuse(*a, **k):
        raise AssertionError("the plain po_observation ran on the card")

    monkeypatch.setattr(observations, "po_observation", refuse)
    gen = torch.Generator(device=dev).manual_seed(7)
    cuda_engine.reset_launch_counts()
    V.reset_graph_counts()
    with torch.no_grad():
        st, obs = walking.reset(m, cfg, 256, gen)
        assert cuda_engine.launch_counts["po_window"] == 1
        for k in range(4):
            action = torch.zeros((256, 12), device=dev)
            out = V.batched_autoreset_step(m, cfg, st, action, gen,
                                           engine_impl="pallas")
            st = out.state
        torch.cuda.synchronize()
    assert V.graph_counts == {"captures": 1, "replays": 2, "eager": 1}
    assert cuda_engine.launch_counts["po_window"] == 1 + 2 + 2
    assert out.obs.shape == (256, W * 26) and bool(out.obs.isfinite().all())
