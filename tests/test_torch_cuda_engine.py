"""The fused rollout kernel's wrapper, model packing and build, and the
kernel's own arithmetic on the CPU.

The CUDA source cannot run here, but its device code is plain C++ over
one rollout: ``tests/torch_host_rollout.cpp`` compiles the same headers
with g++ (the CUDA qualifiers defined away, the grid a loop, a robot's
threads host threads in lockstep) and the tests hold that build to the
plain version, ``fused_rollout_cost_reference``.
The tests marked ``cuda`` run the kernels themselves on a card."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import torch_host_lib

from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import _build, cuda_engine
from quadruped_gym_tpu_torch.ops import leg_engine as LE
from quadruped_gym_tpu_torch.ops.lane_engine import LaneState
from quadruped_gym_tpu_torch.physics.engine import State, make_state
from quadruped_gym_tpu_torch.tasks.commands import make
from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices

PREV = [0.0, 0.0, -0.5] * 4


# decimations the getters' keywords build (the check phase of
# chip_smoke.py holds the card to them too)
DECIMATED = {
    "fast_plant_nsec_none": lambda: spec.get_fast_plant_model(
        n_secondary=None),
    "planning_64": lambda: spec.get_planning_model(64),
}


def _model(name):
    if name in DECIMATED:
        return DECIMATED[name]()
    return getattr(spec, f"get_{name}_model")()


def _inputs(m, kind, S, H, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0) + 0.02 * rng.standard_normal(m.nq)
    if kind == "airborne":
        qpos[2] += 0.5
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)  # noqa: E731
    st = State(qpos=t(qpos), qvel=t(0.1 * rng.standard_normal(m.nv)),
               act=t(PREV), time=t(0.0), sensordata=t(np.zeros(33)))
    seqs = t(np.clip(np.asarray(PREV) + 0.3 * rng.standard_normal((S, H, 12)),
                     -1.0, 1.0))
    cmd = make(t([0.2, 0.1]), t(0.3))
    return st, seqs, cmd, t(PREV)


# --------------------------------------------------------------------------
# model packing


def _cuh_fields():
    """(name, element count) of ``LegModel`` in csrc/leg_model.cuh, in
    declaration order, split into real and int fields."""
    with open(os.path.join(_build.CSRC, "leg_model.cuh")) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    body = src[src.index("struct LegModel {"):]
    body = body[:body.index("};")]
    real, ints = [], []
    for typ, name, dims in re.findall(r"^\s*(T|int) (\w+)((?:\[\w+\])*);",
                                      body, re.M):
        n = 1
        for d in re.findall(r"\[(\w+)\]", dims):
            n *= consts[d] if d in consts else int(d)
        (real if typ == "T" else ints).append((name, n))
    return consts, real, ints


def test_model_struct_matches_header():
    consts, real, ints = _cuh_fields()
    assert consts["MAX_GROUPS"] == cuda_engine.MAX_GROUPS
    assert consts["MAX_VERTS"] == cuda_engine.MAX_VERTS
    assert real == list(cuda_engine._LAYOUT)
    assert ints == list(cuda_engine._INT_LAYOUT)


@pytest.mark.parametrize("name,ngroup", [("planning", 1), ("fast_plant", 3)])
def test_pack_model(name, ngroup):
    m = _model(name)
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        P = cuda_engine.pack_model(m, dtype)
        n_real = sum(n for _, n in cuda_engine._LAYOUT)
        n_int = sum(n for _, n in cuda_engine._INT_LAYOUT)
        packed = n_real * size + n_int * 4
        assert ctypes.sizeof(P) == -(-packed // size) * size  # tail padding
        assert P.timestep == pytest.approx(m.timestep)
        assert P.ngroup == ngroup
        nverts = [P.grp_nvert[g] for g in range(P.ngroup)]
        assert sum(nverts) == sum(
            len(m.col_hull_verts[grp[0]])
            for _, grp in LE._leg_static(m).col_groups)
        assert all(1 <= P.grp_nslot[g] <= 3 for g in range(P.ngroup))
    buf = cuda_engine._model_buffer(m, torch.float64, "cpu")
    assert buf.numel() == ctypes.sizeof(cuda_engine.model_struct(torch.float64))
    assert cuda_engine._model_buffer(m, torch.float64, "cpu") is buf


def test_command_scalars():
    cmd = make(torch.tensor([0.3, -0.4], dtype=torch.float64),
               torch.tensor(0.5, dtype=torch.float64))
    c = cuda_engine.command_scalars(cmd, torch.float64)
    np.testing.assert_allclose(c.numpy(), [0.6, -0.8, 0.5, np.cos(0.5),
                                           np.sin(0.5)], rtol=1e-15)
    z = cuda_engine.command_scalars(
        make(torch.zeros(2, dtype=torch.float64),
             torch.tensor(0.0, dtype=torch.float64)), torch.float32)
    assert z.dtype == torch.float32
    np.testing.assert_array_equal(z.numpy(), [0, 0, 0, 1, 0])


# --------------------------------------------------------------------------
# wrapper, build, operation count


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    m = _model("planning")
    st, seqs, cmd, prev = _inputs(m, "grounded", 4, 1, 0)
    cuda_engine.reset_launch_counts()
    got = cuda_engine.fused_rollout_cost(m, st, seqs, cmd, prev, 2, 2, 4)
    ref = cuda_engine.fused_rollout_cost_reference(m, st, seqs, cmd, prev, 2,
                                                   2, 4)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert cuda_engine.launch_counts["fused_rollout_cost"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_engine.fused_rollout_cost(m, st, seqs.to("meta"), cmd, prev, 2)


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing falls back to the CPU."""
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else
                        os.path.isfile(p) or os.path.isdir(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(cuda_engine.KERNEL_SOURCE, "float32")


def test_build_names_and_flags():
    f32 = _build._lib_path(cuda_engine.KERNEL_SOURCE, "float32")
    f64 = _build._lib_path(cuda_engine.KERNEL_SOURCE, "float64")
    assert f32 != f64 and "float32" in f32 and f32.endswith(".so")
    flags = _build._flags("float64")
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-DQG_REAL=double" in flags and "-O3" in flags
    assert os.path.isfile(os.path.join(_build.CSRC,
                                       cuda_engine.KERNEL_SOURCE))
    # every kernel source is built, and each has its wrapper's name
    assert _build.kernel_sources() == tuple(sorted((
        cuda_engine.KERNEL_SOURCE, cuda_engine.SUBSTEP_SOURCE,
        cuda_engine.OBSERVATION_SOURCE)))
    sub = _build._lib_path(cuda_engine.SUBSTEP_SOURCE, "float32")
    assert sub != f32 and "substep_kernel" in sub


def test_rollout_flops():
    m = _model("planning")
    one = cuda_engine.rollout_flops(m, 1, 2, 2, 4)
    two = cuda_engine.rollout_flops(m, 2, 2, 2, 4)
    assert one > 1e4
    assert two == pytest.approx(2 * one, rel=0.01)
    assert cuda_engine.rollout_flops(_model("fast_plant"), 1, 2, 2, 4) > one


_X = torch.arange(1.0, 7.0, dtype=torch.float64)


@pytest.mark.parametrize("fn,want", [
    (lambda: torch.sqrt(_X), 6),
    (lambda: torch.rsqrt(_X), 6),
    (lambda: _X * 2.0 + 1.0, 12),
    (lambda: torch.where(_X > 3.0, _X, 0.0), 12),
    (lambda: torch.sum(_X), 6),
    (lambda: torch.linalg.vector_norm(_X), 12),
    (lambda: torch.dot(_X, _X), 12),
    (lambda: _X.reshape(2, 3) @ _X.reshape(3, 2), 24),
    (lambda: torch.stack([_X[0], _X[1]]).t().clone(), 0),
])
def test_count_ops(fn, want):
    """Each aten op is counted by name, an FMA as two operations."""
    assert cuda_engine.count_ops(fn)[1] == want


def test_count_ops_refuses_unclassified_ops():
    with pytest.raises(NotImplementedError, match="cumsum"):
        cuda_engine.count_ops(torch.cumsum, _X, 0)


# --------------------------------------------------------------------------
# the kernel's own source, built for the host


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_lib.build(tmp_path_factory.mktemp("host"))


def _host_rollout(lib, m, st, seqs, cmd, prev, fs, it, lsi, dp=None,
                  split=1):
    """The kernels' rollout body built for the host in the card's form:
    4 x ``split`` threads a robot (``split`` replicas of a quad), whose
    copies of each cost must agree in every bit."""
    dt = seqs.dtype
    P = cuda_engine.pack_model(m, dt)
    S = seqs.shape[0]
    lanes = [None if dp is None else getattr(dp, n)
             for n in cuda_engine._DP_ORDER]
    lanes = [None if v is None else v.to(dt).contiguous() for v in lanes]
    ptrs = (ctypes.c_void_p * 7)(*[0 if v is None else v.data_ptr()
                                   for v in lanes])
    vecs = [x.to(dt).contiguous() for x in (st.qpos, st.qvel, st.act, prev)]
    seq = seqs.permute(1, 2, 0).contiguous()
    cs = cuda_engine.command_scalars(cmd, dt).contiguous()
    out = torch.empty(S, dtype=dt)
    name = "qg_host_rollout_{}".format("f64" if dt == torch.float64 else "f32")
    differ = getattr(lib, name)(
        ctypes.addressof(P), vecs[0].data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr(), seq.data_ptr(), vecs[3].data_ptr(), cs.data_ptr(),
        ptrs, out.data_ptr(), S, seqs.shape[1], fs, it, lsi, 0.13, split)
    assert differ == 0, f"{differ} costs differ within their robot"
    return out


def test_host_struct_size(host_lib):
    for dt, tdt in (("f32", torch.float32), ("f64", torch.float64)):
        assert getattr(host_lib, f"qg_model_size_{dt}")() == ctypes.sizeof(
            cuda_engine.model_struct(tdt))


@pytest.mark.parametrize("airborne,it", [(False, 0), (False, 4), (True, 4)])
def test_host_substep_matches_leg_engine(host_lib, airborne, it):
    m = _model("planning")
    P = cuda_engine.pack_model(m, torch.float64)
    rng = np.random.default_rng(int(airborne) + it)
    q = np.asarray(m.qpos0) + 0.05 * rng.standard_normal(19)
    q[2] += 0.5 if airborne else 0.0
    qv = 0.1 * rng.standard_normal(18)
    act = np.array(PREV, np.float64)
    ctrl = np.array([0.1, -0.1, -0.5] * 4)
    ls = LaneState(*(torch.as_tensor(x)[:, None] for x in (q, qv, act)),
                   torch.zeros(1, dtype=torch.float64),
                   torch.zeros((33, 1), dtype=torch.float64))
    ref = LE._step_impl(m, ls, torch.as_tensor(ctrl)[:, None], it, 8)
    # a batch of one lane through the substep kernel's body, a quad of
    # threads
    ins = [torch.as_tensor(x)[:, None].contiguous()
           for x in (q, qv, act, ctrl)]
    outs = [torch.full((1,) + x.shape, float("nan"), dtype=torch.float64)
            for x in ins[:3]]
    sens = torch.full((1, m.nsensordata, 1), float("nan"), dtype=torch.float64)
    err = host_lib.qg_host_substeps_f64(
        ctypes.addressof(P), *[x.data_ptr() for x in ins],
        (ctypes.c_void_p * 7)(), *[x.data_ptr() for x in outs],
        sens.data_ptr(), 1, 1, 1, it, 8, 1, 1)
    assert err == 0
    q, qv, act = (x[0, :, 0].numpy() for x in outs)
    np.testing.assert_allclose(q, ref.qpos[:, 0].numpy(), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(qv, ref.qvel[:, 0].numpy(), rtol=1e-10,
                               atol=1e-11)
    np.testing.assert_allclose(act, ref.act[:, 0].numpy(), rtol=1e-14,
                               atol=1e-15)
    sl = SensorSlices.from_model(m)
    idx = [sl.vel, sl.vel + 1, sl.xaxis, sl.xaxis + 1, sl.zaxis + 2,
           sl.pos + 2]
    np.testing.assert_allclose(sens[0, idx, 0].numpy(),
                               ref.sensordata[idx, 0].numpy(),
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("name,kind,H,fs,with_dp", [
    ("planning", "grounded", 1, 5, False),
    ("planning", "airborne", 3, 2, False),
    ("planning", "grounded", 1, 3, True),
    ("fast_plant", "grounded", 1, 5, False),
    ("fast_plant", "airborne", 2, 2, True),
    ("fast_plant_nsec_none", "grounded", 1, 5, False),
    ("planning_64", "grounded", 1, 5, False),
])
def test_host_rollout_matches_plain_version(host_lib, name, kind, H, fs,
                                            with_dp):
    m = _model(name)
    S = 16
    st, seqs, cmd, prev = _inputs(m, kind, S, H, seed=H + fs)
    dp = None
    if with_dp:
        dp = spec.sample_domain_params(
            torch.Generator().manual_seed(1), S, tilt_range=(-0.1, 0.1),
            terrain_amp_range=(0.0, 0.02), dtype=torch.float64)
    ref = cuda_engine.fused_rollout_cost_reference(m, st, seqs, cmd, prev, fs,
                                                   4, 8, dp=dp)
    got = _host_rollout(host_lib, m, st, seqs, cmd, prev, fs, 4, 8, dp)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-8,
                               atol=1e-8)


@pytest.mark.parametrize("name,budget", [("planning", (2, 4)),
                                         ("fast_plant", (4, 8)),
                                         ("fast_plant_nsec_none", (4, 8)),
                                         ("planning_64", (2, 4))])
def test_host_rollout_float32(host_lib, name, budget):
    """float32 against the float32 plain version: rounding (~6e-8 an
    operation) amplified through the contact solve; 1e-4 is the bound
    chip_smoke.py holds the card to as well."""
    m = _model(name)
    st, seqs, cmd, prev = _inputs(m, "grounded", 32, 1, 5, torch.float32)
    ref = cuda_engine.fused_rollout_cost_reference(m, st, seqs, cmd, prev, 5,
                                                   *budget)
    got = _host_rollout(host_lib, m, st, seqs, cmd, prev, 5, *budget)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,kind,H,fs,with_dp,dtype", [
    ("planning", "grounded", 2, 3, False, torch.float64),
    ("planning", "airborne", 1, 2, True, torch.float64),
    ("fast_plant", "grounded", 1, 2, True, torch.float64),
    ("fast_plant", "grounded", 1, 2, False, torch.float32),
])
def test_host_quad_rollout_agrees_in_every_thread(host_lib, name, kind, H,
                                                  fs, with_dp, dtype):
    """The card's form at split 1 (a quad of threads per robot, the legs'
    sums by two exchange steps, the rows strided by the block): each of
    the robot's four threads returns the same cost in every bit, within
    1e-8 (float64) or 1e-4 (float32) of the plain version."""
    m = _model(name)
    S = 5
    st, seqs, cmd, prev = _inputs(m, kind, S, H, seed=3 * H + fs, dtype=dtype)
    dp = None
    if with_dp:
        dp = spec.sample_domain_params(
            torch.Generator().manual_seed(2), S, friction_range=(0.4, 0.8),
            gain_range=(0.8, 1.2), mass_range=(0.9, 1.5),
            tilt_range=(-0.1, 0.1), terrain_amp_range=(0.0, 0.02),
            dtype=dtype)
    quad = _host_rollout(host_lib, m, st, seqs, cmd, prev, fs, 4, 8, dp)
    ref = cuda_engine.fused_rollout_cost_reference(m, st, seqs, cmd, prev, fs,
                                                   4, 8, dp=dp)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(quad.numpy(), ref.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name,kind,H,fs,with_dp,dtype,split", [
    ("planning", "grounded", 2, 3, False, torch.float64, 2),
    ("planning", "airborne", 1, 2, True, torch.float64, 4),
    ("planning", "grounded", 1, 3, False, torch.float32, 4),
    ("fast_plant", "grounded", 1, 2, True, torch.float64, 4),
    ("fast_plant", "grounded", 1, 2, False, torch.float32, 2),
    ("fast_plant_nsec_none", "grounded", 1, 2, False, torch.float64, 2),
])
def test_host_split_rollout_matches_split_one(host_lib, name, kind, H, fs,
                                              with_dp, dtype, split):
    """Replicas (``split`` quads a rollout, each scanning a share of every
    hull and sharing the winners by exchange steps over the replica bits,
    ties to the lower index): every thread's cost equals split 1's in
    every bit, so B1's costs do not depend on the split, and split 1 is
    within 1e-8 (float64) or 1e-4 (float32) of the plain version."""
    m = _model(name)
    S = 2
    st, seqs, cmd, prev = _inputs(m, kind, S, H, seed=5 * H + fs + split,
                                  dtype=dtype)
    dp = None
    if with_dp:
        dp = spec.sample_domain_params(
            torch.Generator().manual_seed(3), S, friction_range=(0.4, 0.8),
            gain_range=(0.8, 1.2), mass_range=(0.9, 1.5),
            tilt_range=(-0.1, 0.1), terrain_amp_range=(0.0, 0.02),
            dtype=dtype)
    one = _host_rollout(host_lib, m, st, seqs, cmd, prev, fs, 4, 8, dp)
    reps = _host_rollout(host_lib, m, st, seqs, cmd, prev, fs, 4, 8, dp,
                         split=split)
    np.testing.assert_array_equal(reps.numpy(), one.numpy())
    ref = cuda_engine.fused_rollout_cost_reference(m, st, seqs, cmd, prev, fs,
                                                   4, 8, dp=dp)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 chip_smoke.py)")
    m = _model("planning")
    st, seqs, cmd, prev = _inputs(m, "grounded", 256, 1, 9)
    st = State(*(x.cuda() for x in st))
    seqs, prev = seqs.cuda(), prev.cuda()
    cmd = type(cmd)(*(x.cuda() for x in cmd))
    cuda_engine.reset_launch_counts()
    got = cuda_engine.fused_rollout_cost(m, st, seqs, cmd, prev, 5, 4, 8)
    torch.cuda.synchronize()
    assert cuda_engine.launch_counts["fused_rollout_cost"] == 1
    ref = cuda_engine.fused_rollout_cost_reference(m, st, seqs, cmd, prev, 5,
                                                   4, 8)
    torch.testing.assert_close(got, ref, rtol=1e-8, atol=1e-8)
    assert make_state(m, device="cuda").qpos.is_cuda


@pytest.mark.cuda
def test_substep_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 chip_smoke.py)")
    m = _model("planning")
    B = 200  # not a multiple of the block size
    rng = np.random.default_rng(9)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")  # noqa: E731
    qpos = np.asarray(m.qpos0)[:, None] + 0.02 * rng.standard_normal((19, B))
    ls = LaneState(qpos=t(qpos), qvel=t(0.1 * rng.standard_normal((18, B))),
                   act=t(np.tile(np.array(PREV)[:, None], (1, B))),
                   time=t(np.zeros(B)), sensordata=t(np.ones((33, B))))
    ctrl = t(np.clip(np.array(PREV)[:, None]
                     + 0.3 * rng.standard_normal((12, B)), -1.0, 1.0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    dp = spec.sample_domain_params(gen, B, tilt_range=(-0.1, 0.1),
                                   terrain_amp_range=(0.0, 0.02),
                                   dtype=torch.float64)
    cuda_engine.reset_launch_counts()
    got = cuda_engine.control_step(m, ls, ctrl, 3, 4, 8, dp=dp)
    torch.cuda.synchronize()
    assert cuda_engine.launch_counts["substep"] == 1
    ref = cuda_engine.control_step_reference(m, ls, ctrl, 3, 4, 8, dp)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-8, atol=1e-8)
    none = cuda_engine.step(m, ls, ctrl, 4, 8, compute_sensors=False)
    assert float(none.sensordata.abs().max()) == 0.0
    with pytest.raises(ValueError, match="must be a"):
        cuda_engine.step(m, ls, ctrl.to(torch.float32))


# --------------------------------------------------------------------------
# the env step as a CUDA graph (envs/vector_env.py), on the card


def _env_cell(max_time):
    """The fast plant at 4/8 and the env cell's walking task (frame_skip
    10, partial observations over 10 frames, random yaw and a fixed 0.3
    m/s command), with episodes of ``max_time`` seconds."""
    from quadruped_gym_tpu_torch.tasks import commands, walking

    m = spec.get_fast_plant_model(n_directions=128, n_secondary=64)
    cfg = walking.WalkingConfig(
        max_time=max_time, frame_skip=10, obs_window=10, partial_obs=True,
        random_controls=True, random_init=True,
        reset_options=commands.SampleOptions.from_dict(dict(
            fixed_heading_angle=0.0, fixed_velocity_angle=0.0,
            fixed_speed=0.3)),
        solver_iterations=4, dtype=torch.float32)
    return m, cfg


def _drawn(out):
    """What a reset draws afresh: the state but the estimator's and the
    reward's carries, which survive it, and the observation."""
    s = out.state
    return [*s.phys, *s.cmd, s.ideal_position, *s.obs, s.applied_ctrl,
            out.obs]


def _action(n, k, dev):
    g = torch.Generator(device=dev).manual_seed(1000 + k)
    return torch.clamp(torch.randn((n, 12), generator=g, device=dev), -1, 1)


@pytest.mark.cuda
def test_step_graph_matches_eager_on_card():
    """50 steps of 2,048 envs through the graph against the eager step,
    each generator reseeded before every step, episodes ending every 15-16
    steps: ``done`` and every fresh draw equal, the rest bit for bit or
    within 1e-6 relative (the test says which); the generator's state
    after a replay equals its state after an eager step; a step's returned
    tensors are unchanged 17 steps later; 1 eager warm-up, 1 capture and
    48 replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 chip_smoke.py)")
    from torch.utils import _pytree as pytree

    from quadruped_gym_tpu_torch.envs import vector_env as V
    from quadruped_gym_tpu_torch.tasks import walking

    m, cfg = _env_cell(max_time=0.3)
    n, steps, dev = 2048, 50, torch.device("cuda")
    ggen, egen = (torch.Generator(device=dev) for _ in range(2))
    ggen.manual_seed(11)
    gst = est = walking.reset(m, cfg, n, ggen)[0]
    V.reset_graph_counts()
    exact, ended, kept = True, 0, None
    with torch.no_grad():
        for k in range(steps):
            action = _action(n, k, dev)
            ggen.manual_seed(2000 + k)
            egen.manual_seed(2000 + k)
            g = V.batched_autoreset_step(m, cfg, gst, action, ggen,
                                         engine_impl="pallas")
            e = V._batched_autoreset_step(m, cfg, est, action, egen, "pallas")
            assert torch.equal(ggen.get_state(), egen.get_state()), k
            assert torch.equal(g.done, e.done), k
            done = e.done
            ended += int(done.sum())
            for a, b in zip(_drawn(g), _drawn(e)):
                assert torch.equal(a[done], b[done]), k
            for a, b in zip(pytree.tree_leaves(g), pytree.tree_leaves(e)):
                if torch.equal(a, b):
                    continue
                exact = False
                assert a.is_floating_point(), k
                gap = float((a - b).abs().max())
                assert gap <= 1e-6 * max(float(b.abs().max()), 1e-30), (k, gap)
            if k == 10:
                kept = (g, [x.clone() for x in pytree.tree_leaves(g)])
            if k == 27:
                for x, y in zip(pytree.tree_leaves(kept[0]), kept[1]):
                    assert torch.equal(x, y)
            gst, est = g.state, e.state
    assert ended >= 2 * n  # episodes end every 15-16 steps
    assert V.graph_counts == {"captures": 1, "replays": steps - 2, "eager": 1}
    print("graph against eager:",
          "bit for bit" if exact else "within 1e-6 relative")


@pytest.mark.cuda
def test_step_graph_recaptures_and_copies_nothing_on_card():
    """A new number of envs captures a new graph; a replay issues no
    host-to-device copy (the trace) and no synchronising PyTorch call
    (``set_sync_debug_mode("error")``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 chip_smoke.py)")
    from torch.profiler import ProfilerActivity, profile

    from quadruped_gym_tpu_torch.envs import vector_env as V
    from quadruped_gym_tpu_torch.tasks import walking

    m, cfg = _env_cell(max_time=20.0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    V.reset_graph_counts()
    with torch.no_grad():
        for n in (512, 300):
            st = walking.reset(m, cfg, n, gen)[0]
            for k in range(3):
                st = V.batched_autoreset_step(m, cfg, st, _action(n, k, dev),
                                              gen, engine_impl="pallas").state
        assert V.graph_counts == {"captures": 2, "replays": 2, "eager": 2}
        action = _action(300, 9, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    st = V.batched_autoreset_step(m, cfg, st, action, gen,
                                                  engine_impl="pallas").state
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert V.graph_counts["replays"] == 5
    names = [ev.name for ev in prof.events()]
    assert any("substep_kernel" in x for x in names)  # the graph's kernels
    assert not [x for x in names if "HtoD" in x]
