"""The kernels' own arithmetic on the ``full`` collision model, built for
the host with g++ (``tests/torch_host_rollout.cpp``), and the packing and
launch geometry of its base groups, on the CPU.

``full`` brings groups on the base: the hip servos (one geom a leg, each
with its own frame) and the frame (one geom: the four threads of a robot
scan a quarter of its hull each and share the winners, leg 0 keeps its
slots). The host build runs the substep kernel's and the rollout
kernel's bodies in the card's form, a quad of threads a robot, or 2 or 4
replicas of the quad that split every hull's scans; every split must
agree with split 1 in every bit, and split 1 stay within 1e-8 (float64)
or 1e-4 (float32) of the plain version, from states where the hip servos
and the frame touch the ground."""

import ctypes

import numpy as np
import pytest
import torch

import torch_host_lib
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.ops import leg_engine as LE
from quadruped_gym_tpu_torch.ops.lane_engine import LaneState
from quadruped_gym_tpu_torch.physics.engine import State
from quadruped_gym_tpu_torch.tasks.commands import make

F32, F64 = torch.float32, torch.float64
HOLD = [0.0, 0.0, -0.5] * 4
M = spec.get_full_model()
# base heights of the lanes: hip servos touch from ~3 cm, the frame at 0
HEIGHTS = (0.0, -0.005, 0.01, 0.02, 0.03, 0.3)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_lib.build(tmp_path_factory.mktemp("host"))


def _lanes(dtype, seed, with_dp):
    rng = np.random.default_rng(seed)
    B = len(HEIGHTS)
    qpos = np.asarray(M.qpos0)[:, None] + 0.05 * rng.standard_normal((19, B))
    qpos[2] = HEIGHTS
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)  # noqa: E731
    ls = LaneState(t(qpos), t(0.2 * rng.standard_normal((18, B))),
                   t(np.tile(np.array(HOLD)[:, None], (1, B))),
                   t(0.002 * np.arange(B)), t(rng.standard_normal((33, B))))
    ctrl = t(np.clip(np.array(HOLD)[:, None]
                     + 0.3 * rng.standard_normal((12, B)), -1, 1))
    dp = None
    if with_dp:
        dp = spec.sample_domain_params(
            torch.Generator().manual_seed(seed), B, friction_range=(0.4, 0.8),
            gain_range=(0.8, 1.2), mass_range=(0.9, 1.5),
            tilt_range=(-0.1, 0.1), terrain_amp_range=(0.0, 0.02),
            dtype=dtype)
    return ls, ctrl, dp


def _ptrs(dp, dt):
    lanes = [None if dp is None else getattr(dp, k)
             for k in cuda_engine._DP_ORDER]
    lanes = [None if v is None else v.to(dt).contiguous() for v in lanes]
    return lanes, (ctypes.c_void_p * 7)(*[0 if v is None else v.data_ptr()
                                         for v in lanes])


def _host_substeps(lib, ls, ctrl, nsub, dp, split=1):
    """4 x ``split`` threads a robot, each replica's outputs along a
    leading axis."""
    dt = ls.qpos.dtype
    P = cuda_engine.pack_model(M, dt)
    n = ls.qpos.shape[1]
    keep, ptrs = _ptrs(dp, dt)
    ins = [x.contiguous() for x in (ls.qpos, ls.qvel, ls.act, ctrl)]
    outs = [torch.full((split,) + x.shape, float("nan"), dtype=dt)
            for x in ins[:3]]
    sens = torch.full((split, M.nsensordata, n), float("nan"), dtype=dt)
    name = "qg_host_substeps_{}".format("f64" if dt == F64 else "f32")
    err = getattr(lib, name)(
        ctypes.addressof(P), *[x.data_ptr() for x in ins], ptrs,
        *[x.data_ptr() for x in outs], sens.data_ptr(), n, n, nsub, 4, 8, 1,
        split)
    assert err == 0
    return outs + [sens]


def _active(ls):
    """(hip-servo, frame) slots active in the plain version's collision."""
    q_free = [ls.qpos[i] for i in range(7)]
    q_leg = [ls.qpos[LE._Q_IDX[k]] for k in range(3)]
    slots = LE._collide_loop(M, LE._fk(M, q_free, q_leg))
    return tuple(sum(int(a.sum()) for _, _, a, lv, _, _ in slots if lv == x)
                 for x in (LE.BASE, LE.BASE_ONE))


@pytest.mark.parametrize("nsub,with_dp", [(1, False), (3, True)])
def test_host_substeps_match_plain_version(host_lib, nsub, with_dp):
    """Float64: the state and all 33 sensors within 1e-8 of the plain
    version; the frame and the hip servos are in contact."""
    ls, ctrl, dp = _lanes(F64, 3 + nsub, with_dp)
    servos, frame = _active(ls)
    assert servos > 0 and frame > 0
    ref = cuda_engine.control_step_reference(M, ls, ctrl, nsub, 4, 8, dp)
    got = _host_substeps(host_lib, ls, ctrl, nsub, dp)
    for g, f in zip(got, ("qpos", "qvel", "act", "sensordata")):
        np.testing.assert_allclose(g[0].numpy(), getattr(ref, f).numpy(),
                                   rtol=1e-8, atol=1e-8, err_msg=f)


def test_host_substeps_float32(host_lib):
    """Float32 against the float32 plain version, one control step of 4
    substeps at 4/8, at the 1e-4 that chip_smoke.py holds the card to."""
    ls, ctrl, _ = _lanes(F32, 11, False)
    ref = cuda_engine.control_step_reference(M, ls, ctrl, 4, 4, 8)
    got = _host_substeps(host_lib, ls, ctrl, 4, None)
    for g, f in zip(got, ("qpos", "qvel", "act", "sensordata")):
        np.testing.assert_allclose(g[0].numpy(), getattr(ref, f).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("split,nsub,dtype,with_dp", [
    (2, 2, F64, True), (4, 1, F64, False), (4, 2, F64, False),
    (2, 1, F32, False), (4, 3, F32, True), (2, 3, F32, False)])
def test_host_split_substeps_match_split_one(host_lib, split, nsub, dtype,
                                             with_dp):
    """B2 with replicas from the pressed start (the frame and the hip
    servos in contact): each replica scans its share of every hull (of
    its leg's quarter of the frame's) and the winners are shared, so
    every replica's state and sensors equal split 1's in every bit, at
    every split, and split 1 is within 1e-8 (float64) or 1e-4 (float32)
    of the plain version. Two lanes (the frame and the hip servos touch
    at 0, the hip servos at 3 cm): 4 x split host threads step each in
    lockstep, so the lanes are few."""
    ls, ctrl, dp = _lanes(dtype, 40 + split + nsub, with_dp)
    pick = [HEIGHTS.index(0.0), HEIGHTS.index(0.03)]
    ls = LaneState(*(x[..., pick] for x in ls))
    ctrl = ctrl[:, pick]
    if dp is not None:
        dp = type(dp)(*(None if v is None else v[pick] for v in dp))
    servos, frame = _active(ls)
    assert servos > 0 and frame > 0
    one = _host_substeps(host_lib, ls, ctrl, nsub, dp)
    reps = _host_substeps(host_lib, ls, ctrl, nsub, dp, split=split)
    for o, r, f in zip(one, reps, ("qpos", "qvel", "act", "sensordata")):
        assert r.shape[0] == split
        for q in r:
            np.testing.assert_array_equal(q.numpy(), o[0].numpy(), err_msg=f)
    ref = cuda_engine.control_step_reference(M, ls, ctrl, nsub, 4, 8, dp)
    tol = 1e-8 if dtype == F64 else 1e-4
    for o, f in zip(one, ("qpos", "qvel", "act", "sensordata")):
        np.testing.assert_allclose(o[0].numpy(), getattr(ref, f).numpy(),
                                   rtol=tol, atol=tol, err_msg=f)


def _rollout_inputs(dtype, z, S, H, seed):
    rng = np.random.default_rng(seed)
    qpos = np.asarray(M.qpos0) + 0.02 * rng.standard_normal(19)
    qpos[2] = z
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)  # noqa: E731
    st = State(t(qpos), t(0.1 * rng.standard_normal(18)), t(HOLD), t(0.0),
               t(np.zeros(33)))
    seqs = t(np.clip(np.array(HOLD) + 0.3 * rng.standard_normal((S, H, 12)),
                     -1, 1))
    return st, seqs, make(t([0.2, 0.1]), t(0.3)), t(HOLD)


def _host_rollout(lib, st, seqs, cmd, prev, fs, dp, split=1):
    dt = seqs.dtype
    P = cuda_engine.pack_model(M, dt)
    S = seqs.shape[0]
    keep, ptrs = _ptrs(dp, dt)
    vecs = [x.contiguous() for x in (st.qpos, st.qvel, st.act, prev)]
    seq = seqs.permute(1, 2, 0).contiguous()
    cs = cuda_engine.command_scalars(cmd, dt).contiguous()
    out = torch.empty(S, dtype=dt)
    name = "qg_host_rollout_{}".format("f64" if dt == F64 else "f32")
    differ = getattr(lib, name)(
        ctypes.addressof(P), vecs[0].data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr(), seq.data_ptr(), vecs[3].data_ptr(), cs.data_ptr(),
        ptrs, out.data_ptr(), S, seqs.shape[1], fs, 4, 8, 0.13, split)
    assert differ == 0, f"{differ} costs differ within their robot"
    return out


@pytest.mark.parametrize("z,dtype,with_dp", [(0.0, F64, False),
                                             (0.03, F64, True),
                                             (0.03, F32, False)])
def test_host_rollout_matches_plain_version(host_lib, z, dtype, with_dp):
    """The rollout kernel's body (B1) on ``full``: the four threads of a
    robot equal in every bit, within 1e-8 (float64) or 1e-4 (float32) of
    the plain version."""
    S = 4
    st, seqs, cmd, prev = _rollout_inputs(dtype, z, S, 1, seed=int(100 * z))
    dp = None
    if with_dp:
        dp = spec.sample_domain_params(
            torch.Generator().manual_seed(2), S, friction_range=(0.4, 0.8),
            tilt_range=(-0.1, 0.1), terrain_amp_range=(0.0, 0.02),
            dtype=dtype)
    ref = cuda_engine.fused_rollout_cost_reference(M, st, seqs, cmd, prev, 3,
                                                   4, 8, dp=dp)
    got = _host_rollout(host_lib, st, seqs, cmd, prev, 3, dp)
    tol = 1e-8 if dtype == F64 else 1e-4
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("z,dtype,split", [(0.0, F64, 2), (0.0, F64, 4),
                                           (0.03, F64, 4), (0.0, F32, 4),
                                           (0.03, F32, 2)])
def test_host_split_rollout_matches_split_one(host_lib, z, dtype, split):
    """B1 with replicas on ``full``, the base pressed to ``z``: every
    thread's cost equals split 1's in every bit, and split 1 is within
    1e-8 (float64) or 1e-4 (float32) of the plain version."""
    S = 2
    st, seqs, cmd, prev = _rollout_inputs(dtype, z, S, 1,
                                          seed=7 + split + int(100 * z))
    one = _host_rollout(host_lib, st, seqs, cmd, prev, 3, None)
    reps = _host_rollout(host_lib, st, seqs, cmd, prev, 3, None, split=split)
    np.testing.assert_array_equal(reps.numpy(), one.numpy())
    ref = cuda_engine.fused_rollout_cost_reference(M, st, seqs, cmd, prev, 3,
                                                   4, 8)
    tol = 1e-8 if dtype == F64 else 1e-4
    np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=tol, atol=tol)


def test_pack_model_base_groups():
    """The base's groups in the packed model: levels, each hip servo's
    own frame at its leg, the frame's hull once, the base's invweight."""
    P = cuda_engine.pack_model(M, F64)
    ls = LE._leg_static(M)
    assert P.ngroup == 7
    assert [P.grp_level[g] for g in range(7)] == [0, 0, 1, 2, 2, -1, -2]
    assert [P.grp_nslot[g] for g in range(7)] == [2, 2, 2, 3, 2, 2, 2]
    assert sum(P.grp_nvert[g] for g in range(7)) == 1702
    _, servos = ls.col_groups[5]
    for leg, geom in enumerate(servos):
        got = [P.grp_pos[12 * 5 + 3 * leg + c] for c in range(3)]
        assert got == pytest.approx(list(M.col_geom_pos[geom]), abs=0)
    for g in (0, 6):  # a leg group and the frame: one frame for all legs
        pos = [[P.grp_pos[12 * g + 3 * leg + c] for c in range(3)]
               for leg in range(4)]
        assert all(p == pos[0] for p in pos)
    inv = 2.0 * float(M.body_invweight0[ls.base][0])
    assert P.grp_2invweight[5] == P.grp_2invweight[6] == pytest.approx(inv)


def test_launch_geometry_of_full():
    """15 slots a leg column (13 a leg with its hip servo, the frame's 2
    in every column): 76,800 B of rows for a warp of single quads in
    float32, 3 blocks an SM. B1 at 2,048 rollouts takes 2 replicas a leg:
    blocks of two warps (32 columns, 76,800 B), 3 an SM, 256 blocks in one
    wave of 512 warps, one a scheduler of the 132 SMs. B2, whose
    replicas may fill two warps a scheduler on ``full``'s long scans,
    takes 4 at 2,048 envs: single warps of 8 columns (19,200 B), 8 an SM
    by the launch bounds, 1,024 blocks in one wave. The float64 rows of a
    warp of quads, 153,600 B, fit the 227 KB a block may have: 1 an SM,
    too few for replicas at 2,048 envs."""
    geo = cuda_engine.launch_geometry(15, F32, 2048)
    assert geo == (256, 64, 76800, 2)
    assert cuda_engine.resident_blocks(64, 76800) == 3
    assert cuda_engine.resident_blocks(32, 76800) == 3
    assert geo.grid <= cuda_engine.SM_COUNT * 3
    assert geo.grid * 2 <= cuda_engine.SCHEDULERS * cuda_engine.SM_COUNT
    assert cuda_engine.scheduler_warps("substep", M) == 2
    assert cuda_engine.scheduler_warps("fused_rollout_cost", M) == 1
    env = cuda_engine.launch_geometry(15, F32, 2048, 2)
    assert env == (1024, 32, 19200, 4)
    assert cuda_engine.resident_blocks(32, 19200) == 8
    assert env.grid <= cuda_engine.SM_COUNT * 8
    assert env.grid <= 2 * cuda_engine.SCHEDULERS * cuda_engine.SM_COUNT
    assert cuda_engine.launch_geometry(15, F64, 2048, 2).split == 1
    f64 = cuda_engine.launch_geometry(15, F64, 2048)
    assert f64 == (256, 32, 153600, 1)
    assert f64.smem_bytes <= cuda_engine.SMEM_PER_BLOCK
    assert cuda_engine.launch_geometry(15, F32, 65536) == (8192, 32, 76800,
                                                           1)
