"""The fused whole-rollout cost: one CUDA kernel launch per solve.

Counterpart of ``fused_rollout_cost`` in
``quadruped_gym_tpu/ops/pallas_engine.py`` (the Pallas TPU kernel
``_rollout_kernel``). For each of S rollouts from one shared start state
it runs H control steps x ``frame_skip`` leg-engine substeps at a fixed
Newton / line-search budget and sums the walking stage cost; the kernel is
``csrc/rollout_kernel.cu``.

``fused_rollout_cost`` launches the kernel for CUDA tensors and runs the
plain version, ``fused_rollout_cost_reference`` (the eager leg engine and
``solvers.rollout.walking_stage_cost``), only for CPU tensors. The
model's constants are packed into one ``LegModel`` struct
(``csrc/leg_model.cuh``) and uploaded once per (model, dtype, device).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..models.spec import (
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_VELOCIMETER,
    DomainParams,
    PhysicsModel,
)
from ..tasks.rewards import JOINT_CENTERS, SensorSlices
from . import _build
from . import leg_engine as LE
from .lane_engine import LaneState, _kb_from_solref, _np_quat_mat, _static

KERNEL_SOURCE = "rollout_kernel.cu"
MAX_GROUPS = 4
MAX_VERTS = 1024

# launches of each kernel wrapper; a run sets them to 0 and reads them
launch_counts = {"fused_rollout_cost": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# --------------------------------------------------------------------------
# model packing (mirrors csrc/leg_model.cuh field for field)


# (name, element count); C arrays of several dims are laid out flat
_LAYOUT = [
    ("timestep", 1), ("gravity", 3), ("act_coef", 1), ("base_mass", 1),
    ("base_inertia", 3), ("base_ipos", 3), ("base_imat", 9),
    ("free_damping", 6), ("free_armature", 6), ("leg_damping", 1),
    ("leg_armature", 1), ("hip_pos", 12), ("hip_quat", 16),
    ("lev_body_pos", 9), ("lev_body_quat", 12), ("lev_qpos0", 3),
    ("lev_jnt_pos", 9), ("lev_jnt_axis", 9), ("lev_mass", 3),
    ("lev_inertia", 9), ("lev_ipos", 9), ("lev_imat", 27),
    ("lev_range", 6), ("lev_jnt_margin", 3), ("lev_jnt_imp", 21),
    ("lev_jnt_K", 3), ("lev_jnt_B", 3), ("lev_invweight", 3),
    ("lev_gear", 3), ("lev_kp", 3), ("lev_b0", 3), ("lev_bq", 3),
    ("lev_bv", 3), ("lev_dvel", 3), ("lev_forcerange", 6),
    ("lev_ctrlrange", 6), ("plane_frame", 9), ("plane_off", 1),
    ("plane_pos", 3), ("site_pos", 3), ("site_mat", 9),
    ("joint_centers", 12), ("grp_pos", 3 * MAX_GROUPS),
    ("grp_mat", 9 * MAX_GROUPS), ("grp_margin", MAX_GROUPS),
    ("grp_margin2", MAX_GROUPS), ("grp_theta2", MAX_GROUPS),
    ("grp_theta3", MAX_GROUPS), ("grp_inc", MAX_GROUPS),
    ("grp_friction", MAX_GROUPS), ("grp_imp", 7 * MAX_GROUPS),
    ("grp_K", MAX_GROUPS), ("grp_B", MAX_GROUPS),
    ("grp_2invweight", MAX_GROUPS), ("vert", 3 * MAX_VERTS),
    ("vert_n2", MAX_VERTS),
]
_INT_LAYOUT = [("ngroup", 1), ("grp_level", MAX_GROUPS),
               ("grp_nslot", MAX_GROUPS), ("grp_vstart", MAX_GROUPS),
               ("grp_nvert", MAX_GROUPS)]


def _fields(c):
    def field(name, n, t):
        return (name, t) if n == 1 else (name, t * n)
    return ([field(n, k, c) for n, k in _LAYOUT]
            + [field(n, k, ctypes.c_int) for n, k in _INT_LAYOUT])


_STRUCTS = {}


def model_struct(dtype: torch.dtype):
    """The ctypes twin of ``LegModel<float|double>``."""
    if dtype not in _STRUCTS:
        c = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}[dtype]
        _STRUCTS[dtype] = type(f"LegModel_{c.__name__}", (ctypes.Structure,),
                               {"_fields_": _fields(c)})
    return _STRUCTS[dtype]


def _imp7(solimp):
    d0, dmax, width, mid, power = (float(x) for x in solimp)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)
    return [d0, dmax - d0, max(width, 1e-15), mid, power, a, b]


def _set(arr, values):
    for i, v in enumerate(np.asarray(values, np.float64).reshape(-1)):
        arr[i] = float(v)


def _check_cost_sensors(m: PhysicsModel) -> None:
    """The kernel computes the cost's sensors from the base site directly;
    the model must lay them out as the stage cost reads them."""
    sl = SensorSlices.from_model(m)
    kinds = {s.adr: s.kind for s in m.sensors}
    want = {sl.vel: SENSOR_VELOCIMETER, sl.xaxis: SENSOR_FRAMEXAXIS,
            sl.zaxis: SENSOR_FRAMEZAXIS, sl.pos: SENSOR_FRAMEPOS}
    for adr, kind in want.items():
        if kinds.get(adr) != kind:
            raise LE.IncompatibleModelError(
                f"sensor at {adr} is not of kind {kind}")
    LE._require(m.site_bodyid == LE._leg_static(m).base,
                "IMU site must live on the base body")


def pack_model(m: PhysicsModel, dtype: torch.dtype) -> ctypes.Structure:
    """The model's constants as a ``LegModel`` struct of ``dtype``."""
    ls = LE._leg_static(m)
    _check_cost_sensors(m)
    st = _static(m)
    P = model_struct(dtype)()
    b = ls.base
    j0 = [ls.leg_joints[k][0] for k in range(3)]
    b0 = [ls.leg_bodies[k][0] for k in range(3)]
    u0 = [LE._level_actuator(m, k) for k in range(3)]
    h = float(m.timestep)
    tau = max(float(m.actuator_dynprm[u0[0]][0]), 1e-12)
    P.timestep = h
    _set(P.gravity, m.gravity)
    P.act_coef = 1.0 - float(np.exp(-h / tau))
    P.base_mass = float(m.body_mass[b])
    _set(P.base_inertia, m.body_inertia[b])
    _set(P.base_ipos, m.body_ipos[b])
    _set(P.base_imat, _np_quat_mat(m.body_iquat[b]))
    _set(P.free_damping, np.asarray(m.dof_damping)[:6])
    _set(P.free_armature, np.asarray(m.dof_armature)[:6])
    P.leg_damping = float(m.dof_damping[6])
    P.leg_armature = float(m.dof_armature[6])
    hips = list(ls.leg_bodies[0])
    _set(P.hip_pos, np.asarray(m.body_pos)[hips])
    _set(P.hip_quat, np.asarray(m.body_quat)[hips])
    _set(P.lev_body_pos, np.asarray(m.body_pos)[b0])
    _set(P.lev_body_quat, np.asarray(m.body_quat)[b0])
    _set(P.lev_qpos0, [m.qpos0[m.jnt_qposadr[j]] for j in j0])
    _set(P.lev_jnt_pos, np.asarray(m.jnt_pos)[j0])
    _set(P.lev_jnt_axis, np.asarray(m.jnt_axis)[j0])
    _set(P.lev_mass, np.asarray(m.body_mass)[b0])
    _set(P.lev_inertia, np.asarray(m.body_inertia)[b0])
    _set(P.lev_ipos, np.asarray(m.body_ipos)[b0])
    _set(P.lev_imat, [_np_quat_mat(m.body_iquat[x]) for x in b0])
    _set(P.lev_range, np.asarray(m.jnt_range)[j0])
    _set(P.lev_jnt_margin, np.asarray(m.jnt_margin)[j0])
    _set(P.lev_jnt_imp, [_imp7(m.jnt_solimp[j]) for j in j0])
    kb = [_kb_from_solref(m.jnt_solref[j], m.jnt_solimp[j]) for j in j0]
    _set(P.lev_jnt_K, [x[0] for x in kb])
    _set(P.lev_jnt_B, [x[1] for x in kb])
    _set(P.lev_invweight, [m.dof_invweight0[m.jnt_dofadr[j]] for j in j0])
    gear = [float(m.actuator_gear[u]) for u in u0]
    gp = [m.actuator_gainprm[u] for u in u0]
    bp = [m.actuator_biasprm[u] for u in u0]
    _set(P.lev_gear, gear)
    _set(P.lev_kp, [float(g[0]) for g in gp])
    _set(P.lev_b0, [float(x[0]) for x in bp])
    _set(P.lev_bq, [float(x[1]) * g for x, g in zip(bp, gear)])
    _set(P.lev_bv, [float(x[2]) * g for x, g in zip(bp, gear)])
    _set(P.lev_dvel, [g * g * float(x[2]) for x, g in zip(bp, gear)])
    _set(P.lev_forcerange, [m.actuator_forcerange[u] for u in u0])
    _set(P.lev_ctrlrange, [m.actuator_ctrlrange[u] for u in u0])
    _set(P.plane_frame, st.plane_frame)
    P.plane_off = st.plane_off
    _set(P.plane_pos, m.plane_pos)
    _set(P.site_pos, m.site_pos)
    _set(P.site_mat, _np_quat_mat(m.site_quat))
    _set(P.joint_centers, JOINT_CENTERS)

    groups = ls.col_groups
    if len(groups) > MAX_GROUPS:
        raise LE.IncompatibleModelError(
            f"{len(groups)} collision groups; the kernel takes {MAX_GROUPS}")
    vstart = 0
    P.ngroup = len(groups)
    for g, (level, group) in enumerate(groups):
        g0 = group[0]
        verts = np.asarray(m.col_hull_verts[g0], np.float64)
        V = len(verts)
        if vstart + V > MAX_VERTS:
            raise LE.IncompatibleModelError(
                f"more than {MAX_VERTS} hull vertices in all")
        P.grp_level[g] = level
        P.grp_nslot[g] = LE._slot_budget(verts, float(m.col_theta2[g0]),
                                         float(m.col_theta3[g0]))
        P.grp_vstart[g] = vstart
        P.grp_nvert[g] = V
        for c in range(3):
            P.grp_pos[3 * g + c] = float(m.col_geom_pos[g0][c])
        for c, v in enumerate(_np_quat_mat(m.col_geom_quat[g0]).reshape(-1)):
            P.grp_mat[9 * g + c] = float(v)
        margin = float(m.col_margin[g0])
        P.grp_margin[g] = margin
        P.grp_margin2[g] = 2.0 * margin
        P.grp_theta2[g] = float(m.col_theta2[g0])
        P.grp_theta3[g] = float(m.col_theta3[g0])
        P.grp_inc[g] = float(m.col_margin[g0] - m.col_gap[g0])
        P.grp_friction[g] = float(m.col_friction[g0][0])
        for c, v in enumerate(_imp7(m.col_solimp[g0])):
            P.grp_imp[7 * g + c] = v
        K, B = _kb_from_solref(m.col_solref[g0], m.col_solimp[g0])
        P.grp_K[g] = K
        P.grp_B[g] = B
        P.grp_2invweight[g] = 2.0 * float(
            m.body_invweight0[ls.leg_bodies[level][0]][0])
        for i in range(V):
            for c in range(3):
                P.vert[3 * (vstart + i) + c] = float(verts[i, c])
            P.vert_n2[vstart + i] = float(np.sum(verts[i] ** 2))
        vstart += V
    return P


def _model_buffer(m: PhysicsModel, dtype, device) -> torch.Tensor:
    """The packed model on ``device``, uploaded once and cached on ``m``."""
    cache = m.__dict__.setdefault("_cuda_model_cache", {})
    key = (dtype, str(device))
    if key not in cache:
        raw = bytes(pack_model(m, dtype))
        cache[key] = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(
            device)
    return cache[key]


# --------------------------------------------------------------------------
# command scalars (the kernel's stage-cost inputs)


def command_scalars(cmd, dtype) -> torch.Tensor:
    """(5,): unit local command velocity xy, its norm, heading xy
    (pallas_engine.py:344-351)."""
    v2 = cmd.velocity[:2]
    n2 = torch.sum(v2 * v2)
    nonzero = n2 > 0.0
    n = torch.where(nonzero, torch.sqrt(torch.where(nonzero, n2, 1.0)), 0.0)
    u = v2 / torch.clamp_min(n, 1e-30)
    return torch.stack([u[0], u[1], n, cmd.heading[0], cmd.heading[1]]).to(dtype)


# --------------------------------------------------------------------------
# the plain version and the kernel wrapper


def fused_rollout_cost_reference(
    m: PhysicsModel, state0, ctrl_seqs: torch.Tensor, cmd,
    prev_ctrl0: torch.Tensor, frame_skip: int, solver_iterations: int = 4,
    ls_iterations: int = 8, height: float = 0.13,
    dp: Optional[DomainParams] = None,
) -> torch.Tensor:
    """(S,) total walking-stage costs, in eager PyTorch: the kernel's
    plain version, on whatever device the tensors are on. It is the leg
    path of ``solvers.rollout.lane_batched_rollout_cost`` with the
    walking stage cost."""
    from ..solvers import rollout

    sl = SensorSlices.from_model(m)
    dt = ctrl_seqs.dtype

    def cost_fn(sens, ctrl, prev, c):
        return rollout.walking_stage_cost(sl, sens, ctrl, prev, c,
                                          height=height)

    cmd = type(cmd)(*(x.to(dt) for x in cmd))
    return rollout.lane_batched_rollout_cost(
        m, rollout.RolloutConfig(horizon=ctrl_seqs.shape[1],
                                 frame_skip=frame_skip),
        cost_fn, state0, ctrl_seqs, cmd, prev_ctrl0,
        newton_iterations=solver_iterations, ls_iterations=ls_iterations,
        engine_impl="leg", dp=dp)


_DP_ORDER = ("friction", "gain_scale", "base_mass_scale", "tilt_x", "tilt_y",
             "terrain_amp", "terrain_freq")


def _library(dtype: torch.dtype) -> ctypes.CDLL:
    name = {torch.float32: "float32", torch.float64: "float64"}[dtype]
    lib = _build.load(KERNEL_SOURCE, name)
    if not getattr(lib, "_qg_bound", False):
        lib.qg_model_size.restype = ctypes.c_int
        lib.qg_model_size.argtypes = []
        lib.qg_fused_rollout.restype = ctypes.c_int
        lib.qg_fused_rollout.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
            + [ctypes.c_double, ctypes.c_void_p])
        size = lib.qg_model_size()
        if size != ctypes.sizeof(model_struct(dtype)):
            raise RuntimeError(
                f"LegModel layout mismatch: kernel {size} bytes, "
                f"ctypes {ctypes.sizeof(model_struct(dtype))}")
        lib._qg_bound = True
    return lib


def fused_rollout_cost(
    m: PhysicsModel, state0, ctrl_seqs: torch.Tensor, cmd,
    prev_ctrl0: torch.Tensor, frame_skip: int, solver_iterations: int = 4,
    ls_iterations: int = 8, height: float = 0.13,
    dp: Optional[DomainParams] = None,
) -> torch.Tensor:
    """(S,) total walking-stage costs of H-step rollouts from ``state0``
    under ``ctrl_seqs`` (S, H, nu), one kernel launch. ``dp`` is an
    optional ``DomainParams`` of (S,) lanes. CPU tensors go to the plain
    version; CUDA tensors to the kernel, which raises rather than fall
    back."""
    if ctrl_seqs.device.type == "cpu":
        return fused_rollout_cost_reference(
            m, state0, ctrl_seqs, cmd, prev_ctrl0, frame_skip,
            solver_iterations, ls_iterations, height, dp)
    if ctrl_seqs.device.type != "cuda":
        raise ValueError(f"unsupported device {ctrl_seqs.device}")
    S, H, nu = ctrl_seqs.shape
    dt, dev = ctrl_seqs.dtype, ctrl_seqs.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"fused_rollout_cost takes float32/float64, got {dt}")
    if nu != m.nu or nu != 12:
        raise ValueError(f"ctrl_seqs last dim {nu} != 12 actuators")
    if frame_skip < 1 or H < 1:
        raise ValueError("frame_skip and the horizon must be >= 1")

    def vec(x, n):
        x = torch.as_tensor(x).to(device=dev, dtype=dt).contiguous()
        if x.shape != (n,):
            raise ValueError(f"expected shape ({n},), got {tuple(x.shape)}")
        return x

    qpos, qvel = vec(state0.qpos, m.nq), vec(state0.qvel, m.nv)
    act, prev = vec(state0.act, m.na), vec(prev_ctrl0, nu)
    seqs = ctrl_seqs.permute(1, 2, 0).contiguous()  # (H, nu, S)
    cmd_scal = command_scalars(cmd, dt).to(dev).contiguous()
    dp = dp if dp is not None else DomainParams()
    if dp.terrain_amp is not None and dp.terrain_freq is None:
        raise ValueError("DomainParams.terrain_amp requires terrain_freq")
    lanes = []
    for name in _DP_ORDER:
        v = getattr(dp, name)
        if v is None or (name == "terrain_freq" and dp.terrain_amp is None):
            lanes.append(None)
            continue
        if (v.device != dev or v.dtype != dt or v.shape != (S,)
                or not v.is_contiguous()):
            raise ValueError(f"DomainParams.{name} must be a contiguous "
                             f"({S},) {dt} tensor on {dev}")
        lanes.append(v)
    model = _model_buffer(m, dt, dev)
    lib = _library(dt)
    out = torch.empty(S, dtype=dt, device=dev)
    err = lib.qg_fused_rollout(
        model.data_ptr(), qpos.data_ptr(), qvel.data_ptr(), act.data_ptr(),
        seqs.data_ptr(), prev.data_ptr(), cmd_scal.data_ptr(),
        *[0 if v is None else v.data_ptr() for v in lanes],
        out.data_ptr(), S, H, frame_skip, solver_iterations, ls_iterations,
        float(height), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_rollout_cost launch failed: CUDA error {err}")
    launch_counts["fused_rollout_cost"] += 1
    return out


# --------------------------------------------------------------------------
# operation count (for the kernel's roofline bound)


# aten ops that compute, by how they are counted. An op is counted at one
# operation per output element (compares and selects included), one or
# two per input element for a reduction (a norm squares and adds), and
# 2 K per output element for a contraction
# of inner size K: an FMA is two operations, as the card's FP32 peak
# counts it. Transcendentals count one, though the card spends more on
# them, so the count stays a lower bound on the work.
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "reciprocal", "sqrt",
    "rsqrt", "pow", "square", "exp", "log", "sin", "cos", "tanh", "atan2",
    "sign", "floor", "clamp", "clamp_min", "clamp_max", "minimum", "maximum",
    "where", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and",
    "bitwise_or", "bitwise_not", "logical_and", "logical_or", "logical_not"})
_REDUCTIONS = {"sum": 1, "prod": 1, "mean": 1, "amax": 1, "amin": 1,
               "linalg_vector_norm": 2}
_CONTRACTIONS = frozenset({"dot", "mv", "mm", "bmm"})
# aten ops that only make, move or reinterpret data: no operations
_DATA = frozenset({
    "select", "slice", "index", "index_select", "gather", "stack", "cat",
    "view", "_unsafe_view", "reshape", "expand", "permute", "t",
    "transpose", "unsqueeze", "squeeze", "alias", "as_strided", "split",
    "split_with_sizes", "unbind", "clone", "copy", "_to_copy", "detach",
    "lift_fresh", "lift_fresh_copy", "scalar_tensor", "_local_scalar_dense",
    "empty", "empty_like", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "fill", "new_zeros", "new_full", "new_empty",
    "arange", "repeat"})


def _op_count(func, args, out) -> int:
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _DATA:
        return 0
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(o, torch.Tensor)]
    if name in _ELEMENTWISE:
        return sum(o.numel() for o in outs)
    if name in _REDUCTIONS:
        return _REDUCTIONS[name] * args[0].numel()
    if name in _CONTRACTIONS:
        return 2 * args[0].shape[-1] * outs[0].numel()
    raise NotImplementedError(
        f"aten op {name!r} is not classified for the operation count")


def count_ops(fn, *args, **kwargs):
    """(result, operations) of ``fn(*args, **kwargs)``, run eagerly on
    the CPU under a dispatch mode that counts every aten op as the lists
    above say. An op in no list raises, so none is left out unseen."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            count[0] += _op_count(func, args, out)
            return out

    with _Count():
        result = fn(*args, **kwargs)
    return result, count[0]


def rollout_flops(m: PhysicsModel, horizon: int, frame_skip: int,
                solver_iterations: int, ls_iterations: int,
                dp: Optional[DomainParams] = None, lanes: int = 4) -> float:
    """Operations (``count_ops``) of ONE rollout: the plain version run on
    ``lanes`` CPU lanes, divided by ``lanes``. The work has no
    data-dependent branch: fixed Newton / line-search budgets and full
    vertex loops. ``dp`` fields, when given, must be (lanes,) tensors."""
    from ..physics.engine import make_state
    from ..tasks.commands import make

    dt = torch.float64
    st = make_state(m, dtype=dt, device="cpu")
    seqs = torch.zeros((lanes, horizon, m.nu), dtype=dt)
    cmd = make(torch.tensor([0.2, 0.0], dtype=dt), torch.tensor(0.0, dtype=dt))
    prev = torch.zeros(m.nu, dtype=dt)
    _, n = count_ops(fused_rollout_cost_reference, m, st, seqs, cmd, prev,
                     frame_skip, solver_iterations, ls_iterations, dp=dp)
    return n / lanes
