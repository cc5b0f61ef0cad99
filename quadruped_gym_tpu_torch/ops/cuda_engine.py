"""The CUDA kernels of the leg-batched physics and their wrappers.

Counterpart of ``quadruped_gym_tpu/ops/pallas_engine.py``, which holds the
JAX package's two Pallas TPU kernels:

* ``fused_rollout_cost`` (``_rollout_kernel`` there): for each of S
  rollouts from one shared start state, H control steps x ``frame_skip``
  leg-engine substeps at a fixed Newton / line-search budget, with the
  walking stage cost summed; one launch per solve of
  ``csrc/rollout_kernel.cu``.
* ``step`` / ``control_step`` (``_substep_kernel`` there): one substep, or
  the ``frame_skip`` substeps of a control step, per lane of a batch-minor
  ``LaneState``, writing every sensor; one launch of
  ``csrc/substep_kernel.cu`` per call.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``fused_rollout_cost_reference``, ``step_reference``,
``control_step_reference``: the eager leg engine) only for CPU tensors.
The model's constants are packed into one ``LegModel`` struct
(``csrc/leg_model.cuh``) and uploaded once per (model, dtype, device).

Both kernels give a robot to four threads, one per leg, times a split of
1, 2 or 4 replicas that share the hull-vertex scans, and keep the
contact rows of the model's slots in dynamic shared memory, one column a
leg. ``launch_geometry`` chooses the split, the block size, the grid and
the shared bytes of a launch from the model's slot count, the type, the
batch and the warps a scheduler its replicas may fill; the C launch
functions take them as arguments.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.spec import (
    SENSOR_ACCELEROMETER,
    SENSOR_FRAMELINVEL,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_GYRO,
    SENSOR_JOINTPOS,
    SENSOR_VELOCIMETER,
    DomainParams,
    PhysicsModel,
)
from ..tasks.rewards import JOINT_CENTERS, SensorSlices
from ..utils import profiling
from . import _build
from . import leg_engine as LE
from .lane_engine import LaneState, _kb_from_solref, _np_quat_mat, _static

KERNEL_SOURCE = "rollout_kernel.cu"
SUBSTEP_SOURCE = "substep_kernel.cu"
MAX_GROUPS = 7
MAX_VERTS = 2048
MAX_SENSORS = 24
# sensor kinds the kernels' sensor table takes, by their size
_SENSOR_DIMS = {SENSOR_JOINTPOS: 1, SENSOR_ACCELEROMETER: 3, SENSOR_GYRO: 3,
                SENSOR_FRAMEPOS: 3, SENSOR_FRAMELINVEL: 3,
                SENSOR_FRAMEXAXIS: 3, SENSOR_FRAMEZAXIS: 3,
                SENSOR_VELOCIMETER: 3}

# Launch limits. The first four mirror csrc/leg_step.cuh (values a contact
# slot keeps per thread) and csrc/launch.cuh (the kernels'
# __launch_bounds__: largest block, blocks an SM must hold of it);
# the rest are the H100's: SMs, dynamic shared memory a block may ask for
# (227 KB), and the shared memory of an SM (228 KB), of which each resident
# block costs 1 KB besides its own, and the warp schedulers of an SM.
# SPLITS: the replicas of a leg the kernels are built for
# (csrc/launch.cuh::with_split), largest first. LONG_SCANS: the packed
# hull vertices from which the substep kernel's replicas may fill two
# warps a scheduler (``scheduler_warps``).
ROW_VALS = 40
MAX_SLOTS = 3 * MAX_GROUPS
MAX_THREADS = 128
MIN_BLOCKS = 2
SM_COUNT = 132
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024
SMEM_BLOCK_RESERVED = 1024
WARP = 32
SCHEDULERS = 4
SPLITS = (4, 2, 1)
LONG_SCANS = 1024

# launches of each kernel wrapper; a run sets them to 0 and reads them
launch_counts = {"fused_rollout_cost": 0, "substep": 0}

# what the last launch of each kernel by its wrapper got (an eager call or
# a CUDA graph's capture; a replay runs no wrapper): by kernel, the
# model's contact slots a thread keeps rows for (``slots``: those of the
# leg levels, ``leg_slots``, and those of the base's groups,
# ``base_slots``), its packed hull vertices (``verts``), the launch's
# ``grid``, ``threads`` and ``smem_bytes`` a block, its ``split`` (the
# replicas of a leg: how often the vertex scans were split), and what the
# runtime says of the built kernel at that size (``registers`` a thread,
# ``local_bytes`` a thread, ``blocks_per_sm``)
geometry: dict = {}


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
    ("joint_centers", 12), ("grp_pos", 4 * 3 * MAX_GROUPS),
    ("grp_mat", 4 * 9 * MAX_GROUPS), ("grp_margin", MAX_GROUPS),
    ("grp_margin2", MAX_GROUPS), ("grp_theta2", MAX_GROUPS),
    ("grp_theta3", MAX_GROUPS), ("grp_inc", MAX_GROUPS),
    ("grp_friction", MAX_GROUPS), ("grp_imp", 7 * MAX_GROUPS),
    ("grp_K", MAX_GROUPS), ("grp_B", MAX_GROUPS),
    ("grp_2invweight", MAX_GROUPS), ("vert", 3 * MAX_VERTS),
    ("vert_n2", MAX_VERTS),
]
_INT_LAYOUT = [("ngroup", 1), ("grp_level", MAX_GROUPS),
               ("grp_nslot", MAX_GROUPS), ("grp_vstart", MAX_GROUPS),
               ("grp_nvert", MAX_GROUPS), ("nsensordata", 1), ("nsensor", 1),
               ("sens_kind", MAX_SENSORS), ("sens_adr", MAX_SENSORS),
               ("sens_joint", MAX_SENSORS)]


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


def _pack_sensors(m: PhysicsModel, P) -> None:
    """The sensor table: kind, sensordata address and, for a joint
    position, the leg joint 3 * leg + level it reads. Every entry of
    sensordata must be written by exactly one sensor."""
    if len(m.sensors) > MAX_SENSORS:
        raise LE.IncompatibleModelError(
            f"{len(m.sensors)} sensors; the kernel takes {MAX_SENSORS}")
    covered = np.zeros(m.nsensordata, np.int64)
    P.nsensordata = m.nsensordata
    P.nsensor = len(m.sensors)
    for i, sn in enumerate(m.sensors):
        if _SENSOR_DIMS.get(sn.kind) != sn.dim:
            raise LE.IncompatibleModelError(
                f"sensor kind {sn.kind} of size {sn.dim} is not supported")
        joint = 0
        if sn.kind == SENSOR_JOINTPOS:
            joint = m.jnt_qposadr[sn.objid] - 7
            if not 0 <= joint < 12:
                raise LE.IncompatibleModelError(
                    f"joint-position sensor {i} does not read a leg joint")
        covered[sn.adr: sn.adr + sn.dim] += 1
        P.sens_kind[i] = sn.kind
        P.sens_adr[i] = sn.adr
        P.sens_joint[i] = joint
    if not np.all(covered == 1):
        raise LE.IncompatibleModelError(
            "the sensors do not tile sensordata exactly once")


def slot_budgets(m: PhysicsModel) -> list:
    """Contact slots per leg of each collision group, in group order (a
    group on the base included: its slots take rows in every thread)."""
    return [LE._slot_budget(np.asarray(m.col_hull_verts[group[0]], np.float64),
                            float(m.col_theta2[group[0]]),
                            float(m.col_theta3[group[0]]))
            for _, group in LE._leg_static(m).col_groups]


def model_slots(m: PhysicsModel) -> int:
    """Contact slots per leg over all groups: what sizes a launch's rows."""
    if "_cuda_model_slots" not in m.__dict__:
        m.__dict__["_cuda_model_slots"] = sum(slot_budgets(m))
    return m.__dict__["_cuda_model_slots"]


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
    _pack_sensors(m, P)

    groups = ls.col_groups
    if len(groups) > MAX_GROUPS:
        raise LE.IncompatibleModelError(
            f"{len(groups)} collision groups; the kernel takes {MAX_GROUPS}")
    vstart = 0
    P.ngroup = len(groups)
    budgets = slot_budgets(m)
    for g, (level, group) in enumerate(groups):
        g0 = group[0]
        verts = np.asarray(m.col_hull_verts[g0], np.float64)
        V = len(verts)
        if vstart + V > MAX_VERTS:
            raise LE.IncompatibleModelError(
                f"more than {MAX_VERTS} hull vertices in all")
        if level == LE.BASE_ONE and V < 4:  # a quarter a thread
            raise LE.IncompatibleModelError(
                "a geom on the base needs a hull of 4 vertices or more")
        P.grp_level[g] = level
        P.grp_nslot[g] = budgets[g]
        P.grp_vstart[g] = vstart
        P.grp_nvert[g] = V
        # each leg's member of the group, its frame in its body
        members = group if level == LE.BASE else (g0,) * 4
        for leg, geom in enumerate(members):
            for c in range(3):
                P.grp_pos[12 * g + 3 * leg + c] = float(m.col_geom_pos[geom][c])
            for c, v in enumerate(
                    _np_quat_mat(m.col_geom_quat[geom]).reshape(-1)):
                P.grp_mat[36 * g + 9 * leg + c] = float(v)
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
        body = ls.base if level < 0 else ls.leg_bodies[level][0]
        P.grp_2invweight[g] = 2.0 * float(m.body_invweight0[body][0])
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
        with profiling.span("cuda_engine.pack_model"):
            raw = bytes(pack_model(m, dtype))
            cache[key] = torch.frombuffer(bytearray(raw),
                                          dtype=torch.uint8).to(device)
    return cache[key]


def _model_sizes(m: PhysicsModel) -> dict:
    """The model's slots a thread keeps rows for, those of the leg levels
    and of the base's groups, and its packed hull vertices."""
    if "_cuda_model_sizes" not in m.__dict__:
        groups = LE._leg_static(m).col_groups
        base = sum(n for (level, _), n in zip(groups, slot_budgets(m))
                   if level < 0)
        m.__dict__["_cuda_model_sizes"] = {
            "slots": model_slots(m), "leg_slots": model_slots(m) - base,
            "base_slots": base,
            "verts": sum(len(m.col_hull_verts[grp[0]]) for _, grp in groups)}
    return m.__dict__["_cuda_model_sizes"]


@functools.lru_cache(maxsize=None)
def _runtime_info(source: str, dtype, threads: int, smem_bytes: int,
                  split: int) -> dict:
    return kernel_info(source, dtype, threads, smem_bytes, split)


def _record_geometry(kernel: str, source: str, m: PhysicsModel, dtype,
                     geo: "LaunchGeometry") -> None:
    """Set ``geometry[kernel]`` for a launch of ``source`` at ``geo``; the
    runtime is asked once per (source, type, block, shared bytes, split)."""
    info = _runtime_info(source, dtype, geo.threads, geo.smem_bytes,
                         geo.split)
    geometry[kernel] = {
        **_model_sizes(m), "grid": geo.grid, "threads": geo.threads,
        "smem_bytes": geo.smem_bytes, "split": geo.split,
        "registers": info["registers"],
        "local_bytes": info["local_bytes"],
        "blocks_per_sm": info["blocks_per_sm"]}


# --------------------------------------------------------------------------
# launch geometry


class LaunchGeometry(NamedTuple):
    grid: int        # blocks
    threads: int     # threads per block, 4 x split per robot
    smem_bytes: int  # dynamic shared memory per block: the contact rows
    split: int = 1   # replicas of a leg, which share its rows and scans


def resident_blocks(threads: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` and ``smem_bytes`` an SM holds together, by
    its shared memory and by the register cap of the kernels' launch
    bounds (what ptxas actually used can only allow more)."""
    by_smem = SMEM_PER_SM // (smem_bytes + SMEM_BLOCK_RESERVED)
    by_regs = MAX_THREADS * MIN_BLOCKS // threads
    return min(by_smem, by_regs, 32)


def _blocks(per_column: int, n: int, split: int) -> Optional[LaunchGeometry]:
    """The block size for ``n`` robots of ``4 * split`` threads whose leg
    columns take ``per_column`` bytes of rows each: of the block sizes
    (multiples of a warp up to the kernels' launch bound) whose rows fit
    the 227 KB a block may have, one whose grid covers every SM if there is
    one, and among those the one that keeps most threads resident on an SM,
    the smaller block on a tie; if none covers the card, the smallest.
    None if not even one warp's rows fit."""
    best, best_key = None, None
    for threads in range(WARP, MAX_THREADS + 1, WARP):
        smem = threads // split * per_column
        if smem > SMEM_PER_BLOCK:
            break
        grid = -(-4 * split * n // threads)
        resident = threads * resident_blocks(threads, smem)
        covers = grid >= SM_COUNT
        key = (covers, resident if covers else 0, -threads)
        if best_key is None or key > best_key:
            best = LaunchGeometry(grid, threads, smem, split)
            best_key = key
    return best


def scheduler_warps(kernel: str, m: PhysicsModel) -> int:
    """The warps a scheduler ``launch_geometry`` may fill with replicas
    for ``kernel`` ("fused_rollout_cost" or "substep") on ``m``: 2 for the
    substep kernel on a model with ``LONG_SCANS`` packed hull vertices or
    more, else 1. Past one warp a scheduler the replicas' repeated work
    competes for issue; only long scans repay it, and only in the substep
    kernel. PERF.md has the card sweep: at 2,048 robots, split 4 against
    2, the substep kernel ran 6-18 % faster on ``full`` (1,702 vertices)
    and 12-30 % slower on the fast plant (140); the rollout kernel on
    ``full`` up to 1.9x slower."""
    if kernel == "substep" and _model_sizes(m)["verts"] >= LONG_SCANS:
        return 2
    return 1


def launch_geometry(nslot: int, dtype: torch.dtype, n: int,
                    per_scheduler: int = 1) -> LaunchGeometry:
    """Split, block size, grid and dynamic shared bytes for ``n`` robots
    (rollouts or lanes) of a model with ``nslot`` contact slots per leg.

    A robot takes 4 x split threads, a leg's ``split`` replicas sharing
    one column of ``ROW_VALS * nslot`` values of shared memory. Replicas
    split only the hull-vertex scans and repeat the rest of the work, so
    they pay where the grid leaves the SMs' schedulers idle. The split is
    the largest of 4, 2 whose grid (``_blocks``) is one wave (every block
    resident at once on the ``SM_COUNT`` SMs at that block and shared
    size) of at most ``per_scheduler`` warps a scheduler (``SCHEDULERS``
    an SM; ``scheduler_warps`` gives it for a kernel and model), else 1:
    a batch that fills the schedulers at split 1 keeps one quad a robot.
    PERF.md has the card sweep the limit comes from: beyond one warp a
    scheduler the repeated work (the Newton solve above all) competes for
    issue: at ~8 warps an SM B1 on the fast plant and on the planning
    model at a 4/8 budget ran up to 2.4x slower.
    A model whose rows do not fit even one warp is refused."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32/float64, got {dtype}")
    if n < 1:
        raise ValueError("a launch needs at least one robot")
    if not 0 <= nslot <= MAX_SLOTS:
        raise LE.IncompatibleModelError(
            f"{nslot} contact slots per leg; the kernels take {MAX_SLOTS}")
    per_column = ROW_VALS * nslot * torch.empty((), dtype=dtype).element_size()
    most = WARP * SCHEDULERS * SM_COUNT * per_scheduler
    for split in SPLITS[:-1]:
        geo = _blocks(per_column, n, split)
        if geo is not None and geo.grid * geo.threads <= most and (
                geo.grid <= SM_COUNT * resident_blocks(geo.threads,
                                                       geo.smem_bytes)):
            return geo
    geo = _blocks(per_column, n, 1)
    if geo is None:
        raise LE.IncompatibleModelError(
            f"the contact rows of {nslot} slots take {WARP * per_column} "
            f"bytes for one warp; a block has {SMEM_PER_BLOCK}")
    return geo


def _check_launch(err: int, what: str, geo: LaunchGeometry) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} (grid {geo.grid}, "
            f"{geo.threads} threads, {geo.smem_bytes} bytes of dynamic "
            f"shared memory a block, split {geo.split})")


def kernel_info(source: str, dtype: torch.dtype, threads: int,
                smem_bytes: int, split: int = 1) -> dict:
    """What the CUDA runtime reports for the built kernel of ``source``
    for ``split`` replicas at a block size and dynamic shared size:
    registers per thread, local (stack and spill) bytes per thread,
    resident blocks per SM. Needs a card."""
    lib = _library(source, dtype)
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.qg_kernel_info(threads, smem_bytes, split, ctypes.byref(regs),
                             ctypes.byref(local), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"kernel_info({source}): CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": blocks.value, "threads": threads,
            "smem_bytes": smem_bytes, "split": split}


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


def _library(source: str, dtype: torch.dtype) -> ctypes.CDLL:
    name = {torch.float32: "float32", torch.float64: "float64"}[dtype]
    lib = _build.load(source, name)
    if not getattr(lib, "_qg_bound", False):
        lib.qg_model_size.restype = ctypes.c_int
        lib.qg_model_size.argtypes = []
        lib.qg_kernel_info.restype = ctypes.c_int
        lib.qg_kernel_info.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
        if source == KERNEL_SOURCE:
            lib.qg_fused_rollout.restype = ctypes.c_int
            lib.qg_fused_rollout.argtypes = (
                [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                + [ctypes.c_double] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        else:
            lib.qg_substeps.restype = ctypes.c_int
            lib.qg_substeps.argtypes = (
                [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])
        size = lib.qg_model_size()
        if size != ctypes.sizeof(model_struct(dtype)):
            raise RuntimeError(
                f"LegModel layout mismatch: kernel {size} bytes, "
                f"ctypes {ctypes.sizeof(model_struct(dtype))}")
        lib._qg_bound = True
    return lib


def _dp_lanes(dp: Optional[DomainParams], n: int, dt, dev) -> list:
    """The 7 DomainParams lanes in the kernels' order, None where
    nominal; each given lane must be a contiguous (n,) tensor of the
    state's type on its device."""
    dp = dp if dp is not None else DomainParams()
    if dp.terrain_amp is not None and dp.terrain_freq is None:
        raise ValueError("DomainParams.terrain_amp requires terrain_freq")
    lanes = []
    for name in _DP_ORDER:
        v = getattr(dp, name)
        if v is None or (name == "terrain_freq" and dp.terrain_amp is None):
            lanes.append(None)
            continue
        if (v.device != dev or v.dtype != dt or v.shape != (n,)
                or not v.is_contiguous()):
            raise ValueError(f"DomainParams.{name} must be a contiguous "
                             f"({n},) {dt} tensor on {dev}")
        lanes.append(v)
    return lanes


def fused_rollout_cost(
    m: PhysicsModel, state0, ctrl_seqs: torch.Tensor, cmd,
    prev_ctrl0: torch.Tensor, frame_skip: int, solver_iterations: int = 4,
    ls_iterations: int = 8, height: float = 0.13,
    dp: Optional[DomainParams] = None, _geometry=None,
) -> torch.Tensor:
    """(S,) total walking-stage costs of H-step rollouts from ``state0``
    under ``ctrl_seqs`` (S, H, nu), one kernel launch. ``dp`` is an
    optional ``DomainParams`` of (S,) lanes. CPU tensors go to the plain
    version; CUDA tensors to the kernel, which raises rather than fall
    back. ``_geometry`` overrides ``launch_geometry``'s choice (a check
    of the kernel at another split uses it)."""
    with profiling.span("cuda_engine.fused_rollout_cost"):
        if ctrl_seqs.device.type == "cpu":
            return fused_rollout_cost_reference(
                m, state0, ctrl_seqs, cmd, prev_ctrl0, frame_skip,
                solver_iterations, ls_iterations, height, dp)
        if ctrl_seqs.device.type != "cuda":
            raise ValueError(f"unsupported device {ctrl_seqs.device}")
        S, H, nu = ctrl_seqs.shape
        dt, dev = ctrl_seqs.dtype, ctrl_seqs.device
        if dt not in (torch.float32, torch.float64):
            raise TypeError(
                f"fused_rollout_cost takes float32/float64, got {dt}")
        if nu != m.nu or nu != 12:
            raise ValueError(f"ctrl_seqs last dim {nu} != 12 actuators")
        if frame_skip < 1 or H < 1:
            raise ValueError("frame_skip and the horizon must be >= 1")

        def vec(x, n):
            x = torch.as_tensor(x).to(device=dev, dtype=dt).contiguous()
            if x.shape != (n,):
                raise ValueError(
                    f"expected shape ({n},), got {tuple(x.shape)}")
            return x

        qpos, qvel = vec(state0.qpos, m.nq), vec(state0.qvel, m.nv)
        act, prev = vec(state0.act, m.na), vec(prev_ctrl0, nu)
        seqs = ctrl_seqs.permute(1, 2, 0).contiguous()  # (H, nu, S)
        cmd_scal = command_scalars(cmd, dt).to(dev).contiguous()
        lanes = _dp_lanes(dp, S, dt, dev)
        model = _model_buffer(m, dt, dev)
        geo = _geometry or launch_geometry(model_slots(m), dt, S)
        lib = _library(KERNEL_SOURCE, dt)
        out = torch.empty(S, dtype=dt, device=dev)
        args = (model.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
                act.data_ptr(), seqs.data_ptr(), prev.data_ptr(),
                cmd_scal.data_ptr(),
                *[0 if v is None else v.data_ptr() for v in lanes],
                out.data_ptr(), S, H, frame_skip, solver_iterations,
                ls_iterations, float(height), *geo,
                torch.cuda.current_stream(dev).cuda_stream)
        with profiling.span("cuda_engine.launch"):
            err = lib.qg_fused_rollout(*args)
        _check_launch(err, "fused_rollout_cost", geo)
        launch_counts["fused_rollout_cost"] += 1
        _record_geometry("fused_rollout_cost", KERNEL_SOURCE, m, dt, geo)
        return out


# --------------------------------------------------------------------------
# the substep kernel: plain versions and wrappers


def step_reference(m: PhysicsModel, ls: LaneState, ctrl: torch.Tensor,
                   solver_iterations: int = 4, ls_iterations: int = 8,
                   dp: Optional[DomainParams] = None,
                   compute_sensors: bool = True) -> LaneState:
    """One substep in eager PyTorch: the kernel's plain version, which is
    ``leg_engine.step`` except that without sensors the returned
    sensordata is zeros (the eager engine passes the old one through)."""
    out = LE._step_impl(m, ls, ctrl, solver_iterations, ls_iterations,
                        compute_sensors=compute_sensors, dp=dp)
    if not compute_sensors:
        out = out._replace(sensordata=torch.zeros_like(out.sensordata))
    return out


def control_step_reference(m: PhysicsModel, ls: LaneState,
                           ctrl: torch.Tensor, frame_skip: int,
                           solver_iterations: int = 4, ls_iterations: int = 8,
                           dp: Optional[DomainParams] = None) -> LaneState:
    """``frame_skip`` substeps under constant control, sensors on the
    last, in eager PyTorch (``leg_engine.control_step``)."""
    return LE.control_step(m, ls, ctrl, frame_skip, solver_iterations,
                           ls_iterations, dp=dp)


def _launch_substeps(m, ls, ctrl, nsub, solver_iterations, ls_iterations, dp,
                     compute_sensors, geometry=None) -> LaneState:
    """Check, allocate and launch. ``geometry`` overrides
    ``launch_geometry``'s choice (the checks of a refused launch and of
    another split use it)."""
    dev, dt = ls.qpos.device, ls.qpos.dtype
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the substep kernel takes float32/float64, got {dt}")
    if nsub < 1:
        raise ValueError("frame_skip must be >= 1")
    if (m.nq, m.nv, m.na, m.nu) != (19, 18, 12, 12):
        raise ValueError("the substep kernel takes the 12-servo quadruped "
                         "(nq 19, nv 18, na 12, nu 12)")
    B = ls.qpos.shape[-1]

    def rows(x, n, name):
        if x.shape != (n, B) or x.dtype != dt or x.device != dev:
            raise ValueError(
                f"{name} must be a ({n}, {B}) {dt} tensor on {dev}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}")
        return x.contiguous()  # a copy only where a view was passed

    qpos, qvel = rows(ls.qpos, m.nq, "qpos"), rows(ls.qvel, m.nv, "qvel")
    act, ctrl = rows(ls.act, m.na, "act"), rows(ctrl, m.nu, "ctrl")
    if ls.time.shape != (B,):
        raise ValueError(f"time must have shape ({B},)")
    lanes = _dp_lanes(dp, B, dt, dev)
    model = _model_buffer(m, dt, dev)
    geo = geometry or launch_geometry(model_slots(m), dt, B,
                                      scheduler_warps("substep", m))
    lib = _library(SUBSTEP_SOURCE, dt)
    qpos_o, qvel_o, act_o = (torch.empty_like(x) for x in (qpos, qvel, act))
    sens_o = torch.empty((m.nsensordata, B), dtype=dt, device=dev)
    args = (model.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
            act.data_ptr(), ctrl.data_ptr(),
            *[0 if v is None else v.data_ptr() for v in lanes],
            qpos_o.data_ptr(), qvel_o.data_ptr(), act_o.data_ptr(),
            sens_o.data_ptr(), B, nsub, solver_iterations, ls_iterations,
            int(bool(compute_sensors)), *geo,
            torch.cuda.current_stream(dev).cuda_stream)
    with profiling.span("cuda_engine.launch"):
        err = lib.qg_substeps(*args)
    _check_launch(err, "substep kernel", geo)
    launch_counts["substep"] += 1
    _record_geometry("substep", SUBSTEP_SOURCE, m, dt, geo)
    time = ls.time
    for _ in range(nsub):  # as the plain version adds it, substep by substep
        time = time + m.timestep
    return LaneState(qpos=qpos_o, qvel=qvel_o, act=act_o, time=time,
                     sensordata=sens_o)


def step(m: PhysicsModel, ls: LaneState, ctrl: torch.Tensor,
         solver_iterations: int = 4, ls_iterations: int = 8,
         dp: Optional[DomainParams] = None,
         compute_sensors: bool = True) -> LaneState:
    """One physics step (mj_step semantics) per lane, one kernel launch.
    ``ctrl`` is (nu, B); ``dp`` an optional ``DomainParams`` of (B,)
    lanes. With ``compute_sensors=False`` the returned sensordata is
    zeros. CPU tensors go to the plain version; CUDA tensors to the
    kernel, which raises rather than fall back."""
    if ls.qpos.device.type == "cpu":
        return step_reference(m, ls, ctrl, solver_iterations, ls_iterations,
                              dp, compute_sensors)
    return _launch_substeps(m, ls, ctrl, 1, solver_iterations, ls_iterations,
                            dp, compute_sensors)


def control_step(m: PhysicsModel, ls: LaneState, ctrl: torch.Tensor,
                 frame_skip: int, solver_iterations: int = 4,
                 ls_iterations: int = 8,
                 dp: Optional[DomainParams] = None) -> LaneState:
    """``frame_skip`` substeps under constant control with the sensors of
    the last, in ONE kernel launch: the state stays in registers between
    the substeps. CPU tensors go to the plain version; CUDA tensors to the
    kernel, which raises rather than fall back."""
    with profiling.span("cuda_engine.control_step"):
        if ls.qpos.device.type == "cpu":
            return control_step_reference(m, ls, ctrl, frame_skip,
                                          solver_iterations, ls_iterations, dp)
        return _launch_substeps(m, ls, ctrl, frame_skip, solver_iterations,
                                ls_iterations, dp, True)


# --------------------------------------------------------------------------
# operation count (for the kernel's roofline bound)


# aten ops that compute, by how they are counted. An op is counted at one
# operation per output element (compares and selects included; three for
# a cross product's two products and difference), one or two per input
# element for a reduction (a norm squares and adds), one per added
# element for a scatter-add, and 2 K per output element for a contraction
# of inner size K: an FMA is two operations, as the card's FP32 peak
# counts it. Transcendentals count one, though the card spends more on
# them, so the count stays a lower bound on the work.
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "reciprocal", "sqrt",
    "rsqrt", "pow", "square", "exp", "log", "sin", "cos", "tanh", "atan2",
    "sign", "floor", "clamp", "clamp_min", "clamp_max", "minimum", "maximum",
    "where", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and",
    "bitwise_or", "bitwise_not", "logical_and", "logical_or", "logical_not"})
_PER_OUTPUT = {"linalg_cross": 3}
_REDUCTIONS = {"sum": 1, "prod": 1, "mean": 1, "amax": 1, "amin": 1,
               "argmax": 1, "argmin": 1, "linalg_vector_norm": 2}
_SCATTER_ADDS = frozenset({"index_add"})
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
    "arange", "repeat", "diagonal", "index_copy"})


def _op_count(func, args, out) -> int:
    name = func.overloadpacket.__name__.rstrip("_")
    if name in _DATA:
        return 0
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(o, torch.Tensor)]
    if name in _ELEMENTWISE:
        return sum(o.numel() for o in outs)
    if name in _PER_OUTPUT:
        return _PER_OUTPUT[name] * sum(o.numel() for o in outs)
    if name in _REDUCTIONS:
        return _REDUCTIONS[name] * args[0].numel()
    if name in _SCATTER_ADDS:  # (self, dim, index, source)
        return args[3].numel()
    if name in _CONTRACTIONS:
        return 2 * args[0].shape[-1] * outs[0].numel()
    raise NotImplementedError(
        f"aten op {name!r} is not classified for the operation count")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _byte_count(func, args, kwargs, out) -> int:
    """Bytes an op reads and writes: each tensor input once, each output
    once; an op whose outputs only alias its input (a view) moves none."""
    rets = func._schema.returns
    if func.overloadpacket.__name__ == "_unsafe_view" or (rets and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets)):
        return 0
    return sum(t.numel() * t.element_size()
               for t in _tensors([args, list(kwargs.values()), out]))


def count_cost(fn, *args, **kwargs):
    """(result, operations, bytes) of ``fn(*args, **kwargs)``, run eagerly
    under a dispatch mode that counts every aten op: operations as the
    lists above say (an op in no list raises, so none is left out
    unseen), bytes as ``_byte_count`` says. The bytes are an unfused
    program's traffic, every intermediate written and read back: an
    upper bound on what a fused kernel of the same function moves."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0, 0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count[0] += _op_count(func, args, out)
            count[1] += _byte_count(func, args, kwargs, out)
            return out

    with _Count():
        result = fn(*args, **kwargs)
    return result, count[0], count[1]


def count_ops(fn, *args, **kwargs):
    """(result, operations) of ``fn(*args, **kwargs)``, run eagerly on
    the CPU under a dispatch mode that counts every aten op as the lists
    above say. An op in no list raises, so none is left out unseen."""
    result, ops, _ = count_cost(fn, *args, **kwargs)
    return result, ops


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


def substep_flops(m: PhysicsModel, nsub: int, solver_iterations: int,
                  ls_iterations: int, sensors: bool = True,
                  dp: Optional[DomainParams] = None, lanes: int = 4) -> float:
    """Operations (``count_ops``) of ``nsub`` substeps of ONE lane, with
    the sensors of the last when ``sensors``: the plain version run on
    ``lanes`` CPU lanes, divided by ``lanes``."""
    from .lane_engine import make_lane_state

    dt = torch.float64
    ls = make_lane_state(m, lanes, dtype=dt, device="cpu")
    ctrl = torch.zeros((m.nu, lanes), dtype=dt)

    def run():
        st = ls
        for _ in range(nsub - 1):
            st = step_reference(m, st, ctrl, solver_iterations, ls_iterations,
                                dp, compute_sensors=False)
        return step_reference(m, st, ctrl, solver_iterations, ls_iterations,
                              dp, compute_sensors=sensors)

    _, n = count_ops(run)
    return n / lanes
