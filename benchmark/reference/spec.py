# Frozen copy of quadruped_gym_tpu_torch/models/spec.py for the benchmark's plain
# reference: the same code, with its imports pointed at this folder. Later
# changes to the port do not reach it.
"""The static robot model, loaded from committed ``.npz`` snapshots.

Counterpart of ``quadruped_gym_tpu/models/spec.py``. The JAX package
compiles the MJCF with MuJoCo at build time; this package carries no
MuJoCo, so the three full-hull models it starts from are stored as
snapshots of the JAX package's
``get_model(collision_geom_prefixes=FEET_COLLISION_PREFIXES)``,
``get_model(collision_geom_prefixes=MPC_COLLISION_PREFIXES)`` and
``get_model()`` (``assets/{feet,mpc_plant,full}.npz``). The planning and
fast-plant models are derived from the first two by ``decimate_hulls``,
as the JAX package derives them. Regenerate the snapshots, where MuJoCo
and the JAX package are installed, with::

    python scripts/snapshot_torch_models.py
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Optional, Tuple

import numpy as np
import torch

# the raw snapshots the port loads too: the same files, read here anew
ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "quadruped_gym_tpu_torch", "models", "assets")

# MuJoCo sensor type enum values we support (mjtSensor).
SENSOR_JOINTPOS = 9
SENSOR_ACCELEROMETER = 1
SENSOR_GYRO = 3
SENSOR_FRAMEPOS = 26
SENSOR_FRAMELINVEL = 31
SENSOR_FRAMEXAXIS = 28
SENSOR_FRAMEZAXIS = 30
SENSOR_VELOCIMETER = 2

# geom-name prefixes of the collision sets the snapshots were built with:
# the lower-leg set of the closed-loop plant, and the feet-only set of the
# planning model
MPC_COLLISION_PREFIXES = ("foot", "shin", "ankle_servo")
FEET_COLLISION_PREFIXES = ("foot",)

# mjtJoint
JNT_FREE = 0
JNT_BALL = 1
JNT_SLIDE = 2
JNT_HINGE = 3


@dataclasses.dataclass(frozen=True)
class SensorEntry:
    kind: int
    objid: int  # joint id for jointpos, site id otherwise
    adr: int  # offset into the sensordata vector
    dim: int


@dataclasses.dataclass(frozen=True)
class PhysicsModel:
    """Static model description. All arrays are host numpy (float64/int)."""

    # sizes
    nq: int
    nv: int
    nu: int
    na: int
    nbody: int
    njnt: int
    nsensordata: int

    # options
    timestep: float
    gravity: np.ndarray  # (3,)
    solver_iterations: int
    solver_tolerance: float
    ls_iterations: int
    ls_tolerance: float
    impratio: float

    # bodies (index 0 is the world)
    body_parentid: Tuple[int, ...]
    body_jntadr: Tuple[int, ...]
    body_jntnum: Tuple[int, ...]
    body_dofadr: Tuple[int, ...]
    body_dofnum: Tuple[int, ...]
    body_pos: np.ndarray  # (nbody, 3) frame offset in parent
    body_quat: np.ndarray  # (nbody, 4)
    body_ipos: np.ndarray  # (nbody, 3) inertial frame in body
    body_iquat: np.ndarray  # (nbody, 4)
    body_mass: np.ndarray  # (nbody,)
    body_inertia: np.ndarray  # (nbody, 3) principal moments

    # joints
    jnt_type: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_axis: np.ndarray  # (njnt, 3) in body frame
    jnt_pos: np.ndarray  # (njnt, 3) anchor in body frame
    jnt_range: np.ndarray  # (njnt, 2)
    jnt_limited: Tuple[bool, ...]
    jnt_solref: np.ndarray  # (njnt, 2)
    jnt_solimp: np.ndarray  # (njnt, 5)
    jnt_margin: np.ndarray  # (njnt,)

    # dofs
    dof_damping: np.ndarray  # (nv,)
    dof_armature: np.ndarray  # (nv,)
    dof_jntid: Tuple[int, ...]
    dof_invweight0: np.ndarray  # (nv,) compile-time inverse weights
    body_invweight0: np.ndarray  # (nbody, 2) [translational, rotational]

    # actuators (all joint-transmission position servos in this robot)
    actuator_trnid: Tuple[int, ...]  # joint id per actuator
    actuator_gear: np.ndarray  # (nu,) scalar gear on the hinge axis
    actuator_dyntype: Tuple[int, ...]  # 3 == filterexact
    actuator_dynprm: np.ndarray  # (nu, 3) [timeconst, ...]
    actuator_gainprm: np.ndarray  # (nu, 3) [kp, 0, 0]
    actuator_biasprm: np.ndarray  # (nu, 3) [0, -kp, -kv]
    actuator_ctrlrange: np.ndarray  # (nu, 2)
    actuator_forcerange: np.ndarray  # (nu, 2)

    # collision: plane (floor) vs convex mesh geoms
    plane_pos: np.ndarray  # (3,)
    plane_normal: np.ndarray  # (3,) world
    col_geom_bodyid: Tuple[int, ...]  # per collidable mesh geom
    col_geom_pos: np.ndarray  # (ncol, 3) geom offset in body
    col_geom_quat: np.ndarray  # (ncol, 4)
    col_geom_names: Tuple[str, ...]
    col_hull_verts: Tuple[np.ndarray, ...]  # per geom (V_i, 3) hull vertices
    col_friction: np.ndarray  # (ncol, 3) combined tan/torsion (condim 3)
    col_solref: np.ndarray  # (ncol, 2) combined
    col_solimp: np.ndarray  # (ncol, 5) combined
    col_margin: np.ndarray  # (ncol,) combined margin
    col_gap: np.ndarray  # (ncol,)
    col_condim: Tuple[int, ...]
    # multi-contact selection thresholds (calibrated per mesh against
    # CPU MuJoCo by the JAX package)
    col_theta2: np.ndarray  # (ncol,) min planar distance for a 2nd contact
    col_theta3: np.ndarray  # (ncol,) min line distance for a 3rd contact

    # sensors
    sensors: Tuple[SensorEntry, ...]
    site_bodyid: int
    site_pos: np.ndarray  # (3,) site offset in body frame
    site_quat: np.ndarray  # (4,)

    # reset state
    qpos0: np.ndarray  # (nq,)

    # names for lookups
    joint_names: Tuple[str, ...]
    actuator_names: Tuple[str, ...]
    sensor_names: Tuple[str, ...]
    sensor_adr_by_name: Tuple[Tuple[str, int], ...]

    def sensor_adr(self, name: str) -> int:
        """Start offset of a named sensor in the 33-dim sensordata vector."""
        for n, adr in self.sensor_adr_by_name:
            if n == name:
                return adr
        raise KeyError(name)


# --------------------------------------------------------------------------
# snapshot (de)serialization: one .npz, no pickles


def _field_kind(f: dataclasses.Field) -> str:
    t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
    return t


def save_model(m: PhysicsModel, path: str) -> None:
    """Write ``m`` to a single ``.npz``. Ragged hull vertices are stored
    concatenated with offsets; names and sensors as arrays."""
    out = {}
    for f in dataclasses.fields(PhysicsModel):
        v = getattr(m, f.name)
        if f.name == "col_hull_verts":
            counts = np.array([len(x) for x in v], np.int64)
            out["col_hull_verts__flat"] = np.concatenate(
                [np.asarray(x, np.float64) for x in v])
            out["col_hull_verts__offsets"] = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
        elif f.name == "sensors":
            out["sensors"] = np.array(
                [[s.kind, s.objid, s.adr, s.dim] for s in v], np.int64)
        elif f.name == "sensor_adr_by_name":
            out["sensor_adr_by_name__names"] = np.array([n for n, _ in v])
            out["sensor_adr_by_name__adr"] = np.array(
                [a for _, a in v], np.int64)
        elif isinstance(v, tuple):
            if v and isinstance(v[0], str):
                out[f.name] = np.array(v)
            elif v and isinstance(v[0], (bool, np.bool_)):
                out[f.name] = np.array(v, np.bool_)
            else:
                out[f.name] = np.array(v, np.int64)
        else:
            out[f.name] = np.asarray(v)
    np.savez(path, **out)


def load_model(path: str) -> PhysicsModel:
    """Inverse of ``save_model``: python ints/floats/bools/strs and tuples
    where the JAX package's model has them, float64 arrays elsewhere."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    kw = {}
    for f in dataclasses.fields(PhysicsModel):
        t = _field_kind(f)
        if f.name == "col_hull_verts":
            flat, off = d["col_hull_verts__flat"], d["col_hull_verts__offsets"]
            kw[f.name] = tuple(flat[off[i]:off[i + 1]].copy()
                               for i in range(len(off) - 1))
        elif f.name == "sensors":
            kw[f.name] = tuple(SensorEntry(*(int(x) for x in row))
                               for row in d["sensors"])
        elif f.name == "sensor_adr_by_name":
            kw[f.name] = tuple(
                (str(n), int(a)) for n, a in zip(
                    d["sensor_adr_by_name__names"],
                    d["sensor_adr_by_name__adr"]))
        elif t == "int":
            kw[f.name] = int(d[f.name])
        elif t == "float":
            kw[f.name] = float(d[f.name])
        elif t.startswith("Tuple[str"):
            kw[f.name] = tuple(str(x) for x in d[f.name])
        elif t.startswith("Tuple[bool"):
            kw[f.name] = tuple(bool(x) for x in d[f.name])
        elif t.startswith("Tuple[int"):
            kw[f.name] = tuple(int(x) for x in d[f.name])
        else:
            kw[f.name] = d[f.name]
    return PhysicsModel(**kw)


_MODEL_CACHE: dict = {}


def _cached(name: str) -> PhysicsModel:
    if name not in _MODEL_CACHE:
        _MODEL_CACHE[name] = load_model(os.path.join(ASSETS_DIR, name + ".npz"))
    return _MODEL_CACHE[name]


def decimate_hulls(
    m: PhysicsModel,
    n_directions: int = 128,
    per_geom_directions: Optional[dict] = None,
) -> PhysicsModel:
    """Planning-model hull decimation: keep only the vertices that are
    argmax support points along ``n_directions`` Fibonacci-sphere
    directions (the plane-convex contact only ever touches hull support
    vertices). ``per_geom_directions`` maps geom-name prefixes to coarser
    direction counts (e.g. ``{"shin": 32}``), taken as evenly spaced
    indices of the full direction set."""
    # Fibonacci sphere
    i = np.arange(n_directions) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n_directions)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    dirs = np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=1,
    )

    def hull_dirs(k):
        if per_geom_directions is None:
            return dirs
        nd = None
        for prefix, n in per_geom_directions.items():
            if m.col_geom_names[k].startswith(prefix):
                nd = n
        if nd is None or nd >= n_directions:
            return dirs
        return dirs[np.linspace(0, n_directions - 1, nd).astype(int)]

    new_hulls = []
    for k, verts in enumerate(m.col_hull_verts):
        v = np.asarray(verts)
        keep = np.unique(np.argmax(hull_dirs(k) @ v.T, axis=1))
        new_hulls.append(v[keep])
    return dataclasses.replace(m, col_hull_verts=tuple(new_hulls))


def get_planning_model(n_directions: int = 128) -> PhysicsModel:
    """Feet-only, decimated-hull model for maximum-throughput planning
    (the JAX package's ``get_planning_model(n_directions)``)."""
    key = ("planning", n_directions)
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = decimate_hulls(_cached("feet"), n_directions)
    return _MODEL_CACHE[key]


def get_fast_plant_model(
    n_directions: int = 128, n_secondary: Optional[int] = 64
) -> PhysicsModel:
    """Feet + shins + ankle servos with decimated hulls (the JAX package's
    ``get_fast_plant_model(n_directions, n_secondary)``): every hull at
    ``n_directions`` support directions, the shins and ankle servos at
    ``n_secondary`` (None: at ``n_directions`` too)."""
    key = ("fast_plant", n_directions, n_secondary)
    if key not in _MODEL_CACHE:
        per_geom = (
            None if n_secondary is None
            else {"shin": n_secondary, "ankle_servo": n_secondary}
        )
        _MODEL_CACHE[key] = decimate_hulls(
            _cached("mpc_plant"), n_directions, per_geom_directions=per_geom)
    return _MODEL_CACHE[key]


def get_mpc_plant_model() -> PhysicsModel:
    """Feet + shins + ankle servos with their full hulls (12 geoms): the
    closed-loop plant, a snapshot of the JAX package's
    ``get_model(collision_geom_prefixes=MPC_COLLISION_PREFIXES)``."""
    return _cached("mpc_plant")


def get_full_model() -> PhysicsModel:
    """Every collidable mesh geom of the robot (25) with its full hull
    (snapshot of the JAX package's ``get_model()``)."""
    return _cached("full")


# every model a name selects: the full-hull snapshots (assets/<name>.npz)
# and the decimated models derived from them
MODELS = {
    "planning": get_planning_model,
    "fast_plant": get_fast_plant_model,
    "mpc_plant": get_mpc_plant_model,
    "full": get_full_model,
    "fast_plant_nsec32": lambda: get_fast_plant_model(n_secondary=32),
    "feet": lambda: _cached("feet"),
}
SNAPSHOTS = tuple(MODELS)


def get_snapshot(name: str) -> PhysicsModel:
    """The model called ``name``, one of ``SNAPSHOTS``."""
    if name not in MODELS:
        raise ValueError(f"no model snapshot {name!r}; the snapshots are "
                         f"{', '.join(SNAPSHOTS)}")
    return MODELS[name]()


# --------------------------------------------------------------------------
# domain randomization


class DomainParams(typing.NamedTuple):
    """Per-sample physics overrides for domain randomization. Each field is
    None (nominal model value) or a (B,) tensor:

      * ``friction``: tangential friction of every ground contact;
      * ``gain_scale``: scales the servo stiffness kp (gain and its bias
        coupling; the damping kv stays nominal);
      * ``base_mass_scale``: scales the base's mass and rotational inertia;
      * ``tilt_x`` / ``tilt_y``: ground slope, z = tilt_x*x + tilt_y*y
        through the nominal plane point;
      * ``terrain_amp`` / ``terrain_freq``: a smooth bump field on top of
        the slope, ``amp*sin(freq*x)*sin(freq*y)``; contact resolves each
        geom against the local tangent plane at its center. Give both.
    """

    friction: typing.Any = None
    gain_scale: typing.Any = None
    base_mass_scale: typing.Any = None
    tilt_x: typing.Any = None
    tilt_y: typing.Any = None
    terrain_amp: typing.Any = None
    terrain_freq: typing.Any = None


def sample_domain_params(
    generator: torch.Generator,
    batch: int,
    friction_range: Optional[Tuple[float, float]] = (0.4, 0.8),
    gain_range: Optional[Tuple[float, float]] = (0.8, 1.2),
    mass_range: Optional[Tuple[float, float]] = (0.9, 1.5),
    tilt_range: Optional[Tuple[float, float]] = None,
    terrain_amp_range: Optional[Tuple[float, float]] = None,
    terrain_freq_range: Tuple[float, float] = (15.0, 30.0),
    dtype: torch.dtype = torch.float32,
) -> DomainParams:
    """Uniformly sampled ``DomainParams`` lanes for ``batch`` scenarios, on
    the generator's device. Pass None for a range to keep that quantity
    nominal; terrain amplitude and frequency are sampled together."""
    dev = generator.device

    def u(rng):
        if rng is None:
            return None
        x = torch.rand((batch,), generator=generator, device=dev, dtype=dtype)
        return rng[0] + (rng[1] - rng[0]) * x

    return DomainParams(
        friction=u(friction_range),
        gain_scale=u(gain_range),
        base_mass_scale=u(mass_range),
        tilt_x=u(tilt_range),
        tilt_y=u(tilt_range),
        terrain_amp=u(terrain_amp_range),
        terrain_freq=(None if terrain_amp_range is None
                      else u(terrain_freq_range)),
    )
