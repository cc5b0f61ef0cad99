"""The port's lane engine against the JAX package's, float64 on the CPU,
and against the port's own leg and oracle engines.

The JAX lane engine runs 13-25 s a step eagerly and compiles for minutes
jitted, so its results come from ``tests/torch_lane_refs.npz`` (written
by ``scripts/snapshot_torch_lane_refs.py``, whose cases these are): one
case is recomputed live here, the ``slow`` test recomputes them all.
Tolerance against JAX: 1e-9 relative and absolute on qpos, qvel, act and
sensordata (they agree to ~1e-13 on these states).

Joint layouts that no committed model has (a body with two hinges, a
body welded to its parent, free-joint dofs after the hinges') are held to
the JAX lane engine live: the test writes a variant of the robot's MJCF,
builds it with the JAX package's ``build_physics_model`` and runs both
engines on it (one control step, ~9 s eagerly), at 1e-10.

Against the port's other engines: the leg engine is the same math
grouped per leg (1e-10 over five grounded substeps); the oracle engine
with ``max_contacts = 3 * ngeom`` and 8 Newton passes at the JAX test's
tolerances (tests/test_lane_engine.py: qpos 1e-9 / 1e-10, qvel and
sensors 1e-7 / 1e-8, act 1e-12)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.ops import lane_engine, leg_engine
from quadruped_gym_tpu_torch.physics import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("qpos", "qvel", "act", "sensordata")
JAX_TOL = 1e-9
ASSETS = os.path.join(REPO, "quadruped_gym_tpu", "models", "assets")

# MJCF edits (old text, new text) of quadruped.xml per joint layout
LAYOUTS = {
    # shin_1 carries a second hinge after knee_1; foot_2 is welded to
    # shin_2 (ankle_2, its servo and its sensor removed)
    "hinges": (
        ('<joint name="knee_1" class="knee"/>',
         '<joint name="knee_1" class="knee"/>\n<joint name="knee_1b" '
         'type="hinge" axis="1 0 0" damping="0.2"/>'),
        ('<joint name="ankle_2" class="ankle"/>', ''),
        ('<position joint="ankle_2" class="ankle"/>', ''),
        ('<jointpos joint="ankle_2" name="ankle_2_sensor"/>', ''),
    ),
    # a second free body after the robot: its dofs follow the hinges'
    "free_last": (
        ('    </worldbody>',
         '        <body name="ball" pos="0.3 0 0.3"><freejoint/><inertial '
         'pos="0 0 0" mass="0.05" diaginertia="2e-5 2e-5 2e-5"/></body>\n'
         '    </worldbody>'),
    ),
}


@functools.lru_cache(maxsize=None)
def _script():
    path = os.path.join(REPO, "scripts", "snapshot_torch_lane_refs.py")
    spec = importlib.util.spec_from_file_location("snapshot_lane_refs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _refs():
    with np.load(_script().OUT) as data:
        return {k: data[k] for k in data.files}


def _state(batched):
    return lane_engine.from_batched(*(torch.as_tensor(x) for x in batched))


def _run_port(name):
    """One snapshot case through the port's lane engine."""
    case = _script()
    model, _, _, _, call, kw = case.CASES[name]
    kw = dict(kw)
    it = kw.pop("solver_iterations", case.ITERATIONS[0])
    m = tspec.get_snapshot(model)
    batched, ctrl = case.case_inputs(name)
    ls, ctrl = _state(batched), torch.as_tensor(ctrl)
    if call == "step":
        return lane_engine.step(m, ls, ctrl, it, case.ITERATIONS[1], **kw)
    return lane_engine.control_step(m, ls, ctrl, kw.pop("frame_skip"), it,
                                    case.ITERATIONS[1], **kw)


def _assert_jax_close(got, want: dict, tol=JAX_TOL):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                   rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_allclose(got.time.numpy(), want["time"], rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("name", list(_script().CASES))
def test_matches_jax_snapshot(name):
    refs = _refs()
    want = {f: refs[f"{name}_{f}"] for f in FIELDS + ("time",)}
    _assert_jax_close(_run_port(name), want)


@functools.lru_cache(maxsize=None)
def _live_jax():
    """The live case through the JAX lane engine, once a process."""
    from torch_jax_cache import no_cache_writes

    with no_cache_writes():
        return _script().jax_case(_script().LIVE)


def test_matches_live_jax():
    """The snapshot still is what the JAX package computes (one case)."""
    _assert_jax_close(_run_port(_script().LIVE), _live_jax())


def test_leg_route_on_full_matches_live_jax():
    """The port's leg-batched engine on ``full`` (its base's groups
    included; the JAX package's leg engine refuses the model) against the
    live JAX lane engine on the same case: ``full`` pressed to 3 cm, the
    hip servos in contact, one step at 4/8."""
    case = _script()
    assert case.LIVE == "full_contact"
    model, _, _, _, call, kw = case.CASES[case.LIVE]
    assert (model, call, kw) == ("full", "step", {})
    batched, ctrl = case.case_inputs(case.LIVE)
    got = leg_engine.step(tspec.get_snapshot(model), _state(batched),
                          torch.as_tensor(ctrl), *case.ITERATIONS)
    _assert_jax_close(got, _live_jax())


@pytest.mark.slow
def test_snapshot_matches_live_jax():
    from torch_jax_cache import no_cache_writes

    refs = _refs()
    for name in _script().CASES:
        with no_cache_writes():
            live = _script().jax_case(name)
        for f, x in live.items():
            np.testing.assert_allclose(refs[f"{name}_{f}"], x, rtol=1e-13,
                                       atol=1e-13, err_msg=f"{name} {f}")


def test_contact_cases_touch_the_ground():
    """The contact cases really exercise the contact solve, and on
    ``full`` the base and hips (the geoms on the base, which the leg
    engine takes as groups of their own) are among the active slots."""
    case = _script()
    for name in ("mpc_plant_contact", "full_contact"):
        m = tspec.get_snapshot(case.CASES[name][0])
        batched, ctrl = case.case_inputs(name)
        ls, ctrl = _state(batched), torch.as_tensor(ctrl)
        free = lane_engine.step(m, ls, ctrl, 0, 0)
        solved = lane_engine.step(m, ls, ctrl, 4, 8)
        assert float((free.qvel - solved.qvel).abs().max()) > 1e-2, name
    m = tspec.get_full_model()
    kin = lane_engine._fk(m, ls.qpos)
    active = lane_engine._collide(m, kin).active.any(1).numpy()
    bodies = set(np.repeat(np.asarray(m.col_geom_bodyid), 3)[active])
    base = lane_engine._static(m).root
    hips = set(lane_engine._static(m).children[base])
    assert base in bodies and hips <= bodies
    assert leg_engine.is_compatible(m)
    from torch_models import incompatible_full

    assert not leg_engine.is_compatible(incompatible_full())


def test_tile_equals_flat():
    """``tile=True`` folds the batch into (B/128, 128): the flat layout's
    numbers, in every bit, for step and control_step."""
    case = _script()
    m = tspec.get_mpc_plant_model()
    batched, ctrl = case.case_inputs("tile")
    ls, ctrl = _state(batched), torch.as_tensor(ctrl)
    for call in (lambda t: lane_engine.step(m, ls, ctrl, 2, 4, tile=t),
                 lambda t: lane_engine.control_step(m, ls, ctrl, 2, 2, 4,
                                                    tile=t)):
        tiled, flat = call(True), call(False)
        for a, b in zip(tiled, flat):
            assert a.shape == b.shape
            assert torch.equal(a, b)


def test_any_lane_shape():
    """``_step_impl`` takes lane scalars of any shape: (2, 2) lanes give
    the (4,) lanes' numbers."""
    case = _script()
    m = tspec.get_mpc_plant_model()
    batched, ctrl = case.case_inputs("mpc_plant_contact")
    ls, ctrl = _state(batched), torch.as_tensor(ctrl)
    flat = lane_engine._step_impl(m, ls, ctrl, 2, 4)
    square = lane_engine._step_impl(
        m, lane_engine.LaneState(*(x.reshape(x.shape[:-1] + (2, 2))
                                   for x in ls)),
        ctrl.reshape(-1, 2, 2), 2, 4)
    for a, b in zip(square, flat):
        assert torch.equal(a.reshape(b.shape), b)


def _grounded(m, B, seed):
    """A moving state on the floor: the reset pose dropped for 0.2 s on
    the lane engine, then a velocity perturbation."""
    rng = np.random.default_rng(seed)
    ls = lane_engine.make_lane_state(m, B, dtype=torch.float64, device="cpu")
    hold = torch.as_tensor(np.tile(_script().HOLD[:, None], (1, B)))
    ls = lane_engine.control_step(m, ls, hold, 100, 4, 8)
    return ls._replace(qvel=ls.qvel + torch.as_tensor(
        0.1 * rng.standard_normal(ls.qvel.shape)))


def test_matches_leg_engine():
    """Five grounded substeps on ``mpc_plant``: the leg engine is the same
    math with the legs folded into a (4, B) lane dim."""
    m = tspec.get_mpc_plant_model()
    ls = _grounded(m, 4, 0)
    ctrl = torch.as_tensor(np.tile([0.1, -0.1, -0.5] * 4, (4, 1)).T)
    got = lane_engine.control_step(m, ls, ctrl, 5, 4, 8)
    want = leg_engine.control_step(m, ls, ctrl, 5, 4, 8)
    for f in FIELDS + ("time",):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-10, atol=1e-10, msg=f)


@pytest.mark.parametrize("name,start", [
    ("mpc_plant", "air"), ("mpc_plant", "contact"), ("full", "contact")])
def test_matches_oracle_engine(name, start):
    """One step against the oracle engine with a slot for every contact
    (max_contacts = 3 ngeom) and 8 Newton passes, the JAX test's
    setting (its lane engine at 8/12)."""
    m = tspec.get_snapshot(name)
    B = 4
    rng = np.random.default_rng(7)
    if start == "air":
        ls = lane_engine.make_lane_state(m, B, dtype=torch.float64,
                                         device="cpu")
        ls = ls._replace(
            qpos=ls.qpos + torch.as_tensor(
                0.05 * rng.standard_normal(ls.qpos.shape)
                + 0.5 * np.eye(m.nq)[2][:, None]),
            qvel=torch.as_tensor(0.1 * rng.standard_normal(ls.qvel.shape)))
    else:
        ls = _grounded(m, B, 1)
    ctrl = torch.as_tensor(np.tile([0.1, -0.1, -0.5] * 4, (B, 1)).T)
    got = lane_engine.step(m, ls, ctrl, 8, 12)
    ref = engine.step(
        m, engine.State(*lane_engine.to_batched(ls)), ctrl.T,
        max_contacts=3 * len(m.col_geom_bodyid), solver_iterations=8)
    want = lane_engine.from_batched(*ref)
    tol = {"qpos": (1e-9, 1e-10), "qvel": (1e-7, 1e-8),
           "act": (1e-12, 1e-12), "sensordata": (1e-7, 1e-8)}
    for f, (rtol, atol) in tol.items():
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=rtol, atol=atol, msg=f)


class _Ops(TorchDispatchMode):
    """Counts the operators a call dispatches, views aside."""

    VIEWS = {"view", "_unsafe_view", "reshape", "transpose", "unsqueeze",
             "expand", "permute", "select", "slice", "t", "alias",
             "squeeze", "diagonal", "unbind", "detach", "as_strided",
             "_reshape_alias", "lift_fresh"}

    def __init__(self):
        super().__init__()
        self.count, self.reads = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense":  # .item(), bool(tensor)
            self.reads += 1
        if name not in self.VIEWS:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_slot_stacking_and_no_readback():
    """The per-slot work is stacked: a substep dispatches as many
    operators on ``full`` (25 geoms, 75 slots) as on ``planning`` (4, 12),
    and it never reads a value back to the host."""
    counts = {}
    for name in ("planning", "full"):
        m = tspec.get_snapshot(name)
        ls = lane_engine.make_lane_state(m, 8, dtype=torch.float64,
                                         device="cpu")
        ctrl = torch.zeros((m.nu, 8), dtype=torch.float64)
        lane_engine.step(m, ls, ctrl, 4, 8)  # constants built
        with _Ops() as ops:
            lane_engine.control_step(m, ls, ctrl, 2, 4, 8)
        counts[name] = ops.count
        assert ops.reads == 0, name
    assert counts["full"] == counts["planning"]
    assert counts["full"] < 6000  # two substeps, low thousands each


def test_single_robot_lanes():
    """A single robot (lanes of shape ()) steps like a batch of one."""
    m = tspec.get_full_model()
    ls = lane_engine.make_lane_state(m, 1, dtype=torch.float64, device="cpu")
    ctrl = torch.as_tensor(_script().HOLD[:, None])
    one = lane_engine.step(m, ls, ctrl, 2, 4)
    scalar = lane_engine.step(
        m, lane_engine.LaneState(*(x[..., 0] for x in ls)), ctrl[:, 0], 2, 4)
    for a, b in zip(scalar, one):
        assert torch.equal(a, b[..., 0])


def _layout_model(tmp_path, layout):
    """(JAX model, port model) of a variant of the robot, feet-only
    collision: built by the JAX package, then through a snapshot file as
    ``scripts/snapshot_torch_models.py`` writes them."""
    from quadruped_gym_tpu.models import spec as jspec

    with open(os.path.join(ASSETS, "quadruped.xml")) as f:
        xml = f.read().replace('meshdir="./mesh" texturedir="./textures"',
                               f'meshdir="{ASSETS}/mesh" '
                               f'texturedir="{ASSETS}/textures"')
    for old, new in LAYOUTS[layout]:
        assert old in xml, old
        xml = xml.replace(old, new)
    (tmp_path / "quadruped.xml").write_text(xml)
    with open(os.path.join(ASSETS, "scene.xml")) as f:
        (tmp_path / "scene.xml").write_text(f.read())
    jm = jspec.build_physics_model(
        str(tmp_path / "scene.xml"),
        collision_geom_prefixes=jspec.FEET_COLLISION_PREFIXES)
    tspec.save_model(jm, str(tmp_path / "m.npz"))
    return jm, tspec.load_model(str(tmp_path / "m.npz"))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_joint_layouts_match_live_jax(tmp_path, layout):
    """One control step from a moving start pressed to the floor, on a
    model whose joint layout the committed snapshots lack."""
    import jax
    import jax.numpy as jnp

    from quadruped_gym_tpu.ops import lane_engine as jlane

    jm, m = _layout_model(tmp_path, layout)
    if layout == "hinges":
        assert 2 in m.body_jntnum and 0 in m.body_jntnum[1:]
    else:
        free = [j for j in range(m.njnt) if m.jnt_type[j] == 0]
        assert max(m.jnt_dofadr[j] for j in free) == m.nv - 6
    B = 2
    rng = np.random.default_rng(3)
    qpos = np.asarray(m.qpos0)[None] + 0.05 * rng.standard_normal((B, m.nq))
    qpos[:, 2] = 0.03
    batched = (qpos, 0.3 * rng.standard_normal((B, m.nv)),
               np.zeros((B, m.na)), np.zeros(B),
               np.zeros((B, m.nsensordata)))
    ctrl = 0.3 * rng.standard_normal((m.nu, B))
    with jax.disable_jit():
        want = jlane.control_step(
            jm, jlane.from_batched(*(jnp.asarray(x) for x in batched)),
            jnp.asarray(ctrl), 1, 4, 8)
    got = lane_engine.control_step(m, _state(batched), torch.as_tensor(ctrl),
                                   1, 4, 8)
    _assert_jax_close(got, {f: np.asarray(getattr(want, f))
                            for f in FIELDS + ("time",)}, tol=1e-10)
    free = lane_engine.step(m, _state(batched), torch.as_tensor(ctrl), 0, 0)
    assert float((free.qvel - got.qvel).abs().max()) > 1e-2  # in contact
