"""The gym-level envs and their renderer against the JAX package, on the CPU.

Each class of ``quadruped_gym_tpu_torch/envs/gym_env.py`` is stepped in
float64 beside its JAX counterpart from the same ``seed()``: the
reference's global-numpy-RNG draws (reset key, random yaw, random
command) come in the same number and order, so the reset states agree
without injecting anything, and so do ten control steps on the ``full``
model. Every JAX env jits its own step (~14 s of XLA compile on the
``full`` model), so one JAX env per class is built for the module and
reset between tests.

Tolerances: physics and host reward terms 1e-9 (float64 rounding through
a Newton contact solve is ~1e-13). Two terms are ill-conditioned in the
first steps of the drop from the reset height: the local direction
reward at step 0 reads v/|v| of a velocity of ~1e-10 m/s (5e-6), and the
partially observed frame's Madgwick angles normalise an accelerometer
that reads ~0 in free fall (1e-7)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files, no_cache_writes  # noqa: F401

from quadruped_gym_tpu.envs import gym_env as J
from quadruped_gym_tpu.envs import rendering as jrendering
from quadruped_gym_tpu.models.spec import DEFAULT_SCENE
from quadruped_gym_tpu.tasks import walking as jwalking
from quadruped_gym_tpu_torch.envs import gym_env as T
from quadruped_gym_tpu_torch.envs import rendering
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.tasks import observations

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
TOL = 1e-9
DIRECTION_STEP0_TOL = 5e-6
PO_OBS_TOL = 1e-7
CLASSES = {
    "QuadrupedEnv": {},
    "WalkingQuadrupedEnv": dict(random_init=True, random_controls=True),
    "POWalkingQuadrupedEnv": dict(obs_window=3),
}
PRIMITIVES = (
    "ideal_position_cost", "progress_direction_reward_global",
    "progress_direction_reward_local", "progress_speed_reward_local",
    "progress_speed_cost_global", "progress_speed_cost_local",
    "progress_cost_local", "heading_reward", "orientation_reward",
    "body_height_cost", "joint_posture_cost", "control_cost",
    "control_frequency_cost", "control_amplitude_cost", "alive_bonus",
    "flip_termination",
)


def action(i):
    """The asymmetric action pattern of tests/test_envs.py."""
    return np.clip(np.array([0.0, 0.0, -0.5] * 4)
                   + 0.3 * np.sin(0.3 * i + np.arange(12)), -1, 1)


@pytest.fixture(scope="module")
def jax_envs():
    with no_cache_writes():
        return {name: getattr(J, name)(max_time=20.0, frame_skip=10, **kw)
                for name, kw in CLASSES.items()}


def jax_env(jax_envs, name):
    """The module's JAX env of class ``name``, as a fresh one would be:
    default reward/termination dicts and cold persistent carries."""
    env = jax_envs[name]
    env.reward_fns = {"default": env._default_reward}
    env.termination_fns = {"default": env._default_termination}
    if hasattr(env, "_persist"):
        env._persist = jwalking._fresh_persistent(env._cfg, env.pm)
    return env


def port_env(name, **kw):
    return getattr(T, name)(max_time=20.0, frame_skip=10, dtype=F64,
                            device="cpu", **CLASSES[name], **kw)


@pytest.mark.parametrize("name", list(CLASSES))
def test_env_matches_jax(jax_envs, name):
    je, te = jax_env(jax_envs, name), port_env(name)
    je.seed(0)
    jo, _ = je.reset()
    te.seed(0)
    to, _ = te.reset()
    # the reset is the JAX one, random yaw and command included
    np.testing.assert_array_equal(to, np.asarray(jo))
    np.testing.assert_array_equal(te.data.qpos, np.asarray(je.data.qpos))
    if name == "WalkingQuadrupedEnv":
        assert abs(te.data.qpos[6]) > 0.01  # a yaw was drawn
        for f in ("velocity", "heading", "global_velocity"):
            np.testing.assert_array_equal(getattr(te.control_inputs, f),
                                          getattr(je.control_inputs, f))
        assert np.linalg.norm(te.control_inputs.velocity) > 0
    obs_tol = PO_OBS_TOL if name.startswith("PO") else TOL
    for i in range(10):
        jo, jr, jt, jtr, ji = je.step(action(i))
        to, tr, tt, ttr, ti = te.step(action(i))
        assert to.shape == np.asarray(jo).shape and to.dtype == np.float64
        np.testing.assert_allclose(to, np.asarray(jo), rtol=0, atol=obs_tol,
                                   err_msg=f"obs, step {i}")
        assert (tt, ttr) == (jt, jtr)
        comps = ti.get("reward_components", ti)
        assert set(comps) == set(ji.get("reward_components", ji))
        for k, v in comps.items():
            tol = (DIRECTION_STEP0_TOL
                   if i == 0 and k == "progress_direction_reward_local"
                   else TOL)
            assert abs(v - ji.get("reward_components", ji)[k]) <= tol, (k, i)
        assert abs(tr - jr) <= (DIRECTION_STEP0_TOL if i == 0 else TOL)
    np.testing.assert_allclose(te.data.qvel, np.asarray(je.data.qvel),
                               rtol=0, atol=TOL)
    assert te.data.time == pytest.approx(float(je.data.time), abs=1e-12)


def test_host_reward_primitives_match_jax(jax_envs):
    name = "WalkingQuadrupedEnv"
    je, te = jax_env(jax_envs, name), port_env(name)
    for env in (je, te):
        env.seed(1)
        env.reset()
        env.control_inputs.set_orientation(0.3)
        env.control_inputs.set_velocity_speed_alpha(0.25, 0.1)
    for i in range(5):
        je.step(action(i))
        te.step(action(i))
    for prim in PRIMITIVES:
        got, want = getattr(te, prim)(), getattr(je, prim)()
        assert type(got) is type(want), prim
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=prim)
    assert te.input_control_reward() == te._functional_reward
    assert te.info == te._functional_components
    np.testing.assert_allclose(te.ideal_position, np.asarray(je.ideal_position),
                               rtol=0, atol=TOL)


def test_dummy_env_composite_matches_jax(jax_envs):
    """The JAX Dummy env borrows the compiled step of the module's walking
    env (same model and task config), so no second compile."""
    jw = jax_env(jax_envs, "WalkingQuadrupedEnv")
    jd = J.DummyWalkingQuadrupedEnv(max_time=20.0, frame_skip=10)
    jd._wstep = jw._wstep
    td = T.DummyWalkingQuadrupedEnv(max_time=20.0, frame_skip=10, dtype=F64,
                                    device="cpu")
    for env in (jd, td):
        env.seed(2)
        env.reset()
    for i in range(3):
        jo, jr, jt, _, ji = jd.step(action(i))
        to, tr, tt, _, ti = td.step(action(i))
        np.testing.assert_allclose(to, np.asarray(jo), rtol=0, atol=TOL)
        assert set(ti) == set(T.DummyWalkingQuadrupedEnv.reward_keys) == set(ji)
        for k in ji:
            assert abs(ti[k] - ji[k]) <= TOL, k
        assert abs(tr - jr) <= TOL and tt == jt


def test_custom_reward_and_termination_fns_are_honored():
    """The plug-in contract: custom entries replace the default composite,
    or add to it."""
    calls = {"rew": 0, "term": 0}
    env = T.WalkingQuadrupedEnv(max_time=1.0, frame_skip=10, dtype=F64,
                                device="cpu")
    sl = env._sl()

    def forward_speed():
        calls["rew"] += 1
        return float(env.data.sensordata[sl.vel])

    def always_done():
        calls["term"] += 1
        return True

    env.reward_fns = {"forward_speed": forward_speed}
    env.termination_fns = {"always": always_done}
    env.reset()
    obs, rew, term, trunc, info = env.step(np.zeros(12))
    assert calls == {"rew": 1, "term": 1}
    assert rew == float(env.data.sensordata[sl.vel])
    assert term is True and trunc is False
    assert info == {"time": env.data.time,
                    "reward_components": {"forward_speed": rew}}

    env2 = T.WalkingQuadrupedEnv(max_time=1.0, frame_skip=10, dtype=F64,
                                 device="cpu")
    env2.reset()
    env2.reward_fns["bonus"] = lambda: 7.25
    obs, rew, term, trunc, info = env2.step(np.zeros(12))
    assert rew == pytest.approx(env2._functional_reward + 7.25)
    assert set(info) == set(env2.reward_keys)

    po = T.POWalkingQuadrupedEnv(obs_window=2, max_time=1.0, frame_skip=10,
                                 dtype=F64, device="cpu")
    po.reward_fns = {"const": lambda: 3.0}
    po.termination_fns = {}
    po.reset()
    obs, rew, term, trunc, info = po.step(np.zeros(12))
    assert rew == 3.0 and term is False
    assert obs.shape == (observations.PO_OBS_DIM * 2,)


@pytest.mark.parametrize("options", [
    None,
    {"min_speed": 0.1, "max_speed": 0.4},
    {"fixed_heading_angle": 0.0, "fixed_velocity_angle": 0.0,
     "fixed_speed": 0.3},
    {"fixed_heading_angle": 1.0},
])
def test_velocity_heading_controls_match_jax(options):
    got, want = T.VelocityHeadingControls(), J.VelocityHeadingControls()
    for c in (got, want):
        np.random.seed(5)
        c.sample(options)
        c.sample(options)
    for f in ("velocity", "heading", "global_velocity"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.get_heading_theta() == want.get_heading_theta()
    assert got.get_velocity_aplha_speed() == want.get_velocity_aplha_speed()
    cmd, jcmd = got.as_command(F64, "cpu"), want.as_command(np.float64)
    for a, b in zip(cmd, jcmd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_po_reset_seeds_orientation_from_the_state():
    env = T.POWalkingQuadrupedEnv(obs_window=3, max_time=2.0, frame_skip=10,
                                  random_controls=True, dtype=F64,
                                  device="cpu")
    obs, _ = env.reset()
    assert obs.shape == (observations.PO_OBS_DIM * 3,)
    np.testing.assert_array_equal(env.computed_orientation,
                                  env.data.qpos[3:7])
    with pytest.raises(ValueError):
        env.data.qpos[0] = 1.0  # read-only, like the JAX env's view


def test_render_and_video(tmp_path, monkeypatch):
    """Frames at the render rate, an mp4, and a close that calls no
    window function (a headless OpenCV build raises in each)."""

    def no_windows(*a):
        raise AssertionError("a window function was called")

    for name in ("destroyAllWindows", "destroyWindow", "imshow"):
        monkeypatch.setattr(rendering.cv2, name, no_windows)
    path = str(tmp_path / "run.mp4")
    env = T.WalkingQuadrupedEnv(max_time=1.0, frame_skip=10, dtype=F64,
                                device="cpu", render_mode="rgb_array",
                                save_video=True, video_path=path, width=160,
                                height=120)
    env.reset()
    frames = []
    for i in range(4):  # 0.08 s of sim time at 30 frames a second: 2
        env.step(action(i))
        frames.append(env.render())
    got = [f for f in frames if f is not None]
    assert len(got) == 2 and got[0].shape == (120, 160, 3)
    assert got[0].dtype == np.uint8 and got[0].min() < 250
    assert isinstance(env.renderer, rendering.WireframeRenderer)
    env.close()
    assert os.path.getsize(path) > 0


def test_wireframe_frame_matches_jax():
    """The port's wireframe of a settled, yawed state against the JAX
    renderer drawing MuJoCo's own kinematics of the same qpos."""
    import mujoco

    mm = mujoco.MjModel.from_xml_path(DEFAULT_SCENE)
    md = mujoco.MjData(mm)
    yaw = 0.7
    md.qpos[3:7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
    md.ctrl[:] = [0.0, 0.0, -0.5] * 4
    for _ in range(300):  # settle on the floor
        mujoco.mj_step(mm, md)
    mujoco.mj_forward(mm, md)
    pm = spec.get_full_model()
    assert pm.nbody == mm.nbody
    frame = rendering.host_frame(pm, md.qpos, md.qvel, md.time)

    jw = jrendering.WireframeRenderer(mm, 320, 240)
    tw = rendering.WireframeRenderer(pm, 320, 240)
    feet = np.array([md.geom_xpos[g] for g in jw._foot_geoms])
    np.testing.assert_allclose(tw.feet(frame), feet, rtol=0, atol=1e-10)
    np.testing.assert_allclose(frame.xpos, md.xpos, rtol=0, atol=1e-10)

    jcam = mujoco.MjvCamera()
    jcam.distance, jcam.elevation, jcam.azimuth = 1.0, -30, 120
    jcam.lookat[:] = md.qpos[:3]
    tcam = rendering.Camera()
    tcam.lookat[:] = md.qpos[:3]
    extra = [("vec", md.qpos[:3] + [0, 0, 0.1], md.qpos[:3] + [0.1, 0, 0.1],
              [1, 0, 0, 1]),
             ("point", np.array([0.05, 0.02, 0.0]), [1, 0, 1, 1], 0.01)]
    want = jw.render(md, jcam, extra)
    got = tw.render(frame, tcam, extra)
    assert got.shape == want.shape == (240, 320, 3)
    # a projected end point within rounding of a pixel edge could move an
    # anti-aliased line by one pixel; none does here
    assert int((got != want).any(axis=-1).sum()) == 0


def test_refusals():
    with pytest.raises(ValueError, match="MuJoCo"):
        T.QuadrupedEnv(model_path="scene.xml", device="cpu")
    with pytest.raises(ValueError, match="snapshot"):
        T.QuadrupedEnv(model_path="no_such_model", device="cpu")
    env = T.QuadrupedEnv(model_path=spec.get_mpc_plant_model(), device="cpu")
    assert env.pm is spec.get_mpc_plant_model() and env._dtype == torch.float32
    if not torch.cuda.is_available():  # the card unless the caller says cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.QuadrupedEnv()


def test_runs_without_gymnasium_opencv_or_matplotlib():
    """With the three optional packages hidden, the port's env, eval,
    trainer and plot modules import; an env steps; a PNG or a video is
    refused where the JAX package refuses it."""
    code = r"""
import sys
for name in ("gymnasium", "cv2", "matplotlib"):
    sys.modules[name] = None
import numpy as np, torch
from quadruped_gym_tpu_torch.envs import gym_env, rendering
from quadruped_gym_tpu_torch.rl import evaluate, train
from quadruped_gym_tpu_torch.utils import plot, server
assert gym_env.gym is None and gym_env.QuadrupedEnv.__bases__ == (object,)
assert not rendering.HAVE_CV2 and not plot.have_matplotlib()
env = gym_env.WalkingQuadrupedEnv(max_time=1.0, frame_skip=2,
                                  dtype=torch.float64, device="cpu")
assert not hasattr(env, "action_space")
env.reset()
obs, rew, term, trunc, info = env.step(np.zeros(12))
assert obs.shape == (33,) and np.isfinite(rew) and len(info) == 11
try:
    gym_env.QuadrupedEnv(save_video=True, device="cpu").reset()
except RuntimeError as e:
    assert "requires OpenCV" in str(e)
else:
    raise AssertionError("video without OpenCV did not raise")
try:
    plot.plot_data_line([1.0, 2.0], save_path="never.png")
except ImportError:
    pass
else:
    raise AssertionError("a PNG without matplotlib did not raise")
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
    assert not os.path.exists(os.path.join(REPO, "never.png"))
