"""Gymnasium-compatible environment classes over the oracle engine.

Counterpart of ``quadruped_gym_tpu/envs/gym_env.py``, with its classes,
constructor keywords, ``reward_keys``, host reward primitives, plug-in
``reward_fns`` / ``termination_fns`` dicts and ``control_inputs`` command
object, and its quirks (the global numpy RNG, the time limit reported as
``terminated``). The physics is this package's oracle engine on a batch
of one environment; ``data`` reads row 0 back to host numpy after every
reset and step. For training at scale use ``envs.vector_env``.

Differences from the JAX package:

* ``model_path`` is a snapshot name (``models.spec.SNAPSHOTS``; the
  default ``"full"`` is the JAX package's default scene) or a
  ``PhysicsModel``. An MJCF path raises: compiling one needs MuJoCo,
  which this package does not use.
* ``device=None`` is the card (or raises where there is none); pass
  ``device="cpu"`` to run on the CPU. ``dtype`` defaults to float32.
* Rendering always draws the wireframe renderer (``envs/rendering.py``).
* gymnasium is optional: without it the classes derive from ``object``
  and have no ``action_space`` / ``observation_space``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
except Exception:  # pragma: no cover - exercised with gymnasium hidden
    gym = None
    spaces = None

from .._device import resolve_device
from ..models import spec
from ..models.spec import PhysicsModel
from ..physics import engine
from ..tasks import commands, observations, rewards, walking
from .rendering import HostRenderer

DEFAULT_MODEL = "full"


def _model(model_path: Union[str, PhysicsModel]) -> PhysicsModel:
    if isinstance(model_path, PhysicsModel):
        return model_path
    if str(model_path).endswith(".xml"):
        raise ValueError(
            f"model_path={model_path!r}: compiling an MJCF file needs MuJoCo, "
            "which this package does not use; pass a snapshot name "
            f"({', '.join(spec.SNAPSHOTS)}) or a PhysicsModel")
    return spec.get_snapshot(model_path)


def _row0(state: engine.State) -> engine.State:
    """Row 0 of a batch-of-one state as read-only host numpy, in one
    transfer."""
    parts = (state.qpos, state.qvel, state.act, state.time[..., None],
             state.sensordata)
    flat = torch.cat([p[0] for p in parts]).cpu().numpy()
    out, i = [], 0
    for p in parts:
        n = p.shape[-1]
        a = flat[i:i + n]
        a.flags.writeable = False
        out.append(a)
        i += n
    qpos, qvel, act, time, sens = out
    return engine.State(qpos=qpos, qvel=qvel, act=act, time=float(time[0]),
                        sensordata=sens)


class _DataView:
    """Numpy view of the current engine state (MjData-shaped accessors)."""

    def __init__(self, env: "QuadrupedEnv"):
        self._env = env

    @property
    def qpos(self):
        return self._env._host.qpos

    @property
    def qvel(self):
        return self._env._host.qvel

    @property
    def act(self):
        return self._env._host.act

    @property
    def ctrl(self):
        return np.asarray(self._env._ctrl)

    @property
    def sensordata(self):
        return self._env._host.sensordata

    @property
    def time(self):
        return self._env._host.time


class VelocityHeadingControls:
    """Mutable command object with the reference's API, synced into the
    engine each step; ``sample`` draws from the global numpy RNG."""

    def __init__(self):
        self.velocity = np.zeros(3)
        self.heading = np.zeros(3)
        self.global_velocity = np.zeros(3)

    def update_global_velocity(self):
        v0, v1 = self.velocity[0], self.velocity[1]
        h0, h1 = self.heading[0], self.heading[1]
        self.global_velocity[0] = h0 * v0 - h1 * v1
        self.global_velocity[1] = h1 * v0 + h0 * v1
        self.global_velocity[2] = 0.0

    def set_velocity_xy(self, x, y):
        self.velocity[0] = x
        self.velocity[1] = y
        self.update_global_velocity()

    def set_velocity_speed_alpha(self, speed, alpha):
        self.velocity[0] = speed * np.cos(alpha)
        self.velocity[1] = speed * np.sin(alpha)
        self.update_global_velocity()

    def set_orientation(self, theta):
        self.heading[0] = np.cos(theta)
        self.heading[1] = np.sin(theta)
        self.update_global_velocity()

    def get_global_velocity_alpha_speed(self):
        speed = np.linalg.norm(self.global_velocity[0:2])
        alpha = np.arctan2(self.global_velocity[1], self.global_velocity[0])
        return speed, alpha

    def get_velocity_aplha_speed(self):  # (sic) reference method name
        speed = np.linalg.norm(self.velocity[0:2])
        alpha = np.arctan2(self.velocity[1], self.velocity[0])
        return speed, alpha

    def get_heading_theta(self):
        return np.arctan2(self.heading[1], self.heading[0])

    def sample(self, options=None):
        options = options or {}
        min_speed = options.get("min_speed", 0.0)
        max_speed = options.get("max_speed", 1.0)
        theta = options.get("fixed_heading_angle")
        if theta is None:
            theta = np.random.uniform(-np.pi, np.pi)
        self.set_orientation(theta)
        alpha = options.get("fixed_velocity_angle")
        if alpha is None:
            alpha = np.random.uniform(-np.pi, np.pi)
        speed = options.get("fixed_speed")
        if speed is None:
            speed = np.random.uniform(min_speed, max_speed)
        self.set_velocity_speed_alpha(speed, alpha)

    def as_command(self, dtype=torch.float32, device=None) -> commands.Command:
        """The command as (3,) tensors on ``device`` (the card unless
        given)."""
        device = resolve_device(device)
        return commands.Command(*(
            torch.tensor(v, dtype=dtype, device=device)
            for v in (self.velocity, self.heading, self.global_velocity)))


_BaseEnv = gym.Env if gym is not None else object


class QuadrupedEnv(_BaseEnv):
    """Base environment: raw-sensor observation, pluggable rewards.

    Actions in [-1,1]^12, observation = 33-dim sensordata (zeros before the
    first step: the reference runs no forward pass at reset),
    frame-skipped stepping, modular reward/termination dicts, decoupled
    render pacing, video save."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(
        self,
        model_path: Union[str, PhysicsModel] = DEFAULT_MODEL,
        max_time: float = 10.0,
        frame_skip: int = 4,
        render_mode: Optional[str] = None,
        width: int = 720,
        height: int = 480,
        render_fps: int = 30,
        reward_fns: Optional[dict] = None,
        termination_fns: Optional[dict] = None,
        save_video: bool = False,
        video_path: str = "videos/simulation.mp4",
        use_default_termination: bool = True,
        dtype=None,
        device=None,
    ):
        if gym is not None:
            super().__init__()
        self.model_path = model_path
        self.pm = _model(model_path)
        self._device = resolve_device(device)
        self.max_time = max_time
        self.frame_skip = frame_skip
        self.render_mode = render_mode
        self.width = width
        self.height = height
        self.render_fps = render_fps
        self.metadata = dict(self.metadata, render_fps=render_fps)
        self.save_video = save_video
        self.video_path = video_path
        self._dtype = torch.float32 if dtype is None else dtype
        self._renderer: Optional[HostRenderer] = None

        if spaces is not None:
            self.action_space = spaces.Box(
                low=-1.0, high=1.0, shape=(self.pm.nu,), dtype=np.float32
            )
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(self.pm.nsensordata,), dtype=np.float32
            )

        self.reward_fns = reward_fns if reward_fns is not None else {
            "default": self._default_reward
        }
        self.termination_fns = termination_fns if termination_fns is not None else {}
        if use_default_termination:
            self.termination_fns["default"] = self._default_termination

        self._set_state(self._fresh_state())
        self._ctrl = np.array([0.0, 0.0, -0.5] * 4)
        self.data = _DataView(self)
        self.seed()

    def _fresh_state(self) -> engine.State:
        one = engine.make_state(self.pm, self._dtype, self._device)
        return engine.State(*(x[None] for x in one))

    def _set_state(self, state: engine.State):
        """The (1, ...) engine state, and its host copy behind ``data``."""
        self._state = state
        self._host = _row0(state)

    # -- reference API ------------------------------------------------------

    def seed(self, seed=None):
        np.random.seed(seed)  # reference quirk: global numpy RNG
        return [seed]

    def _default_reward(self):
        return 0.0

    def _default_termination(self):
        return self.data.time >= self.max_time

    def _get_obs(self):
        return self.data.sensordata.copy()

    def reset(self, seed=None, options=None):
        self._set_state(self._fresh_state())
        self._ctrl = np.array([0.0, 0.0, -0.5] * 4)
        if self._renderer is not None:
            self._renderer.reset_timers(human=self.render_mode == "human")
        elif self.render_mode is not None or self.save_video:
            self._ensure_renderer().reset_timers(human=self.render_mode == "human")
        observation = self._get_obs()
        return observation, {}

    def step(self, action):
        action = np.clip(np.asarray(action, dtype=np.float64), -1.0, 1.0)
        self._ctrl = action
        ctrl = torch.as_tensor(action, dtype=self._dtype, device=self._device)
        self._set_state(engine.control_step(self.pm, self._state, ctrl[None],
                                            self.frame_skip))
        observation = self._get_obs()

        total_reward = 0.0
        reward_info = {}
        for name, fn in self.reward_fns.items():
            r = float(fn())
            reward_info[name] = r
            total_reward += r
        terminated = any(bool(fn()) for fn in self.termination_fns.values())
        truncated = False  # reference quirk: time limit reported as terminated
        info = {"time": self.data.time, "reward_components": reward_info}
        return observation, total_reward, terminated, truncated, info

    # -- rendering ------------------------------------------------------------

    def _ensure_renderer(self) -> HostRenderer:
        if self._renderer is None:
            self._renderer = HostRenderer(
                self.pm, self.width, self.height, self.render_fps,
                self.save_video, self.video_path,
            )
        return self._renderer

    def render_custom_geoms(self):
        pass

    def render_vector(self, origin, vector, color, scale=0.2, radius=0.005, offset=0.0):
        self._ensure_renderer().render_vector(origin, vector, color, scale, radius, offset)

    def render_point(self, position, color, radius=0.01):
        self._ensure_renderer().render_point(position, color, radius)

    def update_camera(self):
        r = self._ensure_renderer()
        r.camera.lookat[:] = self.data.qpos[:3]

    @property
    def renderer(self):
        return self._ensure_renderer().renderer

    def render(self):
        if self.render_mode is None and not self.save_video:
            return None
        r = self._ensure_renderer()
        r.sync(self.data.qpos, self.data.qvel, self.data.time)
        mode = self.render_mode or "rgb_array"
        return r.render(mode, custom_geoms=lambda _: self.render_custom_geoms())

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None


class WalkingQuadrupedEnv(QuadrupedEnv):
    """Velocity/heading-command locomotion task (``walking.step`` on one
    environment)."""

    reward_keys = list(rewards.REWARD_KEYS)

    def __init__(
        self,
        settling_time: float = 0.0,
        random_controls: bool = False,
        random_init: bool = False,
        reset_options: Optional[dict] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.settling_time = settling_time
        self.random_controls = random_controls
        self.random_init = random_init
        self.reset_options = reset_options
        self.control_inputs = VelocityHeadingControls()
        self.joint_centers = np.array([0.0, 0.0, -0.5] * 4, dtype=np.float32)
        self.info = {}

        # random_init / random_controls are drawn on the host from numpy's
        # global RNG (below), not by walking.reset
        self._cfg = walking.WalkingConfig(
            max_time=self.max_time,
            frame_skip=self.frame_skip,
            settling_time=settling_time,
            partial_obs=self._partial_obs(),
            obs_window=getattr(self, "obs_window", 1),
            dtype=self._dtype,
        )
        # persistent carries (estimator + frozen ctrl-cost ref survive reset)
        self._persist = walking._fresh_persistent(self._cfg, self.pm, 1,
                                                  self._device)
        self._wstate: Optional[walking.WalkingState] = None
        self.ideal_position = np.zeros(3)
        self.ctrl_f_est = np.zeros(12, dtype=np.float32)
        self.ctrl_a_est = np.zeros(12, dtype=np.float32)
        self.previous_ctrl = self.joint_centers.astype(np.float64)
        self.previous_ctrl_cost = None
        self._functional_reward = 0.0
        self._functional_terminated = False
        self._functional_components = {}

    def _partial_obs(self) -> bool:
        return False

    def _command(self) -> commands.Command:
        cmd = self.control_inputs.as_command(self._dtype, self._device)
        return commands.Command(*(x[None] for x in cmd))

    # -- reset / step ---------------------------------------------------------

    def initialize_robot_state(self):
        angle = np.random.uniform(0, 2 * np.pi)
        quat = np.array([np.cos(angle / 2), 0, 0, np.sin(angle / 2)])
        st = self._wstate
        qpos = st.phys.qpos.clone()
        qpos[0, 3:7] = torch.as_tensor(quat, dtype=qpos.dtype)
        self._wstate = st._replace(phys=st.phys._replace(qpos=qpos))

    def reset(self, seed=None, options=None):
        if options is None:
            options = self.reset_options
        observation, _ = super().reset(seed=seed, options=options)

        # the reference's draw of a reset key from the global numpy RNG;
        # the config samples nothing with it, but the draw keeps numpy's
        # stream where the JAX package leaves it
        gen = torch.Generator(device=self._device)
        gen.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        st, _ = walking.reset(self.pm, self._cfg, 1, gen,
                              persistent=self._persist)
        self._wstate = st
        if self.random_init:
            self.initialize_robot_state()
        if self.random_controls:
            self.control_inputs.sample(options=options)
        self._wstate = self._wstate._replace(cmd=self._command())
        self.ideal_position = np.zeros(3)
        self.info = {}
        self._functional_reward = 0.0
        self._functional_terminated = False
        self._functional_components = {}
        self._sync_host()
        return self._obs_np(), self.info

    def step(self, action):
        # keep the command in sync with the mutable control_inputs object
        st = self._wstate._replace(cmd=self._command())
        act = torch.as_tensor(np.asarray(action, dtype=np.float64),
                              dtype=self._dtype, device=self._device)
        out = walking.step(self.pm, self._cfg, st, act[None])
        self._wstate = out.state
        self._persist = (out.state.est, out.state.rew)
        self._sync_host()
        comps = out.reward_components[0].cpu().numpy()
        self._functional_reward = float(out.reward[0])
        self._functional_terminated = bool(out.terminated[0])
        self._functional_components = {
            k: float(v) for k, v in zip(self.reward_keys, comps)
        }

        # The reference's contract: reward = sum over the pluggable
        # reward_fns dict, terminated = any(termination_fns). The default
        # entries resolve to the walking task's composite (computed with
        # the step); user-supplied entries are evaluated on the host
        # against the synced state.
        total_reward = 0.0
        self.info = {}
        reward_info = {}
        for name, fn in self.reward_fns.items():
            r = float(fn())
            reward_info[name] = r
            total_reward += r
        terminated = any(bool(fn()) for fn in self.termination_fns.values())
        if not self.info:
            # base-env contract for custom reward fns: per-fn breakdown +
            # time. The default composite instead publishes its
            # per-component dict (input_control_reward), which replaces
            # self.info inside the loop above.
            self.info = {
                "time": float(self.data.time),
                "reward_components": reward_info,
            }
        return (
            self._obs_np(out.obs[0]),
            total_reward,
            terminated,
            False,
            self.info,
        )

    def _sync_host(self):
        ws = self._wstate
        self._set_state(ws.phys)
        self._ctrl = ws.applied_ctrl[0].cpu().numpy()
        self.ideal_position = ws.ideal_position[0].cpu().numpy()
        self.ctrl_f_est = ws.est.f_est[0].cpu().numpy()
        self.ctrl_a_est = ws.est.a_est[0].cpu().numpy()
        # the reference's attributes behind control_cost, mirrored from
        # the functional RewardCarry
        self.previous_ctrl = ws.rew.previous_ctrl[0].cpu().numpy()
        self.previous_ctrl_cost = (
            float(ws.rew.ctrl_cost_ref[0])
            if bool(ws.rew.ctrl_cost_ref_set[0])
            else None
        )

    def _obs_np(self, obs=None):
        if obs is None:
            if self._cfg.partial_obs:
                return self._wstate.obs.buffer[0].reshape(-1).cpu().numpy()
            return self.data.sensordata.copy()
        return obs.cpu().numpy()

    # -- reward primitives (host-side plugin API) ------------------------------

    def _sl(self):
        return rewards.SensorSlices.from_model(self.pm)

    def _vec3(self, adr):
        return self.data.sensordata[adr : adr + 3]

    @staticmethod
    def _unit_np(x):
        n = np.linalg.norm(x)
        return x / n if n > 0 else np.zeros_like(x)

    def ideal_position_cost(self):
        sl = self._sl()
        cur = self._vec3(sl.pos)
        return float(np.linalg.norm(cur[:2] - self.ideal_position[:2]))

    def progress_direction_reward_global(self):
        """Global linvel against the LOCAL command vector (the reference
        compares with ``control_inputs.velocity``, not
        ``global_velocity``)."""
        sl = self._sl()
        return float(
            self._unit_np(self._vec3(sl.linvel)[:2])
            @ self._unit_np(self.control_inputs.velocity[:2])
        )

    def progress_direction_reward_local(self):
        sl = self._sl()
        return float(
            self._unit_np(self._vec3(sl.vel)[:2])
            @ self._unit_np(self.control_inputs.velocity[:2])
        )

    def progress_speed_reward_local(self):
        """The reference's effective (second) definition."""
        sl = self._sl()
        actual = float(np.linalg.norm(self._vec3(sl.vel)[:2]))
        target = float(np.linalg.norm(self.control_inputs.velocity[:2]))
        return actual - (target - actual) ** 2

    def progress_speed_cost_global(self):
        sl = self._sl()
        d = float(np.linalg.norm(self._vec3(sl.linvel)[:2])) - float(
            np.linalg.norm(self.control_inputs.velocity[:2])
        )
        return d * d

    def progress_speed_cost_local(self):
        sl = self._sl()
        d = float(np.linalg.norm(self._vec3(sl.vel)[:2])) - float(
            np.linalg.norm(self.control_inputs.velocity[:2])
        )
        return d * d

    def progress_cost_local(self):
        sl = self._sl()
        d = self._vec3(sl.vel)[:2] - self.control_inputs.velocity[:2]
        return float(np.sum(np.square(d)))

    def heading_reward(self):
        sl = self._sl()
        return float(self._vec3(sl.xaxis)[:2] @ self.control_inputs.heading[:2])

    def orientation_reward(self):
        sl = self._sl()
        return float(self._vec3(sl.zaxis)[2])

    def body_height_cost(self, height=0.12):
        sl = self._sl()
        return float(abs(self._vec3(sl.pos)[2] - height))

    def joint_posture_cost(self):
        return float(np.linalg.norm((self.data.ctrl - self.joint_centers) / self.pm.nu))

    def control_cost(self, alpha=0.8):
        """Against the functional carry's state. The EMA reference value
        (``previous_ctrl_cost``) is the frozen first-step cost, the
        reference's quirk; after a step ``previous_ctrl`` already holds
        the current ctrl, so diff == 0, as in the reference."""
        diff = self.data.ctrl - self.previous_ctrl
        cost = float(np.sum(np.square(diff)))
        ref = self.previous_ctrl_cost if self.previous_ctrl_cost is not None else cost
        return alpha * ref + (1 - alpha) * cost

    def control_frequency_cost(self, target_frequencies=(1.0, 1.0, 0.0)):
        target = np.array(list(target_frequencies) * 4, dtype=np.float32)
        return float(np.linalg.norm((self.ctrl_f_est - target) / self.pm.nu))

    def control_amplitude_cost(self, target_amplitudes=(1.5, 0.5, 0.0)):
        target = np.array(list(target_amplitudes) * 4, dtype=np.float32)
        return float(np.linalg.norm((self.ctrl_a_est - target) / self.pm.nu))

    def alive_bonus(self):
        return 1

    def input_control_reward(self):
        """The composite reward of the step, as ``walking.step`` computed
        it (same weights, EMA freeze, first-step-derivative quirks); it
        publishes the per-component breakdown into ``self.info`` as the
        reference does."""
        self.info = dict(self._functional_components)
        return self._functional_reward

    def flip_termination(self):
        sl = self._sl()
        return bool(self._vec3(sl.zaxis)[2] < 0)

    def _default_termination(self):
        return self.flip_termination() or super()._default_termination()

    def _default_reward(self):
        return self.input_control_reward()

    # -- debug geoms -------------------------------------------------------------

    def render_custom_geoms(self):
        origin = self._vec3(self._sl().pos)
        self.render_vector(origin, self.control_inputs.global_velocity, [1, 0, 0, 1], offset=0.1)
        self.render_vector(origin, self.control_inputs.heading, [0, 1, 0, 1], offset=0.05)
        self.render_point(self.ideal_position, [1, 0, 1, 1])


class POWalkingQuadrupedEnv(WalkingQuadrupedEnv):
    """Partially-observed variant: IMU + Madgwick orientation +
    optical-flow velocity + ctrl + command, frame-stacked."""

    def __init__(self, obs_window: int = 1, **kwargs):
        self.obs_window = obs_window
        super().__init__(**kwargs)
        if spaces is not None:
            dim = observations.PO_OBS_DIM * obs_window
            self.observation_space = spaces.Box(
                low=-np.inf, high=np.inf, shape=(dim,), dtype=np.float32
            )

    def _partial_obs(self) -> bool:
        return True

    @property
    def computed_orientation(self):
        return self._wstate.obs.mad_quat[0].cpu().numpy()


class DummyWalkingQuadrupedEnv(WalkingQuadrupedEnv):
    """Simple forward/no-drift reward variant (dead code in the reference,
    a broken import; this one works): the composite 0.1*alive - 0.5*ctrl
    + 5*fwd - 3*drift."""

    reward_keys = ["alive_bonus", "control_cost", "forward_reward", "no_drift_reward"]

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._prev_ctrl_host = self.joint_centers.copy().astype(np.float64)
        self._ctrl_cost_ref = None

    def forward_reward(self):
        sl = self._sl()
        return float(self.data.sensordata[sl.linvel] * self.data.sensordata[sl.pos])

    def no_drift_reward(self):
        sl = self._sl()
        return float(
            abs(self.data.sensordata[sl.linvel + 1] * self.data.sensordata[sl.pos + 1])
        )

    def control_cost(self, alpha=0.8):
        diff = self.data.ctrl - self._prev_ctrl_host
        self._prev_ctrl_host = self.data.ctrl.copy()
        cost = float(np.sum(np.square(diff)))
        if self._ctrl_cost_ref is None:
            self._ctrl_cost_ref = cost
        return alpha * self._ctrl_cost_ref + (1 - alpha) * cost

    def step(self, action):
        obs, _, terminated, truncated, _ = super().step(action)
        comps = {
            "alive_bonus": 0.1 * 1.0,
            "control_cost": -0.5 * self.control_cost(),
            "forward_reward": 5.0 * self.forward_reward(),
            "no_drift_reward": -3.0 * self.no_drift_reward(),
        }
        self.info = comps
        return obs, float(sum(comps.values())), terminated, truncated, comps
