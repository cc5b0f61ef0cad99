"""Host-side visualisation of the engine's state: frames and video.

Counterpart of ``quadruped_gym_tpu/envs/rendering.py``. This package
carries no MuJoCo, so there is no GL renderer: ``HostRenderer`` always
draws the software ``WireframeRenderer`` (a pinhole projection of the
ground grid, the kinematic tree, the base's heading triad, the feet and
the env's debug arrows and points, drawn with OpenCV), which is what the
JAX package falls back to on a host without GL. The kinematics it draws
are this package's own forward kinematics (``physics/smooth.py``), run
on the host in float64. Frames keep the reference's sim-time pacing, the
camera follows the base, and mp4 capture and the "human" window need
OpenCV: without it they raise, as in the JAX package. ``close`` destroys
the OpenCV window only where "human" mode opened one: a headless OpenCV
build has no window functions.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.spec import PhysicsModel
from ..physics import smooth

try:
    import cv2

    HAVE_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAVE_CV2 = False


class Camera:
    """Orbit camera around ``lookat`` (MuJoCo's free-camera fields)."""

    def __init__(self, distance: float = 1.0, elevation: float = -30.0,
                 azimuth: float = 120.0):
        self.lookat = np.zeros(3)
        self.distance = distance
        self.elevation = elevation
        self.azimuth = azimuth


class Frame(NamedTuple):
    """Host mirror of one state: what a frame is drawn from."""

    qpos: np.ndarray  # (nq,)
    qvel: np.ndarray  # (nv,)
    time: float
    xpos: np.ndarray  # (nbody, 3) body frame origins
    xmat: np.ndarray  # (nbody, 3, 3) body orientations


def host_frame(m: PhysicsModel, qpos, qvel=None, time_: float = 0.0) -> Frame:
    """Forward kinematics of ``qpos`` on the host in float64."""
    q = torch.tensor(np.array(qpos, np.float64), device="cpu")
    kin = smooth.fwd_position(m, q)
    v = np.zeros(m.nv) if qvel is None else np.asarray(qvel, np.float64)
    return Frame(qpos=q.numpy().copy(), qvel=v.copy(), time=float(time_),
                 xpos=kin.xpos.numpy(), xmat=kin.xmat.numpy())


class WireframeRenderer:
    """Software renderer: pinhole projection + OpenCV lines.

    Draws the ground grid, the robot's kinematic tree as a coloured
    skeleton, the base's x and z axes, foot markers and the env's debug
    arrows/points: enough to see a gait in the recorded mp4."""

    FOVY = 45.0

    def __init__(self, model: PhysicsModel, width: int, height: int):
        self.model = model
        self.width = width
        self.height = height
        # kinematic-tree edges (parent body -> body) inside the robot;
        # world-rooted edges are skipped
        self.edges = [
            (int(model.body_parentid[b]), b)
            for b in range(1, model.nbody)
            if model.body_parentid[b] != 0
        ]
        # the foot markers: collision geoms named "foot...", at their
        # offset in their body
        self._feet = [
            (int(model.col_geom_bodyid[g]),
             np.asarray(model.col_geom_pos[g], np.float64))
            for g, name in enumerate(model.col_geom_names)
            if "foot" in name
        ]

    def _camera_frame(self, camera):
        az = np.radians(camera.azimuth)
        el = np.radians(camera.elevation)
        fwd = np.array([
            np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
        ])
        lookat = np.asarray(camera.lookat, np.float64)
        pos = lookat - camera.distance * fwd
        z = fwd / np.linalg.norm(fwd)  # camera looks along +z_cam
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)  # screen right
        n = np.linalg.norm(x)
        x = x / (n if n > 1e-9 else 1.0)
        y = np.cross(z, x)  # screen DOWN (right-handed with z forward)
        R = np.stack([x, y, z])  # world -> cam rows
        return R, pos

    def _project(self, R, campos, pts):
        pc = (np.atleast_2d(pts) - campos) @ R.T
        f = 0.5 * self.height / np.tan(np.radians(self.FOVY) / 2)
        zs = np.maximum(pc[:, 2], 1e-3)
        u = self.width / 2 + f * pc[:, 0] / zs
        v = self.height / 2 + f * pc[:, 1] / zs  # y_cam already points down
        valid = pc[:, 2] > 0.05
        return np.stack([u, v], 1), valid

    @staticmethod
    def _c(color):
        c = (np.clip(np.asarray(color, np.float64)[:3], 0, 1) * 255)
        return int(c[2]), int(c[1]), int(c[0])  # BGR

    def feet(self, frame: Frame) -> np.ndarray:
        """(nfeet, 3) world positions of the foot geoms."""
        return np.array([frame.xpos[b] + frame.xmat[b] @ p
                         for b, p in self._feet]).reshape(-1, 3)

    def render(self, frame: Frame, camera, extra=()):
        if not HAVE_CV2:
            raise RuntimeError("the wireframe renderer requires OpenCV")
        img = np.full((self.height, self.width, 3), 250, np.uint8)
        R, campos = self._camera_frame(camera)

        def line(a, b, color, w=1):
            p, ok = self._project(R, campos, np.stack([a, b]))
            if ok.all():
                cv2.line(img, tuple(p[0].astype(int)), tuple(p[1].astype(int)),
                         color, w, cv2.LINE_AA)

        # ground grid (0.1 m cells) around the camera target
        cx, cy = np.round(np.asarray(camera.lookat[:2], np.float64), 1)
        rng = np.arange(-0.5, 0.51, 0.1)
        for g in rng:
            line([cx + g, cy - 0.5, 0], [cx + g, cy + 0.5, 0], (210, 210, 210))
            line([cx - 0.5, cy + g, 0], [cx + 0.5, cy + g, 0], (210, 210, 210))

        # skeleton: one colour per leg chain, black base
        xpos = frame.xpos
        leg_colors = [(180, 90, 30), (30, 90, 180), (30, 160, 30), (140, 30, 150)]
        for parent, b in self.edges:
            # bodies are laid out base, then 3 per leg
            leg = (b - 2) // 3 if b >= 2 else -1
            color = leg_colors[leg % 4] if leg >= 0 else (40, 40, 40)
            line(xpos[parent], xpos[b], color, 2)

        # base heading triad
        xmat = frame.xmat[1]
        base = xpos[1]
        line(base, base + 0.08 * xmat[:, 0], (0, 0, 220), 2)   # x: red
        line(base, base + 0.08 * xmat[:, 2], (220, 80, 0), 2)  # z: blue

        # feet markers
        for foot in self.feet(frame):
            p, ok = self._project(R, campos, foot)
            if ok[0]:
                cv2.circle(img, tuple(p[0].astype(int)), 4, (30, 30, 30), -1,
                           cv2.LINE_AA)

        # debug geoms queued by render_vector/render_point
        for item in extra:
            if item[0] == "vec":
                _, origin, endpoint, color = item
                line(origin, endpoint, self._c(color), 2)
            else:
                _, pos, color, radius = item
                p, ok = self._project(R, campos, np.asarray(pos, np.float64))
                if ok[0]:
                    cv2.circle(img, tuple(p[0].astype(int)), 5,
                               self._c(color), -1, cv2.LINE_AA)

        cv2.putText(img, f"t={frame.time:6.2f}s  z={frame.qpos[2]:.3f}",
                    (8, 16), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (60, 60, 60), 1,
                    cv2.LINE_AA)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class HostRenderer:
    """Frames of a host mirror of the engine's state, always drawn by the
    ``WireframeRenderer`` (no GL renderer in this package), with the
    reference's sim-time frame pacing, video capture and "human" window."""

    def __init__(
        self,
        model: PhysicsModel,
        width: int = 720,
        height: int = 480,
        render_fps: int = 30,
        save_video: bool = False,
        video_path: str = "videos/simulation.mp4",
    ):
        self.model = model
        self.data = host_frame(model, model.qpos0)
        self.width = width
        self.height = height
        self.render_fps = render_fps
        self.renderer = WireframeRenderer(model, width, height)
        self.save_video = save_video
        self.video_path = video_path
        self.video_writer = None
        self._frame_count = 0
        self._sim_start_time = None
        self._window = False
        self._extra = []
        self.camera = Camera(distance=1.0, elevation=-30, azimuth=120)

    # -- state sync ---------------------------------------------------------

    def sync(self, qpos: np.ndarray, qvel: Optional[np.ndarray] = None,
             time_: float = 0.0):
        """Mirror an engine state on the host (visualisation only)."""
        self.data = host_frame(self.model, qpos, qvel, time_)

    def reset_timers(self, human: bool = False):
        self._frame_count = 0
        if human:
            self._sim_start_time = time.time()
        if self.save_video and self.video_writer is None:
            if not HAVE_CV2:
                raise RuntimeError("video capture requires OpenCV")
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self.video_writer = cv2.VideoWriter(
                self.video_path, fourcc, self.render_fps, (self.width, self.height)
            )

    # -- debug geoms ------------------------------------------------------------

    def render_vector(self, origin, vector, color, scale=0.2, radius=0.005, offset=0.0):
        origin = np.asarray(origin, dtype=np.float64).copy() + np.array([0, 0, offset])
        endpoint = origin + np.asarray(vector, dtype=np.float64) * scale
        self._extra.append(("vec", origin, endpoint, color))

    def render_point(self, position, color, radius=0.01):
        self._extra.append(("point", position, color, radius))

    # -- frame production --------------------------------------------------------

    def render(
        self,
        mode: Optional[str],
        custom_geoms: Optional[Callable[["HostRenderer"], None]] = None,
    ):
        if mode is None:
            return None
        expected = int(self.data.time * self.render_fps)
        if self._frame_count >= expected:
            return None
        self._frame_count += 1

        self.camera.lookat[:] = self.data.qpos[:3]
        self._extra = []
        if custom_geoms is not None:
            custom_geoms(self)
        pixels = self.renderer.render(self.data, self.camera, self._extra)
        if (self.save_video and self.video_writer is not None) or mode == "human":
            if not HAVE_CV2:
                raise RuntimeError("human mode / video requires OpenCV")
            pixels_bgr = cv2.cvtColor(pixels, cv2.COLOR_RGB2BGR)
            if self.save_video and self.video_writer is not None:
                self.video_writer.write(pixels_bgr)

        if mode == "rgb_array":
            return pixels
        if mode == "human":
            if self._sim_start_time is None:
                self._sim_start_time = time.time()
            wait = self._sim_start_time + self.data.time - time.time()
            if wait > 0:
                time.sleep(wait)
            self._window = True
            cv2.imshow("Simulation", pixels_bgr)
            cv2.waitKey(1)
            return None
        return None

    def close(self):
        if self.video_writer is not None:
            self.video_writer.release()
            self.video_writer = None
        if self._window:
            cv2.destroyWindow("Simulation")
            self._window = False
