"""Native (C++) runtime components, loaded via ctypes.

Counterpart of ``quadruped_gym_tpu/native/__init__.py``, with its own
copies of the two host-side sources (``telemetry.cc``: the wait-free SPSC
ring and writer thread behind ``NativeRewardLogger``, so the trainer never
blocks on file IO or the GIL; ``control_bus.cc``: the seqlock shared-memory
``ControlBus`` between an MPC loop and a robot driver process). Neither
touches the card: they are the JAX package's host runtime, with its CSV
schema and shm layout, so either package reads what the other wrote.

The shared library is built on first use with ``g++ -O2 -std=c++17 -fPIC
-shared -pthread ... -lrt`` into ``build/quadruped_gym_tpu_torch/`` beside
the package, named by a hash of the sources and the flags (as
``ops/_build.py`` names the kernels' libraries), never next to the
sources. ``make_reward_logger`` falls back to the Python
``RewardCSVLogger`` when the library cannot be built, as the JAX
package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "telemetry.cc"),
    os.path.join(_DIR, "control_bus.cc"),
]
_PKG_PARENT = os.path.dirname(os.path.dirname(_DIR))
CXX = "g++"
FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]
LIBS = ["-lrt"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def build_dir() -> str:
    return os.path.join(_PKG_PARENT, "build", "quadruped_gym_tpu_torch")


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256()
    for path in _SRCS:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS + LIBS).encode())
    return os.path.join(build_dir(), f"qgt_native_{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = shutil.which(CXX) or CXX
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *FLAGS, *_SRCS, "-o", tmp, *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.qgt_logger_open.restype = ctypes.c_void_p
    lib.qgt_logger_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
    ]
    lib.qgt_logger_log.restype = ctypes.c_int
    lib.qgt_logger_log.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_double),
    ]
    lib.qgt_logger_log_many.restype = ctypes.c_int
    lib.qgt_logger_log_many.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
    ]
    lib.qgt_logger_dropped.restype = ctypes.c_uint64
    lib.qgt_logger_dropped.argtypes = [ctypes.c_void_p]
    lib.qgt_logger_flush.argtypes = [ctypes.c_void_p]
    lib.qgt_logger_close.argtypes = [ctypes.c_void_p]
    lib.qgt_bus_create.restype = ctypes.c_void_p
    lib.qgt_bus_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.qgt_bus_open.restype = ctypes.c_void_p
    lib.qgt_bus_open.argtypes = [ctypes.c_char_p]
    lib.qgt_bus_nsensor.restype = ctypes.c_int
    lib.qgt_bus_nsensor.argtypes = [ctypes.c_void_p]
    lib.qgt_bus_nctrl.restype = ctypes.c_int
    lib.qgt_bus_nctrl.argtypes = [ctypes.c_void_p]
    _dp = ctypes.POINTER(ctypes.c_double)
    lib.qgt_bus_write_sensor.argtypes = [ctypes.c_void_p, _dp, ctypes.c_double]
    lib.qgt_bus_write_ctrl.argtypes = [ctypes.c_void_p, _dp, ctypes.c_double]
    lib.qgt_bus_read_sensor.restype = ctypes.c_ulonglong
    lib.qgt_bus_read_sensor.argtypes = [ctypes.c_void_p, _dp, _dp]
    lib.qgt_bus_read_ctrl.restype = ctypes.c_ulonglong
    lib.qgt_bus_read_ctrl.argtypes = [ctypes.c_void_p, _dp, _dp]
    lib.qgt_bus_close.argtypes = [ctypes.c_void_p]
    lib.qgt_bus_unlink.restype = ctypes.c_int
    lib.qgt_bus_unlink.argtypes = [ctypes.c_char_p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            _LIB = _bind(ctypes.CDLL(path))
        except OSError:
            return None
        return _LIB


class NativeRewardLogger:
    """Drop-in, non-blocking replacement for utils.metrics.RewardCSVLogger.

    Same CSV schema (``step,total,<components...>``, each number written
    as ``%.10g``); enqueue is wait-free from the caller's thread, a C++
    writer thread owns the file."""

    def __init__(self, path: str, keys: Sequence[str],
                 capacity_rows: int = 65536, binary: bool = False,
                 append: bool = True):
        lib = load()
        if lib is None:
            raise RuntimeError("native telemetry library unavailable")
        self._lib = lib
        self.keys = tuple(keys)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h = lib.qgt_logger_open(
            path.encode(), ",".join(keys).encode(), len(keys),
            capacity_rows, int(binary), int(append),
        )
        if not self._h:
            raise OSError(f"cannot open {path}")

    def log(self, step: int, components: np.ndarray) -> None:
        row = np.ascontiguousarray(components, dtype=np.float64)
        if row.shape != (len(self.keys),):
            raise ValueError(f"expected shape ({len(self.keys)},), got "
                             f"{row.shape}")
        self._lib.qgt_logger_log(
            self._h, step, row.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )

    def log_many(self, start_step: int, components: np.ndarray) -> None:
        rows = np.ascontiguousarray(components, dtype=np.float64)
        if rows.ndim != 2 or rows.shape[1] != len(self.keys):
            raise ValueError(f"expected shape (n, {len(self.keys)}), got "
                             f"{rows.shape}")
        self._lib.qgt_logger_log_many(
            self._h, start_step,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            rows.shape[0],
        )

    @property
    def dropped(self) -> int:
        return int(self._lib.qgt_logger_dropped(self._h))

    def flush(self) -> None:
        self._lib.qgt_logger_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.qgt_logger_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_reward_logger(path: str, keys: Sequence[str]):
    """NativeRewardLogger when the toolchain allows, else the Python CSV
    logger — identical schema either way."""
    try:
        return NativeRewardLogger(path, keys)
    except (RuntimeError, OSError):
        from ..utils.metrics import RewardCSVLogger

        return RewardCSVLogger(path, keys)


class ControlBus:
    """Shared-memory real-time exchange with a robot driver process.

    Two seqlock-protected blocks in POSIX shm (``control_bus.cc``): the
    driver publishes (timestamp, sensordata) at its own rate; the MPC loop
    publishes (timestamp, ctrl). Writers are wait-free, readers retry on
    torn snapshots; either process can crash and reattach. A bus of this
    package and one of the JAX package attach to each other.

    >>> bus = ControlBus.create("/qgt_robot0", nsensor=33, nctrl=12)
    >>> bus.write_ctrl(ctrl, t)                  # MPC side, 100 Hz
    >>> seq, sens, t = bus.read_sensor()          # returns (0, None, None)
    ...                                           # until the driver writes
    """

    def __init__(self, lib, handle, name: str):
        self._lib = lib
        self._h = handle
        self.name = name
        self.nsensor = int(lib.qgt_bus_nsensor(handle))
        self.nctrl = int(lib.qgt_bus_nctrl(handle))

    @classmethod
    def create(cls, name: str, nsensor: int, nctrl: int) -> "ControlBus":
        lib = load()
        if lib is None:
            raise RuntimeError("native control-bus library unavailable")
        h = lib.qgt_bus_create(name.encode(), nsensor, nctrl)
        if not h:
            raise OSError(f"cannot create shm bus {name}")
        return cls(lib, h, name)

    @classmethod
    def open(cls, name: str) -> "ControlBus":
        lib = load()
        if lib is None:
            raise RuntimeError("native control-bus library unavailable")
        h = lib.qgt_bus_open(name.encode())
        if not h:
            raise OSError(f"cannot open shm bus {name}")
        return cls(lib, h, name)

    def _write(self, fn, values, n, t):
        if not self._h:
            raise RuntimeError("ControlBus is closed")
        v = np.ascontiguousarray(values, dtype=np.float64)
        if v.shape != (n,):
            raise ValueError(f"expected shape ({n},), got {v.shape}")
        fn(self._h, v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
           float(t))

    def write_sensor(self, values, t: float = 0.0) -> None:
        self._write(self._lib.qgt_bus_write_sensor, values, self.nsensor, t)

    def write_ctrl(self, values, t: float = 0.0) -> None:
        self._write(self._lib.qgt_bus_write_ctrl, values, self.nctrl, t)

    def _read(self, fn, n):
        if not self._h:
            raise RuntimeError("ControlBus is closed")
        out = np.empty(n, np.float64)
        t = ctypes.c_double(0.0)
        seq = fn(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                 ctypes.byref(t))
        if seq == 0:
            return 0, None, None
        return int(seq), out, float(t.value)

    def read_sensor(self):
        """(seq, values, timestamp); seq==0 means never written."""
        return self._read(self._lib.qgt_bus_read_sensor, self.nsensor)

    def read_ctrl(self):
        return self._read(self._lib.qgt_bus_read_ctrl, self.nctrl)

    def close(self) -> None:
        if self._h:
            self._lib.qgt_bus_close(self._h)
            self._h = None

    def unlink(self) -> None:
        self._lib.qgt_bus_unlink(self.name.encode())

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
