"""Build the kernels' device code for the host (g++) and bind it with
ctypes: shared by the test files that run the kernels' own arithmetic on
the CPU (``tests/torch_host_rollout.cpp`` holds the entry points)."""

import ctypes
import os
import shutil
import subprocess

import pytest

from quadruped_gym_tpu_torch.ops import _build

HERE = os.path.dirname(os.path.abspath(__file__))


def build(tmp_dir) -> ctypes.CDLL:
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    out = os.path.join(str(tmp_dir), "host_rollout.so")
    subprocess.run([cxx, "-O2", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    f"-I{_build.CSRC}", "-o", out,
                    os.path.join(HERE, "torch_host_rollout.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    # the card's form, 4 x split host threads a robot (split replicas of a
    # quad); the last argument is the split
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"qg_host_rollout_{dt}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_int])
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qg_host_substeps_{dt}")
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
        fn.restype = ctypes.c_int
        getattr(lib, f"qg_model_size_{dt}").restype = ctypes.c_int
    return lib
