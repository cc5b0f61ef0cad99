"""Build and load the CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each source in ``csrc/`` that defines kernels is compiled once per real
type (``-DQG_REAL=float`` / ``double``) for ``sm_90a``, into
``build/quadruped_gym_tpu_torch/`` beside the package, at first use. A
library is named by the hash of every source in ``csrc/`` and of the
flags, so an edit rebuilds it.
``build_all`` starts all the nvcc processes together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]
REALS = {"float32": "float", "float64": "double"}

_LIBS: dict = {}


def build_dir() -> str:
    return os.path.join(_PKG_PARENT, "build", "quadruped_gym_tpu_torch")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _flags(dtype: str):
    return ARCH_FLAGS + FLAGS + [f"-DQG_REAL={REALS[dtype]}"]


def _digest(dtype: str) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(dtype)).encode())
    return h.hexdigest()[:16]


def _lib_path(source: str, dtype: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"{stem}_{dtype}_{_digest(dtype)}.so")


def _start(source: str, dtype: str):
    out = _lib_path(source, dtype)
    if os.path.exists(out):
        return None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + _flags(dtype) + ["-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job, source: str, dtype: str) -> None:
    proc, tmp, out = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} ({dtype}):\n{text}")
    os.replace(tmp, out)
    with open(out + ".log", "w") as f:
        f.write(text)


def kernel_sources():
    """Every source in ``csrc/`` that defines kernels (the ``*.cu``)."""
    return tuple(sorted(os.path.basename(p)
                        for p in glob.glob(os.path.join(CSRC, "*.cu"))))


def build_all(sources=None, dtypes=("float32", "float64")) -> None:
    """Build every (source, dtype) library that is missing, all nvcc
    processes at once. ``sources`` defaults to every kernel source."""
    if sources is None:
        sources = kernel_sources()
    jobs = [(s, d, _start(s, d)) for s in sources for d in dtypes]
    for s, d, job in jobs:
        if job is not None:
            _finish(job, s, d)


def ptxas_report(source: str, dtype: str) -> str:
    """What ``nvcc -Xptxas -v`` said about the built library's kernels:
    registers, stack frame, spill stores and loads, under each kernel's
    name and split (``substep_kernel<4>``)."""
    with open(_lib_path(source, dtype) + ".log") as f:
        lines = f.read().splitlines()
    keep = ("registers", "spill", "stack frame")
    out = []
    for ln in lines:
        name = re.search(
            r"Function properties for _ZN2qg\d+([a-z_]+)ILi(\d+)E", ln)
        if name:
            out.append(f"{name.group(1)}<{name.group(2)}>:")
        elif any(k in ln for k in keep):
            out.append(ln.strip())
    return "\n".join(out)


def load(source: str, dtype: str) -> ctypes.CDLL:
    """The library of ``source`` for ``dtype`` ('float32' / 'float64'),
    built first if missing."""
    key = (source, dtype)
    if key not in _LIBS:
        build_all((source,), (dtype,))
        _LIBS[key] = ctypes.CDLL(_lib_path(source, dtype))
    return _LIBS[key]
