"""Device choice for the port's entry points (the card unless asked),
the card line their numbers carry, and the loader by which one entry
point reaches another's helpers."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``. With no device given and no CUDA
    device present this raises: the port never carries on on the CPU
    unless the caller asks for it (``device="cpu"``, as the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")


def card_line(device) -> str:
    """The hardware a number measured on ``device`` comes from: for a CUDA
    device, ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (a card set below its maximum power runs slower under load, so a
    number is kept only with the limit beside it: this raises where
    nvidia-smi cannot say), else "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def repo_module(folder, name):
    """The repo's ``<folder>/<name>.py`` (an example or a script: the
    folders are not packages) as the module ``<folder>.<name>``, loaded
    once."""
    key = f"{folder}.{name}"
    if key not in sys.modules:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(repo, folder, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]
