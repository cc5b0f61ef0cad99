# Frozen copy of ``resolve_device`` from quadruped_gym_tpu_torch/_device.py for
# the benchmark's plain reference.
"""Device choice of the reference's modules."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; with no device given and no
    CUDA device present this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")
