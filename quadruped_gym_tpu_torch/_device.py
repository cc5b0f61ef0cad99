"""Device choice for the port's entry points: the card unless asked."""

from __future__ import annotations

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
