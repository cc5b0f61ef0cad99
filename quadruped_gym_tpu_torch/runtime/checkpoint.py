"""Checkpoint / resume for train states, policies and solver state.

Counterpart of ``quadruped_gym_tpu/runtime/checkpoint.py``, with its
layout: ``<path>/state.npz`` holds the arrays as ``leaf_0``, ``leaf_1``,
... and the step as ``__step__``; ``<path>/meta.json`` holds the leaf
count and the step. A checkpoint the JAX package wrote is read by
``read`` (its leaves in ``jax.tree_util`` order; ``convert.
policy_params`` takes a policy's), one the port wrote by ``restore``.

The port's trees are flattened in this order:

- a tensor or numpy array is one leaf; ``None`` is none;
- a tuple, list or NamedTuple: its items in order;
- an ``nn.Module``: the values of its ``state_dict()`` in order;
- an optimizer: for each parameter of each group, in order, its state in
  sorted key order (Adam: ``exp_avg``, ``exp_avg_sq``, ``step``);
- a ``torch.Generator``: its ``get_state()``.

So ``rl.ppo.TrainState`` flattens as the network's ``state_dict``, the
Adam state, the env state (``WalkingState`` field by field), ``obs``,
the generator's state and ``update_idx``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

_ORBAX_MARKERS = (
    "_CHECKPOINT_METADATA", "checkpoint", "manifest.ocdbt", "_METADATA", "d",
)


def _leaves(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, torch.optim.Optimizer):
        for group in tree.param_groups:
            for p in group["params"]:
                state = tree.state[p]
                for k in sorted(state):
                    yield state[k]
    elif isinstance(tree, torch.Generator):
        yield tree.get_state()
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _tensor_like(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {a.shape} where the "
                         f"example has {tuple(like.shape)}")
    return torch.as_tensor(a).to(device=like.device, dtype=like.dtype)


def _rebuild(example: Any, it: Iterator[np.ndarray]) -> Any:
    """``example`` with its leaves taken from ``it``. Tensors come back
    new, on the example leaf's device and in its dtype; modules,
    optimizers and generators are restored in place and returned."""
    if example is None:
        return None
    if isinstance(example, torch.Tensor):
        return _tensor_like(next(it), example)
    if isinstance(example, np.ndarray):
        return np.asarray(next(it), dtype=example.dtype)
    if isinstance(example, nn.Module):
        sd = example.state_dict()
        example.load_state_dict({k: _tensor_like(next(it), v)
                                 for k, v in sd.items()})
        return example
    if isinstance(example, torch.optim.Optimizer):
        for group in example.param_groups:
            for p in group["params"]:
                state = example.state[p]
                for k in sorted(state):
                    state[k] = _tensor_like(next(it), state[k])
        return example
    if isinstance(example, torch.Generator):
        example.set_state(torch.as_tensor(next(it), dtype=torch.uint8))
        return example
    if isinstance(example, tuple) and hasattr(example, "_fields"):
        return type(example)(*(_rebuild(x, it) for x in example))
    if isinstance(example, (tuple, list)):
        return type(example)(_rebuild(x, it) for x in example)
    raise TypeError(f"cannot restore a {type(example).__name__}")


def _looks_like_orbax(path: str) -> bool:
    if not os.path.isdir(path) or os.path.exists(
            os.path.join(path, "state.npz")):
        return False
    entries = set(os.listdir(path))
    if entries & set(_ORBAX_MARKERS):
        return True
    # orbax CheckpointManager layout: numbered step dirs containing the above
    return any(
        e.isdigit()
        and os.path.isdir(os.path.join(path, e))
        and set(os.listdir(os.path.join(path, e))) & set(_ORBAX_MARKERS)
        for e in entries
    )


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Save ``tree``: <path>/state.npz + meta.json.

    Atomic: both files are written to temporaries and renamed into place
    (state first, meta last), so a crash mid-save never leaves a
    meta.json beside a torn state.npz; crash resume (``rl/train.py``)
    always sees the last complete checkpoint. The step is stored inside
    the npz too, so a crash between the two renames cannot pair one
    step's meta with the next step's state (``read`` trusts the npz)."""
    os.makedirs(path, exist_ok=True)
    leaves = [_numpy(x) for x in _leaves(tree)]
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    if step is not None:
        arrays["__step__"] = np.asarray(int(step), dtype=np.int64)
    # np.savez appends ".npz" to names without it: keep the suffix last
    tmp_state = os.path.join(path, ".state.tmp.npz")
    np.savez(tmp_state, **arrays)
    os.replace(tmp_state, os.path.join(path, "state.npz"))
    meta = {"num_leaves": len(leaves), "step": step}
    tmp_meta = os.path.join(path, ".meta.json.tmp")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_meta, os.path.join(path, "meta.json"))


def read(path: str) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """The ``leaf_i`` arrays of a checkpoint, whichever package wrote it,
    and its step."""
    if _looks_like_orbax(path):
        raise ValueError(
            f"{path!r} looks like an Orbax checkpoint. This restore reads "
            "the npz+meta layout only: re-save it with the JAX package's "
            "checkpoint.save().")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    n = meta["num_leaves"]
    if sorted(k for k in arrays if k != "__step__") != sorted(
            f"leaf_{i}" for i in range(n)):
        raise ValueError(f"{path!r}: state.npz does not hold the {n} leaves "
                         "meta.json announces")
    # the npz-embedded step is authoritative (written atomically with the
    # leaves); meta.json's copy is a fallback for older checkpoints
    step = arrays.pop("__step__", None)
    step = int(step) if step is not None else meta.get("step")
    return arrays, step


def restore(path: str, example_tree: Any):
    """Restore into the structure of ``example_tree`` (see ``_rebuild``).
    Returns (tree, step)."""
    arrays, step = read(path)
    n = sum(1 for _ in _leaves(example_tree))
    if n != len(arrays):
        raise ValueError(f"{path!r} holds {len(arrays)} leaves, the example "
                         f"{n}: checkpoint/structure mismatch")
    it = iter(arrays[f"leaf_{i}"] for i in range(n))
    return _rebuild(example_tree, it), step


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "meta.json"))
