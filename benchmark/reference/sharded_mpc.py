"""The plain reference of one MPPI solve with its samples sharded over the
ranks of a group, as the port describes ``parallel.sharded_mppi_plan``:
rank r draws its S_local perturbations from ``fold_in(generator, r)``
and scores them on its own card; the cost baseline is the MIN over all
ranks' samples, the weights a softmax over all of them, and the plan the
weighted mean of every rank's sequences. That is ``mpc.solve`` over the
concatenation of the ranks' draws in rank order.

``fold_in_seed`` is a frozen copy of the port's ``parallel.mesh.fold_in``
(the seed of the generator it returns): one ``randint(2**62)`` from a
generator seeded with the solve's seed, on the device the program draws
on, mixed with the rank index through ``numpy.random.SeedSequence``.

The rollouts are spread as the program's are: ``slice_costs`` scores
rank r's slice of each solve on the card it runs on, and ``update``
(on one rank, after the slices' costs are gathered) redraws every
rank's slice and does MPPI's update and the shift over all of them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import mpc
from .commands import Command
from .spec import PhysicsModel


def fold_in_seed(seed: int, idx: int, device) -> int:
    """The seed of stream ``idx`` of a generator seeded with ``seed``, as
    ``fold_in`` makes it from the generator's first draw on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = int(torch.randint(2 ** 62, (), generator=gen, device=device))
    return int(np.random.SeedSequence([draw, int(idx)]).generate_state(
        1, np.uint64)[0])


def slice_inputs(inputs: Sequence[mpc.SolveInput], rank: int):
    """The solves with the noise seed of rank ``rank``'s slice: a fresh
    generator on that seed draws the slice's normals first."""
    return [x._replace(noise_seed=fold_in_seed(x.noise_seed, rank,
                                               x.mean.device))
            for x in inputs]


def slice_costs(m: PhysicsModel, inputs: Sequence[mpc.SolveInput],
                rank: int, cmd: Command, s_local: int, sigma: float,
                frame_skip: int, newton: int, line_search: int,
                noise_dtype: torch.dtype, dtype: torch.dtype,
                block: int) -> torch.Tensor:
    """(len(inputs), s_local) rollout costs of rank ``rank``'s slice of
    each solve, computed in ``dtype``, ``block`` solves a pass."""
    return torch.stack([costs for _, costs in mpc.sample_costs(
        m, slice_inputs(inputs, rank), cmd, s_local, sigma, frame_skip,
        newton, line_search, noise_dtype, dtype, block)])


def update(m: PhysicsModel, inputs: Sequence[mpc.SolveInput],
           costs: torch.Tensor, s_local: int, sigma: float,
           temperature: float, noise_dtype: torch.dtype,
           dtype: torch.dtype) -> list:
    """The solves' outputs from ``costs``, (ranks, len(inputs), s_local)
    in rank order: each rank's slice drawn again, MPPI's update over the
    concatenation, the applied control and the shift (``mpc.solve``'s)."""
    lo = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 0]))
    hi = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 1]))
    out = []
    for i, x in enumerate(inputs):
        dev = x.mean.device
        H, nu = x.mean.shape
        seqs = torch.cat([
            torch.clamp(x.mean.to(dtype)[None] + sigma * mpc.noise(
                y.noise_seed, (s_local, H, nu), noise_dtype, dev).to(dtype),
                lo.to(dev, dtype), hi.to(dev, dtype))
            for y in (slice_inputs([x], r)[0] for r in range(costs.shape[0]))])
        mean, best, mean_cost = mpc.weighted_update(
            seqs, costs[:, i].reshape(-1).to(dev, dtype), temperature)
        out.append(mpc.SolveOutput(
            ctrl=mean[0], carry_mean=torch.cat([mean[1:], mean[-1:]], dim=0),
            best_cost=best, mean_cost=mean_cost))
        del seqs
    return out
