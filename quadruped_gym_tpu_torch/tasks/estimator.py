"""Online per-channel frequency & amplitude estimation as an explicit carry.

Counterpart of ``quadruped_gym_tpu/tasks/estimator.py``:
derivative-sign-crossing counting over a circular window (frequency) and
windowed max-min (amplitude), both EMA-smoothed, including the first-call
behavior (store the sample, return zeros) and zero-derivative sign
retention. Every field takes any leading batch axes (one estimator per
environment), so the buffers are (..., W, C) and each environment has its
own ``buffer_index``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._device import resolve_device


class FreqAmpState(NamedTuple):
    signal_buffer: torch.Tensor  # (..., W, C)
    crossings_buffer: torch.Tensor  # (..., W, C) 0/1
    buffer_index: torch.Tensor  # (...,) int64
    crossings_count: torch.Tensor  # (..., C)
    sample_count: torch.Tensor  # (...,) int64
    prev_sample: torch.Tensor  # (..., C)
    prev_deriv_sign: torch.Tensor  # (..., C)
    has_prev_sample: torch.Tensor  # (...,) bool
    has_prev_sign: torch.Tensor  # (...,) bool
    f_est: torch.Tensor  # (..., C)
    a_est: torch.Tensor  # (..., C)


def window_size(min_freq: float, dt: float) -> int:
    """Two cycles of min_freq."""
    return int(math.ceil(2.0 / (min_freq * dt)))


def init(n_channels: int, window: int, dtype=torch.float32, device=None,
         batch_shape=()) -> FreqAmpState:
    device = resolve_device(device)
    bs = tuple(batch_shape)

    def z(*shape, dt=dtype):
        return torch.zeros(bs + shape, dtype=dt, device=device)

    return FreqAmpState(
        signal_buffer=z(window, n_channels),
        crossings_buffer=z(window, n_channels),
        buffer_index=z(dt=torch.int64),
        crossings_count=z(n_channels),
        sample_count=z(dt=torch.int64),
        prev_sample=z(n_channels),
        prev_deriv_sign=z(n_channels),
        has_prev_sample=z(dt=torch.bool),
        has_prev_sign=z(dt=torch.bool),
        f_est=z(n_channels),
        a_est=z(n_channels),
    )


def update(s: FreqAmpState, x: torch.Tensor, dt: float,
           ema_alpha: float = 0.80):
    """One estimator update on the sample x (..., C). Returns
    (new_state, f_est, a_est)."""
    W, C = s.signal_buffer.shape[-2:]
    dtype = s.signal_buffer.dtype
    first = ~s.has_prev_sample  # (...,)
    first_c = first[..., None]
    has_sign_c = s.has_prev_sign[..., None]
    # this environment's row of the circular buffers
    row = s.buffer_index[..., None, None].expand(
        s.buffer_index.shape + (1, C))

    # the sample is stored on the first call too
    signal_buffer = s.signal_buffer.scatter(-2, row, x[..., None, :])

    # --- regular update ---
    diff = x - s.prev_sample
    sign = torch.sign(diff)
    sign = torch.where(has_sign_c & (sign == 0), s.prev_deriv_sign, sign)
    crossing = torch.where(has_sign_c, (sign != s.prev_deriv_sign).to(dtype),
                           torch.zeros_like(x))
    sample_count = torch.clamp_max(s.sample_count + 1, W)
    crossings_count = (
        s.crossings_count - s.crossings_buffer.gather(-2, row)[..., 0, :]
        + crossing)
    crossings_buffer = s.crossings_buffer.scatter(-2, row,
                                                  crossing[..., None, :])

    effective_duration = sample_count.to(dtype) * dt
    f_current = (crossings_count / 2.0) / effective_duration[..., None]
    f_est = ema_alpha * s.f_est + (1 - ema_alpha) * f_current

    # amplitude over the filled portion of the buffer
    rows = torch.arange(W, device=x.device)[:, None]  # (W, 1)
    filled = rows < sample_count[..., None, None]  # (..., W, 1)
    amp = (torch.amax(signal_buffer.masked_fill(~filled, -torch.inf), dim=-2)
           - torch.amin(signal_buffer.masked_fill(~filled, torch.inf),
                        dim=-2))
    a_est = ema_alpha * s.a_est + (1 - ema_alpha) * amp

    f_out = torch.where(first_c, s.f_est, f_est)
    a_out = torch.where(first_c, s.a_est, a_est)
    new = FreqAmpState(
        signal_buffer=signal_buffer,
        crossings_buffer=torch.where(first_c[..., None], s.crossings_buffer,
                                     crossings_buffer),
        buffer_index=(s.buffer_index + 1) % W,
        crossings_count=torch.where(first_c, s.crossings_count,
                                    crossings_count),
        sample_count=torch.where(first, torch.ones_like(sample_count),
                                 sample_count),
        prev_sample=x,
        prev_deriv_sign=torch.where(first_c, s.prev_deriv_sign, sign),
        has_prev_sample=torch.ones_like(s.has_prev_sample),
        has_prev_sign=s.has_prev_sample,  # sign becomes valid after 2nd call
        f_est=f_out,
        a_est=a_out,
    )
    return new, f_out, a_out
