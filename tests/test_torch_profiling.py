"""The port's roofline accounting (``utils/profiling.py``) on the CPU.

``cost_summary`` counts operations through ``ops.cuda_engine``'s dispatch
counter: a square matmul is exactly 2n³ of them, and the kernel's plain
version at 4 lanes is 4 x ``rollout_flops``; its bytes are every
dispatched op's inputs and outputs (an upper bound, unfused). ``measure``
runs on CPU tensors as the JAX package's does (tests/test_profiling.py),
``trace`` writes a Chrome trace, and the H100 spec's peaks are the ones
``chip_smoke.py`` holds the kernels to."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.physics.engine import make_state
from quadruped_gym_tpu_torch.tasks.commands import make
from quadruped_gym_tpu_torch.utils import profiling

N = 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cost_summary_matmul(dtype):
    a = torch.ones((N, N), dtype=dtype)
    cs = profiling.cost_summary(lambda x: x @ x, a)
    assert cs.flops == 2 * N**3  # count_ops' contraction rule
    itemsize = torch.finfo(dtype).bits // 8
    # two inputs read, one output written
    assert cs.bytes_accessed == 3 * N * N * itemsize
    assert cs.bytes_accessed >= 2 * N * N * 4
    assert cs.bound in ("compute", "memory")
    assert cs.roofline_s == max(cs.flop_time_s, cs.mem_time_s) > 0
    assert cs.flop_time_s == cs.flops / profiling.H100.peak_flops_f32


def test_views_move_no_bytes():
    x = torch.ones((4, 8))
    for view in (lambda v: v.t()[1:3].unsqueeze(0).expand(2, 2, 4),
                 lambda v: v.reshape(-1)[:3]):
        cs = profiling.cost_summary(view, x)
        assert cs.flops == 0 and cs.bytes_accessed == 0
    # a copy moves its bytes: the transposed tensor read, the copy written
    cs = profiling.cost_summary(lambda v: v.t().reshape(-1), x)
    assert cs.flops == 0 and cs.bytes_accessed == 2 * 32 * 4
    cs = profiling.cost_summary(lambda v: v + 1.0, x)
    assert cs.flops == 32 and cs.bytes_accessed == 2 * 32 * 4


@pytest.mark.parametrize("model,budget,frame_skip", [
    ("planning", (2, 4), 5),
    ("fast_plant", (4, 8), 2),
])
def test_cost_summary_of_the_plain_version_is_rollout_flops(model, budget,
                                                           frame_skip):
    """The plain version on 4 CPU lanes, random moving controls, float32:
    its operations over 4 are ``rollout_flops`` (counted on zeros in
    float64) exactly: the fixed budgets leave no data-dependent work."""
    m = getattr(spec, f"get_{model}_model")()
    dt, lanes = torch.float32, 4
    rng = np.random.default_rng(3)
    st = make_state(m, dtype=dt, device="cpu")
    st = st._replace(qvel=torch.as_tensor(0.1 * rng.standard_normal(m.nv),
                                          dtype=dt))
    seqs = torch.as_tensor(np.clip(
        np.array([0.0, 0.0, -0.5] * 4)
        + 0.3 * rng.standard_normal((lanes, 1, 12)), -1, 1), dtype=dt)
    cmd = make(torch.tensor([0.2, 0.1], dtype=dt), torch.tensor(0.3, dtype=dt))
    prev = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=dt)
    cs = profiling.cost_summary(cuda_engine.fused_rollout_cost_reference, m,
                                st, seqs, cmd, prev, frame_skip, *budget)
    assert cs.flops / lanes == cuda_engine.rollout_flops(
        m, 1, frame_skip, *budget)
    # unfused: far more than the fused kernel's true traffic
    assert cs.bytes_accessed / lanes > 100 * (12 * 4 + 4)


def test_measure_runs():
    a = torch.ones((128, 128), dtype=torch.float32)
    meas = profiling.measure(lambda x: (x * 2.0).sum(), a, iters=3)
    assert meas.wall_s > 0
    assert meas.cost is not None
    assert meas.cost.flops == 2 * 128 * 128  # the products, the sum
    sol = meas.speed_of_light
    assert sol is None or sol >= 0


def test_measure_takes_a_given_cost():
    cost = profiling.roofline(67e9, 0.0)  # 1 ms at the FP32 peak
    assert cost.bound == "compute" and cost.roofline_s == pytest.approx(1e-3)
    meas = profiling.measure(lambda x: x + 1.0, torch.ones(8), iters=2,
                             cost=cost)
    assert meas.cost is cost
    assert meas.speed_of_light == pytest.approx(1e-3 / meas.wall_s)
    assert profiling.measure(lambda x: x, torch.ones(2), iters=1,
                             with_cost=False).speed_of_light is None


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    x = torch.ones((64, 64))
    with profiling.trace(d) as prof:
        (x @ x).sum()
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)
    assert len(prof.events()) > 0


def test_h100_peaks_are_chip_smokes():
    assert profiling.H100.peak_flops_f32 == 67e12
    assert profiling.H100.peak_hbm_bytes == 3.35e12
    assert chip_smoke.PEAK_FP32 == profiling.H100.peak_flops_f32
    assert chip_smoke.PEAK_BYTES == profiling.H100.peak_hbm_bytes
    # the port keeps no TPU spec
    assert not [n for n in dir(profiling) if "TPU" in n.upper()]
