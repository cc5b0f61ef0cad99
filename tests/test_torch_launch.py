"""The launch geometry of the two CUDA kernels, computed in Python.

Both kernels give a robot to a quad of threads and keep the contact rows
of the model's slots in dynamic shared memory, so the block size, the grid
and the shared bytes of a launch depend on the model and the type.
``cuda_engine.launch_geometry`` chooses them and the C launch functions
only take them; these tests hold the choice to the card's limits and to
the constants of the CUDA sources, on the CPU."""

import os
import re

import pytest
import torch

from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import _build, cuda_engine
from quadruped_gym_tpu_torch.ops import leg_engine as LE

F32, F64 = torch.float32, torch.float64
SIZE = {F32: 4, F64: 8}


def _model(name):
    return getattr(spec, f"get_{name}_model")()


def _constants(header):
    with open(os.path.join(_build.CSRC, header)) as f:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (\w+) = (\d+);", f.read())}


def test_limits_match_the_cuda_sources():
    """``ROW_VALS`` and the launch bounds are written twice, in the CUDA
    headers and in ``cuda_engine``: they must agree, and the row layout
    must tile its ``ROW_VALS`` values."""
    rows = _constants("leg_step.cuh")
    assert rows["ROW_VALS"] == cuda_engine.ROW_VALS
    assert [rows[k] for k in ("ROW_J", "ROW_AREF", "ROW_D", "ROW_JAR",
                              "ROW_JD", "ROW_VALS")] == [0, 27, 31, 32, 36, 40]
    lim = _constants("launch.cuh")
    assert lim["MAX_THREADS"] == cuda_engine.MAX_THREADS
    assert lim["MIN_BLOCKS"] == cuda_engine.MIN_BLOCKS
    with open(os.path.join(_build.CSRC, "leg_model.cuh")) as f:
        assert "MAX_SLOTS = 3 * MAX_GROUPS" in f.read()
    assert cuda_engine.MAX_SLOTS == 3 * cuda_engine.MAX_GROUPS
    # both kernels take their bounds from launch.cuh and their rows from
    # dynamic shared memory
    for source in _build.kernel_sources():
        with open(os.path.join(_build.CSRC, source)) as f:
            src = f.read()
        assert "__launch_bounds__(MAX_THREADS, MIN_BLOCKS)" in src
        assert "extern __shared__" in src


@pytest.mark.parametrize("name,slots", [("planning", 3), ("fast_plant", 7)])
def test_model_slots(name, slots):
    m = _model(name)
    assert cuda_engine.model_slots(m) == slots == sum(
        cuda_engine.slot_budgets(m))
    P = cuda_engine.pack_model(m, F32)
    assert sum(P.grp_nslot[g] for g in range(P.ngroup)) == slots


@pytest.mark.parametrize("name", ["planning", "fast_plant"])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", [65536, 4096, 4001, 4000, 2048, 200, 1])
def test_geometry_covers_the_batch_inside_the_limits(name, dtype, n):
    """Four threads a robot, whole warps, every robot covered by less
    than one spare block, the rows of the model's slots exactly, inside
    the 227 KB a block may ask for and the kernels' launch bound."""
    nslot = cuda_engine.model_slots(_model(name))
    geo = cuda_engine.launch_geometry(nslot, dtype, n)
    assert geo.threads % 32 == 0
    assert 32 <= geo.threads <= cuda_engine.MAX_THREADS
    assert geo.grid * geo.threads >= 4 * n > (geo.grid - 1) * geo.threads
    assert geo.smem_bytes == (cuda_engine.ROW_VALS * nslot * SIZE[dtype]
                              * geo.threads)
    assert geo.smem_bytes <= cuda_engine.SMEM_PER_BLOCK == 232448
    assert cuda_engine.resident_blocks(geo.threads, geo.smem_bytes) >= 1


def test_geometry_of_the_main_paths():
    """The shapes chip_smoke.py launches, float32. The kernels' launch
    bounds leave 8 warps an SM; the planning model's rows fit beside all
    of them, the fast plant's beside 6. Blocks are single warps (the
    smaller block on a tie), so an env batch of 2,048 makes 256 blocks for
    the 132 SMs."""
    plan = cuda_engine.launch_geometry(3, F32, 65536)
    assert plan == (8192, 32, 15360)
    assert cuda_engine.resident_blocks(32, 15360) == 8
    fast = cuda_engine.launch_geometry(7, F32, 65536)
    assert fast == (8192, 32, 35840)
    assert cuda_engine.resident_blocks(32, 35840) == 6
    env = cuda_engine.launch_geometry(7, F32, 2048)
    assert env == (256, 32, 35840)
    assert env.grid >= cuda_engine.SM_COUNT
    # float64 rows are twice the bytes: 3 warps beside the fast plant's
    assert cuda_engine.launch_geometry(7, F64, 4096) == (512, 32, 71680)
    assert cuda_engine.resident_blocks(32, 71680) == 3
    # a batch too small to cover the card still takes the smallest block
    assert cuda_engine.launch_geometry(3, F32, 200) == (25, 32, 15360)
    # no contact groups: no rows, no shared memory
    assert cuda_engine.launch_geometry(0, F32, 65536).smem_bytes == 0


def test_geometry_prefers_resident_threads_then_small_blocks(monkeypatch):
    """With launch bounds that leave 16 warps an SM, the planning model's
    rows (480 B a thread) fit 15 warps as 3 blocks of 160 threads and only
    14 as single warps: the larger block wins when it covers the card."""
    monkeypatch.setattr(cuda_engine, "MAX_THREADS", 256)
    assert cuda_engine.launch_geometry(3, F32, 65536) == (1639, 160, 76800)
    assert cuda_engine.resident_blocks(160, 76800) == 3
    # at 4,096 robots blocks of 160 would leave SMs empty
    assert cuda_engine.launch_geometry(3, F32, 4096) == (512, 32, 15360)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_every_packable_model_fits_a_block(dtype):
    for nslot in range(cuda_engine.MAX_SLOTS + 1):
        for n in (1, 2048, 65536):
            geo = cuda_engine.launch_geometry(nslot, dtype, n)
            assert geo.smem_bytes <= cuda_engine.SMEM_PER_BLOCK
            assert (geo.smem_bytes + cuda_engine.SMEM_BLOCK_RESERVED
                    <= cuda_engine.SMEM_PER_SM)


def test_geometry_refuses_what_cannot_fit(monkeypatch):
    with pytest.raises(LE.IncompatibleModelError, match="contact slots"):
        cuda_engine.launch_geometry(cuda_engine.MAX_SLOTS + 1, F64, 16)
    with pytest.raises(TypeError, match="float32/float64"):
        cuda_engine.launch_geometry(3, torch.float16, 16)
    with pytest.raises(ValueError, match="at least one"):
        cuda_engine.launch_geometry(3, F32, 0)
    # a card whose blocks have less shared memory than one warp's rows:
    # refused, nothing falls back
    monkeypatch.setattr(cuda_engine, "SMEM_PER_BLOCK", 48 * 1024)
    assert cuda_engine.launch_geometry(3, F64, 16).threads == 32
    with pytest.raises(LE.IncompatibleModelError, match="for one warp"):
        cuda_engine.launch_geometry(12, F64, 16)


def test_a_failed_launch_raises_with_its_geometry():
    geo = cuda_engine.LaunchGeometry(8, 128, 300 * 1024)
    cuda_engine._check_launch(0, "substep kernel", geo)
    with pytest.raises(RuntimeError, match=r"CUDA error 1 .*307200 bytes"):
        cuda_engine._check_launch(1, "substep kernel", geo)


@pytest.mark.cuda
def test_refused_launch_raises_on_card():
    """More dynamic shared memory than a block may have: the launch
    function returns the card's error and the wrapper raises; nothing is
    counted, and the next launch works."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python3 chip_smoke.py)")
    from quadruped_gym_tpu_torch.ops.lane_engine import make_lane_state

    m = _model("planning")
    ls = make_lane_state(m, 64, dtype=F32, device="cuda")
    ctrl = torch.zeros((12, 64), dtype=F32, device="cuda")
    cuda_engine.reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_engine._launch_substeps(
            m, ls, ctrl, 1, 2, 4, None, True,
            geometry=cuda_engine.LaunchGeometry(2, 128, 300 * 1024))
    assert cuda_engine.launch_counts["substep"] == 0
    out = cuda_engine.step(m, ls, ctrl, 2, 4)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.qpos).all())
    assert cuda_engine.launch_counts["substep"] == 1
