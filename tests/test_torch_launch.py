"""The launch geometry of the two CUDA kernels, computed in Python.

Both kernels give a robot to ``split`` replicas of a quad of threads and
keep the contact rows of the model's slots in dynamic shared memory, one
column a leg, so the split, the block size, the grid and the shared bytes
of a launch depend on the model, the type and the batch.
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
    # dynamic shared memory, and are built for the splits the rule takes
    # (lane_math.cuh::with_split)
    with open(os.path.join(_build.CSRC, "lane_math.cuh")) as f:
        cases = re.findall(
            r"case (\d+): return f\(std::integral_constant<int, (\d+)>",
            f.read())
    assert sorted(int(a) for a, b in cases if a == b) == sorted(
        cuda_engine.SPLITS)
    for source in _build.kernel_sources():
        with open(os.path.join(_build.CSRC, source)) as f:
            src = f.read()
        assert "__launch_bounds__(MAX_THREADS, MIN_BLOCKS)" in src
        assert "extern __shared__" in src
        assert "with_split(split" in src


@pytest.mark.parametrize("name,slots", [("planning", 3), ("fast_plant", 7)])
def test_model_slots(name, slots):
    m = _model(name)
    assert cuda_engine.model_slots(m) == slots == sum(
        cuda_engine.slot_budgets(m))
    P = cuda_engine.pack_model(m, F32)
    assert sum(P.grp_nslot[g] for g in range(P.ngroup)) == slots


@pytest.mark.parametrize("name", ["planning", "fast_plant", "full"])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", [65536, 4096, 4001, 4000, 2048, 200, 1])
def test_geometry_covers_the_batch_inside_the_limits(name, dtype, n):
    """4 x split threads a robot, whole warps (so a robot never crosses
    one), every robot covered by less than one spare block, the rows of
    the model's slots once a robot (one column a leg, shared by its
    replicas), inside the 227 KB a block may ask for and the kernels'
    launch bound."""
    nslot = cuda_engine.model_slots(_model(name))
    geo = cuda_engine.launch_geometry(nslot, dtype, n)
    assert geo.split in cuda_engine.SPLITS
    assert geo.threads % 32 == 0 and 32 % (4 * geo.split) == 0
    assert 32 <= geo.threads <= cuda_engine.MAX_THREADS
    lanes = 4 * geo.split * n
    assert geo.grid * geo.threads >= lanes > (geo.grid - 1) * geo.threads
    assert geo.smem_bytes == (cuda_engine.ROW_VALS * nslot * SIZE[dtype]
                              * geo.threads // geo.split)
    assert geo.smem_bytes <= cuda_engine.SMEM_PER_BLOCK == 232448
    assert cuda_engine.resident_blocks(geo.threads, geo.smem_bytes) >= 1


# the split each kernel's wrapper takes at 65,536 / 4,096 / 2,048 / 1,024 /
# 200 robots, by kernel, model (contact slots a leg, packed hull vertices)
# and type
B1, B2 = "fused_rollout_cost", "substep"
SPLIT_CHOICES = {
    (B1, "planning", F32): (1, 1, 2, 4, 4),
    (B1, "planning", F64): (1, 1, 2, 4, 4),
    (B1, "fast_plant", F32): (1, 1, 2, 4, 4),
    (B1, "fast_plant", F64): (1, 1, 2, 4, 4),
    (B1, "full", F32): (1, 1, 2, 4, 4),
    (B1, "full", F64): (1, 1, 1, 4, 4),
    (B2, "planning", F32): (1, 1, 2, 4, 4),
    (B2, "planning", F64): (1, 1, 2, 4, 4),
    (B2, "fast_plant", F32): (1, 1, 2, 4, 4),
    (B2, "fast_plant", F64): (1, 1, 2, 4, 4),
    (B2, "full", F32): (1, 1, 4, 4, 4),
    (B2, "full", F64): (1, 1, 1, 4, 4),
}


@pytest.mark.parametrize("kernel,name,dtype", list(SPLIT_CHOICES))
@pytest.mark.parametrize("i,n", enumerate([65536, 4096, 2048, 1024, 200]))
def test_split_choices(kernel, name, dtype, i, n):
    """The rule's choices: 65,536 and the replan's 4,096 rollouts keep a
    quad a robot (4,096 quads are already a warp a scheduler); the env's
    2,048 lanes take 2 replicas, 1,024 and 200 take 4; ``full`` in
    float64 none at 2,048, where its rows leave too few warps an SM for a
    wave of replicas. The substep kernel on ``full`` (1,702 packed
    vertices) may fill two warps a scheduler: 4 replicas at 2,048 lanes
    in float32."""
    m = _model(name)
    per = cuda_engine.scheduler_warps(kernel, m)
    assert per == (2 if (kernel, name) == (B2, "full") else 1)
    geo = cuda_engine.launch_geometry(cuda_engine.model_slots(m), dtype, n,
                                      per)
    assert geo.split == SPLIT_CHOICES[kernel, name, dtype][i]


@pytest.mark.parametrize("nslot", [0, 3, 7, 15, 21])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", [1, 200, 1024, 1056, 1057, 2048, 4096, 8448,
                               65536])
@pytest.mark.parametrize("per", [1, 2])
def test_split_is_the_largest_that_fits_one_wave(nslot, dtype, n, per):
    """A function of the robots, the slots, the type, the residency and
    the warps a scheduler the kernel may fill (``per``) alone: a split
    above 1 puts every block of the grid on the card at once (the SMs
    times the blocks an SM holds at that block and shared size) with at
    most ``per`` warps a scheduler, and no larger split would."""
    geo = cuda_engine.launch_geometry(nslot, dtype, n, per)
    per_column = cuda_engine.ROW_VALS * nslot * SIZE[dtype]

    def fits(g):
        return g is not None and g.grid <= cuda_engine.SM_COUNT * (
            cuda_engine.resident_blocks(g.threads, g.smem_bytes)) and (
            g.grid * g.threads // 32
            <= per * cuda_engine.SCHEDULERS * cuda_engine.SM_COUNT)

    if geo.split > 1:
        assert fits(geo)
    for split in cuda_engine.SPLITS[:-1]:
        if split > geo.split:
            assert not fits(cuda_engine._blocks(per_column, n, split))


def test_geometry_of_the_main_paths():
    """The shapes chip_smoke.py launches, float32. The kernels' launch
    bounds leave 8 warps an SM; the planning model's rows fit beside all
    of them, the fast plant's beside 6. Blocks are single warps (the
    smaller block on a tie). An env batch of 2,048 robots of one quad
    would be 256 warps for the 132 SMs, at most 2 an SM: it takes 2
    replicas a leg instead, 512 warps of 4 robots, a warp a scheduler;
    65,536 and 4,096 robots already give every scheduler a warp and keep
    a quad a robot."""
    plan = cuda_engine.launch_geometry(3, F32, 65536)
    assert plan == (8192, 32, 15360, 1)
    assert cuda_engine.resident_blocks(32, 15360) == 8
    fast = cuda_engine.launch_geometry(7, F32, 65536)
    assert fast == (8192, 32, 35840, 1)
    assert cuda_engine.resident_blocks(32, 35840) == 6
    env = cuda_engine.launch_geometry(7, F32, 2048)
    assert env == (512, 32, 17920, 2)
    assert env.grid <= cuda_engine.SCHEDULERS * cuda_engine.SM_COUNT
    assert cuda_engine.launch_geometry(3, F32, 4096) == (512, 32, 15360, 1)
    # float64 rows are twice the bytes: 3 warps beside the fast plant's
    assert cuda_engine.launch_geometry(7, F64, 4096) == (512, 32, 71680, 1)
    assert cuda_engine.resident_blocks(32, 71680) == 3
    # a batch too small to cover the card even with 4 replicas still
    # takes the smallest block
    assert cuda_engine.launch_geometry(3, F32, 200) == (100, 32, 3840, 4)
    # no contact groups: no rows, no shared memory
    assert cuda_engine.launch_geometry(0, F32, 65536).smem_bytes == 0


def test_geometry_prefers_resident_threads_then_small_blocks(monkeypatch):
    """With launch bounds that leave 16 warps an SM, the planning model's
    rows (480 B a thread) fit 15 warps as 3 blocks of 160 threads and only
    14 as single warps: the larger block wins when it covers the card."""
    monkeypatch.setattr(cuda_engine, "MAX_THREADS", 256)
    assert cuda_engine.launch_geometry(3, F32, 65536) == (1639, 160, 76800,
                                                          1)
    assert cuda_engine.resident_blocks(160, 76800) == 3
    # at 4,096 robots blocks of 160 would leave SMs empty
    assert cuda_engine.launch_geometry(3, F32, 4096) == (512, 32, 15360, 1)


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
    # a card whose blocks have less shared memory than one warp's rows of
    # single quads: refused where the batch takes a quad a robot, nothing
    # falls back; 16 robots of 12 slots take 4 replicas a leg, a quarter
    # of the rows
    monkeypatch.setattr(cuda_engine, "SMEM_PER_BLOCK", 48 * 1024)
    assert cuda_engine.launch_geometry(3, F64, 16).threads == 32
    assert cuda_engine.launch_geometry(12, F64, 16).smem_bytes == 30720
    with pytest.raises(LE.IncompatibleModelError, match="for one warp"):
        cuda_engine.launch_geometry(12, F64, 65536)


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


def test_geometry_counter_records_the_split(monkeypatch):
    """``geometry[kernel]["split"]`` is the launch's replicas a leg, read
    beside its grid and block (the runtime's answer stubbed here)."""
    monkeypatch.setattr(cuda_engine, "geometry", {})
    monkeypatch.setattr(cuda_engine, "_runtime_info", lambda *a: {
        "registers": 255, "local_bytes": 0, "blocks_per_sm": 8})
    m = _model("full")
    for n, split in ((2048, 4), (65536, 1)):
        geo = cuda_engine.launch_geometry(cuda_engine.model_slots(m), F32, n,
                                          cuda_engine.scheduler_warps(B2, m))
        cuda_engine._record_geometry("substep", cuda_engine.SUBSTEP_SOURCE,
                                     m, F32, geo)
        got = cuda_engine.geometry["substep"]
        assert (got["split"], got["grid"], got["threads"]) == (
            split, geo.grid, geo.threads)


def test_ptxas_report_names_each_split(monkeypatch, tmp_path):
    """The build's ptxas lines under each instantiation's name, so the
    registers and spills of split 1 read apart from the others'."""
    log = tmp_path / "k.so.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN2qg14substep_kernelILi2EEEvPKNS_8LegModelIfEE' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN2qg14substep_kernelILi2EEEvPKNS_8LegModelIfEE\n"
        "    96 bytes stack frame, 60 bytes spill stores, 72 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Function properties for "
        "_ZN2qg14substep_kernelILi1EEEvPKNS_8LegModelIfEE\n"
        "    88 bytes stack frame, 52 bytes spill stores, 68 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers\n")
    monkeypatch.setattr(_build, "_lib_path",
                        lambda s, d: str(tmp_path / "k.so"))
    lines = _build.ptxas_report("substep_kernel.cu", "float32").splitlines()
    assert lines[0] == "substep_kernel<2>:"
    assert lines[3] == "substep_kernel<1>:"
    assert lines[4].startswith("88 bytes stack frame")
    assert len(lines) == 6
