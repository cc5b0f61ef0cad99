"""The port's native runtime (``native/``) against the JAX package's, on
the CPU: the same C++ sources, a reward CSV equal byte for byte to the
JAX package's native logger's, a shared-memory bus each package reads
from the other, the Python fallback, and the trainer writing its CSV
through ``make_reward_logger``."""

import filecmp
import os
import threading

import numpy as np
import pytest

from quadruped_gym_tpu import native as jnative
from quadruped_gym_tpu_torch import native
from quadruped_gym_tpu_torch.rl import train
from quadruped_gym_tpu_torch.tasks.rewards import REWARD_KEYS
from quadruped_gym_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs():
    if native.load() is None or jnative.load() is None:
        pytest.skip("g++ unavailable")
    return native.load(), jnative.load()


def _name(tag):
    return f"/qgt_torch_{tag}_{os.getpid()}"


@pytest.mark.parametrize("src", ["telemetry.cc", "control_bus.cc"])
def test_sources_are_the_jax_packages(src):
    ours = os.path.join(REPO, "quadruped_gym_tpu_torch", "native", src)
    theirs = os.path.join(REPO, "quadruped_gym_tpu", "native", src)
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_library_is_built_beside_the_package_not_the_sources(libs):
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        REPO, "build", "quadruped_gym_tpu_torch")
    assert not os.path.exists(os.path.join(
        REPO, "quadruped_gym_tpu_torch", "native", "_qgt_native.so"))
    assert libs[0]._name == path


def _write(mod, path, rows, start=0, append=True):
    lg = mod.NativeRewardLogger(path, REWARD_KEYS, append=append)
    lg.log_many(start, rows)
    lg.flush()
    dropped = lg.dropped
    lg.close()
    return dropped


@pytest.mark.parametrize("rows", [
    np.arange(33, dtype=float).reshape(3, 11),
    np.random.RandomState(0).randn(20000, 11),
], ids=["3x11", "20000x11"])
def test_native_csv_equals_the_jax_packages(tmp_path, libs, rows):
    ours, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    assert _write(native, ours, rows) == 0
    assert _write(jnative, theirs, rows) == 0
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # the parsed file is the Python logger's, to the native writer's
    # ten significant digits ("%.10g")
    py = str(tmp_path / "python.csv")
    lg = metrics.RewardCSVLogger(py, REWARD_KEYS)
    lg.log_many(0, rows)
    lg.close()
    s1, t1, c1, k1 = metrics.read_reward_csv(ours)
    s2, t2, c2, k2 = metrics.read_reward_csv(py)
    assert k1 == k2 == REWARD_KEYS
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_allclose(c1, c2, rtol=5e-10, atol=1e-300)
    np.testing.assert_allclose(t1, t2, rtol=5e-10, atol=1e-9)
    np.testing.assert_array_equal(
        c1, np.vectorize(lambda x: float("%.10g" % x))(rows))


def test_native_logger_refuses_a_row_of_another_width(tmp_path, libs):
    lg = native.NativeRewardLogger(str(tmp_path / "w.csv"), REWARD_KEYS)
    try:
        with pytest.raises(ValueError, match="expected shape"):
            lg.log(0, np.zeros(10))
        with pytest.raises(ValueError, match="expected shape"):
            lg.log_many(0, np.zeros((2, 12)))
        lg.log(0, np.zeros(11))
        lg.flush()
        assert lg.dropped == 0
    finally:
        lg.close()
    assert len(metrics.read_reward_csv(str(tmp_path / "w.csv"))[0]) == 1


def test_native_append_keeps_single_header(tmp_path, libs):
    p = str(tmp_path / "r.csv")
    for start in (0, 2):
        assert _write(native, p, np.ones((2, 11)), start=start) == 0
    with open(p) as f:
        assert f.read().count("step,total") == 1
    steps, _, comp, _ = metrics.read_reward_csv(p)
    assert list(steps) == [0, 1, 2, 3]
    np.testing.assert_array_equal(comp, np.ones((4, 11)))


def test_fallback_factory_when_the_build_fails(tmp_path, monkeypatch):
    """No library and a compiler that is not there: the Python logger,
    with the same schema."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path / "b"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    lg = native.make_reward_logger(str(tmp_path / "x.csv"), REWARD_KEYS)
    assert isinstance(lg, metrics.RewardCSVLogger)
    assert native.load() is None
    assert not os.listdir(tmp_path / "b")  # nothing half-built left
    lg.log_many(0, np.zeros((1, 11)))
    lg.flush()
    lg.close()
    assert metrics.read_reward_csv(str(tmp_path / "x.csv"))[3] == REWARD_KEYS
    with pytest.raises(RuntimeError, match="unavailable"):
        native.ControlBus.create(_name("none"), 3, 2)


def test_factory_is_native_where_it_builds(tmp_path, libs):
    lg = native.make_reward_logger(str(tmp_path / "n.csv"), REWARD_KEYS)
    assert isinstance(lg, native.NativeRewardLogger)
    lg.close()


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_control_bus_across_the_packages(libs, creator):
    """One package creates the bus, the other opens it; values and
    timestamps come through exactly, with JAX's sequence numbers."""
    made, opened = (native, jnative) if creator == "port" else (jnative,
                                                                 native)
    name = _name(f"bus_{creator}")
    bus = made.ControlBus.create(name, nsensor=37, nctrl=12)
    try:
        assert bus.read_sensor() == (0, None, None)  # never written
        sens = np.random.RandomState(1).randn(37)
        bus.write_sensor(sens, t=1.25)
        bus.write_ctrl(np.arange(12.0) * 0.1, t=2.5)
        other = opened.ControlBus.open(name)
        assert (other.nsensor, other.nctrl) == (37, 12)
        seq, v, t = other.read_sensor()
        assert seq == 2 and t == 1.25
        np.testing.assert_array_equal(v, sens)
        seq, v, t = other.read_ctrl()
        assert seq == 2 and t == 2.5
        np.testing.assert_array_equal(v, np.arange(12.0) * 0.1)
        other.write_sensor(np.full(37, 7.0), t=9.0)
        other.close()
        seq, v, t = bus.read_sensor()
        assert seq == 4 and t == 9.0 and (v == 7.0).all()
        with pytest.raises(ValueError, match="expected shape"):
            bus.write_ctrl(np.zeros(3))
    finally:
        bus.unlink()
        bus.close()
    with pytest.raises(RuntimeError, match="closed"):
        bus.read_ctrl()


def test_control_bus_no_torn_reads(libs):
    """Seqlock consistency under a concurrent writer of the JAX package:
    every snapshot the port's reader obtains is internally consistent."""
    name = _name("tear")
    bus = native.ControlBus.create(name, nsensor=64, nctrl=12)
    writer_bus = jnative.ControlBus.open(name)
    stop = threading.Event()

    def writer():
        k = 0.0
        while not stop.is_set():
            k += 1.0
            writer_bus.write_sensor(np.full(64, k), t=k)

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    try:
        reads = 0
        while reads < 2000:
            seq, v, t = bus.read_sensor()
            if seq == 0:
                continue
            assert v.min() == v.max(), "torn snapshot"
            assert t == v[0]
            reads += 1
    finally:
        stop.set()
        th.join(timeout=5)
        writer_bus.close()
        bus.unlink()
        bus.close()
    assert not th.is_alive()


def test_trainer_writes_its_csv_through_make_reward_logger(tmp_path, libs,
                                                           monkeypatch):
    made = []

    def spy(path, keys):
        lg = native.make_reward_logger(path, keys)
        made.append(lg)
        return lg

    monkeypatch.setattr(train, "make_reward_logger", spy)
    out = str(tmp_path / "run")
    train.main(["--output", out, "--iterations", "1", "--num-envs", "2",
                "--num-steps", "3", "--timesteps-per-iteration", "6",
                "--frame-skip", "1", "--max-contacts", "4",
                "--solver-iterations", "2", "--no-eval"], device="cpu")
    assert len(made) == 1 and isinstance(made[0], native.NativeRewardLogger)
    csv = os.path.join(out, "rewards_continuous.csv")
    assert made[0].keys == REWARD_KEYS
    steps, _, comp, keys = metrics.read_reward_csv(csv)
    assert list(steps) == [0, 1, 2] and keys == REWARD_KEYS
    assert np.isfinite(comp).all()
    # the native writer's bytes: each row printed again as telemetry.cc
    # prints it gives the file
    with open(csv) as f:
        lines = f.read().split("\n")
    assert lines[-1] == ""
    for line in lines[1:-1]:
        step, *nums = line.split(",")
        assert line == ",".join([step] + ["%.10g" % float(x) for x in nums])
