"""The port's typed config (``runtime/config.py``): dict and JSON round
trips as in tests/test_config.py, dtypes written by name, and files that
the JAX package saves loading in the port and the other way round."""

import json

import jax.numpy as jnp
import pytest
import torch

from quadruped_gym_tpu.runtime import config as jconfig
from quadruped_gym_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from quadruped_gym_tpu.runtime.mpc_runtime import MPCConfig as JMPCConfig
from quadruped_gym_tpu.tasks.walking import WalkingConfig as JWalkingConfig
from quadruped_gym_tpu_torch.runtime import config
from quadruped_gym_tpu_torch.runtime.mpc_runtime import MPCConfig
from quadruped_gym_tpu_torch.solvers.ilqr import ILQRConfig
from quadruped_gym_tpu_torch.solvers.sqp import SQPConfig
from quadruped_gym_tpu_torch.tasks.walking import WalkingConfig


def _same(a, b) -> bool:
    """Equal as written (NaN fields, e.g. the unfixed sample options,
    compare equal)."""
    return json.dumps(config.to_dict(a)) == json.dumps(config.to_dict(b))


def test_roundtrip_default():
    cfg = config.FrameworkConfig()
    cfg2 = config.from_dict(config.to_dict(cfg))
    assert cfg2.env == cfg.env
    assert cfg2.ppo == cfg.ppo
    assert cfg2.mpc.mppi == cfg.mpc.mppi
    assert cfg2.mpc.sqp == cfg.mpc.sqp and cfg2.ilqr == cfg.ilqr
    assert cfg2 == cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_roundtrip_modified(tmp_path, dtype):
    cfg = config.FrameworkConfig(
        env=WalkingConfig(max_time=20.0, frame_skip=10, obs_window=10,
                          partial_obs=True, dtype=dtype),
        mpc=MPCConfig(solver="ilqr", sqp=SQPConfig(iterations=3)),
        seed=7,
    )
    p = str(tmp_path / "cfg.json")
    config.save(p, cfg)
    with open(p) as f:
        assert json.load(f)["env"]["dtype"] == str(dtype).split(".")[-1]
    cfg2 = config.load(p)
    assert cfg2.env.max_time == 20.0
    assert cfg2.env.frame_skip == 10
    assert cfg2.env.dtype is dtype
    assert cfg2.seed == 7
    assert cfg2.mpc.solver == "ilqr"
    assert isinstance(cfg2.mpc.sqp, SQPConfig)
    assert cfg2.mpc.sqp.iterations == 3
    assert _same(cfg2, cfg)


def test_nested_override_from_dict():
    d = config.to_dict(config.FrameworkConfig())
    d["mpc"]["mppi"]["num_samples"] = 2048
    d["mpc"]["mppi"]["rollout"]["horizon"] = 30
    d["ilqr"]["alphas"] = [1.0, 0.5]
    cfg = config.from_dict(d)
    assert cfg.mpc.mppi.num_samples == 2048
    assert cfg.mpc.mppi.rollout.horizon == 30
    assert cfg.ilqr.alphas == (1.0, 0.5)
    d["mpc"]["nope"] = 1
    with pytest.raises(KeyError, match="nope"):
        config.from_dict(d)
    d = config.to_dict(config.FrameworkConfig())
    d["env"]["dtype"] = "Tensor"
    with pytest.raises(ValueError, match="dtype"):
        config.from_dict(d)


def test_jax_saved_file_loads_in_the_port(tmp_path):
    p = str(tmp_path / "jax.json")
    jconfig.save(p, jconfig.FrameworkConfig(
        env=JWalkingConfig(max_time=12.0, dtype=jnp.float64),
        mpc=JMPCConfig(solver="sqp"), ilqr=JILQRConfig(iterations=3),
        seed=5))
    cfg = config.load(p)
    assert cfg.env.dtype is torch.float64 and cfg.env.max_time == 12.0
    assert cfg.mpc.solver == "sqp" and cfg.ilqr.iterations == 3
    assert cfg.seed == 5
    want = config.FrameworkConfig(
        env=WalkingConfig(max_time=12.0, dtype=torch.float64),
        mpc=MPCConfig(solver="sqp"), ilqr=ILQRConfig(iterations=3), seed=5)
    assert _same(cfg, want)
    with open(p) as f:  # the same file as the port writes
        assert json.load(f) == json.loads(json.dumps(config.to_dict(want)))


def test_port_saved_file_loads_in_jax(tmp_path):
    p = str(tmp_path / "port.json")
    config.save(p, config.FrameworkConfig(
        env=WalkingConfig(frame_skip=4, dtype=torch.float32),
        mpc=MPCConfig(solver="ilqr"), seed=3))
    cfg = jconfig.load(p)
    assert cfg.env.dtype is jnp.float32 and cfg.env.frame_skip == 4
    assert cfg.mpc.solver == "ilqr" and cfg.seed == 3
    assert cfg.mpc.mppi == jconfig.FrameworkConfig().mpc.mppi
    assert cfg.ppo == jconfig.FrameworkConfig().ppo
