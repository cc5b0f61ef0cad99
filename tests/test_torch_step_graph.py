"""``envs.vector_env.batched_autoreset_step``'s CUDA graph, what the CPU
can hold: every route the graph does not take (CPU tensors, the eager
engines) counts as eager and computes what the eager step computes; the
step's constants are uploaded once and keep the values the per-call
uploads had, so a step after the first builds no tensor from host data;
the graph's key tells apart what fixes the captured work; the packing of
inputs and outputs into one flat buffer per dtype. The graph itself runs
only on the card (``tests/test_torch_cuda_engine.py``, ``cuda`` marker)."""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from quadruped_gym_tpu_torch.envs import vector_env
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.physics import engine, smooth
from quadruped_gym_tpu_torch.tasks import commands, observations, rewards, walking

N = 3


def _cfg(dtype=torch.float64, **kw):
    base = dict(max_time=0.001, frame_skip=1, obs_window=2, partial_obs=True,
                random_controls=True, random_init=True,
                reset_options=commands.SampleOptions(fixed_speed=0.3),
                solver_iterations=2, dtype=dtype)
    return walking.WalkingConfig(**{**base, **kw})


def _inputs(m, cfg, n=N, seed=0):
    gen = torch.Generator().manual_seed(seed)
    st, _ = walking.reset(m, cfg, n, gen)
    rng = np.random.default_rng(seed)
    action = torch.as_tensor(np.clip(0.5 * rng.standard_normal((n, 12)), -1, 1),
                             dtype=cfg.dtype)
    return st, action


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model,impl", [("planning", "pallas"),
                                        ("planning", "leg"),
                                        ("planning", "auto"),
                                        ("full", "pallas")])
def test_routes_off_the_graph_are_eager_and_unchanged(model, impl):
    """On the CPU, and on every engine but the substep kernel, a call is
    counted eager and returns what the task step and the auto-reset
    compute (``full`` under ``"pallas"``: the lane engine's fallback)."""
    m = getattr(spec, f"get_{model}_model")()
    cfg = _cfg()
    st, action = _inputs(m, cfg)
    vector_env.reset_graph_counts()
    with pytest.warns(UserWarning) if model == "full" else contextlib.nullcontext():
        got = vector_env.batched_autoreset_step(
            m, cfg, st, action, torch.Generator().manual_seed(5),
            engine_impl=impl)
    assert vector_env.graph_counts == {"captures": 0, "replays": 0, "eager": 1}
    with pytest.warns(UserWarning) if model == "full" else contextlib.nullcontext():
        out = walking.batched_step(m, cfg, st, action, engine_impl=impl)
    want = vector_env._autoreset(m, cfg, out, N,
                                 torch.Generator().manual_seed(5))
    assert bool(got.done.all())  # max_time 0.001: every env was reset
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_are_uploaded_once_with_the_old_values(dtype):
    """Each constant of the step is one tensor per (dtype, device), equal
    to what the per-call upload it replaced made."""
    m = spec.get_planning_model()
    centers = rewards.constant(rewards.JOINT_CENTERS, dtype, "cpu")
    assert rewards.constant(rewards.JOINT_CENTERS, dtype, "cpu") is centers
    assert rewards.constant(rewards.JOINT_CENTERS, dtype,
                            torch.device("cpu")) is centers
    torch.testing.assert_close(
        centers, torch.as_tensor(rewards.JOINT_CENTERS, dtype=dtype),
        rtol=0, atol=0)
    jc = rewards.joint_centers(dtype, "cpu", (2,))
    assert jc.shape == (2, 12) and jc.data_ptr() != centers.data_ptr()
    like = torch.zeros((12, 5), dtype=dtype)
    for target in ((1.0, 1.0, 0.0), (1.5, 0.5, 0.0)):
        t = rewards._target(target, like)
        assert t.shape == (12, 1)
        assert rewards._target(target, like).data_ptr() == t.data_ptr()
        torch.testing.assert_close(
            t[:, 0], torch.as_tensor(np.array(list(target) * 4), dtype=dtype),
            rtol=0, atol=0)
    ctrl = torch.as_tensor(np.linspace(-3.0, 3.0, 24).reshape(2, 12),
                           dtype=dtype)
    lo = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 0]), dtype=dtype)
    hi = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 1]), dtype=dtype)
    torch.testing.assert_close(smooth.clip_ctrl(m, ctrl),
                               torch.clamp(ctrl, lo, hi), rtol=0, atol=0)
    assert smooth.consts(m, dtype, "cpu") is smooth.consts(m, dtype, "cpu")
    one, two = (engine.make_state(m, dtype=dtype, device="cpu")
                for _ in range(2))
    torch.testing.assert_close(
        one.qpos, torch.as_tensor(np.asarray(m.qpos0), dtype=dtype),
        rtol=0, atol=0)
    z0 = float(one.qpos[2])
    one.qpos[2] = 7.0  # a caller's write reaches neither the cache nor the model
    assert float(two.qpos[2]) == z0 != 7.0
    assert float(engine.make_state(m, dtype, "cpu").qpos[2]) == z0
    assert float(m.qpos0[2]) != 7.0
    carry = observations.po_init_carry(3, dtype, "cpu", (2,))
    torch.testing.assert_close(
        carry.mad_quat, torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2, dtype=dtype),
        rtol=0, atol=0)


def test_a_warm_step_builds_no_tensor_from_host_data():
    """After its first call the task layer and the auto-reset make no
    tensor from host data (``lift_fresh``, what ``torch.tensor`` and
    ``torch.as_tensor`` of a list or an array run), so on the card they
    copy nothing from the host and a graph can capture them. The physics
    is left out: on the CPU ``"pallas"`` is the plain version of the
    kernel, not its wrapper."""
    m = spec.get_planning_model()
    cfg = _cfg(torch.float32, max_time=1.0)
    st, action = _inputs(m, cfg)
    gen = torch.Generator().manual_seed(1)

    def step():
        out = walking._task_step(m, cfg, st, action, lambda phys, ctrl: phys)
        return vector_env._autoreset(m, cfg, out, N, gen)

    counts = []
    for _ in range(2):
        with _Ops() as ops:
            step()
        counts.append(ops.count)
    assert counts[1]["lift_fresh"] == 0
    assert sum(counts[1].values()) > 100  # the step ran under the counter


def test_graph_key_tells_apart_what_fixes_the_capture():
    """The key differs with the number of envs, the configuration, the
    dtype, the generator and the model, and is the same for new tensors of
    the same shapes."""
    m = spec.get_planning_model()
    cfg = _cfg(torch.float32)
    gen = torch.Generator()

    def key(m=m, cfg=cfg, n=N, gen=gen):
        st, action = _inputs(m, cfg, n)
        return vector_env.graph_key(m, cfg, pytree.tree_leaves((st, action)),
                                    gen)

    base = key()
    assert key() == base and hash(key()) == hash(base)
    others = [key(n=N + 1), key(cfg=dataclasses.replace(cfg, max_time=5.0)),
              key(cfg=_cfg(torch.float64)), key(gen=torch.Generator()),
              key(m=spec.get_fast_plant_model())]
    assert all(k != base for k in others)
    assert len(set(others)) == len(others)


def test_inputs_and_outputs_pack_into_one_buffer_per_dtype():
    """``_Packed`` lays a step's tensors out as views of one flat buffer per
    dtype, in the order ``_by_dtype`` groups them, in a round trip that
    the flattening's spec rebuilds the state from."""
    m = spec.get_planning_model()
    cfg = _cfg(torch.float32)
    st, action = _inputs(m, cfg)
    leaves, tree = pytree.tree_flatten((st, action))
    packed = vector_env._Packed(leaves)
    assert packed.dtypes == [torch.float32, torch.int64, torch.bool]
    groups = vector_env._by_dtype(leaves)
    assert [g[0].dtype for g in groups] == packed.dtypes
    assert sum(map(len, groups)) == len(leaves)
    flats = [torch.cat([x.reshape(-1) for x in g]) for g in groups]
    views = packed.views(flats)
    for v, x in zip(views, leaves):
        assert v.shape == x.shape and v.dtype == x.dtype
        torch.testing.assert_close(v, x, rtol=0, atol=0)
    bases = {v.untyped_storage().data_ptr() for v in views}
    assert bases == {f.untyped_storage().data_ptr() for f in flats}
    back, back_action = pytree.tree_unflatten(views, tree)
    assert isinstance(back, walking.WalkingState)
    assert back_action is views[-1]
    assert all(a is b for a, b in zip(pytree.tree_leaves(back), views))


@pytest.mark.parametrize("model,impl,want", [
    ("planning", "pallas", "cuda_engine"), ("planning", "auto", "leg_engine"),
    ("planning", "leg", "leg_engine"), ("planning", "lane", "lane_engine"),
    ("full", "pallas", "lane_engine"), ("full", "auto", "lane_engine")])
def test_batched_engine_is_the_one_choice_of_engine(model, impl, want):
    """``walking.batched_engine`` names the engine ``batched_step`` runs,
    and the graph route is taken exactly when it names the substep
    kernel's wrapper; an unknown name raises."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    m = getattr(spec, f"get_{model}_model")()
    eng = walking.batched_engine(m, impl)
    assert eng.__name__.rsplit(".", 1)[-1] == want
    assert (eng is cuda_engine) == (model == "planning" and impl == "pallas")
    with pytest.raises(ValueError, match="unknown engine_impl"):
        walking.batched_engine(m, "fused")
