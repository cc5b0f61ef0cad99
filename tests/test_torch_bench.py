"""``torch_bench.py``, the port's ``bench.py``, on the CPU: its JSON line
and ``--plant`` choices are ``bench.py``'s (read from the JAX script's
source by ``ast``), it scores through ``lane_batched_rollout_cost(
engine_impl="fused")`` on each plant's model and budget (on the CPU the
fused kernel's plain version, at S=8 and H=2), and a failure raises."""

import ast
import importlib.util
import json
import os

import pytest
import torch

from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.ops import cuda_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(REPO, "torch_bench.py")
    mod_spec = importlib.util.spec_from_file_location("torch_bench", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(bench, monkeypatch):
    monkeypatch.setattr(bench, "S", 8)
    monkeypatch.setattr(bench, "HORIZON", 2)
    return bench


def _jax_bench():
    with open(os.path.join(REPO, "bench.py")) as f:
        return ast.parse(f.read())


def _jax_keys():
    """(keys of the JSON line of one plant, keys ``--plant both`` adds,
    metric names) of ``bench.py``; the fail-soft keys aside."""
    tree = _jax_bench()
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    line = set()
    for node in ast.walk(funcs["run_bench"]):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"):
            line |= {k.value for k in node.args[0].keys}
    added = set()
    for node in ast.walk(funcs["supervise"]):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.slice, ast.Constant):
                    added.add(t.slice.value)
    metrics = {n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and n.value.startswith("mpc_rollouts_per_s")}
    return line, added - {"full_plant_error"}, metrics


def test_json_line_has_bench_keys(small, monkeypatch, capsys):
    monkeypatch.setattr(small, "ITERS", 1)
    line, added, metrics = _jax_keys()
    assert line == {"metric", "value", "unit", "vs_baseline"}
    assert added == {"full_plant_rollouts_per_s", "full_plant_vs_baseline"}
    out = small.main(["--cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == out
    assert set(out) == line | added | {"card"}
    assert out["metric"] in metrics and out["card"] == "cpu"
    assert out["unit"] == "rollouts/s"
    assert out["value"] > 0 and out["full_plant_rollouts_per_s"] > 0
    assert out["metric"] == "mpc_rollouts_per_s_per_chip_H50"
    one = small.main(["--cpu", "--plant", "full"])
    assert set(one) == line | {"card"}
    assert one["metric"] == "mpc_rollouts_per_s_per_chip_H50_full_plant"
    assert one["vs_baseline"] == round(
        one["value"] / small.BASELINE_ROLLOUTS_PER_S, 4)
    assert {out["metric"], one["metric"]} == metrics


def test_plant_choices_match_bench(bench):
    tree = _jax_bench()
    want = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--plant"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("choices", "default")}
            want = (tuple(kw["choices"]), kw["default"])
    action = next(a for a in bench._parser()._actions
                  if "--plant" in a.option_strings)
    assert (tuple(action.choices), action.default) == want
    assert bench._parser().parse_args(["--plant", "full"]).plant == "full"
    with pytest.raises(SystemExit):
        bench._parser().parse_args(["--plant", "oracle"])


@pytest.mark.parametrize("plant,getter,budget", [
    ("planning", spec.get_planning_model, (2, 4)),
    ("full", spec.get_fast_plant_model, (4, 8))])
def test_scores_through_the_fused_route(small, monkeypatch, plant, getter,
                                        budget):
    """Each solve is one ``lane_batched_rollout_cost(engine_impl="fused")``
    on the plant's model and budget, with ``make_cost_fn(m)``, from
    ``make_state(m)``, command (0.2, 0), prev (0, 0, -0.5) x 4: the
    costs are the fused kernel's plain version on those inputs."""
    calls = []
    real = small.rollout.lane_batched_rollout_cost

    def spy(m, cfg, cost_fn, state, seqs, cmd, prev, **kw):
        costs = real(m, cfg, cost_fn, state, seqs, cmd, prev, **kw)
        if kw.get("engine_impl") == "fused":  # not the plain version's own
            calls.append((m, cfg, cost_fn, state, seqs, cmd, prev, kw,
                          costs))
        return costs

    monkeypatch.setattr(small.rollout, "lane_batched_rollout_cost", spy)
    before = dict(cuda_engine.launch_counts)
    small.run_bench(plant, 0, "cpu")
    assert cuda_engine.launch_counts == before  # no kernel on the CPU
    assert len(calls) == small.ITERS + 1
    m = getter()
    for i, (got_m, cfg, cost_fn, state, seqs, cmd, prev, kw,
            costs) in enumerate(calls):
        assert got_m is m
        assert (cfg.horizon, cfg.frame_skip) == (2, 5)
        assert kw == {"newton_iterations": budget[0],
                      "ls_iterations": budget[1], "engine_impl": "fused"}
        assert cost_fn._is_walking_stage_cost  # make_cost_fn(m), eps 0
        assert seqs.shape == (8, 2, m.nu) and seqs.dtype == torch.float32
        assert float(seqs.abs().max()) <= 1.0
        torch.testing.assert_close(state.qpos, torch.as_tensor(
            m.qpos0, dtype=torch.float32))
        assert float(state.qvel.abs().max()) == 0.0
        torch.testing.assert_close(
            cmd.velocity, torch.tensor([0.2, 0.0, 0.0]))
        torch.testing.assert_close(prev, torch.tensor([0.0, 0.0, -0.5] * 4))
        if i in (0, small.ITERS):  # a timed solve and the warm-up
            want = cuda_engine.fused_rollout_cost_reference(
                m, state, seqs, cmd, prev, 5, *budget)
            torch.testing.assert_close(costs, want, rtol=0, atol=0)
    # each solve on its own control batch
    for a, b in zip(calls, calls[1:]):
        assert not torch.equal(a[4], b[4])


def test_failure_raises(small, monkeypatch, capsys):
    """No fail-soft line: an error in the solve, non-finite costs and a
    missing card each raise, and nothing is printed."""
    def broken(*a, **kw):
        raise RuntimeError("kernel refused")

    monkeypatch.setattr(small.rollout, "lane_batched_rollout_cost", broken)
    with pytest.raises(RuntimeError, match="kernel refused"):
        small.main(["--cpu", "--plant", "planning"])
    monkeypatch.setattr(small.rollout, "lane_batched_rollout_cost",
                        lambda *a, **kw: torch.full((8,), float("nan")))
    with pytest.raises(RuntimeError, match="non-finite"):
        small.main(["--cpu", "--plant", "full"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        small.main([])
    assert capsys.readouterr().out == ""
