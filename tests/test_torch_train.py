"""The trainer, its checkpoints, its reward CSV, plots and dashboard, on
the CPU.

``runtime/checkpoint.py`` round-trips a train state bit for bit (the
generator's state and Adam's step included) and reads what the JAX
package's ``checkpoint.save`` wrote; ``utils/metrics.py`` writes the JAX
logger's bytes, ``utils/plot.py`` the JAX overview's and
``utils/server.py`` serves what the JAX dashboard serves; ``rl/train.
main`` trains 4 envs x 4 steps for 2 iterations, resumes at iteration 2
exactly where an uninterrupted run would be, runs its per-iteration eval,
plots and dashboard, and runs ``--distributed`` as a group of one."""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.rl import networks as jnet
from quadruped_gym_tpu.runtime import checkpoint as jcheckpoint
from quadruped_gym_tpu.utils import metrics as jmetrics
from quadruped_gym_tpu.utils import plot as jplot
from quadruped_gym_tpu.utils import server as jserver
from quadruped_gym_tpu_torch import convert, native
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.rl import networks as tnet
from quadruped_gym_tpu_torch.rl import ppo as tppo
from quadruped_gym_tpu_torch.rl import train
from quadruped_gym_tpu_torch.runtime import checkpoint
from quadruped_gym_tpu_torch.tasks import walking as twalk
from quadruped_gym_tpu_torch.utils import metrics, plot, server

TM = tspec.get_mpc_plant_model()
SMALL = ["--num-envs", "4", "--num-steps", "4",
         "--timesteps-per-iteration", "16", "--frame-skip", "2",
         "--max-contacts", "8", "--solver-iterations", "3", "--no-eval"]


def _small_state(seed, hidden=(8,)):
    env = twalk.WalkingConfig(frame_skip=1, partial_obs=True, obs_window=2,
                              max_contacts=4, solver_iterations=2,
                              random_controls=True, dtype=torch.float64)
    cfg = tppo.PPOConfig(num_envs=2, num_steps=2, epochs=1,
                         num_minibatches=1, hidden=hidden)
    return env, cfg, tppo.init_train_state(TM, env, cfg, seed, device="cpu")


def _leaves(ts):
    return list(checkpoint._leaves(ts))


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    env, cfg, ts = _small_state(0)
    ts, _ = tppo.update_fn(TM, env, cfg)(ts)  # Adam step 1, moved envs
    checkpoint.save(str(tmp_path), ts, step=7)
    assert checkpoint.exists(str(tmp_path))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta == {"num_leaves": len(_leaves(ts)), "step": 7}
    # documented order: the network's state_dict first, then Adam's
    # state of each parameter (exp_avg, exp_avg_sq, step), ...
    with np.load(tmp_path / "state.npz") as data:
        assert int(data["__step__"]) == 7
        first = next(iter(ts.net.state_dict().values()))
        np.testing.assert_array_equal(data["leaf_0"], first.numpy())
        n_net = len(ts.net.state_dict())
        np.testing.assert_array_equal(data[f"leaf_{n_net + 2}"], 1.0)
        # ... and update_idx last
        np.testing.assert_array_equal(data[f"leaf_{meta['num_leaves'] - 1}"],
                                      1)

    _, _, fresh = _small_state(1)
    got, step = checkpoint.restore(str(tmp_path), fresh)
    assert step == 7 and got.net is fresh.net and got.opt is fresh.opt
    assert float(got.opt.state[got.net.log_std]["step"]) == 1.0
    for a, b in zip(_leaves(got), _leaves(ts)):
        a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.env_state.rew.ctrl_cost_ref_set.dtype == torch.bool
    # the restored generator continues the saved one's stream
    torch.testing.assert_close(torch.rand(5, generator=got.generator),
                               torch.rand(5, generator=ts.generator),
                               rtol=0, atol=0)


def test_checkpoint_refuses_what_it_cannot_read(tmp_path):
    _, _, ts = _small_state(0)
    checkpoint.save(str(tmp_path / "a"), ts, step=1)
    _, _, wider = _small_state(0, hidden=(8, 8))
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore(str(tmp_path / "a"), wider)
    _, _, other = _small_state(0, hidden=(9,))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path / "a"), other)
    orbax = tmp_path / "orbax"
    (orbax / "3" / "d").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.read(str(orbax))


def test_reads_the_jax_packages_checkpoints(tmp_path):
    """A policy checkpoint and a train-state checkpoint written by the JAX
    package (whose leaves start with the params): the port reads both
    with ``checkpoint.read`` and ``convert.policy_params``."""
    jparams = jnet.init(jax.random.PRNGKey(2), jnet.NetConfig(52, 12,
                                                              (16, 24)))
    jcheckpoint.save(str(tmp_path / "policy"), jparams, step=5)
    tree = (jparams, {"count": jnp.zeros((), jnp.int32)},
            jnp.ones((3, 52)), jnp.asarray(4))
    jcheckpoint.save(str(tmp_path / "train"), tree, step=9)
    for name, want_step in (("policy", 5), ("train", 9)):
        arrays, step = checkpoint.read(str(tmp_path / name))
        assert step == want_step
        net = convert.policy_params(arrays, dtype=torch.float32,
                                    device="cpu")
        assert net.cfg == tnet.NetConfig(52, 12, (16, 24))
        for t, a in convert._policy_pairs(net, jparams):
            np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a))
    # and the JAX package reads what the port wrote in its layout
    checkpoint.save(str(tmp_path / "port"), [np.arange(3.0)], step=2)
    back, step = jcheckpoint.restore(str(tmp_path / "port"),
                                     [jnp.zeros(3)])
    assert step == 2
    np.testing.assert_array_equal(np.asarray(back[0]), np.arange(3.0))


def test_reward_csv_matches_the_jax_logger(tmp_path):
    rows = np.random.default_rng(0).standard_normal((5, 11))
    for mod, name in ((jmetrics, "jax.csv"), (metrics, "port.csv")):
        log = mod.RewardCSVLogger(str(tmp_path / name))
        log.log_many(3, rows[:2])
        log.close()
        log = mod.RewardCSVLogger(str(tmp_path / name))  # appends
        log.log_many(5, rows[2:])
        log.close()
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    steps, totals, comp, keys = metrics.read_reward_csv(
        str(tmp_path / "port.csv"))
    np.testing.assert_array_equal(steps, np.arange(3, 8))
    np.testing.assert_allclose(comp, rows, rtol=1e-15)
    np.testing.assert_allclose(totals, rows.sum(axis=1), rtol=1e-15)
    assert keys == metrics.REWARD_KEYS


def _csv(out):
    return metrics.read_reward_csv(os.path.join(out, "rewards_continuous.csv"))


def test_train_main_resumes_where_it_stopped(tmp_path, capsys):
    """2 iterations, then a resume for 1 more: 4 CSV rows an update,
    ``__step__`` after each call, and the resumed iteration equals the
    third of an uninterrupted run to the bit (network, Adam state, envs
    and generator all came back). Then a fine-tune iteration."""
    out = str(tmp_path / "run")
    ts, hist = train.main(["--output", out, "--iterations", "2"] + SMALL,
                          device="cpu")
    assert [h.index for h in hist] == [0, 1] and int(ts.update_idx) == 2
    for h in hist:
        assert h.seconds > 0.0
        assert h.metrics.reward_components.shape == (1, 4, 11)
        assert all(bool(torch.isfinite(x).all()) for x in h.metrics)
    assert checkpoint.read(os.path.join(out, "policy"))[1] == 2
    steps, _, comp, _ = _csv(out)
    np.testing.assert_array_equal(steps, np.arange(8))
    # each component exactly as the trainer's writer printed it: the
    # native C++ logger's "%.10g" (native.make_reward_logger), or the
    # Python fallback's full repr where the library cannot be built
    want = hist[1].metrics.reward_components[0].double().numpy()
    if native.load() is not None:
        want = np.vectorize(lambda x: float("%.10g" % x))(want)
    np.testing.assert_array_equal(comp[4:], want)

    ts, _ = train.main(["--output", out, "--iterations", "1"] + SMALL,
                       device="cpu")
    printed = capsys.readouterr().out
    assert "resumed from" in printed and "at iteration 2" in printed
    assert "iter 2:" in printed and "iter 1:" not in printed.split(
        "resumed")[1]
    assert int(ts.update_idx) == 3
    assert checkpoint.read(os.path.join(out, "policy"))[1] == 3

    whole, _ = train.main(
        ["--output", str(tmp_path / "whole"), "--iterations", "3"] + SMALL,
        device="cpu")
    for a, b in zip(_leaves(ts), _leaves(whole)):
        assert torch.equal(torch.as_tensor(np.asarray(a)),
                           torch.as_tensor(np.asarray(b)))
    for a, b in zip(_csv(out), _csv(str(tmp_path / "whole"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ts, _ = train.main(["--output", out, "--iterations", "0",
                        "--finetune-iterations", "1"] + SMALL, device="cpu")
    printed = capsys.readouterr().out
    assert "iter 3:" in printed and "[finetune log_std<=-1.2]" in printed
    assert float(ts.net.log_std.detach().max()) <= -1.2
    assert checkpoint.read(os.path.join(out, "policy"))[1] == 4
    np.testing.assert_array_equal(_csv(out)[0], np.arange(16))


def test_train_refuses_what_is_not_ported(tmp_path):
    """``--distributed`` runs on the CPU (a group of this process alone,
    gone after the call); a data-parallel ``update_fn`` needs the mesh of
    its axis; and nothing runs on the CPU unless asked."""
    out = ["--output", str(tmp_path / "dist")]
    ts, its = train.main(out + ["--distributed", "--iterations", "1"]
                         + SMALL, device="cpu")
    assert not torch.distributed.is_initialized()
    assert [it.index for it in its] == [0]
    assert checkpoint.read(str(tmp_path / "dist" / "policy"))[1] == 1
    assert len(_csv(str(tmp_path / "dist"))[0]) == 4
    with pytest.raises(ValueError, match="needs the mesh"):
        tppo.update_fn(TM, twalk.WalkingConfig(), tppo.PPOConfig(),
                       axis_name="data")
    out = ["--output", str(tmp_path / "none")]
    if not torch.cuda.is_available():  # the card unless the caller says cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(out + ["--no-eval"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tppo.init_train_state(TM, twalk.WalkingConfig(),
                                  tppo.PPOConfig(num_envs=1), 0)
    assert not os.path.exists(tmp_path / "none")


# the keys of a line of the JAX trainer's eval_metrics.jsonl: its
# eval_rollout's metrics without "rewards", plus "iteration"
EVAL_KEYS = {"episode_return", "steps", "survived", "mean_tracking_error",
             "final_tracking_error", "mean_uprightness", "command_speed",
             "iteration"}


def _get(srv, path):
    host, port = srv.server_address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=30) as r:
        return r.read()


def test_train_main_evals_plots_and_serves(tmp_path, monkeypatch, capsys):
    """The trainer's default iteration: an eval episode (0.09 s at
    frame_skip 2: 23 steps on the full model), a video, the plots, and
    the dashboard (on a free port here) serving the run's CSV."""
    served, real = [], server.launch_dash

    def launch(csv_path, block=True):
        served.append(real(csv_path, port=0, block=block))
        return served[-1]

    monkeypatch.setattr(server, "launch_dash", launch)
    out = str(tmp_path / "run")
    small = [a for a in SMALL if a != "--no-eval"]
    ts, hist = train.main(["--output", out, "--iterations", "2",
                           "--max-time", "0.09", "--video-every", "2",
                           "--dashboard"] + small, device="cpu")
    try:
        assert len(served) == 1
        data = json.loads(_get(served[0], "/data"))
        steps, totals, comp, keys = _csv(out)
        assert data["keys"] == list(keys) and len(data["rows"]) == 8
        np.testing.assert_allclose(np.asarray(data["rows"])[:, 2:], comp,
                                   rtol=1e-15)
    finally:
        for srv in served:
            srv.shutdown()
            srv.server_close()
    printed = capsys.readouterr().out
    assert "dashboard on :8050" in printed
    assert printed.count("  eval: return") == 2
    with open(os.path.join(out, "logs", "eval_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == EVAL_KEYS
        assert r["steps"] == 23 and r["command_speed"] == 0.2
        assert np.isfinite(r["episode_return"])
    assert all(h.eval_seconds > 0 for h in hist)
    # a video at iteration 0 (every 2nd) and at the last, 1
    for it in (0, 1):
        assert os.path.getsize(os.path.join(out, "videos",
                                            f"run_{it}.mp4")) > 0
        for f in (f"reward_plot_{it}.png", f"reward_components_{it}.html"):
            assert os.path.getsize(os.path.join(out, "plots", f)) > 0


def test_dashboard_serves_what_the_jax_dashboard_serves(tmp_path):
    rows = np.random.default_rng(1).standard_normal((7, 11))
    csv_path = str(tmp_path / "rewards_continuous.csv")
    log = metrics.RewardCSVLogger(csv_path)
    log.log_many(0, rows)
    log.close()
    servers = [jserver.launch_dash(csv_path, port=0, block=False),
               server.launch_dash(csv_path, port=0, block=False)]
    try:
        (jdata, jpage), (tdata, tpage) = [
            (json.loads(_get(s, "/data")), _get(s, "/")) for s in servers]
        assert tdata == jdata and len(tdata["rows"]) == 7
        assert tpage == jpage
        os.remove(csv_path)
        assert json.loads(_get(servers[1], "/data")) == {"keys": [],
                                                         "rows": []}
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_plots_match_the_jax_plots(tmp_path):
    rng = np.random.default_rng(2)
    comp = rng.standard_normal((2500, 11))
    keys = list(metrics.REWARD_KEYS)
    for mod, name in ((jplot, "jax"), (plot, "port")):
        mod.plot_reward_components(comp, keys, str(tmp_path / f"{name}.html"))
    assert (tmp_path / "port.html").read_bytes() == \
        (tmp_path / "jax.html").read_bytes()
    np.testing.assert_array_equal(plot.moving_average(comp[:, 0], 7),
                                  jplot.moving_average(comp[:, 0], 7))
    assert plot.have_matplotlib()
    for fn, arg in ((plot.plot_data_line, 50), (plot.plot_data, 40)):
        path = str(tmp_path / f"{fn.__name__}.png")
        assert fn(comp[:, 0], arg, save_path=path) == path
        assert os.path.getsize(path) > 0
    path = str(tmp_path / "components.png")
    assert plot.plot_reward_components(comp[:300], keys, path) == path


def test_make_env_config_matches_the_jax_trainer():
    # importing the JAX trainer points JAX's compilation cache at its own
    # directory: put the suite's back
    keep = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keep}
    try:
        from quadruped_gym_tpu.rl import train as jtrain
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    for argv in ([], ["--min-speed", "0.1"], ["--full-obs",
                                              "--frame-skip", "4"]):
        args = train._parser().parse_args(argv + ["--no-eval"])
        got = train.make_env_config(args)
        want = jtrain.make_env_config(args)
        for f in ("max_time", "frame_skip", "obs_window", "partial_obs",
                  "random_controls", "max_contacts", "solver_iterations"):
            assert getattr(got, f) == getattr(want, f), f
        np.testing.assert_array_equal(np.asarray(got.reset_options),
                                      np.asarray(want.reset_options))
    assert got.dtype == torch.float32
