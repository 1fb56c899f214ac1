"""The port's L2 training run end to end, on the CPU, at a tiny size.

The config is ``TINY_OVERRIDES`` of ``tests/test_end_to_end.py`` (H=3,
iLQR <= 12, 30-step training episodes, 15-step evaluation
episodes, 1-2 epochs) reading the committed pendulum
store through ``env.trajectories_path``, with the committed pendulum
expert run copied into a temporary workdir (nothing is written under the
repo's ``runs/``):

  * ``runners.l2.run`` completes and saves the JAX runner's files; a
    second run with the same seed gives bitwise equal params and an equal
    ``config.json`` (the JAX ``test_l2_deterministic_given_seed``);
  * crashed after epoch 1 and resumed, the run's final params are bitwise
    equal to an uninterrupted 2-epoch run's, its logs show the resume and
    its checkpoints are cleared at the end (the JAX
    ``test_l2_checkpoint_resume``, with periodic evaluation off: the
    checkpoint is taken before an epoch's evaluation, as in JAX);
  * the setting whose path is not ported (data parallel) raises
    ``NotImplementedError`` before the run does any work; the fused epochs
    run, DAgger rounds leave the L2 and the modular GAN runs as they are,
    as in JAX, the video is written at the end of the run and the
    dm_control cross-evaluation (here, where dm_control imports) stamps
    its one episode into ``config.json``;
  * ``dm_cross_eval`` gives None with 0 episodes, for an env without a
    suite task and where dm_control does not import.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.runners import common, l2
from test_end_to_end import TINY_OVERRIDES
from test_torch_pendulum import REPO, STORE

torch.set_num_threads(1)

EXPERT = "runs/trained_models/expert/pendulum_swingup/0"
RUN_FILES = {"config.json", "params.msgpack", "dynamics_train_losses.json",
             "cost_train_losses.json", "cost_test_losses.json", "episode_returns.json"}


def tiny_config(workdir, **overrides) -> Config:
    """The tiny config on the committed store, evaluation episodes cut to 15
    steps, its workdir holding a copy of the committed pendulum expert
    run."""
    expert = os.path.join(workdir, "trained_models", "expert", "pendulum_swingup", "0")
    if not os.path.exists(expert):
        shutil.copytree(REPO / EXPERT, expert)
    overrides = {"mpc__evaluate__max_interactions": 15, **overrides}
    return Config.from_yaml_str(TINY_OVERRIDES).replace(
        runtime__workdir=str(workdir), env__trajectories_path=str(REPO / STORE), **overrides)


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def assert_params_equal(a, b):
    a, b = dict(leaves(a)), dict(leaves(b))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class Crash(RuntimeError):
    pass


def resumed_run(module, tag, cfg):
    """Run ``cfg`` crashing on the ``[tag] epoch 1`` line (the epoch-1
    checkpoint is saved before it), then again. Returns (result, logs)."""
    def crash_after_epoch_1(msg):
        if msg.startswith(f"[{tag}] epoch 1 "):
            raise Crash(msg)

    with pytest.raises(Crash):
        module.run(cfg, log_fn=crash_after_epoch_1, device="cpu")
    ckpt = l2.checkpointer_for(cfg, tag)
    assert ckpt.latest_step() == 1
    logs = []
    return module.run(cfg, log_fn=logs.append, device="cpu"), logs


def test_l2_run_saves_and_is_deterministic(tmp_path):
    cfg = tiny_config(tmp_path)
    a = l2.run(cfg, log_fn=None, device="cpu")
    b = l2.run(cfg, log_fn=None, device="cpu")
    assert set(os.listdir(a["run_dir"])) == RUN_FILES
    assert a["run_dir"] != b["run_dir"]
    assert_params_equal(a["params"], b["params"])
    with open(os.path.join(a["run_dir"], "config.json")) as f, \
            open(os.path.join(b["run_dir"], "config.json")) as g:
        assert f.read() == g.read()
    h = a["history"]
    assert len(h["cost_train_losses"]) == 1 and len(h["dynamics_train_losses"]) == 4
    assert all(np.isfinite(v) for vs in h.values() for v in vs)
    stamp = l2.io.load_json(os.path.join(a["run_dir"], "config.json"))
    fe = stamp["fresh_eval"]
    assert fe["num_episodes"] == 16 and fe["episodes"] == sorted(fe["episodes"])
    assert fe["mean"] == pytest.approx(sum(fe["episodes"]) / 16, abs=0.1)
    # the saved run loads back into the port bitwise
    ctx = common.setup(cfg.replace(mpc__train__init_from_run=a["run_dir"]), False, device="cpu")
    assert_params_equal(l2.to_jax_params(ctx["policy"]), a["params"])


def test_l2_resume_equals_uninterrupted_run(tmp_path):
    ck = dict(runtime__checkpoint={"every_epochs": 1, "keep": 2}, mpc__train__num_epochs=2,
              mpc__evaluate__fresh_eval_episodes=2)
    whole = l2.run(tiny_config(tmp_path / "whole", **ck), log_fn=None, device="cpu")
    cfg = tiny_config(tmp_path / "crashed", **ck)
    out, logs = resumed_run(l2, "l2", cfg)
    assert "[l2] resumed from checkpoint at epoch 1" in logs
    assert sum(m.startswith("[l2] epoch") for m in logs) == 1  # only epoch 2 trained
    assert_params_equal(out["params"], whole["params"])
    assert out["history"]["cost_train_losses"] == whole["history"]["cost_train_losses"][1:]
    assert out["avg_reward"] == whole["avg_reward"]
    ckpt = l2.checkpointer_for(cfg, "l2")
    assert ckpt.latest_step() is None
    assert os.listdir(os.path.join(cfg.runtime.workdir, "checkpoints", "pendulum_swingup",
                                   "l2")) == []


@pytest.mark.parametrize("override", [
    {"runtime__data_parallel_devices": 2},
], ids=["data_parallel"])
@pytest.mark.parametrize("family", ["l2", "gan"])
def test_unported_settings_raise(tmp_path, override, family):
    from gan_mpc_tpu_torch.runners import gan

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        {"l2": l2, "gan": gan}[family].run(tiny_config(tmp_path, **override), log_fn=None,
                                           device="cpu")
    assert not os.path.exists(os.path.join(tmp_path, "metrics"))


DAGGER = {"rounds": 1, "num_segments": 4, "segment_steps": 12, "policy_episodes": 2,
          "finetune_epochs": 1, "extra_epochs": 1}


@pytest.mark.parametrize("setting", ["fused_epochs", "dagger", "video", "dm_control"])
@pytest.mark.parametrize("family", ["l2", "gan"])
def test_settings_that_now_run(tmp_path, setting, family):
    """The fused epochs run, through the fused loop; DAgger rounds are left
    alone by the L2 run and the modular GAN run, which train as without
    them (JAX runs DAgger in the GAN run's fused branch only);
    ``save_video`` writes the video of 15 steps into the run (a GIF where
    imageio has no ffmpeg, as here); ``dm_control_episodes`` (dm_control
    imports here) stamps the cross-evaluation's one episode, JAX's dict,
    and logs JAX's ``[dm_control]`` line."""
    from gan_mpc_tpu_torch.runners import gan

    run = {"l2": l2, "gan": gan}[family].run
    cut = dict(mpc__evaluate__fresh_eval_episodes=2)
    logs = []
    if setting == "video":
        out = run(tiny_config(tmp_path, mpc__evaluate__save_video=True, **cut), log_fn=None,
                  device="cpu")
        written = [f for f in os.listdir(out["run_dir"]) if f.startswith("video.")]
        assert written in (["video.mp4"], ["video.gif"])
        if written == ["video.gif"]:  # whose writer merges a frame equal to the one before
            from PIL import Image

            with Image.open(os.path.join(out["run_dir"], "video.gif")) as gif:
                assert 8 <= gif.n_frames <= 15 and gif.size == (320, 240)
        return
    if setting == "dm_control":
        out = run(tiny_config(tmp_path, mpc__evaluate__dm_control_episodes=1, **cut),
                  log_fn=logs.append, device="cpu")
        stamp = l2.io.load_json(os.path.join(out["run_dir"], "config.json"))["dm_control_reward"]
        assert sorted(stamp) == ["episodes", "mean"] and len(stamp["episodes"]) == 1
        assert stamp["mean"] == round(stamp["episodes"][0], 2)
        assert sum(m.startswith("[dm_control] pendulum_swingup mean ") and m.endswith(
            "over 1 eps: " + str([round(stamp["episodes"][0], 1)])) for m in logs) == 1
        return
    if setting == "fused_epochs":
        out = run(tiny_config(tmp_path, runtime__fused_epochs=True, **cut), log_fn=logs.append,
                  device="cpu")
        assert sum(m.startswith(f"[{family}/fused] epoch 1 return") for m in logs) == 1
        assert all(len(v) == 1 and np.isfinite(v).all() for v in out["history"].values())
        return
    plain = run(tiny_config(tmp_path / "plain", **cut), log_fn=None, device="cpu")
    out = run(tiny_config(tmp_path / "dagger", expert_prediction__dagger=DAGGER, **cut),
              log_fn=logs.append, device="cpu")
    assert not any(m.startswith("[gan/dagger]") for m in logs)
    assert_params_equal(out["params"], plain["params"])
    assert out["history"] == plain["history"]


def test_dm_cross_eval(tmp_path, monkeypatch):
    cfg = tiny_config(tmp_path)
    assert l2.dm_cross_eval(cfg, {}) is None  # 0 episodes
    on = cfg.replace(mpc__evaluate__dm_control_episodes=2)
    assert l2.dm_cross_eval(on.replace(env__imitator__name="humanoid_walk"), {}) is None
    for name in [m for m in sys.modules if m == "dm_control" or m.startswith("dm_control.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "dm_control", None)  # import fails
    assert l2.dm_cross_eval(on, {}) is None


@pytest.mark.parametrize("family", ["l2", "gan"])
def test_runs_default_to_the_card(tmp_path, family):
    """Called without a device, a run starts on the card; on a host without
    one it raises before any work rather than training on the CPU."""
    from gan_mpc_tpu_torch.runners import gan

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU-host behaviour is what is checked here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"l2": l2, "gan": gan}[family].run(tiny_config(tmp_path), log_fn=None)
    assert not os.path.exists(os.path.join(tmp_path, "metrics"))
