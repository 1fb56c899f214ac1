"""A committed config from an empty workdir, on the CPU.

  * The expert data-identity guard (``runners/expert.load_pretrained_expert``)
    on ``configs/gan_cheetah.yaml`` with a copy of the committed cheetah
    experts: the newest (run 1) records the fingerprint ``8923ef176f``, the
    config's is another, so both packages' loaders raise
    ``FileNotFoundError``; with ``load_id: 1`` both load, and the params are
    equal (bitwise). With that guard ``setup`` trains an expert, as JAX's
    does: on the config cut to a small store (60-step episodes, a gate of
    0, one expert epoch), it collects the store, saves expert run 2 with
    the store's fingerprint and serves the policy with it.
  * The slice as a whole: ``runners.gan.run`` on the tiny pendulum config
    of ``tests/test_end_to_end.py`` (fused epochs off, 4 episodes of 200
    steps, ``min_expert_reward`` 1, which they clear) in an empty
    ``tmp_path`` collects the store, trains and saves an expert and runs
    one epoch; then JAX's ``load_pretrained_expert`` and
    ``load_trajectories`` read what the port wrote (the same params and
    arrays, bitwise), and a second ``setup`` in the workdir reads both
    without collecting or training.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.data.trajectories import load_trajectories as jax_load_trajectories
from gan_mpc_tpu.runners.expert import load_pretrained_expert as jax_load_expert
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data.trajectories import load_trajectories
from gan_mpc_tpu_torch.params import expert_to_jax_params
from gan_mpc_tpu_torch.runners import common, gan
from gan_mpc_tpu_torch.runners import expert as expert_runner
from test_end_to_end import TINY_OVERRIDES
from test_torch_pendulum import REPO
from test_torch_run_l2 import assert_params_equal

torch.set_num_threads(1)

CHEETAH = str(REPO / "configs" / "gan_cheetah.yaml")
CHEETAH_EXPERTS = REPO / "runs" / "trained_models" / "expert" / "cheetah_run"


@pytest.fixture
def cheetah_workdir(tmp_path):
    shutil.copytree(CHEETAH_EXPERTS, tmp_path / "trained_models" / "expert" / "cheetah_run")
    return str(tmp_path)


def test_stale_cheetah_expert_is_refused_and_load_id_overrides(cheetah_workdir):
    cfg = Config.from_yaml(CHEETAH).replace(runtime__workdir=cheetah_workdir)
    jcfg = JaxConfig.from_yaml(CHEETAH).replace(runtime__workdir=cheetah_workdir)
    saved = expert_runner.io.load_json(os.path.join(cheetah_workdir, "trained_models",
                                                    "expert", "cheetah_run", "1", "config.json"))
    assert saved["collection_fingerprint"] != common.collection_fingerprint(cfg)
    with pytest.raises(FileNotFoundError, match="fingerprint"):
        expert_runner.load_pretrained_expert(cfg, 17, 6, "cpu")
    with pytest.raises(FileNotFoundError, match="fingerprint"):
        jax_load_expert(jcfg, 17, 6)
    model = expert_runner.load_pretrained_expert(
        cfg.replace(mpc__model__expert__load_id=1), 17, 6, "cpu")
    _, jparams = jax_load_expert(jcfg.replace(mpc__model__expert__load_id=1), 17, 6)
    assert_params_equal(expert_to_jax_params(model), jax.device_get(jparams))


def test_setup_trains_an_expert_where_the_saved_one_is_stale(cheetah_workdir):
    cfg = Config.from_yaml(CHEETAH).replace(
        runtime__workdir=cheetah_workdir,
        env__expert_episode_steps=60, mpc__train__trajectory_len=40,
        mpc__train__min_expert_reward=0.0, expert_prediction__train__num_epochs=1,
        mpc__evaluate__max_interactions=5)
    ctx = common.setup(cfg, with_critic=True, device="cpu")
    run_dir = os.path.join(common.expert_model_dir(cfg), "2")
    stamp = expert_runner.io.load_json(os.path.join(run_dir, "config.json"))
    assert stamp["collection_fingerprint"] == common.collection_fingerprint(cfg)
    assert os.path.exists(common.trajectories_path(cfg))
    saved = expert_runner.load_pretrained_expert(cfg, 17, 6, "cpu")
    assert_params_equal(expert_to_jax_params(ctx["policy"].expert_model),
                        expert_to_jax_params(saved))


def test_gan_run_from_an_empty_workdir(tmp_path, monkeypatch):
    overrides = dict(runtime__workdir=str(tmp_path), env__expert_episode_steps=200,
                     mpc__evaluate__max_interactions=15)
    cfg = Config.from_yaml_str(TINY_OVERRIDES).replace(**overrides)
    jcfg = JaxConfig.from_yaml_str(TINY_OVERRIDES).replace(**overrides)
    assert not cfg.get_path("runtime.fused_epochs", False)
    logs = []
    out = gan.run(cfg, log_fn=logs.append, device="cpu")
    assert any(m.startswith("[gan] epoch 1 ") for m in logs)
    assert os.path.exists(os.path.join(out["run_dir"], "params.msgpack"))

    path = common.trajectories_path(cfg)
    assert os.path.basename(path) == f"trajectories-{common.collection_fingerprint(cfg)}.gmts"
    gate = dict(num_trajectories=3, trajectory_len=60, min_reward=1.0)
    got, want = load_trajectories(path, **gate), jax_load_trajectories(path, **gate)
    for name in ("states", "actions", "rewards", "executed_actions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))

    expert_dir = os.path.join(common.expert_model_dir(cfg), "0")
    stamp = expert_runner.io.load_json(os.path.join(expert_dir, "config.json"))
    assert sorted(stamp) == ["avg_reward", "collection_fingerprint", "env", "loss", "model",
                             "train"]
    assert np.isfinite(stamp["loss"]["train_loss"]) and np.isfinite(stamp["loss"]["test_loss"])
    _, jparams = jax_load_expert(jcfg, 3, 1)  # the guard passes: the same fingerprint
    saved = expert_runner.load_pretrained_expert(cfg, 3, 1, "cpu")
    assert_params_equal(expert_to_jax_params(saved), jax.device_get(jparams))
    assert_params_equal(out["params"]["expert_params"], jax.device_get(jparams))

    def refuse(*args, **kwargs):
        raise AssertionError("collected or trained again")

    monkeypatch.setattr(common, "collect_expert_trajectories", refuse)
    monkeypatch.setattr(expert_runner, "run", refuse)
    ctx = common.setup(cfg, with_critic=True, device="cpu")
    assert_params_equal(expert_to_jax_params(ctx["policy"].expert_model),
                        jax.device_get(jparams))
