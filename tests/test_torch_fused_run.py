"""The port's fused training runs end to end, on the CPU, at a tiny size.

The configs are ``tiny_config`` of ``test_torch_run_l2.py`` (cut from
``configs/{gan,l2}_pendulum.yaml``: H=3, iLQR <= 12, 30-step episodes,
the committed pendulum store and expert) with ``runtime.fused_epochs`` on,
2 epochs, and for the GAN run one DAgger round (2 policy episodes of 15
steps, 4 reward-weighted segments of 12 steps, 1 fine-tune epoch, 1
extra fused epoch):

  * ``runners.gan.run`` and ``runners.l2.run`` train through the fused
    epochs (the ``[gan/fused]`` / ``[l2/fused]`` lines, the DAgger line),
    write the metrics rows under the JAX runners' fused names (with
    ``dagger_round`` and ``dagger_test_loss``), keep every history finite,
    and save a run that JAX's ``io.load_params`` reads bitwise;
  * crashed after fused epoch 1 and resumed (checkpoints every epoch,
    periodic evaluation off: the checkpoint is taken before an epoch's
    evaluation, as in JAX), each run equals the uninterrupted one bitwise,
    params and histories, the DAgger round and its extra epoch included;
  * an L2 config without a critic section runs (the phase optimizers read
    the critic's only where the policy has one);
  * over the 17 committed configs: where each one stops in the port.
    ``check_supported`` refuses none, with dm_control importable (here,
    where the 9 that cross-evaluate in it do so) and unimportable (the
    card's host): all 17 run, the two ensemble configs
    ``humanoid_scale*.yaml`` among them;
  * an ensemble run's ``params.msgpack`` (``humanoid_scale.yaml``'s
    8-member ensemble at narrow widths, saved by ``utils/io.save_params``)
    reads back in JAX's ``io.load_params`` and the port's ``load_msgpack``
    with the stacked (E, ...) dynamics leaves, bitwise, and loads into a
    JAX policy built from the config as it loads into the port's.
"""

import glob
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.utils import io as jio
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.envs import dm_eval, make_env
from gan_mpc_tpu_torch.params import load_msgpack, to_jax_params
from gan_mpc_tpu_torch.runners import common, gan, l2
from test_torch_pendulum import REPO
from test_torch_run_gan import _jax_template
from test_torch_run_l2 import assert_params_equal, tiny_config

torch.set_num_threads(1)

DAGGER = {"rounds": 1, "num_segments": 4, "segment_steps": 12, "policy_episodes": 2,
          "finetune_epochs": 1, "extra_epochs": 1, "state_weighting": "reward_weighted"}
# the JAX runners' metrics rows: the fused epoch's (runners/gan.py:117-125,
# runners/l2.py:487-493), DAgger's (runners/gan.py:257)
FUSED_ROWS = {
    "gan": {"episode_return", "dynamics_train_loss", "critic_train_loss", "critic_test_loss",
            "generator_train_loss", "generator_test_loss"},
    "l2": {"episode_return", "dynamics_train_loss", "cost_train_loss", "cost_test_loss"},
}
DAGGER_ROW = {"dagger_round", "dagger_test_loss"}
RUNS = {"gan": gan, "l2": l2}


def fused_config(workdir, family, **overrides):
    extra = {"expert_prediction__dagger": DAGGER} if family == "gan" else {}
    return tiny_config(workdir, runtime__fused_epochs=True, mpc__train__num_epochs=2,
                       mpc__evaluate__fresh_eval_episodes=2, **{**extra, **overrides})


def metric_rows(cfg, family):
    with open(os.path.join(cfg.runtime.workdir, "metrics", "pendulum_swingup",
                           f"{family}.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_fused_run_trains_and_saves(tmp_path, family):
    cfg = fused_config(tmp_path, family, mpc__evaluate__every_epochs=1,
                       mpc__evaluate__midrun_episodes=1)
    logs = []
    out = RUNS[family].run(cfg, log_fn=logs.append, device="cpu")
    epochs = [m for m in logs if m.startswith(f"[{family}/fused] epoch") and "return" in m]
    daggers = [m for m in logs if m.startswith("[gan/dagger] round 1: 4 corrective segments")]
    assert len(epochs) == (3 if family == "gan" else 2)  # the GAN run's DAgger extra epoch
    assert len(daggers) == (1 if family == "gan" else 0)
    assert not any(m.startswith(f"[{family}] epoch") for m in logs)  # no modular epoch
    h = out["history"]
    assert all(len(v) == len(epochs) for v in h.values())
    assert all(np.isfinite(v) for vs in h.values() for v in vs)
    rows = metric_rows(cfg, family)
    keys = {frozenset(r) - {"step", "time"} for r in rows}
    assert FUSED_ROWS[family] in keys and frozenset({"eval_reward"}) in keys
    assert (frozenset(DAGGER_ROW) in keys) == (family == "gan")
    assert not any("epoch_seconds" in r for r in rows)  # JAX's fused loop times no epoch
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "time"), r
    # JAX's loader reads the saved run bitwise
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    restored = jio.load_params(_jax_template(jcfg, with_critic=family == "gan"),
                               os.path.join(out["run_dir"], "params.msgpack"))
    assert_params_equal(jax.device_get(restored), out["params"])


def test_l2_config_without_a_critic_section_runs(tmp_path):
    """An L2 config need not name the critic (``configs/l2_pendulum.yaml``
    does not): the run builds no critic optimizer."""
    d = fused_config(tmp_path, "l2").to_dict()
    del d["mpc"]["train"]["critic"]
    out = l2.run(Config.from_dict(d), log_fn=None, device="cpu")
    assert all(np.isfinite(v).all() for v in out["history"].values())


class Crash(RuntimeError):
    pass


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_fused_resume_equals_uninterrupted_run(tmp_path, family):
    ck = dict(runtime__checkpoint={"every_epochs": 1, "keep": 2})
    run = RUNS[family].run
    whole = run(fused_config(tmp_path / "whole", family, **ck), log_fn=None, device="cpu")
    cfg = fused_config(tmp_path / "crashed", family, **ck)

    def crash_after_epoch_1(msg):
        if msg.startswith(f"[{family}/fused] epoch 1 "):
            raise Crash(msg)

    with pytest.raises(Crash):
        run(cfg, log_fn=crash_after_epoch_1, device="cpu")
    assert l2.checkpointer_for(cfg, family).latest_step() == 1
    logs = []
    out = run(cfg, log_fn=logs.append, device="cpu")
    assert f"[{family}] resumed from checkpoint at epoch 1" in logs
    epochs = [m for m in logs if m.startswith(f"[{family}/fused] epoch")]
    assert epochs[0].startswith(f"[{family}/fused] epoch 2 ")  # epoch 1 is not trained again
    assert_params_equal(out["params"], whole["params"])
    for name, values in whole["history"].items():
        assert out["history"][name] == values[1:], name
    assert out["avg_reward"] == whole["avg_reward"]
    assert l2.checkpointer_for(cfg, family).latest_step() is None


# humanoid_scale.yaml's dynamics section, its 8 members of 3 hidden layers
# narrowed to 16 wide; and an LSTM dynamics section of 4 features
DYNAMICS = {
    "ensemble": {"use": "ensemble", "ensemble": {"num_members": 8, "mlp": {"hidden": [16] * 3}}},
    "lstm": {"use": "lstm", "lstm": {"features": 4, "hidden": [8]}},
}


@pytest.mark.parametrize("use", ["ensemble", "lstm"])
def test_run_with_ensemble_or_lstm_dynamics_saves_what_jax_loads(tmp_path, use):
    """A fused GAN run (1 epoch, no DAgger) trains the dynamics of ``use``
    from fresh weights; its ``params.msgpack`` reads back in JAX's
    ``io.load_params``, into the template JAX's ``build_policy`` makes of
    the config (for the ensemble its stacked (8, in, out) leaves), and in
    the port's ``load_msgpack``, bitwise equal to the run's params, and a
    run continued from it (``init_from_run``) starts from them."""
    cfg = tiny_config(tmp_path, runtime__fused_epochs=True, mpc__train__num_epochs=1,
                      mpc__evaluate__fresh_eval_episodes=2,
                      expert_prediction__dagger={"rounds": 0},
                      mpc__model__dynamics={**DYNAMICS[use], "mlp": {"hidden": [16]}})
    logs = []
    out = gan.run(cfg, log_fn=logs.append, device="cpu")
    assert any(m.startswith("[gan/fused] epoch 1 ") for m in logs)
    assert all(np.isfinite(v) for vs in out["history"].values() for v in vs)
    path = os.path.join(out["run_dir"], "params.msgpack")
    dyn = load_msgpack(path)["dynamics_params"]["params"]
    if use == "ensemble":
        assert {k: v["kernel"].shape for k, v in dyn.items()} == {
            "Dense_0": (8, 4, 16), "Dense_1": (8, 16, 16), "Dense_2": (8, 16, 16),
            "Dense_3": (8, 16, 3)}
        members = [m.net.layers[0].kernel for m in out["policy"].dynamics_model.members]
        assert not any(torch.equal(members[0], w) for w in members[1:])  # drawn one by one
    else:
        assert "OptimizedLSTMCell_0" in dyn
    assert_params_equal(load_msgpack(path), out["params"])
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    restored = jio.load_params(_jax_template(jcfg, with_critic=True), path)
    assert_params_equal(jax.device_get(restored), out["params"])
    cont = common.setup(cfg.replace(mpc__train__init_from_run=out["run_dir"]), True,
                        device="cpu")
    assert_params_equal(to_jax_params(cont["policy"]), out["params"])


# where each committed config stops in the port, with dm_control or
# without it (the card's host): None runs; else check_supported's refusal,
# which names the ROADMAP Queue 1 item it waits on (none is left there)
STOPS = {
    "gan_cheetah.yaml": None,
    "gan_cheetah_quality.yaml": None,
    "gan_humanoid_walk.yaml": None,
    "gan_humanoid_walk_continue.yaml": None,
    "gan_humanoid_walk_continue2.yaml": None,
    "gan_pendulum.yaml": None,
    "gan_pendulum_continue.yaml": None,
    "gan_pendulum_quality.yaml": None,
    "gan_pendulum_rung4.yaml": None,
    "gan_pendulum_rung5.yaml": None,
    "gan_pendulum_rung5b.yaml": None,
    "gan_walker.yaml": None,
    "humanoid_scale.yaml": None,
    "humanoid_scale_continue.yaml": None,
    "l2_cartpole_quality.yaml": None,
    "l2_pendulum.yaml": None,
    "l2_pendulum_quality.yaml": None,
}
# the configs that cross-evaluate in dm_control where it imports (here)
CROSS_EVALUATED = {"gan_cheetah_quality.yaml", "gan_pendulum_continue.yaml",
                   "gan_pendulum_quality.yaml", "gan_pendulum_rung4.yaml",
                   "gan_pendulum_rung5.yaml", "gan_pendulum_rung5b.yaml", "gan_walker.yaml",
                   "l2_cartpole_quality.yaml", "l2_pendulum_quality.yaml"}


def stop_of(config: Config):
    """Where the port refuses ``config``: ``check_supported`` (the steps a
    run takes before any work), else None once its env and dynamics build
    (every committed config's env and dynamics are ported)."""
    try:
        common.check_supported(config)
    except NotImplementedError as e:
        assert "ROADMAP Queue 1" in str(e)
        return str(e)
    make_env(config.env.name, "cpu")
    common.build_dynamics_model(config, 3, 1)
    return None


def committed_configs():
    return {os.path.basename(p): Config.from_yaml(p)
            for p in sorted(glob.glob(str(REPO / "configs" / "*.yaml")))}


def test_where_each_committed_config_stops(monkeypatch):
    configs = committed_configs()
    assert sorted(configs) == sorted(STOPS)
    fused = [n for n, c in configs.items() if c.get_path("runtime.fused_epochs", False)]
    dagger = [n for n, c in configs.items()
              if c.get_path("expert_prediction.dagger.rounds", 0) > 0]
    assert len(fused) == 16 and len(dagger) == 10
    # dm_control imports here: the 9 configs that cross-evaluate in it run too
    assert dm_eval.dm_control_available()
    assert sorted(n for n, c in configs.items()
                  if c.get_path("mpc.evaluate.dm_control_episodes", 0) > 0) == sorted(
        CROSS_EVALUATED)
    assert {name: stop_of(cfg) for name, cfg in configs.items()} == STOPS
    assert sorted(n for n, c in configs.items() if stop_of(c) is None) == sorted(STOPS)
    # without dm_control (the card's host) check_supported refuses none: all
    # 17 configs run, the ensemble ones included
    for name in [m for m in sys.modules if m == "dm_control" or m.startswith("dm_control.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "dm_control", None)
    assert {name: stop_of(cfg) for name, cfg in configs.items()} == STOPS
    assert list(STOPS.values()) == [None] * 17
    # nor does it name the dynamics or the video at all any more
    for use in ("mlp", "lstm", "ensemble"):
        common.check_supported(configs["humanoid_scale.yaml"].replace(
            mpc__model__dynamics__use=use))
    common.check_supported(configs["l2_pendulum.yaml"].replace(mpc__evaluate__save_video=True))
