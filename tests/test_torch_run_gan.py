"""The port's GAN training run against the JAX runner, on the CPU.

  * ``runners.gan.run`` on the tiny config of ``test_torch_run_l2.py``
    with periodic evaluation, selection and gain calibration (4 raw
    weights and a configured gain: 5 saved): the files, ``config.json``
    keys and loss sections of a run the JAX runner saved (gan/9), the JAX
    runner's metrics-row keys, params that JAX's ``io.load_params`` and
    the port's ``setup(init_from_run=...)`` both load bitwise;
  * crashed after epoch 1 and resumed: bitwise equal to the uninterrupted
    run, the resume logged, the checkpoints cleared;
  * (slow: the JAX run alone takes over a minute here) both packages'
    ``runners.gan.run`` on the same tiny config: the same files, the same
    ``config.json`` keys and equal ``seed`` / ``env`` / ``policy`` /
    ``expert_prediction`` sections, the same metrics-row keys, and each
    package's ``params.msgpack`` loads into the other.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.runners.expert import load_pretrained_expert
from gan_mpc_tpu.utils import io as jio
from gan_mpc_tpu.utils.metrics import solver_stats as jax_solver_stats
from gan_mpc_tpu_torch.params import to_jax_params
from gan_mpc_tpu_torch.runners import common, gan, l2
from test_torch_pendulum import G9, REPO
from test_torch_run_l2 import assert_params_equal, resumed_run, tiny_config

torch.set_num_threads(1)

GAN_FILES = set(os.listdir(REPO / G9))


JAX_ROW_KEYS = {
    frozenset({"step", "time", "epoch_seconds"}),
    frozenset({"step", "time", "episode_return", "dynamics_train_loss", "critic_train_loss",
               "generator_train_loss"}),
    frozenset({"step", "time", "eval_reward"}),
}


def _row_keys(workdir, family):
    with open(os.path.join(workdir, "metrics", "pendulum_swingup", f"{family}.jsonl")) as f:
        return {frozenset(json.loads(line)) for line in f}


def _jax_template(jcfg, with_critic=True):
    """The JAX runner's params template for ``jcfg``: the saved expert's
    model from its own config.json, as its setup builds it."""
    expert_model, expert_params = load_pretrained_expert(jcfg, 3, 1)
    return jcommon.build_policy(jcfg, 3, 1, with_critic=with_critic, expert_params=expert_params,
                                expert_model=expert_model)[1]


def test_gan_run_saves_what_the_jax_runner_saves(tmp_path):
    cfg = tiny_config(
        tmp_path,
        mpc__evaluate={"max_interactions": 15, "num_runs_for_avg": 1, "every_epochs": 1,
                       "midrun_episodes": 1, "candidate_pool": 2, "selection_episodes": 1,
                       "fresh_eval_episodes": 2},
        mpc__model__cost__weights={"action": -2.0, "state": 3.0, "terminal": -3.0,
                                   "action_goal": 0.5, "action_goal_gain": 1.0},
        mpc__model__cost__calibrate_action_goal_gain=True,
        mpc__model__cost__gain_grid=[1.0, 1.2])
    logs = []
    out = gan.run(cfg, log_fn=logs.append, device="cpu")
    assert set(os.listdir(out["run_dir"])) == GAN_FILES
    with open(REPO / G9 / "config.json") as f:
        ref = json.load(f)
    stamp = l2.io.load_json(os.path.join(out["run_dir"], "config.json"))
    assert sorted(stamp) == sorted(ref) and sorted(stamp["loss"]) == sorted(ref["loss"])
    assert sorted(stamp["fresh_eval"]) == sorted(ref["fresh_eval"])
    sol_keys = set(jax_solver_stats(type("S", (), dict(
        iterations=jnp.ones(2), converged=jnp.ones(2, bool), obj=jnp.ones(2)))))
    assert _row_keys(cfg.runtime.workdir, "gan") == JAX_ROW_KEYS | {
        frozenset({"step", "time"} | sol_keys)}
    assert sum("eval_reward" in m for m in logs) == 1
    assert any(m.startswith("[select] honest re-rank") for m in logs)
    assert any(m.startswith("[calibrate] selected action_goal_gain") for m in logs)
    h = out["history"]
    assert all(np.isfinite(v) for vs in h.values() for v in vs)
    assert len(h["critic_train_losses"]) == 1 and out["params"]["mpc_weights"].shape == (5,)
    # JAX's loader and the port's read the saved run bitwise
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    restored = jio.load_params(_jax_template(jcfg), os.path.join(out["run_dir"],
                                                                 "params.msgpack"))
    assert_params_equal(jax.device_get(restored), out["params"])
    ctx = common.setup(cfg.replace(mpc__train__init_from_run=out["run_dir"]), True,
                       device="cpu")
    assert_params_equal(to_jax_params(ctx["policy"]), out["params"])


def test_gan_resume_equals_uninterrupted_run(tmp_path):
    ck = dict(runtime__checkpoint={"every_epochs": 1, "keep": 2}, mpc__train__num_epochs=2,
              mpc__evaluate__fresh_eval_episodes=2)
    whole = gan.run(tiny_config(tmp_path / "whole", **ck), log_fn=None, device="cpu")
    cfg = tiny_config(tmp_path / "crashed", **ck)
    out, logs = resumed_run(gan, "gan", cfg)
    assert "[gan] resumed from checkpoint at epoch 1" in logs
    assert sum(m.startswith("[gan] epoch") for m in logs) == 1
    assert_params_equal(out["params"], whole["params"])
    assert out["history"]["critic_train_losses"] == whole["history"]["critic_train_losses"][1:]
    assert l2.checkpointer_for(cfg, "gan").latest_step() is None


@pytest.mark.slow
def test_gan_run_matches_the_jax_run(tmp_path):
    from gan_mpc_tpu.runners import gan as jgan

    cfg = tiny_config(tmp_path / "port", mpc__evaluate__fresh_eval_episodes=2)
    jcfg = JaxConfig.from_dict(tiny_config(tmp_path / "jax",
                                           mpc__evaluate__fresh_eval_episodes=2).to_dict())
    out = gan.run(cfg, log_fn=None, device="cpu")
    jout = jgan.run(jcfg, log_fn=None)
    assert set(os.listdir(out["run_dir"])) == set(os.listdir(jout["run_dir"])) == GAN_FILES
    stamp = l2.io.load_json(os.path.join(out["run_dir"], "config.json"))
    jstamp = jio.load_json(os.path.join(jout["run_dir"], "config.json"))
    assert sorted(stamp) == sorted(jstamp)
    assert sorted(stamp["loss"]) == sorted(jstamp["loss"])
    for key in ("policy", "expert_prediction", "seed"):
        assert stamp[key] == jstamp[key], key
    env = dict(stamp["env"])
    jenv = dict(jstamp["env"])
    assert env.pop("trajectories_path") == jenv.pop("trajectories_path")
    assert env == jenv
    assert _row_keys(cfg.runtime.workdir, "gan") == _row_keys(jcfg.runtime.workdir, "gan")
    # each package's params.msgpack loads into the other
    restored = jio.load_params(jax.device_get(jout["params"]),
                               os.path.join(out["run_dir"], "params.msgpack"))
    assert_params_equal(jax.device_get(restored), out["params"])
    ctx = common.setup(cfg.replace(mpc__train__init_from_run=jout["run_dir"]), True,
                       device="cpu")
    assert_params_equal(to_jax_params(ctx["policy"]), jax.device_get(jout["params"]))
