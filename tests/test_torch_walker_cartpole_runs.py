"""``configs/gan_walker.yaml`` and ``configs/l2_cartpole_quality.yaml`` run
in the port from an empty workdir, on the CPU, with dm_control
unimportable (as on the card's host, where the JAX runner skips the
dm_control cross-evaluation and the port's ``check_supported`` accepts
the configs).

Each config is cut by ``TINY_CUTS`` (widths, horizon, history, DAgger's
settings other than its counts and the reward weighting kept): 4
collected expert episodes of 60 steps, one expert epoch, iLQR <= 2, the
walker's 2 fused epochs and one DAgger round with one extra epoch, the
cart-pole's one fused epoch, 10-step evaluations. The run collects the
fingerprinted store (the walker and cart-pole scripted experts), trains
and saves the expert, trains through the fused epochs, writes the fused
metrics rows (and DAgger's), keeps every history finite and saves a run
that JAX's ``io.load_params`` reads bitwise.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.runners.expert import load_pretrained_expert
from gan_mpc_tpu.utils import io as jio
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.runners import common, gan, l2
from test_torch_fused_run import DAGGER_ROW, FUSED_ROWS
from test_torch_pendulum import REPO
from test_torch_run_l2 import assert_params_equal

torch.set_num_threads(1)

_COMMON = dict(
    env__expert_episode_steps=60,  # of 1000
    env__collect_trajectories=4,  # of 12 (walker)
    mpc__train__num_trajectories=2,  # of 8 / 10
    mpc__train__trajectory_len=60,  # of 1000
    mpc__train__min_expert_reward=5.0,  # of 700 / 500 over 1000 steps
    mpc__solver__max_iterations=2,  # of 30 / 20
    mpc__train__dynamics__max_interactions_per_episode=10,  # of 300
    mpc__train__dynamics__num_updates=1,  # of 12 / 5
    mpc__train__dynamics__warm_start_updates=1,  # of 30 / 10
    mpc__train__dynamics__batch_size=16,  # of 128
    mpc__train__cost__num_updates=1,  # of 3
    mpc__train__cost__batch_size=4,  # of 128
    mpc__evaluate__max_interactions=10,  # of 1000
    mpc__evaluate__every_epochs=1,  # of 2 / 5
    mpc__evaluate__midrun_episodes=1,  # of 6 / 16
    mpc__evaluate__candidate_pool=1,  # of 4 / 6
    mpc__evaluate__selection_episodes=1,  # of 12 / 16
    mpc__evaluate__num_runs_for_avg=1,  # of 8
    mpc__evaluate__fresh_eval_episodes=1,  # of 16 (the default)
    expert_prediction__train__num_epochs=1,  # of 24 / 40
    expert_prediction__eval_runs=1,  # of 4 / 3
)
TINY_CUTS = {
    "gan_walker.yaml": dict(
        _COMMON,
        mpc__train__num_epochs=2,  # of 16
        mpc__train__critic__num_updates=1,  # of 2
        mpc__train__critic__batch_size=4,  # of 128
        runtime__num_parallel_envs=2,  # of 8
        expert_prediction__dagger__rounds=1,  # of 2
        expert_prediction__dagger__num_segments=4,  # of 256
        expert_prediction__dagger__segment_steps=12,  # of 200
        expert_prediction__dagger__policy_episodes=2,  # of 8
        expert_prediction__dagger__finetune_epochs=1,  # of 8
        expert_prediction__dagger__extra_epochs=1,  # of 8
    ),
    "l2_cartpole_quality.yaml": dict(_COMMON, mpc__train__num_epochs=1),  # of 10
}
FAMILY = {"gan_walker.yaml": "gan", "l2_cartpole_quality.yaml": "l2"}
SIZES = {"walker_walk": (17, 6), "cartpole_balance": (5, 1)}
RUNS = {"gan": gan, "l2": l2}


@pytest.mark.parametrize("name", sorted(TINY_CUTS))
def test_config_runs_from_an_empty_workdir(name, tmp_path, monkeypatch):
    for mod in [m for m in sys.modules if m == "dm_control" or m.startswith("dm_control.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "dm_control", None)
    family = FAMILY[name]
    cfg = Config.from_yaml(str(REPO / "configs" / name)).replace(
        runtime__workdir=str(tmp_path), **TINY_CUTS[name])
    assert cfg.get_path("runtime.fused_epochs") and cfg.mpc.evaluate.dm_control_episodes > 0
    logs = []
    out = RUNS[family].run(cfg, log_fn=logs.append, device="cpu")

    assert os.path.exists(common.trajectories_path(cfg))  # collected by the scripted expert
    assert os.listdir(common.expert_model_dir(cfg)) == ["0"]  # the expert trained and saved
    epochs = [m for m in logs if m.startswith(f"[{family}/fused] epoch") and "return" in m]
    daggers = [m for m in logs if m.startswith("[gan/dagger] round 1")]
    assert len(epochs) == (3 if family == "gan" else 1)  # the walker's DAgger extra epoch
    assert len(daggers) == (1 if family == "gan" else 0)
    assert all(np.isfinite(v) for vs in out["history"].values() for v in vs)
    with open(os.path.join(str(tmp_path), "metrics", cfg.env.name, f"{family}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = {frozenset(r) - {"step", "time"} for r in rows}
    assert FUSED_ROWS[family] in keys
    assert (frozenset(DAGGER_ROW) in keys) == (family == "gan")
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "time"), r
    # JAX's loader reads the saved run bitwise, into its runner's template
    # (the saved expert's model from its own config.json)
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    x, u = SIZES[cfg.env.name]
    expert_model, expert_params = load_pretrained_expert(jcfg, x, u)
    template = jcommon.build_policy(jcfg, x, u, with_critic=family == "gan",
                                    expert_params=expert_params, expert_model=expert_model)[1]
    restored = jio.load_params(template, os.path.join(out["run_dir"], "params.msgpack"))
    assert_params_equal(jax.device_get(restored), out["params"])
