"""Expert predictor runner: train, evaluate, save and load the predictor.

Counterpart of ``gan_mpc_tpu/runners/expert.py``: read the expert store
(collecting it where missing), fit the normalizer, split the sequence
windows (the rest-start oversampling on the train side only), train the
autoregressive predictor, evaluate it closed loop in the imitator's env,
and save ``params.msgpack`` (flax's bytes) and ``config.json`` (JAX's
keys) under the next numbered run directory of
``<workdir>/trained_models/expert/<env>/``.

``load_pretrained_expert`` reads a saved predictor back, its model
rebuilt from the run's own ``config.json``, behind JAX's data-identity
guard: with no ``mpc.model.expert.load_id``, a newest run that records a
``collection_fingerprint`` other than the config's is stale (trained on
other expert data), and loading raises ``FileNotFoundError``, where the
runners' ``setup`` trains a new predictor. Older runs are not searched
for a match, as in JAX.

Random draws: a generator seeded with the config's seed gives the
initial weights (flax's initializers, ``params.init_flax_like``) and, one
child generator each (``training.common.split``), the split, the
minibatches and the evaluation's resets.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data.trajectories import TrajectorySet
from gan_mpc_tpu_torch.data.windows import split_sequence_windows
from gan_mpc_tpu_torch.envs.rollout import average_return
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import (
    expert_from_jax_params,
    expert_to_jax_params,
    init_flax_like,
    load_msgpack,
    save_msgpack,
)
from gan_mpc_tpu_torch.runners import common
from gan_mpc_tpu_torch.training.common import split
from gan_mpc_tpu_torch.training.expert import train_expert
from gan_mpc_tpu_torch.training.masking import ClippedAdam
from gan_mpc_tpu_torch.utils import io


def expert_eval_policy(model: ExpertPredictor):
    """The closed-loop policy of the predictor: replay the observed history
    (B, h+1, x) teacher-forced and act with the last predicted action."""

    @torch.no_grad()
    def policy_fn(history_x, history_u):
        del history_u
        _, (_, useq) = model(model.init_carry(history_x[:, 0]), history_x, True)
        return useq[:, -1]

    return policy_fn


def run(config: Config, log_fn=print, device="cuda",
        trajs: Optional[TrajectorySet] = None) -> dict:
    """Train, evaluate and save an expert predictor for ``config`` on the
    store ``common.ensure_trajectories`` gives (or ``trajs``), on the card
    unless ``device`` says otherwise. Returns the model, its flax tree, the
    run directory, the average return and the last losses."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(config.seed)
    k_split, k_train, k_eval = (split(generator) for _ in range(3))
    env = common.make_env(config.env.name, device)
    if trajs is None:
        trajs = common.ensure_trajectories(config, device)
    normalizer = common.build_normalizer(config, trajs, device)

    tcfg = config.expert_prediction.train
    states = normalizer.normalize_state(torch.tensor(trajs.states, device=device))
    actions = normalizer.normalize_action(torch.tensor(trajs.actions, device=device))
    train_data, test_data = split_sequence_windows(
        states, actions, tcfg.seqlen, k_split,
        start_oversample=tcfg.get_path("start_oversample", 20))

    model = common.build_expert_model(config, env.obs_size, env.act_size)
    init_flax_like(model, generator)
    model.to(device)
    optimizer = ClippedAdam([(model.parameters(), tcfg.learning_rate)], max_grad_norm=100.0)
    train_losses, test_loss = train_expert(
        model, optimizer, train_data, test_data, num_epochs=tcfg.num_epochs,
        batch_size=tcfg.batch_size, generator=k_train, discount_factor=tcfg.discount_factor,
        teacher_forcing_factor=tcfg.teacher_forcing_factor, log_fn=log_fn)
    model.requires_grad_(False)

    env_im, env_im_params = common.imitator_env(config, device)
    avg_reward = float(average_return(
        env_im, env_im_params, expert_eval_policy(model), normalizer,
        num_steps=config.get_path("mpc.evaluate.max_interactions", 1000),
        history=tcfg.seqlen - 1, num_runs=config.get_path("expert_prediction.eval_runs", 3),
        generator=k_eval))

    run_dir = io.new_run_dir(common.expert_model_dir(config))
    tree = expert_to_jax_params(model)
    save_msgpack(tree, os.path.join(run_dir, "params.msgpack"))
    io.save_json({
        "env": config.env.to_dict(),
        "model": config.expert_prediction.model.to_dict(),
        "train": tcfg.to_dict(),
        # the identity of the data the predictor learned from: a saved
        # predictor of other data is stale (load_pretrained_expert)
        "collection_fingerprint": common.collection_fingerprint(config),
        "loss": {"train_loss": round(train_losses[-1], 5), "test_loss": round(test_loss, 5)},
        "avg_reward": round(avg_reward, 2),
    }, os.path.join(run_dir, "config.json"))
    if log_fn is not None:
        log_fn(f"[expert] avg_reward {avg_reward:.2f} saved to {run_dir}")
    return {"model": model, "params": tree, "run_dir": run_dir, "avg_reward": avg_reward,
            "train_loss": train_losses[-1], "test_loss": test_loss}


def load_pretrained_expert(config: Config, x_size: int, u_size: int,
                           device="cuda") -> ExpertPredictor:
    """The saved predictor ``mpc.model.expert.load_id`` (else the newest
    run), rebuilt from its own ``config.json``, without gradients, on the
    card unless ``device`` says otherwise. Raises ``FileNotFoundError``
    where no run is saved, and where the newest run (no ``load_id``)
    records another data fingerprint than the config's."""
    load_id = config.get_path("mpc.model.expert.load_id")
    run_dir = io.latest_run_dir(common.expert_model_dir(config), load_id)
    saved = io.load_json(os.path.join(run_dir, "config.json"))
    saved_fp = saved.get("collection_fingerprint")
    if saved_fp is not None and load_id is None:
        current = common.collection_fingerprint(config)
        if saved_fp != current:
            raise FileNotFoundError(
                f"expert predictor at {run_dir} was trained on data fingerprint {saved_fp}, "
                f"current is {current}; retraining")
    model = common.build_expert_model_from_dict(saved["model"], x_size, u_size)
    expert_from_jax_params(load_msgpack(os.path.join(run_dir, "params.msgpack")), model)
    return model.requires_grad_(False).to(resolve_device(device))

