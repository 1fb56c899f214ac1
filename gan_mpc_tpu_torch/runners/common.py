"""Config-driven factories and the runners' shared setup.

Counterpart of ``gan_mpc_tpu/runners/common.py`` (the factories,
``solver_settings``, ``build_normalizer``, ``load_run_config``,
``imitator_env``) and of the shared ``setup`` of
``gan_mpc_tpu/runners/l2.py``. Two differences:

  * the port never collects expert data: ``setup`` takes the path of a
    trajectory store (``data/trajectories.py``). The JAX
    ``ensure_trajectories`` collects one under ``runs/`` when no store
    carries the config's collection fingerprint, which is the case for
    the committed pendulum runs;
  * ``solver_settings`` reads every knob ``SolverSettings`` has, where the
    JAX one leaves ``fused_ls``, ``num_alphas`` and ``compute_dtype`` at
    their defaults.

Weights are drawn flax-style (``params.init_flax_like``) from a
``torch.Generator`` seeded with the config's seed, then replaced by a
saved run's (``mpc.train.init_from_run``) as the JAX ``setup`` does, or,
without one, the expert is read from the saved expert run.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.data.trajectories import TrajectorySet, load_trajectories
from gan_mpc_tpu_torch.data.windows import cost_windows, sequence_windows, shuffle_and_split
from gan_mpc_tpu_torch.envs import apply_physics_shift, make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.critic import SequenceCritic
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import (
    expert_from_jax_params,
    from_jax_params,
    init_flax_like,
    load_msgpack,
)
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy


def build_cost_model(config: Config, horizon: int, x_size: int) -> MPCCost:
    ccfg = config.mpc.model.cost
    net = CostFeatureNet(x_size, hidden=tuple(ccfg.mlp.hidden),
                         features_out=ccfg.mlp.features_out)
    return MPCCost(
        net,
        horizon=horizon,
        mpc_weights=mpc_weights(config),
        action_goal_scale=float(ccfg.get_path("action_goal_scale", 1.0)),
        action_goal_squared=bool(ccfg.get_path("action_goal_squared", False)),
    )


def build_dynamics_model(config: Config, x_size: int, u_size: int) -> LearnedDynamics:
    mcfg = config.mpc.model.dynamics
    if mcfg.use != "mlp":
        raise NotImplementedError(f"dynamics.use={mcfg.use!r} is not ported (only 'mlp')")
    return LearnedDynamics(ResidualMLPDynamicsNet(x_size, u_size, hidden=tuple(mcfg.mlp.hidden)))


def build_expert_model_from_dict(mdict: dict, x_size: int, u_size: int) -> ExpertPredictor:
    """The expert from a model-config dict (the schema of an expert run's
    ``config.json``)."""
    if mdict["use"] != "lstm":
        raise NotImplementedError(f"expert model.use={mdict['use']!r} is not ported")
    return ExpertPredictor(x_size, u_size, arch="lstm", features=mdict["lstm"]["features"],
                           hidden=tuple(mdict["lstm"]["hidden"]))


def build_expert_model(config: Config, x_size: int, u_size: int) -> ExpertPredictor:
    return build_expert_model_from_dict(config.expert_prediction.model.to_dict(), x_size,
                                        u_size)


def build_critic_model(config: Config, x_size: int) -> SequenceCritic:
    mcfg = config.mpc.model.critic
    if mcfg.use != "lstm":
        raise ValueError("critic supports only the lstm architecture")
    return SequenceCritic(x_size, features=mcfg.lstm.features, hidden=tuple(mcfg.lstm.hidden))


def solver_settings(config: Config) -> SolverSettings:
    """Every ``SolverSettings`` field from ``mpc.solver.<field>``, with the
    JAX package's defaults (``inner_unroll``: the horizon up to 8, else 1)."""
    horizon = config.mpc.get_path("horizon", 5)
    defaults = SolverSettings(inner_unroll=horizon if horizon <= 8 else 1)
    return SolverSettings(**{
        f.name: config.mpc.get_path(f"solver.{f.name}", getattr(defaults, f.name))
        for f in dataclasses.fields(SolverSettings)
    })


def mpc_weights(config: Config) -> tuple:
    """The raw MPC weights (action, state, terminal[, action_goal[,
    action_goal_gain]]): the optional ones where the config names them."""
    wcfg = config.mpc.model.cost.weights
    weights = [wcfg.action, wcfg.state, wcfg.terminal]
    if wcfg.get_path("action_goal") is not None:
        weights.append(wcfg.action_goal)
        if wcfg.get_path("action_goal_gain") is not None:
            weights.append(wcfg.action_goal_gain)
    return tuple(float(w) for w in weights)


def build_policy(config: Config, x_size: int, u_size: int, with_critic: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None) -> MPCPolicy:
    """The policy of ``config`` with fresh flax-style weights drawn from
    ``generator`` (default: seeded with ``config.seed``), every parameter
    without gradient, on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    horizon = config.mpc.horizon
    policy = MPCPolicy(
        cost_model=build_cost_model(config, horizon, x_size),
        dynamics_model=build_dynamics_model(config, x_size, u_size),
        expert_model=build_expert_model(config, x_size, u_size),
        critic_model=build_critic_model(config, x_size) if with_critic else None,
        horizon=horizon,
        settings=solver_settings(config),
        bilevel_solver=config.get_path("mpc.solver.bilevel", "dense"),
        goal_projection=config.get_path("mpc.goal_projection_iters", 0),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    init_flax_like(policy, generator)
    return policy.requires_grad_(False).to(device)


def build_normalizer(config: Config, trajs: TrajectorySet, device="cuda") -> Normalizer:
    ncfg = config.mpc.normalizer
    device = resolve_device(device)
    return Normalizer.fit(
        torch.tensor(trajs.states, device=device),
        torch.tensor(trajs.actions, device=device),
        normalize_state=ncfg.state == "standard_norm",
        normalize_action=ncfg.action == "standard_norm",
    )


def load_run_config(run_dir: str) -> Config:
    """The training config of a saved run, rebuilt from its own
    ``config.json`` (env, seed, ``policy`` as the mpc tree and
    ``expert_prediction``), with the default ``runtime``."""
    path = os.path.join(run_dir, "config.json")
    with open(path) as fp:
        saved = json.load(fp)
    if "expert_prediction" not in saved:
        raise ValueError(f"{path} predates expert_prediction provenance")
    return Config.from_dict({"seed": saved.get("seed", 0), "env": saved["env"],
                             "mpc": saved["policy"],
                             "expert_prediction": saved["expert_prediction"],
                             "runtime": {"workdir": "runs"}})


def imitator_env(config: Config, device="cuda"):
    """(env, physics params with the imitator's shift) on the card unless
    ``device`` says otherwise."""
    icfg = config.env.imitator
    env = make_env(icfg.name, device)
    params = env.default_params()
    shifts = [dict(kv) for kv in (icfg.get_path("physics") or [])]
    if shifts:
        params = apply_physics_shift(params, shifts)
    return env, params


def expert_model_dir(config: Config) -> str:
    workdir = config.get_path("runtime.workdir", "runs")
    return os.path.join(workdir, "trained_models", "expert", config.env.name)


def load_saved_params(policy: MPCPolicy, run_dir: str) -> MPCPolicy:
    """Every component of ``run_dir/params.msgpack`` into ``policy`` (the
    critic where the policy has one). A run saved with fewer MPC weights
    than the policy has keeps the policy's tail (the JAX ``setup``'s prefix
    splice); more raise."""
    tree = load_msgpack(os.path.join(run_dir, "params.msgpack"))
    saved = np.asarray(tree["mpc_weights"], np.float32)
    current = policy.cost_model.weights.detach().cpu().numpy()
    if saved.shape[0] > current.shape[0]:
        raise ValueError(f"init_from_run has {saved.shape[0]} mpc weights, the config only "
                         f"{current.shape[0]}: cannot drop trained weights")
    tree["mpc_weights"] = np.concatenate([saved, current[saved.shape[0]:]])
    if policy.critic_model is not None and "critic_params" not in tree:
        raise ValueError(f"{run_dir} holds no critic_params")
    return from_jax_params(tree, policy)


def load_saved_expert(config: Config, policy: MPCPolicy) -> MPCPolicy:
    """The expert of the saved expert run ``mpc.model.expert.load_id`` (or
    the newest), rebuilt from that run's own ``config.json``."""
    base = expert_model_dir(config)
    run_id = config.get_path("mpc.model.expert.load_id")
    if run_id is None:
        ids = [int(d) for d in os.listdir(base) if d.isdigit()]
        if not ids:
            raise FileNotFoundError(f"no expert runs under {base!r}")
        run_id = max(ids)
    run_dir = os.path.join(base, str(run_id))
    with open(os.path.join(run_dir, "config.json")) as fp:
        mdict = json.load(fp)["model"]
    old = policy.expert_model
    expert = build_expert_model_from_dict(mdict, old.x_size, old.u_size)
    expert_from_jax_params(load_msgpack(os.path.join(run_dir, "params.msgpack")), expert)
    policy.expert_model = expert.requires_grad_(False).to(next(old.parameters()).device)
    return policy


def setup(config: Config, with_critic: bool, trajectories_path: str, device="cuda",
          generator: Optional[torch.Generator] = None) -> dict:
    """The L2 and GAN runners' shared setup (``runners/l2.py`` ``setup``)
    on the store at ``trajectories_path``: the policy (weights of
    ``mpc.train.init_from_run`` where set), the normalizer fitted on the
    store, the cost windows split into train and test, the expert's
    dynamics windows (train split), the imitator env, the replay buffer
    and ``collect_fn(generator)``, the on-policy episode of the dynamics
    phase with its exploration noise. The splits draw from ``generator``
    (default: seeded with ``config.seed``). Returns a dict of them."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    env = make_env(config.env.name, device)
    x_size, u_size = env.obs_size, env.act_size
    tcfg = config.mpc.train
    trajs = load_trajectories(trajectories_path, num_trajectories=tcfg.num_trajectories,
                              trajectory_len=tcfg.trajectory_len,
                              min_reward=tcfg.get_path("min_expert_reward", 500.0))
    normalizer = build_normalizer(config, trajs, device)

    policy = build_policy(config, x_size, u_size, with_critic, device)
    init_run = tcfg.get_path("init_from_run")
    if init_run:
        load_saved_params(policy, init_run)
    else:
        load_saved_expert(config, policy)

    history, horizon = config.mpc.history, config.mpc.horizon
    states = normalizer.normalize_state(torch.tensor(trajs.states, device=device))
    cost_data = shuffle_and_split(cost_windows(states, history, horizon), generator)
    dyn_actions = normalizer.normalize_action(torch.tensor(trajs.dynamics_actions,
                                                           device=device))
    dyn_train, _ = shuffle_and_split(sequence_windows(states, dyn_actions, horizon), generator)

    env_im, env_im_params = imitator_env(config, device)
    dcfg = tcfg.dynamics
    replay = ReplayBuffer.create(dcfg.replay_buffer_size, horizon, x_size, u_size, device)

    def collect_fn(gen: torch.Generator):
        return policy_rollout(
            env_im, env_im_params, policy, normalizer,
            num_steps=dcfg.max_interactions_per_episode, history=history,
            num_envs=config.get_path("runtime.num_parallel_envs", 1), generator=gen,
            action_noise=dcfg.get_path("collection_noise", 0.0),
        )

    return dict(config=config, env=env, trajs=trajs, env_im=env_im,
                env_im_params=env_im_params, policy=policy, normalizer=normalizer,
                cost_data=cost_data, dyn_train=dyn_train, replay=replay,
                collect_fn=collect_fn)
