"""Config-driven factories and the runners' shared setup.

Counterpart of ``gan_mpc_tpu/runners/common.py`` (the factories,
``solver_settings``, ``build_normalizer``, ``load_run_config``,
``imitator_env``, ``collection_fingerprint``, ``trajectories_path``,
``imitator_model_dir``, ``record_solver_stats``) and of the shared
``setup`` of ``gan_mpc_tpu/runners/l2.py``. Differences:

  * the port never collects expert data: ``setup`` reads the store that
    ``resolve_trajectories`` names (``env.trajectories_path``, else the
    fingerprinted store under the workdir) and raises
    ``FileNotFoundError`` where the JAX ``ensure_trajectories`` would
    collect one (the collectors are not ported). The committed pendulum
    runs' fingerprint names no committed store, so they are run with
    ``env.trajectories_path``;
  * the expert is read from a saved expert run; where the JAX ``setup``
    trains one when none is saved, this one raises (the expert trainer is
    not ported), unless ``mpc.train.init_from_run`` names a run whose
    params replace it anyway;
  * ``solver_settings`` reads every knob ``SolverSettings`` has, where the
    JAX one leaves ``fused_ls``, ``num_alphas`` and ``compute_dtype`` at
    their defaults;
  * ``maybe_clear_caches``, ``maybe_mesh`` and the runners'
    ``runtime_setup`` manage XLA's compile caches and device meshes and
    have no counterpart; ``check_supported`` refuses the settings whose
    paths are not ported.

Weights are drawn flax-style (``params.init_flax_like``) from a
``torch.Generator`` seeded with the config's seed; then the expert is read
from the saved expert run, and every component replaced by a saved run's
where ``mpc.train.init_from_run`` names one, as the JAX ``setup`` does.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components
from gan_mpc_tpu_torch.utils.metrics import solver_stats

# The scripted experts' behaviour versions (``gan_mpc_tpu/runners/collect.py``),
# folded into the collection fingerprint; cheetah's variant comes from
# GMT_CHEETAH_EXPERT, read when the fingerprint is taken.
EXPERT_VERSION = {"pendulum_swingup": 2, "humanoid_walk": 3, "walker_walk": 2}


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


def imitator_model_dir(config: Config, family: str) -> str:
    workdir = config.get_path("runtime.workdir", "runs")
    return os.path.join(workdir, "trained_models", "imitator", config.env.name, family)


def expert_version(env_name: str):
    if env_name == "cheetah_run":
        variant = os.environ.get("GMT_CHEETAH_EXPERT", "nominal")
        return 2 if variant == "nominal" else f"2-{variant}"
    return EXPERT_VERSION.get(env_name, 1)


def collection_fingerprint(config: Config) -> str:
    """Short hash of everything that determines the collected expert data:
    the env's physics constants (``default_params``' fields in order, as
    float32, as the JAX leaves are) and the collection knobs. Equal to the
    JAX package's for the envs the port has."""
    params = make_env(config.env.name, "cpu").default_params()
    payload = [config.env.name]
    payload += [f"{float(np.float32(getattr(params, f.name))):.9g}"
                for f in dataclasses.fields(params)]
    num = max(config.get_path("env.collect_trajectories", config.mpc.train.num_trajectories),
              config.mpc.train.num_trajectories, 4)
    payload += [
        str(config.get_path("env.expert_episode_steps", 1000)),
        str(config.get_path("env.expert_noise", 0.25)),
        str(config.get_path("env.expert_reset_velocity", 0.0)),
        str(num),
        str(config.seed + 7),
        f"expert-v{expert_version(config.env.name)}",
    ]
    return hashlib.sha256("|".join(payload).encode()).hexdigest()[:10]


def trajectories_path(config: Config) -> str:
    """The fingerprinted store of ``config`` under the workdir: the
    ``.gmts`` where it exists, else the ``.npz`` where that exists, else the
    ``.gmts`` name (the JAX package's choice where its native store library
    loads)."""
    workdir = config.get_path("runtime.workdir", "runs")
    base = os.path.join(workdir, "expert_trajectories", config.env.name)
    fp = collection_fingerprint(config)
    gmts = os.path.join(base, f"trajectories-{fp}.gmts")
    npz = os.path.join(base, f"trajectories-{fp}.npz")
    if not os.path.exists(gmts) and os.path.exists(npz):
        return npz
    for legacy in ("trajectories.gmts", "trajectories.npz"):
        if not os.path.exists(gmts) and os.path.exists(os.path.join(base, legacy)):
            print(f"[trajectories] ignoring legacy unfingerprinted store "
                  f"{os.path.join(base, legacy)}; expected trajectories-{fp}.*")
            break
    return gmts


def resolve_trajectories(config: Config) -> str:
    """The store a run reads (the JAX ``ensure_trajectories``' choice):
    ``env.trajectories_path`` where set, else ``trajectories_path``. Raises
    ``FileNotFoundError`` where the JAX package would collect it: expert
    collection is not ported (ROADMAP Queue 1 item 8)."""
    path = config.get_path("env.trajectories_path") or trajectories_path(config)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no expert trajectory store at {path!r}: the port does not collect expert "
            "data (the collectors are not ported, ROADMAP Queue 1 item 8); set "
            "env.trajectories_path to a store")
    return path


# dm_control's suite tasks of the repo's envs (``gan_mpc_tpu/envs/dm_eval.py``)
DM_SUITE_NAMES = ("pendulum_swingup", "cartpole_balance", "cheetah_run", "walker_walk")


def dm_cross_eval_runs(config: Config) -> bool:
    """Whether the JAX run would cross-evaluate in real dm_control:
    ``mpc.evaluate.dm_control_episodes`` > 0, dm_control importable and the
    imitator env a suite task."""
    if not config.get_path("mpc.evaluate.dm_control_episodes", 0):
        return False
    try:
        import dm_control.suite  # noqa: F401
    except Exception:
        return False
    return config.env.imitator.name in DM_SUITE_NAMES


def check_supported(config: Config) -> None:
    """Raise ``NotImplementedError``, before any work, for a run setting
    whose path is not ported, naming its ROADMAP Queue 1 item; the
    dm_control cross-evaluation where it would run (``dm_cross_eval_runs``)."""
    if dm_cross_eval_runs(config):
        raise NotImplementedError(
            "the dm_control cross-evaluation (envs/dm_eval.py) is not ported (item 8 of "
            "ROADMAP Queue 1); set mpc.evaluate.dm_control_episodes: 0")
    unported = [
        (config.get_path("runtime.fused_epochs", False), "runtime.fused_epochs: true",
         "the fused epochs, item 9"),
        (config.get_path("expert_prediction.dagger.rounds", 0) > 0,
         "expert_prediction.dagger.rounds > 0", "DAgger, items 7-8"),
        (config.get_path("mpc.evaluate.save_video", False), "mpc.evaluate.save_video: true",
         "video, item 8"),
        (int(config.get_path("runtime.data_parallel_devices", 1) or 1) > 1,
         "runtime.data_parallel_devices > 1", "data parallel, item 9"),
    ]
    for on, setting, item in unported:
        if on:
            raise NotImplementedError(f"{setting} is not ported ({item} of ROADMAP Queue 1)")


def phase_optimizers(ctx: dict) -> dict:
    """The phase optimizers of the config: ``masked_adam`` with each
    phase's ``no_grads`` and learning rate, the cost phase's MPC weights at
    ``weights_learning_rate`` where set; the critic's where the policy has
    a critic."""
    tcfg = ctx["config"].mpc.train
    comps = policy_components(ctx["policy"])
    ccfg, dcfg, qcfg = tcfg.cost, tcfg.dynamics, tcfg.critic
    opts = {
        "cost": masked_adam(comps, ccfg.no_grads, ccfg.learning_rate,
                            weights_learning_rate=ccfg.get_path("weights_learning_rate")),
        "dynamics": masked_adam(comps, dcfg.no_grads, dcfg.learning_rate),
    }
    if "critic_params" in comps:
        opts["critic"] = masked_adam(comps, qcfg.no_grads, qcfg.learning_rate)
    return opts


def record_solver_stats(metrics, policy: MPCPolicy, cost_test, epoch: int, n: int = 32) -> None:
    """Plan the first ``n`` held-out expert histories of ``cost_test`` (the
    (X, Y) test split of ``setup``) and record the solver's convergence
    statistics."""
    hX = cost_test[0][:n]
    hU = hX.new_zeros((hX.shape[0], hX.shape[1] - 1, policy.expert_model.u_size))
    metrics.record(epoch, **solver_stats(policy.plan_batch(hX, hU)))


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
            raise FileNotFoundError(f"no expert runs under {base!r} (the expert trainer "
                                    "is not ported, ROADMAP Queue 1 item 7)")
        run_id = max(ids)
    run_dir = os.path.join(base, str(run_id))
    with open(os.path.join(run_dir, "config.json")) as fp:
        mdict = json.load(fp)["model"]
    old = policy.expert_model
    expert = build_expert_model_from_dict(mdict, old.x_size, old.u_size)
    expert_from_jax_params(load_msgpack(os.path.join(run_dir, "params.msgpack")), expert)
    policy.expert_model = expert.requires_grad_(False).to(next(old.parameters()).device)
    return policy


def setup(config: Config, with_critic: bool, trajectories_path: Optional[str] = None,
          device="cuda", generator: Optional[torch.Generator] = None) -> dict:
    """The L2 and GAN runners' shared setup (``runners/l2.py`` ``setup``)
    on the store at ``trajectories_path`` (default: ``resolve_trajectories``):
    the policy (weights of
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
    path = trajectories_path or resolve_trajectories(config)
    min_reward = tcfg.get_path("min_expert_reward", 500.0)
    trajs = load_trajectories(path, num_trajectories=tcfg.num_trajectories,
                              trajectory_len=tcfg.trajectory_len, min_reward=min_reward)
    if trajs.states.shape[0] < tcfg.num_trajectories:
        print(f"[trajectories] WARNING: only {trajs.states.shape[0]} of the requested "
              f"{tcfg.num_trajectories} trajectories clear min_expert_reward={min_reward} "
              f"in {path}; training proceeds on the smaller set")
    normalizer = build_normalizer(config, trajs, device)

    policy = build_policy(config, x_size, u_size, with_critic, device)
    # the saved expert first (its model rebuilt from its own config.json),
    # then a saved run over every component, as the JAX setup does
    init_run = tcfg.get_path("init_from_run")
    try:
        load_saved_expert(config, policy)
    except FileNotFoundError:
        if not init_run:
            raise
    if init_run:
        load_saved_params(policy, init_run)

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
