"""Config-driven factories and the runners' shared setup.

Counterpart of ``gan_mpc_tpu/runners/common.py`` (the factories,
``solver_settings``, ``build_normalizer``, ``load_run_config``,
``imitator_env``, ``collection_fingerprint``, ``trajectories_path``,
``ensure_trajectories``, ``imitator_model_dir``, ``record_solver_stats``)
and of the shared ``setup`` of ``gan_mpc_tpu/runners/l2.py``. As there,
``setup`` reads the config's expert store, collecting it with the
scripted expert where it is missing (``ensure_trajectories``), and the
saved expert predictor, training one where none matches the store's data
(``runners/expert.py``). Differences:

  * where ``mpc.train.init_from_run`` names a run, ``setup`` trains no
    expert when none is saved: the run's params replace the expert anyway
    (JAX trains one and then overwrites it, so the policy is the same);
  * ``setup`` takes a store path of its own, read as it is (never
    collected), which tests and the card's smoke run use for the
    committed pendulum store; the expert trainer then reads that store;
  * ``solver_settings`` reads every knob ``SolverSettings`` has, where the
    JAX one leaves ``fused_ls``, ``num_alphas`` and ``compute_dtype`` at
    their defaults; every value of each runs (``riccati: associative`` and
    ``compute_dtype: bfloat16`` included);
  * ``maybe_mesh`` makes the mesh inside the ranks that
    ``data_parallel_devices`` names (``parallel/launch.py`` spawns one
    process per device); ``maybe_clear_caches`` and ``runtime_setup``
    manage XLA's compile caches and have no counterpart (``runtime_setup``
    is a documented no-op: the kernels' keyed ``ops/_build.py`` directory
    is the port's compile cache, and ``runtime.compile_cache_dir`` is
    accepted and ignored).

Random draws come from ``torch.Generator``s: the collection from one
seeded with ``seed + 7`` (where JAX seeds its key), the expert trainer
from one seeded with the config's seed, the policy's flax-style weights
and the splits from the run's generator.
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
from gan_mpc_tpu_torch.data.trajectories import (
    TrajectorySet,
    load_trajectories,
    save_trajectories,
)
from gan_mpc_tpu_torch.data.windows import cost_windows, sequence_windows, shuffle_and_split
from gan_mpc_tpu_torch.envs import apply_physics_shift, make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.critic import SequenceCritic
from gan_mpc_tpu_torch.models.dynamics import (
    LearnedDynamics,
    LSTMDynamicsNet,
    ResidualMLPDynamicsNet,
)
from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import from_jax_params, init_flax_like, load_msgpack
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
from gan_mpc_tpu_torch.runners.collect import collect_expert_trajectories, expert_version
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components
from gan_mpc_tpu_torch.utils.metrics import solver_stats


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


def build_dynamics_model(config: Config, x_size: int, u_size: int):
    """The dynamics of ``mpc.model.dynamics.use``: "mlp" (a residual MLP),
    "lstm" (``LSTMDynamicsNet``) or "ensemble" (``ensemble.num_members``
    residual MLPs of ``ensemble.mlp.hidden``, each drawn on its own by
    ``build_policy``); each one serves and trains."""
    mcfg = config.mpc.model.dynamics
    if mcfg.use == "mlp":
        return LearnedDynamics(ResidualMLPDynamicsNet(x_size, u_size,
                                                      hidden=tuple(mcfg.mlp.hidden)))
    if mcfg.use == "lstm":
        return LearnedDynamics(LSTMDynamicsNet(x_size, u_size, features=mcfg.lstm.features,
                                               hidden=tuple(mcfg.lstm.hidden)))
    if mcfg.use == "ensemble":
        ecfg = mcfg.ensemble
        return EnsembleDynamics([ResidualMLPDynamicsNet(x_size, u_size,
                                                        hidden=tuple(ecfg.mlp.hidden))
                                 for _ in range(ecfg.num_members)])
    raise ValueError(f"dynamics.use must be mlp|lstm|ensemble, got {mcfg.use!r}")


def build_expert_model_from_dict(mdict: dict, x_size: int, u_size: int) -> ExpertPredictor:
    """The expert from a model-config dict (the schema of an expert run's
    ``config.json``)."""
    use = mdict["use"]
    if use == "lstm":
        return ExpertPredictor(x_size, u_size, arch="lstm", features=mdict["lstm"]["features"],
                               hidden=tuple(mdict["lstm"]["hidden"]))
    if use == "mlp":
        return ExpertPredictor(x_size, u_size, arch="mlp", features=0,
                               hidden=tuple(mdict["mlp"]["hidden"]))
    raise ValueError(f"expert model.use must be mlp|lstm, got {use!r}")


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
    dynamics = build_dynamics_model(config, x_size, u_size)
    policy = MPCPolicy(
        # the cost net reads the planner state, the dynamics' carry included
        cost_model=build_cost_model(config, horizon, x_size + dynamics.carry_size),
        dynamics_model=dynamics,
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


def collection_size(config: Config) -> int:
    """The episodes a collection draws: ``env.collect_trajectories`` (more
    than ``mpc.train.num_trajectories`` leaves the reward gate headroom),
    at least ``num_trajectories`` and 4."""
    num = config.mpc.train.num_trajectories
    return max(config.get_path("env.collect_trajectories", num), num, 4)


def collection_fingerprint(config: Config) -> str:
    """Short hash of everything that determines the collected expert data:
    the env's physics constants (``default_params``' fields in order, as
    float32, as the JAX leaves are) and the collection knobs. Equal to the
    JAX package's for the envs the port has."""
    params = make_env(config.env.name, "cpu").default_params()
    payload = [config.env.name]
    payload += [f"{float(np.float32(getattr(params, f.name))):.9g}"
                for f in dataclasses.fields(params)]
    payload += [
        str(config.get_path("env.expert_episode_steps", 1000)),
        str(config.get_path("env.expert_noise", 0.25)),
        str(config.get_path("env.expert_reset_velocity", 0.0)),
        str(collection_size(config)),
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
    """The store a run reads: ``env.trajectories_path`` where set, else
    ``trajectories_path``; whether it exists or not."""
    return config.get_path("env.trajectories_path") or trajectories_path(config)


def load_store(config: Config, path: str) -> TrajectorySet:
    """The store at ``path`` through the reward gate of ``mpc.train``,
    with a warning where fewer trajectories clear it than were asked for
    (``load_trajectories`` raises only where none does)."""
    tcfg = config.mpc.train
    min_reward = tcfg.get_path("min_expert_reward", 500.0)
    trajs = load_trajectories(path, num_trajectories=tcfg.num_trajectories,
                              trajectory_len=tcfg.trajectory_len, min_reward=min_reward)
    if trajs.states.shape[0] < tcfg.num_trajectories:
        print(f"[trajectories] WARNING: only {trajs.states.shape[0]} of the requested "
              f"{tcfg.num_trajectories} trajectories clear min_expert_reward={min_reward} "
              f"in {path}; training proceeds on the smaller set; raise "
              "env.collect_trajectories to restore oversampling headroom")
    return trajs


def ensure_trajectories(config: Config, device="cuda") -> TrajectorySet:
    """The config's expert store (``resolve_trajectories``) through the
    reward gate; where it is missing, first collected with the scripted
    expert (``collection_size`` episodes of ``env.expert_episode_steps``
    steps, ``env.expert_noise``, ``env.expert_reset_velocity``; draws from a
    generator seeded with ``seed + 7``) on ``device`` and saved there."""
    path = resolve_trajectories(config)
    if not os.path.exists(path):
        trajs = collect_expert_trajectories(
            make_env(config.env.name, device), collection_size(config),
            torch.Generator().manual_seed(config.seed + 7),
            num_steps=config.get_path("env.expert_episode_steps", 1000),
            noise_sigma=config.get_path("env.expert_noise", 0.25),
            reset_velocity_sigma=config.get_path("env.expert_reset_velocity", 0.0),
        )
        save_trajectories(path, trajs)
    return load_store(config, path)


def check_supported(config: Config) -> None:
    """Raise ``NotImplementedError``, before any work, for a training-run
    setting whose path is not ported, naming its ROADMAP Queue 1 item.
    None is left: every dynamics ``build_dynamics_model`` builds trains,
    the dm_control cross-evaluation, the video and data parallelism
    (``runtime.data_parallel_devices``, ``data_parallel_devices``) run."""
    del config


def runtime_setup(config: Optional[Config] = None) -> None:
    """The JAX runners' ``runtime_setup.setup``, a no-op here: it points
    XLA's persistent compile cache at ``runtime.compile_cache_dir``; the
    port compiles its kernels once per source into ``ops/_build.py``'s
    keyed directory, which is its compile cache, and ignores the key."""
    del config


def data_parallel_devices(config: Config, devices=None) -> Optional[list]:
    """The devices of the ranks a run spawns: None where
    ``runtime.data_parallel_devices`` <= 1 or the run's epochs are not
    the fused ones (the modular path ignores the mesh, as JAX's does:
    its ``maybe_mesh`` is called in ``_run_fused_epochs`` only); else
    ``devices`` (one per rank) or ``cuda:0..N-1``, which raises where
    fewer cards are attached."""
    n = int(config.get_path("runtime.data_parallel_devices", 1) or 1)
    if n <= 1 or not config.get_path("runtime.fused_epochs", False):
        return None
    from gan_mpc_tpu_torch.parallel.mesh import default_devices

    devices = default_devices(n) if devices is None else [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"runtime.data_parallel_devices={n} but {len(devices)} devices given")
    return devices


def maybe_mesh(config: Config, devices=None):
    """A data-parallel mesh when ``runtime.data_parallel_devices`` > 1,
    else None (JAX's ``maybe_mesh``). It raises where fewer CUDA devices
    are attached than asked for (``devices`` names them otherwise), and
    outside the ranks of that many (``parallel/launch.py``)."""
    n = int(config.get_path("runtime.data_parallel_devices", 1) or 1)
    if n <= 1:
        return None
    from gan_mpc_tpu_torch.parallel.mesh import default_devices, make_mesh

    return make_mesh(n, devices=default_devices(n) if devices is None else devices)


def phase_optimizers(ctx: dict) -> dict:
    """The phase optimizers of the config: ``masked_adam`` with each
    phase's ``no_grads`` and learning rate, the cost phase's MPC weights at
    ``weights_learning_rate`` where set; the critic's where the policy has
    a critic."""
    tcfg = ctx["config"].mpc.train
    comps = policy_components(ctx["policy"])
    ccfg, dcfg = tcfg.cost, tcfg.dynamics
    opts = {
        "cost": masked_adam(comps, ccfg.no_grads, ccfg.learning_rate,
                            weights_learning_rate=ccfg.get_path("weights_learning_rate")),
        "dynamics": masked_adam(comps, dcfg.no_grads, dcfg.learning_rate),
    }
    if "critic_params" in comps:  # an L2 config may have no critic section
        opts["critic"] = masked_adam(comps, tcfg.critic.no_grads, tcfg.critic.learning_rate)
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


def setup(config: Config, with_critic: bool, trajectories_path: Optional[str] = None,
          device="cuda", generator: Optional[torch.Generator] = None) -> dict:
    """The L2 and GAN runners' shared setup (``runners/l2.py`` ``setup``):
    the expert store (the one at ``trajectories_path`` where given, else
    ``ensure_trajectories``), the normalizer fitted on it, the policy (its
    expert the saved one that matches the store's data, else trained now;
    every component of ``mpc.train.init_from_run`` where set), the cost
    windows split into train and test, the expert's dynamics windows (train
    split), the imitator env, the replay buffer and ``collect_fn(generator)``,
    the on-policy episode of the dynamics phase with its exploration noise.
    The weights and splits draw from ``generator`` (default: seeded with
    ``config.seed``). Returns a dict of them."""
    from gan_mpc_tpu_torch.runners import expert as expert_runner

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    env = make_env(config.env.name, device)
    x_size, u_size = env.obs_size, env.act_size
    tcfg = config.mpc.train
    if trajectories_path is None:
        trajs = ensure_trajectories(config, device)
    else:
        trajs = load_store(config, trajectories_path)
    normalizer = build_normalizer(config, trajs, device)

    policy = build_policy(config, x_size, u_size, with_critic, device)
    # the saved expert (its model rebuilt from its own config.json), else
    # a new one trained on this store; then a saved run over every
    # component, as the JAX setup does
    init_run = tcfg.get_path("init_from_run")
    try:
        policy.expert_model = expert_runner.load_pretrained_expert(config, x_size, u_size,
                                                                   device)
    except FileNotFoundError:
        if not init_run:
            policy.expert_model = expert_runner.run(config, log_fn=None, device=device,
                                                    trajs=trajs)["model"]
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
