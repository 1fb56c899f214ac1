"""The fused GAN and L2 epochs: one training epoch's whole update sequence.

Counterpart of ``gan_mpc_tpu/training/fused_epoch.py``
(``make_fused_gan_epoch``, ``make_fused_l2_epoch``). There an epoch is
one jitted XLA program; here it is an eager loop of the same update
sequence, on the live policy, the replay buffer and the phase optimizers
(``masking.ClippedAdam``), all updated in place:

  1. collection: one batched episode of ``num_envs`` envs for
     ``episode_steps`` steps with the ``collect_noise`` exploration noise;
     its return is the mean over envs of the summed rewards, and its
     normalized windows go into the ring replay;
  2. dynamics: ``dynamics_updates * (N // batch_size)`` minibatch steps on
     replay windows drawn with replacement from the filled slots (N the
     expert histories), then ``expert_dyn_updates`` teacher-forced steps
     on the expert's dynamics windows;
  3. (GAN) the critic: ``critic_plan_batch`` expert histories drawn
     without replacement and planned; expert futures labelled +1, the
     planned states -1, shuffled; ``critic_updates`` BCE minibatch steps;
  4. ``cost_updates`` generator (GAN) or L2 cost minibatch steps through
     the planner's implicit gradient, then one Polyak blend of every
     parameter back toward its value before them;
  5. held-out metrics from one planning pass over the first
     ``test_plan_batch`` test histories: the critic's BCE and the
     generator loss (GAN) or the L2 loss.

Every minibatch has ``batch_size`` rows (the runners pass the cost
phase's). The phases are module functions (``collect_episode``,
``dynamics_steps``, ``critic_dataset``, ``cost_steps``,
``gan_test_metrics``, ``l2_test_metric``) that the epochs look up when
they run.

Draws: the GAN epoch splits six independent generators off its own, in
JAX's order of keys (collection, dynamics, critic subset, critic
minibatches, cost, critic shuffle); the L2 epoch three (collection,
dynamics, cost). The expert refresh draws from a generator split off the
dynamics one, the counterpart of ``fold_in(k_dyn, 1)``. Each draw can be
passed in instead (``FusedDraws``), so that tests replay JAX's.

Differences from the JAX module:

  * ``chunk_updates`` changes nothing. JAX partitions its one program
    into programs of at most that many updates, for the TPU runtime's
    watchdog, with the same update sequence and the same numbers; an
    eager loop has no program to bound.
  * ``collect_chunk_steps`` changes nothing either: the episode runs
    whole (JAX bounds its collection program the same way).
  * ``plan_chunk`` > 0 plans the critic's and the test split's histories
    in sub-batches of that many, in every mode (JAX does it in its
    chunked mode). The batch planner's lanes are independent, each with
    its own convergence mask and Levenberg-Marquardt damping, so the
    sub-batches give the same plans up to float32 rounding.

Mesh mode (``mesh``, ``parallel/mesh.py``; the runners pass it where
``runtime.data_parallel_devices`` > 1): the same epoch on every rank of
the mesh's ``dp_axis``, as JAX's ``shard_map`` runs its one program
(``training/fused_epoch.py:104-173`` there). Every draw stays global and
the same on every rank (the generators are seeded alike, or ``draws``
passes them in), and each rank takes its rows (``mesh.rows``): of the
collection's start states and noise (drawn as the single-process epoch
draws them), of each minibatch row of ``dyn_perm``, ``exp_perm``,
``crit_perm`` and ``cost_perm``, and of the critic's and the GAN test
split's planning fan-outs. The collected windows and the planned states
are gathered, so the replay and the critic's dataset stay identical on
every rank; the episode return, every update's loss and its gradients are
averaged over the axis before the optimizer's step. The L2 test metric
plans the whole test split on every rank, as JAX's does. So the sharded
epoch computes the single-process epoch up to float reduction order.
``num_envs``, ``batch_size``, ``critic_plan_batch`` and the GAN test
split must divide the axis size, and mesh mode excludes
``chunk_updates``, with JAX's messages.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from gan_mpc_tpu_torch.envs.base import EnvState
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.policies.losses import (
    critic_bce_loss,
    gan_generator_loss,
    l2_imitation_loss,
)
from gan_mpc_tpu_torch.training import cost as tcost
from gan_mpc_tpu_torch.training import critic as tcritic
from gan_mpc_tpu_torch.training import dynamics as tdyn
from gan_mpc_tpu_torch.training.common import split
from gan_mpc_tpu_torch.training.masking import policy_components

GAN_STREAMS = ("collect", "dynamics", "critic_subset", "critic_minibatches", "cost", "shuffle")
L2_STREAMS = ("collect", "dynamics", "cost")


class FusedEpochMetrics(NamedTuple):
    episode_return: float
    dynamics_loss: float
    critic_loss: float
    generator_loss: float
    critic_test_loss: float
    generator_test_loss: float


class FusedL2Metrics(NamedTuple):
    episode_return: float
    dynamics_loss: float
    cost_loss: float
    cost_test_loss: float


class FusedDraws(NamedTuple):
    """An epoch's random draws; each one left None is drawn from its
    stream. Index tensors are int64 on any device."""

    reset: Optional[EnvState] = None  # (num_envs,) start states
    noise: Optional[torch.Tensor] = None  # (episode_steps, num_envs, act) standard normal
    dyn_perm: Optional[torch.Tensor] = None  # (dynamics steps, batch) replay slots
    exp_perm: Optional[torch.Tensor] = None  # (expert_dyn_updates, batch) expert windows
    plan_idx: Optional[torch.Tensor] = None  # (critic_plan_batch,) distinct histories
    shuffle: Optional[torch.Tensor] = None  # (2 critic_plan_batch,) permutation
    crit_perm: Optional[torch.Tensor] = None  # (critic_updates, batch) critic sequences
    cost_perm: Optional[torch.Tensor] = None  # (cost_updates, batch) histories


def _randint(generator: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(high, tuple(shape), generator=generator, device=generator.device)


@torch.no_grad()
def collect_episode(policy, env, env_params, normalizer, replay, num_envs: int,
                    episode_steps: int, history: int, noise_sigma: float,
                    generator: Optional[torch.Generator], reset: Optional[EnvState] = None,
                    noise: Optional[torch.Tensor] = None, mesh=None) -> float:
    """One batched on-policy episode into ``replay`` (normalized); its
    return, the mean over envs of the summed rewards. With a ``mesh`` the
    start states and the noise are drawn for all ``num_envs`` envs, as
    the rollout draws them, each rank rolls its rows, and the windows are
    gathered into every rank's replay."""
    if mesh is not None:
        if reset is None:
            reset = env.reset(env_params, num_envs, generator)
        if noise is None and noise_sigma > 0.0:
            noise = torch.stack([torch.randn((num_envs, env.act_size), generator=generator,
                                             device=generator.device)
                                 for _ in range(episode_steps)])
        reset = EnvState(*(mesh.rows(t) for t in (reset.qpos, reset.qvel, reset.t)))
        noise = None if noise is None else mesh.rows(noise.transpose(0, 1)).transpose(0, 1)
        num_envs = num_envs // mesh.size
    episode = policy_rollout(env, env_params, policy, normalizer, num_steps=episode_steps,
                             history=history, num_envs=num_envs, init_state=reset,
                             generator=generator, action_noise=noise_sigma, noise=noise)
    states = normalizer.normalize_state(episode.states)
    actions = normalizer.normalize_action(episode.actions)
    ep_return = episode.rewards.sum(-1).mean()
    if mesh is not None:
        states, actions = mesh.gather(states), mesh.gather(actions)
        ep_return = mesh.pmean(ep_return)
    replay.add_trajectories(states, actions)
    return float(ep_return)


def dynamics_steps(policy, optimizer, replay, dyn_perm: torch.Tensor, gamma: float,
                   teacher_forcing: bool, expert_windows=None,
                   exp_perm: Optional[torch.Tensor] = None, mesh=None) -> float:
    """One step per row of ``dyn_perm`` on the replay's windows at the
    caller's teacher forcing, then (where given) one teacher-forced step
    per row of ``exp_perm`` on ``expert_windows``; the replay steps' mean
    loss. With a ``mesh``, data parallel (``update_pass``)."""
    model = policy.dynamics_model
    loss = tdyn.update_pass(model, optimizer, (replay.states, replay.actions, replay.next_states),
                            dyn_perm, gamma, teacher_forcing, mesh)
    if exp_perm is not None:
        tdyn.update_pass(model, optimizer, expert_windows, exp_perm, gamma, True, mesh)
    return float(loss)


def _solutions(policy, X: torch.Tensor, plan_chunk: int) -> list:
    """Plans of the histories ``X`` without gradients, in sub-batches of
    ``plan_chunk`` (0: all at once): [(rows slice, solution)]."""
    n = X.shape[0]
    step = plan_chunk if plan_chunk > 0 else max(n, 1)
    with torch.no_grad():
        return [(slice(s, s + step), policy.plan(X[s:s + step], warm_start_carry=False))
                for s in range(0, n, step)]


def critic_dataset(policy, exp_X: torch.Tensor, exp_Y: torch.Tensor, plan_idx: torch.Tensor,
                   shuffle: torch.Tensor, plan_chunk: int = 0, mesh=None):
    """The critic's labelled sequences: the expert futures of the
    histories ``plan_idx`` (+1) and their planned states (-1), in the
    order ``shuffle``. Returns (sequences (2k, H+1, x), labels (2k,)).
    With a ``mesh`` each rank plans its rows of ``plan_idx`` and the
    planned states are gathered."""
    plan_idx = plan_idx.to(exp_X.device)
    mine = plan_idx if mesh is None else mesh.rows(plan_idx)
    fakes = torch.cat([policy.planned_states(sol)
                       for _, sol in _solutions(policy, exp_X[mine], plan_chunk)])
    if mesh is not None:
        fakes = mesh.gather(fakes)
    k = plan_idx.shape[0]
    seqs = torch.cat([exp_Y[plan_idx], fakes])
    labels = torch.cat([torch.ones(k, device=seqs.device), -torch.ones(k, device=seqs.device)])
    shuffle = shuffle.to(seqs.device)
    return seqs[shuffle], labels[shuffle]


def cost_steps(policy, optimizer, loss_fn, dataset, cost_perm: torch.Tensor,
               has_targets: bool, polyak_factor: float, mesh=None) -> float:
    """One step per row of ``cost_perm`` through the planner's implicit
    gradient on ``dataset`` = (X[, Y]), then the Polyak blend of every
    parameter; the steps' mean loss. With a ``mesh``, data parallel
    (``update_pass``)."""
    params: List[torch.Tensor] = [p for ps in policy_components(policy).values() for p in ps]
    prev = [p.detach().clone() for p in params]
    loss = tcost.update_pass(policy, optimizer, loss_fn, dataset, cost_perm, has_targets, mesh)
    tcost.blend_back(params, prev, polyak_factor)
    return float(loss)


@torch.no_grad()
def gan_test_metrics(policy, tX: torch.Tensor, tY: torch.Tensor, plan_chunk: int = 0,
                     mesh=None):
    """(critic BCE, generator loss) on held-out histories, from one
    planning pass: the critic on the expert futures (+1) and the planned
    states (-1), the generator loss -log(p + 1e-6) + log(1 - p + 1e-6) of
    the critic's p on the planned states. With a ``mesh`` each rank plans
    its rows and the planned states and generator losses are gathered."""
    sols = _solutions(policy, tX if mesh is None else mesh.rows(tX), plan_chunk)
    fakes = torch.cat([policy.planned_states(sol) for _, sol in sols])
    gen = torch.cat([gan_generator_loss(policy, sol) for _, sol in sols])
    if mesh is not None:
        fakes, gen = mesh.gather(fakes), mesh.gather(gen)
    n = tX.shape[0]
    labels = torch.cat([torch.ones(n, device=tX.device), -torch.ones(n, device=tX.device)])
    crit = critic_bce_loss(policy.critic_model, torch.cat([tY, fakes]), labels).mean()
    return float(crit), float(gen.mean())


@torch.no_grad()
def l2_test_metric(policy, tX: torch.Tensor, tY: torch.Tensor, plan_chunk: int = 0) -> float:
    """The L2 imitation loss on held-out histories, from one planning
    pass."""
    losses = [l2_imitation_loss(policy, sol, tY[rows])
              for rows, sol in _solutions(policy, tX, plan_chunk)]
    return float(torch.cat(losses).mean())


def _check_mesh(mesh, dp_axis: str, chunk_updates: int, sizes: dict):
    """JAX's refusals of mesh mode; the mesh's ``dp_axis`` must be all of
    it. None without a mesh."""
    if mesh is None:
        return None
    if chunk_updates:
        raise ValueError("fused epoch: mesh mode and chunk_updates are exclusive")
    num_dev = mesh.shape[dp_axis]
    if mesh.size != num_dev:
        raise ValueError(f"fused epoch mesh mode runs over one axis; the mesh is "
                         f"{mesh.shape}")
    for name, v in sizes.items():
        if v % num_dev:
            raise ValueError(f"fused epoch mesh mode: {name}={v} must divide the "
                             f"{dp_axis} axis size {num_dev}")
    return mesh


class _EpochData:
    """What both epochs hold: the expert windows and the draw sizes."""

    def __init__(self, expert_history_X, expert_future_Y, expert_history_X_test,
                 expert_future_Y_test, test_plan_batch, expert_dyn_windows, expert_dyn_updates,
                 batch_size, dynamics_updates):
        self.X, self.Y = expert_history_X, expert_future_Y
        self.have_test = expert_history_X_test is not None
        if self.have_test:
            self.tX = expert_history_X_test[:test_plan_batch]
            self.tY = expert_future_Y_test[:test_plan_batch]
        self.exp_windows = expert_dyn_windows if (
            expert_dyn_windows is not None and expert_dyn_updates > 0) else None
        self.exp_updates = expert_dyn_updates
        self.batch_size = batch_size
        self.dyn_steps = dynamics_updates * max(self.X.shape[0] // batch_size, 1)

    def dynamics_draws(self, streams, replay, draws: FusedDraws):
        """(dyn_perm, exp_perm or None), drawn where not given."""
        k_exp = split(streams["dynamics"])  # the counterpart of fold_in(k_dyn, 1)
        dyn_perm = draws.dyn_perm if draws.dyn_perm is not None else _randint(
            streams["dynamics"], max(replay.size, 1), (self.dyn_steps, self.batch_size))
        exp_perm = None
        if self.exp_windows is not None:
            exp_perm = draws.exp_perm if draws.exp_perm is not None else _randint(
                k_exp, self.exp_windows[0].shape[0], (self.exp_updates, self.batch_size))
        return dyn_perm, exp_perm

    def cost_perm(self, streams, draws: FusedDraws, cost_updates: int) -> torch.Tensor:
        if draws.cost_perm is not None:
            return draws.cost_perm
        return _randint(streams["cost"], self.X.shape[0], (cost_updates, self.batch_size))


def make_fused_gan_epoch(
    policy,
    env,
    env_params,
    normalizer,
    optimizers: dict,  # {"dynamics": opt, "critic": opt, "cost": opt}
    expert_history_X: torch.Tensor,  # (N, history+1, x) normalized expert histories
    expert_future_Y: torch.Tensor,  # (N, horizon+1, x) normalized expert futures
    *,
    num_envs: int,
    episode_steps: int,
    history: int,
    dynamics_updates: int,
    critic_updates: int,
    cost_updates: int,
    batch_size: int,
    gamma: float,
    polyak_factor: float,
    critic_plan_batch: int = 64,
    expert_history_X_test: Optional[torch.Tensor] = None,  # held-out split
    expert_future_Y_test: Optional[torch.Tensor] = None,
    test_plan_batch: int = 64,
    expert_dyn_windows=None,  # (X, U, Y) expert sequence windows
    expert_dyn_updates: int = 0,
    chunk_updates: int = 0,
    plan_chunk: int = 0,
    collect_noise: float = 0.0,
    collect_chunk_steps: int = 0,
    mesh=None,
    dp_axis: str = "dp",
):
    """The fused GAN epoch. Returns ``epoch(replay, generator,
    teacher_forcing, draws=None) -> FusedEpochMetrics``, which trains the
    policy and fills ``replay`` in place. Without the test split the test
    metrics are 0. ``mesh``: mesh mode over ``dp_axis`` (module
    docstring)."""
    data = _EpochData(expert_history_X, expert_future_Y, expert_history_X_test,
                      expert_future_Y_test, test_plan_batch, expert_dyn_windows,
                      expert_dyn_updates, batch_size, dynamics_updates)
    sizes = dict(num_envs=num_envs, batch_size=batch_size, critic_plan_batch=critic_plan_batch)
    if data.have_test:
        sizes["test_plan_batch"] = data.tX.shape[0]
    mesh = _check_mesh(mesh, dp_axis, chunk_updates, sizes)
    del chunk_updates, collect_chunk_steps  # nothing to bound (module docstring)

    def epoch(replay, generator: torch.Generator, teacher_forcing: bool,
              draws: Optional[FusedDraws] = None) -> FusedEpochMetrics:
        draws = draws if draws is not None else FusedDraws()
        streams = {name: split(generator) for name in GAN_STREAMS}
        ep_return = collect_episode(policy, env, env_params, normalizer, replay, num_envs,
                                    episode_steps, history, collect_noise, streams["collect"],
                                    draws.reset, draws.noise, mesh)

        dyn_perm, exp_perm = data.dynamics_draws(streams, replay, draws)
        dyn_loss = dynamics_steps(policy, optimizers["dynamics"], replay, dyn_perm, gamma,
                                  teacher_forcing, data.exp_windows, exp_perm, mesh)

        plan_idx = draws.plan_idx if draws.plan_idx is not None else tcritic.subset_indices(
            streams["critic_subset"], data.X.shape[0], critic_plan_batch)
        shuffle = draws.shuffle if draws.shuffle is not None else tcritic.permutation(
            streams["shuffle"], 2 * critic_plan_batch)
        seqs, labels = critic_dataset(policy, data.X, data.Y, plan_idx, shuffle, plan_chunk,
                                      mesh)
        crit_perm = draws.crit_perm if draws.crit_perm is not None else _randint(
            streams["critic_minibatches"], 2 * critic_plan_batch, (critic_updates, batch_size))
        crit_loss = float(tcritic.update_pass(policy.critic_model, optimizers["critic"], seqs,
                                              labels, crit_perm, mesh))

        gen_loss = cost_steps(policy, optimizers["cost"], gan_generator_loss, (data.X,),
                              data.cost_perm(streams, draws, cost_updates), False, polyak_factor,
                              mesh)
        crit_test, gen_test = gan_test_metrics(policy, data.tX, data.tY, plan_chunk, mesh) \
            if data.have_test else (0.0, 0.0)
        return FusedEpochMetrics(episode_return=ep_return, dynamics_loss=dyn_loss,
                                 critic_loss=crit_loss, generator_loss=gen_loss,
                                 critic_test_loss=crit_test, generator_test_loss=gen_test)

    return epoch


def make_fused_l2_epoch(
    policy,
    env,
    env_params,
    normalizer,
    optimizers: dict,  # {"dynamics": opt, "cost": opt}
    expert_history_X: torch.Tensor,
    expert_future_Y: torch.Tensor,
    *,
    num_envs: int,
    episode_steps: int,
    history: int,
    dynamics_updates: int,
    cost_updates: int,
    batch_size: int,
    gamma: float,
    polyak_factor: float,
    expert_history_X_test: Optional[torch.Tensor] = None,
    expert_future_Y_test: Optional[torch.Tensor] = None,
    test_plan_batch: int = 64,
    expert_dyn_windows=None,
    expert_dyn_updates: int = 0,
    chunk_updates: int = 0,
    plan_chunk: int = 0,
    collect_noise: float = 0.0,
    collect_chunk_steps: int = 0,
    mesh=None,
    dp_axis: str = "dp",
):
    """The fused L2-MPC epoch: collection, dynamics updates, L2 cost
    updates with the Polyak blend, the held-out L2 loss. Returns
    ``epoch(replay, generator, teacher_forcing, draws=None) ->
    FusedL2Metrics`` (``draws`` reads reset, noise, dyn_perm, exp_perm and
    cost_perm). ``mesh``: mesh mode over ``dp_axis`` (module docstring)."""
    mesh = _check_mesh(mesh, dp_axis, chunk_updates,
                       dict(num_envs=num_envs, batch_size=batch_size))
    del chunk_updates, collect_chunk_steps  # nothing to bound (module docstring)
    data = _EpochData(expert_history_X, expert_future_Y, expert_history_X_test,
                      expert_future_Y_test, test_plan_batch, expert_dyn_windows,
                      expert_dyn_updates, batch_size, dynamics_updates)

    def epoch(replay, generator: torch.Generator, teacher_forcing: bool,
              draws: Optional[FusedDraws] = None) -> FusedL2Metrics:
        draws = draws if draws is not None else FusedDraws()
        streams = {name: split(generator) for name in L2_STREAMS}
        ep_return = collect_episode(policy, env, env_params, normalizer, replay, num_envs,
                                    episode_steps, history, collect_noise, streams["collect"],
                                    draws.reset, draws.noise, mesh)
        dyn_perm, exp_perm = data.dynamics_draws(streams, replay, draws)
        dyn_loss = dynamics_steps(policy, optimizers["dynamics"], replay, dyn_perm, gamma,
                                  teacher_forcing, data.exp_windows, exp_perm, mesh)
        cost_loss = cost_steps(policy, optimizers["cost"], l2_imitation_loss, (data.X, data.Y),
                               data.cost_perm(streams, draws, cost_updates), True, polyak_factor,
                               mesh)
        cost_test = l2_test_metric(policy, data.tX, data.tY, plan_chunk) \
            if data.have_test else 0.0
        return FusedL2Metrics(episode_return=ep_return, dynamics_loss=dyn_loss,
                              cost_loss=cost_loss, cost_test_loss=cost_test)

    return epoch
