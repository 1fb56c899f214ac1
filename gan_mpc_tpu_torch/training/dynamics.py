"""On-policy dynamics model trainer.

Counterpart of ``gan_mpc_tpu/training/dynamics.py``:

  * multi-step prediction loss: unroll the learned dynamics over a window,
    open- or closed-loop by the teacher-forcing switch, discounted squared
    error summed over time and features. Batched over the windows: each
    time step is one ``batch_apply`` of the dynamics over the minibatch
    (a residual MLP, an LSTM net with its carry threaded through, or an
    ensemble's member mean), so on the card each MLP forward is the fused
    MLP kernel and its gradient the fused backward kernel (an ensemble's
    E members launch E of each a step);
  * one optimizer step per row of a (steps, batch) index matrix (the JAX
    ``lax.scan`` over minibatches is a Python loop);
  * warm-start updates on the expert dataset at the first epoch, then
    ``expert_updates``, then on-policy episodes into the replay buffer.

Parameters and optimizer state live in the model and the optimizer and
are updated in place (JAX threads them through and returns them).
Random draws come from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
from gan_mpc_tpu_torch.data.windows import minibatch_indices
from gan_mpc_tpu_torch.parallel.mesh import data_parallel_step
from gan_mpc_tpu_torch.training.common import discounted_sum


def multistep_prediction_loss(dynamics_model, xseq, useq, next_xseq, gamma: float,
                              teacher_forcing: bool) -> torch.Tensor:
    """Discounted multi-step prediction error of each (seqlen, ·) window:
    xseq, next_xseq (B, T, x), useq (B, T, u) -> (B,).

    The unroll runs on the planner state xc = [x, carry] from the
    dynamics' zero carry. Teacher forcing replaces x by the window's own
    state; the carry always threads on from the prediction. The error is
    taken on x. For an ensemble the prediction is the members' mean (its
    ``batch_apply``), so the loss trains the mean, as the JAX package's
    does."""
    xs = xseq.shape[-1]
    x = xseq[:, 0]
    carry = dynamics_model.zero_carry(xseq.shape[0], xseq.device)
    preds = []
    for t in range(xseq.shape[1]):
        xc = torch.cat([xseq[:, t] if teacher_forcing else x, carry], dim=-1)
        next_xc = dynamics_model.batch_apply(xc, useq[:, t])
        x, carry = next_xc[:, :xs], next_xc[:, xs:]
        preds.append(x)
    err = (torch.stack(preds) - next_xseq.transpose(0, 1)) ** 2  # (T, B, x)
    return discounted_sum(err, gamma).sum(-1)


def update_pass(dynamics_model, optimizer, dataset, indices: torch.Tensor, gamma: float,
                teacher_forcing: bool, mesh=None) -> torch.Tensor:
    """One optimizer step per row of ``indices`` (steps, batch) on the
    windows it picks from ``dataset`` = (X, U, Y); the mean loss (the JAX
    ``_update_scan``), as a device scalar. With a ``mesh``
    (``parallel/mesh.py``) each rank takes its rows of every index row
    and the gradients and losses are averaged over the mesh
    (``data_parallel_step``)."""
    X, U, Y = dataset
    losses = []
    for p in indices.to(X.device):
        if mesh is not None:
            p = mesh.rows(p)
        losses.append(data_parallel_step(optimizer, lambda: multistep_prediction_loss(
            dynamics_model, X[p], U[p], Y[p], gamma, teacher_forcing).mean(), mesh))
    return torch.stack(losses).mean()


def _run_updates(dynamics_model, optimizer, dataset, num_updates: int, batch_size: int,
                 gamma: float, teacher_forcing_factor: float, generator: torch.Generator,
                 update_offset: int = 0) -> List[float]:
    datasize = dataset[0].shape[0]
    steps = max(datasize // batch_size, 1)
    losses = []
    for up in range(1, num_updates + 1):
        perm = minibatch_indices(generator, datasize, steps, batch_size)
        tf = (update_offset + up) <= num_updates * teacher_forcing_factor
        loss = update_pass(dynamics_model, optimizer, dataset, perm, gamma, tf)
        losses.append(float(loss))
    return losses


def train_dynamics(
    dynamics_model,
    optimizer,
    expert_dataset,
    replay_buffer: ReplayBuffer,
    collect_fn: Callable,
    normalizer,
    num_episodes: int,
    num_updates: int,
    batch_size: int,
    discount_factor: float,
    teacher_forcing_factor: float,
    generator: torch.Generator,
    epoch: int,
    warm_start_updates: int = 3,
    expert_updates: int = 0,
):
    """One epoch of on-policy dynamics training.

    ``collect_fn(generator) -> EpisodeData`` runs the policy whose
    ``dynamics_model`` is being trained (its planning runs without
    gradients), possibly batched over envs (states (B, T, x)).

    Returns (replay_buffer, episode_returns, losses).
    """
    losses = []
    if epoch == 1 and warm_start_updates > 0:
        losses += _run_updates(
            dynamics_model, optimizer, expert_dataset, warm_start_updates, batch_size,
            discount_factor, 1.0, generator,
        )
    if expert_updates > 0:
        # keep refreshing on the expert distribution every epoch (the JAX
        # trainer's reason: pure on-policy data collapses the model onto
        # wherever the early policy visits)
        losses += _run_updates(
            dynamics_model, optimizer, expert_dataset, expert_updates, batch_size,
            discount_factor, 1.0, generator,
        )

    episode_returns = []
    for ep in range(num_episodes):
        episode = collect_fn(generator)
        states, actions = episode.states, episode.actions
        if states.dim() == 2:  # single env -> add batch axis for windowing
            states, actions = states[None], actions[None]
        episode_returns.append(float(episode.rewards.sum(-1).mean()))
        replay_buffer.add_trajectories(
            normalizer.normalize_state(states), normalizer.normalize_action(actions)
        )
        take = min(max(replay_buffer.size, 1), replay_buffer.capacity)
        dataset = (
            replay_buffer.states[:take],
            replay_buffer.actions[:take],
            replay_buffer.next_states[:take],
        )
        losses += _run_updates(
            dynamics_model, optimizer, dataset, num_updates, batch_size, discount_factor,
            teacher_forcing_factor * num_episodes, generator, update_offset=num_updates * ep,
        )
    return replay_buffer, episode_returns, losses
