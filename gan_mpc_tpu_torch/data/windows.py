"""Sliding-window datasets of the dynamics, cost and expert trainers.

Counterpart of ``cost_windows``, ``sequence_windows``,
``split_sequence_windows``, ``shuffle_and_split`` and ``minibatch_indices``
in ``gan_mpc_tpu/data/windows.py``: one gather per trajectory set, on the
trajectories' device. Random draws come from a ``torch.Generator``
(``jax.random`` cannot be reproduced in torch); the splits also take an
explicit permutation, so that tests can feed JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _window_indices(num_windows: int, width: int, device) -> torch.Tensor:
    return (torch.arange(num_windows, device=device)[:, None]
            + torch.arange(width, device=device)[None, :])


def cost_windows(states: torch.Tensor, history: int,
                 horizon: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost-training windows from (N, L, x) state trajectories: X (num,
    history + 1, x), the past up to and including "now", and Y (num,
    horizon + 1, x), "now" and the future, with num = N * (L - horizon -
    history). Trajectories are zero-padded at the front by ``history``."""
    n, length, x_size = states.shape
    padded = torch.cat([states.new_zeros((n, history, x_size)), states], dim=1)
    num = length - horizon - history
    starts = torch.arange(num, device=states.device) + history  # "now" in padded frame
    x_idx = starts[:, None] + torch.arange(history + 1, device=states.device) - history
    y_idx = starts[:, None] + torch.arange(horizon + 1, device=states.device)
    return (padded[:, x_idx].reshape(n * num, history + 1, x_size),
            padded[:, y_idx].reshape(n * num, horizon + 1, x_size))


def sequence_windows(
    states: torch.Tensor,
    actions: torch.Tensor,
    seqlen: int,
    start_oversample: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xseq, useq, next_xseq) windows from (N, L, ·) trajectories, each
    (N * (L - seqlen), seqlen, ·), trajectory-major. ``start_oversample >
    0`` repeats each trajectory's first ``seqlen`` windows that many extra
    times, as the JAX version does."""
    n, length, x_size = states.shape
    u_size = actions.shape[-1]
    num = length - seqlen
    idx = _window_indices(num, seqlen, states.device)
    if start_oversample > 0:
        early = idx[: min(seqlen, num)]
        idx = torch.cat([idx] + [early] * start_oversample, dim=0)
        num = idx.shape[0]
    X = states[:, idx].reshape(n * num, seqlen, x_size)
    U = actions[:, idx].reshape(n * num, seqlen, u_size)
    Y = states[:, idx + 1].reshape(n * num, seqlen, x_size)
    return X, U, Y


def _permutation(size: int, generator: Optional[torch.Generator],
                 perm: Optional[torch.Tensor]) -> torch.Tensor:
    if perm is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a permutation")
        perm = torch.randperm(size, generator=generator, device=generator.device)
    return perm


def split_sequence_windows(
    states: torch.Tensor,
    actions: torch.Tensor,
    seqlen: int,
    generator: Optional[torch.Generator] = None,
    start_oversample: int = 0,
    train_frac: float = 0.8,
    perm: Optional[torch.Tensor] = None,
):
    """Train/test split of the (xseq, useq, next_xseq) windows of (N, L, ·)
    trajectories, with the rest-start oversampling applied to the train
    split only: the window ids (trajectory-major) are split by ``perm``
    (else a permutation drawn from ``generator``), then the train side
    gains ``start_oversample`` extra copies of its early windows (those
    that start within the first ``seqlen`` steps of their trajectory), so
    that no copy of a trained window lands in the held-out split. Returns
    (train, test) tuples."""
    n, length, x_size = states.shape
    num = length - seqlen
    idx = _window_indices(num, seqlen, states.device)
    perm = _permutation(n * num, generator, perm).to(states.device)
    cut = int(n * num * train_frac)
    train_ids, test_ids = perm[:cut], perm[cut:]
    if start_oversample > 0:
        early_train = train_ids[train_ids % num < min(seqlen, num)]
        train_ids = torch.cat([train_ids] + [early_train] * start_oversample)

    def gather(ids):
        traj, widx = ids // num, idx[ids % num]
        return (states[traj[:, None], widx], actions[traj[:, None], widx],
                states[traj[:, None], widx + 1])

    return gather(train_ids), gather(test_ids)


def shuffle_and_split(
    dataset: tuple,
    generator: Optional[torch.Generator] = None,
    train_frac: float = 0.8,
    perm: Optional[torch.Tensor] = None,
):
    """Random shuffle and train/test split: ``perm`` if given, else a
    permutation drawn from ``generator``. Returns (train, test) tuples."""
    size = dataset[0].shape[0]
    perm = _permutation(size, generator, perm).to(dataset[0].device)
    cut = int(size * train_frac)
    train = tuple(d[perm[:cut]] for d in dataset)
    test = tuple(d[perm[cut:]] for d in dataset)
    return train, test


def minibatch_indices(
    generator: torch.Generator, datasize: int, steps: int, batch_size: int
) -> torch.Tensor:
    """(steps, batch) random index matrix, sampled with replacement, on
    the generator's device: one update pass's minibatches."""
    return torch.randint(datasize, (steps, batch_size), generator=generator,
                         device=generator.device)
