"""GAN critic (discriminator) trainer.

Counterpart of ``gan_mpc_tpu/training/critic.py``: every call builds a
fresh labelled dataset by planning on expert histories with the current
generator (the planner): expert futures labelled +1, planned futures -1.
Then binary-cross-entropy updates, one optimizer step per row of a
(steps, batch) index matrix (the JAX ``lax.scan`` over minibatches is a
Python loop).

The JAX package plans with ``vmap(policy.plan)``; here one batch-major
``MPCPolicy.plan`` solves all histories at once, without gradients.
Parameters and optimizer state live in the policy and the optimizer and
are updated in place. Random draws (the ``plan_batch`` subset, the
dataset shuffles, the minibatches) come from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gan_mpc_tpu_torch.data.windows import minibatch_indices
from gan_mpc_tpu_torch.parallel.mesh import data_parallel_step
from gan_mpc_tpu_torch.policies.losses import critic_bce_loss


def permutation(generator: torch.Generator, n: int) -> torch.Tensor:
    """A random permutation of range(n), on the generator's device."""
    return torch.randperm(n, generator=generator, device=generator.device)


def subset_indices(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """``k`` distinct indices of range(n), drawn at random."""
    return permutation(generator, n)[:k]


@torch.no_grad()
def build_critic_dataset(policy, X: torch.Tensor, Y: torch.Tensor,
                         generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(histories X (N, h+1, x), expert futures Y (N, H+1, x)) -> shuffled
    (sequences (2N, H+1, x), labels (2N,)): Y labelled +1, the planned
    states from the same histories -1."""
    pred = policy.planned_states(policy.plan(X, warm_start_carry=False))
    n = Y.shape[0]
    seqs = torch.cat([Y, pred], dim=0)
    labels = torch.cat([torch.ones(n, device=Y.device), -torch.ones(n, device=Y.device)])
    perm = permutation(generator, 2 * n).to(Y.device)
    return seqs[perm], labels[perm]


def update_pass(critic_model, optimizer, seqs: torch.Tensor, labels: torch.Tensor,
                indices: torch.Tensor, mesh=None) -> torch.Tensor:
    """One optimizer step per row of ``indices`` (steps, batch); the mean
    loss (the JAX ``_update_scan``), as a device scalar. With a ``mesh``
    each rank takes its rows of every index row and the gradients and
    losses are averaged over the mesh (``data_parallel_step``)."""
    losses = []
    for p in indices.to(seqs.device):
        if mesh is not None:
            p = mesh.rows(p)
        losses.append(data_parallel_step(
            optimizer, lambda: critic_bce_loss(critic_model, seqs[p], labels[p]).mean(), mesh))
    return torch.stack(losses).mean()


@torch.no_grad()
def evaluate_critic_loss(critic_model, seqs: torch.Tensor, labels: torch.Tensor) -> float:
    return float(critic_bce_loss(critic_model, seqs, labels).mean())


def train_critic(
    policy,
    optimizer,
    true_train_data,
    true_test_data,
    num_updates: int,
    batch_size: int,
    generator: torch.Generator,
    plan_batch: int = 256,
) -> Tuple[List[float], List[float]]:
    """``num_updates`` update passes over a dataset planned from at most
    ``plan_batch`` training histories (a fresh random subset each call),
    each followed by the loss on a dataset planned from the first
    ``plan_batch`` held-out histories. Returns (train_losses,
    test_losses)."""
    Xtr, Ytr = true_train_data[0], true_train_data[1]
    if Xtr.shape[0] > plan_batch:
        idx = subset_indices(generator, Xtr.shape[0], plan_batch).to(Xtr.device)
        Xtr, Ytr = Xtr[idx], Ytr[idx]
    seqs, labels = build_critic_dataset(policy, Xtr, Ytr, generator)
    test_seqs, test_labels = build_critic_dataset(
        policy, true_test_data[0][:plan_batch], true_test_data[1][:plan_batch], generator)
    datasize = seqs.shape[0]
    steps = max(datasize // batch_size, 1)
    critic = policy.critic_model
    train_losses, test_losses = [], []
    for _ in range(num_updates):
        perm = minibatch_indices(generator, datasize, steps, batch_size)
        train_losses.append(float(update_pass(critic, optimizer, seqs, labels, perm)))
        test_losses.append(evaluate_critic_loss(critic, test_seqs, test_labels))
    return train_losses, test_losses
