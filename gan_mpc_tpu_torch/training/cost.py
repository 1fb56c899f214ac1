"""Bilevel cost trainer.

Counterpart of ``gan_mpc_tpu/training/cost.py``: optimize the cost net
and the (sigmoid-squashed) MPC weights so that planning with them
reproduces expert futures. One optimizer step per row of a (steps, batch)
index matrix (the JAX ``lax.scan`` over minibatches is a Python loop); the
gradient goes through the planner by the implicit gradient
(``MPCPolicy.batched_loss``, ``planner/bilevel.py``). After the updates
every parameter is Polyak-blended back toward its value before them.

Parameters and optimizer state live in the policy and the optimizer and
are updated in place (JAX threads them through and returns them).
Gradients are taken for the parameters that require one; the phase
optimizer (``masking.masked_adam``) steps its own. Minibatches are drawn
from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from gan_mpc_tpu_torch.data.windows import minibatch_indices
from gan_mpc_tpu_torch.parallel.mesh import data_parallel_step
from gan_mpc_tpu_torch.training.masking import policy_components, polyak_blend

MAX_EVAL_WINDOWS = 256


def update_pass(policy, optimizer, loss_fn: Callable, dataset, indices: torch.Tensor,
                has_targets: bool = True, mesh=None) -> torch.Tensor:
    """One optimizer step per row of ``indices`` (steps, batch) on the
    history windows it picks from ``dataset`` = (X, Y) (Y the targets);
    the mean loss (the JAX ``_update_scan``), as a device scalar. With a
    ``mesh`` each rank takes its rows of every index row and the gradients
    and losses are averaged over the mesh (``data_parallel_step``)."""
    X = dataset[0]
    losses = []
    for p in indices.to(X.device):
        if mesh is not None:
            p = mesh.rows(p)
        args = (dataset[1][p],) if has_targets else ()
        losses.append(data_parallel_step(
            optimizer, lambda: policy.batched_loss(X[p], loss_fn, args), mesh))
    return torch.stack(losses).mean()


@torch.no_grad()
def blend_back(params: List[torch.Tensor], prev: List[torch.Tensor], polyak_factor: float) -> None:
    """Polyak-blend each of ``params`` back toward ``prev``, its value
    before the updates, in place."""
    blended = polyak_blend(dict(enumerate(prev)), {i: p.detach() for i, p in enumerate(params)},
                           polyak_factor)
    for i, p in enumerate(params):
        p.copy_(blended[i])


@torch.no_grad()
def evaluate_cost_loss(policy, loss_fn: Callable, dataset, has_targets: bool = True,
                       eval_windows: Optional[int] = None) -> float:
    """Planning loss on at most ``eval_windows`` (default 256) windows of a
    held-out set, without gradients: each window is a planner solve."""
    cap = MAX_EVAL_WINDOWS if eval_windows is None else eval_windows
    args = (dataset[1][:cap],) if has_targets else ()
    sol = policy.plan(dataset[0][:cap], warm_start_carry=False)
    return float(loss_fn(policy, sol, *args).mean())


def train_cost(
    policy,
    optimizer,
    train_data,
    test_data,
    loss_fn: Callable,
    num_updates: int,
    batch_size: int,
    polyak_factor: float,
    generator: torch.Generator,
    has_targets: bool = True,
    eval_test: bool = True,
    eval_windows: Optional[int] = None,
    max_steps_per_update: Optional[int] = None,
) -> Tuple[List[float], List[float]]:
    """``num_updates`` update passes of min(datasize // batch_size,
    ``max_steps_per_update``) minibatch steps, each followed by the test
    loss, then the Polyak blend. Returns (train_losses, test_losses)."""
    params = [p for ps in policy_components(policy).values() for p in ps]
    prev = [p.detach().clone() for p in params]
    datasize = train_data[0].shape[0]
    steps = max(datasize // batch_size, 1)
    if max_steps_per_update is not None:
        steps = min(steps, max_steps_per_update)
    train_losses, test_losses = [], []
    for _ in range(num_updates):
        perm = minibatch_indices(generator, datasize, steps, batch_size)
        train_losses.append(float(update_pass(policy, optimizer, loss_fn, train_data, perm,
                                              has_targets)))
        if eval_test:
            test_losses.append(evaluate_cost_loss(policy, loss_fn, test_data, has_targets,
                                                  eval_windows))
    blend_back(params, prev, polyak_factor)
    return train_losses, test_losses
