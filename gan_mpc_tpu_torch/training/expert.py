"""Expert predictor trainer.

Counterpart of ``gan_mpc_tpu/training/expert.py``: teacher-forced
sequence regression with a gamma-discounted squared error on both the
predicted next states and the actions; each epoch is one pass over
random minibatches (drawn with replacement) with clip-by-global-norm 100
and Adam (``masking.ClippedAdam``); teacher forcing stays on for the first
``num_epochs * teacher_forcing_factor`` epochs. The parameters live in the
model and are updated in place.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from gan_mpc_tpu_torch.data.windows import minibatch_indices
from gan_mpc_tpu_torch.training.common import discounted_sum


def expert_sequence_loss(model, xseq: torch.Tensor, useq: torch.Tensor,
                         next_xseq: torch.Tensor, gamma: float,
                         teacher_forcing: bool) -> torch.Tensor:
    """Mean over the batch (B, T, ·) of the discounted squared errors of
    both heads, each summed over its features."""
    _, (pred_next, pred_u) = model(model.init_carry(xseq[:, 0]), xseq, teacher_forcing)
    err_u = discounted_sum(((pred_u - useq) ** 2).transpose(0, 1), gamma)
    err_x = discounted_sum(((pred_next - next_xseq) ** 2).transpose(0, 1), gamma)
    return (err_u.sum(-1) + err_x.sum(-1)).mean()


def train_expert(
    model,
    optimizer,
    train_data: Tuple[torch.Tensor, ...],
    test_data: Tuple[torch.Tensor, ...],
    num_epochs: int,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    discount_factor: float = 0.9,
    teacher_forcing_factor: float = 0.7,
    log_every: int = 10,
    log_fn=print,
    indices: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[List[float], float]:
    """Train ``model`` with ``optimizer`` (a ``ClippedAdam`` over its
    parameters) for ``num_epochs`` epochs of ``max(N // batch_size, 1)``
    minibatch steps on ``train_data`` = (xseq, useq, next_xseq). Each
    epoch's (steps, batch) indices come from ``indices`` where given, else
    from ``generator``. Returns (the mean train loss of each epoch, the
    final test loss without teacher forcing)."""
    X, U, Y = train_data
    datasize = X.shape[0]
    steps = max(datasize // batch_size, 1)
    train_losses = []
    for ep in range(1, num_epochs + 1):
        idx = indices[ep - 1] if indices is not None else minibatch_indices(
            generator, datasize, steps, batch_size)
        tf = ep <= num_epochs * teacher_forcing_factor
        losses = []
        for p in idx.to(X.device):
            loss = expert_sequence_loss(model, X[p], U[p], Y[p], discount_factor, tf)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        train_losses.append(float(torch.stack(losses).mean()))
        if log_fn is not None and ep % log_every == 0:
            log_fn(f"[expert] epoch {ep} train_loss {train_losses[-1]:.4f} "
                   f"test_loss {held_out_loss(model, test_data, discount_factor):.4f}")
    return train_losses, held_out_loss(model, test_data, discount_factor)


@torch.no_grad()
def held_out_loss(model, test_data: Tuple[torch.Tensor, ...], discount_factor: float) -> float:
    """The held-out loss, without teacher forcing."""
    return float(expert_sequence_loss(model, *test_data, discount_factor, False))
