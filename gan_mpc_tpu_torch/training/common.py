"""Shared training utilities (``gan_mpc_tpu/training/common.py``), and
``split``, the generator counterpart of ``jax.random.split``."""

from __future__ import annotations

import torch


def discounted_sum(seq: torch.Tensor, gamma: float) -> torch.Tensor:
    """sum_t gamma^t * seq[t] along axis 0."""
    t = torch.arange(seq.shape[0], dtype=seq.dtype, device=seq.device)
    discounts = torch.pow(torch.as_tensor(gamma, dtype=seq.dtype, device=seq.device), t)
    return torch.tensordot(discounts, seq, dims=([0], [0]))


def split(generator: torch.Generator) -> torch.Generator:
    """A new CPU generator seeded from one draw of ``generator``: what the
    draw is used for cannot change the stream after it."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)
