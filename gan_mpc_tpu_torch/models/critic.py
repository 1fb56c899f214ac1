"""Adversarial sequence critic (the GAN discriminator).

Counterpart of ``gan_mpc_tpu/models/critic.py``, batch-major: an LSTM
(flax's ``OptimizedLSTMCell``, zero initial carry) scans each (T, x)
state sequence of a (B, T, x) batch, and a relu MLP head maps the last
hidden output to one realness score per sequence. The time scan is a
Python loop, as in the expert; everything runs plain torch (no TPU kernel
serves the critic in the JAX package either).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gan_mpc_tpu_torch.models.expert import OptimizedLSTMCell
from gan_mpc_tpu_torch.ops.fused_mlp import Dense


class SequenceCritic(nn.Module):
    """(B, T, x) state sequences -> (B,) scores. Parameters in flax's
    order: the scanned cell (``ScanOptimizedLSTMCell_0``), then
    ``Dense_0..`` of the head, the last one to width 1."""

    def __init__(self, x_size: int, features: int = 64, hidden: Sequence[int] = (64,)):
        super().__init__()
        self.features = features
        self.lstm = OptimizedLSTMCell(x_size, features)
        widths = [features, *hidden, 1]
        self.head = nn.ModuleList(Dense(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, xseq: torch.Tensor) -> torch.Tensor:
        zeros = xseq.new_zeros((xseq.shape[0], self.features))
        carry, h = (zeros, zeros), zeros
        for t in range(xseq.shape[1]):
            carry, h = self.lstm(carry, xseq[:, t])
        for i, d in enumerate(self.head):
            h = h @ d.kernel + d.bias
            if i < len(self.head) - 1:
                h = torch.relu(h)
        return h[:, 0]
