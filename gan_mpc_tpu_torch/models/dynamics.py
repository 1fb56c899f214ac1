"""Learned residual dynamics: ``next_x = x + MLP([x, u])``.

Counterpart of ``ResidualMLPDynamicsNet`` and the batch hooks of
``LearnedDynamics`` in ``gan_mpc_tpu/models/dynamics.py``. The LSTM
dynamics net (a recurrent carry packed into the planner state) is not
ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gan_mpc_tpu_torch.ops.fused_mlp import (
    Dense,
    dense_stack,
    mlp_apply,
    mlp_value_and_jac,
)


class ResidualMLPDynamicsNet(nn.Module):
    """next_x = x + MLP([x, u]); carry-free (carry width 0)."""

    carry_size = 0

    def __init__(self, x_size: int, u_size: int,
                 hidden: Sequence[int] = (200, 200, 200)):
        super().__init__()
        self.x_size = x_size
        widths = [x_size + u_size, *hidden, x_size]
        self.layers = nn.ModuleList(
            Dense(a, b) for a, b in zip(widths[:-1], widths[1:])
        )

    def stack(self):
        return dense_stack(self.layers)


class LearnedDynamics(nn.Module):
    """Planner-facing wrapper around a dynamics net."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net
        self.x_size = net.x_size
        self.carry_size = net.carry_size

    @property
    def is_batch_native(self) -> bool:
        """True for the plain residual relu-MLP (no recurrent carry), the
        net the fused batch-major planner path supports."""
        return isinstance(self.net, ResidualMLPDynamicsNet) and self.carry_size == 0

    def batch_apply(self, X: torch.Tensor, U: torch.Tensor, compute_dtype=None,
                    twice_differentiable: bool = False):
        """next_x for (N, n) states and (N, m) actions in one fused call
        (``twice_differentiable`` as in ``mlp_apply``)."""
        z = torch.cat([X, U], dim=-1)
        return X + mlp_apply(z, self.net.stack(), compute_dtype, twice_differentiable)

    def batch_value_and_jac(self, X: torch.Tensor, U: torch.Tensor,
                            compute_dtype=None):
        """(next_x (N,n), A (N,n,n), B (N,n,m)) with the exact Jacobians
        of the relu MLP."""
        n = X.shape[-1]
        z = torch.cat([X, U], dim=-1)
        dx, J = mlp_value_and_jac(z, self.net.stack(), compute_dtype)
        A = J[..., :n] + torch.eye(n, dtype=X.dtype, device=X.device)
        return X + dx, A, J[..., n:]
