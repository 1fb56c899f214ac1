"""Learned dynamics for the planner.

Counterpart of ``gan_mpc_tpu/models/dynamics.py``, batch-major:

  * ``ResidualMLPDynamicsNet``: ``next_x = x + MLP([x, u])``, carry-free;
  * ``LSTMDynamicsNet``: flax's ``OptimizedLSTMCell`` on ``[x, u]`` and a
    relu MLP head from its output to dx, the recurrent state packed into
    the planner state ``xc = [x, h, c]`` so that the linearization
    differentiates through the recurrence;
  * ``LearnedDynamics``, the planner-facing wrapper: the batch hooks
    ``batch_apply`` and ``batch_value_and_jac`` on (N, n) rows, and the
    carry utilities ``zero_carry`` and ``warm_carry`` (the history replayed
    through the cell from a zero carry).

Every MLP forward goes through ``mlp_apply`` (on the card the fused
kernel). The Jacobians: the relu MLP's exact masked weight products
(``mlp_value_and_jac``); the LSTM cell's by ``torch.func.jacrev`` on the
plain cell, chained with its head's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gan_mpc_tpu_torch.models.expert import OptimizedLSTMCell
from gan_mpc_tpu_torch.ops.fused_mlp import (
    Dense,
    dense_stack,
    mlp_apply,
    mlp_value_and_jac,
)


def _mlp_layers(widths):
    return nn.ModuleList(Dense(a, b) for a, b in zip(widths[:-1], widths[1:]))


class ResidualMLPDynamicsNet(nn.Module):
    """next_x = x + MLP([x, u]); carry-free (carry width 0). A relu MLP:
    piecewise linear in (x, u)."""

    carry_size = 0
    piecewise_linear = True

    def __init__(self, x_size: int, u_size: int,
                 hidden: Sequence[int] = (200, 200, 200)):
        super().__init__()
        self.x_size = x_size
        self.layers = _mlp_layers([x_size + u_size, *hidden, x_size])

    def stack(self):
        return dense_stack(self.layers)

    def batch_apply(self, X, U, compute_dtype=None, twice_differentiable=False):
        z = torch.cat([X, U], dim=-1)
        return X + mlp_apply(z, self.stack(), compute_dtype, twice_differentiable)

    def batch_value_and_jac(self, X, U, compute_dtype=None):
        n = X.shape[-1]
        dx, J = mlp_value_and_jac(torch.cat([X, U], dim=-1), self.stack(), compute_dtype)
        A = J[..., :n] + torch.eye(n, dtype=X.dtype, device=X.device)
        return X + dx, A, J[..., n:]


class LSTMDynamicsNet(nn.Module):
    """LSTM-backed residual dynamics with the carry packed into xc =
    [x (x_size), h (features), c (features)]. Parameters in flax's order:
    the cell (``OptimizedLSTMCell_0``), then the head ``Dense_0..``. The
    cell's sigmoids and tanhs curve: not piecewise linear."""

    piecewise_linear = False

    def __init__(self, x_size: int, u_size: int, features: int = 64,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.x_size, self.features = x_size, features
        self.carry_size = 2 * features
        self.cell = OptimizedLSTMCell(x_size + u_size, features)
        self.layers = _mlp_layers([features, *hidden, x_size])

    def stack(self):
        return dense_stack(self.layers)

    def cell_step(self, X, U):
        """The cell on rows of xc (..., n) and u: (h', c')."""
        xs, f = self.x_size, self.features
        h, c = X[..., xs:xs + f], X[..., xs + f:]
        (c2, h2), _ = self.cell((c, h), torch.cat([X[..., :xs], U], dim=-1))
        return h2, c2

    def batch_apply(self, X, U, compute_dtype=None, twice_differentiable=False):
        h2, c2 = self.cell_step(X, U)
        dx = mlp_apply(h2, self.stack(), compute_dtype, twice_differentiable)
        return torch.cat([X[:, :self.x_size] + dx, h2, c2], dim=-1)

    def batch_value_and_jac(self, X, U, compute_dtype=None):
        xs, f = self.x_size, self.features
        n = X.shape[-1]

        def hc(x, u):
            return torch.cat(self.cell_step(x, u), dim=-1)

        Jx, Ju = torch.func.vmap(torch.func.jacrev(hc, argnums=(0, 1)))(X, U)
        h2, c2 = self.cell_step(X, U)
        dx, Jh = mlp_value_and_jac(h2, self.stack(), compute_dtype)  # Jh (N, xs, f)
        eye = torch.eye(xs, n, dtype=X.dtype, device=X.device)
        A = torch.cat([eye + Jh @ Jx[:, :f], Jx], dim=1)
        Bm = torch.cat([Jh @ Ju[:, :f], Ju], dim=1)
        return torch.cat([X[:, :xs] + dx, h2, c2], dim=-1), A, Bm


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

    @property
    def piecewise_linear(self) -> bool:
        """Whether the next state is piecewise linear in (xc, u), so that
        a rollout's second derivative vanishes almost everywhere and the
        Gauss-Newton product of the planner's linearization is the exact
        Hessian (``planner/bilevel.py``)."""
        return self.net.piecewise_linear

    def batch_apply(self, X: torch.Tensor, U: torch.Tensor, compute_dtype=None,
                    twice_differentiable: bool = False):
        """next xc for (N, n) states and (N, m) actions, every MLP through
        one fused call (``twice_differentiable`` as in ``mlp_apply``)."""
        return self.net.batch_apply(X, U, compute_dtype, twice_differentiable)

    def batch_value_and_jac(self, X: torch.Tensor, U: torch.Tensor,
                            compute_dtype=None):
        """(next xc (N,n), A (N,n,n), B (N,n,m)) with exact Jacobians."""
        return self.net.batch_value_and_jac(X, U, compute_dtype)

    def zero_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros((batch, self.carry_size), device=device)

    def warm_carry(self, history_X: torch.Tensor, history_U: torch.Tensor) -> torch.Tensor:
        """The carry (B, carry) after replaying the (x, u) history
        (B, h, x), (B, h, u) through the cell from a zero carry (the JAX
        ``warm_carry``, which runs the whole net and keeps the carry; the
        head's output is not needed, so it is not run)."""
        carry = self.zero_carry(history_X.shape[0], history_X.device)
        if self.carry_size == 0:
            return carry
        for t in range(history_X.shape[1]):
            h, c = self.net.cell_step(torch.cat([history_X[:, t], carry], -1), history_U[:, t])
            carry = torch.cat([h, c], -1)
        return carry
