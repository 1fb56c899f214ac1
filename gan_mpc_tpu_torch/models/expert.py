"""Expert predictor: an autoregressive state-action sequence model.

Counterpart of ``ExpertPredictor`` (``arch="lstm"``), ``_LSTMCell`` and
``_PredictionHeads`` in ``gan_mpc_tpu/models/expert.py``, batched over
envs (a leading batch axis in place of ``jax.vmap``; the time scan is a
Python loop). The ``"mlp"`` arch is not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from gan_mpc_tpu_torch.ops.fused_mlp import Dense, reference_forward

GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    """flax.linen's OptimizedLSTMCell: carry (c, h); gates i, f, g, o from
    input kernels ``i*`` (no bias) plus hidden kernels ``h*`` (with bias);
    c' = f c + i g, h' = o tanh(c')."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        self.features = features
        for gate in GATES:
            self.register_parameter(
                f"i{gate}", nn.Parameter(torch.zeros(in_size, features))
            )
            self.register_parameter(
                f"h{gate}", nn.Parameter(torch.zeros(features, features))
            )
            self.register_parameter(
                f"h{gate}_bias", nn.Parameter(torch.zeros(features))
            )

    def forward(self, carry, x):
        c, h = carry
        w_h = torch.cat([getattr(self, f"h{g}") for g in GATES], dim=-1)
        b_h = torch.cat([getattr(self, f"h{g}_bias") for g in GATES], dim=-1)
        w_i = torch.cat([getattr(self, f"i{g}") for g in GATES], dim=-1)
        dh = (h @ w_h + b_h).split(self.features, dim=-1)
        di = (x @ w_i).split(self.features, dim=-1)
        i = torch.sigmoid(dh[0] + di[0])
        f = torch.sigmoid(dh[1] + di[1])
        g = torch.tanh(dh[2] + di[2])
        o = torch.sigmoid(dh[3] + di[3])
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class PredictionHeads(nn.Module):
    """Trunk feature y (and input state x) -> (next_x, u). Layers in flax
    creation order: ``Dense_0..2`` the state head, ``Dense_3..5`` the
    action head."""

    def __init__(self, in_size: int, x_size: int, u_size: int,
                 hidden: Sequence[int]):
        super().__init__()
        xw = [in_size, *hidden, x_size]
        uw = [in_size, *hidden, u_size]
        self.layers = nn.ModuleList(
            [Dense(a, b) for a, b in zip(xw[:-1], xw[1:])]
            + [Dense(a, b) for a, b in zip(uw[:-1], uw[1:])]
        )
        self._split = len(xw) - 1

    def forward(self, y, x):
        layers = [(d.kernel, d.bias) for d in self.layers]
        next_x = reference_forward(y, layers[: self._split]) + x
        u = torch.tanh(reference_forward(y, layers[self._split :]))
        return next_x, u


class LSTMCell(nn.Module):
    """One expert step: the LSTM trunk, then the prediction heads."""

    def __init__(self, x_size: int, u_size: int, features: int,
                 hidden: Sequence[int]):
        super().__init__()
        self.lstm = OptimizedLSTMCell(x_size, features)
        self.heads = PredictionHeads(features, x_size, u_size, hidden)

    def forward(self, lstm_state, x):
        lstm_state, y = self.lstm(lstm_state, x)
        next_x, u = self.heads(y, x)
        return lstm_state, next_x, u


Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]


class ExpertPredictor(nn.Module):
    """Batched LSTM expert: warm a carry on the observed history, then
    generate the goal states and warm-start actions for the planner."""

    def __init__(self, x_size: int, u_size: int, arch: str = "lstm",
                 features: int = 128, hidden: Sequence[int] = (128, 128)):
        super().__init__()
        if arch != "lstm":
            raise NotImplementedError(f"expert arch {arch!r} is not ported")
        self.x_size, self.u_size, self.features = x_size, u_size, features
        self.cell = LSTMCell(x_size, u_size, features, hidden)

    def warm_carry(self, history_x: torch.Tensor) -> Carry:
        """Teacher-forced replay of history_x (B, h+1, x): the carry poised
        at the current state (the last row), which seeds generation."""
        B = history_x.shape[0]
        zeros = history_x.new_zeros((B, self.features))
        state = (zeros, zeros)
        for t in range(history_x.shape[1] - 1):
            state, _, _ = self.cell(state, history_x[:, t])
        return state, history_x[:, -1]

    def generate(self, carry: Carry, horizon: int):
        """Closed-loop rollout of the predicted future: goal states
        (B, horizon+1, x), with the current state first, and actions
        (B, horizon, u)."""
        state, x = carry
        xs, us = [x], []
        for _ in range(horizon):
            state, x, u = self.cell(state, x)
            xs.append(x)
            us.append(u)
        return torch.stack(xs, dim=1), torch.stack(us, dim=1)
