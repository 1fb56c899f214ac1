"""Expert predictor: an autoregressive state-action sequence model.

Counterpart of ``ExpertPredictor``, ``_LSTMCell``, ``_MLPCell`` and
``_PredictionHeads`` in ``gan_mpc_tpu/models/expert.py``, batched over
sequences (a leading batch axis in place of ``jax.vmap``; the time scan
is a Python loop). Both archs: ``"lstm"`` (flax's OptimizedLSTMCell
trunk) and ``"mlp"`` (one relu Dense trunk). Per step the cell reads the
sequence's state (teacher forcing) or its own last prediction, and emits
the next state (residual on its input) and a tanh-squashed action.
Carries are tuples as in JAX: ``((c, h), x)`` for the LSTM, ``(x,)`` for
the MLP, the last entry the state the next step reads without teacher
forcing.
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


class MLPCell(nn.Module):
    """One expert step of the "mlp" arch: a relu Dense trunk of
    ``hidden[0]`` (flax ``Dense_0``), then the prediction heads
    (``_PredictionHeads_0``)."""

    def __init__(self, x_size: int, u_size: int, hidden: Sequence[int]):
        super().__init__()
        self.trunk = Dense(x_size, hidden[0])
        self.heads = PredictionHeads(hidden[0], x_size, u_size, hidden)

    def forward(self, x):
        y = torch.relu(x @ self.trunk.kernel + self.trunk.bias)
        return self.heads(y, x)


Carry = Tuple[torch.Tensor, ...]


class ExpertPredictor(nn.Module):
    """Batched expert: ``forward`` scans the cell over state sequences;
    ``warm_carry`` and ``generate`` serve the planner its goal states and
    warm-start actions."""

    def __init__(self, x_size: int, u_size: int, arch: str = "lstm",
                 features: int = 128, hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.x_size, self.u_size, self.arch, self.features = x_size, u_size, arch, features
        if arch == "lstm":
            self.cell = LSTMCell(x_size, u_size, features, hidden)
        elif arch == "mlp":
            self.cell = MLPCell(x_size, u_size, hidden)
        else:
            raise ValueError(f"unknown expert arch {arch!r}")

    def init_carry(self, x0: torch.Tensor) -> Carry:
        """The carry of fresh sequences starting at x0 (B, x)."""
        if self.arch == "lstm":
            zeros = x0.new_zeros((x0.shape[0], self.features))
            return ((zeros, zeros), x0)
        return (x0,)

    def step(self, carry: Carry, x: torch.Tensor):
        """One cell step reading ``x`` (B, x): (carry, next_x, u)."""
        if self.arch == "lstm":
            lstm_state, next_x, u = self.cell(carry[0], x)
            return (lstm_state, next_x), next_x, u
        next_x, u = self.cell(x)
        return (next_x,), next_x, u

    def forward(self, carry: Carry, xseq: torch.Tensor, teacher_forcing: bool):
        """Scan over xseq (B, T, x): with ``teacher_forcing`` each step reads
        the sequence's state, else the carry's last prediction. Returns
        (carry, (next_xseq (B, T, x), useq (B, T, u)))."""
        xs, us = [], []
        for t in range(xseq.shape[1]):
            carry, next_x, u = self.step(carry, xseq[:, t] if teacher_forcing else carry[-1])
            xs.append(next_x)
            us.append(u)
        if not xs:  # an empty sequence (the history of a single state)
            return carry, (xseq, xseq.new_zeros(xseq.shape[:2] + (self.u_size,)))
        return carry, (torch.stack(xs, dim=1), torch.stack(us, dim=1))

    def warm_carry(self, history_x: torch.Tensor) -> Carry:
        """Teacher-forced replay of history_x (B, h+1, x): the carry poised
        at the current state (the last row), which seeds generation."""
        carry = self.init_carry(history_x[:, 0])
        carry, _ = self(carry, history_x[:, :-1], True)
        return carry[:-1] + (history_x[:, -1],)

    def generate(self, carry: Carry, horizon: int):
        """Closed-loop rollout of the predicted future: goal states
        (B, horizon+1, x), with the current state first, and actions
        (B, horizon, u)."""
        x_now = carry[-1]
        placeholder = x_now.new_zeros((x_now.shape[0], horizon, self.x_size))
        _, (next_xs, us) = self(carry, placeholder, False)
        return torch.cat([x_now[:, None], next_xs], dim=1), us
