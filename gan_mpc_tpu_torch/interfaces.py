"""Structural typing contracts for the port's model zoo.

Counterpart of ``gan_mpc_tpu/interfaces.py``: the four
``runtime_checkable`` Protocols (any object with the right attributes and
methods conforms; no inheritance), stated with the port's batch-major
method names, on ``torch.nn.Module``s whose parameters live in the
module (the JAX methods take them as arguments).
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class CostModel(Protocol):
    """The planner's stage and terminal costs over a horizon, and their
    whole-horizon quadratization (``models/cost.MPCCost``)."""

    horizon: int

    def stage_cost_batch(self, X: torch.Tensor, U: torch.Tensor, t: torch.Tensor,
                         goal_tm: torch.Tensor,
                         goal_u_tm: Optional[torch.Tensor] = None) -> torch.Tensor: ...

    def terminal_cost_batch(self, X: torch.Tensor,
                            twice_differentiable: bool = False) -> torch.Tensor: ...

    def quad_batch(self, X: torch.Tensor, U: torch.Tensor, goal_tm: torch.Tensor,
                   goal_u_tm: Optional[torch.Tensor] = None): ...


@runtime_checkable
class DynamicsModel(Protocol):
    """The planner's dynamics on rows of the flat state xc = [x, carry]
    (a possibly width-0 recurrent carry) and actions
    (``models/dynamics.LearnedDynamics``, ``models/ensemble.EnsembleDynamics``)."""

    x_size: int
    carry_size: int

    def zero_carry(self, batch: int, device=None) -> torch.Tensor: ...

    def warm_carry(self, history_X: torch.Tensor, history_U: torch.Tensor) -> torch.Tensor: ...

    def batch_apply(self, X: torch.Tensor, U: torch.Tensor, compute_dtype=None,
                    twice_differentiable: bool = False) -> torch.Tensor: ...

    def batch_value_and_jac(self, X: torch.Tensor, U: torch.Tensor,
                            compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                         torch.Tensor]: ...


@runtime_checkable
class CriticModel(Protocol):
    """Sequence discriminator: (B, seq_len, x) -> (B,) realness scores
    (``models/critic.SequenceCritic``)."""

    def forward(self, xseq: torch.Tensor) -> torch.Tensor: ...


@runtime_checkable
class ExpertModel(Protocol):
    """Autoregressive expert predictor supplying plan-time goals
    (``models/expert.ExpertPredictor``)."""

    x_size: int
    u_size: int

    def warm_carry(self, history_x: torch.Tensor): ...

    def generate(self, carry, horizon: int) -> Tuple[torch.Tensor, torch.Tensor]: ...
