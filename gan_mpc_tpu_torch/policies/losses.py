"""Outer (planner-level) losses.

Counterpart of ``gan_mpc_tpu/policies/losses.py``, batched: a planner
loss takes the policy and a batch solution of ``MPCPolicy.plan`` and
returns one value per instance, (B,), which ``MPCPolicy.batched_loss``
averages. The gradient reaches the parameters through the planner's
implicit gradient.

  * ``l2_imitation_loss``: planned states against the expert's;
  * ``gan_generator_loss``: the non-saturating JS generator loss, the
    critic's score of the planned states;
  * ``critic_bce_loss``: the critic's loss on +-1-labelled sequences.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def l2_imitation_loss(policy, sol, desired_xseq: torch.Tensor) -> torch.Tensor:
    """Sum over state dims of the time-mean squared distance between the
    planned states (B, H+1, x) and the expert's ``desired_xseq``: (B,)."""
    xseq = policy.planned_states(sol)
    return torch.sum(torch.mean((xseq - desired_xseq) ** 2, dim=1), dim=-1)


def gan_generator_loss(policy, sol, *unused_args) -> torch.Tensor:
    """-log p + log(1 - p) of the critic's p = sigmoid(score) on the
    planned states: (B,). The targets a caller passes are not read."""
    p = torch.sigmoid(policy.critic_model(policy.planned_states(sol)))
    return -torch.log(p + _EPS) + torch.log(1.0 - p + _EPS)


def critic_bce_loss(critic_model, xseq: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """-log sigmoid(score) for label +1, -log(1 - sigmoid(score)) for -1,
    per sequence of xseq (B, T, x): (B,)."""
    p = torch.sigmoid(critic_model(xseq))
    p = torch.where(label > 0, p, 1.0 - p)
    return -torch.log(p + _EPS)
