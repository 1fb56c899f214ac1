"""Outer (planner-level) imitation losses.

Counterpart of ``gan_mpc_tpu/policies/losses.py``, batched: a loss takes
the policy and a batch solution of ``MPCPolicy.plan`` and returns one
value per instance, (B,), which ``MPCPolicy.batched_loss`` averages. The
gradient reaches the parameters through the planner's implicit gradient.
The GAN generator and critic losses wait for the critic.
"""

from __future__ import annotations

import torch


def l2_imitation_loss(policy, sol, desired_xseq: torch.Tensor) -> torch.Tensor:
    """Sum over state dims of the time-mean squared distance between the
    planned states (B, H+1, x) and the expert's ``desired_xseq``: (B,)."""
    xseq = policy.planned_states(sol)
    return torch.sum(torch.mean((xseq - desired_xseq) ** 2, dim=1), dim=-1)
