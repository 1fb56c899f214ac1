"""Ensemble dynamics: E independent dynamics nets, planned on their mean.

Counterpart of ``gan_mpc_tpu/models/ensemble.py``. The JAX package holds
the members' parameters stacked on a leading axis E and ``vmap``s one
net over them; here each member is a ``LearnedDynamics`` of its own, and
``params.dynamics_from_jax_params`` slices the stacked leaves. The
planner's dynamics are the member mean: ``batch_apply`` runs every
member's forward (on the card one ``fused_mlp_fwd`` launch each) and
averages, ``batch_value_and_jac`` averages the members' exact Jacobians,
which is the Jacobian of the mean. ``member_predict`` and
``disagreement`` (the per-dimension std across members, the epistemic
signal of ensemble world models) serve callers outside the planner.

As in the JAX package the ensemble is not batch native: the policy plans
it through the per-instance path (``policies/mpc.py``), which reads no
fused line-search step. Its members are relu MLPs, so the mean is
piecewise linear (``piecewise_linear``) and the implicit gradient keeps
its Gauss-Newton Hessian.

Training: a run from an empty workdir draws each member's weights on its
own (``params.init_flax_like`` walks the members in turn, as the JAX
``init`` splits one key per member). The dynamics trainer's loss is the
multi-step error of the members' mean (``training/dynamics.py``), as the
JAX package's code trains it; its module docstring speaks of members
updated on bootstrapped minibatches, which no JAX code does, and the port
follows the code. The phase optimizer clips one global norm over every
member's tensors, as ``optax.clip_by_global_norm`` does over the stacked
leaves.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics


class EnsembleDynamics(nn.Module):
    """The mean of ``len(nets)`` carry-free dynamics nets of one
    architecture (the residual MLPs ``runners.common.build_dynamics_model``
    builds; the JAX package builds no other ensemble)."""

    is_batch_native = False
    carry_size = 0
    piecewise_linear = True

    def __init__(self, nets: Sequence[nn.Module]):
        super().__init__()
        if any(net.carry_size for net in nets):
            raise NotImplementedError("an ensemble of recurrent dynamics nets is not ported")
        self.members = nn.ModuleList(LearnedDynamics(net) for net in nets)
        self.num_members = len(nets)
        self.x_size = nets[0].x_size

    def member_predict(self, X: torch.Tensor, U: torch.Tensor, compute_dtype=None,
                       twice_differentiable: bool = False) -> torch.Tensor:
        """(E, N, n) per-member next states of (N, n) rows and (N, m) actions."""
        return torch.stack([m.batch_apply(X, U, compute_dtype, twice_differentiable)
                            for m in self.members])

    def batch_apply(self, X, U, compute_dtype=None, twice_differentiable=False):
        """The ensemble-mean next state (the planner's dynamics)."""
        return self.member_predict(X, U, compute_dtype, twice_differentiable).mean(0)

    def batch_value_and_jac(self, X, U, compute_dtype=None):
        """(mean next state, mean A, mean B): the mean's exact Jacobians,
        summed member by member."""
        out = None
        for m in self.members:
            part = m.batch_value_and_jac(X, U, compute_dtype)
            out = list(part) if out is None else [a + b for a, b in zip(out, part)]
        return tuple(t / self.num_members for t in out)

    def disagreement(self, X, U) -> torch.Tensor:
        """(N, x) std across members of the predicted states (the JAX
        ``jnp.std``: population std)."""
        preds = self.member_predict(X, U)[..., : self.x_size]
        return preds.std(0, unbiased=False)

    def zero_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros((batch, 0), device=device)

    def warm_carry(self, history_X: torch.Tensor, history_U: torch.Tensor) -> torch.Tensor:
        """The members are carry-free: a zero-width carry, as the JAX
        ``warm_carry`` returns for them."""
        return self.zero_carry(history_X.shape[0], history_X.device)
