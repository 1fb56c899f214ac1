"""Per-phase optimizers over the policy's components.

Counterpart of ``gan_mpc_tpu/training/masking.py``. There, each training
phase owns one optax optimizer over the whole parameter dict, with the
components it must not touch routed to ``set_to_zero``. Here a phase's
optimizer holds only the parameters of the components it trains, which
amounts to the same: the others get no update. Ported: the phase chain
``clip_by_global_norm(max_grad_norm)`` then Adam (b1 0.9, b2 0.999, eps
1e-8; ``torch.optim.Adam`` has optax's update formula), and
``polyak_blend``. The separate Adam rate for the MPC weights
(``weights_learning_rate``, the cost phase's) is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import torch
from torch import nn


def policy_components(policy: nn.Module) -> Dict[str, List[torch.Tensor]]:
    """The JAX parameter dict's top-level components, as lists of the
    port policy's parameters (the critic is not ported)."""
    return {
        "mpc_weights": [policy.cost_model.weights],
        "cost_params": list(policy.cost_model.net.parameters()),
        "dynamics_params": list(policy.dynamics_model.parameters()),
        "expert_params": list(policy.expert_model.parameters()),
    }


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` over
    ``params``. ``clip_grad_norm_`` divides by norm + 1e-6 where optax
    divides by the norm; the difference is far below float32 rounding of
    the update at a clip of 100."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 max_grad_norm: float = 100.0):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        torch.nn.utils.clip_grad_norm_(self.params, self.max_grad_norm)
        self.adam.step()


def masked_adam(components: Mapping[str, List[torch.Tensor]], no_grads: Iterable[str],
                learning_rate: float, max_grad_norm: float = 100.0) -> ClippedAdam:
    """The phase optimizer over every component except those named in
    ``no_grads``; switches gradients on for the parameters it trains."""
    frozen = set(no_grads)
    unknown = frozen - set(components)
    if unknown:
        raise ValueError(f"no_grads names unknown components: {sorted(unknown)}")
    params = [p for name, ps in components.items() if name not in frozen for p in ps]
    for p in params:
        p.requires_grad_(True)
    return ClippedAdam(params, learning_rate, max_grad_norm)


def polyak_blend(old: Mapping[str, torch.Tensor], new: Mapping[str, torch.Tensor],
                 factor: float) -> Dict[str, torch.Tensor]:
    """``factor * old + (1 - factor) * new`` per entry, computed as
    ``old + (1 - factor) * (new - old)``, exact where ``new == old``."""
    return {k: old[k] + (1.0 - factor) * (new[k] - old[k]) for k in old}
