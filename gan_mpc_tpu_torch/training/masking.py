"""Per-phase optimizers over the policy's components.

Counterpart of ``gan_mpc_tpu/training/masking.py``. There, each training
phase owns one optax optimizer over the whole parameter dict, with the
components it must not touch routed to ``set_to_zero``. Here a phase's
optimizer holds only the parameters of the components it trains, which
amounts to the same: the others get no update. Each group of the phase's
``optax.multi_transform`` is the chain ``clip_by_global_norm(max_grad_norm)``
then Adam (b1 0.9, b2 0.999, eps 1e-8; ``torch.optim.Adam`` has optax's
update formula), clipped over its own parameters only: "learn", and with
``weights_learning_rate`` (the cost phase's) "weights", the MPC weights at
a rate of their own. Also ``polyak_blend``, and ``policy_state`` /
``load_policy_state``, the copy of every component's tensors that the
runners keep as a model-selection candidate and checkpoint.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


def policy_components(policy: nn.Module) -> Dict[str, List[torch.Tensor]]:
    """The JAX parameter dict's top-level components, as lists of the
    port policy's parameters; ``critic_params`` where the policy has a
    critic."""
    comps = {
        "mpc_weights": [policy.cost_model.weights],
        "cost_params": list(policy.cost_model.net.parameters()),
        "dynamics_params": list(policy.dynamics_model.parameters()),
        "expert_params": list(policy.expert_model.parameters()),
    }
    if getattr(policy, "critic_model", None) is not None:
        comps["critic_params"] = list(policy.critic_model.parameters())
    return comps


def policy_state(policy: nn.Module) -> Dict[str, List[torch.Tensor]]:
    """Detached copies of every component's tensors (``policy_components``
    order): a value that later training does not change."""
    return {name: [p.detach().clone() for p in ps]
            for name, ps in policy_components(policy).items()}


def set_mpc_weights(policy: nn.Module, weights: torch.Tensor) -> None:
    """Install ``weights`` as the policy's raw MPC weights: a new parameter,
    since their number may change (calibration appends the gain)."""
    old = policy.cost_model.weights
    policy.cost_model.weights = nn.Parameter(weights.detach().clone().to(old.device),
                                             requires_grad=old.requires_grad)


@torch.no_grad()
def load_policy_state(policy: nn.Module, state: Mapping[str, List[torch.Tensor]]) -> None:
    """Copy ``state`` (a ``policy_state``) into the policy's own tensors, in
    place, so that the phase optimizers keep holding them. Only the MPC
    weights may change length: they are then installed anew
    (``set_mpc_weights``)."""
    for name, ps in policy_components(policy).items():
        if len(state[name]) != len(ps):
            raise ValueError(f"{name}: {len(state[name])} tensors for {len(ps)}")
        for p, q in zip(ps, state[name]):
            if p.shape == q.shape:
                p.copy_(q)
            elif name == "mpc_weights":
                set_mpc_weights(policy, q)
            else:
                raise ValueError(f"{name}: shape {tuple(q.shape)} for {tuple(p.shape)}")


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` per
    group of ``groups`` = [(params, learning_rate), ...], each group's norm
    over its own parameters. ``clip_grad_norm_`` divides by norm + 1e-6
    where optax divides by the norm; the difference is far below float32
    rounding of the update at a clip of 100."""

    def __init__(self, groups: Sequence[Tuple[Iterable[torch.Tensor], float]],
                 max_grad_norm: float = 100.0):
        self.groups = [(list(ps), lr) for ps, lr in groups]
        self.params = [p for ps, _ in self.groups for p in ps]
        self.max_grad_norm = max_grad_norm
        self.adam = torch.optim.Adam([{"params": ps, "lr": lr} for ps, lr in self.groups],
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for ps, _ in self.groups:
            torch.nn.utils.clip_grad_norm_(ps, self.max_grad_norm)
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Adam's moments and step counts, group by group (the groups are
        rebuilt by ``masked_adam`` in the same order)."""
        self.adam.load_state_dict(state)


def masked_adam(components: Mapping[str, List[torch.Tensor]], no_grads: Iterable[str],
                learning_rate: float, max_grad_norm: float = 100.0,
                weights_learning_rate: Optional[float] = None) -> ClippedAdam:
    """The phase optimizer over every component except those named in
    ``no_grads``; switches gradients on for the parameters it trains.
    ``weights_learning_rate`` gives ``mpc_weights`` an Adam of its own
    (the JAX reason: their gradients through the implicit planner are
    orders of magnitude smaller than the nets')."""
    frozen = set(no_grads)
    unknown = frozen - set(components)
    if unknown:
        raise ValueError(f"no_grads names unknown components: {sorted(unknown)}")
    apart = set() if weights_learning_rate is None else {"mpc_weights"} - frozen
    learn = [p for name, ps in components.items() if name not in frozen | apart for p in ps]
    groups = [(learn, learning_rate)] + [
        (components[name], weights_learning_rate) for name in apart
    ]
    for ps, _ in groups:
        for p in ps:
            p.requires_grad_(True)
    return ClippedAdam(groups, max_grad_norm)


def polyak_blend(old: Mapping[str, torch.Tensor], new: Mapping[str, torch.Tensor],
                 factor: float) -> Dict[str, torch.Tensor]:
    """``factor * old + (1 - factor) * new`` per entry, computed as
    ``old + (1 - factor) * (new - old)``, exact where ``new == old``."""
    return {k: old[k] + (1.0 - factor) * (new[k] - old[k]) for k in old}
