"""Per-feature state/action normalization.

Counterpart of ``Normalizer`` in ``gan_mpc_tpu/data/normalizer.py``:
``(x - mean) / std``, identity or fitted to data.
"""

from __future__ import annotations

import dataclasses

import torch

from gan_mpc_tpu_torch import resolve_device


@dataclasses.dataclass
class Normalizer:
    state_mean: torch.Tensor
    state_std: torch.Tensor
    action_mean: torch.Tensor
    action_std: torch.Tensor

    @classmethod
    def identity(cls, state_size: int, action_size: int, device="cuda") -> "Normalizer":
        device = resolve_device(device)
        z = lambda n: torch.zeros(n, device=device)
        o = lambda n: torch.ones(n, device=device)
        return cls(z(state_size), o(state_size), z(action_size), o(action_size))

    @classmethod
    def fit(cls, states: torch.Tensor, actions: torch.Tensor,
            normalize_state: bool = True, normalize_action: bool = False,
            eps: float = 1e-8) -> "Normalizer":
        """Fit on (..., x) states and (..., u) actions, on their device
        (the reference's default: standard state norm, identity action
        norm). The std is the population std (``jnp.std``), plus eps."""
        s = states.reshape(-1, states.shape[-1]).to(torch.float32)
        a = actions.reshape(-1, actions.shape[-1]).to(torch.float32)
        ident = cls.identity(s.shape[-1], a.shape[-1], s.device)
        return cls(
            state_mean=s.mean(0) if normalize_state else ident.state_mean,
            state_std=s.std(0, correction=0) + eps if normalize_state else ident.state_std,
            action_mean=a.mean(0) if normalize_action else ident.action_mean,
            action_std=a.std(0, correction=0) + eps if normalize_action else ident.action_std,
        )

    def normalize_state(self, x):
        return (x - self.state_mean) / self.state_std

    def denormalize_state(self, x):
        return x * self.state_std + self.state_mean

    def normalize_action(self, u):
        return (u - self.action_mean) / self.action_std

    def denormalize_action(self, u):
        return u * self.action_std + self.action_mean
