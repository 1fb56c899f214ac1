"""Per-feature state/action normalization.

Counterpart of ``Normalizer`` in ``gan_mpc_tpu/data/normalizer.py``:
``(x - mean) / std``. ``Normalizer.fit`` is not ported.
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

    def normalize_state(self, x):
        return (x - self.state_mean) / self.state_std

    def denormalize_state(self, x):
        return x * self.state_std + self.state_mean

    def normalize_action(self, u):
        return (u - self.action_mean) / self.action_std

    def denormalize_action(self, u):
        return u * self.action_std + self.action_mean
