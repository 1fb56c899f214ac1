"""Device-resident replay buffer of dynamics windows.

Counterpart of ``ReplayBuffer`` in ``gan_mpc_tpu/data/buffers.py``:
fixed-shape window tensors on the device with a ring write pointer. The
JAX buffer is immutable and each add returns a new one; this one is
written in place (an add copies only the new windows) and its adds return
the buffer itself, so callers read the same either way. The pointer and
the fill level are host integers: the number of windows added is known on
the host, so reading the fill level never waits on the device.
"""

from __future__ import annotations

import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.data.windows import sequence_windows


class ReplayBuffer:
    def __init__(self, states: torch.Tensor, actions: torch.Tensor,
                 next_states: torch.Tensor, ptr: int = 0, size: int = 0):
        self.states = states  # (capacity, seqlen, x)
        self.actions = actions  # (capacity, seqlen, u)
        self.next_states = next_states  # (capacity, seqlen, x)
        self.ptr = ptr  # next write slot
        self.size = size  # valid entries

    @property
    def capacity(self) -> int:
        return self.states.shape[0]

    @classmethod
    def create(cls, capacity: int, seqlen: int, x_size: int, u_size: int,
               device="cuda") -> "ReplayBuffer":
        """An empty buffer, on the card unless ``device`` says otherwise."""
        device = resolve_device(device)
        z = lambda w: torch.zeros((capacity, seqlen, w), device=device)
        return cls(z(x_size), z(u_size), z(x_size))

    def add_windows(self, xw: torch.Tensor, uw: torch.Tensor,
                    yw: torch.Tensor) -> "ReplayBuffer":
        """Insert pre-windowed sequences (n, seqlen, ·) at the ring head."""
        n = xw.shape[0]
        idx = (self.ptr + torch.arange(n, device=self.states.device)) % self.capacity
        self.states[idx] = xw
        self.actions[idx] = uw
        self.next_states[idx] = yw
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        return self

    def add_trajectories(self, states: torch.Tensor,
                         actions: torch.Tensor) -> "ReplayBuffer":
        """Window (B, T, ·) trajectories and insert them (normalization is
        the caller's job)."""
        return self.add_windows(*sequence_windows(states, actions, self.states.shape[1]))

    def sample(self, generator: torch.Generator, steps: int, batch_size: int):
        """(steps, batch) minibatches of (x, u, next_x) windows, drawn
        uniformly from the filled slots."""
        idx = torch.randint(max(self.size, 1), (steps, batch_size), generator=generator,
                            device=generator.device).to(self.states.device)
        return self.states[idx], self.actions[idx], self.next_states[idx]
