"""Checkpoint and resume of a training run's whole state.

Counterpart of ``gan_mpc_tpu/utils/checkpoint.py`` (Orbax there): the
same methods and semantics, in a format of the port's own. A state is a
dict of tensors, host ints and nested dicts and lists of them (the
policy's tensors, each optimizer's state dict, the replay buffer with its
pointer and fill level, the run's ``torch.Generator`` state); each saved
step is one ``torch.save`` file, ``<step>.pt``, written to a temporary
name and renamed, so a crash mid-write leaves the last good step.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch


class TrainCheckpointer:
    """Keeps the newest ``keep`` steps of one run under ``directory``,
    saving every ``every``-th step."""

    def __init__(self, directory: str, keep: int = 3, every: int = 1):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(keep, 1)
        self._every = max(every, 1)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(f[:-3]) for f in os.listdir(self._dir)
                      if f.endswith(".pt") and f[:-3].isdigit())

    def maybe_save(self, step: int, state: Any) -> bool:
        """Save if ``step`` hits the cadence. Returns True if saved."""
        if step % self._every != 0:
            return False
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self._keep]:
            os.remove(self._path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at ``step`` (default: the latest), its tensors
        on the devices they were saved from unless ``map_location`` says
        otherwise."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir!r}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def clear(self) -> None:
        """Delete every saved step (a completed run calls it, so that the
        next fresh invocation does not resume, that is skip, a finished
        run)."""
        for step in self.all_steps():
            os.remove(self._path(step))

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""
