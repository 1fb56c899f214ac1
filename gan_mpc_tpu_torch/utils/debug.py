"""Debug-mode numerical guards.

Counterpart of ``gan_mpc_tpu/utils/debug.py``. JAX's global NaN check
(``jax_debug_nans``) maps onto autograd's anomaly mode, which names the
forward operation whose backward produced a NaN; the finiteness checks
are the same.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def enable_debug_checks(nans: bool = True) -> None:
    """Turn autograd's anomaly detection on (or off) globally: every
    backward checks its outputs for NaN (slow; debug runs only)."""
    torch.autograd.set_detect_anomaly(nans)


@contextlib.contextmanager
def debug_checks():
    """Scoped variant of ``enable_debug_checks``."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _leaves(tree, path=""):
    """(path, tensor) of every leaf of a nested dict / list / tuple /
    ``nn.Module``; paths as ``jax.tree_util.keystr`` writes them
    (``['key'][0]``), a module's entries keyed by their ``state_dict``
    names."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{path}[{i}]")
    elif tree is not None:
        yield path, torch.as_tensor(tree)


def assert_finite(tree, label: str = "value") -> None:
    """Host-side finiteness check over a nested dict / list / ``nn.Module``
    of tensors (at phase boundaries): raises ``FloatingPointError`` naming
    the first leaf, by its path, that holds a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        if not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"{label}{path} contains non-finite values")


def checkify_finite(x: torch.Tensor, label: str = "value") -> torch.Tensor:
    """x where every entry is finite, else x * NaN, which poisons what
    follows (and trips the anomaly check in a backward). No host sync:
    the choice is made on x's device."""
    return torch.where(torch.isfinite(x).all(), x, x * float("nan"))
