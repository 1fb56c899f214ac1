"""Small SPD solves: pivotless Gauss-Jordan elimination.

Counterpart of ``gan_mpc_tpu/planner/linalg.py::solve_spd``. The Riccati
step solves a Levenberg-Marquardt-regularized SPD system (m = action
dimension) for every lane at every timestep; its diagonal is bounded
away from zero by construction, so no pivoting is needed. The JAX
package unrolls the elimination for m <= 16 and rolls it into a
``fori_loop`` above that, to bound XLA program size. Eager PyTorch has no
program to bound: both cases are the same Python loop of m batched
rank-1 updates, with the same arithmetic.
"""

from __future__ import annotations

import torch

SMALL_MAX = 16


def solve_spd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for SPD A (..., m, m) and B (..., m, k)."""
    m = A.shape[-1]
    aug = torch.cat([A, B], dim=-1)  # (..., m, m + k)
    for i in range(m):
        piv = aug[..., i, :] / aug[..., i, i : i + 1]
        col = aug[..., :, i]
        aug = aug - col[..., :, None] * piv[..., None, :]
        aug[..., i, :] = piv
    return aug[..., m:]
