"""Solver settings and solution container.

Counterpart of ``SolverSettings`` and ``ILQRSolution`` in
``gan_mpc_tpu/planner/ilqr.py``. Every field is kept, so that configs
written for the JAX package load unchanged; the batch solver
(``planner/batch_ilqr.py``) raises ``NotImplementedError`` for the values
that select paths not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """iLQR knobs; defaults are the JAX package's (trajax's defaults)."""

    max_iterations: int = 100
    grad_norm_tol: float = 1e-4
    obj_step_tol: float = 0.0
    alpha_0: float = 1.0
    alpha_decay: float = 0.5
    num_alphas: int = 16
    reg_init: float = 1e-6
    reg_min: float = 1e-6
    reg_max: float = 1e8
    reg_up: float = 10.0
    reg_down: float = 0.5
    psd_delta: float = 0.0
    # "sequential" (ported) or "associative" (not ported).
    riccati: str = "sequential"
    # An XLA scan-unroll knob; eager PyTorch has no counterpart. Accepted
    # so that configs load, and ignored.
    inner_unroll: int = 1
    # "recompute", "materialize", or "auto", which resolves as in the JAX
    # package: materialize when T >= 16 and the candidate block is <= 32 MiB
    # (``batch_ilqr.ls_materializes``).
    ls_materialize: str = "auto"
    # "float32" (ported) or "bfloat16" (not ported).
    compute_dtype: str = "float32"
    # Fused forward-scan step (``ops/fused_ls.py``): "off", "on", or
    # "auto", on for CUDA inputs (the JAX package's "on the accelerator").
    fused_ls: str = "off"


@dataclasses.dataclass
class ILQRSolution:
    X: torch.Tensor  # (..., T+1, n) optimized state trajectory
    U: torch.Tensor  # (..., T, m) optimized controls
    obj: torch.Tensor  # objective at (X, U)
    grad: torch.Tensor  # (..., T, m) dJ/dU at the solution
    adjoints: torch.Tensor  # (..., T+1, n) costate trajectory
    iterations: torch.Tensor  # int32 outer iterations used
    converged: torch.Tensor  # bool
    trips: int = None  # iterations the batch loop ran (host int)
