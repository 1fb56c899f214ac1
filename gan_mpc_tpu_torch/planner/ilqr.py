"""Solver settings, the solution container, and the generic iLQR.

Counterpart of ``gan_mpc_tpu/planner/ilqr.py``. ``SolverSettings`` keeps
every field, so that configs written for the JAX package load unchanged,
and the batch solver (``planner/batch_ilqr.py``) runs every value the JAX
one takes.

``ilqr(cost, dynamics, x0, U0, settings, terminal_cost)`` solves a problem
given as per-instance callables, as the JAX function does:
``cost(x, u, t)`` a scalar (``t == T`` the terminal step, with a zero
control row, unless ``terminal_cost(x)`` is given, and then ``cost`` is
the stage cost only) and ``dynamics(x, u, t)`` the next state, ``t`` a
0-d integer tensor. It runs no loop of its own: ``per_instance_problem``
turns the callables into a ``BatchProblem`` (rows through
``torch.func.vmap``, the linearization by ``jacrev``, the quadratization
by ``hessian``, the split terminal quadratized once) and ``batch_ilqr``
solves it with the per-instance solver's semantics
(``BatchProblem.per_instance``). The callables must be plain torch:
``torch.func`` does not differentiate through the fused kernels'
``autograd.Function``; models with a fused forward supply their own
batch hooks (``models/dynamics.py``, ``models/ensemble.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
    # Quu's eigenvalues clamped to >= psd_delta in the Riccati step of a
    # per-instance problem (``BatchProblem.per_instance``: the JAX
    # ``ilqr``); the JAX batch solver's sequential pass ignores it, and so
    # does the port's on batch-native problems.
    psd_delta: float = 0.0
    # "sequential" (the Riccati recursion) or "associative" (its O(log T)
    # depth form, ``planner/parallel_riccati.py``), on every path.
    riccati: str = "sequential"
    # An XLA scan-unroll knob; eager PyTorch has no counterpart. Accepted
    # so that configs load, and ignored.
    inner_unroll: int = 1
    # "recompute", "materialize", or "auto", which resolves as in the JAX
    # package: materialize when T >= 16 and the candidate block is <= 32 MiB
    # (``batch_ilqr.ls_materializes``).
    ls_materialize: str = "auto"
    # "float32" or "bfloat16": the dtype of the dynamics net's products on
    # the batch-native serving path (``MPCPolicy.plan_batch``: the forward
    # scans, the fused step and the linearization's Jacobian chain), with
    # f32 accumulation; the solver's own arithmetic stays f32. The
    # per-instance path and the differentiable ``plan`` do not read it, as
    # in the JAX package.
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


def _t(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.int64, device=device)


def rollout(dynamics: Callable, U: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Roll controls U (T, m) through ``dynamics`` from x0 (n,): X (T+1, n)."""
    xs = [x0]
    for t in range(U.shape[0]):
        xs.append(dynamics(xs[-1], U[t], _t(t, x0.device)))
    return torch.stack(xs)


def total_cost(cost: Callable, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Sum of per-step costs including the terminal one (t == T, zero
    control)."""
    Up = torch.cat([U, torch.zeros_like(U[-1:])])
    ts = torch.arange(X.shape[0], device=X.device)
    return torch.func.vmap(cost)(X, Up, ts).sum()


def per_instance_problem(cost: Callable, dynamics: Callable, T: int, m: int,
                         terminal_cost: Optional[Callable] = None):
    """A ``BatchProblem`` over per-instance callables (the conventions of
    ``ilqr``) for horizon T and control width m, every lane the same
    functions: each callback maps its rows through ``torch.func.vmap``;
    ``dynamics_jac`` is ``jacrev`` of ``dynamics``, ``quad`` the gradient
    and ``hessian`` of the stage cost at t < T and of the terminal
    (``terminal_cost``, or ``cost`` at t == T with a zero control) once."""
    from gan_mpc_tpu_torch.planner.batch_ilqr import BatchProblem

    vmap, jacrev, hessian = torch.func.vmap, torch.func.jacrev, torch.func.hessian

    def terminal(x):
        if terminal_cost is not None:
            return terminal_cost(x)
        return cost(x, x.new_zeros(m), _t(T, x.device))

    def rows(fn, X, U, t):
        B, K, n = X.shape
        out = vmap(fn, in_dims=(0, 0, None))(X.reshape(B * K, n), U.reshape(B * K, -1),
                                             _t(t, X.device))
        return out.reshape((B, K) + out.shape[1:])

    def terminal_rows(X):
        B, K, n = X.shape
        return vmap(terminal)(X.reshape(B * K, n)).reshape(B, K)

    def dynamics_jac(X, U):
        B, n = X.shape[1:]
        ts = torch.arange(T, device=X.device).repeat_interleave(B)
        A, Bm = vmap(jacrev(dynamics, argnums=(0, 1)))(X.reshape(T * B, n),
                                                       U.reshape(T * B, m), ts)
        return A.reshape(T, B, n, n), Bm.reshape(T, B, n, m)

    def quad(X, U):
        B = U.shape[1]
        n = X.shape[-1]
        ts = torch.arange(T, device=X.device).repeat_interleave(B)
        x, u = X[:T].reshape(T * B, n), U.reshape(T * B, m)
        cx, cu = vmap(jacrev(cost, argnums=(0, 1)))(x, u, ts)
        (cxx, _), (cux, cuu) = vmap(hessian(cost, argnums=(0, 1)))(x, u, ts)
        cx_T = vmap(jacrev(terminal))(X[T])
        cxx_T = vmap(hessian(terminal))(X[T])
        return (torch.cat([cx.reshape(T, B, n), cx_T[None]]), cu.reshape(T, B, m),
                torch.cat([cxx.reshape(T, B, n, n), cxx_T[None]]), cuu.reshape(T, B, m, m),
                cux.reshape(T, B, m, n))

    return BatchProblem(
        dynamics_step=lambda X, U, t: rows(dynamics, X, U, t),
        dynamics_jac=dynamics_jac,
        stage_cost=lambda X, U, t: rows(cost, X, U, t),
        terminal_cost=terminal_rows,
        quad=quad,
        per_instance=True,
    )


def ilqr(cost: Callable, dynamics: Callable, x0: torch.Tensor, U0: torch.Tensor,
         settings: SolverSettings = SolverSettings(),
         terminal_cost: Optional[Callable] = None) -> ILQRSolution:
    """Iterative LQR over per-instance callables (the module's conventions).
    x0 (n,) and U0 (T, m) solve one problem, as the JAX ``ilqr``; x0 (B, n)
    and U0 (B, T, m) solve B problems lane by lane (its ``vmap``), and the
    solution's fields carry the leading B."""
    from gan_mpc_tpu_torch.planner.batch_ilqr import batch_ilqr

    single = x0.dim() == 1
    x0b, U0b = (x0[None], U0[None]) if single else (x0, U0)
    T, m = U0b.shape[1:]
    problem = per_instance_problem(cost, dynamics, T, m, terminal_cost)
    sol = batch_ilqr(problem, x0b, U0b, settings)
    if not single:
        return sol
    return ILQRSolution(sol.X[0], sol.U[0], sol.obj[0], sol.grad[0], sol.adjoints[0],
                        sol.iterations[0], sol.converged[0], sol.trips)
