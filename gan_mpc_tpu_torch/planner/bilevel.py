"""Differentiating through the batch planner (the implicit gradient).

Counterpart of ``gan_mpc_tpu/planner/bilevel.py``, batch-major: one
``batch_ilqr`` solve for B problems forward, and a backward that works on
(B, ...) cotangents. The JAX package wraps its single-instance ``ilqr``
in a ``jax.custom_vjp`` and ``vmap``s it; its ``batch_ilqr`` matches
``vmap(ilqr)`` numerically, so the two agree.

Math. At the solution U* of U* = argmin_U J(U; theta) the gradient
g(U*, theta) = dJ/dU vanishes, so for an outer loss with cotangents
(X_bar, U_bar, obj_bar) on the solution

    theta_bar = dtheta_from_X - d/dtheta <v, g(U*, theta)> + obj_bar dJ/dtheta,
    A v = U_bar + dU_from_X,   A = (H + H^T) / 2 + ridge I,  H = d^2 J / dU^2,

where (dU_from_X, dtheta_from_X) is X_bar pulled back through the
rollout, and the last term is the envelope gradient of the objective.

Each term takes the derivative it needs and no more:
  * the rollout pullback and the envelope are first derivatives: they run
    the problem built at ``order=1``, whose MLPs go through ``mlp_apply``
    and so, on CUDA tensors, through ``FusedMlpFunction`` (the forward and
    backward kernels);
  * the mixed term d/dtheta <v, g> is a second derivative: it runs the
    problem built at ``order=2``, whose MLPs are the plain torch forward
    (``mlp_apply(..., twice_differentiable=True)``), as the JAX package
    takes it in flax outside its kernels; so do the exact Hessian's
    products below;
  * H is the exact Hessian, as the JAX package takes it (``jax.jacfwd``
    of ``jax.grad`` for "dense", ``jax.jvp`` of it for "cg"), in one of
    two ways, as the problem states (``BatchProblem.gauss_newton_exact``):
    - where the dynamics are piecewise linear in (x, u), as the residual
      relu MLP, an ensemble of them and linear dynamics are, from the
      linearization the solver already makes (``dynamics_jac`` and
      ``quad`` at (X*, U*)) by a Gauss-Newton Hessian-vector product: a
      tangent rollout dx_{t+1} = A_t dx_t + B_t w_t and its adjoint. That
      is the exact Hessian almost everywhere (the rollout's second
      derivative vanishes), and ``quad`` holds the cost's exact second
      derivatives (the relu terminal net's is 2 w J^T J);
    - where they are not (the LSTM dynamics: the cell's sigmoids and
      tanhs curve, and Gauss-Newton would drop that curvature), by
      double backward through the order-2 problem: the gradient dJ/dU of
      the plain rollout, kept differentiable, then one backward of
      <dJ/dU, w> to U per direction w.
    ``"dense"`` applies it to the T*m unit directions and solves with
    ``solve_spd``; ``"cg"`` runs a batched conjugate gradient with
    ``jax.scipy.sparse.linalg.cg``'s stopping rule, per lane: |r| <= 1e-5
    |b|, at most ``cg_iters`` trips, converged lanes masked (the loop never
    syncs with the device).

x0 and U0 (goals, warm starts) get no gradient, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch

from gan_mpc_tpu_torch.planner.batch_ilqr import (
    BatchProblem,
    batch_ilqr,
    batch_rollout,
    mlp_calls_per_solve,
)
from gan_mpc_tpu_torch.planner.ilqr import ILQRSolution, SolverSettings
from gan_mpc_tpu_torch.planner.linalg import solve_spd

CG_TOL = 1e-5  # jax.scipy.sparse.linalg.cg's default relative tolerance


def gn_hvp(lin, W: torch.Tensor) -> torch.Tensor:
    """d^2J/dU^2 applied to K directions W (T, B, m, K), from the
    linearization ``lin = (A (T,B,n,n), Bm (T,B,n,m), cxx (T+1,B,n,n),
    cuu (T,B,m,m), cux (T,B,m,n))``: the tangent rollout of W, then the
    adjoint of the second-order cost terms. Returns (T, B, m, K)."""
    A, Bm, cxx, cuu, cux = lin
    T = W.shape[0]
    dxs = [torch.zeros(A.shape[1:3] + W.shape[-1:], dtype=W.dtype, device=W.device)]
    for t in range(T):
        dxs.append(A[t] @ dxs[t] + Bm[t] @ W[t])
    lam = cxx[T] @ dxs[T]
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = Bm[t].transpose(-1, -2) @ lam + cux[t] @ dxs[t] + cuu[t] @ W[t]
        lam = (A[t].transpose(-1, -2) @ lam + cxx[t] @ dxs[t]
               + cux[t].transpose(-1, -2) @ W[t])
    return torch.stack(out)


def dense_hessian(lin, T: int, m: int) -> torch.Tensor:
    """(B, T*m, T*m): ``gn_hvp`` on every unit direction at once; row and
    column index t * m + i, the JAX package's flattening of U (T, m)."""
    return _dense(lambda W: gn_hvp(lin, W), lin[0].shape[1], T, m, lin[0].dtype,
                  lin[0].device)


def _dense(hvp: Callable, B: int, T: int, m: int, dtype, device) -> torch.Tensor:
    """(B, T*m, T*m) from ``hvp`` on the T*m unit directions (T, B, m, T*m)."""
    eye = torch.eye(T * m, dtype=dtype, device=device).reshape(T, 1, m, T * m)
    cols = hvp(eye.expand(T, B, m, T * m))  # (T, B, m, T*m)
    return cols.permute(1, 0, 2, 3).reshape(B, T * m, T * m)


def exact_hvp(g: torch.Tensor, U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """d^2J/dU^2 applied to K directions W (T, B, m, K) by double backward:
    ``g`` = dJ/dU (T, B, m) of a graph built with ``create_graph`` from
    ``U``, one backward of <g, w> per direction. Lanes solve independent
    problems, so one backward serves every lane. Returns (T, B, m, K),
    outside any graph."""
    cols = [torch.autograd.grad(g, U, W[..., k], retain_graph=True)[0]
            for k in range(W.shape[-1])]
    return torch.stack(cols, -1)


def batched_cg(matvec: Callable, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Solve A x = b per row of b (B, N) for SPD A given as ``matvec``,
    from x = 0: ``jax.scipy.sparse.linalg.cg`` under ``vmap``. A lane runs
    while |r|^2 > tol^2 |b|^2, for at most ``iters`` trips; a lane that has
    stopped changes nothing. All ``iters`` trips run."""
    x = torch.zeros_like(b)
    r, p = b, b
    gamma = (r * r).sum(-1)
    stop2 = CG_TOL ** 2 * gamma
    for _ in range(iters):
        run = (gamma > stop2)[:, None]
        Ap = matvec(p)
        alpha = (gamma / (p * Ap).sum(-1))[:, None]
        r_new = r - alpha * Ap
        gamma_new = (r_new * r_new).sum(-1)
        x = torch.where(run, x + alpha * p, x)
        p = torch.where(run, r_new + (gamma_new / gamma)[:, None] * p, p)
        r = torch.where(run, r_new, r)
        gamma = torch.where(run[:, 0], gamma_new, gamma)
    return x


def mlp_calls_per_step(horizon: int, trips: int, fused: bool = False,
                       steps: int = 1, materialize: bool = False, members: int = 1,
                       projection: bool = False) -> Dict[str, int]:
    """Kernel launches of ``steps`` implicit solves that ran ``trips``
    iterations in all, and their backwards, on the card, for an outer loss
    that reads X or U and not obj (the imitation and generator losses).

    The solves: ``mlp_calls_per_solve`` (``materialize``, ``members`` and
    ``projection`` as there). Each backward's first-order rollout at
    (U*, theta): ``horizon`` dynamics forwards of ``members`` MLP launches
    each (``fused_mlp_fwd`` through ``FusedMlpFunction``; an ensemble's
    members, 1 for a residual MLP or the LSTM dynamics' head) and one
    terminal-cost forward, then the X pullback, the same ``members`` x
    ``horizon`` MLP backwards (``fused_mlp_bwd``). A loss that reads obj
    adds the envelope's dynamics backwards and one of the cost net. The
    Hessian and the mixed term run plain torch.
    """
    calls = dict(mlp_calls_per_solve(horizon, trips, fused, steps, materialize, members,
                                     projection))
    calls["fused_mlp_fwd"] += steps * (members * horizon + 1)
    calls["fused_mlp_bwd"] = steps * members * horizon
    return calls


class _ImplicitSolve(torch.autograd.Function):
    """Arguments: the planner, ``build_problem``, x0 (B, n), U0 (B, T, m),
    then the theta tensors. Outputs: X, U, obj (differentiable), grad,
    adjoints, iterations, converged (not), and the trips (an int)."""

    @staticmethod
    def forward(ctx, planner, build_problem, x0, U0, *theta):
        sol = batch_ilqr(build_problem(0), x0, U0, planner.settings)
        ctx.planner, ctx.build_problem, ctx.theta = planner, build_problem, theta
        ctx.save_for_backward(x0, sol.U)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(sol.grad, sol.adjoints, sol.iterations, sol.converged)
        return (sol.X, sol.U, sol.obj, sol.grad, sol.adjoints, sol.iterations, sol.converged,
                sol.trips)

    @staticmethod
    def backward(ctx, X_bar, U_bar, obj_bar, *unused):
        x0, Ustar = ctx.saved_tensors
        needs = ctx.needs_input_grad[4:]
        wrt = [t for t, need in zip(ctx.theta, needs) if need]
        grads = ctx.planner._theta_grads(ctx.build_problem, wrt, x0, Ustar, X_bar, U_bar,
                                        obj_bar)
        it = iter(grads)
        return (None, None, None, None) + tuple(next(it) if need else None for need in needs)


@dataclasses.dataclass(frozen=True)
class ImplicitPlanner:
    """The JAX package's ``make_implicit_planner`` for batch problems:
    ``plan(build_problem, theta, x0, U0) -> ILQRSolution`` whose X, U and
    obj are differentiable in the tensors of ``theta``.

    ``build_problem(order) -> BatchProblem`` builds the planning problem
    from the tensors of ``theta`` (and tensors that need no gradient, such
    as goals): order 0 for the solve (no gradient is recorded; it may
    carry the fused line-search step), 1 for first derivatives (the MLPs
    through ``mlp_apply``), 2 for second derivatives (the MLPs plain,
    ``twice_differentiable``). ``solver`` is ``"dense"`` or ``"cg"``,
    ``ridge`` the Tikhonov term added to the Hessian, ``cg_iters`` the CG
    trip count. x0 (B, n), U0 (B, T, m) as ``batch_ilqr`` takes them.
    """

    settings: SolverSettings = SolverSettings()
    solver: str = "dense"
    ridge: float = 1e-5
    cg_iters: int = 64

    def __post_init__(self):
        if self.solver not in ("dense", "cg"):
            raise ValueError(f"unknown bilevel solver {self.solver!r}")

    def __call__(self, build_problem: Callable[[int], BatchProblem],
                 theta: Sequence[torch.Tensor], x0: torch.Tensor,
                 U0: torch.Tensor) -> ILQRSolution:
        out = _ImplicitSolve.apply(self, build_problem, x0, U0, *theta)
        return ILQRSolution(*out)

    def _theta_grads(self, build_problem, wrt, x0, Ustar, X_bar, U_bar, obj_bar):
        """The gradients of the tensors ``wrt`` for the cotangents of X,
        U and obj (batch-major, None where the outer loss reads nothing)."""
        if not wrt:
            return []
        x0 = x0.to(torch.float32)
        U = Ustar.transpose(0, 1).detach()  # (T, B, m)
        T, B, m = U.shape
        total = [torch.zeros_like(t) for t in wrt]

        def add(grads, scale=1.0):
            for acc, g in zip(total, grads):
                if g is not None:
                    acc.add_(g, alpha=scale)

        # first derivatives: the rollout at (U*, theta) through the kernels
        with torch.enable_grad():
            U1 = U.clone().requires_grad_()
            problem = build_problem(1)
            X, obj = batch_rollout(problem, U1, x0)
            u_bar = torch.zeros_like(U) if U_bar is None else U_bar.transpose(0, 1)
            if X_bar is not None:
                dU, *dtheta = torch.autograd.grad(
                    X, [U1, *wrt], X_bar.transpose(0, 1), retain_graph=obj_bar is not None,
                    allow_unused=True)
                u_bar = u_bar + dU
                add(dtheta)
            if obj_bar is not None:
                add(torch.autograd.grad(obj, wrt, obj_bar, allow_unused=True))
        if U_bar is None and X_bar is None:
            return total  # v = 0: no implicit term

        b = u_bar.transpose(0, 1).reshape(B, T * m)
        with torch.enable_grad():
            # dJ/dU of the plain rollout, kept differentiable: the mixed
            # term's d/dtheta, and the exact Hessian's products
            U2 = U.clone().requires_grad_()
            _, obj2 = batch_rollout(build_problem(2), U2, x0)
            (g,) = torch.autograd.grad(obj2.sum(), U2, create_graph=True)
        if problem.gauss_newton_exact:
            with torch.no_grad():
                lin = (*problem.dynamics_jac(X.detach()[:-1], U),
                       *problem.quad(X.detach(), U)[2:])
            hvp = lambda W: gn_hvp(lin, W)
        else:
            hvp = lambda W: exact_hvp(g, U2, W)
        with torch.no_grad():
            if self.solver == "dense":
                H = _dense(hvp, B, T, m, U.dtype, U.device)
                H = (H + H.transpose(-1, -2)) / 2.0 + self.ridge * torch.eye(
                    T * m, dtype=H.dtype, device=H.device)
                v = solve_spd(H, b[..., None])[..., 0]
            else:
                def matvec(w):
                    Wt = w.reshape(B, T, m).transpose(0, 1)[..., None]
                    Hw = hvp(Wt)[..., 0].transpose(0, 1).reshape(B, T * m)
                    return Hw + self.ridge * w
                v = batched_cg(matvec, b, self.cg_iters)
            v = v.reshape(B, T, m).transpose(0, 1)

        # the mixed second derivative -d/dtheta <v, dJ/dU> through plain MLPs
        with torch.enable_grad():
            add(torch.autograd.grad((g * v).sum(), wrt, allow_unused=True), -1.0)
        return total
