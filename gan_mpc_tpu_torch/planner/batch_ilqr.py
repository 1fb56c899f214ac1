"""Batch-native iLQR: one solver instance for a whole (B,)-batch of
planning problems.

Counterpart of ``gan_mpc_tpu/planner/batch_ilqr.py``. Every callback
receives the whole batch, so the fused MLP kernel sees real batches
(B rows in the rollouts, B * num_alphas rows in the line search).
Horizon-indexed arrays are time-major inside the solver: X (T+1, B, n),
U (T, B, m), A (T, B, n, n). ``lax.scan`` becomes a Python loop.

Per-lane line-search acceptance, Levenberg-Marquardt schedule and
convergence are (B,) tensors with masked updates. A lane that is no
longer active changes no state. The iteration loop stops, as the JAX
package's ``while any(active)`` does, once no lane is active (one host
sync a trip). The solution reports the trips that ran
(``ILQRSolution.trips``), from which ``mlp_calls_per_solve`` gives the
kernel launches.

Every setting of the JAX batch solver runs: both backward passes
(``riccati``: "sequential", the Riccati recursion, or "associative", its
O(log T)-depth parallel form, ``_backward_associative``), both line-search
strategies (``ls_materialize``, resolved by ``ls_materializes`` as the JAX
package resolves it: recompute the winner, or materialize every candidate
and gather it), and the forward scans either through the separate
callbacks or through the fused step ``ls_step`` (``fused_ls``).
``compute_dtype`` is read where the problem is built (``MPCPolicy``), which
passes it to the dynamics' callbacks and the fused step; the solver's own
arithmetic is f32 at both. Nothing is refused: data parallelism over
devices runs around the solver (``parallel/``: each rank solves its rows
of a batch with this function).

A problem marked ``per_instance`` is solved as the JAX package's
``vmap(ilqr)`` solves it (``tests/test_batch_ilqr.py`` holds that equal
to its ``batch_ilqr``): Quu projected onto eigenvalues >= ``psd_delta``
in the sequential Riccati step (the associative pass does not read it, in
either package), and ``fused_ls`` and ``compute_dtype`` not read (its
callbacks have no fused step and run f32). The generic ``ilqr``
(``planner/ilqr.py``) and the policies whose dynamics are not batch
native (ensembles, recurrent nets) build such problems.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from gan_mpc_tpu_torch.planner.ilqr import ILQRSolution, SolverSettings
from gan_mpc_tpu_torch.planner.linalg import solve_spd
from gan_mpc_tpu_torch.planner.parallel_riccati import associative_scan, parallel_backward_pass


@dataclasses.dataclass(frozen=True)
class BatchProblem:
    """Batch-major planner callbacks.

    dynamics_step: (X (B,K,n), U (B,K,m), t) -> (B,K,n), K parallel
      rollouts per lane (K=1 plain rollout, K=num_alphas line search);
    dynamics_jac: (X (T,B,n), U (T,B,m)) -> (A (T,B,n,n), Bm (T,B,n,m));
    stage_cost: (X (B,K,n), U (B,K,m), t) -> (B,K);
    terminal_cost: (X (B,K,n)) -> (B,K);
    quad: (X (T+1,B,n), U (T,B,m)) -> (cx (T+1,B,n), cu (T,B,m),
      cxx (T+1,B,n,n), cuu (T,B,m,m), cux (T,B,m,n));
    ls_step (optional): the fused forward-scan step (``ops/fused_ls.py``),
      control law + dynamics + stage cost in one call,
      (x (B,A,n), Xref (B,n), Uref (B,m), alphaBA (B,A), k (B,m),
       K (B,m,n), t) -> (nx (B,A,n), u (B,A,m), cost (B,A)), every
      argument contiguous. When set, ``batch_rollout``,
      ``_line_search_objs`` and ``_forward_best`` route through it;
    per_instance: the semantics of the JAX per-instance ``ilqr`` (the
      module's docstring);
    gauss_newton_exact: whether the Gauss-Newton product of
      ``dynamics_jac`` and ``quad`` is the objective's exact Hessian in U,
      which holds where the dynamics are piecewise linear in (x, u); the
      implicit gradient (``planner/bilevel.py``) reads it.
    """

    dynamics_step: Callable
    dynamics_jac: Callable
    stage_cost: Callable
    terminal_cost: Callable
    quad: Callable
    ls_step: Optional[Callable] = None
    per_instance: bool = False
    gauss_newton_exact: bool = True


def ls_materializes(settings: SolverSettings, T: int, B: int, n: int, m: int) -> bool:
    """Whether a solve of B lanes over horizon T with n states and m
    actions materializes its line-search candidates: ``ls_materialize``
    "materialize", or "auto" when T >= 16 and the candidates take at most
    32 MiB (the JAX package's rule: every length-T scan saved pays off at
    long horizons while the candidate block stays small)."""
    cand_bytes = 4 * T * B * settings.num_alphas * (n + m)
    return settings.ls_materialize == "materialize" or (
        settings.ls_materialize == "auto"
        and T >= 16
        and cand_bytes <= 32 * 1024 * 1024
    )


def _check_settings(settings: SolverSettings, problem: BatchProblem) -> None:
    """Raise for a backward pass or compute dtype that does not exist, and
    for ``fused_ls="on"`` on a batch-native problem without the fused
    step."""
    if settings.riccati not in ("sequential", "associative"):
        raise ValueError(f"riccati must be 'sequential' or 'associative', got "
                         f"{settings.riccati!r}")
    if settings.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got "
                         f"{settings.compute_dtype!r}")
    if problem.per_instance:
        return
    if settings.fused_ls == "on" and problem.ls_step is None:
        raise ValueError(
            "fused_ls='on' needs a problem with the fused step (ls_step); "
            "MPCPolicy.plan_batch builds one"
        )


def batch_rollout(problem: BatchProblem, U, x0):
    """U (T,B,m), x0 (B,n) -> X (T+1,B,n), obj (B,)."""
    B, n = x0.shape
    x = x0
    acc = torch.zeros(B, dtype=x0.dtype, device=x0.device)
    xs = [x0]
    if problem.ls_step is not None:
        # fused path: alpha = 0, k = 0, K = 0, Xref = x -> u = U[t] exactly
        m = U.shape[-1]
        zk = torch.zeros((B, m), dtype=x0.dtype, device=x0.device)
        zK = torch.zeros((B, m, n), dtype=x0.dtype, device=x0.device)
        za = torch.zeros((B, 1), dtype=x0.dtype, device=x0.device)
    for t in range(U.shape[0]):
        u = U[t]
        if problem.ls_step is not None:
            nx, _, cost = problem.ls_step(x[:, None], x, u, za, zk, zK, t)
            acc = acc + cost[:, 0]
            x = nx[:, 0]
        else:
            acc = acc + problem.stage_cost(x[:, None], u[:, None], t)[:, 0]
            x = problem.dynamics_step(x[:, None], u[:, None], t)[:, 0]
        xs.append(x)
    obj = acc + problem.terminal_cost(x[:, None])[:, 0]
    return torch.stack(xs), obj


def project_psd(mat: torch.Tensor, delta: float) -> torch.Tensor:
    """Symmetric (..., m, m) matrices with their eigenvalues clamped to >=
    delta (the JAX ``ilqr._project_psd``)."""
    w, v = torch.linalg.eigh((mat + mat.transpose(-1, -2)) / 2.0)
    return (v * torch.clamp(w, min=delta)[..., None, :]) @ v.transpose(-1, -2)


def _backward(A, Bm, cx, cu, cxx, cuu, cux, reg, psd_delta=0.0):
    """Batched Riccati recursion, time-major inputs; reg (B,).

    Fused-block form: with C = [A | B] (B, n, n+m) the Q-model is
    [Qx; Qu] = [cx; cu] + C^T Vx and Q = Cblock + C^T Vxx C, and the value
    recursion goes through S = [I; K]: Vx' = S^T ([Qx; Qu] + Q [0; k]),
    Vxx' = S^T Q S. The open-loop costate recursion rides in the same
    reverse loop (one C^T [Vx, lam] product). Returns (k, K, adjoints, G)
    with G (T, B, m) = dJ/dU. The JAX version also returns the expected
    cost reductions dv1, dv2, which its caller never reads; they are not
    computed here. With ``psd_delta`` > 0 the gains solve against Quu
    projected onto eigenvalues >= psd_delta (the value recursion keeps Quu,
    as the JAX ``ilqr._backward_pass`` does).
    """
    T, B, n, _ = A.shape
    m = Bm.shape[-1]

    C = torch.cat([A, Bm], dim=-1)  # (T, B, n, n+m)
    qc = torch.cat([cx[:-1], cu], dim=-1)  # (T, B, n+m)
    top = torch.cat([cxx[:-1], cux.transpose(-1, -2)], dim=-1)
    bot = torch.cat([cux, cuu], dim=-1)
    cblock = torch.cat([top, bot], dim=-2)  # (T, B, n+m, n+m)
    eye_b = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)
    reg_eye = reg[:, None, None] * torch.eye(m, dtype=A.dtype, device=A.device)

    Vx, Vxx, lam = cx[-1], cxx[-1], cx[-1]
    ks, Ks, Vxs, Gs = [None] * T, [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        Ct, qct, cbt = C[t], qc[t], cblock[t]
        P = torch.stack([Vx, lam], dim=-1)  # (B, n, 2)
        R = torch.einsum("bnp,bnk->bpk", Ct, P)  # (B, n+m, 2)
        q = qct + R[..., 0]
        lamg = qct + R[..., 1]
        M = torch.einsum("bnp,bnq->bpq", Ct, Vxx)  # C^T Vxx
        Q = cbt + M @ Ct
        Qu = q[:, n:]
        Quu = Q[:, n:, n:]
        Quu_reg = (project_psd(Quu, psd_delta) if psd_delta > 0.0 else Quu) + reg_eye
        kK = solve_spd(Quu_reg, torch.cat([Qu[..., None], Q[:, n:, :n]], dim=-1))
        k, K = -kK[..., 0], -kK[..., 1:]
        S = torch.cat([eye_b, K], dim=1)  # (B, n+m, n)
        Qd = torch.einsum("bpj,bj->bp", Q[:, :, n:], k)
        Vx = torch.einsum("bpn,bp->bn", S, q + Qd)
        T1 = Q @ S
        Vxx = torch.einsum("bpn,bpm->bnm", S, T1)
        Vxx = (Vxx + Vxx.transpose(-1, -2)) / 2.0
        lam = lamg[:, :n]
        ks[t], Ks[t], Vxs[t], Gs[t] = k, K, Vx, lamg[:, n:]
    adjoints = torch.cat([torch.stack(Vxs), cx[-1:]], dim=0)
    return torch.stack(ks), torch.stack(Ks), adjoints, torch.stack(Gs)


def _backward_associative(A, Bm, cx, cu, cxx, cuu, cux, reg, psd_delta=0.0):
    """The O(log T)-depth backward pass (the JAX ``_backward_associative``),
    with ``_backward``'s inputs and returns.

    ``parallel_riccati.parallel_backward_pass`` on every lane at once (the
    JAX package ``vmap``s it; here the lane axis rides between time and
    the matrix axes), ``psd_delta`` passed and not read, as there. The
    open-loop gradient comes from the costate lam_t = A_t^T lam_{t+1} +
    cx_t by a second associative scan, over the affine maps' suffix
    compositions applied to lam_T = cx_T; then g_t = cu_t + B_t^T
    lam_{t+1}.
    """
    k, K, _, _, _, adjoints = parallel_backward_pass(A, Bm, cx, cu, cxx, cuu, cux, reg,
                                                     psd_delta)

    def combine(later, earlier):  # ``later``: the part already composed, nearer T
        M2, v2 = later
        M1, v1 = earlier
        return M1 @ M2, (M1 @ v2[..., None])[..., 0] + v1

    Mr, vr = associative_scan(combine, (A.transpose(-1, -2).flip(0), cx[:-1].flip(0)))
    lam = (Mr.flip(0) @ cx[-1][..., None])[..., 0] + vr.flip(0)  # lam_0 .. lam_{T-1}
    lam_next = torch.cat([lam[1:], cx[-1:]])
    G = cu + (Bm.transpose(-1, -2) @ lam_next[..., None])[..., 0]
    return k, K, adjoints, G


def _line_search_objs(problem, X, U, k, K, alphas, materialize=False):
    """Objective of every (lane, alpha) closed-loop rollout: (B, A).

    ``materialize=False``: only the running objective is carried; the
    winner is recomputed once afterwards (``_forward_best``).
    ``materialize=True``: each step's candidate states and actions are
    kept, and the result is (objs, (Xc (T,B,A,n), Uc (T,B,A,m))), Xc
    holding x_1..x_T and Uc the actions the cost was taken on (with the
    fused step, the ``u`` it returns); the winner is then a gather.
    """
    B = X.shape[1]
    A_ = alphas.shape[0]
    x = X[0][:, None].expand(B, A_, X.shape[-1])
    acc = torch.zeros((B, A_), dtype=X.dtype, device=X.device)
    xs, us = [], []
    if problem.ls_step is not None:
        x = x.contiguous()
        alphaBA = alphas[None].expand(B, A_).contiguous()
    for t in range(U.shape[0]):
        if problem.ls_step is not None:
            x, u, cost = problem.ls_step(x, X[t], U[t], alphaBA, k[t], K[t], t)
            acc = acc + cost
        else:
            du = torch.einsum("bmn,ban->bam", K[t], x - X[t][:, None])
            u = U[t][:, None] + alphas[None, :, None] * k[t][:, None] + du
            acc = acc + problem.stage_cost(x, u, t)
            x = problem.dynamics_step(x, u, t)
        if materialize:
            xs.append(x)
            us.append(u)
    objs = acc + problem.terminal_cost(x)
    return (objs, (torch.stack(xs), torch.stack(us))) if materialize else objs


def _forward_best(problem, X, U, k, K, alpha_b):
    """Closed-loop rollout at each lane's own step size alpha_b (B,).

    Returns Xn (T+1,B,n), Un (T,B,m). The JAX version also returns the
    rollout's objective, which its only caller discards; it is not
    computed here, which saves one terminal-cost MLP call per iteration.
    """
    x = X[0]
    xs, us = [x], []
    alphaB1 = alpha_b[:, None]  # (B, 1): the fused step's candidate axis
    for t in range(U.shape[0]):
        if problem.ls_step is not None:
            nx, u, _ = problem.ls_step(x[:, None], X[t], U[t], alphaB1, k[t], K[t], t)
            x, u = nx[:, 0], u[:, 0]
        else:
            u = U[t] + alpha_b[:, None] * k[t] + torch.einsum("bmn,bn->bm", K[t], x - X[t])
            x = problem.dynamics_step(x[:, None], u[:, None], t)[:, 0]
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)


def mlp_calls_per_solve(horizon: int, trips: int, fused: bool = False,
                        solves: int = 1, materialize: bool = False, members: int = 1,
                        projection: bool = False, bf16: bool = False) -> Dict[str, int]:
    """Kernel launches on the card of ``solves`` ``batch_ilqr`` calls that
    ran ``trips`` iterations in all (``ILQRSolution.trips``, or
    ``max_iterations`` each where no lane stops early), by kernel;
    ``materialize`` is the line-search strategy the solves resolved to
    (``ls_materializes``).

    Three forward scans run: the initial rollout, then per trip the
    line search and the winner recompute, H steps each; materializing
    solves run no recompute, so two. Every step is one dynamics forward,
    ``members`` MLP launches (``fused_mlp_fwd``; an ensemble's members,
    ``models/ensemble.py``; 1 for a residual MLP or the LSTM dynamics'
    head), or with the fused step one ``fused_ls_step`` launch. The
    rollout and the line search end in one terminal-cost MLP forward each;
    the recompute reads no objective. With ``projection`` (the policy's
    ``goal_projection`` > 0) each solve is preceded by the goal
    projection's H dynamics advances. (The linearization, the
    quadratization and the projection's Gauss-Newton steps run plain
    torch.) With ``bf16`` (``compute_dtype="bfloat16"`` on the batch-native
    path) the forward scans' dynamics launch the kernels' bf16 instances,
    ``fused_mlp_fwd_bf16`` or ``fused_ls_step_bf16``, and the terminal cost
    stays on the f32 ``fused_mlp_fwd``. The counts are of launches that
    reach the device (the wrappers' ``launches``), so they hold for solves
    of at least one row: a solve over 0 rows launches nothing.
    """
    steps = horizon * (solves + (1 if materialize else 2) * trips)
    terminal = solves + trips
    advances = members * horizon * solves if projection else 0
    scan = (0, steps) if fused else (members * steps, 0)  # (MLP, fused step) launches
    if bf16:
        return {"fused_mlp_fwd": terminal + advances, "fused_ls_step": 0,
                "fused_mlp_fwd_bf16": scan[0], "fused_ls_step_bf16": scan[1]}
    return {"fused_mlp_fwd": scan[0] + terminal + advances, "fused_ls_step": scan[1]}


def batch_ilqr(
    problem: BatchProblem,
    x0: torch.Tensor,
    U0: torch.Tensor,
    settings: SolverSettings = SolverSettings(),
) -> ILQRSolution:
    """Solve B planning problems jointly. x0 (B,n), U0 (B,T,m).

    Returns an ILQRSolution whose fields carry a leading batch axis
    (X (B,T+1,n), U (B,T,m), ...), and the trips the loop ran.
    """
    x0 = x0.to(torch.float32).contiguous()
    U0 = U0.to(torch.float32).transpose(0, 1).contiguous()  # -> (T, B, m)
    T, B, m = U0.shape
    n = x0.shape[-1]
    _check_settings(settings, problem)
    materialize = ls_materializes(settings, T, B, n, m)
    dev = x0.device
    alphas = settings.alpha_0 * settings.alpha_decay ** torch.arange(
        settings.num_alphas, dtype=torch.float32, device=dev
    )

    X, obj = batch_rollout(problem, U0, x0)
    U = U0
    grad = torch.full((T, B, m), float("inf"), device=dev)
    adj = torch.zeros((T + 1, B, n), device=dev)
    reg = torch.full((B,), settings.reg_init, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    converged = torch.zeros((B,), dtype=torch.bool, device=dev)

    # JAX's ``while any(active)``: inactive lanes change no state, so the
    # outputs are those of all max_iterations trips.
    trips = 0
    while trips < settings.max_iterations:
        if trips and not bool(active.any()):
            break
        trips += 1
        A, Bm = problem.dynamics_jac(X[:-1], U)
        cx, cu, cxx, cuu, cux = problem.quad(X, U)
        if settings.riccati == "associative":
            k, K, adjoints, g = _backward_associative(A, Bm, cx, cu, cxx, cuu, cux, reg,
                                                      settings.psd_delta)
        else:
            k, K, adjoints, g = _backward(A, Bm, cx, cu, cxx, cuu, cux, reg,
                                          settings.psd_delta if problem.per_instance else 0.0)
        gnorm = torch.sqrt(torch.sum(g * g, dim=(0, 2)))
        grad_small = gnorm < settings.grad_norm_tol

        objs = _line_search_objs(problem, X, U, k, K, alphas, materialize)
        if materialize:
            objs, (Xc, Uc) = objs
        objs = torch.where(torch.isfinite(objs), objs, float("inf"))
        best = torch.argmin(objs, dim=1)
        best_obj = torch.gather(objs, 1, best[:, None])[:, 0]
        improved = best_obj < obj
        take = active & ~grad_small & improved
        if materialize:
            # the winner is a gather over the alpha axis (a copy, not a
            # view into the candidates); the states get X[0] back in front
            sel = best[None, :, None, None]
            Xb = torch.cat([X[:1], torch.gather(Xc, 2, sel.expand(T, B, 1, n))[:, :, 0]])
            Ub = torch.gather(Uc, 2, sel.expand(T, B, 1, m))[:, :, 0]
        else:
            alpha_b = torch.where(take, alphas[best], 0.0)
            Xb, Ub = _forward_best(problem, X, U, k, K, alpha_b)

        mask_tb = take[None, :, None]
        objn = torch.where(take, best_obj, obj)
        X = torch.where(mask_tb, Xb, X)
        U = torch.where(mask_tb, Ub, U)
        adj = torch.where((active & ~grad_small)[None, :, None], adjoints, adj)
        grad = torch.where(active[None, :, None], g, grad)
        stalled = ~improved & (reg >= settings.reg_max)
        reg = torch.where(
            active,
            torch.where(
                improved,
                torch.clamp(reg * settings.reg_down, min=settings.reg_min),
                torch.clamp(reg * settings.reg_up, max=settings.reg_max),
            ),
            reg,
        )
        done_now = active & (grad_small | stalled)
        if settings.obj_step_tol > 0.0:
            step_small = improved & ((obj - objn) <= settings.obj_step_tol)
            done_now = done_now | (active & step_small)
        obj = objn
        it = it + active.to(torch.int32)
        converged = converged | done_now
        active = active & ~done_now & (it < settings.max_iterations)

    return ILQRSolution(
        X=X.transpose(0, 1),
        U=U.transpose(0, 1),
        obj=obj,
        grad=grad.transpose(0, 1),
        adjoints=adj.transpose(0, 1),
        iterations=it,
        converged=converged,
        trips=trips,
    )
