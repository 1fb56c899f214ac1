"""Parallel-in-time Riccati backward pass by an associative scan.

Counterpart of ``gan_mpc_tpu/planner/parallel_riccati.py``: the same
time-varying LQR value functions as the sequential recursion in O(log T)
depth, by the temporal parallelization of Särkkä & García-Fernández
(2021). Each time step is an element of an associative semigroup of
conditional value functions; combining two elements composes their
segments.

Representation. A segment [k, l) is summarized by (A, b, C, eta, J) with

    E(x_k, x_l) = 1/2 x_k^T J x_k - eta^T x_k + 1/2 |w|^2,
    x_l = A x_k + b + M w,  C = M M^T,

and two segments compose over their shared midpoint (``_combine``). Cross
terms (c_ux) are removed first by completing the square, the linear
control cost folds into the offset b, and the stage state costs are
projected onto the PSD cone, as in the JAX package. The value function at
k is that of the suffix element [k, T], from which the gains are recovered
pointwise.

PyTorch has no ``associative_scan``: ``associative_scan`` here is the
odd/even recursion ``jax.lax.associative_scan`` uses, so the combines
follow the same tree. Each of its levels is one batched ``_combine`` over
every pair of the level and every lane; a scan over N elements calls
``_combine`` ``scan_combines(N)`` times, about 2 log2 N, where the
sequential recursion takes N dependent steps.

Every function takes time-major inputs with any batch axes between the
time axis and the matrix axes: one problem as (T, n, n), a batch of lanes
as (T, B, n, n).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from gan_mpc_tpu_torch.planner.linalg import solve_spd

Elems = Tuple[torch.Tensor, ...]


def _mT(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _combine(earlier: Elems, later: Elems) -> Elems:
    """Compose segment ``earlier`` (in time) with ``later``; any leading
    axes batch. With D = I + C1 J2:

        A12   = A2 D^-1 A1
        b12   = A2 D^-1 (b1 + C1 eta2) + b2
        C12   = A2 D^-1 C1 A2^T + C2
        eta12 = A1^T (I + J2 C1)^-1 (eta2 - J2 b1) + eta1
        J12   = A1^T J2 D^-1 A1 + J1

    (``torch.linalg.solve``, as the JAX package uses ``jnp.linalg.solve``;
    the three solves against D are one solve of their stacked columns)."""
    A1, b1, C1, eta1, J1 = earlier
    A2, b2, C2, eta2, J2 = later
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    D = eye + C1 @ J2
    Dt = eye + J2 @ C1  # D^T where C1 and J2 are symmetric
    sol = torch.linalg.solve(D, torch.cat([A1, C1, (b1 + _mv(C1, eta2))[..., None]], dim=-1))
    DA1, DC1, Db = sol[..., :n], sol[..., n:2 * n], sol[..., 2 * n]
    A12 = A2 @ DA1
    b12 = _mv(A2, Db) + b2
    C12 = A2 @ DC1 @ _mT(A2) + C2
    C12 = (C12 + _mT(C12)) / 2.0
    eta12 = _mv(_mT(A1), torch.linalg.solve(Dt, (eta2 - _mv(J2, b1))[..., None])[..., 0]) + eta1
    J12 = _mT(A1) @ (J2 @ DA1) + J1
    J12 = (J12 + _mT(J12)) / 2.0
    return A12, b12, C12, eta12, J12


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0] + odd.shape[0],) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn: Callable[[Elems, Elems], Elems], elems: Sequence[torch.Tensor]) -> Elems:
    """Inclusive scan over axis 0 with the associative ``fn(a, b)`` (``a``
    the earlier part): element i of the result combines elements 0..i.
    The recursion of ``jax.lax.associative_scan``: combine neighbouring
    pairs, scan the half-length result (the odd outputs), then combine each
    odd output with the next even input (the even outputs)."""
    elems = tuple(elems)
    num = elems[0].shape[0]
    if num < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if num > 2:
        heads = odd if num % 2 else tuple(e[:-1] for e in odd)
        even = fn(heads, tuple(e[2::2] for e in elems))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    else:
        even = tuple(e[:1] for e in elems)
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def scan_combines(num: int) -> int:
    """How many batched ``fn`` calls ``associative_scan`` makes over
    ``num`` elements."""
    if num < 2:
        return 0
    return 1 + scan_combines(num // 2) + (1 if num > 2 else 0)


def _psd(M: torch.Tensor) -> torch.Tensor:
    """Symmetric M with its negative eigenvalues set to 0. The
    eigendecomposition runs in float64: on the card cuSOLVER's float32
    Jacobi solver fails to converge on the pseudo-Huber stage cost's
    Hessian, whose eigenvalues are all equal but one (seen at the
    humanoid-class row: 28 of 29), where LAPACK's float32 one, the JAX
    package's on the CPU, does not."""
    w, v = torch.linalg.eigh(M.double())
    return ((v * torch.clamp(w, min=0.0)[..., None, :]) @ _mT(v)).to(M.dtype)


def parallel_backward_pass(A, B, cx, cu, cxx, cuu, cux, reg, psd_delta=0.0):
    """The associative counterpart of the sequential Riccati pass.

    A (T, ..., n, n), B (T, ..., n, m); cx, cxx (T+1, ...) with the
    terminal row; cu, cuu, cux (T, ...) or (T+1, ...), a terminal row
    ignored; reg a scalar or one per lane (...). Returns (k (T, ..., m),
    K (T, ..., m, n), Qu (T, ..., m), dv1 (...), dv2 (...), adjoints
    (T+1, ..., n)), the JAX function's contract. ``psd_delta`` is not read
    (the JAX pass regularizes the gain solve with ``reg`` alone).
    """
    del psd_delta
    T = A.shape[0]
    m = B.shape[-1]
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    reg = torch.as_tensor(reg, dtype=A.dtype, device=A.device)
    Bt = _mT(B)

    # The elements take a fixed tiny ridge (U must be invertible); ``reg``
    # enters the pointwise gain recovery alone, as the sequential pass
    # regularizes its gain solve and propagates the unregularized value.
    U = cuu[:T] + 1e-6 * eye_m
    S, q, r = cux[:T], cx[:T], cu[:T]
    # complete the square: u = u~ - U^-1 S x
    Uinv_S = solve_spd(U, S)
    Uinv_r = solve_spd(U, r[..., None])[..., 0]
    F = A - B @ Uinv_S
    X = cxx[:T] - _mT(S) @ Uinv_S
    X = _psd((X + _mT(X)) / 2.0)
    q_t = q - _mv(_mT(S), Uinv_r)
    C = B @ solve_spd(U, Bt)
    b = -_mv(B, Uinv_r)
    # the terminal element: a cost and no transition
    zn = torch.zeros_like(A[:1])
    elems = (
        torch.cat([F, zn]),
        torch.cat([b, torch.zeros_like(cx[:1])]),
        torch.cat([C, zn]),
        torch.cat([-q_t, -cx[T:T + 1]]),
        torch.cat([X, _psd(cxx[T:T + 1])]),
    )

    # suffixes: a scan of the time-reversed elements, each combined as the
    # earlier segment with the later one already composed
    suffix = associative_scan(lambda later, earlier: _combine(earlier, later),
                              tuple(e.flip(0) for e in elems))
    P = suffix[4].flip(0)  # (T+1, ..., n, n) value Hessians
    p = -suffix[3].flip(0)  # (T+1, ..., n) value gradients

    # the gains from V_{t+1}, every step at once
    P1, p1 = P[1:], p[1:]
    BtP = Bt @ P1
    Quu0 = cuu[:T] + BtP @ B
    Quu = Quu0 + reg[..., None, None] * eye_m
    Qu = cu[:T] + _mv(Bt, p1)
    Qux = cux[:T] + BtP @ A
    kK = solve_spd(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
    k, K = -kK[..., 0], -kK[..., 1:]
    dv1 = (k * Qu).sum(-1).sum(0)
    dv2 = 0.5 * (k * _mv(Quu0, k)).sum(-1).sum(0)
    return k, K, Qu, dv1, dv2, p
