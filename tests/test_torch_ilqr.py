"""Port parity: the generic iLQR (``gan_mpc_tpu_torch/planner/ilqr.py``)
against the JAX package's ``ilqr`` on the cases of ``tests/test_ilqr.py``.

The same problems are written once in torch and once in JAX (the same
float32 arithmetic), solved by each package from the same start, and held
to the analytic LQR oracle where there is one. Tolerances:

  * LQR (one Newton step solves it): U within 1e-4 of the oracle, as the
    JAX test holds its own, and within 1e-5 of JAX's U; obj rtol 1e-5;
  * the rollout and the objective the solver reports against ``rollout``
    and ``total_cost``: X atol 1e-5, obj rtol 1e-5, as the JAX test;
  * the nonlinear pendulum (40 steps, up to 100 iterations): the JAX
    test's own checks (the objective below 0.3 of the start's, converged,
    finite), obj rtol 1e-5 of JAX's, and U within max(1e-3, 2 x JAX's own
    spread): the optimum is flat, so JAX's own U moves by 8e-3 when x0 is
    scaled by 1 +- 1e-7 (while its obj moves by 3e-7 relative), and the
    port's batch-major loop stops a lane without its last step once the
    gradient is below tolerance, where the JAX per-instance loop takes it;
  * maxiter 1: at most one iteration, U within 1e-5 of JAX's;
  * psd_delta 0 and 1e-3 on the LQR, converged, U within 1e-5 of JAX's;
    ``project_psd`` against JAX's ``_project_psd`` on random indefinite
    symmetric matrices (1e-5), and a nonconvex problem whose Quu is
    indefinite at the start, solved with psd_delta 0.1 by both (U 1e-4);
  * split stage / terminal against the combined form: U within 2e-3 and
    obj rtol 1e-5 of each other, as the JAX test, and each form within the
    same of JAX's own solve of it (the optimum is flat: at
    grad_norm_tol 1e-6 the two JAX forms differ by up to 2e-3 in U);
  * a batch of two LQR starts solved lane by lane equals the single solves
    (1e-5), the JAX test's ``vmap``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.planner import SolverSettings as JaxSettings
from gan_mpc_tpu.planner import ilqr as jax_ilqr
from gan_mpc_tpu_torch.planner.batch_ilqr import project_psd
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings, ilqr, rollout, total_cost

jax_ilqr_mod = importlib.import_module("gan_mpc_tpu.planner.ilqr")
torch.set_num_threads(1)

A_ = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)
B_ = np.array([[0.0], [0.1]], np.float32)
Q_, R_, QF_ = 0.5 * np.eye(2, dtype=np.float32), 0.5 * np.eye(1, dtype=np.float32), \
    5.0 * np.eye(2, dtype=np.float32)
T_LQR = 10
X0_LQR = np.array([1.0, 0.0], np.float32)


def lqr_problem(lib):
    """(cost, dynamics) of the JAX test's LQR in torch or JAX."""
    if lib is torch:
        A, B, Q, R, Qf = (torch.tensor(v) for v in (A_, B_, Q_, R_, QF_))
        where = torch.where
    else:
        A, B, Q, R, Qf = (jnp.asarray(v) for v in (A_, B_, Q_, R_, QF_))
        where = jnp.where

    def cost(x, u, t):
        stage = 0.5 * (x @ Q @ x) + 0.5 * (u @ R @ u)
        term = 0.5 * (x @ Qf @ x)
        return where(t == T_LQR, term, stage)

    def dynamics(x, u, t):
        return A @ x + B @ u

    return cost, dynamics


def lqr_oracle():
    P, Ks = QF_.astype(np.float64), []
    for _ in range(T_LQR):
        K = np.linalg.solve(R_ + B_.T @ P @ B_, B_.T @ P @ A_)
        P = Q_ + A_.T @ P @ A_ - A_.T @ P @ B_ @ K
        Ks.append(K)
    x, U = X0_LQR.astype(np.float64), []
    for K in Ks[::-1]:
        U.append(-K @ x)
        x = A_ @ x + B_ @ U[-1]
    return np.stack(U)


def solve_both(problem, x0, T, m, settings=None, terminal=False):
    """(port solution, JAX solution) of ``problem(lib)`` from x0 and U0 = 0."""
    settings = settings or {}
    pc, pd, *pt = problem(torch)
    jc, jd, *jt = problem(jnp)
    got = ilqr(pc, pd, torch.tensor(x0), torch.zeros(T, m), SolverSettings(**settings),
               pt[0] if terminal else None)
    want = jax_ilqr(jc, jd, jnp.asarray(x0), jnp.zeros((T, m)), JaxSettings(**settings),
                    jt[0] if terminal else None)
    return got, want


def test_ilqr_matches_analytic_lqr_and_jax():
    got, want = solve_both(lqr_problem, X0_LQR, T_LQR, 1)
    np.testing.assert_allclose(got.U.numpy(), lqr_oracle(), atol=1e-4)
    assert bool(got.converged) and int(got.iterations) <= 3
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=1e-5)
    np.testing.assert_allclose(float(got.obj), float(want.obj), rtol=1e-5)
    assert got.X.shape == (T_LQR + 1, 2) and got.adjoints.shape == (T_LQR + 1, 2)


def test_ilqr_objective_consistent():
    cost, dynamics = lqr_problem(torch)
    x0 = torch.tensor(X0_LQR)
    sol = ilqr(cost, dynamics, x0, torch.zeros(T_LQR, 1))
    X = rollout(dynamics, sol.U, x0)
    np.testing.assert_allclose(sol.X.numpy(), X.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(sol.obj), float(total_cost(cost, X, sol.U)), rtol=1e-5)
    jc, jd = lqr_problem(jnp)
    jU = jnp.asarray(sol.U.numpy())
    jX = jax_ilqr_mod.rollout(jd, jU, jnp.asarray(X0_LQR))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=1e-6)
    np.testing.assert_allclose(float(total_cost(cost, X, sol.U)),
                               float(jax_ilqr_mod.total_cost(jc, jX, jU)), rtol=1e-6)


def pendulum_problem(lib):
    dt = 0.05
    if lib is torch:
        sin, cos, tanh, stack, where = torch.sin, torch.cos, torch.tanh, torch.stack, torch.where
    else:
        sin, cos, tanh, stack, where = jnp.sin, jnp.cos, jnp.tanh, jnp.stack, jnp.where

    def dynamics(x, u, t):
        th, thdot = x[0], x[1]
        thddot = -9.81 * sin(th) + 5.0 * tanh(u[0])
        thdot = thdot + dt * thddot
        return stack([th + dt * thdot, thdot])

    def cost(x, u, t):
        upright = (cos(x[0]) - 1.0) ** 2 + 0.05 * x[1] ** 2
        return where(t == 40, 20.0 * upright, upright + 0.01 * u[0] ** 2)

    return cost, dynamics


def test_ilqr_nonlinear_pendulum_converges_as_jax():
    x0 = np.array([np.pi - 0.4, 0.3], np.float32)
    cost, dynamics = pendulum_problem(torch)
    U0 = torch.zeros(40, 1)
    obj0 = float(total_cost(cost, rollout(dynamics, U0, torch.tensor(x0)), U0))
    got, want = solve_both(pendulum_problem, x0, 40, 1, dict(max_iterations=100))
    assert float(got.obj) < 0.3 * obj0
    assert bool(got.converged) and bool(torch.isfinite(got.U).all())
    np.testing.assert_allclose(float(got.obj), float(want.obj), rtol=1e-5)
    jc, jd = pendulum_problem(jnp)
    spread = max(np.abs(np.asarray(jax_ilqr(jc, jd, jnp.asarray(x0 * s), jnp.zeros((40, 1)),
                                            JaxSettings(max_iterations=100)).U)
                        - np.asarray(want.U)).max() for s in (1 + 1e-7, 1 - 1e-7))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=max(1e-3, 2 * spread))


def test_ilqr_solves_a_batch_lane_by_lane():
    cost, dynamics = lqr_problem(torch)
    x0s = torch.tensor([[1.0, 0.0], [-0.5, 0.3]])
    sols = ilqr(cost, dynamics, x0s, torch.zeros(2, T_LQR, 1))
    assert sols.U.shape == (2, T_LQR, 1) and bool(sols.converged.all())
    for i in range(2):
        single = ilqr(cost, dynamics, x0s[i], torch.zeros(T_LQR, 1))
        np.testing.assert_allclose(sols.U[i].numpy(), single.U.numpy(), atol=1e-5)


def test_ilqr_respects_maxiter():
    got, want = solve_both(lqr_problem, X0_LQR, T_LQR, 1, dict(max_iterations=1))
    assert int(got.iterations) <= 1 and got.trips == 1
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=1e-5)


@pytest.mark.parametrize("psd_delta", [0.0, 1e-3])
def test_ilqr_psd_option(psd_delta):
    got, want = solve_both(lqr_problem, X0_LQR, T_LQR, 1, dict(psd_delta=psd_delta))
    assert bool(got.converged)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=1e-5)


def test_project_psd_matches_jax():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 3, 3)).astype(np.float32)
    for delta in (1e-3, 0.5):
        got = project_psd(torch.tensor(M), delta).numpy()
        want = np.stack([np.asarray(jax_ilqr_mod._project_psd(jnp.asarray(m), delta))
                         for m in M])
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (np.linalg.eigvalsh(got) >= delta - 1e-5).all()


def nonconvex_problem(lib):
    """Action cost 0.05 u^2 - 0.3 u^2 exp(-|x|^2): concave in u near the
    origin, so Quu is indefinite at the start and the projection acts."""
    exp = torch.exp if lib is torch else jnp.exp
    A, B = (lib.tensor(v) if lib is torch else jnp.asarray(v) for v in (A_, B_))

    def cost(x, u, t):
        return (x @ x) + (0.05 - 0.3 * exp(-(x @ x))) * (u @ u) + 0.1 * (u @ u) ** 2

    def dynamics(x, u, t):
        return A @ x + B @ u

    def terminal(x):
        return 5.0 * (x @ x)

    return cost, dynamics, terminal


def test_ilqr_psd_projection_on_an_indefinite_problem():
    x0 = np.array([0.3, -0.2], np.float32)
    settings = dict(psd_delta=0.1, max_iterations=50)
    got, want = solve_both(nonconvex_problem, x0, 8, 1, settings, terminal=True)
    assert bool(torch.isfinite(got.U).all())
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=1e-4)
    np.testing.assert_allclose(float(got.obj), float(want.obj), rtol=1e-5)


def split_problem(lib):
    T = 8
    if lib is torch:
        tanh, sin, where, total = torch.tanh, torch.sin, torch.where, torch.sum
    else:
        tanh, sin, where, total = jnp.tanh, jnp.sin, jnp.where, jnp.sum

    def stage(x, u, t):
        return total((x - 0.3) ** 2) + 0.05 * total(u ** 2)

    def terminal(x):
        return 4.0 * total(tanh(x) ** 2)

    def combined(x, u, t):
        return where(t == T, terminal(x), stage(x, u, t))

    def dynamics(x, u, t):
        return x + 0.1 * tanh(u) + 0.05 * sin(x)

    return stage, dynamics, terminal, combined


def test_split_terminal_cost_matches_combined_and_jax():
    x0 = np.array([0.6, -0.4], np.float32)
    settings = dict(grad_norm_tol=1e-6, max_iterations=300)
    split, jsplit = solve_both(split_problem, x0, 8, 2, settings, terminal=True)

    def combined(lib):
        _, dynamics, _, comb = split_problem(lib)
        return comb, dynamics

    comb, jcomb = solve_both(combined, x0, 8, 2, settings)
    np.testing.assert_allclose(comb.U.numpy(), split.U.numpy(), atol=2e-3)
    np.testing.assert_allclose(float(comb.obj), float(split.obj), rtol=1e-5)
    for got, want in ((split, jsplit), (comb, jcomb)):
        np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=2e-3)
        np.testing.assert_allclose(float(got.obj), float(want.obj), rtol=1e-5)
