"""Port parity: the associative (parallel-in-time) Riccati backward pass
(``gan_mpc_tpu_torch/planner/parallel_riccati.py``) against the JAX
package, float32 on the CPU, inputs from a numpy seed.

  1. ``associative_scan`` against a plain left fold of matrix products
     (non-commuting), at every length from 1 to 13, and its count of
     batched combines (about 2 log2 N);
  2. ``parallel_backward_pass`` against JAX's on the (T, n, m) cases of
     ``tests/test_parallel_riccati.py`` (the odd tiny horizon and H=50):
     rtol 1e-4, atol 1e-5 on k, K, Qu, dv1, dv2 and the adjoints (the same
     algorithm; the solves, the eigendecompositions and the sums round in
     another order), and against the port's sequential ``_backward`` with
     the JAX test's own rtol and atol 2e-3 (the associative pass propagates
     the unregularized value function and projects the stage costs onto
     the PSD cone, so the two agree to a tolerance, not to rounding);
  3. ``_backward_associative`` against JAX's on fixed batched inputs (k, K,
     the adjoints and G; dv1 and dv2 through ``parallel_backward_pass`` on
     the same lanes), rtol 1e-4, atol 1e-5, and G against the sequential
     costate recursion (2e-5, the JAX test's bound);
  4. ``batch_ilqr(riccati="associative")`` against JAX's on the batched LQR
     of ``tests/test_batch_ilqr.py`` (3 lanes, T=24; every lane converges
     early, at the default gradient tolerance): U, X and obj rtol and atol
     1e-5, the adjoints (the pass's own output) as in 2., equal iterations;
     the gradient at the solution, whose
     norm both hold below the 1e-4 tolerance, is a rounding-level residue
     of cancelling terms (3e-5 apart): atol 1e-4;
  5. the generic ``ilqr`` with ``riccati="associative"`` against JAX's
     ``ilqr`` on the double integrator of ``tests/test_parallel_riccati.py``
     (T=30, a per-instance problem): U atol 1e-5, obj rtol 1e-5;
  6. one flagship ``plan_batch`` at the tiny flagship's widths (H=10, 3
     iLQR trips, 8 envs, histories 0.01 N(0, 1) about the origin) with the
     associative pass against JAX's: each lane's U within max(1e-4, twice
     JAX's own spread under 1 +- 1e-7 scalings of the histories), equal
     iterations (measured: 4e-7 against a spread of 3e-7; at 0.3 N(0, 1)
     the random-weight problem is chaotic at 3 trips, JAX against itself
     moving by 4e-2 under those nudges).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gan_mpc_tpu.planner import SolverSettings as JaxSettings
from gan_mpc_tpu.planner import ilqr as jax_ilqr
from gan_mpc_tpu.planner.batch_ilqr import BatchProblem as JaxProblem
from gan_mpc_tpu.planner.batch_ilqr import batch_ilqr as jax_batch_ilqr
from gan_mpc_tpu.planner.parallel_riccati import parallel_backward_pass as jax_parallel
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import from_jax_params
from gan_mpc_tpu_torch.planner.batch_ilqr import (
    BatchProblem,
    _backward,
    _backward_associative,
    batch_ilqr,
)
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings, ilqr
from gan_mpc_tpu_torch.planner.parallel_riccati import (
    associative_scan,
    parallel_backward_pass,
    scan_combines,
)
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
from test_torch_planner import JAX_OPS, TORCH_OPS, _lqr, _lqr_problem

jbi = importlib.import_module("gan_mpc_tpu.planner.batch_ilqr")

torch.set_num_threads(1)
pin_fp32()

RTOL, ATOL = 1e-4, 1e-5
NAMES = ["k", "K", "Qu", "dv1", "dv2", "adjoints"]


def _terms(T, n, m, seed, lanes=()):
    """Random LQR terms as ``tests/test_parallel_riccati.py`` draws them
    (numpy): (A, B, cx, cu, cxx, cuu, cux), the u-terms with a terminal
    row, the batch axes ``lanes`` after time."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    L = tuple(lanes)
    A = np.eye(n, dtype=np.float32) + 0.1 * f(T, *L, n, n)

    def psd(d):
        Ms = f(T + 1, *L, d, d)
        return 0.3 * Ms @ np.swapaxes(Ms, -1, -2) + np.eye(d, dtype=np.float32)

    return (A, 0.3 * f(T, *L, n, m), 0.5 * f(T + 1, *L, n), 0.5 * f(T + 1, *L, m),
            psd(n), psd(m), 0.2 * f(T + 1, *L, m, n))


@pytest.mark.parametrize("num", list(range(1, 14)))
def test_associative_scan_is_the_prefix_fold(num):
    rng = np.random.default_rng(num)
    mats = torch.from_numpy(rng.standard_normal((num, 3, 3)).astype(np.float64))
    calls = []

    def mul(a, b):
        calls.append(a[0].shape[0])
        return (a[0] @ b[0],)

    (got,) = associative_scan(mul, (mats,))
    want = [mats[0]]
    for i in range(1, num):
        want.append(want[-1] @ mats[i])
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-12, atol=1e-12)
    assert len(calls) == scan_combines(num)
    assert scan_combines(num) <= 2 * int(np.ceil(np.log2(max(num, 2))))


@pytest.mark.parametrize("T,n,m", [(5, 3, 1), (50, 4, 2)])
def test_parallel_backward_pass_matches_jax(T, n, m):
    terms = _terms(T, n, m, seed=T)
    want = jax_parallel(*map(jnp.asarray, terms), jnp.float32(1e-6))
    got = parallel_backward_pass(*map(torch.from_numpy, terms), 1e-6)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,n,m", [(5, 3, 1), (50, 4, 2)])
def test_parallel_backward_pass_matches_the_sequential_pass(T, n, m):
    """Against the port's own ``_backward`` on one lane (the JAX test's
    bounds against JAX's sequential pass)."""
    terms = _terms(T, n, m, seed=100 + T, lanes=(1,))
    A, B, cx, cu, cxx, cuu, cux = map(torch.from_numpy, terms)
    reg = torch.full((1,), 1e-6)
    k, K, adjoints, _ = _backward(A, B, cx, cu[:T], cxx, cuu[:T], cux[:T], reg)
    pk, pK, _, _, _, padj = parallel_backward_pass(A, B, cx, cu, cxx, cuu, cux, reg)
    for name, a, b in (("k", pk, k), ("K", pK, K), ("adjoints", padj, adjoints)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3, msg=name)


def test_backward_associative_matches_jax():
    T, lanes, n, m = 24, 3, 3, 2
    A, Bm, cx, cu, cxx, cuu, cux = _terms(T, n, m, seed=7, lanes=(lanes,))
    cu, cuu, cux = cu[:T], cuu[:T], cux[:T]  # the batch solver's shapes: no terminal row
    reg = np.array([1e-6, 1e-3, 1.0], np.float32)
    jk, jK, jdv1, jdv2, jadj, jG = jbi._backward_associative(
        *map(jnp.asarray, (A, Bm, cx, cu, cxx, cuu, cux, reg)), JaxSettings())
    t = [torch.from_numpy(v) for v in (A, Bm, cx, cu, cxx, cuu, cux, reg)]
    k, K, adj, G = _backward_associative(*t, 0.0)
    _, _, _, dv1, dv2, _ = parallel_backward_pass(*t)
    for name, g, w in (("k", k, jk), ("K", K, jK), ("adjoints", adj, jadj), ("G", G, jG),
                       ("dv1", dv1, jdv1), ("dv2", dv2, jdv2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    G_seq = jbi._adjoint_gradient(*map(jnp.asarray, (A, Bm, cx, cu)))
    np.testing.assert_allclose(G.numpy(), np.asarray(G_seq), rtol=2e-5, atol=2e-5)
    # psd_delta is passed and not read, as in the JAX pass
    for a, b in zip(_backward_associative(*t, 0.5), (k, K, adj, G)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_batch_ilqr_associative_matches_jax():
    A, Bm, Q, R, x0 = _lqr(B=3, n=3, m=2, seed=1)
    T = 24
    U0 = np.zeros((3, T, 2), np.float32)
    jprob = JaxProblem(**_lqr_problem(JAX_OPS, *map(jnp.asarray, (A, Bm, Q, R))))
    settings = dict(max_iterations=8, riccati="associative")
    ref = jax_batch_ilqr(jprob, jnp.asarray(x0), jnp.asarray(U0), JaxSettings(**settings))
    prob = BatchProblem(**_lqr_problem(TORCH_OPS, *map(torch.from_numpy, (A, Bm, Q, R))))
    got = batch_ilqr(prob, torch.from_numpy(x0), torch.from_numpy(U0), SolverSettings(**settings))
    assert np.all(np.asarray(ref.converged))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for name in ("X", "U", "obj"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.adjoints.numpy(), np.asarray(ref.adjoints), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref.grad), rtol=0, atol=1e-4)


def _double_integrator(lib, T):
    """The LQR of ``tests/test_parallel_riccati.py``, in torch or JAX."""
    where = torch.where if lib is torch else jnp.where
    A = lib.tensor([[1.0, 0.1], [0.0, 1.0]]) if lib is torch else jnp.array(
        [[1.0, 0.1], [0.0, 1.0]])
    B = lib.tensor([[0.0], [0.1]]) if lib is torch else jnp.array([[0.0], [0.1]])

    def cost(x, u, t):
        stage = 0.5 * (x ** 2).sum() + 0.05 * (u ** 2).sum()
        return where(t == T, 5.0 * (x ** 2).sum(), stage)

    def dyn(x, u, t):
        return A @ x + B @ u

    return cost, dyn


def test_generic_ilqr_associative_matches_jax():
    T = 30
    x0 = np.array([1.0, -0.5], np.float32)
    jc, jd = _double_integrator(jnp, T)
    want = jax_ilqr(jc, jd, jnp.asarray(x0), jnp.zeros((T, 1)),
                    JaxSettings(riccati="associative"))
    pc, pd = _double_integrator(torch, T)
    got = ilqr(pc, pd, torch.from_numpy(x0), torch.zeros(T, 1),
               SolverSettings(riccati="associative"))
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.obj), float(want.obj), rtol=1e-5)
    seq = ilqr(pc, pd, torch.from_numpy(x0), torch.zeros(T, 1), SolverSettings())
    np.testing.assert_allclose(got.U.numpy(), seq.U.numpy(), rtol=0, atol=1e-3)


H, ITERS, B_PLAN, X, U = 10, 3, 8, 17, 6


def test_flagship_plan_associative_matches_jax():
    jpolicy, jparams, _, _ = graft._flagship(horizon=H, max_iterations=ITERS, tiny=True,
                                             x_size=X, u_size=U, riccati="associative")
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(X, hidden=(16,), features_out=4), H,
                           mpc_weights=(-2.0, 3.0, -3.0)),
        dynamics_model=LearnedDynamics(ResidualMLPDynamicsNet(X, U, hidden=(16,))),
        expert_model=ExpertPredictor(X, U, arch="lstm", features=8, hidden=(16,)),
        horizon=H,
        settings=SolverSettings(max_iterations=ITERS, riccati="associative"),
    )
    policy = from_jax_params(jax.device_get(jparams), policy).requires_grad_(False)
    rng = np.random.default_rng(3)
    hX = (0.01 * rng.standard_normal((B_PLAN, 2, X))).astype(np.float32)
    hU = np.zeros((B_PLAN, 1, U), np.float32)
    ref = jpolicy.plan_batch(jparams, jnp.asarray(hX), jnp.asarray(hU))
    ref_U = np.asarray(ref.U)
    spread = np.zeros(B_PLAN)
    for scale in (1 + 1e-7, 1 - 1e-7):
        nudged = jpolicy.plan_batch(jparams, jnp.asarray(hX * scale), jnp.asarray(hU))
        spread = np.maximum(spread, np.abs(np.asarray(nudged.U) - ref_U).max(axis=(1, 2)))
    got = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    d = np.abs(got.U.numpy() - ref_U).max(axis=(1, 2))
    assert np.all(d <= np.maximum(1e-4, 2 * spread)), (d, spread)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
