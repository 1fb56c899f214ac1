"""Port parity: the batch planner against the JAX package.

``solve_spd`` on SPD systems from a numpy seed (atol 1e-5); the batch
iLQR on a batched LQR problem where every lane converges before the
iteration cap (the port's loop, which stops once no lane is active and
reports the trips it ran, against JAX's ``while any(active)``); the
materializing line search on the same oracle, forced and resolved by
"auto" (rtol and atol 1e-5), and against the port's recompute (atol
1e-6); the launch counts of both strategies against the callbacks a
solve made; and one full flagship ``plan_batch`` solve on 8 envs with
weights carried across by ``from_jax_params`` (U atol 1e-4,
``iterations`` and ``converged`` equal), at H=5 and at H=16, where
"auto" materializes. Float32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gan_mpc_tpu.planner import SolverSettings as JaxSettings
from gan_mpc_tpu.planner.batch_ilqr import BatchProblem as JaxProblem
from gan_mpc_tpu.planner.batch_ilqr import batch_ilqr as jax_batch_ilqr
from gan_mpc_tpu.planner.linalg import solve_spd as jax_solve_spd
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import flagship
from gan_mpc_tpu_torch.params import from_jax_params
from gan_mpc_tpu_torch.planner.batch_ilqr import (
    BatchProblem,
    batch_ilqr,
    ls_materializes,
    mlp_calls_per_solve,
)
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.planner.linalg import solve_spd

torch.set_num_threads(1)
pin_fp32()


@pytest.mark.parametrize("m,k", [(6, 7), (12, 1), (20, 3)],
                         ids=["cheetah", "humanoid", "rolled"])
def test_solve_spd_matches_jax(m, k):
    rng = np.random.default_rng(m)
    G = rng.standard_normal((10, m, m)).astype(np.float32)
    A = G @ G.transpose(0, 2, 1) + m * np.eye(m, dtype=np.float32)
    Bv = rng.standard_normal((10, m, k)).astype(np.float32)
    ref = np.asarray(jax_solve_spd(jnp.asarray(A), jnp.asarray(Bv)))
    got = solve_spd(torch.from_numpy(A), torch.from_numpy(Bv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(A @ got, Bv, rtol=0, atol=1e-4)


def _lqr(B=6, n=4, m=2, seed=0):
    rng = np.random.default_rng(seed)
    A = (np.eye(n) + 0.05 * rng.standard_normal((B, n, n))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, n, m))).astype(np.float32)
    Q, R = np.eye(n, dtype=np.float32), 0.1 * np.eye(m, dtype=np.float32)
    x0 = rng.standard_normal((B, n)).astype(np.float32)
    return A, Bm, Q, R, x0


JAX_OPS = (jnp.einsum, lambda M, lead: jnp.broadcast_to(M, lead + M.shape), jnp.zeros)
TORCH_OPS = (torch.einsum, lambda M, lead: M.expand(*lead, *M.shape), torch.zeros)


def _lqr_problem(ops, A, Bm, Q, R):
    """The same batched LQR callbacks in either framework; ``ops`` is
    (einsum, broadcast to leading dims, zeros)."""
    e, bcast, zeros = ops

    def quad(X, U):
        T1, Bn, n = X.shape
        T, m = T1 - 1, U.shape[-1]
        return (e("ij,tbj->tbi", Q, X), e("ij,tbj->tbi", R, U),
                bcast(Q, (T1, Bn)), bcast(R, (T, Bn)), zeros((T, Bn, m, n)))

    return dict(
        dynamics_step=lambda X, U, t: e("bij,bkj->bki", A, X) + e("bij,bkj->bki", Bm, U),
        dynamics_jac=lambda X, U: (bcast(A, X.shape[:1]), bcast(Bm, X.shape[:1])),
        stage_cost=lambda X, U, t: 0.5 * (e("bki,ij,bkj->bk", X, Q, X)
                                          + e("bki,ij,bkj->bk", U, R, U)),
        terminal_cost=lambda X: 0.5 * e("bki,ij,bkj->bk", X, Q, X),
        quad=quad,
    )


def test_batch_ilqr_matches_jax_when_lanes_converge_early():
    A, Bm, Q, R, x0 = _lqr()
    T = 6
    U0 = np.zeros((x0.shape[0], T, Bm.shape[-1]), np.float32)
    jprob = JaxProblem(**_lqr_problem(JAX_OPS, *map(jnp.asarray, (A, Bm, Q, R))))
    ref = jax_batch_ilqr(jprob, jnp.asarray(x0), jnp.asarray(U0),
                         JaxSettings(max_iterations=8))
    prob = BatchProblem(**_lqr_problem(TORCH_OPS, *map(torch.from_numpy, (A, Bm, Q, R))))
    got = batch_ilqr(prob, torch.from_numpy(x0), torch.from_numpy(U0),
                     SolverSettings(max_iterations=8))
    # the exact Newton step converges every lane well before the cap
    assert np.all(np.asarray(ref.converged)) and np.all(np.asarray(ref.iterations) < 8)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    assert got.trips == int(np.asarray(ref.iterations).max()) < 8
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for name in ("X", "U", "obj", "grad", "adjoints"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=1e-5, err_msg=name,
        )


def _counted(callbacks, counts):
    """The problem's callbacks, each call of the MLP-launching ones
    (``dynamics_step``, ``terminal_cost``, ``ls_step``) counted."""
    def wrap(name, fn):
        def counted(*args):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args)
        return counted
    return {name: wrap(name, fn) if name in ("dynamics_step", "terminal_cost", "ls_step")
            else fn for name, fn in callbacks.items()}


def _lqr_ls_step(A, Bm, Q, R):
    """The LQR's fused forward-scan step: control law, stage cost and
    dynamics in one call, as ``BatchProblem.ls_step`` takes it."""
    def ls_step(x, Xref, Uref, alphaBA, kt, Kt, t):
        u = (Uref[:, None] + alphaBA[..., None] * kt[:, None]
             + torch.einsum("bmn,ban->bam", Kt, x - Xref[:, None]))
        cost = 0.5 * (torch.einsum("bki,ij,bkj->bk", x, Q, x)
                      + torch.einsum("bki,ij,bkj->bk", u, R, u))
        nx = torch.einsum("bij,bkj->bki", A, x) + torch.einsum("bij,bkj->bki", Bm, u)
        return nx, u, cost
    return ls_step


@pytest.mark.parametrize("mode,T", [("materialize", 5), ("auto", 16)],
                         ids=["materialize_T5", "auto_T16"])
def test_materializing_line_search_matches_jax(mode, T):
    """The line search that keeps every candidate and gathers the winner,
    forced at T=5 and resolved by "auto" at T=16 (JAX's rule), against
    JAX's ``batch_ilqr`` in the same mode on the LQR oracle: iterations
    and convergence equal, each field within 1e-5 max(1, max|ref|) of its
    scale. At T=16 the adjoints reach ~170 and the converged gradient
    (cu + B^T lam, ~1e-5) is the rounding left of terms that size, so its
    scale is the adjoints'. The port's dynamics calls show that no
    recompute scan ran: T per scan, one scan per trip after the rollout."""
    A, Bm, Q, R, x0 = _lqr()
    B, n, m = x0.shape[0], A.shape[-1], Bm.shape[-1]
    U0 = 0.1 * np.random.default_rng(T).standard_normal((B, T, m)).astype(np.float32)
    jprob = JaxProblem(**_lqr_problem(JAX_OPS, *map(jnp.asarray, (A, Bm, Q, R))))
    ref = jax_batch_ilqr(jprob, jnp.asarray(x0), jnp.asarray(U0),
                         JaxSettings(max_iterations=8, ls_materialize=mode))
    counts = {}
    prob = BatchProblem(**_counted(_lqr_problem(TORCH_OPS, *map(torch.from_numpy,
                                                                (A, Bm, Q, R))), counts))
    settings = SolverSettings(max_iterations=8, ls_materialize=mode)
    assert ls_materializes(settings, T, B, n, m)
    got = batch_ilqr(prob, torch.from_numpy(x0), torch.from_numpy(U0), settings)
    assert np.all(np.asarray(ref.converged))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert counts == {"dynamics_step": T * (1 + got.trips), "terminal_cost": 1 + got.trips}
    for name in ("X", "U", "obj", "grad", "adjoints"):
        scale = np.abs(np.asarray(ref.adjoints if name == "grad" else getattr(ref, name))).max()
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=0, atol=1e-5 * max(1.0, scale), err_msg=name,
        )


@pytest.mark.parametrize("fused", [False, True], ids=["callbacks", "fused_step"])
def test_materialize_matches_recompute(fused):
    """The port's two line-search strategies on the same LQR problem,
    through the separate callbacks and through a fused step: the same
    math in another schedule, so X, U and obj agree to atol 1e-6 and the
    iterations are equal. With the fused step the gathered actions are
    the ``u`` the step returned for the winning step size."""
    A, Bm, Q, R, x0 = _lqr(seed=3)
    T, m = 20, Bm.shape[-1]
    U0 = 0.1 * np.random.default_rng(1).standard_normal((x0.shape[0], T, m)).astype(np.float32)
    tensors = tuple(map(torch.from_numpy, (A, Bm, Q, R)))
    prob = BatchProblem(**_lqr_problem(TORCH_OPS, *tensors),
                        ls_step=_lqr_ls_step(*tensors) if fused else None)
    sols = {mode: batch_ilqr(prob, torch.from_numpy(x0), torch.from_numpy(U0),
                             SolverSettings(max_iterations=8, ls_materialize=mode))
            for mode in ("recompute", "materialize")}
    assert bool(sols["recompute"].converged.all())
    torch.testing.assert_close(sols["materialize"].iterations, sols["recompute"].iterations,
                               rtol=0, atol=0)
    for name in ("X", "U", "obj"):
        torch.testing.assert_close(getattr(sols["materialize"], name),
                                   getattr(sols["recompute"], name), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["recompute", "materialize"])
@pytest.mark.parametrize("fused", [False, True], ids=["callbacks", "fused_step"])
def test_launch_counts_follow_the_line_search_mode(mode, fused):
    """``mlp_calls_per_solve`` against the MLP-launching callbacks a solve
    made (a dynamics step or a fused step is one launch, a terminal cost
    one), for both strategies; 3 solves counted together. The LQR's lanes
    stop early, so the trips come from the solver."""
    A, Bm, Q, R, x0 = _lqr(seed=5)
    T = 6
    tensors = tuple(map(torch.from_numpy, (A, Bm, Q, R)))
    counts = {}
    callbacks = _lqr_problem(TORCH_OPS, *tensors)
    if fused:
        callbacks["ls_step"] = _lqr_ls_step(*tensors)
    prob = BatchProblem(**_counted(callbacks, counts))
    trips = 0
    for seed in range(3):
        U0 = np.random.default_rng(seed).standard_normal((x0.shape[0], T, 2)).astype(np.float32)
        trips += batch_ilqr(prob, torch.from_numpy(x0), torch.from_numpy(U0),
                            SolverSettings(max_iterations=8, ls_materialize=mode)).trips
    expected = mlp_calls_per_solve(T, trips, fused, solves=3,
                                   materialize=mode == "materialize")
    step = "ls_step" if fused else "dynamics_step"
    assert {"fused_mlp_fwd": counts.get("dynamics_step", 0) + counts["terminal_cost"],
            "fused_ls_step": counts.get("ls_step", 0)} == expected
    assert counts[step] == T * (3 + (1 if mode == "materialize" else 2) * trips)


def test_plan_batch_matches_jax_at_flagship_width():
    """One solve at the first control step's input: zero history and
    reset-like observations (rest pose + 0.01 noise).

    With random weights the solve is discontinuous in its input: the
    line-search argmin and the acceptance test can flip on f32 rounding,
    and some inputs sit on such a boundary (JAX against itself with the
    input scaled by 1 + 1e-7 then moves U by up to 2e-2). The test first
    checks that this input is not one of them, then holds the port to
    U atol 1e-4 with equal ``iterations`` and ``converged``.
    """
    H, iters, B = 5, 5, 8
    jpolicy, jparams, x, u = graft._flagship(
        horizon=H, max_iterations=iters, x_size=17, u_size=6
    )
    policy = from_jax_params(jax.device_get(jparams), flagship(H, iters, x, u, device="cpu"))
    rest = np.concatenate([[0.64, 0.0, 0.9, -0.75, 0.35, 0.0, 0.0, 0.0], np.zeros(9)])
    hX = np.zeros((B, 2, x), np.float32)
    hX[:, 1] = rest + 0.01 * np.random.default_rng(0).standard_normal((B, x))
    hU = np.zeros((B, 1, u), np.float32)
    ref = jpolicy.plan_batch(jparams, jnp.asarray(hX), jnp.asarray(hU))
    ref_nudged = jpolicy.plan_batch(jparams, jnp.asarray(hX * (1 + 1e-7)), jnp.asarray(hU))
    assert np.abs(np.asarray(ref_nudged.U) - np.asarray(ref.U)).max() < 1e-4
    got = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(ref.obj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "change,T,error",
    [
        # runs since the associative pass was ported: on the LQR it solves as
        # the sequential one does (tests/test_torch_parallel_riccati.py holds
        # it to JAX's)
        (dict(riccati="associative"), 5, None),
        # "on" is ported, but forces the fused step: a problem without one raises
        (dict(fused_ls="on"), 5, ValueError),
        # runs since the bf16 path was ported: MPCPolicy, which builds the
        # problem, reads the dtype; the solver's own arithmetic is f32 at
        # either, so the LQR's solution is the same bits
        # (tests/test_torch_bf16.py)
        (dict(compute_dtype="bfloat16"), 5, None),
    ],
    ids=["associative", "fused_ls", "bf16"],
)
def test_settings_outside_the_slice_raise(change, T, error):
    """Once three refusals; the fused_ls case still raises, and the two
    settings ported since solve the LQR as the defaults do (rtol and atol
    1e-5; bf16 bitwise)."""
    A, Bm, Q, R, x0 = _lqr(B=2)
    prob = BatchProblem(**_lqr_problem(TORCH_OPS, *map(torch.from_numpy, (A, Bm, Q, R))))
    settings = dataclasses.replace(SolverSettings(max_iterations=2), **change)
    if error is not None:
        with pytest.raises(error):
            batch_ilqr(prob, torch.from_numpy(x0), torch.zeros(2, T, 2), settings)
        return
    got = batch_ilqr(prob, torch.from_numpy(x0), torch.zeros(2, T, 2), settings)
    ref = batch_ilqr(prob, torch.from_numpy(x0), torch.zeros(2, T, 2),
                     SolverSettings(max_iterations=2))
    tol = 0.0 if "compute_dtype" in change else 1e-5
    for name in ("X", "U", "obj", "grad", "adjoints"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=tol, atol=tol)


@pytest.mark.parametrize("change", [dict(riccati="parallel"), dict(compute_dtype="float16")],
                         ids=["riccati", "dtype"])
def test_unknown_backward_or_dtype_raises(change):
    A, Bm, Q, R, x0 = _lqr(B=2)
    prob = BatchProblem(**_lqr_problem(TORCH_OPS, *map(torch.from_numpy, (A, Bm, Q, R))))
    settings = dataclasses.replace(SolverSettings(max_iterations=2), **change)
    with pytest.raises(ValueError, match="must be"):
        batch_ilqr(prob, torch.from_numpy(x0), torch.zeros(2, 5, 2), settings)


def test_defaults_stay_on_the_ported_path():
    A, Bm, Q, R, x0 = _lqr(B=2)
    prob = BatchProblem(**_lqr_problem(TORCH_OPS, *map(torch.from_numpy, (A, Bm, Q, R))))
    for fused in ("off", "auto"):
        sol = batch_ilqr(prob, torch.from_numpy(x0), torch.zeros(2, 5, 2),
                         SolverSettings(max_iterations=2, fused_ls=fused))
        assert sol.U.shape == (2, 5, 2)
    assert mlp_calls_per_solve(5, 5) == {"fused_mlp_fwd": 61, "fused_ls_step": 0}
    assert mlp_calls_per_solve(5, 5, fused=True) == {"fused_mlp_fwd": 6, "fused_ls_step": 55}
    # the humanoid-class row: 128 envs, H=50, 16 step sizes, n=29, m=12
    # (16.8 MB of candidates) resolves to materialize: 2 scans, not 3
    assert ls_materializes(SolverSettings(), 50, 128, 29, 12)
    assert not ls_materializes(SolverSettings(), 15, 128, 29, 12)
    assert not ls_materializes(SolverSettings(), 50, 512, 29, 12)  # 67 MB
    assert mlp_calls_per_solve(50, 5, materialize=True) == {"fused_mlp_fwd": 306,
                                                            "fused_ls_step": 0}
    assert mlp_calls_per_solve(50, 5, fused=True, materialize=True) == {
        "fused_mlp_fwd": 6, "fused_ls_step": 300}


def test_policy_paths_outside_the_slice_raise():
    """Goal projection and the per-instance path (ensemble, LSTM dynamics)
    are served since the slice that ported them (``test_torch_ensemble.py``,
    ``test_torch_lstm_dynamics.py``, ``test_torch_goal_projection.py``),
    and such dynamics train since the next one
    (``test_torch_train_ensemble.py``, ``test_torch_train_lstm_dynamics.py``:
    here the LSTM's multi-step loss gives one finite loss a window); an
    expert arch the JAX package lacks and the associative Riccati pass
    still raise."""
    from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, LSTMDynamicsNet
    from gan_mpc_tpu_torch.models.expert import ExpertPredictor
    from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
    from gan_mpc_tpu_torch.training.dynamics import multistep_prediction_loss

    policy = flagship(5, 2, device="cpu")
    projected = MPCPolicy(policy.cost_model, policy.dynamics_model, policy.expert_model,
                          goal_projection=2)
    assert projected.goal_projection == 2 and projected.batch_native
    # both of the JAX package's expert archs are ported; another raises there as here
    with pytest.raises(ValueError, match="arch"):
        ExpertPredictor(17, 6, arch="gru")

    recurrent = MPCPolicy(policy.cost_model, LearnedDynamics(LSTMDynamicsNet(17, 6, 8, (8,))),
                          policy.expert_model)
    assert not recurrent.batch_native
    x, u = torch.zeros(2, 3, 17), torch.zeros(2, 3, 6)
    losses = multistep_prediction_loss(recurrent.dynamics_model, x, u, x, 0.9, True)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    # the associative pass, once refused here, plans on the per-instance path
    # too: one trip from near rest, on random flax-style weights and a cost
    # net that reads the carry, matches the sequential pass's
    from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
    from gan_mpc_tpu_torch.params import init_flax_like

    dyn = recurrent.dynamics_model
    recurrent = MPCPolicy(MPCCost(CostFeatureNet(17 + dyn.carry_size, hidden=(16,),
                                                 features_out=4), 5),
                          dyn, policy.expert_model, horizon=5)
    init_flax_like(recurrent, torch.Generator().manual_seed(0))
    recurrent.requires_grad_(False)
    rng = np.random.default_rng(0)
    hX = torch.from_numpy(0.1 * rng.standard_normal((2, 2, 17)).astype(np.float32))
    hU = torch.from_numpy(0.1 * rng.standard_normal((2, 1, 6)).astype(np.float32))
    plans = {}
    for riccati in ("sequential", "associative"):
        recurrent.settings = SolverSettings(max_iterations=1, riccati=riccati)
        plans[riccati] = recurrent.plan_batch(hX, hU)
    assert bool(torch.isfinite(plans["associative"].U).all())
    torch.testing.assert_close(plans["associative"].U, plans["sequential"].U, rtol=0, atol=1e-4)
