"""Port parity: the implicit (bilevel) planner gradient against the JAX package.

  * The toy problem of ``tests/test_bilevel.py`` (linear dynamics with a
    learned bias, quadratic cost with learned weights, T = 8) as a
    ``BatchProblem`` over 3 start states: the port's gradients of the
    outer loss against JAX's ``make_implicit_planner`` under ``vmap`` and
    against central finite differences of the port's own loss, for both
    solvers; and the envelope gradient of the objective.
  * A small cheetah policy (H = 3, dynamics 23->32->32->17, cost
    17->16->16->4, LSTM expert with 16 features) with JAX's weights carried
    by ``params.from_jax_params``, on 8 windows: ``plan`` against
    ``jax.vmap(policy.plan)`` (U, X, obj), the Gauss-Newton Hessian against
    JAX's ``jax.hessian`` of the objective, and ``batched_loss_and_grad``
    with ``l2_imitation_loss`` against JAX's, every component, both
    solvers.

Tolerances: the loss rel 1e-4 of |ref|; each gradient max|d| <= 1e-3
max|ref|; U, X and obj atol 1e-4 (plans), the Hessian 1e-4 max|ref|;
finite differences rtol 0.05 (the JAX test's). Random-weight solves are
discontinuous in their input (the line-search argmin flips on f32
rounding): the test checks that JAX's own plan moves by less than 1e-4
when the histories are scaled by 1 +- 1e-7. Float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.models import (
    CostFeatureNet as JaxCostNet,
    ExpertPredictor as JaxExpert,
    LearnedDynamics as JaxDynamics,
    MPCCost as JaxMPCCost,
    ResidualMLPDynamicsNet as JaxResidualNet,
)
from gan_mpc_tpu.planner import SolverSettings as JaxSettings
from gan_mpc_tpu.planner import make_implicit_planner as jax_make_implicit_planner
from gan_mpc_tpu.planner.ilqr import _make_total_fn, rollout
from gan_mpc_tpu.policies import MPCPolicy as JaxPolicy
from gan_mpc_tpu.policies.losses import l2_imitation_loss as jax_l2_loss
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import from_jax_params
from gan_mpc_tpu_torch.planner.batch_ilqr import BatchProblem, batch_rollout
from gan_mpc_tpu_torch.planner.bilevel import ImplicitPlanner, dense_hessian
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy

torch.set_num_threads(1)
pin_fp32()

SOLVERS = ["dense", "cg"]

# -- the toy problem of tests/test_bilevel.py ---------------------------------

T, N, M = 8, 2, 1
A_MAT = np.array([[1.0, 0.1], [-0.05, 0.98]], np.float32)
B_MAT = np.array([[0.0], [0.1]], np.float32)
TOY_ITERS, TOY_TOL, TOY_RIDGE = 10, 1e-7, 1e-8  # the LQ toy converges in 2


def _jax_cost(x, u, t, theta, goal_X):
    goal = goal_X[t]
    stage = jnp.sum((x - goal) ** 2) * theta["w_state"] + 0.1 * jnp.sum(u**2)
    term = jnp.sum((x - goal) ** 2) * theta["w_term"]
    return jnp.where(t == T, term, stage)


def _jax_dynamics(x, u, t, theta):
    return jnp.asarray(A_MAT) @ x + jnp.asarray(B_MAT) @ u + theta["bias"]


def _toy_data():
    rng = np.random.default_rng(0)
    theta = {"w_state": np.float32(1.3), "w_term": np.float32(2.1),
             "bias": (0.01 * rng.standard_normal(N)).astype(np.float32)}
    x0 = np.array([0.8, -0.2], np.float32)
    x0s = np.stack([x0, 0.5 * x0, -x0])
    goal = (0.3 * rng.standard_normal((T + 1, N))).astype(np.float32)
    target = (0.3 * rng.standard_normal((T + 1, N))).astype(np.float32)
    return theta, x0s, goal, target


def _toy_problem(theta, goal):
    """The toy as a batch problem; theta (w_state, w_term, bias) tensors."""
    w_state, w_term, bias = theta
    A, Bm, g = torch.from_numpy(A_MAT), torch.from_numpy(B_MAT), torch.from_numpy(goal)

    def quad(X, U):
        T1, B, n = X.shape
        d = X - g[:, None]
        w = torch.cat([w_state.expand(T1 - 1), w_term.reshape(1)])[:, None, None]
        eye = torch.eye(n).expand(T1, B, n, n)
        return (2 * w * d, 0.2 * U, 2 * w[..., None] * eye,
                0.2 * torch.eye(U.shape[-1]).expand(T1 - 1, B, U.shape[-1], U.shape[-1]),
                torch.zeros(T1 - 1, B, U.shape[-1], n))

    return BatchProblem(
        dynamics_step=lambda X, U, t: X @ A.T + U @ Bm.T + bias,
        dynamics_jac=lambda X, U: (A.expand(X.shape[:2] + A.shape),
                                   Bm.expand(X.shape[:2] + Bm.shape)),
        stage_cost=lambda X, U, t: (w_state * ((X - g[t]) ** 2).sum(-1)
                                    + 0.1 * (U ** 2).sum(-1)),
        terminal_cost=lambda X: w_term * ((X - g[T]) ** 2).sum(-1),
        quad=quad,
    )


def _toy_port_loss(theta, x0s, goal, target, solver, which="loss"):
    """Mean over the start states of the outer loss (``which="loss"``)
    or of the objective (``"obj"``) for theta = (w_state, w_term, bias)."""
    plan = ImplicitPlanner(SolverSettings(max_iterations=TOY_ITERS, grad_norm_tol=TOY_TOL),
                           solver=solver, ridge=TOY_RIDGE)
    x0 = torch.from_numpy(x0s)
    sol = plan(lambda order: _toy_problem(theta, goal), theta, x0,
               torch.zeros(x0.shape[0], T, M))
    if which == "obj":
        return sol.obj.mean()
    return ((sol.X - torch.from_numpy(target)) ** 2).mean(1).sum(-1).mean()


def _toy_jax_grads(theta, x0s, goal, target, solver, which="loss"):
    plan = jax_make_implicit_planner(
        _jax_cost, _jax_dynamics, JaxSettings(max_iterations=TOY_ITERS, grad_norm_tol=TOY_TOL),
        solver=solver, ridge=TOY_RIDGE)

    def single(th, x0):
        sol = plan(th, x0, jnp.zeros((T, M)), (jnp.asarray(goal),), ())
        if which == "obj":
            return sol.obj
        return jnp.sum(jnp.mean((sol.X - jnp.asarray(target)) ** 2, axis=0))

    loss = lambda th: jnp.mean(jax.vmap(lambda x: single(th, x))(jnp.asarray(x0s)))
    val, grads = jax.jit(jax.value_and_grad(loss))(jax.tree_util.tree_map(jnp.asarray, theta))
    return float(val), [np.asarray(grads[k]) for k in ("w_state", "w_term", "bias")]


def _toy_theta(theta):
    return [torch.tensor(theta[k], requires_grad=True) for k in ("w_state", "w_term", "bias")]


@pytest.mark.parametrize("which", ["loss", "obj"], ids=["outer_loss", "envelope"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_toy_gradients_match_jax_and_finite_differences(solver, which):
    """The outer loss reads X (rollout pullback, Hessian solve, mixed
    term); the objective alone reads obj (the envelope gradient)."""
    raw, x0s, goal, target = _toy_data()
    theta = _toy_theta(raw)
    loss = _toy_port_loss(theta, x0s, goal, target, solver, which)
    got = torch.autograd.grad(loss, theta)
    ref_val, ref = _toy_jax_grads(raw, x0s, goal, target, solver, which)
    np.testing.assert_allclose(loss.item(), ref_val, rtol=1e-4)
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - r).max() <= 1e-3 * np.abs(r).max(), (g, r)

    eps = 1e-3
    for i, t in enumerate(theta):
        for j in range(t.numel()):
            vals = []
            for sign in (1.0, -1.0):
                shifted = [s.detach().clone() for s in theta]
                shifted[i].view(-1)[j] += sign * eps
                vals.append(_toy_port_loss(shifted, x0s, goal, target, solver, which).item())
            fd = (vals[0] - vals[1]) / (2 * eps)
            np.testing.assert_allclose(got[i].view(-1)[j].item(), fd, rtol=0.05, atol=1e-4)


# -- a small cheetah policy -----------------------------------------------------

X_SIZE, U_SIZE, H, B = 17, 6, 3, 8
DYN_HIDDEN, COST_HIDDEN, FEATURES = (32, 32), (16, 16), 4
EXPERT_FEATURES, EXPERT_HIDDEN = 16, (16,)
ITERS = 2


def _jax_policy(solver):
    return JaxPolicy(
        cost_model=JaxMPCCost(JaxCostNet(hidden=COST_HIDDEN, features_out=FEATURES), H),
        dynamics_model=JaxDynamics(JaxResidualNet(x_size=X_SIZE, hidden=DYN_HIDDEN)),
        expert_model=JaxExpert(x_size=X_SIZE, u_size=U_SIZE, arch="lstm",
                               features=EXPERT_FEATURES, hidden=EXPERT_HIDDEN),
        horizon=H, settings=JaxSettings(max_iterations=ITERS), bilevel_solver=solver,
    )


def _port_policy(tree, solver):
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(X_SIZE, COST_HIDDEN, FEATURES), H),
        dynamics_model=LearnedDynamics(ResidualMLPDynamicsNet(X_SIZE, U_SIZE, DYN_HIDDEN)),
        expert_model=ExpertPredictor(X_SIZE, U_SIZE, features=EXPERT_FEATURES,
                                     hidden=EXPERT_HIDDEN),
        horizon=H, settings=SolverSettings(max_iterations=ITERS), bilevel_solver=solver,
    )
    return from_jax_params(tree, policy)


@pytest.fixture(scope="module")
def small():
    """(JAX policy, JAX params, numpy tree, histories (B, 2, x), targets
    (B, H+1, x)). One JAX policy for every test, so that its jitted solver
    compiles once."""
    jpolicy = _jax_policy("dense")
    jparams = jpolicy.init(jax.random.PRNGKey(3), (-2.0, 3.0, -3.0), U_SIZE)
    rng = np.random.default_rng(5)
    hX = (0.2 * rng.standard_normal((B, 2, X_SIZE))).astype(np.float32)
    Y = (0.5 * rng.standard_normal((B, H + 1, X_SIZE))).astype(np.float32)
    return jpolicy, jparams, jax.device_get(jparams), hX, Y


def test_plan_matches_jax_vmapped_plan(small):
    jpolicy, jparams, tree, hX, _ = small
    zeros_u = jnp.zeros((1, U_SIZE))
    plans = jax.jit(jax.vmap(lambda hx: jpolicy.plan(jparams, hx, zeros_u,
                                                     warm_start_carry=False)))
    ref = plans(jnp.asarray(hX))
    for scale in (1 + 1e-7, 1 - 1e-7):  # the input sits clear of line-search flips
        nudged = plans(jnp.asarray(hX * np.float32(scale)))
        assert np.abs(np.asarray(nudged.U) - np.asarray(ref.U)).max() < 1e-4
    with torch.no_grad():
        got = _port_policy(tree, "dense").plan(torch.from_numpy(hX))
    for name in ("U", "X", "obj"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_gauss_newton_hessian_matches_jax_hessian(small):
    """At random controls: the port's Hessian from the linearization
    against ``jax.hessian`` of JAX's objective through its flax modules."""
    jpolicy, jparams, tree, hX, _ = small
    U = (0.5 * np.random.default_rng(6).standard_normal((B, H, U_SIZE))).astype(np.float32)
    goals, _ = jax.vmap(lambda hx: jpolicy.goals_and_warm_start(jparams, hx))(jnp.asarray(hX))
    theta = jpolicy._theta(jparams)
    cm, dm = jpolicy.cost_model, jpolicy.dynamics_model

    def objective(u_flat, x0, goal):
        stage = lambda x, u, t: cm.stage(x, u, t, theta["mpc_weights"], goal)
        term = lambda x: cm.terminal(x, theta["cost_params"], theta["mpc_weights"])
        dyn = lambda x, u, t: dm(x, u, t, theta["dynamics_params"])
        u = u_flat.reshape(H, U_SIZE)
        return _make_total_fn(stage, term)(rollout(dyn, u, x0), u)

    ref = jax.jit(jax.vmap(jax.hessian(objective)))(
        jnp.asarray(U.reshape(B, -1)), jnp.asarray(hX[:, -1]), goals)
    policy = _port_policy(tree, "dense")
    with torch.no_grad():
        goal_X, init_U = policy.goals_and_warm_start(torch.from_numpy(hX))
        problem = policy._problem(goal_X.transpose(0, 1), init_U.transpose(0, 1), order=1)
        Ut = torch.from_numpy(U).transpose(0, 1)
        X, _ = batch_rollout(problem, Ut, torch.from_numpy(hX[:, -1]))
        lin = (*problem.dynamics_jac(X[:-1], Ut), *problem.quad(X, Ut)[2:])
        got = dense_hessian(lin, H, U_SIZE).numpy()
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.fixture(scope="module")
def jax_loss_and_grad(small):
    """JAX's ``batched_loss_and_grad`` with the configuration's dense
    solver, flattened to the port's parameter order."""
    jpolicy, jparams, _, hX, Y = small
    loss, grads = jax.jit(lambda p, hx, y: jpolicy.batched_loss_and_grad(
        p, hx, jax_l2_loss, (y,)))(jparams, jnp.asarray(hX), jnp.asarray(Y))
    return float(loss), {
        "mpc_weights": [np.asarray(grads["mpc_weights"])],
        "cost_params": _dense_leaves(grads["cost_params"]),
        "dynamics_params": _dense_leaves(grads["dynamics_params"]),
    }


@pytest.mark.parametrize("solver", SOLVERS)
def test_batched_loss_and_grad_matches_jax(small, jax_loss_and_grad, solver):
    """Both port solvers against JAX's dense solve: CG stops at 1e-5 of
    the right-hand side's norm, well inside the gradients' tolerance."""
    _, _, tree, hX, Y = small
    ref_loss, ref = jax_loss_and_grad
    policy = _port_policy(tree, solver).requires_grad_(True)
    loss, got = policy.batched_loss_and_grad(torch.from_numpy(hX), l2_imitation_loss,
                                             (torch.from_numpy(Y),))
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    for name, refs in ref.items():
        assert len(got[name]) == len(refs), name
        for g, r in zip(got[name], refs):
            assert g.shape == r.shape, name
            assert np.abs(g.numpy() - r).max() <= 1e-3 * np.abs(r).max(), name
    assert all(not g.any() for g in got["expert_params"])
    assert np.abs(ref["mpc_weights"][0]).max() > 0


def _dense_leaves(tree):
    """(kernel, bias) per Dense layer in index order, flattened: the port's
    ``parameters()`` order."""
    p = tree["params"]
    return [np.asarray(p[f"Dense_{i}"][k]) for i in range(len(p)) for k in ("kernel", "bias")]
