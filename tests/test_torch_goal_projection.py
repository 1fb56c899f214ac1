"""Port parity: goal projection (``MPCPolicy.project_goals`` in
``gan_mpc_tpu_torch/policies/mpc.py``) against the JAX package, on the
cases of ``tests/test_goal_projection.py``, float32 on the CPU, the JAX
policy's flax-initialized weights loaded into the port's:

  * the projected goals are exactly reachable: G[1:] is the port's own
    rollout of the returned actions (1e-5), the actions stay within the
    torque bounds, the projection tracks the goals at least as well as the
    zero warm start, and goals and actions equal JAX's ``project_goals``
    (its ``vmap``) within 1e-5;
  * the action-goal target survives the projection: with a huge squared
    action-goal term the plan pins U to the expert's unprojected actions
    (within 1e-2, closer than to the projected ones), in ``plan`` and in
    ``plan_batch`` alike (1e-3), and within 1e-3 of JAX's plan;
  * projection off changes nothing: ``goal_projection=0`` plans exactly
    as a solve on the expert's raw goals and warm start;
  * both paths against JAX's ``plan_batch`` on 16 histories with
    ``goal_projection`` 2 (cheetah gan/0's setting): the batch-native path
    (residual MLP, projected from the last observation, H=10) and the
    per-instance path (an ensemble, projected from xc0, H=10). The
    projection's goals and actions against JAX's within 1e-4 (its
    Gauss-Newton solves amplify rounding: JAX's own actions move by up to
    2.3e-5 when x0 is scaled by 1 + 1e-7). The solve that follows starts
    on goals its rollout reaches exactly, at the kink of the state term's
    pseudo-Huber (curvature 1/alpha = 100), where the solve amplifies
    rounding: JAX's own two solvers, its batch ``plan_batch`` and its
    ``vmap(plan)``, differ there by up to 6.3e-4 in U after one iteration
    on this problem, against 2.4e-5 without the projection (measured when
    this was written). So the plans are compared from the same
    projection (the port's ``project_goals`` hands on JAX's result), after
    one iteration, U, X and obj within 2e-3 on the lanes JAX's own solve
    is stable on (the rule of ``test_torch_ensemble.py``): the port came
    within 9.5e-5 (mlp) and 8.4e-4 (ensemble, whose JAX solve is
    ``vmap(plan)``) when this was written.
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
from gan_mpc_tpu.policies import MPCPolicy as JaxPolicy
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import from_jax_params
from gan_mpc_tpu_torch.planner.batch_ilqr import batch_ilqr
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
from test_torch_ensemble import assert_plans_match, histories, policy_pair

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
H, X, U = 5, 4, 2


def pair(goal_projection=3, weights=(-2.0, 3.0, -3.0), ag_scale=1.0, ag_squared=False):
    """(JAX policy, its params, the port policy) of the JAX test's sizes."""
    jpolicy = JaxPolicy(
        cost_model=JaxMPCCost(JaxCostNet(hidden=(8,), features_out=2), H,
                              action_goal_scale=ag_scale, action_goal_squared=ag_squared),
        dynamics_model=JaxDynamics(JaxResidualNet(x_size=X, hidden=(16,))),
        expert_model=JaxExpert(x_size=X, u_size=U, arch="mlp", features=0, hidden=(8,)),
        horizon=H, settings=JaxSettings(max_iterations=3), goal_projection=goal_projection,
    )
    jparams = jpolicy.init(KEY, weights, U)
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(X, (8,), 2), H, mpc_weights=weights,
                           action_goal_scale=ag_scale, action_goal_squared=ag_squared),
        dynamics_model=LearnedDynamics(ResidualMLPDynamicsNet(X, U, (16,))),
        expert_model=ExpertPredictor(X, U, arch="mlp", features=0, hidden=(8,)),
        horizon=H, settings=SolverSettings(max_iterations=3), goal_projection=goal_projection,
    )
    return jpolicy, jparams, from_jax_params(jax.device_get(jparams), policy)


def test_projected_goals_are_exactly_reachable():
    jpolicy, jparams, policy = pair()
    x0 = jax.random.normal(KEY, (3, X))
    goals = jnp.concatenate([x0[:, None], 2.0 * jax.random.normal(jax.random.PRNGKey(1),
                                                                   (3, H, X))], 1)
    u0 = jnp.zeros((3, H, U))
    G_ref, U_ref = jax.vmap(lambda a, g, u: jpolicy.project_goals(
        jparams["dynamics_params"], a, g, u))(x0, goals, u0)
    t = lambda a: torch.tensor(np.asarray(a))
    G, Useq = policy.project_goals(t(x0), t(goals), t(u0))
    assert G.shape == goals.shape and Useq.shape == u0.shape
    np.testing.assert_allclose(G.numpy(), np.asarray(G_ref), atol=1e-5)
    np.testing.assert_allclose(Useq.numpy(), np.asarray(U_ref), atol=1e-5)
    dyn = policy.dynamics_model
    with torch.no_grad():
        x = t(x0)
        for step in range(H):
            x = dyn.batch_apply(x, Useq[:, step])
            np.testing.assert_allclose(x.numpy(), G[:, step + 1].numpy(), atol=1e-5)
        assert float(Useq.abs().max()) <= 1.0 + 1e-6

        def step_dist(useq):
            x, total = t(x0), 0.0
            for step in range(H):
                x = dyn.batch_apply(x, useq[:, step])
                total += float(((x - t(goals)[:, step + 1]) ** 2).sum())
            return total

        assert step_dist(Useq) <= step_dist(t(u0)) + 1e-6


def test_action_goal_target_survives_projection():
    jpolicy, jparams, policy = pair(weights=(-20.0, -20.0, -20.0, 20.0), ag_scale=1e4,
                                    ag_squared=True)
    hx = 0.1 * jax.random.normal(KEY, (2, X))
    hX = torch.tensor(np.asarray(hx))[None]
    hU = torch.zeros((1, 1, U))
    with torch.no_grad():
        goals, u_cloned = policy.goals_and_warm_start(hX)
        _, u_proj = policy.project_goals(hX[:, -1], goals, u_cloned)
        assert float((u_cloned - u_proj).abs().max()) > 1e-4
        sol = policy.plan(hX, hU, warm_start_carry=False)
        d_cloned = float((sol.U - u_cloned).abs().max())
        d_proj = float((sol.U - u_proj).abs().max())
        assert d_cloned < 1e-2 and d_cloned < d_proj
        solb = policy.plan_batch(hX, hU)
    np.testing.assert_allclose(solb.U.numpy(), sol.U.numpy(), atol=1e-3)
    ref = jpolicy.plan(jparams, hx, jnp.zeros((1, U)), warm_start_carry=False)
    np.testing.assert_allclose(sol.U[0].numpy(), np.asarray(ref.U), atol=1e-3)


def test_projection_off_matches_a_solve_on_the_raw_goals():
    _, _, policy = pair(goal_projection=0)
    hX = 0.1 * torch.tensor(np.random.default_rng(0).standard_normal((3, 2, X)),
                            dtype=torch.float32)
    hU = torch.zeros((3, 1, U))
    with torch.no_grad():
        sol = policy.plan_batch(hX, hU)
        goals, useq = policy.goals_and_warm_start(hX)
        problem = policy._problem(goals.transpose(0, 1), useq.transpose(0, 1), order=0)
        raw = batch_ilqr(problem, hX[:, -1], useq, policy.settings)
    for name in ("U", "X", "obj"):
        np.testing.assert_array_equal(getattr(sol, name).numpy(), getattr(raw, name).numpy())


@pytest.mark.parametrize("kind", ["mlp", "ensemble"])
def test_projected_plan_batch_matches_jax(kind, monkeypatch):
    jpolicy, jparams, policy = policy_pair(kind, 10, 1, seed=5, goal_projection=2)
    assert policy.batch_native == (kind == "mlp")
    hX, hU = histories(np.random.default_rng(11), 16)
    goals, warm = jax.vmap(lambda hx: jpolicy.goals_and_warm_start(jparams, hx))(
        jnp.asarray(hX))
    projected = jax.vmap(lambda x0, g, u: jpolicy.project_goals(
        jparams["dynamics_params"], x0, g, u))(jnp.asarray(hX[:, -1]), goals, warm)
    calls = []
    real = policy.project_goals

    def handing_on_jax(xc0, goal_X, init_U):
        calls.append(real(xc0, goal_X, init_U))
        return tuple(torch.tensor(np.asarray(a)) for a in projected)

    monkeypatch.setattr(policy, "project_goals", handing_on_jax)
    _, _, lanes = assert_plans_match(jpolicy, jparams, policy, hX, hU, atol=2e-3,
                                     min_stable=12)
    assert len(calls) == 1
    for got, want in zip(calls[0], projected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
