"""Port parity: cost, dynamics and expert models against the JAX package.

The JAX flagship policy (``__graft_entry__._flagship``: cheetah widths,
cost 17->128->128->10, dynamics 23->200->200->200->17, LSTM expert with
128 features) is initialized by flax, and its weights are carried into
the port with ``params.from_jax_params``. Inputs come from a numpy seed.
Everything is float32 on the CPU. Tolerance: rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gan_mpc_tpu.models.cost import MPCCost as JaxMPCCost
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import flagship
from gan_mpc_tpu_torch.models.cost import MPCCost
from gan_mpc_tpu_torch.params import from_jax_params

torch.set_num_threads(1)
pin_fp32()

TOL = dict(rtol=1e-5, atol=1e-5)
X, U, H, B, K = 17, 6, 5, 8, 16


@pytest.fixture(scope="module")
def pair():
    jpolicy, jparams, _, _ = graft._flagship(
        horizon=H, max_iterations=5, x_size=X, u_size=U
    )
    tree = jax.device_get(jparams)
    return jpolicy, jparams, from_jax_params(tree, flagship(H, 5, X, U, device="cpu"))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _np(t):
    return t.detach().numpy()


# (raw MPC weights, action_goal_scale, action_goal_squared): the 3-weight
# flagship, the 4th (action-goal) weight in both shapes, and the 5th (gain).
WEIGHTS = [
    ((-2.0, 3.0, -3.0), 1.0, False),
    ((-2.0, 3.0, -3.0, 0.5), 1.0, False),
    ((-2.0, 3.0, -3.0, 0.5), 5.0, True),
    ((-2.0, 3.0, -3.0, 0.5, 1.3), 2.0, False),
]
WEIGHT_IDS = ["3w", "4w_huber", "4w_squared", "5w_gain"]


def _costs(pair, weights, scale, squared):
    jpolicy, jparams, policy = pair
    jcost = JaxMPCCost(jpolicy.cost_model.net, H, scale, squared)
    cost = MPCCost(policy.cost_model.net, H, weights, scale, squared)
    return jcost, jparams["cost_params"], jnp.asarray(weights, jnp.float32), cost


@pytest.mark.parametrize("weights,scale,squared", WEIGHTS, ids=WEIGHT_IDS)
def test_stage_cost_batch(pair, weights, scale, squared):
    jcost, _, jw, cost = _costs(pair, weights, scale, squared)
    Xs, Us = _rand((B, K, X), 0), _rand((B, K, U), 1)
    goal, goal_u = _rand((H + 1, B, X), 2), _rand((H, B, U), 3)
    for t in (0, 3):
        ref = jcost.stage_cost_batch(Xs, Us, t, jw, goal, goal_u)
        got = cost.stage_cost_batch(
            torch.from_numpy(Xs), torch.from_numpy(Us), t,
            torch.from_numpy(goal), torch.from_numpy(goal_u),
        )
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_terminal_cost_batch(pair):
    jcost, jnet, jw, cost = _costs(pair, (-2.0, 3.0, -3.0), 1.0, False)
    Xs = _rand((B, K, X), 4)
    ref = jcost.terminal_cost_batch(Xs, jnet, jw)
    got = cost.terminal_cost_batch(torch.from_numpy(Xs))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weights,scale,squared", WEIGHTS, ids=WEIGHT_IDS)
def test_quad_batch(pair, weights, scale, squared):
    jcost, jnet, jw, cost = _costs(pair, weights, scale, squared)
    Xs, Us = _rand((H + 1, B, X), 5), _rand((H, B, U), 6)
    goal, goal_u = _rand((H + 1, B, X), 7), _rand((H, B, U), 8)
    ref = jcost.quad_batch(Xs, Us, jnet, jw, goal, goal_u)
    got = cost.quad_batch(
        torch.from_numpy(Xs), torch.from_numpy(Us),
        torch.from_numpy(goal), torch.from_numpy(goal_u),
    )
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)


def test_dynamics_batch_apply_and_value_and_jac(pair):
    jpolicy, jparams, policy = pair
    jdyn, dyn = jpolicy.dynamics_model, policy.dynamics_model
    assert dyn.is_batch_native and jdyn.is_batch_native
    Xs, Us = _rand((40, X), 9), _rand((40, U), 10)
    dp = jparams["dynamics_params"]
    ref = jdyn.batch_apply(dp, Xs, Us)
    got = dyn.batch_apply(torch.from_numpy(Xs), torch.from_numpy(Us))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    refs = jdyn.batch_value_and_jac(dp, Xs, Us)
    gots = dyn.batch_value_and_jac(torch.from_numpy(Xs), torch.from_numpy(Us))
    for g, r in zip(gots, refs):
        assert g.shape == r.shape
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)


def test_expert_warm_carry_and_generate(pair):
    jpolicy, jparams, policy = pair
    jexp, exp = jpolicy.expert_model, policy.expert_model
    ep = jparams["expert_params"]
    hist = _rand((B, 3, X), 11, 0.5)  # history 2: two teacher-forced steps

    def one(hx):
        carry = jexp.warm_carry(ep, hx)
        return carry, jexp.generate(ep, carry, H)

    ((c_ref, h_ref), x_ref), (goal_ref, u_ref) = jax.vmap(one)(hist)
    (c, h), x = exp.warm_carry(torch.from_numpy(hist))
    goal, u = exp.generate(((c, h), x), H)
    for g, r in [(c, c_ref), (h, h_ref), (x, x_ref), (goal, goal_ref), (u, u_ref)]:
        assert g.shape == r.shape
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)
