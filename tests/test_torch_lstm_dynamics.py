"""Port parity: the LSTM dynamics (``LSTMDynamicsNet`` in
``gan_mpc_tpu_torch/models/dynamics.py``) and their per-instance planning
path against the JAX package, float32 on the CPU, on flax-initialized
weights loaded by ``params.dynamics_from_jax_params`` and numpy-seeded
inputs:

  * ``batch_apply`` on rows of xc = [x, h, c] against flax's
    ``LearnedDynamics.__call__`` (the cell, then the relu head): 1e-5;
  * ``warm_carry`` of a 3-step (x, u) history against JAX's
    ``warm_carry``: 1e-5;
  * ``batch_value_and_jac`` (the cell's Jacobian by ``torch.func`` chained
    with the head's) against ``jax.jacfwd`` of flax's step in (xc, u):
    value and both Jacobians 1e-5;
  * the parameters round trip bitwise;
  * ``plan_batch`` of 16 histories (H=10, 3 iLQR iterations) against
    JAX's ``plan_batch`` (its ``vmap``ped ``plan``, the carry warmed from
    ``history_U``) on the stable lanes (the rule of
    ``test_torch_ensemble.py``): U, X (the carry included) and obj within
    1e-4; ``history_U`` is read (other actions give other plans, in both
    packages alike);
  * ``build_policy`` on a config with ``dynamics.use: lstm`` sizes the cost
    net at x + carry, as JAX's ``MPCPolicy.init`` does, and JAX's and the
    port's trees have the same leaves and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.params import dynamics_from_jax_params, dynamics_to_jax_params, \
    to_jax_params
from gan_mpc_tpu_torch.runners import common
from test_torch_ensemble import (
    LSTM_FEATURES,
    U_SIZE,
    X_SIZE,
    assert_plans_match,
    histories,
    jax_dynamics,
    policy_pair,
    port_dynamics,
)
from test_torch_pendulum import REPO

torch.set_num_threads(1)
N_ROWS = 16
NC = X_SIZE + 2 * LSTM_FEATURES


@pytest.fixture(scope="module")
def lstm():
    jdyn = jax_dynamics("lstm")
    jparams = jdyn.init(jax.random.PRNGKey(2), U_SIZE)
    tree = jax.device_get(jparams)
    dyn = dynamics_from_jax_params(tree, port_dynamics("lstm")).requires_grad_(False)
    rng = np.random.default_rng(1)
    xc = rng.standard_normal((N_ROWS, NC)).astype(np.float32)
    u = rng.standard_normal((N_ROWS, U_SIZE)).astype(np.float32)
    return jdyn, jparams, tree, dyn, xc, u


def test_step_and_warm_carry_match_flax(lstm):
    jdyn, jparams, _, dyn, xc, u = lstm
    ref = jax.vmap(lambda a, b: jdyn(a, b, 0, jparams))(jnp.asarray(xc), jnp.asarray(u))
    np.testing.assert_allclose(dyn.batch_apply(torch.from_numpy(xc), torch.from_numpy(u)).numpy(),
                               np.asarray(ref), atol=1e-5)
    rng = np.random.default_rng(2)
    hx = rng.standard_normal((N_ROWS, 3, X_SIZE)).astype(np.float32)
    hu = rng.standard_normal((N_ROWS, 3, U_SIZE)).astype(np.float32)
    want = jax.vmap(lambda a, b: jdyn.warm_carry(jparams, a, b))(jnp.asarray(hx), jnp.asarray(hu))
    got = dyn.warm_carry(torch.from_numpy(hx), torch.from_numpy(hu))
    assert got.shape == (N_ROWS, 2 * LSTM_FEATURES) and dyn.carry_size == 2 * LSTM_FEATURES
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not dyn.is_batch_native


def test_jacobian_matches_jax_jacfwd(lstm):
    jdyn, jparams, _, dyn, xc, u = lstm
    f = lambda a, b: jdyn(a, b, 0, jparams)
    A_ref, B_ref = jax.vmap(jax.jacfwd(f, argnums=(0, 1)))(jnp.asarray(xc), jnp.asarray(u))
    nx, A, Bm = dyn.batch_value_and_jac(torch.from_numpy(xc), torch.from_numpy(u))
    assert A.shape == (N_ROWS, NC, NC) and Bm.shape == (N_ROWS, NC, U_SIZE)
    for got, want in ((nx, jax.vmap(f)(jnp.asarray(xc), jnp.asarray(u))), (A, A_ref),
                      (Bm, B_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_params_round_trip(lstm):
    _, _, tree, dyn, _, _ = lstm
    back = dynamics_to_jax_params(dyn)
    want = jax.tree_util.tree_leaves_with_path(tree)
    have = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in have] == [p for p, _ in want]
    for (_, h), (_, w) in zip(have, want):
        np.testing.assert_array_equal(np.asarray(h), np.asarray(w))


def test_plan_batch_reads_history_u_and_matches_jax():
    jpolicy, jparams, policy = policy_pair("lstm", 10, 3, seed=6)
    assert not policy.batch_native
    hX, hU = histories(np.random.default_rng(3), 16)
    got, ref, lanes = assert_plans_match(jpolicy, jparams, policy, hX, hU)
    assert got.X.shape == (16, 11, NC)
    # other past actions warm another carry: the plans move, in both packages
    hU2 = -hU
    got2 = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU2))
    ref2 = jax.jit(jpolicy.plan_batch)(jparams, jnp.asarray(hX), jnp.asarray(hU2))
    assert np.abs(got2.X.numpy()[:, 0] - got.X.numpy()[:, 0]).max() > 1e-3
    np.testing.assert_allclose(got2.X.numpy()[:, 0], np.asarray(ref2.X)[:, 0], atol=1e-5)
    assert policy.planned_states(got).shape == (16, 11, X_SIZE)


def test_cost_net_is_sized_at_the_planner_state(monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = Config.from_yaml("configs/gan_pendulum.yaml").replace(
        mpc__model__dynamics__use="lstm")
    features = cfg.mpc.model.dynamics.lstm.features
    policy = common.build_policy(cfg, 3, 1, device="cpu")
    assert policy.cost_model.net.layers[0].kernel.shape[0] == 3 + 2 * features
    from gan_mpc_tpu.config import Config as JaxConfig

    jcfg = JaxConfig.from_yaml("configs/gan_pendulum.yaml").replace(
        mpc__model__dynamics__use="lstm")
    _, jparams = jcommon.build_policy(jcfg, 3, 1)
    got = to_jax_params(policy)
    for comp in ("cost_params", "dynamics_params"):
        want = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams[comp]))
        have = jax.tree_util.tree_leaves_with_path(got[comp])
        assert [(p, np.shape(v)) for p, v in have] == [(p, np.shape(v)) for p, v in want]
