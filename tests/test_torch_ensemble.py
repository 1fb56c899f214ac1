"""Port parity: ensemble dynamics (``gan_mpc_tpu_torch/models/ensemble.py``)
and the per-instance planning path against the JAX package.

The same flax-initialized weights (the JAX ensemble's stacked member
parameters, E = 3, loaded member by member by
``params.dynamics_from_jax_params``) and the same numpy-seeded inputs go
through both packages, float32 on the CPU:

  * ``batch_apply`` (the member mean), ``member_predict`` and
    ``disagreement`` against JAX's ``__call__``, ``member_predict`` and
    ``disagreement`` row by row: 1e-5 (the member MLPs' f32 sums run in
    another order);
  * ``batch_value_and_jac`` against ``jax.jacfwd`` of JAX's ensemble mean
    in (xc, u): value and both Jacobians 1e-5;
  * the parameters round trip: ``dynamics_to_jax_params`` of what
    ``dynamics_from_jax_params`` loaded gives the stacked leaves back
    bitwise, and a policy's ``to_jax_params`` carries them;
  * an H=50 ``plan_batch`` of 16 histories with CG bilevel settings (the
    configuration of humanoid_stand gan/0, cut to narrow widths and 3 iLQR
    iterations) against JAX's ``plan_batch``, which ``vmap``s its
    per-instance ``plan`` for an ensemble (sequential Riccati): U, X and
    obj within 1e-4 on the lanes where the solve is stable.
    Random-weight solves are discontinuous in their input (the line-search
    argmin flips on f32 rounding), and at H=50 many lanes sit near a flip:
    the members' output layers are scaled by 1/16 (as
    ``test_torch_humanoid_loop.py`` scales its dynamics), and a lane is
    held where JAX's own U moves by less than 1e-4 when the histories are
    scaled by 1 +- 1e-7 (``assert_plans_match``; 10 of the 16 when this was
    written; at least 4 must be). Lanes solve independently in both
    packages, so the others do not touch them;
  * the launches ``mlp_calls_per_solve`` reckons (``members``,
    ``projection``) equal the MLP forwards a plan runs through
    ``mlp_apply`` (on the CPU its plain ``reference_forward``, counted),
    for the ensemble, the LSTM dynamics and the residual MLP, with goal
    projection on and off, each line-search strategy.
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
    LSTMDynamicsNet as JaxLSTMNet,
    MPCCost as JaxMPCCost,
    ResidualMLPDynamicsNet as JaxResidualNet,
)
from gan_mpc_tpu.models.ensemble import EnsembleDynamics as JaxEnsemble
from gan_mpc_tpu.planner import SolverSettings as JaxSettings
from gan_mpc_tpu.policies import MPCPolicy as JaxPolicy
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import (
    LearnedDynamics,
    LSTMDynamicsNet,
    ResidualMLPDynamicsNet,
)
from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import (
    dynamics_from_jax_params,
    dynamics_to_jax_params,
    from_jax_params,
    to_jax_params,
)
from gan_mpc_tpu_torch.ops import fused_mlp
from gan_mpc_tpu_torch.planner.batch_ilqr import ls_materializes, mlp_calls_per_solve
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy

torch.set_num_threads(1)
pin_fp32()

X_SIZE, U_SIZE, E, HIDDEN = 6, 2, 3, (32, 32)
COST_HIDDEN, FEATURES = (16, 16), 4
EXPERT_FEATURES, EXPERT_HIDDEN = 8, (16,)
LSTM_FEATURES, LSTM_HIDDEN = 8, (16, 16)
NUDGES = (1 + 1e-7, 1 - 1e-7)


def jax_ensemble():
    return JaxEnsemble(JaxResidualNet(x_size=X_SIZE, hidden=HIDDEN), num_members=E)


def port_dynamics(kind):
    if kind == "ensemble":
        return EnsembleDynamics([ResidualMLPDynamicsNet(X_SIZE, U_SIZE, HIDDEN)
                                 for _ in range(E)])
    if kind == "lstm":
        return LearnedDynamics(LSTMDynamicsNet(X_SIZE, U_SIZE, LSTM_FEATURES, LSTM_HIDDEN))
    return LearnedDynamics(ResidualMLPDynamicsNet(X_SIZE, U_SIZE, HIDDEN))


def jax_dynamics(kind):
    if kind == "ensemble":
        return jax_ensemble()
    if kind == "lstm":
        return JaxDynamics(JaxLSTMNet(x_size=X_SIZE, features=LSTM_FEATURES,
                                      hidden=LSTM_HIDDEN))
    return JaxDynamics(JaxResidualNet(x_size=X_SIZE, hidden=HIDDEN))


def scale_output_layer(tree, scale):
    """The dynamics tree with its last Dense layer (kernel and bias) scaled."""
    params = dict(tree["params"])
    last = max((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    params[last] = {k: np.asarray(v) * np.float32(scale) for k, v in params[last].items()}
    return {"params": params}


def policy_pair(kind, horizon, iters, seed, goal_projection=0, solver="cg",
                dyn_scale=1.0 / 16, mpc_weights=(-2.0, 3.0, -3.0)):
    """(JAX policy, its params, the port policy with the same weights) of
    narrow widths with ``kind`` dynamics ("ensemble", "lstm" or "mlp")."""
    def settings(cls):
        return cls(max_iterations=iters, grad_norm_tol=1e-4)

    jpolicy = JaxPolicy(
        cost_model=JaxMPCCost(JaxCostNet(hidden=COST_HIDDEN, features_out=FEATURES), horizon),
        dynamics_model=jax_dynamics(kind),
        expert_model=JaxExpert(x_size=X_SIZE, u_size=U_SIZE, arch="lstm",
                               features=EXPERT_FEATURES, hidden=EXPERT_HIDDEN),
        horizon=horizon, settings=settings(JaxSettings), bilevel_solver=solver,
        goal_projection=goal_projection,
    )
    jparams = jpolicy.init(jax.random.PRNGKey(seed), mpc_weights, U_SIZE)
    tree = jax.device_get(jparams)
    tree["dynamics_params"] = scale_output_layer(tree["dynamics_params"], dyn_scale)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    dyn = port_dynamics(kind)
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(X_SIZE + dyn.carry_size, COST_HIDDEN, FEATURES),
                           horizon, mpc_weights=mpc_weights),
        dynamics_model=dyn,
        expert_model=ExpertPredictor(X_SIZE, U_SIZE, features=EXPERT_FEATURES,
                                     hidden=EXPERT_HIDDEN),
        horizon=horizon, settings=settings(SolverSettings), bilevel_solver=solver,
        goal_projection=goal_projection,
    )
    return jpolicy, jparams, from_jax_params(tree, policy).requires_grad_(False)


def histories(rng, B, h=1):
    hX = (0.3 * rng.standard_normal((B, h + 1, X_SIZE))).astype(np.float32)
    hU = (0.3 * rng.standard_normal((B, h, U_SIZE))).astype(np.float32)
    return hX, hU


def assert_plans_match(jpolicy, jparams, policy, hX, hU, atol=1e-4, min_stable=4):
    """Port ``plan_batch`` against JAX's on the lanes whose JAX solve is
    stable (U moves < 1e-4 under 1 +- 1e-7 scalings of hX), at least
    ``min_stable`` of them: U, X and obj within ``atol``. Returns (port
    solution, JAX solution, the stable lanes)."""
    plan = jax.jit(jpolicy.plan_batch)
    ref = plan(jparams, jnp.asarray(hX), jnp.asarray(hU))
    spread = np.max([np.abs(np.asarray(plan(jparams, jnp.asarray(hX * np.float32(s)),
                                            jnp.asarray(hU)).U) - np.asarray(ref.U)).max((1, 2))
                     for s in NUDGES], 0)
    lanes = np.nonzero(spread < 1e-4)[0]
    assert len(lanes) >= min_stable, f"only lanes {lanes} are stable: spread {spread}"
    got = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    for name in ("U", "X", "obj"):
        np.testing.assert_allclose(getattr(got, name).numpy()[lanes],
                                   np.asarray(getattr(ref, name))[lanes],
                                   rtol=0, atol=atol, err_msg=name)
    return got, ref, lanes


@pytest.fixture(scope="module")
def members():
    jens = jax_ensemble()
    jparams = jens.init(jax.random.PRNGKey(1), U_SIZE)
    tree = jax.device_get(jparams)
    ens = dynamics_from_jax_params(tree, port_dynamics("ensemble"))
    rng = np.random.default_rng(0)
    xc = rng.standard_normal((16, X_SIZE)).astype(np.float32)
    u = rng.standard_normal((16, U_SIZE)).astype(np.float32)
    return jens, jparams, tree, ens, xc, u


def test_mean_members_and_disagreement_match_jax(members):
    jens, jparams, _, ens, xc, u = members
    X, U = torch.from_numpy(xc), torch.from_numpy(u)
    rows = lambda f: jax.vmap(lambda a, b: f(a, b, 0, jparams))(jnp.asarray(xc), jnp.asarray(u))
    with torch.no_grad():
        np.testing.assert_allclose(ens.batch_apply(X, U).numpy(), np.asarray(rows(jens)),
                                   atol=1e-5)
        np.testing.assert_allclose(ens.member_predict(X, U).numpy(),
                                   np.swapaxes(np.asarray(rows(jens.member_predict)), 0, 1),
                                   atol=1e-5)
        np.testing.assert_allclose(ens.disagreement(X, U).numpy(),
                                   np.asarray(rows(jens.disagreement)), atol=1e-5)
    assert ens.num_members == E and not ens.is_batch_native
    assert ens.warm_carry(torch.zeros(16, 1, X_SIZE), torch.zeros(16, 1, U_SIZE)).shape == (16, 0)


def test_value_and_jacobian_match_jax_jacfwd(members):
    jens, jparams, _, ens, xc, u = members
    jac = jax.vmap(jax.jacfwd(lambda a, b: jens(a, b, 0, jparams), argnums=(0, 1)))
    A_ref, B_ref = jac(jnp.asarray(xc), jnp.asarray(u))
    with torch.no_grad():
        nx, A, Bm = ens.batch_value_and_jac(torch.from_numpy(xc), torch.from_numpy(u))
    ref = jax.vmap(lambda a, b: jens(a, b, 0, jparams))(jnp.asarray(xc), jnp.asarray(u))
    for got, want in ((nx, ref), (A, A_ref), (Bm, B_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_params_round_trip(members):
    _, _, tree, ens, _, _ = members
    back = dynamics_to_jax_params(ens)
    assert sorted(back["params"]) == sorted(tree["params"])
    for name, layer in tree["params"].items():
        for k, v in layer.items():
            assert back["params"][name][k].shape == (E,) + np.asarray(v).shape[1:]
            np.testing.assert_array_equal(back["params"][name][k], np.asarray(v))
    _, _, policy = policy_pair("ensemble", 5, 1, seed=2)
    leaves = to_jax_params(policy)["dynamics_params"]["params"]
    assert leaves["Dense_0"]["kernel"].shape == (E, X_SIZE + U_SIZE, HIDDEN[0])
    with pytest.raises(ValueError, match="members"):
        dynamics_from_jax_params(tree, EnsembleDynamics(
            [ResidualMLPDynamicsNet(X_SIZE, U_SIZE, HIDDEN) for _ in range(E + 1)]))


def test_h50_cg_plan_batch_matches_jax_vmapped_plan():
    jpolicy, jparams, policy = policy_pair("ensemble", 50, 3, seed=4)
    assert not policy.batch_native and policy.settings.fused_ls == "off"
    hX, hU = histories(np.random.default_rng(7), 16)
    got, _, _ = assert_plans_match(jpolicy, jparams, policy, hX, hU)
    assert got.U.shape == (16, 50, U_SIZE) and got.trips == 3


@pytest.mark.parametrize("kind,projection", [("ensemble", 2), ("ensemble", 0), ("lstm", 2),
                                             ("mlp", 2)])
@pytest.mark.parametrize("horizon", [5, 20])
def test_mlp_calls_per_solve_counts_members_and_projection(kind, projection, horizon,
                                                           monkeypatch):
    _, _, policy = policy_pair(kind, horizon, 2, seed=3, goal_projection=projection)
    calls = []
    plain = fused_mlp.reference_forward
    monkeypatch.setattr(fused_mlp, "reference_forward", lambda x, layers, *bf16: (
        calls.append(x.shape[0]) or plain(x, layers, *bf16)))
    hX, hU = histories(np.random.default_rng(0), 3)
    sol = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    n = X_SIZE + policy.dynamics_model.carry_size
    mat = ls_materializes(policy.settings, horizon, 3, n, U_SIZE)
    assert mat == (horizon >= 16)
    members = E if kind == "ensemble" else 1
    assert mlp_calls_per_solve(horizon, sol.trips, materialize=mat, members=members,
                               projection=projection > 0) == {
        "fused_mlp_fwd": len(calls), "fused_ls_step": 0}


class _Counted(torch.autograd.Function):
    """The plain MLP under autograd, counting its backwards: on the CPU, what
    ``FusedMlpFunction`` launches on the card (one ``fused_mlp_bwd`` a
    backward)."""

    counts = None

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return fused_mlp.reference_forward(x, list(zip(flat[0::2], flat[1::2])))

    @staticmethod
    def backward(ctx, gy):
        x, *flat = ctx.saved_tensors
        _Counted.counts["fused_mlp_bwd"] += x.shape[0] > 0  # 0 rows launch nothing
        dx, grads = fused_mlp.reference_backward(x, list(zip(flat[0::2], flat[1::2])), gy)
        return (dx, *[t for wb in grads for t in wb])


def count_launches(monkeypatch):
    """Route every ``mlp_apply`` of the dynamics and the cost as the card
    routes it, counting what would launch: a forward kernel for each call
    that is not twice differentiable, a backward kernel for each backward
    through one recorded under autograd. Returns the live counts."""
    from gan_mpc_tpu_torch.models import cost, dynamics

    counts = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0}
    monkeypatch.setattr(_Counted, "counts", counts)

    def apply(x, layers, compute_dtype=None, twice_differentiable=False):
        if twice_differentiable:
            return fused_mlp.reference_forward(x, layers)
        counts["fused_mlp_fwd"] += x.shape[0] > 0  # 0 rows launch nothing
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for wb in layers for t in wb)):
            return _Counted.apply(x, *[t for wb in layers for t in wb])
        return fused_mlp.reference_forward(x, layers)

    for module in (cost, dynamics):
        monkeypatch.setattr(module, "mlp_apply", apply)
    return counts


@pytest.mark.parametrize("kind,projection", [("ensemble", 0), ("ensemble", 2), ("lstm", 0),
                                             ("mlp", 0)])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_mlp_calls_per_step_counts_members_in_the_backward(kind, projection, solver,
                                                           monkeypatch):
    """The cost trainer's step (an implicit solve and its backward, the L2
    loss, the cost phase's no_grads) and the dynamics trainer's (a window
    of H steps, forward and backward): the launches
    ``planner.bilevel.mlp_calls_per_step`` and E x H x 2 per dynamics step
    reckon, against those the CPU run counts as the card would launch
    them (``count_launches``); the LSTM's exact Hessian and every second
    derivative run plain."""
    from gan_mpc_tpu_torch.planner.bilevel import mlp_calls_per_step
    from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
    from gan_mpc_tpu_torch.training import dynamics as tdyn
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    horizon = 5
    _, _, policy = policy_pair(kind, horizon, 2, seed=3, goal_projection=projection,
                               solver=solver)
    members = E if kind == "ensemble" else 1
    counts = count_launches(monkeypatch)
    hX, _ = histories(np.random.default_rng(0), 3)
    Y = torch.from_numpy(histories(np.random.default_rng(1), 3, h=horizon)[0])
    comps = policy_components(policy)
    masked_adam(comps, ("dynamics_params", "expert_params"), 1e-3)  # the cost phase's grads
    sol = policy.plan(torch.from_numpy(hX), warm_start_carry=False)
    l2_imitation_loss(policy, sol, Y).mean().backward()
    n = X_SIZE + policy.dynamics_model.carry_size
    mat = ls_materializes(policy.settings, horizon, 3, n, U_SIZE)
    want = mlp_calls_per_step(horizon, sol.trips, materialize=mat, members=members,
                              projection=projection > 0)
    assert want.pop("fused_ls_step") == 0
    assert counts == want
    assert want["fused_mlp_bwd"] == members * horizon

    policy.requires_grad_(False)
    opt = masked_adam(comps, ("mpc_weights", "cost_params", "expert_params"), 1e-3)
    counts.update(fused_mlp_fwd=0, fused_mlp_bwd=0)
    rng = np.random.default_rng(2)
    windows = [torch.from_numpy((0.3 * rng.standard_normal((4, horizon, w))).astype(np.float32))
               for w in (X_SIZE, U_SIZE, X_SIZE)]
    tdyn.update_pass(policy.dynamics_model, opt, windows, torch.zeros((2, 4), dtype=torch.long),
                     0.9, False)
    assert counts == {"fused_mlp_fwd": 2 * members * horizon,
                      "fused_mlp_bwd": 2 * members * horizon}
