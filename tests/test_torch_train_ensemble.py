"""Port parity: training with ensemble dynamics against the JAX package.

Small widths: E = 3 members of 6->16->16->4 (x = 4, u = 2), H = 4, iLQR
<= 3 trips, a cost net 4->8->8->3, an LSTM expert and an LSTM critic of 8
features. JAX's flax weights (its stacked member leaves) go into the port
by ``params.from_jax_params``; inputs come from a numpy seed. Float32 on
the CPU. Compared:

  * ``multistep_prediction_loss`` over 6 windows, teacher forcing on and
    off: the losses rtol 1e-5, and the gradients of the mean loss with
    respect to every member's tensors against ``jax.value_and_grad``,
    each leaf max|d| <= 1e-4 max|ref| (f32 sums in another order; the
    loss of the member MEAN, as JAX trains it);
  * one ``_update_scan`` of 3 minibatch steps on the same index rows,
    once with the clip of 100 inactive and once active (targets scaled
    by 300): per-step losses rtol 1e-5, every member's parameters atol
    2 k lr after k Adam steps (Adam's early steps are about lr * sign(g),
    which flips where |g| is near 0); the phase optimizer holds every
    member in one group, so that it clips one global norm over all of
    them, as ``optax.clip_by_global_norm`` does over the stacked leaves;
  * ``batched_loss_and_grad`` with the L2 and the generator losses,
    through the per-instance implicit gradient, under ``dense`` and
    ``cg`` (each against JAX's own solver): the loss rtol 1e-4, each
    gradient leaf max|d| <= 1e-3 max|ref| (the plan's own f32 rounding
    moves the implicit gradient by more than the loss's). Random-weight
    solves are discontinuous in their input (the line-search argmin flips
    on f32 rounding): the members' output layers are scaled by 1/16 and
    the histories are the ones whose JAX plan moves by less than 1e-5
    when they are scaled by 1 +- 1e-7 (``stable_histories``);
  * one ``train_cost`` call (1 update of 2 minibatch steps of 4 windows,
    evaluation on 4, the Polyak blend) with JAX's minibatch draws replayed:
    losses rtol 1e-4, parameters atol 2 k lr;
  * one fused GAN epoch on the pendulum policy of
    ``tests/jax_fused_reference.py`` with a 3-member ensemble (JAX's side
    in a fresh interpreter, every draw replayed): the tolerances of
    ``test_torch_fused_epoch.py``, or twice JAX's own spread under 1 +-
    1e-7 scalings of the params where that is larger.

The launch counts of the ensemble's training paths are checked in
``test_torch_ensemble.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gan_mpc_tpu.training.cost as jcost
import gan_mpc_tpu.training.dynamics as jdyn
import gan_mpc_tpu_torch.training.cost as tcost
import gan_mpc_tpu_torch.training.dynamics as tdyn
from gan_mpc_tpu.data.windows import minibatch_indices as jax_minibatch_indices
from gan_mpc_tpu.models import (
    CostFeatureNet as JaxCostNet,
    ExpertPredictor as JaxExpert,
    LearnedDynamics as JaxDynamics,
    LSTMDynamicsNet as JaxLSTMNet,
    MPCCost as JaxMPCCost,
    ResidualMLPDynamicsNet as JaxResidualNet,
    SequenceCritic as JaxCritic,
)
from gan_mpc_tpu.models.ensemble import EnsembleDynamics as JaxEnsemble
from gan_mpc_tpu.planner import SolverSettings as JaxSettings
from gan_mpc_tpu.policies import MPCPolicy as JaxPolicy
from gan_mpc_tpu.policies.losses import gan_generator_loss as jax_gan_loss
from gan_mpc_tpu.policies.losses import l2_imitation_loss as jax_l2_loss
from gan_mpc_tpu.training.masking import masked_adam as jax_masked_adam
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.critic import SequenceCritic
from gan_mpc_tpu_torch.models.dynamics import (
    LearnedDynamics,
    LSTMDynamicsNet,
    ResidualMLPDynamicsNet,
)
from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import dynamics_from_jax_params, dynamics_to_jax_params, \
    from_jax_params, to_jax_params
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.losses import gan_generator_loss, l2_imitation_loss
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components
from test_torch_ensemble import scale_output_layer
from test_torch_fused_epoch import jax_draws, leaves, run_port, run_reference

torch.set_num_threads(1)
pin_fp32()

X_SIZE, U_SIZE, E, H = 4, 2, 3, 4
HIDDEN = (16, 16)
LSTM_FEATURES, LSTM_HIDDEN = 4, (8,)
COST_HIDDEN, FEATURES_OUT = (8, 8), 3
EXPERT_FEATURES, EXPERT_HIDDEN = 8, (8,)
CRITIC_FEATURES, CRITIC_HIDDEN = 8, (8,)
ITERS, GAMMA, LR = 3, 0.9, 1e-3
MPC_WEIGHTS = (-2.0, 3.0, -3.0)
NUDGES = (1 + 1e-7, 1 - 1e-7)
LOSSES = {"l2": (jax_l2_loss, l2_imitation_loss), "gan": (jax_gan_loss, gan_generator_loss)}


def jax_dynamics(kind):
    if kind == "ensemble":
        return JaxEnsemble(JaxResidualNet(x_size=X_SIZE, hidden=HIDDEN), num_members=E)
    return JaxDynamics(JaxLSTMNet(x_size=X_SIZE, features=LSTM_FEATURES, hidden=LSTM_HIDDEN))


def port_dynamics(kind):
    if kind == "ensemble":
        return EnsembleDynamics([ResidualMLPDynamicsNet(X_SIZE, U_SIZE, HIDDEN)
                                 for _ in range(E)])
    return LearnedDynamics(LSTMDynamicsNet(X_SIZE, U_SIZE, LSTM_FEATURES, LSTM_HIDDEN))


def policy_pair(kind, solver, seed, dyn_scale=1.0 / 16):
    """(JAX policy, its params, the port policy with the same weights), with
    a critic, ``kind`` dynamics ("ensemble" or "lstm") and ``solver`` the
    bilevel solver of both."""
    jpolicy = JaxPolicy(
        cost_model=JaxMPCCost(JaxCostNet(hidden=COST_HIDDEN, features_out=FEATURES_OUT), H),
        dynamics_model=jax_dynamics(kind),
        expert_model=JaxExpert(x_size=X_SIZE, u_size=U_SIZE, arch="lstm",
                               features=EXPERT_FEATURES, hidden=EXPERT_HIDDEN),
        critic_model=JaxCritic(features=CRITIC_FEATURES, hidden=CRITIC_HIDDEN),
        horizon=H, settings=JaxSettings(max_iterations=ITERS, grad_norm_tol=1e-4),
        bilevel_solver=solver)
    tree = jax.device_get(jpolicy.init(jax.random.PRNGKey(seed), MPC_WEIGHTS, U_SIZE,
                                       critic_x_size=X_SIZE))
    tree["dynamics_params"] = scale_output_layer(tree["dynamics_params"], dyn_scale)
    dyn = port_dynamics(kind)
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(X_SIZE + dyn.carry_size, COST_HIDDEN, FEATURES_OUT),
                           H, mpc_weights=MPC_WEIGHTS),
        dynamics_model=dyn,
        expert_model=ExpertPredictor(X_SIZE, U_SIZE, features=EXPERT_FEATURES,
                                     hidden=EXPERT_HIDDEN),
        critic_model=SequenceCritic(X_SIZE, CRITIC_FEATURES, CRITIC_HIDDEN),
        horizon=H, settings=SolverSettings(max_iterations=ITERS, grad_norm_tol=1e-4),
        bilevel_solver=solver)
    return (jpolicy, jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, policy).requires_grad_(False))


def stable_histories(jpolicy, jparams, n, seed, candidates=24):
    """``n`` histories (n, 2, x) whose JAX training-time plan (zero carry)
    moves by less than 1e-5 when they are scaled by 1 +- 1e-7: clear of the
    line search's flips."""
    zeros_u = jnp.zeros((1, U_SIZE))
    plans = jax.jit(jax.vmap(lambda hx: jpolicy.plan(jparams, hx, zeros_u,
                                                     warm_start_carry=False).U))
    hX = (0.3 * np.random.default_rng(seed).standard_normal(
        (candidates, 2, X_SIZE))).astype(np.float32)
    ref = np.asarray(plans(jnp.asarray(hX)))
    spread = np.max([np.abs(np.asarray(plans(jnp.asarray(hX * np.float32(s)))) - ref)
                     .max((1, 2)) for s in NUDGES], 0)
    lanes = np.nonzero(spread < 1e-5)[0]
    assert len(lanes) >= n, f"only lanes {lanes} are stable: spread {spread}"
    return hX[lanes[:n]]


def grads_tree(policy, grads):
    """The port's gradients (``batched_loss_and_grad``'s dict) as the JAX
    parameter tree: a copy of the policy holding them, through
    ``to_jax_params``."""
    clone = copy.deepcopy(policy)
    for name, ps in policy_components(clone).items():
        for p, g in zip(ps, grads[name]):
            p.data = g.detach().clone()
    return to_jax_params(clone)


def assert_grads_match(got, want, components, rtol):
    """Each leaf of ``components``: max|d| <= rtol max|ref|."""
    got, want = dict(leaves(got)), dict(leaves(jax.device_get(want)))
    for name in sorted(k for k in want if k.startswith(components)):
        ref = want[name]
        assert got[name].shape == ref.shape, name
        assert np.abs(got[name] - ref).max() <= rtol * np.abs(ref).max(), (
            name, np.abs(got[name] - ref).max(), np.abs(ref).max())


_STABLE, _JAX_IMPLICIT = {}, {}


def implicit_grads(kind, solver, loss, seed, dyn_scale=1.0 / 16):
    """(JAX loss, JAX grads, port loss, port grads tree) of one
    ``batched_loss_and_grad`` on 4 stable histories (targets for L2 from
    the same seed). JAX's side is computed once per setting and kept: the
    stable histories do not depend on the bilevel solver."""
    jpolicy, jparams, policy = policy_pair(kind, solver, seed, dyn_scale)
    if (kind, seed, dyn_scale) not in _STABLE:
        _STABLE[kind, seed, dyn_scale] = stable_histories(jpolicy, jparams, 4, seed)
    hX = _STABLE[kind, seed, dyn_scale]
    Y = (0.3 * np.random.default_rng(seed + 1).standard_normal(
        (4, H + 1, X_SIZE))).astype(np.float32)
    jloss_fn, loss_fn = LOSSES[loss]
    args = (Y,) if loss == "l2" else ()
    key = (kind, solver, loss, seed, dyn_scale)
    if key not in _JAX_IMPLICIT:
        _JAX_IMPLICIT[key] = jax.jit(lambda p, x, *a: jpolicy.batched_loss_and_grad(
            p, x, jloss_fn, a))(jparams, jnp.asarray(hX), *map(jnp.asarray, args))
    jl, jg = _JAX_IMPLICIT[key]
    comps = ("mpc_weights", "cost_params", "dynamics_params", "critic_params")
    try:
        for name in comps:
            for p in policy_components(policy)[name]:
                p.requires_grad_(True)
        tl, tg = policy.batched_loss_and_grad(torch.from_numpy(hX), loss_fn,
                                              tuple(map(torch.from_numpy, args)))
    finally:
        policy.requires_grad_(False)
    assert all(not g.any() for g in tg["expert_params"])
    return float(jl), jg, tl.item(), grads_tree(policy, tg)


# -- the dynamics trainer ---------------------------------------------------


def windows(n, seed, target_scale=1.0):
    rng = np.random.default_rng(seed)
    X = (0.5 * rng.standard_normal((n, H, X_SIZE))).astype(np.float32)
    Uw = (0.5 * rng.standard_normal((n, H, U_SIZE))).astype(np.float32)
    Y = (target_scale * 0.5 * rng.standard_normal((n, H, X_SIZE))).astype(np.float32)
    return X, Uw, Y


def dynamics_pair(kind, seed):
    jmodel = jax_dynamics(kind)
    tree = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), U_SIZE))
    return jmodel, tree, dynamics_from_jax_params(tree, port_dynamics(kind))


def check_multistep_loss(kind, teacher_forcing):
    jmodel, tree, tmodel = dynamics_pair(kind, 3)
    X, Uw, Y = windows(6, 4)

    def jloss(p):
        per = jax.vmap(lambda x, u, y: jdyn.multistep_prediction_loss(
            jmodel, p, x, u, y, GAMMA, jnp.asarray(teacher_forcing)))(X, Uw, Y)
        return jnp.mean(per), per

    (_, jper), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tmodel.requires_grad_(True)
    per = tdyn.multistep_prediction_loss(tmodel, *map(torch.from_numpy, (X, Uw, Y)), GAMMA,
                                         teacher_forcing)
    per.mean().backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=1e-5)
    clone = copy.deepcopy(tmodel)
    for p, q in zip(clone.parameters(), tmodel.parameters()):
        p.data = q.grad.clone()
    assert_grads_match({"d": dynamics_to_jax_params(clone)}, {"d": jg}, ("d",), 1e-4)


def check_update_scan(kind, target_scale):
    """Three steps of JAX's ``_update_scan`` and the port's ``update_pass``
    on the same index rows."""
    jmodel, tree, tmodel = dynamics_pair(kind, 10)
    data = windows(16, 11, target_scale)
    idx = np.random.default_rng(12).integers(0, 16, (3, 8))
    jd = tuple(jnp.asarray(d) for d in data)
    params = {"dynamics_params": jax.tree_util.tree_map(jnp.asarray, tree)}

    def first_loss(p):
        return jnp.mean(jax.vmap(lambda x, u, y: jdyn.multistep_prediction_loss(
            jmodel, p["dynamics_params"], x, u, y, GAMMA, jnp.asarray(True)))(
            *(d[idx[0]] for d in jd)))

    clipped = float(optax.global_norm(jax.grad(first_loss)(params))) > 100.0
    assert clipped == (target_scale > 1.0)
    opt, opt_state = jax_masked_adam(params, no_grads=(), learning_rate=LR)
    topt = masked_adam({"dynamics_params": list(tmodel.parameters())}, (), LR)
    assert len(topt.groups) == 1 and topt.params == list(tmodel.parameters())
    td = tuple(map(torch.from_numpy, data))
    for k in range(1, 4):
        rows = jnp.asarray(idx[k - 1: k])
        params, opt_state, loss_ref = jdyn._update_scan(
            jmodel, opt, params, opt_state, rows, jd, GAMMA, jnp.asarray(True))
        loss = tdyn.update_pass(tmodel, topt, td, torch.from_numpy(idx[k - 1: k]), GAMMA, True)
        np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5, err_msg=f"step {k}")
        got = dict(leaves(dynamics_to_jax_params(tmodel)))
        for name, ref in leaves(jax.device_get(params["dynamics_params"])):
            np.testing.assert_allclose(got[name], ref, rtol=0, atol=2 * k * LR,
                                       err_msg=f"{name} step {k}")


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_multistep_loss_and_gradients_match_jax(teacher_forcing):
    check_multistep_loss("ensemble", teacher_forcing)


@pytest.mark.parametrize("target_scale", [1.0, 300.0], ids=["unclipped", "clipped"])
def test_update_scan_step_matches_jax(target_scale):
    check_update_scan("ensemble", target_scale)


# -- the implicit gradient ----------------------------------------------------


@pytest.mark.parametrize("loss", ["l2", "gan"])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_batched_loss_and_grad_matches_jax(solver, loss):
    jl, jg, tl, tg = implicit_grads("ensemble", solver, loss, seed=5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    comps = ("mpc_weights", "cost_params", "dynamics_params") + (
        ("critic_params",) if loss == "gan" else ())
    assert_grads_match(tg, jg, comps, 1e-3)


def test_train_cost_matches_jax(monkeypatch):
    """The cost phase (dynamics, critic and expert frozen) on stable
    histories, CG as in ``configs/humanoid_scale.yaml``."""
    jpolicy, jparams, policy = policy_pair("ensemble", "cg", 6)
    hX = stable_histories(jpolicy, jparams, 12, 6, candidates=32)
    Y = (0.3 * np.random.default_rng(7).standard_normal((12, H + 1, X_SIZE))).astype(np.float32)
    train, test = (hX[:8], Y[:8]), (hX[8:], Y[8:])
    no_grads = ("dynamics_params", "critic_params", "expert_params")
    kwargs = dict(num_updates=1, batch_size=4, polyak_factor=0.9, eval_windows=4,
                  max_steps_per_update=2)
    draws = []

    def recording(*args):
        draws.append(np.array(jax_minibatch_indices(*args)))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jcost, "minibatch_indices", recording)
    opt, opt_state = jax_masked_adam(jparams, no_grads, LR)
    jout, _, jtrain, jtest = jcost.train_cost(
        jpolicy, opt, jparams, opt_state, tuple(map(jnp.asarray, train)),
        tuple(map(jnp.asarray, test)), jax_l2_loss, key=jax.random.PRNGKey(1), **kwargs)
    assert [d.shape for d in draws] == [(2, 4)]

    replay = iter(draws)
    monkeypatch.setattr(tcost, "minibatch_indices",
                        lambda gen, n, steps, batch: torch.from_numpy(next(replay)))
    topt = masked_adam(policy_components(policy), no_grads, LR)
    before = to_jax_params(policy)
    ttrain, ttest = tcost.train_cost(
        policy, topt, tuple(map(torch.from_numpy, train)), tuple(map(torch.from_numpy, test)),
        l2_imitation_loss, generator=torch.Generator(), **kwargs)
    np.testing.assert_allclose(ttrain, jtrain, rtol=1e-4)
    np.testing.assert_allclose(ttest, jtest, rtol=1e-4)
    got, want = dict(leaves(to_jax_params(policy))), dict(leaves(jax.device_get(jout)))
    old = dict(leaves(before))
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=0, atol=2 * 2 * LR, err_msg=name)
        moved = not np.array_equal(got[name], old[name])
        assert moved == name.startswith(("mpc_weights", "cost_params")), name


# -- a fused GAN epoch ------------------------------------------------------


@pytest.fixture(scope="module")
def ensemble_epoch(tmp_path_factory):
    return run_reference("ensemble_epoch", tmp_path_factory.mktemp("jax"))["gan"]


def test_fused_gan_epoch_matches_jax(ensemble_epoch):
    """As ``test_torch_fused_epoch.test_fused_epoch_matches_jax`` (metrics
    rtol 1e-4, the replay atol 1e-5, each trained parameter within 1e-6 +
    1% of how far JAX's epoch moved it, the rest bitwise), each bound
    widened to twice JAX's own spread where that is larger: the spread of
    its epoch rerun from the params scaled by 1 +- 1e-7. The ensemble's
    generator steps plan histories that are not picked for stability, and
    an implicit gradient there moves by more than rounding (a cost bias by
    5% of its 3e-5 step when this was written)."""
    ref = ensemble_epoch
    assert ref["members"] == 3 and len(ref["nudged"]) == 2
    assert jax_draws(ref).dyn_perm is not None
    metrics, replay, params = run_port(ref)
    for name, want in ref["metrics"].items():
        spread = max(abs(float(n["metrics"][name]) - float(want)) for n in ref["nudged"])
        assert abs(metrics[name] - float(want)) <= max(1e-6 + 1e-4 * abs(float(want)),
                                                       2 * spread), name
    n = ref["replay"]["size"]
    for name in ("states", "actions", "next_states"):
        np.testing.assert_allclose(getattr(replay, name)[:n].numpy(), ref["replay"][name],
                                   atol=1e-5, err_msg=name)
    want, before = dict(leaves(ref["params1"])), dict(leaves(ref["params0"]))
    nudged = [dict(leaves(n["params1"])) for n in ref["nudged"]]
    assert sorted(params) == sorted(want)
    assert want["dynamics_params/params/Dense_0/kernel"].shape[0] == 3
    for name, w in want.items():
        moved = np.abs(w - before[name]).max()
        if name.startswith(("mpc_weights", "cost_params", "dynamics_params", "critic_params")):
            spread = max(np.abs(nd[name] - w).max() for nd in nudged)
            assert moved > 0, name
            assert np.abs(params[name] - w).max() <= max(1e-6 + 1e-2 * moved, 2 * spread), name
        else:
            np.testing.assert_array_equal(params[name], w, err_msg=name)
