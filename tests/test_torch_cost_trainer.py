"""Port parity: the bilevel cost trainer against the JAX package.

``cost_windows`` (exact), ``masked_adam`` with and without
``weights_learning_rate`` (two steps on the same gradients against optax,
atol 1e-6), and one ``train_cost`` call (1 update of 2 minibatch steps of
4 windows, evaluation on 8 windows, the Polyak blend) on the small
cheetah policy of ``tests/test_torch_bilevel.py``, with JAX's minibatch
draws recorded and replayed into the port. Compared: losses rtol 1e-4,
parameters atol 2 k lr after k Adam steps at each group's rate. Float32
on the CPU. A ``gpu``-marked test holds one implicit-gradient minibatch
step on the card against the CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gan_mpc_tpu.training.cost as jcost
import gan_mpc_tpu_torch.training.cost as tcost
from gan_mpc_tpu.data.windows import cost_windows as jax_cost_windows
from gan_mpc_tpu.data.windows import minibatch_indices as jax_minibatch_indices
from gan_mpc_tpu.policies.losses import l2_imitation_loss as jax_l2_loss
from gan_mpc_tpu.training.masking import masked_adam as jax_masked_adam
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.data.windows import cost_windows
from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components
from test_torch_bilevel import B, H, U_SIZE, X_SIZE, _dense_leaves, _jax_policy, _port_policy

torch.set_num_threads(1)
pin_fp32()

NO_GRADS = ("dynamics_params", "expert_params")  # the cost phase's, without a critic
LR, WEIGHTS_LR, POLYAK = 1e-5, 1e-3, 0.9


@pytest.mark.parametrize("history,horizon", [(1, 5), (3, 2)])
def test_cost_windows_match_jax(history, horizon):
    states = np.random.default_rng(history).standard_normal((3, 12, X_SIZE)).astype(np.float32)
    ref = jax_cost_windows(jnp.asarray(states), history, horizon)
    got = cost_windows(torch.from_numpy(states), history, horizon)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].shape == (3 * (12 - horizon - history), history + 1, X_SIZE)


@pytest.mark.parametrize("weights_lr", [None, WEIGHTS_LR], ids=["one_group", "weights_group"])
def test_masked_adam_matches_optax(weights_lr):
    """Two steps: the first gradients' norm (1,000) is clipped to 100 in
    the "learn" group, the second's (50) is not; the MPC weights' small
    gradients are clipped with the nets' only when they share a group."""
    rng = np.random.default_rng(0)
    shapes = {"mpc_weights": [(3,)], "cost_params": [(4, 5), (5,)], "dynamics_params": [(6,)]}
    init = {k: [rng.standard_normal(s).astype(np.float32) for s in v] for k, v in shapes.items()}
    steps = []
    for norm in (1000.0, 50.0):
        g = {k: [rng.standard_normal(s).astype(np.float32) for s in v] for k, v in shapes.items()}
        scale = norm / np.sqrt(sum((a ** 2).sum() for a in g["cost_params"]))
        g["cost_params"] = [scale * a for a in g["cost_params"]]
        steps.append(g)

    tree = lambda d: {k: {str(i): jnp.asarray(a) for i, a in enumerate(v)} for k, v in d.items()}
    params = tree(init)
    tx, state = jax_masked_adam(params, ["dynamics_params"], LR * 1e3,
                                weights_learning_rate=weights_lr)
    for g in steps:
        updates, state = tx.update(tree(g), state, params)
        params = optax.apply_updates(params, updates)

    comps = {k: [torch.tensor(a) for a in v] for k, v in init.items()}
    opt = masked_adam(comps, ["dynamics_params"], LR * 1e3, weights_learning_rate=weights_lr)
    assert len(opt.groups) == (1 if weights_lr is None else 2)
    for g in steps:
        for k, ps in comps.items():
            for p, a in zip(ps, g[k]):
                p.grad = torch.tensor(a)
        opt.step()
    for k, ps in comps.items():
        for i, p in enumerate(ps):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k][str(i)]),
                                       rtol=0, atol=1e-6, err_msg=f"{k}[{i}]")
    assert not comps["dynamics_params"][0].requires_grad


def _windows():
    """16 train and 8 test cost windows (history 1) of 4 random state
    trajectories of 11 steps, scaled to sit clear of line-search flips."""
    states = (0.2 * np.random.default_rng(7).standard_normal((4, 11, X_SIZE))).astype(np.float32)
    X, Y = (np.array(a) for a in jax_cost_windows(jnp.asarray(states), 1, H))
    assert X.shape[0] == 4 * (11 - H - 1) == 28
    return (X[:16], Y[:16]), (X[16:24], Y[16:24])


def test_train_cost_matches_jax(monkeypatch):
    train, test = _windows()
    jpolicy = _jax_policy("dense")
    params = jpolicy.init(jax.random.PRNGKey(3), (-2.0, 3.0, -3.0), U_SIZE)
    tree = jax.device_get(params)
    kwargs = dict(num_updates=1, batch_size=4, polyak_factor=POLYAK, eval_windows=8,
                  max_steps_per_update=2)

    draws = []

    def recording(*args):
        draws.append(np.array(jax_minibatch_indices(*args)))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jcost, "minibatch_indices", recording)
    opt, opt_state = jax_masked_adam(params, NO_GRADS, LR, weights_learning_rate=WEIGHTS_LR)
    jparams, _, jtrain, jtest = jcost.train_cost(
        jpolicy, opt, params, opt_state, tuple(map(jnp.asarray, train)),
        tuple(map(jnp.asarray, test)), jax_l2_loss, key=jax.random.PRNGKey(1), **kwargs)
    assert [d.shape for d in draws] == [(2, 4)]

    replay = iter(draws)
    monkeypatch.setattr(tcost, "minibatch_indices",
                        lambda gen, n, steps, batch: torch.from_numpy(next(replay)))
    policy = _port_policy(tree, "dense").requires_grad_(False)
    topt = masked_adam(policy_components(policy), NO_GRADS, LR, weights_learning_rate=WEIGHTS_LR)
    before = {k: [p.detach().clone() for p in ps] for k, ps in policy_components(policy).items()}
    ttrain, ttest = tcost.train_cost(
        policy, topt, tuple(map(torch.from_numpy, train)), tuple(map(torch.from_numpy, test)),
        l2_imitation_loss, generator=torch.Generator(), **kwargs)

    np.testing.assert_allclose(ttrain, jtrain, rtol=1e-4)
    np.testing.assert_allclose(ttest, jtest, rtol=1e-4)
    comps = policy_components(policy)
    refs = {"mpc_weights": [np.asarray(jparams["mpc_weights"])],
            "cost_params": _dense_leaves(jparams["cost_params"]),
            "dynamics_params": _dense_leaves(jparams["dynamics_params"])}
    for name, lr in (("mpc_weights", WEIGHTS_LR), ("cost_params", LR), ("dynamics_params", LR)):
        for p, r in zip(comps[name], refs[name]):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=0, atol=2 * 2 * lr,
                                       err_msg=name)
    for name, ps in comps.items():
        moved = any(not torch.equal(p, q) for p, q in zip(ps, before[name]))
        assert moved == (name in ("mpc_weights", "cost_params")), name


@pytest.mark.gpu
def test_implicit_step_on_the_card_matches_the_cpu():
    """One minibatch step's loss and gradients (``batched_loss_and_grad``,
    all components differentiated) on the card against the CPU path:
    loss rel 1e-4, each gradient 1e-3 of its max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree = jax.device_get(_jax_policy("dense").init(jax.random.PRNGKey(3), (-2.0, 3.0, -3.0),
                                                   U_SIZE))
    (X, Y), _ = _windows()
    results = []
    for device in ("cuda", "cpu"):
        policy = _port_policy(tree, "dense").to(device).requires_grad_(True)
        results.append(policy.batched_loss_and_grad(
            torch.from_numpy(X[:B]).to(device), l2_imitation_loss,
            (torch.from_numpy(Y[:B]).to(device),)))
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
    np.testing.assert_allclose(loss_gpu.item(), loss_cpu.item(), rtol=1e-4)
    for name in g_cpu:
        for a, r in zip(g_gpu[name], g_cpu[name]):
            assert (a.cpu() - r).abs().max() <= 1e-3 * max(r.abs().max().item(), 1e-12), name
