"""Port parity: the GAN critic, its losses and its trainer, on gan/9.

  * ``SequenceCritic`` on gan/9's trained critic (an LSTM of 64 features
    over 3 normalized states, a 64 -> 64 relu head, then 64 -> 1) against
    flax's ``apply`` under ``vmap``: scores rel 1e-5 of max|ref|;
  * ``critic_bce_loss`` and ``gan_generator_loss`` and their gradients
    (the critic's parameters, and the sequences the generator's gradient
    flows through) against ``jax.value_and_grad``: loss rel 1e-5, each
    gradient max|d| <= 1e-5 of its max|ref|;
  * one ``train_critic`` on gan/9 (2 updates of 2 minibatches of 4 on a
    dataset planned from 8 of 12 train histories and 6 test histories,
    iLQR <= 5, H=10), with JAX's draws (the subset, the two shuffles, the
    minibatches) replayed into the port: losses rel 1e-5, the critic's
    parameters after the updates max|d| <= 1e-5 of max|ref|, and no other
    component moved.

Float32 on the CPU.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gan_mpc_tpu.training.critic as jcritic
import gan_mpc_tpu_torch.training.critic as tcritic
from gan_mpc_tpu.data.windows import cost_windows as jax_cost_windows
from gan_mpc_tpu.data.windows import minibatch_indices as jax_minibatch_indices
from gan_mpc_tpu.models.critic import SequenceCritic as JaxCritic
from gan_mpc_tpu.policies.losses import critic_bce_loss as jax_critic_bce_loss
from gan_mpc_tpu.policies.losses import gan_generator_loss as jax_gan_generator_loss
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.training.masking import masked_adam as jax_masked_adam
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.models.critic import SequenceCritic
from gan_mpc_tpu_torch.params import critic_from_jax_params, load_msgpack
from gan_mpc_tpu_torch.policies.losses import critic_bce_loss, gan_generator_loss
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components
from test_torch_pendulum import G9, REPO, gan9_configs, jax_gan9, port_gan9, trajectories

torch.set_num_threads(1)
pin_fp32()

CRITIC_NO_GRADS = ("mpc_weights", "cost_params", "dynamics_params", "expert_params")


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)


def _critics():
    """gan/9's critic in flax (model, params) and in the port."""
    tree = load_msgpack(REPO / G9 / "params.msgpack")["critic_params"]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    critic = critic_from_jax_params(tree, SequenceCritic(3, 64, (64,)))
    return JaxCritic(features=64, hidden=(64,)), jparams, critic


def _seqs(B=16, T=11, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, 3)).astype(np.float32)


def _tree_leaves(tree):
    """The leaves of a flax Dense/LSTM tree, in the port's parameter
    order: the cell's i/h gate kernels and biases, then the head."""
    p = tree["params"]
    cell = p["ScanOptimizedLSTMCell_0"]
    out = []
    for g in "ifgo":
        out += [cell[f"i{g}"]["kernel"], cell[f"h{g}"]["kernel"], cell[f"h{g}"]["bias"]]
    for name in sorted((k for k in p if k.startswith("Dense_")), key=lambda s: int(s[6:])):
        out += [p[name]["kernel"], p[name]["bias"]]
    return [np.asarray(a) for a in out]


def _port_leaves(critic):
    lstm = critic.lstm
    out = []
    for g in "ifgo":
        out += [getattr(lstm, f"i{g}"), getattr(lstm, f"h{g}"), getattr(lstm, f"h{g}_bias")]
    for d in critic.head:
        out += [d.kernel, d.bias]
    return out


def _close(got, ref, rel, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), what


def test_sequence_critic_matches_flax():
    jmodel, jparams, critic = _critics()
    seqs = _seqs()
    ref = jax.vmap(lambda s: jmodel.apply(jparams, s))(jnp.asarray(seqs))
    with torch.no_grad():
        got = critic(torch.from_numpy(seqs))
    assert got.shape == (16,)
    _close(got.numpy(), ref, 1e-5, "scores")
    assert len(list(critic.parameters())) == len(_tree_leaves(jparams)) == 16


@pytest.mark.parametrize("loss", ["critic_bce", "generator"])
def test_losses_and_gradients_match_jax(loss):
    jmodel, jparams, critic = _critics()
    seqs = _seqs(seed=1)
    labels = np.where(np.arange(16) % 3 == 0, 1.0, -1.0).astype(np.float32)

    if loss == "critic_bce":
        def jax_loss(params, s):
            return jnp.mean(jax.vmap(lambda x, l: jax_critic_bce_loss(jmodel, params, x, l))(
                s, jnp.asarray(labels)))

        def port_loss(s):
            return critic_bce_loss(critic, s, torch.from_numpy(labels)).mean()
    else:
        jpolicy = SimpleNamespace(planned_states=lambda sol: sol.X, critic_model=jmodel)

        def jax_loss(params, s):
            return jnp.mean(jax.vmap(lambda x: jax_gan_generator_loss(
                jpolicy, SimpleNamespace(X=x), {"critic_params": params}))(s))

        tpolicy = SimpleNamespace(planned_states=lambda sol: sol.X, critic_model=critic)

        def port_loss(s):
            return gan_generator_loss(tpolicy, SimpleNamespace(X=s), "targets").mean()

    ref, (g_params, g_seqs) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jparams, jnp.asarray(seqs))
    x = torch.from_numpy(seqs).requires_grad_()
    critic.requires_grad_(True)
    got = port_loss(x)
    grads = torch.autograd.grad(got, [x, *_port_leaves(critic)])
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(grads[0].numpy(), g_seqs, 1e-5, "d/dseqs")
    for i, (g, r) in enumerate(zip(grads[1:], _tree_leaves(g_params))):
        _close(g.numpy(), r, 1e-5, f"critic parameter {i}")


def test_train_critic_matches_jax(monkeypatch):
    overrides = dict(mpc__solver__max_iterations=5)
    jcfg, pcfg = gan9_configs(**overrides)
    jpolicy, params = jax_gan9(jcfg)
    policy = port_gan9(pcfg)
    jtrajs, _ = trajectories(2, 40)
    jnorm = jcommon.build_normalizer(jcfg, jtrajs)
    X, Y = (np.array(a) for a in jax_cost_windows(
        jnorm.normalize_state(jnp.asarray(jtrajs.states)), 1, 10))
    train, test = (X[:12], Y[:12]), (X[40:46], Y[40:46])
    kwargs = dict(num_updates=2, batch_size=4, plan_batch=8)

    # JAX's draws, from its own key schedule; the minibatches recorded
    key = jax.random.PRNGKey(5)
    _, k_train, k_test, k_sub = jax.random.split(key, 4)
    subset = np.array(jax.random.choice(k_sub, 12, shape=(8,), replace=False))
    perms = [np.array(jax.random.permutation(k_train, 16)),
             np.array(jax.random.permutation(k_test, 12))]
    draws = []

    def recording(*args):
        draws.append(np.array(jax_minibatch_indices(*args)))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jcritic, "minibatch_indices", recording)
    opt, opt_state = jax_masked_adam(params, CRITIC_NO_GRADS, 1e-4)
    jparams, _, jtrain, jtest = jcritic.train_critic(
        jpolicy, opt, params, opt_state, tuple(map(jnp.asarray, train)),
        tuple(map(jnp.asarray, test)), key=key, **kwargs)
    assert [d.shape for d in draws] == [(4, 4), (4, 4)]

    perm_iter, draw_iter = iter(perms), iter(draws)
    monkeypatch.setattr(tcritic, "subset_indices", lambda gen, n, k: torch.from_numpy(subset))
    monkeypatch.setattr(tcritic, "permutation",
                        lambda gen, n: torch.from_numpy(next(perm_iter)))
    monkeypatch.setattr(tcritic, "minibatch_indices",
                        lambda gen, n, steps, batch: torch.from_numpy(next(draw_iter)))
    topt = masked_adam(policy_components(policy), CRITIC_NO_GRADS, 1e-4)
    before = {k: [p.detach().clone() for p in ps] for k, ps in policy_components(policy).items()}
    ttrain, ttest = tcritic.train_critic(
        policy, topt, tuple(map(torch.from_numpy, train)), tuple(map(torch.from_numpy, test)),
        generator=torch.Generator(), **kwargs)

    np.testing.assert_allclose(ttrain, jtrain, rtol=1e-5)
    np.testing.assert_allclose(ttest, jtest, rtol=1e-5)
    for i, (p, r) in enumerate(zip(_port_leaves(policy.critic_model),
                                   _tree_leaves(jparams["critic_params"]))):
        _close(p.detach().numpy(), r, 1e-5, f"critic parameter {i}")
    for name, ps in policy_components(policy).items():
        moved = any(not torch.equal(p, q) for p, q in zip(ps, before[name]))
        assert moved == (name == "critic_params"), name
