"""The expert predictor's trainer against the JAX package, on the CPU.

Small sizes: cheetah's 17 states and 6 actions, the predictor's trunk and
heads 16 wide, windows of 6 steps. Weights are JAX's ``init_params``
carried over by ``expert_from_jax_params``; where JAX draws (the split's
permutation, the minibatches, the evaluation's resets), the test records
JAX's draws and passes them to the port.

  * ``split_sequence_windows`` with JAX's permutation: equal windows,
    bitwise (a gather), the rest-start oversampling on the train side
    only;
  * ``expert_sequence_loss`` of both archs ("lstm", "mlp"), with teacher
    forcing and without: the loss rtol 1e-5 and every parameter's
    gradient against ``jax.grad`` (atol 1e-5 of the largest); the flax
    tree written back by ``expert_to_jax_params`` bitwise equal to JAX's;
  * ``train_expert`` for two epochs (teacher forcing on, then off) with
    JAX's minibatch draws replayed: each epoch's mean loss and the final
    test loss rtol 1e-4, the parameters after its k Adam steps atol 2 k lr
    (Adam's step is about lr per element whatever the gradient's size, so
    a gradient element within rounding of 0 can move its parameter by up
    to 2 lr a step the other way);
  * ``average_return`` of the predictor's closed-loop policy
    (``expert_eval_policy``) on cheetah from JAX's resets: atol 1e-4 of
    the mean return of 15 steps.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_mpc_tpu.data.normalizer import Normalizer as JaxNormalizer
from gan_mpc_tpu.data.windows import minibatch_indices as jax_minibatch_indices
from gan_mpc_tpu.data.windows import split_sequence_windows as jax_split
from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs.rollout import average_return as jax_average_return
from gan_mpc_tpu.models.expert import ExpertPredictor as JaxExpert
from gan_mpc_tpu.runners.expert import expert_eval_policy as jax_eval_policy
from gan_mpc_tpu.training import expert as jexpert
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.data.windows import split_sequence_windows
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.envs.rollout import average_return
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import expert_from_jax_params, expert_to_jax_params
from gan_mpc_tpu_torch.runners.expert import expert_eval_policy
from gan_mpc_tpu_torch.training import expert as texpert
from gan_mpc_tpu_torch.training.masking import ClippedAdam

torch.set_num_threads(1)

X, U, SEQLEN, GAMMA, LR = 17, 6, 6, 0.9, 1e-3
ARCHS = {"lstm": dict(features=16, hidden=(16, 16)), "mlp": dict(features=0, hidden=(16, 16))}


def _trajectories(n=4, length=30, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, length, X)).astype(np.float32),
            np.tanh(rng.standard_normal((n, length, U))).astype(np.float32))


def _models(arch, seed=0):
    """JAX's model and initial params, and the port's model holding them."""
    jmodel = JaxExpert(X, U, arch=arch, **ARCHS[arch])
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = expert_from_jax_params(jax.device_get(jparams),
                                   ExpertPredictor(X, U, arch=arch, **ARCHS[arch]))
    return jmodel, jparams, model


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _split(oversample=3):
    key = jax.random.PRNGKey(1)
    states, actions = _trajectories()
    n, num = states.shape[0], states.shape[1] - SEQLEN
    perm = np.asarray(jax.random.permutation(key, n * num))
    want = jax_split(jnp.asarray(states), jnp.asarray(actions), SEQLEN, key,
                     start_oversample=oversample)
    got = split_sequence_windows(torch.tensor(states), torch.tensor(actions), SEQLEN,
                                 start_oversample=oversample, perm=torch.tensor(perm))
    return want, got


def test_split_sequence_windows_matches_jax():
    want, got = _split()
    for side_w, side_g in zip(want, got):
        for w, g in zip(side_w, side_g):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    (train_x, _, _), (test_x, _, _) = got
    assert train_x.shape[0] > 0.8 * 4 * (30 - SEQLEN)  # oversampled train side
    assert test_x.shape[0] == 4 * (30 - SEQLEN) - int(4 * (30 - SEQLEN) * 0.8)


@pytest.mark.parametrize("arch", ["lstm", "mlp"])
@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_expert_sequence_loss_and_gradients_match_jax(arch, teacher_forcing):
    jmodel, jparams, model = _models(arch)
    _, ((xs, us, ys), _) = _split()
    xs, us, ys = xs[:8], us[:8], ys[:8]
    want, jgrads = jax.value_and_grad(
        lambda p: jexpert.expert_sequence_loss(jmodel, p, jnp.asarray(xs), jnp.asarray(us),
                                               jnp.asarray(ys), GAMMA,
                                               jnp.asarray(teacher_forcing)))(jparams)
    loss = texpert.expert_sequence_loss(model, xs, us, ys, GAMMA, teacher_forcing)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = copy.deepcopy(model)
    for g, p in zip(grads.parameters(), model.parameters()):
        g.data = p.grad
    got = dict(_leaves(expert_to_jax_params(grads)))
    for name, g in _leaves(jax.device_get(jgrads)):
        np.testing.assert_allclose(got[name], g, rtol=0, atol=1e-5 * max(np.abs(g).max(), 1e-6),
                                   err_msg=name)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in
               zip(_leaves(expert_to_jax_params(model)), _leaves(jax.device_get(jparams))))


def test_train_expert_matches_jax_with_its_draws():
    jmodel, jparams, model = _models("lstm")
    (train, test) = _split()[0]
    batch, epochs, tff = 16, 2, 0.5
    tx = optax.chain(optax.clip_by_global_norm(100.0), optax.adam(LR))
    key = jax.random.PRNGKey(7)
    jp, _, jlosses, jtest = jexpert.train_expert(
        jmodel, jparams, tx, tx.init(jparams), train, test, num_epochs=epochs,
        batch_size=batch, key=key, discount_factor=GAMMA, teacher_forcing_factor=tff,
        log_fn=None)
    datasize = train[0].shape[0]
    steps = max(datasize // batch, 1)
    indices = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        indices.append(torch.tensor(np.asarray(jax_minibatch_indices(sub, datasize, steps,
                                                                       batch))))
    to_t = lambda d: tuple(torch.tensor(np.asarray(a)) for a in d)
    losses, test_loss = texpert.train_expert(
        model, ClippedAdam([(model.parameters(), LR)], 100.0), to_t(train), to_t(test),
        num_epochs=epochs, batch_size=batch, discount_factor=GAMMA,
        teacher_forcing_factor=tff, log_fn=None, indices=indices)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(test_loss, jtest, rtol=1e-4)
    k = epochs * steps
    for (name, g), (_, w) in zip(_leaves(expert_to_jax_params(model)),
                                 _leaves(jax.device_get(jp))):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * k * LR, err_msg=name)


def test_average_return_of_the_expert_policy_matches_jax():
    jmodel, jparams, model = _models("lstm", seed=3)
    states, actions = _trajectories(seed=4)
    jnorm = JaxNormalizer.fit(jnp.asarray(states), jnp.asarray(actions), True, False)
    norm = Normalizer.fit(torch.tensor(states), torch.tensor(actions), True, False)
    jenv, env = jax_make_env("cheetah_run"), make_env("cheetah_run", "cpu")
    key, runs, steps = jax.random.PRNGKey(11), 3, 15
    want = float(jax_average_return(jenv, jenv.default_params(),
                                    jax.jit(jax_eval_policy(jmodel)), jparams, jnorm, key,
                                    steps, SEQLEN - 1, runs))
    # batched_rollout's resets: each env's key split in two, the first resets
    resets = jax.vmap(lambda k: jenv.reset(jenv.default_params(), jax.random.split(k)[0]))(
        jax.random.split(key, runs))
    init = EnvState(qpos=torch.tensor(np.asarray(resets.qpos)),
                    qvel=torch.tensor(np.asarray(resets.qvel)),
                    t=torch.zeros(runs, dtype=torch.int32))
    got = average_return(env, env.default_params(), expert_eval_policy(model.requires_grad_(False)),
                         norm, steps, SEQLEN - 1, runs, init_state=init)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-4)
