"""Port parity: the dynamics-training path against the JAX package.

Windows, split, replay buffer, ``discounted_sum``, ``Normalizer.fit``,
the multi-step prediction loss and its gradients, optimizer steps, the
teacher-forcing schedule and the warm start, and one whole
``train_dynamics`` epoch, at the flagship's dynamics widths
(23->200->200->200->17) with small batches. Inputs and weights come from
a numpy seed; both packages run float32 on the CPU. Where JAX draws
random numbers (permutations, minibatch indices), the test records JAX's
draws and feeds them to the port. Tolerances are stated per test.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gan_mpc_tpu.training.dynamics as jdyn
import gan_mpc_tpu_torch.training.dynamics as tdyn
from gan_mpc_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from gan_mpc_tpu.data.normalizer import Normalizer as JaxNormalizer
from gan_mpc_tpu.data.windows import minibatch_indices as jax_minibatch_indices
from gan_mpc_tpu.data.windows import sequence_windows as jax_sequence_windows
from gan_mpc_tpu.data.windows import shuffle_and_split as jax_shuffle_and_split
from gan_mpc_tpu.models.dynamics import LearnedDynamics as JaxLearnedDynamics
from gan_mpc_tpu.models.dynamics import ResidualMLPDynamicsNet as JaxResidualNet
from gan_mpc_tpu.training.common import discounted_sum as jax_discounted_sum
from gan_mpc_tpu.training.masking import masked_adam as jax_masked_adam
from gan_mpc_tpu.training.masking import polyak_blend as jax_polyak_blend
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import flagship
from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.data.windows import (
    minibatch_indices,
    sequence_windows,
    shuffle_and_split,
)
from gan_mpc_tpu_torch.envs import make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.params import dynamics_from_jax_params
from gan_mpc_tpu_torch.training.common import discounted_sum
from gan_mpc_tpu_torch.training.masking import (
    masked_adam,
    policy_components,
    polyak_blend,
)

torch.set_num_threads(1)
pin_fp32()

X_SIZE, U_SIZE, SEQLEN = 17, 6, 5
WIDTHS = [X_SIZE + U_SIZE, 200, 200, 200, X_SIZE]
LR, GAMMA = 1e-5, 0.9  # configs/gan_cheetah.yaml, mpc.train.dynamics


def _trajectories(n, length, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    states = (scale * rng.standard_normal((n, length, X_SIZE))).astype(np.float32)
    actions = rng.uniform(-1, 1, (n, length, U_SIZE)).astype(np.float32)
    return states, actions


def _windows(n, seed, target_scale=1.0):
    """(X, U, Y) numpy windows; Y is a damped copy of X, scaled."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, SEQLEN, X_SIZE)).astype(np.float32)
    U = rng.uniform(-1, 1, (n, SEQLEN, U_SIZE)).astype(np.float32)
    Y = (target_scale * (0.9 * X + 0.1 * rng.standard_normal(X.shape))).astype(np.float32)
    return X, U, Y


def _dynamics_tree(seed):
    """A JAX ``dynamics_params`` tree of numpy weights (biases non-zero)."""
    rng = np.random.default_rng(seed)
    return {"params": {
        f"Dense_{i}": {
            "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(b)).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(WIDTHS[:-1], WIDTHS[1:]))
    }}


def _models(seed):
    """(JAX model, JAX params, port model) on the same weights."""
    tree = _dynamics_tree(seed)
    jmodel = JaxLearnedDynamics(JaxResidualNet(X_SIZE, hidden=(200, 200, 200)))
    tmodel = dynamics_from_jax_params(
        tree, LearnedDynamics(ResidualMLPDynamicsNet(X_SIZE, U_SIZE))
    )
    return jmodel, jax.tree_util.tree_map(jnp.asarray, tree), tmodel


def _port_params(tmodel):
    return [(d.kernel.detach().numpy(), d.bias.detach().numpy()) for d in tmodel.net.layers]


def _jax_params(tree):
    p = tree["params"]
    return [(np.asarray(p[f"Dense_{i}"]["kernel"]), np.asarray(p[f"Dense_{i}"]["bias"]))
            for i in range(len(p))]


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


# -- data -------------------------------------------------------------------


@pytest.mark.parametrize("oversample", [0, 2])
def test_sequence_windows_match_jax(oversample):
    """Exact: a gather."""
    states, actions = _trajectories(3, 12, 0)
    ref = jax_sequence_windows(jnp.asarray(states), jnp.asarray(actions), SEQLEN, oversample)
    got = sequence_windows(*_t(states, actions), SEQLEN, oversample)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_shuffle_and_split_matches_jax_on_its_permutation():
    """Exact, on JAX's permutation; the generator's split is a partition."""
    data = _windows(23, 1)
    key = jax.random.PRNGKey(3)
    ref = jax_shuffle_and_split(tuple(jnp.asarray(d) for d in data), key)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 23)))
    got = shuffle_and_split(_t(*data), perm=perm)
    for g_half, r_half in zip(got, ref):
        for g, r in zip(g_half, r_half):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    train, test = shuffle_and_split(_t(*data), torch.Generator().manual_seed(0))
    assert train[0].shape[0] == 18 and test[0].shape[0] == 5
    rows = torch.cat([train[0], test[0]]).reshape(23, -1)
    assert torch.equal(rows.sort(0).values, _t(data[0])[0].reshape(23, -1).sort(0).values)


def test_minibatch_indices_shape_and_range():
    """As ``jax.random.choice(key, n, (steps, batch))``: with replacement,
    in [0, n)."""
    ref = jax_minibatch_indices(jax.random.PRNGKey(0), 10, 4, 32)
    got = minibatch_indices(torch.Generator().manual_seed(0), 10, 4, 32)
    assert got.shape == ref.shape and got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 10


def test_replay_buffer_ring_wrap_matches_jax():
    """Exact: windows, ring pointer and fill level after the adds wrap."""
    jbuf = JaxReplayBuffer.create(capacity=20, seqlen=SEQLEN, x_size=X_SIZE, u_size=U_SIZE)
    tbuf = ReplayBuffer.create(20, SEQLEN, X_SIZE, U_SIZE, device="cpu")
    for seed, n in [(0, 2), (1, 1), (2, 2)]:  # 8 + 4 + 8 windows of 9-step trajectories
        states, actions = _trajectories(n, 9, seed)
        jbuf = jbuf.add_trajectories(jnp.asarray(states), jnp.asarray(actions))
        assert tbuf.add_trajectories(*_t(states, actions)) is tbuf
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
    assert (tbuf.ptr, tbuf.size) == (0, 20)
    for name in ("states", "actions", "next_states"):
        np.testing.assert_array_equal(getattr(tbuf, name).numpy(), np.asarray(getattr(jbuf, name)))
    xw, uw, yw = _windows(5, 4)
    jbuf = jbuf.add_windows(jnp.asarray(xw), jnp.asarray(uw), jnp.asarray(yw))
    tbuf.add_windows(*_t(xw, uw, yw))
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size)) == (5, 20)
    np.testing.assert_array_equal(tbuf.states.numpy(), np.asarray(jbuf.states))
    X, U, Y = tbuf.sample(torch.Generator().manual_seed(0), 3, 7)
    assert X.shape == (3, 7, SEQLEN, X_SIZE) and U.shape == (3, 7, SEQLEN, U_SIZE)


def test_discounted_sum_matches_jax():
    """Both packages against a float64 sum of the same terms (the float32
    discounts, as both take them), to the float32 bound n 2^-24 sum_t
    |gamma^t x_t|: the two reduce the n = 7 terms in different orders, so
    they may differ from each other by rounding (1.3e-6 relative on this
    input), each within the bound."""
    seq = np.random.default_rng(5).standard_normal((7, 4, 3)).astype(np.float32)
    discounts = np.float64(np.float32(GAMMA)) ** np.arange(7)
    exact = np.tensordot(discounts, seq.astype(np.float64), axes=(0, 0))
    bound = 7 * 2.0 ** -24 * np.tensordot(discounts, np.abs(seq.astype(np.float64)),
                                          axes=(0, 0))
    for got in (np.asarray(jax_discounted_sum(jnp.asarray(seq), GAMMA)),
                discounted_sum(*_t(seq), GAMMA).numpy()):
        assert np.all(np.abs(got - exact) <= bound)


@pytest.mark.parametrize("flags", [(True, False), (True, True), (False, True)])
def test_normalizer_fit_matches_jax(flags):
    """Population std plus eps, as ``jnp.std``; rtol 1e-6."""
    states, actions = _trajectories(4, 30, 6, scale=3.0)
    ref = JaxNormalizer.fit(jnp.asarray(states), jnp.asarray(actions), *flags)
    got = Normalizer.fit(*_t(states, actions), *flags)
    for name in ("state_mean", "state_std", "action_mean", "action_std"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_polyak_blend_matches_jax():
    """rtol 1e-6; exact where the entries are equal."""
    rng = np.random.default_rng(7)
    old = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": np.ones(2, np.float32)}
    new = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": np.ones(2, np.float32)}
    ref = jax_polyak_blend(old, new, 0.9)
    got = polyak_blend({k: torch.from_numpy(v) for k, v in old.items()},
                       {k: torch.from_numpy(v) for k, v in new.items()}, 0.9)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(ref["a"]), rtol=1e-6)
    np.testing.assert_array_equal(got["b"].numpy(), old["b"])


# -- loss, gradients, optimizer ------------------------------------------


def _jax_loss(jmodel, X, U, Y, tf):
    def loss_fn(params):
        losses = jax.vmap(lambda x, u, y: jdyn.multistep_prediction_loss(
            jmodel, params["dynamics_params"], x, u, y, GAMMA, tf))(X, U, Y)
        return jnp.mean(losses)
    return loss_fn


@pytest.mark.parametrize("teacher_forcing", [True, False], ids=["tf_on", "tf_off"])
def test_multistep_loss_and_grads_match_jax(teacher_forcing):
    """16 windows. Loss rtol 1e-5; gradients atol 1e-5 * max(1, max|ref|)
    (f32 sums over 16 windows x 5 steps in another order)."""
    jmodel, jparams, tmodel = _models(8)
    X, U, Y = _windows(16, 9)
    loss_ref, g_ref = jax.value_and_grad(_jax_loss(
        jmodel, *map(jnp.asarray, (X, U, Y)), jnp.asarray(teacher_forcing)))(
        {"dynamics_params": jparams})
    loss = tdyn.multistep_prediction_loss(tmodel, *_t(X, U, Y), GAMMA, teacher_forcing).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    for (gw, gb), (rw, rb) in zip(
        [(d.kernel.grad.numpy(), d.bias.grad.numpy()) for d in tmodel.net.layers],
        _jax_params(g_ref["dynamics_params"]),
    ):
        for g, r in ((gw, rw), (gb, rb)):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("target_scale", [1.0, 30.0], ids=["unclipped", "clipped"])
def test_optimizer_steps_match_jax_update_scan(target_scale):
    """Three steps on the same index rows: per-step losses rtol 1e-5;
    parameters after step k atol 2 k lr (Adam's early steps are about
    lr * sign(g), which flips where |g| is near 0). At target scale 30
    the global gradient norm exceeds the clip of 100."""
    jmodel, jparams, tmodel = _models(10)
    data = _windows(16, 11, target_scale)
    idx = np.random.default_rng(12).integers(0, 16, (3, 8))
    jd = tuple(jnp.asarray(d) for d in data)
    params = {"dynamics_params": jparams}
    _, g0 = jax.value_and_grad(_jax_loss(jmodel, *(d[idx[0]] for d in jd), True))(params)
    clipped = float(optax.global_norm(g0)) > 100.0
    assert clipped == (target_scale > 1.0)

    opt, opt_state = jax_masked_adam(params, no_grads=(), learning_rate=LR)
    topt = masked_adam({"dynamics_params": list(tmodel.parameters())}, (), LR)
    td = _t(*data)
    for k in range(1, 4):
        rows = jnp.asarray(idx[k - 1: k])
        params, opt_state, loss_ref = jdyn._update_scan(
            jmodel, opt, params, opt_state, rows, jd, GAMMA, jnp.asarray(True))
        loss = tdyn.update_pass(tmodel, topt, td, torch.from_numpy(idx[k - 1: k]), GAMMA, True)
        np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5, err_msg=f"step {k}")
        for (gw, gb), (rw, rb) in zip(_port_params(tmodel),
                                      _jax_params(params["dynamics_params"])):
            np.testing.assert_allclose(gw, rw, rtol=0, atol=2 * k * LR)
            np.testing.assert_allclose(gb, rb, rtol=0, atol=2 * k * LR)


def test_masked_adam_trains_only_the_named_components():
    policy = flagship(2, 1, device="cpu", seed=0)
    comps = policy_components(policy)
    with pytest.raises(ValueError, match="unknown"):
        masked_adam(comps, ["critic_params"], LR)
    opt = masked_adam(comps, ["mpc_weights", "cost_params", "expert_params"], LR)
    assert opt.params == comps["dynamics_params"]
    assert all(p.requires_grad for p in comps["dynamics_params"])
    assert not any(p.requires_grad for name in ("mpc_weights", "cost_params", "expert_params")
                   for p in comps[name])


# -- the trainer ----------------------------------------------------------


def _episode(n, length, seed):
    states, actions = _trajectories(n, length, seed)
    rewards = np.random.default_rng(seed + 100).uniform(0, 1, (n, length)).astype(np.float32)
    return states, actions, rewards


def _record_runs(monkeypatch, epoch, warm, expert_updates):
    """The (teacher forcing, dataset size, index-matrix shape) of every
    update pass that the JAX and the port trainer make in one epoch of
    2 episodes x 3 updates (factor 0.7), with the update passes stubbed."""
    expert = _windows(40, 13)
    episodes = [_episode(2, 10, 20 + i) for i in range(2)]
    kwargs = dict(num_episodes=2, num_updates=3, batch_size=8, discount_factor=GAMMA,
                  teacher_forcing_factor=0.7, epoch=epoch, warm_start_updates=warm,
                  expert_updates=expert_updates)
    jax_calls, port_calls = [], []

    def jax_update(model, opt, params, opt_state, perm, dataset, gamma, tf):
        jax_calls.append((bool(tf), dataset[0].shape[0], tuple(perm.shape)))
        return params, opt_state, jnp.float32(0.0)

    def port_update(model, opt, dataset, indices, gamma, tf):
        port_calls.append((bool(tf), dataset[0].shape[0], tuple(indices.shape)))
        return torch.tensor(0.0)

    monkeypatch.setattr(jdyn, "_update_scan", jax_update)
    monkeypatch.setattr(tdyn, "update_pass", port_update)
    jeps = iter(episodes)
    _, _, _, jret, jlosses = jdyn.train_dynamics(
        None, None, {}, None, tuple(jnp.asarray(d) for d in expert),
        JaxReplayBuffer.create(100, SEQLEN, X_SIZE, U_SIZE),
        lambda p, k: SimpleNamespace(**dict(zip(("states", "actions", "rewards"),
                                                map(jnp.asarray, next(jeps))))),
        JaxNormalizer.identity(X_SIZE, U_SIZE), key=jax.random.PRNGKey(0), **kwargs)
    teps = iter(episodes)
    _, tret, tlosses = tdyn.train_dynamics(
        None, None, _t(*expert), ReplayBuffer.create(100, SEQLEN, X_SIZE, U_SIZE, "cpu"),
        lambda gen: SimpleNamespace(**dict(zip(("states", "actions", "rewards"),
                                               _t(*next(teps))))),
        Normalizer.identity(X_SIZE, U_SIZE, "cpu"), generator=torch.Generator(), **kwargs)
    np.testing.assert_allclose(tret, jret, rtol=1e-6)
    assert len(tlosses) == len(jlosses)
    return jax_calls, port_calls


@pytest.mark.parametrize("epoch,warm,expert_updates", [(1, 3, 0), (1, 3, 2), (2, 3, 1)])
def test_teacher_forcing_schedule_and_warm_start_match_jax(monkeypatch, epoch, warm,
                                                           expert_updates):
    """Exact: the sequence of update passes, each with its teacher-forcing
    flag, data size (expert windows, then the growing replay buffer) and
    number of minibatches."""
    jax_calls, port_calls = _record_runs(monkeypatch, epoch, warm, expert_updates)
    assert port_calls == jax_calls
    n_warm = warm if epoch == 1 else 0
    assert len(port_calls) == n_warm + expert_updates + 2 * 3


def test_train_dynamics_epoch_matches_jax(monkeypatch):
    """One epoch at the configuration's settings (warm start 2 updates on
    24 expert windows, batch 8, one episode, one update, factor 0.7),
    fitted normalizer, a fixed episode for both, JAX's minibatch draws fed
    to the port. Losses rtol 1e-5; parameters atol 2 k lr after k = 7
    steps; the replay buffer's windows atol 1e-6 (normalized in f32)."""
    jmodel, jparams, tmodel = _models(14)
    states, actions = _trajectories(2, 9, 15, scale=2.0)
    norm_args = (states.reshape(-1, X_SIZE), actions.reshape(-1, U_SIZE))
    jnorm = JaxNormalizer.fit(*map(jnp.asarray, norm_args))
    tnorm = Normalizer.fit(*_t(*norm_args))
    expert = tuple(np.asarray(d) for d in jax_sequence_windows(
        jnorm.normalize_state(jnp.asarray(states)), jnp.asarray(actions), SEQLEN))
    expert = tuple(np.concatenate([d, d, d]) for d in expert)  # 24 windows
    episode = _episode(1, 12, 16)
    kwargs = dict(num_episodes=1, num_updates=1, batch_size=8, discount_factor=GAMMA,
                  teacher_forcing_factor=0.7, epoch=1, warm_start_updates=2)

    draws = []

    def recording(*args):
        draws.append(np.array(jax_minibatch_indices(*args)))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jdyn, "minibatch_indices", recording)
    params = {"dynamics_params": jparams}
    opt, opt_state = jax_masked_adam(params, no_grads=(), learning_rate=LR)
    params, _, jbuf, jret, jlosses = jdyn.train_dynamics(
        jmodel, opt, params, opt_state, tuple(jnp.asarray(d) for d in expert),
        JaxReplayBuffer.create(100, SEQLEN, X_SIZE, U_SIZE),
        lambda p, k: SimpleNamespace(states=jnp.asarray(episode[0]),
                                     actions=jnp.asarray(episode[1]),
                                     rewards=jnp.asarray(episode[2])),
        jnorm, key=jax.random.PRNGKey(1), **kwargs)
    assert [d.shape for d in draws] == [(3, 8), (3, 8), (1, 8)]

    replay = iter(draws)
    monkeypatch.setattr(tdyn, "minibatch_indices",
                        lambda gen, n, steps, batch: torch.from_numpy(next(replay)))
    topt = masked_adam({"dynamics_params": list(tmodel.parameters())}, (), LR)
    tbuf, tret, tlosses = tdyn.train_dynamics(
        tmodel, topt, _t(*expert), ReplayBuffer.create(100, SEQLEN, X_SIZE, U_SIZE, "cpu"),
        lambda gen: SimpleNamespace(**dict(zip(("states", "actions", "rewards"),
                                               _t(*episode)))),
        tnorm, generator=torch.Generator(), **kwargs)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(tret, jret, rtol=1e-6)
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size)) == (7, 7)
    for name in ("states", "actions", "next_states"):
        np.testing.assert_allclose(getattr(tbuf, name).numpy(),
                                   np.asarray(getattr(jbuf, name)), rtol=0, atol=1e-6)
    for (gw, gb), (rw, rb) in zip(_port_params(tmodel), _jax_params(params["dynamics_params"])):
        np.testing.assert_allclose(gw, rw, rtol=0, atol=2 * 7 * LR)
        np.testing.assert_allclose(gb, rb, rtol=0, atol=2 * 7 * LR)


def test_train_dynamics_collects_with_the_policy_it_trains():
    """The port's own collection: ``policy_rollout`` under the flagship
    policy whose dynamics are trained (shared parameters, planning without
    gradients), on the CPU at 1 env x 8 steps, H=5, 1 iLQR iteration. Only
    the dynamics change; the episode's windows land in the buffer."""
    policy = flagship(5, 1, device="cpu", seed=0)
    comps = policy_components(policy)
    before = {name: [p.detach().clone() for p in ps] for name, ps in comps.items()}
    opt = masked_adam(comps, ["mpc_weights", "cost_params", "expert_params"], LR)
    env = make_env("cheetah_run", "cpu")
    norm = Normalizer.identity(X_SIZE, U_SIZE, "cpu")
    episodes = []

    def collect(gen):
        assert all(p.requires_grad for p in comps["dynamics_params"])
        episodes.append(policy_rollout(env, env.default_params(), policy, norm, num_steps=8,
                                       history=1, num_envs=1, generator=gen))
        return episodes[-1]

    expert = tuple(t[:, :SEQLEN] for t in _t(*_windows(16, 17)))
    buf, returns, losses = tdyn.train_dynamics(
        policy.dynamics_model, opt, expert, ReplayBuffer.create(50, SEQLEN, X_SIZE, U_SIZE,
                                                                "cpu"),
        collect, norm, num_episodes=1, num_updates=1, batch_size=8, discount_factor=GAMMA,
        teacher_forcing_factor=0.7, generator=torch.Generator().manual_seed(0), epoch=1,
        warm_start_updates=1)
    assert len(losses) == 2 and np.all(np.isfinite(losses)) and np.isfinite(returns[0])
    assert buf.size == 3 and episodes[0].actions.grad_fn is None
    np.testing.assert_array_equal(buf.states[:3, 0].numpy(), episodes[0].states[0, :3].numpy())
    for name, ps in comps.items():
        moved = any(not torch.equal(p, q) for p, q in zip(ps, before[name]))
        assert moved == (name == "dynamics_params"), name
