"""Port parity: one modular GAN epoch on gan/9, against the JAX loop body.

The JAX runner's epoch (``gan_mpc_tpu/runners/gan.py``, the modular loop:
``train_dynamics``, ``train_critic``, ``train_cost`` with
``gan_generator_loss``) is written out here on gan/9 loaded from its own
``config.json`` and ``params.msgpack``, and the port's
``runners.gan.gan_epoch`` runs on ``runners.common.setup`` of the same
config, both on the committed expert store. Cut to size: 2 trajectories
of 40 steps, an on-policy episode of 12 steps at 1 env with the
collection noise (0.2), iLQR <= 5, one update per phase, small batches.
Every JAX draw (the splits, the reset and the noise, the critic's subset
and shuffles, the minibatches) is recorded and replayed into the port.
Compared: every loss and the episode return, rel 1e-4; each phase moves
its own components and leaves the others bitwise unchanged. Float32 on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gan_mpc_tpu.training.cost as jcost
import gan_mpc_tpu.training.critic as jcritic
import gan_mpc_tpu.training.dynamics as jdyn
import gan_mpc_tpu_torch.training.cost as tcost
import gan_mpc_tpu_torch.training.critic as tcritic
import gan_mpc_tpu_torch.training.dynamics as tdyn
from gan_mpc_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from gan_mpc_tpu.data.windows import cost_windows as jax_cost_windows
from gan_mpc_tpu.data.windows import minibatch_indices as jax_minibatch_indices
from gan_mpc_tpu.data.windows import sequence_windows as jax_sequence_windows
from gan_mpc_tpu.data.windows import shuffle_and_split as jax_shuffle_and_split
from gan_mpc_tpu.envs.rollout import policy_rollout as jax_policy_rollout
from gan_mpc_tpu.policies.losses import gan_generator_loss as jax_gan_loss
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.training.masking import masked_adam as jax_masked_adam
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.envs import EnvState
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.runners import common, gan
from gan_mpc_tpu_torch.training.masking import policy_components
from test_torch_pendulum import REPO, STORE, gan9_configs, jax_gan9, trajectories

torch.set_num_threads(1)
pin_fp32()


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)


# -- one GAN epoch ------------------------------------------------------------

EPOCH_CUTS = dict(
    mpc__solver__max_iterations=5, mpc__train__num_trajectories=2,
    mpc__train__trajectory_len=40,
    mpc__train__dynamics__max_interactions_per_episode=12,
    mpc__train__dynamics__warm_start_updates=1, mpc__train__dynamics__expert_updates=1,
    mpc__train__dynamics__num_updates=1, mpc__train__dynamics__batch_size=16,
    mpc__train__critic__plan_batch=8, mpc__train__critic__batch_size=4,
    mpc__train__critic__num_updates=1, mpc__train__cost__batch_size=4,
    mpc__train__cost__num_updates=1, mpc__train__cost__steps_per_update=2,
    mpc__train__cost__eval_windows=6,
)


def _jax_epoch(jcfg, key, record):
    """The JAX runner's modular epoch body (``runners/gan.py``) on the
    committed store; records the draws it makes in ``record``."""
    tcfg = jcfg.mpc.train
    ccfg, dcfg, qcfg = tcfg.cost, tcfg.dynamics, tcfg.critic
    jpolicy, params = jax_gan9(jcfg)
    jtrajs, _ = trajectories(tcfg.num_trajectories, tcfg.trajectory_len)
    jnorm = jcommon.build_normalizer(jcfg, jtrajs)
    states = jnorm.normalize_state(jnp.asarray(jtrajs.states))
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    cost_data = jax_shuffle_and_split(jax_cost_windows(states, 1, 10), k1)
    dyn_actions = jnorm.normalize_action(jnp.asarray(jtrajs.dynamics_actions))
    dyn_train, _ = jax_shuffle_and_split(jax_sequence_windows(states, dyn_actions, 10), k2)
    env_im, env_im_params = jcommon.imitator_env(jcfg)
    replay = JaxReplayBuffer.create(capacity=dcfg.replay_buffer_size, seqlen=10, x_size=3,
                                    u_size=1)
    record.update(cost_data=cost_data, dyn_train=dyn_train, collect=[])

    def collect_fn(p, k):
        record["collect"].append(k)
        return jax_policy_rollout(env_im, env_im_params, jpolicy, p, jnorm, k,
                                  num_steps=dcfg.max_interactions_per_episode, history=1,
                                  num_envs=1, action_noise=dcfg.collection_noise)

    opts = {name: jax_masked_adam(params, c.no_grads, c.learning_rate)
            for name, c in (("cost", ccfg), ("dynamics", dcfg), ("critic", qcfg))}
    _, k_dyn, k_critic, k_cost = jax.random.split(key, 4)
    record["k_critic"] = k_critic
    params, _, replay, ep_returns, dyn_losses = jdyn.train_dynamics(
        jpolicy.dynamics_model, opts["dynamics"][0], params, opts["dynamics"][1], dyn_train,
        replay, collect_fn, jnorm, num_episodes=dcfg.num_episodes,
        num_updates=dcfg.num_updates, batch_size=dcfg.batch_size,
        discount_factor=dcfg.discount_factor,
        teacher_forcing_factor=dcfg.teacher_forcing_factor, key=k_dyn, epoch=1,
        warm_start_updates=dcfg.warm_start_updates, expert_updates=dcfg.expert_updates)
    params, _, critic_losses, critic_tests = jcritic.train_critic(
        jpolicy, opts["critic"][0], params, opts["critic"][1], cost_data[0], cost_data[1],
        num_updates=qcfg.num_updates, batch_size=qcfg.batch_size, key=k_critic,
        plan_batch=qcfg.plan_batch)
    params, _, gen_losses, gen_tests = jcost.train_cost(
        jpolicy, opts["cost"][0], params, opts["cost"][1], cost_data[0], cost_data[1],
        jax_gan_loss, num_updates=ccfg.num_updates, batch_size=ccfg.batch_size,
        polyak_factor=ccfg.polyak_factor, key=k_cost, has_targets=True,
        eval_windows=ccfg.eval_windows, max_steps_per_update=ccfg.steps_per_update)
    return {"episode_returns": ep_returns, "dynamics_train_losses": dyn_losses,
            "critic_train_losses": critic_losses, "critic_test_losses": critic_tests,
            "cost_train_losses": gen_losses, "cost_test_losses": gen_tests}


def test_gan_epoch_matches_jax(monkeypatch):
    jcfg, pcfg = gan9_configs(**EPOCH_CUTS)
    draws = {"dyn": [], "critic": [], "cost": []}
    for name, mod in (("dyn", jdyn), ("critic", jcritic), ("cost", jcost)):
        def recording(*args, _log=draws[name]):
            _log.append(np.array(jax_minibatch_indices(*args)))
            return jnp.asarray(_log[-1])
        monkeypatch.setattr(mod, "minibatch_indices", recording)
    record = {}
    ref = _jax_epoch(jcfg, jax.random.PRNGKey(2), record)

    ctx = common.setup(pcfg, True, STORE, "cpu")
    to_t = lambda arrs: tuple(torch.from_numpy(np.array(a)) for a in arrs)
    ctx["cost_data"] = tuple(to_t(part) for part in record["cost_data"])
    ctx["dyn_train"] = to_t(record["dyn_train"])
    # the collection: JAX's resets and noise for each recorded key
    env_im, env_im_params = ctx["env_im"], ctx["env_im_params"]
    steps = pcfg.mpc.train.dynamics.max_interactions_per_episode
    jenv, jenv_params = jcommon.imitator_env(jcfg)
    episodes = []
    for k in record["collect"]:
        k_reset, k_noise = jax.random.split(k)
        s = jax.vmap(lambda kk: jenv.reset(jenv_params, kk))(jax.random.split(k_reset, 1))
        z = np.stack([np.asarray(jax.random.normal(kk, (1, 1)))
                      for kk in jax.random.split(k_noise, steps)])
        episodes.append((EnvState(torch.tensor(np.asarray(s.qpos)),
                                  torch.tensor(np.asarray(s.qvel)),
                                  torch.zeros(1, dtype=torch.int32)), torch.from_numpy(z)))
    episode_iter = iter(episodes)

    def collect_fn(gen):
        init, z = next(episode_iter)
        return policy_rollout(env_im, env_im_params, ctx["policy"], ctx["normalizer"],
                              num_steps=steps, history=1, num_envs=1, init_state=init,
                              action_noise=0.2, noise=z)

    ctx["collect_fn"] = collect_fn
    # the critic's subset and shuffles from its key, as the JAX trainer draws them
    n_train = ctx["cost_data"][0][0].shape[0]
    _, k_train, k_test, k_sub = jax.random.split(record["k_critic"], 4)
    subset = np.array(jax.random.choice(k_sub, n_train, shape=(8,), replace=False))
    n_test = min(8, ctx["cost_data"][1][0].shape[0])
    perms = iter([np.array(jax.random.permutation(k_train, 16)),
                  np.array(jax.random.permutation(k_test, 2 * n_test))])
    replay = {name: iter(d) for name, d in draws.items()}
    for name, mod in (("dyn", tdyn), ("critic", tcritic), ("cost", tcost)):
        monkeypatch.setattr(mod, "minibatch_indices",
                            lambda gen, n, s, b, _it=replay[name]: torch.from_numpy(next(_it)))
    monkeypatch.setattr(tcritic, "subset_indices", lambda gen, n, k: torch.from_numpy(subset))
    monkeypatch.setattr(tcritic, "permutation", lambda gen, n: torch.from_numpy(next(perms)))

    # each phase's trainer, watched: which components it moved
    moved = {}
    for phase in ("train_dynamics", "train_critic", "train_cost"):
        def watched(*args, _phase=phase, _fn=getattr(gan, phase), **kwargs):
            comps = policy_components(ctx["policy"])
            before = {k: [p.detach().clone() for p in ps] for k, ps in comps.items()}
            out = _fn(*args, **kwargs)
            moved[_phase] = {k for k, ps in comps.items()
                             if any(not torch.equal(p, q) for p, q in zip(ps, before[k]))}
            return out
        monkeypatch.setattr(gan, phase, watched)

    opts = gan.phase_optimizers(ctx)
    got = gan.gan_epoch(ctx, opts, 1, torch.Generator())
    assert set(got) == set(ref)
    for name in ref:
        assert len(got[name]) == len(ref[name]), name
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, err_msg=name)
    assert len(got["dynamics_train_losses"]) == 3 and ctx["replay"].size == 2
    assert all(next(it, None) is None for it in replay.values())
    assert moved == {"train_dynamics": {"dynamics_params"}, "train_critic": {"critic_params"},
                     "train_cost": {"mpc_weights", "cost_params"}}
