"""Port parity: walker_walk and cartpole_balance, their scripted experts and
their collectors, against the JAX package.

The same states, actions and physics knobs (numpy draws from a seed, or
JAX's own resets) go through ``gan_mpc_tpu/envs/{walker,cartpole}.py``
(jitted, vmapped over the batch) and the port's envs, float32 on the CPU:

  * cartpole (smooth, no contact; RK4 with a 2 x 2 solve per stage): 100
    steps of random actions (some past the +-1 clip) from JAX's resets,
    qpos, qvel and reward within 1e-5 max(1, max|ref|) at every step
    (2e-7 relative when this was written);
  * walker, in the air (no contact switches on for 20 steps: every
    contact point stays 0.2 or more above the ground): qpos within 1e-5,
    qvel within 1e-5 max(1, max|ref|), reward 1e-5 at every step (over 30
    steps 1.1e-6, 3.3e-5 of max|qvel| ~ 20 and 1.2e-6 when this was
    written; JAX's own spread under 1e-7 reset nudges is as large in qvel);
  * walker standing on its reset pose (heels and toes in the ground), one
    step: qpos and reward within 1e-5, qvel within 1e-4 max(1, max|ref|),
    the humanoid's tolerance for the velocity solve through the contacts;
  * ``observe`` exactly; ``apply_physics_shift`` with ``body_mass_cart`` and
    ``body_mass_torso``: the fields in JAX's leaf order, the shifted engine
    equal to JAX's (rtol 1e-6) and one step as above;
  * (``test_torch_collect_walker_cartpole.py``) the scripted experts and
    ``collect_expert_trajectories`` fed JAX's resets and noise: the tests
    and tolerances of ``test_torch_collect.py``;
  * ``collect_dagger_trajectories``: both packages' collectors restart the
    expert from the states of one recorded policy episode (the states of a
    short JAX expert collection in place of an imitator's rollout, so that
    the segments start mid-gait), JAX's picks (uniform and reward-weighted)
    and noise replayed into the port: the segments within the collection
    test's base tolerances, 1e-4 (rewards 1e-5), over their 8 steps.
Resets draw from a ``torch.Generator`` where JAX splits a key, so they are
checked for their distribution.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.envs import apply_physics_shift as jax_shift
from gan_mpc_tpu.envs import base as jax_base
from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs import rollout as jax_rollout
from gan_mpc_tpu.runners import collect as jcollect
from gan_mpc_tpu_torch.envs import EnvState, apply_physics_shift, make_env
from gan_mpc_tpu_torch.envs.cartpole import CartpoleParams
from gan_mpc_tpu_torch.envs.planar import contact_points, forward_kinematics
from gan_mpc_tpu_torch.envs.walker import WalkerParams
from gan_mpc_tpu_torch.runners import collect
from test_torch_collect import BASE_ATOL

torch.set_num_threads(1)

B = 16
NAMES = ["walker_walk", "cartpole_balance"]
SIZES = {"walker_walk": (17, 6, 9), "cartpole_balance": (5, 1, 2)}  # obs, act, nq
SHIFT = {"walker_walk": [{"key": "body_mass_torso", "value": 1.5}],
         "cartpole_balance": [{"key": "body_mass_cart", "value": 1.3}]}
PARAMS = {"walker_walk": WalkerParams, "cartpole_balance": CartpoleParams}
_JAX_STEPS = {}


def _jax_step(name):
    """The JAX env's step, vmapped over the batch and jitted once per env."""
    if name not in _JAX_STEPS:
        env = jax_make_env(name)
        _JAX_STEPS[name] = jax.jit(jax.vmap(env.step, in_axes=(None, 0, 0)))
    return _JAX_STEPS[name]


def _jax_resets(name, seed):
    jenv = jax_make_env(name)
    s = jax.vmap(jenv.reset, in_axes=(None, 0))(jenv.default_params(),
                                                jax.random.split(jax.random.PRNGKey(seed), B))
    return np.asarray(s.qpos), np.asarray(s.qvel)


def _airborne(seed):
    """The walker with its hip at z 2 (every contact point 0.2 or more
    above the ground), pose noise 0.1, velocities N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 9))
    q[:, 1] = 2.0
    q += 0.1 * rng.standard_normal((B, 9))
    return q.astype(np.float32), (0.5 * rng.standard_normal((B, 9))).astype(np.float32)


def _both(q, qd):
    n = q.shape[0]
    jstate = jax_base.EnvState(qpos=jnp.asarray(q), qvel=jnp.asarray(qd),
                               t=jnp.zeros(n, jnp.int32))
    state = EnvState(torch.from_numpy(q), torch.from_numpy(qd), torch.zeros(n, dtype=torch.int32))
    return jstate, state


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()), err_msg=what)


def _rollout(name, q, qd, us, tol, jparams=None, params=None, check=None):
    """Step both packages through ``us`` (T, B, act) from (q, qd), holding
    qpos, qvel and reward to ``tol`` (rel) at every step."""
    env = make_env(name, "cpu")
    jp = jparams if jparams is not None else jax_make_env(name).default_params()
    p = params if params is not None else env.default_params()
    jstate, state = _both(q, qd)
    for t, u in enumerate(us):
        jstate, jrew = _jax_step(name)(jp, jstate, jnp.asarray(u))
        state, rew = env.step(p, state, torch.from_numpy(u))
        for what, got, ref in (("qpos", state.qpos, jstate.qpos), ("qvel", state.qvel, jstate.qvel),
                               ("reward", rew, jrew)):
            _close(got, ref, tol[what], f"{what} at step {t}")
        if check is not None:
            check(env, p, state)
    return env, jstate, state


@pytest.mark.parametrize("name", NAMES)
def test_env_api_and_shapes(name):
    obs, act, nq = SIZES[name]
    env = make_env(name, "cpu")
    assert env.name == name and (env.obs_size, env.act_size) == (obs, act)
    assert (env.dt, env.episode_steps) == (0.01, 1000)
    params = env.default_params()
    state = env.reset(params, 3, torch.Generator().manual_seed(0))
    assert state.qpos.shape == state.qvel.shape == (3, nq) and state.t.dtype == torch.int32
    assert env.observe(params, state).shape == (3, obs)
    state2, reward = env.step(params, state, torch.zeros(3, act))
    assert torch.isfinite(reward).all() and bool(((0.0 <= reward) & (reward <= 1.0)).all())
    assert state2.t.tolist() == [1, 1, 1]


def test_cartpole_rollout_matches_jax():
    q, qd = _jax_resets("cartpole_balance", 0)
    us = np.random.default_rng(1).uniform(-1.2, 1.2, (100, B, 1)).astype(np.float32)
    tol = {"qpos": 1e-5, "qvel": 1e-5, "reward": 1e-5}
    _, jstate, _ = _rollout("cartpole_balance", q, qd, us, tol)
    assert np.abs(np.asarray(jstate.qpos)[:, 1]).max() > 0.5  # the poles swing well away


def test_walker_airborne_rollout_matches_jax():
    def in_the_air(env, p, state):
        model = env.model(p)
        angles, origins, _ = forward_kinematics(model, state.qpos)
        assert contact_points(model, angles, origins)[..., 1].min() > 0.2

    q, qd = _airborne(0)
    us = np.random.default_rng(1).uniform(-1.0, 1.0, (20, B, 6)).astype(np.float32)
    tol = {"qpos": 1e-5, "qvel": 1e-5, "reward": 1e-5}
    _rollout("walker_walk", q, qd, us, tol, check=in_the_air)


def test_walker_step_in_contact_matches_jax():
    q, qd = _jax_resets("walker_walk", 2)
    env = make_env("walker_walk", "cpu")
    model = env.model(env.default_params())
    angles, origins, _ = forward_kinematics(model, torch.from_numpy(q))
    assert (contact_points(model, angles, origins)[:, :4, 1] < 0).any(-1).all()
    us = np.random.default_rng(3).uniform(-1.3, 1.3, (1, B, 6)).astype(np.float32)
    _rollout("walker_walk", q, qd, us, {"qpos": 1e-5, "qvel": 1e-4, "reward": 1e-5})


@pytest.mark.parametrize("name", NAMES)
def test_observe_matches_jax(name):
    jenv, env = jax_make_env(name), make_env(name, "cpu")
    q, qd = _jax_resets(name, 4)
    qd = qd + np.random.default_rng(4).standard_normal(qd.shape).astype(np.float32)
    jstate, state = _both(q, qd)
    ref = jax.vmap(lambda s: jenv.observe(jenv.default_params(), s))(jstate)
    np.testing.assert_array_equal(env.observe(env.default_params(), state).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("name", NAMES)
def test_physics_shift_matches_jax(name):
    jenv, env = jax_make_env(name), make_env(name, "cpu")
    jp = jax_shift(jenv.default_params(), SHIFT[name])
    p = apply_physics_shift(env.default_params(), SHIFT[name])
    assert [f.name for f in dataclasses.fields(PARAMS[name])] == list(
        type(jp).__dataclass_fields__)
    np.testing.assert_allclose([getattr(p, k) for k in type(jp).__dataclass_fields__],
                               [float(v) for v in jax.tree_util.tree_leaves(jp)], rtol=1e-6)
    if name == "walker_walk":
        jm, m = jenv._model(jp), env.model(p)
        for field in ("mass", "inertia", "joint_stiffness"):
            np.testing.assert_allclose(getattr(m, field).numpy(), np.asarray(getattr(jm, field)),
                                       rtol=1e-6, atol=0, err_msg=field)
        q, qd = _airborne(5)
        tol = {"qpos": 1e-5, "qvel": 1e-5, "reward": 1e-5}
    else:
        q, qd = _jax_resets(name, 5)
        tol = {"qpos": 1e-5, "qvel": 1e-5, "reward": 1e-5}
    us = np.random.default_rng(6).uniform(-1.0, 1.0, (1, B, env.act_size)).astype(np.float32)
    _rollout(name, q, qd, us, tol, jparams=jp, params=p)
    with pytest.raises(ValueError, match="no physics field"):
        apply_physics_shift(p, [{"key": "body_mass_thigh", "value": 2.0}])


def test_resets_are_seeded_and_follow_the_reference_distribution():
    walker = make_env("walker_walk", "cpu")
    a = walker.reset(walker.default_params(), 512, torch.Generator().manual_seed(3))
    b = walker.reset(walker.default_params(), 512, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.qpos.numpy(), b.qpos.numpy())
    rest = np.zeros(9)
    rest[1] = 1.13
    for noise in (a.qpos.numpy() - rest, a.qvel.numpy()):
        assert abs(noise.mean()) < 1e-3 and abs(noise.std() - 0.005) < 2e-4
    cart = make_env("cartpole_balance", "cpu")
    s = cart.reset(cart.default_params(), 4096, torch.Generator().manual_seed(3))
    x, th = s.qpos[:, 0].numpy(), s.qpos[:, 1].numpy()
    assert -0.1 <= x.min() and x.max() < 0.1 and -0.034 <= th.min() and th.max() < 0.034
    assert abs(x.std() - 0.2 / 12 ** 0.5) < 2e-3 and abs(th.std() - 0.068 / 12 ** 0.5) < 1e-3
    assert abs(s.qvel.numpy().std() - 0.01) < 5e-4


@pytest.mark.parametrize("name", NAMES)
def test_make_env_defaults_to_the_card(name):
    """Without a device the env runs on the card; on a host without one
    it raises rather than running quietly on the CPU."""
    if torch.cuda.is_available():
        assert make_env(name).reset(make_env(name).default_params(), 1,
                                    torch.Generator()).qpos.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_env(name)


SEG_STEPS, SEGMENTS = 8, 6


class _Recorded:
    """Wraps ``module.name`` to keep what each call returns."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []
        self.original = getattr(module, name)

    def __enter__(self):
        def wrapped(*args, **kwargs):
            self.calls.append(self.original(*args, **kwargs))
            return self.calls[-1]
        setattr(self.module, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


@pytest.fixture(scope="module", params=NAMES)
def policy_episode(request):
    """(name, the "policy episode" both collectors restart from): 3
    episodes of 8 states of JAX's own expert collection, its qpos and
    qvel, and rewards scaled down along the episode so that the reward
    weighting matters."""
    name = request.param
    jenv = jax_make_env(name)
    s0 = jax.vmap(jenv.reset, in_axes=(None, 0))(jenv.default_params(),
                                                 jax.random.split(jax.random.PRNGKey(11), 3))
    expert = jcollect.scripted_expert(jenv)

    def one_step(s, _):
        obs = jax.vmap(lambda st: jenv.observe(jenv.default_params(), st))(s)
        u = jax.vmap(lambda o: expert(None, o[None], None))(obs)
        s2, r = jax.vmap(jenv.step, in_axes=(None, 0, 0))(jenv.default_params(), s, u)
        return s2, (s2.qpos, s2.qvel, r)

    _, (qpos, qvel, rew) = jax.lax.scan(one_step, s0, None, length=8)
    return name, dict(qpos=np.asarray(qpos).transpose(1, 0, 2),
                      qvel=np.asarray(qvel).transpose(1, 0, 2),
                      rewards=np.asarray(rew).T * np.linspace(0.2, 1.0, 8, dtype=np.float32))


@pytest.mark.parametrize("weighting", ["uniform", "reward_weighted"])
def test_dagger_collector_matches_jax(policy_episode, weighting, monkeypatch):
    name, kept = policy_episode
    jenv, env = jax_make_env(name), make_env(name, "cpu")
    noise_sigma = 0.1
    episode = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in kept.items()})
    monkeypatch.setattr(jax_rollout, "policy_rollout", lambda *a, **k: episode)
    kw = dict(num_segments=SEGMENTS, segment_steps=SEG_STEPS, policy_steps=8, policy_episodes=3,
              noise_sigma=noise_sigma, history=1, state_weighting=weighting)
    with _Recorded(jax.random, "choice") as picks:
        want = jcollect.collect_dagger_trajectories(jenv, jenv.default_params(), None, None, None,
                                                    jax.random.PRNGKey(7), **kw)
    _, _, k_noise = jax.random.split(jax.random.PRNGKey(7), 3)
    noise = np.stack([np.stack([np.asarray(jax.random.normal(kk, (jenv.act_size,)))
                                for kk in jax.random.split(k, SEG_STEPS)])
                      for k in jax.random.split(k_noise, SEGMENTS)], axis=1)

    port_episode = types.SimpleNamespace(**{k: torch.tensor(v) for k, v in kept.items()})
    monkeypatch.setattr(collect, "policy_rollout", lambda *a, **k: port_episode)
    got = collect.collect_dagger_trajectories(
        env, env.default_params(), None, None, picked=torch.tensor(np.asarray(picks[0])).long(),
        noise=torch.tensor(noise), **kw)
    starts = kept["qpos"].reshape(-1, kept["qpos"].shape[-1])[np.asarray(picks[0])]
    np.testing.assert_allclose(got.states[:, 0], np.asarray(
        jax.vmap(lambda q, qd: jenv.observe(jenv.default_params(), jax_base.EnvState(
            qpos=q, qvel=qd, t=jnp.int32(0))))(jnp.asarray(starts), jnp.asarray(
                kept["qvel"].reshape(-1, kept["qvel"].shape[-1])[np.asarray(picks[0])]))),
        rtol=0, atol=1e-6)
    for field, atol in BASE_ATOL.items():
        have, ref = getattr(got, field), getattr(want, field)
        assert have.shape == ref.shape == (SEGMENTS, SEG_STEPS) + ref.shape[2:], field
        np.testing.assert_allclose(have, ref, rtol=0, atol=atol, err_msg=field)
