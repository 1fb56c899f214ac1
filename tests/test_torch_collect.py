"""The port's scripted experts and expert collection against the JAX package.

Here the pendulum and the cheetah; ``test_torch_collect_humanoid.py`` runs
the same tests on humanoid_stand and humanoid_walk, and
``test_torch_walker_cartpole.py`` on walker_walk and cartpole_balance.

  * each expert's action equals JAX's on the same observations, taken from a short
    JAX collection: atol 1e-5. The observations used sit clear of the
    experts' switches: for the phase-matched gaits the best and the
    second-best grid errors differ by 1e-4 or more (an argmin near-tie
    flips on float32 rounding, in the manner of ``clear_of_kinks``), for
    the pendulum the pole is 1e-4 or more from the stabilizer's |th| = 0.5
    and the pump's sign switch;
  * a 30-step collection of 6 envs per expert equals JAX's, fed the reset
    states and noise that JAX's ``collect_expert_trajectories`` draws from
    its key (recomputed here): per quantity and step, atol = max(base,
    2 x JAX's own spread), the spread the largest move of JAX's own
    collection over the compared envs when its resets are scaled by
    1 +- 1e-7 and 1 +- 2e-7 (base 1e-4, rewards 1e-5). The cheetah's ground contact carries rounding
    into its states at 1e-4 (JAX's own spread is as large). The humanoid's
    stiff ground makes its rollouts chaotic in JAX itself: nudges of 1e-7
    move its states by several units within 10 steps, after which JAX does
    not reproduce itself, so an env is compared at the steps where JAX's
    own spread of its states stays under 0.1 (every step for the pendulum
    and the cheetah, at least the first 5 for the humanoid);
  * the fingerprint's expert version reads ``GMT_CHEETAH_EXPERT`` where
    it is asked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.runners import collect as jcollect
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.runners import collect

torch.set_num_threads(1)

ENVS = ["pendulum_swingup", "cheetah_run"]
# (noise, reset velocity) of the collection per env: the configs' values
KNOBS = {"pendulum_swingup": (0.25, 0.5), "humanoid_stand": (0.1, 0.0),
         "humanoid_walk": (0.1, 0.0), "cheetah_run": (0.25, 0.0), "walker_walk": (0.1, 0.0),
         "cartpole_balance": (0.25, 0.0)}
N, T = 6, 30
NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)
REPRODUCIBLE = 0.1  # JAX's own spread of an env's states under which it is compared
BASE_ATOL = {"states": 1e-4, "actions": 1e-4, "executed_actions": 1e-4, "rewards": 1e-5}


def jax_draws(jenv, num, key, steps, reset_velocity):
    """The resets (reset velocity included) and the standard normal noise
    (steps, num, act) that JAX's ``collect_expert_trajectories`` draws
    from ``key``."""
    params = jenv.default_params()

    def one(k):
        k_reset, k_vel, k_noise = jax.random.split(k, 3)
        s0 = jenv.reset(params, k_reset)
        qvel = s0.qvel
        if reset_velocity > 0.0:
            qvel = qvel + reset_velocity * jax.random.normal(k_vel, qvel.shape)
        noise = jax.vmap(lambda kk: jax.random.normal(kk, (jenv.act_size,)))(
            jax.random.split(k_noise, steps))
        return s0.qpos, qvel, noise

    qpos, qvel, noise = (np.asarray(a) for a in jax.vmap(one)(jax.random.split(key, num)))
    init = EnvState(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
                    t=torch.zeros(num, dtype=torch.int32))
    return init, torch.tensor(noise).transpose(0, 1)


class _NudgedResets:
    """The JAX env with every reset state scaled by ``scale``."""

    def __init__(self, env, scale):
        self._env, self._scale = env, scale

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, params, key):
        s = self._env.reset(params, key)
        return s.replace(qpos=s.qpos * self._scale, qvel=s.qvel * self._scale)


def jax_collect(jenv, key, steps=T):
    noise, reset_velocity = KNOBS[jenv.name]
    return jcollect.collect_expert_trajectories(jenv, N, key, num_steps=steps,
                                                noise_sigma=noise,
                                                reset_velocity_sigma=reset_velocity)


def _gap(err: np.ndarray) -> np.ndarray:
    """Second-best minus best along the last axis."""
    s = np.sort(err, axis=-1)
    return s[..., 1] - s[..., 0]


def clear_of_switches(name, env, obs: np.ndarray, margin=1e-4) -> np.ndarray:
    """Rows of ``obs`` whose expert action sits clear of a discrete switch."""
    o = obs.astype(np.float64)
    if name == "pendulum_swingup":
        th = np.arctan2(o[:, 1], o[:, 0])
        return (np.abs(np.abs(th) - 0.5) > margin) & (np.abs(o[:, 2] + 0.3 * o[:, 1]) > margin)
    if name in ("humanoid_stand", "cartpole_balance"):
        return np.ones(len(o), bool)
    if name == "humanoid_walk":
        w = collect._f32(collect._HUMANOID_WALK_PHASE, "cpu")
        _, qts, qdts = collect.phase_grid(collect._walk_pd_targets, w)
        joints, jointsd, lam = o[:, 2:14], o[:, 17:29], abs(float(w[14]))
    elif name == "walker_walk":
        w = collect._f32(collect._WALKER_WALK_PHASE, "cpu")
        _, qts, qdts = collect.phase_grid(collect._walker_targets, w)
        joints, jointsd, lam = o[:, 2:8], o[:, 11:17], abs(float(w[13]))
    else:
        w = collect._f32(collect.cheetah_pd_weights(), "cpu")
        _, qts, qdts = collect.phase_grid(collect._cheetah_targets, w)
        joints, jointsd, lam = o[:, 2:8], o[:, 11:17], abs(float(w[26]))
    qts, qdts = qts.double().numpy(), qdts.double().numpy()
    err = ((qts - joints[:, None]) ** 2).sum(-1) + lam * ((qdts - jointsd[:, None]) ** 2).sum(-1)
    return _gap(err) > margin * (1.0 + err.min(-1))


def collections_of(name):
    """(name, JAX's collection, JAX's nudged collections, the port's on
    JAX's draws) for one env."""
    jenv, env = jax_make_env(name), make_env(name, "cpu")
    key = jax.random.PRNGKey(3)
    ref = jax_collect(jenv, key)
    nudged = [jax_collect(_NudgedResets(jenv, s), key) for s in NUDGES]
    init, noise = jax_draws(jenv, N, key, T, KNOBS[name][1])
    got = collect.collect_expert_trajectories(env, N, num_steps=T, noise_sigma=KNOBS[name][0],
                                              init_state=init, noise=noise)
    return name, ref, nudged, got


@pytest.fixture(scope="module", params=ENVS)
def collections(request):
    return collections_of(request.param)


def test_expert_action_matches_jax(collections):
    name, ref, _, _ = collections
    jenv, env = jax_make_env(name), make_env(name, "cpu")
    obs = ref.states.reshape(-1, jenv.obs_size)
    obs = obs[clear_of_switches(name, env, obs)]
    assert len(obs) >= N * T // 2
    jpolicy = jcollect.scripted_expert(jenv)
    want = np.asarray(jax.jit(jax.vmap(lambda o: jpolicy(None, o[None], None)))(jnp.asarray(obs)))
    got = collect.scripted_expert(env)(torch.tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _spread(ref, nudged, field):
    """JAX's own spread per env and step (N, T): the largest move of any
    entry over the nudged collections."""
    want = getattr(ref, field)
    moves = np.max([np.abs(getattr(n, field) - want) for n in nudged], axis=0)
    return moves.reshape(N, T, -1).max(-1)


def test_collection_matches_jax(collections):
    name, ref, nudged, got = collections
    compared = _spread(ref, nudged, "states") < REPRODUCIBLE
    assert compared[:, :5].all()
    if name in ("pendulum_swingup", "cheetah_run"):
        assert compared.all()
    for field, base in BASE_ATOL.items():
        want, have = getattr(ref, field), getattr(got, field)
        assert have.shape == want.shape
        spread = np.where(compared, _spread(ref, nudged, field), 0.0).max(0)
        atol = np.broadcast_to(np.maximum(base, 2.0 * spread), compared.shape)
        dev = np.abs(have - want).reshape(N, T, -1).max(-1)
        bad = np.argwhere(compared & (dev > atol))
        assert not len(bad), (f"{name} {field}: (env, step) {bad[:5].tolist()} off by "
                              f"{dev[compared & (dev > atol)][:5]} > {atol[compared & (dev > atol)][:5]}")


@pytest.mark.parametrize("variant", ["nominal", "shift3"])
def test_expert_version_matches_jax(monkeypatch, variant):
    monkeypatch.setenv("GMT_CHEETAH_EXPERT", variant)
    want = 2 if variant == "nominal" else "2-shift3"
    assert collect.expert_version("cheetah_run") == want
    assert collect.cheetah_pd_weights() == tuple(
        jcollect._CHEETAH_PD_W_NOMINAL if variant == "nominal" else jcollect._CHEETAH_PD_W_SHIFT3)
    for name in ("pendulum_swingup", "humanoid_walk", "humanoid_stand", "walker_walk",
                 "cartpole_balance"):
        assert collect.expert_version(name) == jcollect.EXPERT_VERSION.get(name, 1)
