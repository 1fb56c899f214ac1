"""The humanoid's scripted experts and their collection against the JAX
package: the tests of ``test_torch_collect.py`` (their tolerances stated
there) on humanoid_stand (the balance controller) and humanoid_walk (the
state-indexed gait over it), and the balance controller's centre-of-mass
offset and its rate (``jax.jvp`` against ``torch.func.jvp``), atol 1e-5 of
the largest, and the time-indexed walking gait (expert v2), atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs.planar import contact_points as jax_contact_points
from gan_mpc_tpu.envs.planar import forward_kinematics as jax_forward_kinematics
from gan_mpc_tpu.runners import collect as jcollect
from gan_mpc_tpu_torch.envs import make_env
from gan_mpc_tpu_torch.runners import collect
from test_torch_collect import (  # noqa: F401  (the tests, run here on the humanoid)
    collections_of,
    jax_collect,
    test_collection_matches_jax,
    test_expert_action_matches_jax,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["humanoid_stand", "humanoid_walk"])
def collections(request):
    return collections_of(request.param)


def test_humanoid_com_offset_jvp_matches_jax():
    jenv, env = jax_make_env("humanoid_stand"), make_env("humanoid_stand", "cpu")
    obs = jax_collect(jenv, jax.random.PRNGKey(5), steps=8).states.reshape(-1, 29)
    jmodel = jenv._model(jenv.default_params())

    def com_minus_feet(q):
        _, _, coms = jax_forward_kinematics(jmodel, q)
        com_x = jnp.sum(jmodel.mass * coms[:, 0]) / jnp.sum(jmodel.mass)
        return com_x - jnp.mean(jax_contact_points(jmodel, q)[:4, 0])

    def jvp(o):
        q = jnp.concatenate([jnp.zeros(1, o.dtype), o[:14]])
        return jax.jvp(com_minus_feet, (q,), (o[14:29],))

    want = [np.asarray(a) for a in jax.jit(jax.vmap(jvp))(jnp.asarray(obs))]
    got = [a.numpy() for a in collect.com_offset(torch.tensor(obs), env)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_time_indexed_walk_action_matches_jax():
    """The time-indexed walking gait (expert v2) on the observations of a
    short humanoid_walk collection, each at its own step: atol 1e-5."""
    jenv, env = jax_make_env("humanoid_walk"), make_env("humanoid_walk", "cpu")
    states = jax_collect(jenv, jax.random.PRNGKey(5), steps=8).states
    obs = states.reshape(-1, 29)
    t = np.tile(np.arange(states.shape[1], dtype=np.int32), states.shape[0])
    want = np.asarray(jax.jit(jax.vmap(
        lambda o, k: jcollect.humanoid_walk_action(o, k, jenv.dt, jenv)))(
            jnp.asarray(obs), jnp.asarray(t)))
    got = collect.humanoid_walk_action(torch.tensor(obs), torch.tensor(t), env.dt, env).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
