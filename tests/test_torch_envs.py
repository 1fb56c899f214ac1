"""Port parity: the planar engine and cheetah-run against the JAX package.

The port writes the engine's Jacobians and bias forces out by hand
(``gan_mpc_tpu_torch/envs/planar.py``); the JAX engine takes them by
autodiff. Same (q, qd, u) from a numpy seed, float32 on the CPU. One
cheetah step (4 substeps, contacts) is held at atol 1e-4: the stiff
ground (kp 4000) amplifies rounding. The engine's pieces are held at
atol 1e-4 relative to their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.envs import apply_physics_shift as jax_shift
from gan_mpc_tpu.envs import base as jax_base
from gan_mpc_tpu.envs import planar as jax_planar
from gan_mpc_tpu.envs.cheetah import CheetahRun as JaxCheetah
from gan_mpc_tpu_torch.envs import EnvState, apply_physics_shift, make_env, tolerance
from gan_mpc_tpu_torch.envs import planar

torch.set_num_threads(1)

B = 16
SHIFTS = {"default": [], "torso_x3": [{"key": "body_mass_torso", "value": 3.0}]}


def _state(seed):
    """Near the rest pose, some feet in the ground, brisk velocities."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([[0.0, 0.6, 0.0], [0.9, -0.75, 0.35, 0.0, 0.0, 0.0]])
    q = (q + 0.1 * rng.standard_normal((B, 9))).astype(np.float32)
    qd = (1.0 * rng.standard_normal((B, 9))).astype(np.float32)
    u = rng.uniform(-1.2, 1.2, (B, 6)).astype(np.float32)  # clipping too
    return q, qd, u


def _envs(shift):
    jenv, env = JaxCheetah(), make_env("cheetah_run", "cpu")
    jp = jax_shift(jenv.default_params(), SHIFTS[shift])
    p = apply_physics_shift(env.default_params(), SHIFTS[shift])
    return jenv, jp, env, p


@pytest.mark.parametrize("shift", list(SHIFTS))
def test_cheetah_step_matches_jax(shift):
    jenv, jp, env, p = _envs(shift)
    q, qd, u = _state(0)
    jstate = jax_base.EnvState(qpos=jnp.asarray(q), qvel=jnp.asarray(qd),
                               t=jnp.zeros(B, jnp.int32))
    jnext, jrew = jax.vmap(lambda s, a: jenv.step(jp, s, a))(jstate, jnp.asarray(u))
    state = EnvState(torch.from_numpy(q), torch.from_numpy(qd),
                     torch.zeros(B, dtype=torch.int32))
    nxt, rew = env.step(p, state, torch.from_numpy(u))
    assert np.any(np.asarray(jax.vmap(
        lambda qq: jax_planar.contact_points(jenv._model(jp), qq)
    )(jnp.asarray(q)))[..., 1] < 0.0), "no contact exercised"
    np.testing.assert_allclose(nxt.qpos.numpy(), np.asarray(jnext.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(nxt.qvel.numpy(), np.asarray(jnext.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(nxt.t.numpy(), np.ones(B))
    np.testing.assert_array_equal(
        env.observe(p, nxt).numpy(),
        np.concatenate([nxt.qpos.numpy()[:, 1:], nxt.qvel.numpy()], -1),
    )


@pytest.mark.parametrize("shift", list(SHIFTS))
def test_engine_terms_match_jax_autodiff(shift):
    """Mass matrix, bias, contact and damping terms written out by hand
    against the JAX engine's jacfwd/jvp/grad versions."""
    jenv, jp, env, p = _envs(shift)
    jm, m = jenv._model(jp), env.model(p)
    q, qd, _ = _state(1)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    ref = {
        "mass": jax.vmap(lambda a: jax_planar.mass_matrix(jm, a))(jq),
        "bias": jax.vmap(lambda a, b: jax_planar.bias_forces(jm, a, b))(jq, jqd),
        "contact": jax.vmap(lambda a, b: jax_planar.contact_forces(jm, a, b))(jq, jqd),
        "damping": jax.vmap(lambda a: jax_planar._damping_matrix(jm, a))(jq),
        "joint": jax.vmap(lambda a, b: jax_planar.joint_forces(jm, a, b))(jq, jqd),
    }
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    angles, origins, coms = planar.forward_kinematics(m, tq)
    Jc = planar.point_jacobian(coms, m.ancestors, origins)
    pts = planar.contact_points(m, angles, origins)
    Jp = planar.point_jacobian(pts, m.contact_ancestors, origins)
    got = {
        "mass": planar.mass_matrix(m, Jc),
        "bias": planar.bias_forces(m, tq, tqd, angles, origins, coms, Jc),
        "contact": planar.contact_forces(m, tqd, pts, Jp),
        "damping": planar.damping_matrix(m, pts, Jp),
        "joint": planar.joint_forces(m, tq, tqd),
    }
    for name, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(
            got[name].numpy(), r, rtol=0, atol=1e-4 * max(1.0, np.abs(r).max()),
            err_msg=name,
        )


@pytest.mark.parametrize("sigmoid,kw", [
    ("linear", dict(lower=10.0, upper=float("inf"), margin=10.0, value_at_margin=0.0)),
    ("gaussian", dict(lower=-1.0, upper=1.0, margin=2.0, value_at_margin=0.1)),
    ("quadratic", dict(lower=0.0, upper=0.5, margin=1.0, value_at_margin=0.2)),
    ("gaussian", dict(lower=0.0, upper=1.0, margin=0.0)),
], ids=["linear", "gaussian", "quadratic", "no_margin"])
def test_tolerance_matches_jax(sigmoid, kw):
    x = np.linspace(-6.0, 25.0, 311).astype(np.float32)
    ref = jax_base.tolerance(jnp.asarray(x), sigmoid=sigmoid, **kw)
    got = tolerance(torch.from_numpy(x), sigmoid=sigmoid, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_reset_is_seeded_and_near_rest():
    env = make_env("cheetah_run", "cpu")
    a = env.reset(env.default_params(), 32, torch.Generator().manual_seed(3))
    b = env.reset(env.default_params(), 32, torch.Generator().manual_seed(3))
    assert a.qpos.shape == a.qvel.shape == (32, 9) and a.t.dtype == torch.int32
    np.testing.assert_array_equal(a.qpos.numpy(), b.qpos.numpy())
    rest = np.concatenate([[0.0, 0.64, 0.0], [0.9, -0.75, 0.35, 0.0, 0.0, 0.0]])
    assert np.abs(a.qpos.numpy() - rest).max() < 0.1
    assert np.abs(a.qvel.numpy()).max() < 0.1


def test_only_cheetah_is_ported():
    """An env the JAX package does not have raises; a physics field the
    env does not have raises."""
    with pytest.raises(ValueError, match="unknown environment 'acrobot_swingup'"):
        make_env("acrobot_swingup", "cpu")
    with pytest.raises(ValueError, match="no physics field"):
        apply_physics_shift(make_env("cheetah_run", "cpu").default_params(),
                            [{"key": "body_mass_pole", "value": 2.0}])
