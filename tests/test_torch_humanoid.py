"""Port parity: the planar humanoid (stand and walk) against the JAX package.

The same states, actions and physics knobs, drawn from a numpy seed, go
through ``gan_mpc_tpu/envs/humanoid.py`` (jitted, vmapped over the batch)
and ``gan_mpc_tpu_torch/envs/humanoid.py``, float32 on the CPU. The
ground is stiff (kp 20000, 4 substeps, 8 contact points, a 15 x 15 solve
per substep), so rounding grows once contacts switch:

  * the engine's terms (mass matrix, bias, contact, damping and hinge
    forces; the port writes the Jacobians out, JAX takes them by
    autodiff) within 1e-5 max(1, max|ref|), standing and fallen;
  * one step, from standing states (feet in the ground) and from fallen
    ones (lying on the pelvis, head and elbows), with random actions
    (some past the +-1 clip): qpos and reward within 1e-5 max(1,
    max|ref|) of the JAX step's, qvel within 1e-4 max(1, max|ref|): the
    velocity comes out of a 15 x 15 solve whose condition number is
    about 8e3 on these states, so f32 solves that pivot differently part
    by more than 1e-5 (3.5e-5 of max|qvel| when this was written);
  * 20-step rollouts of random actions in [-1, 1] from the same states:
    qpos and reward within 5e-3, qvel within 5e-2 max(1, max|ref|) at
    every step. A contact's normal damper (kd 500) switches on with the
    sign of its depth, so a rounding-sized difference in a heel's height
    can start a contact one step earlier in one engine and move a
    velocity by a few percent (1.3e-2 of max|qvel| from standing, 7.4e-4
    in qpos, 1.5e-4 in reward when this was written; fallen bodies,
    whose contacts stay closed, 1.8e-4 and 3.3e-5);
  * ``observe`` exactly and ``_head_height`` within 1e-6 (XLA may fuse
    the sums) on the same states;
  * ``HumanoidParams`` with every field shifted by ``apply_physics_shift``:
    the fields in JAX's leaf order, the engine's masses, inertias and hinge
    stiffnesses equal to JAX's (rtol 1e-6), and one step as above.
Resets draw from a ``torch.Generator`` where JAX splits a key, so they
are checked for their distribution, not against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.envs import apply_physics_shift as jax_shift
from gan_mpc_tpu.envs import base as jax_base
from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs import planar as jax_planar
from gan_mpc_tpu_torch.envs import EnvState, apply_physics_shift, make_env, planar
from gan_mpc_tpu_torch.envs.humanoid import HumanoidParams

torch.set_num_threads(1)

B = 16
NAMES = ["humanoid_stand", "humanoid_walk"]
POSES = ["standing", "fallen"]
SHIFTS = [{"key": "body_mass_torso", "value": 1.5}, {"key": "body_mass_pelvis", "value": 0.8},
          {"key": "jnt_stiffness_left_hip", "value": 2.0},
          {"key": "jnt_stiffness_right_hip", "value": 0.5},
          {"key": "geom_size_torso", "value": 1.2}]
_JAX_STEPS = {}


def _jax_step(name):
    """The JAX env's step, vmapped over the batch and jitted once per env."""
    if name not in _JAX_STEPS:
        env = jax_make_env(name)
        _JAX_STEPS[name] = jax.jit(jax.vmap(env.step, in_axes=(None, 0, 0)))
    return _JAX_STEPS[name]


def _states(seed, pose):
    """Standing: the reset pose with 0.02 noise, so that some heels and
    toes are in the ground. Fallen: lying on the back near the ground,
    pelvis, head or elbows in contact. Velocities N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 15))
    if pose == "standing":
        q[:, 1] = 1.05
        q += 0.02 * rng.standard_normal((B, 15))
    else:
        q[:, 1], q[:, 2] = 0.12, 1.5
        q += 0.1 * rng.standard_normal((B, 15))
    qd = 0.5 * rng.standard_normal((B, 15))
    return q.astype(np.float32), qd.astype(np.float32)


def _both(q, qd):
    jstate = jax_base.EnvState(qpos=jnp.asarray(q), qvel=jnp.asarray(qd),
                               t=jnp.zeros(B, jnp.int32))
    state = EnvState(torch.from_numpy(q), torch.from_numpy(qd),
                     torch.zeros(B, dtype=torch.int32))
    return jstate, state


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()), err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_env_api_and_shapes(name):
    env = make_env(name, "cpu")
    assert env.name == name and env.obs_size == 29 and env.act_size == 12
    params = env.default_params()
    state = env.reset(params, 3, torch.Generator().manual_seed(0))
    assert state.qpos.shape == state.qvel.shape == (3, 15) and state.t.dtype == torch.int32
    assert env.observe(params, state).shape == (3, env.obs_size)
    state2, reward = env.step(params, state, torch.zeros(3, env.act_size))
    assert torch.isfinite(reward).all() and bool(((0.0 <= reward) & (reward <= 1.0)).all())
    assert state2.t.tolist() == [1, 1, 1]


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_jax(name, pose):
    env = make_env(name, "cpu")
    q, qd = _states(0, pose)
    u = np.random.default_rng(1).uniform(-1.3, 1.3, (B, 12)).astype(np.float32)
    jstate, state = _both(q, qd)
    jp = jax_make_env(name).default_params()
    jnext, jrew = _jax_step(name)(jp, jstate, jnp.asarray(u))
    nxt, rew = env.step(env.default_params(), state, torch.from_numpy(u))
    pts = jax.vmap(lambda qq: jax_planar.contact_points(jax_make_env(name)._model(jp), qq))(
        jnp.asarray(q))
    assert np.any(np.asarray(pts)[..., 1] < 0.0), "no contact exercised"
    _close(nxt.qpos, jnext.qpos, 1e-5, "qpos")
    _close(nxt.qvel, jnext.qvel, 1e-4, "qvel")
    _close(rew, jrew, 1e-5, "reward")
    assert nxt.t.tolist() == [1] * B


@pytest.mark.parametrize("pose", POSES)
def test_engine_terms_match_jax_autodiff(pose):
    jenv, env = jax_make_env("humanoid_stand"), make_env("humanoid_stand", "cpu")
    jm, m = jenv._model(jenv.default_params()), env.model(env.default_params())
    q, qd = _states(7, pose)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    ref = jax.jit(jax.vmap(lambda a, b: {
        "mass": jax_planar.mass_matrix(jm, a),
        "bias": jax_planar.bias_forces(jm, a, b),
        "contact": jax_planar.contact_forces(jm, a, b),
        "damping": jax_planar._damping_matrix(jm, a),
        "joint": jax_planar.joint_forces(jm, a, b),
    }))(jq, jqd)
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    angles, origins, coms = planar.forward_kinematics(m, tq)
    Jc = planar.point_jacobian(coms, m.ancestors, origins)
    pts = planar.contact_points(m, angles, origins)
    Jp = planar.point_jacobian(pts, m.contact_ancestors, origins)
    assert bool((pts[..., 1] < 0.0).any()), "no contact exercised"
    got = {
        "mass": planar.mass_matrix(m, Jc),
        "bias": planar.bias_forces(m, tq, tqd, angles, origins, coms, Jc),
        "contact": planar.contact_forces(m, tqd, pts, Jp),
        "damping": planar.damping_matrix(m, pts, Jp),
        "joint": planar.joint_forces(m, tq, tqd),
    }
    for name, r in ref.items():
        _close(got[name], r, 1e-5, name)


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("name", NAMES)
def test_rollout_matches_jax(name, pose):
    env = make_env(name, "cpu")
    q, qd = _states(2, pose)
    us = np.random.default_rng(3).uniform(-1.0, 1.0, (20, B, 12)).astype(np.float32)
    jstate, state = _both(q, qd)
    jp, p = jax_make_env(name).default_params(), env.default_params()
    for t in range(20):
        jstate, jrew = _jax_step(name)(jp, jstate, jnp.asarray(us[t]))
        state, rew = env.step(p, state, torch.from_numpy(us[t]))
        np.testing.assert_allclose(state.qpos.numpy(), np.asarray(jstate.qpos), rtol=0,
                                   atol=5e-3, err_msg=f"qpos at step {t}")
        _close(state.qvel, jstate.qvel, 5e-2, f"qvel at step {t}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=5e-3,
                                   err_msg=f"reward at step {t}")


@pytest.mark.parametrize("pose", POSES)
def test_observe_and_head_height_match_jax(pose):
    jenv, env = jax_make_env("humanoid_stand"), make_env("humanoid_stand", "cpu")
    q, qd = _states(4, pose)
    jstate, state = _both(q, qd)
    ref = jax.vmap(lambda s: jenv.observe(jenv.default_params(), s))(jstate)
    np.testing.assert_array_equal(env.observe(env.default_params(), state).numpy(),
                                  np.asarray(ref))
    np.testing.assert_allclose(env._head_height(torch.from_numpy(q)).numpy(),
                               np.asarray(jax.vmap(jenv._head_height)(jnp.asarray(q))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_physics_shift_matches_jax(name):
    jenv, env = jax_make_env(name), make_env(name, "cpu")
    jp = jax_shift(jenv.default_params(), SHIFTS)
    p = apply_physics_shift(env.default_params(), SHIFTS)
    assert [f.name for f in dataclasses.fields(HumanoidParams)] == list(
        type(jp).__dataclass_fields__)
    np.testing.assert_allclose([getattr(p, k) for k in type(jp).__dataclass_fields__],
                               [float(v) for v in jax.tree_util.tree_leaves(jp)], rtol=1e-6)
    jm, m = jenv._model(jp), env.model(p)
    for field in ("mass", "inertia", "joint_stiffness"):
        np.testing.assert_allclose(getattr(m, field).numpy(), np.asarray(getattr(jm, field)),
                                   rtol=1e-6, atol=0, err_msg=field)
    assert (m.ground_kp, m.ground_kd) == (jm.ground_kp, jm.ground_kd) == (20000.0, 500.0)
    q, qd = _states(5, "standing")
    u = np.random.default_rng(6).uniform(-1.0, 1.0, (B, 12)).astype(np.float32)
    jstate, state = _both(q, qd)
    jnext, jrew = _jax_step(name)(jp, jstate, jnp.asarray(u))
    nxt, rew = env.step(p, state, torch.from_numpy(u))
    _close(nxt.qpos, jnext.qpos, 1e-5, "qpos")
    _close(nxt.qvel, jnext.qvel, 1e-4, "qvel")
    _close(rew, jrew, 1e-5, "reward")
    with pytest.raises(ValueError, match="no physics field"):
        apply_physics_shift(p, [{"key": "body_mass_thigh", "value": 2.0}])


def test_reset_is_seeded_and_near_standing():
    env = make_env("humanoid_walk", "cpu")
    a = env.reset(env.default_params(), 256, torch.Generator().manual_seed(3))
    b = env.reset(env.default_params(), 256, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.qpos.numpy(), b.qpos.numpy())
    np.testing.assert_array_equal(a.qvel.numpy(), b.qvel.numpy())
    rest = np.zeros(15)
    rest[1] = 1.05
    for noise in (a.qpos.numpy() - rest, a.qvel.numpy()):
        assert abs(noise.mean()) < 1e-3 and abs(noise.std() - 0.005) < 2e-4


@pytest.mark.parametrize("name", NAMES)
def test_make_env_defaults_to_the_card(name):
    """Without a device the env runs on the card; on a host without one
    it raises rather than running quietly on the CPU."""
    if torch.cuda.is_available():
        env = make_env(name)
        assert env.model(env.default_params()).mass.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_env(name)
