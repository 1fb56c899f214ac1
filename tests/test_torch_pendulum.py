"""Port parity: loading the committed pendulum_swingup run gan/9.

The env step and reward against ``gan_mpc_tpu.envs.pendulum`` on the same
(q, qd, u), with and without a physics shift (atol 1e-6: float32 both
ways); ``load_trajectories`` of both packages on the committed ``.gmts``
store (with its ``.exec.npz`` sidecar) and on the ``.npz`` (equal
arrays); the normalizer fitted on the store (atol 1e-6); ``load_run_config``
of gan/9 (``to_dict`` equal); ``solver_settings`` reading every knob, and
agreeing with the JAX one where that one reads a knob; gan/9's every
component loaded into the port's policy, equal to flax's restore; the
prefix splice of a longer MPC weight vector; ``setup`` without a run to
continue, which reads the saved expert.

Neither package collects here: both read the committed store (the JAX
``ensure_trajectories`` would collect under ``runs/``, because gan/9's
collection fingerprint names no committed store). The helpers at the top
build gan/9 in both packages for ``test_torch_critic.py`` and
``test_torch_gan.py``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gan_mpc_tpu.data.trajectories import load_trajectories as jax_load_trajectories
from gan_mpc_tpu.envs import apply_physics_shift as jax_apply_physics_shift
from gan_mpc_tpu.envs.base import EnvState as JaxEnvState
from gan_mpc_tpu.envs.pendulum import PendulumSwingup as JaxPendulum
from gan_mpc_tpu.policies import MPCPolicy as JaxMPCPolicy
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data.trajectories import load_trajectories, read_gmts
from gan_mpc_tpu_torch.envs import EnvState, apply_physics_shift, make_env
from gan_mpc_tpu_torch.params import load_msgpack
from gan_mpc_tpu_torch.runners import common
from gan_mpc_tpu_torch.training.masking import policy_components

import jax_native_store

torch.set_num_threads(1)
pin_fp32()

# the JAX loaders read the committed .gmts through its native library
jax_native_store.ensure()

REPO = Path(__file__).resolve().parent.parent
G9 = "runs/trained_models/imitator/pendulum_swingup/gan/9"
STORE = "runs/expert_trajectories/pendulum_swingup/trajectories-f690b23776.gmts"
NPZ = "runs/expert_trajectories/pendulum_swingup/trajectories.npz"


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    # the run's paths (init_from_run, stores) are relative to the repo
    monkeypatch.chdir(REPO)


# -- gan/9 in both packages (shared by the critic and GAN tests) -------------


def gan9_configs(**overrides):
    """(JAX config, port config) of gan/9 continued from its own params,
    with the same dotted-path overrides (``mpc__horizon=3``)."""
    overrides = {"mpc__train__init_from_run": G9, **overrides}
    return (jcommon.load_run_config(str(REPO / G9)).replace(**overrides),
            common.load_run_config(str(REPO / G9)).replace(**overrides))


def jax_gan9(jcfg):
    """(policy, params) of gan/9 in the JAX package: the policy that
    ``build_policy`` makes with a critic, and every component as flax
    restores it from ``params.msgpack`` (``build_policy``'s own random
    init, which the restore replaces, is left out: it costs seconds)."""
    H = jcfg.mpc.horizon
    policy = JaxMPCPolicy(
        cost_model=jcommon.build_cost_model(jcfg, H),
        dynamics_model=jcommon.build_dynamics_model(jcfg, 3),
        expert_model=jcommon.build_expert_model(jcfg, 3, 1),
        critic_model=jcommon.build_critic_model(jcfg), horizon=H,
        settings=jcommon.solver_settings(jcfg),
        bilevel_solver=jcfg.get_path("mpc.solver.bilevel", "dense"))
    with open(REPO / G9 / "params.msgpack", "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    return policy, jax.tree_util.tree_map(jnp.asarray, raw)


def port_gan9(pcfg):
    """gan/9's policy in the port, on the CPU, loaded as ``setup`` does."""
    policy = common.build_policy(pcfg, 3, 1, with_critic=True, device="cpu")
    return common.load_saved_params(policy, G9)


def trajectories(num, length):
    """The committed store through both loaders: (JAX set, port set)."""
    return (jax_load_trajectories(STORE, num, length, 500.0),
            load_trajectories(STORE, num, length, 500.0))


# -- the env ------------------------------------------------------------------


@pytest.mark.parametrize("shift", [[], [{"key": "body_mass_pole", "value": 1.3},
                                        {"key": "geom_size_pole", "value": 0.9}]],
                         ids=["default", "shifted"])
def test_pendulum_step_matches_jax(shift):
    rng = np.random.default_rng(4)
    B = 64
    q = rng.uniform(-np.pi, np.pi, (B, 1)).astype(np.float32)
    qd = (3.0 * rng.standard_normal((B, 1))).astype(np.float32)
    u = (1.5 * rng.standard_normal((B, 1))).astype(np.float32)  # some clipped
    jenv = JaxPendulum()
    jparams = jax_apply_physics_shift(jenv.default_params(), shift) if shift else \
        jenv.default_params()
    env = make_env("pendulum_swingup", "cpu")
    params = apply_physics_shift(env.default_params(), shift) if shift else env.default_params()
    jstate = JaxEnvState(qpos=jnp.asarray(q), qvel=jnp.asarray(qd), t=jnp.zeros(B, jnp.int32))
    state = EnvState(torch.from_numpy(q), torch.from_numpy(qd), torch.zeros(B, dtype=torch.int32))
    # several steps, so that the state after each one is compared
    for _ in range(5):
        jobs = jax.vmap(lambda s: jenv.observe(jparams, s))(jstate)
        jstate, jrew = jax.vmap(lambda s, a: jenv.step(jparams, s, a))(jstate, jnp.asarray(u))
        obs = env.observe(params, state)
        state, rew = env.step(params, state, torch.from_numpy(u))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.qpos.numpy(), np.asarray(jstate.qpos), rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.qvel.numpy(), np.asarray(jstate.qvel), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
    assert state.qpos.dtype == torch.float32


def test_pendulum_reset_and_shift_keys():
    env = make_env("pendulum_swingup", "cpu")
    s = env.reset(env.default_params(), 1000, torch.Generator().manual_seed(0))
    assert s.qpos.shape == (1000, 1) and bool((s.qpos.abs() <= np.pi).all())
    assert bool((s.qvel == 0).all()) and s.qpos.std().item() > 1.5
    with pytest.raises(ValueError, match="no physics field"):
        apply_physics_shift(env.default_params(), [{"key": "body_mass_torso", "value": 2.0}])


# -- the store and the normalizer ---------------------------------------------


@pytest.mark.parametrize("path,num,length", [(STORE, 24, 1000), (STORE, 3, 200), (NPZ, 5, 1000)],
                         ids=["gmts", "gmts_cut", "npz"])
def test_load_trajectories_matches_jax(path, num, length):
    ref = jax_load_trajectories(path, num, length, 500.0)
    got = load_trajectories(path, num, length, 500.0)
    for name in ("states", "actions", "rewards", "executed_actions", "dynamics_actions"):
        r, g = getattr(ref, name), getattr(got, name)
        assert (r is None) == (g is None), name
        if r is not None:
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, r, err_msg=name)
    if path == STORE:
        assert got.states.shape == (min(num, 10), length, 3)
        assert got.executed_actions is not None
        assert length < 1000 or (got.rewards.sum(1) > 500).all()


def test_read_gmts_refuses_other_files(tmp_path):
    bad = tmp_path / "x.gmts"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        read_gmts(str(bad))


def test_normalizer_fit_on_the_store_matches_jax():
    jcfg, pcfg = gan9_configs()
    jtrajs, trajs = trajectories(24, 1000)
    ref = jcommon.build_normalizer(jcfg, jtrajs)
    got = common.build_normalizer(pcfg, trajs, "cpu")
    for name in ("state_mean", "state_std", "action_mean", "action_std"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


# -- the run's config and settings --------------------------------------------


def test_load_run_config_matches_jax():
    ref = jcommon.load_run_config(str(REPO / G9))
    got = common.load_run_config(str(REPO / G9))
    assert got.to_dict() == ref.to_dict()
    assert got.mpc.horizon == 10 and got.get_path("mpc.solver.max_iterations") == 30
    assert got.replace(mpc__horizon=3).mpc.horizon == 3 and got.mpc.horizon == 10
    assert Config.from_dict(got.to_dict()) == got


def test_solver_settings_read_every_knob():
    """gan/9's settings equal the JAX ones field by field; and a config
    that sets every field gets every value, where the JAX loader keeps
    fused_ls, num_alphas, compute_dtype and others at their defaults."""
    jcfg, pcfg = gan9_configs()
    ref, got = jcommon.solver_settings(jcfg), common.solver_settings(pcfg)
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.max_iterations == 30 and got.inner_unroll == 1

    knobs = dict(max_iterations=7, grad_norm_tol=1e-3, obj_step_tol=1e-5, alpha_0=0.5,
                 alpha_decay=0.7, num_alphas=8, reg_init=1e-4, reg_min=1e-5, reg_max=1e6,
                 reg_up=4.0, reg_down=0.3, psd_delta=1e-3, riccati="associative",
                 inner_unroll=2, ls_materialize="recompute", compute_dtype="bfloat16",
                 fused_ls="on")
    assert set(knobs) == {f.name for f in dataclasses.fields(got)}
    settings = common.solver_settings(pcfg.replace(**{f"mpc__solver__{k}": v
                                                     for k, v in knobs.items()}))
    assert dataclasses.asdict(settings) == knobs


def test_gan9_components_load_as_flax_restores_them():
    jcfg, pcfg = gan9_configs()
    _, params = jax_gan9(jcfg)
    policy = port_gan9(pcfg)
    comps = policy_components(policy)
    assert set(comps) == set(params)
    leaves = lambda tree: sorted((jax.tree_util.keystr(p), np.asarray(v))
                                 for p, v in jax.tree_util.tree_leaves_with_path(tree))
    for name, ps in comps.items():
        ref = [v for _, v in leaves(params[name])]
        got = sorted(p.detach().numpy().ravel().tolist() for p in ps)
        want = sorted(np.asarray(v, np.float32).ravel().tolist() for v in ref)
        assert got == want, name
    assert policy.cost_model.weights.shape == (4,)
    assert all(not p.requires_grad for p in policy.parameters())


def test_saved_params_splice_a_longer_weight_vector():
    """A config with one more MPC weight (the action-goal gain) than the
    run saved keeps its own tail, as the JAX setup's prefix splice does;
    fewer raise."""
    _, pcfg = gan9_configs(mpc__model__cost__weights__action_goal_gain=1.5)
    policy = common.build_policy(pcfg, 3, 1, with_critic=True, device="cpu")
    common.load_saved_params(policy, G9)
    saved = np.asarray(load_msgpack(REPO / G9 / "params.msgpack")["mpc_weights"])
    np.testing.assert_array_equal(policy.cost_model.weights.detach().numpy(),
                                  np.append(saved, np.float32(1.5)))
    short = common.build_policy(gan9_configs()[1].replace(
        mpc__model__cost__weights__action_goal=None), 3, 1, with_critic=True, device="cpu")
    with pytest.raises(ValueError, match="cannot drop"):
        common.load_saved_params(short, G9)


def test_setup_without_a_run_reads_the_saved_expert():
    """Without ``init_from_run`` the expert comes from the newest saved
    expert run, rebuilt from that run's config.json."""
    _, pcfg = gan9_configs(mpc__train__init_from_run=None, mpc__train__num_trajectories=2,
                           mpc__train__trajectory_len=40)
    ctx = common.setup(pcfg, True, STORE, "cpu")
    tree = load_msgpack(REPO / "runs/trained_models/expert/pendulum_swingup/0/params.msgpack")
    cell = tree["params"]["_LSTMCell_0"]
    lstm = ctx["policy"].expert_model.cell.lstm
    np.testing.assert_array_equal(lstm.ii.detach().numpy(),
                                  cell["OptimizedLSTMCell_0"]["ii"]["kernel"])
    assert ctx["cost_data"][0][0].shape == (int(0.8 * 2 * 29), 2, 3)
    assert ctx["dyn_train"][0].shape == (int(0.8 * 2 * 30), 10, 3)
