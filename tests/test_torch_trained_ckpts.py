"""Port parity: committed trained runs served from their committed stores.

The runs are cheetah_run gan/4 (the JAX bench's ``DEFAULT_CHECKPOINT``:
H=10, iLQR <= 30, dynamics 23->256->256->256->17, the action-goal cost,
critic), walker_walk gan/0 (the same stacks, torso x1.5) and
cartpole_balance l2/0 (H=5, iLQR <= 20, dynamics 6->200->200->200->5, no
critic). Each one's expert store is committed under
``runs/expert_trajectories/<env>/``, written by the JAX package's own
``ensure_trajectories`` on the run's saved config, so that both packages
fit the same normalizer.

  * the store loads in both packages bitwise equal, through each one's
    ``ensure_trajectories`` (which finds it and collects nothing), and
    the port's ``trajectories_path`` names the committed file;
  * the port bench's ``load_checkpoint`` builds what the JAX bench's
    ``_load_checkpoint`` builds: the normalizer (each mean and std within
    1e-6 of its channel's root mean square: the two reduce in different
    orders, and the cart-pole's cos th, near 1 with a std of 2e-5, loses
    its std's low digits to cancellation, 4.6e-6 of it when this was
    written), the imitator's physics, horizon,
    iteration budget and history, and every component's weights bitwise;
  * served control steps: JAX's batch policy closes the loop over 2 envs
    for 3 steps from its resets; the port acts on the same observation
    histories (the port's normalizer on the same raw observations). These
    trained solves are ill-conditioned (most run the whole iteration
    budget; the cart-pole's normalizer divides cos th by a std of 2e-5,
    so one rounding of cos th moves the planner's input by 3e-3), so each
    action is held to max(1e-3, 2 x JAX's own spread), the spread being
    the largest move of JAX's action when the raw observations or the
    normalizer's mean are scaled by 1 +- 1e-7 and 1 +- 2e-7. Measured
    over reset keys 0-5 x 4 envs x 3 steps of the three runs when this
    was written: the port's deviations reached 7.5e-2 (cart-pole), 7.3e-3
    (gan/4) and 3.7e-2 (walker); these 8 nudges covered them in 17 of the
    18 (run, key) cases, 16 nudges (up to 1 +- 4e-7) in all 18; key 0 is
    the one held here.

``test_torch_trained_ckpts_walker.py`` runs the JAX comparisons on
walker gan/0, which this file leaves out to stay under a minute.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.data.trajectories import load_trajectories as jax_load_trajectories
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu_torch import bench, pin_fp32
from gan_mpc_tpu_torch.data.trajectories import load_trajectories
from gan_mpc_tpu_torch.params import to_jax_params
from gan_mpc_tpu_torch.runners import common
from test_torch_pendulum import REPO

import jax_native_store

torch.set_num_threads(1)
pin_fp32()
jax_native_store.ensure()

STORES = {
    "cheetah_run/gan/4": "cheetah_run/trajectories-7f1480bbfd.gmts",
    "walker_walk/gan/0": "walker_walk/trajectories-90388c1f2e.gmts",
    "cartpole_balance/l2/0": "cartpole_balance/trajectories-828ef1af76.gmts",
}
B, T = 2, 3
NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)


def run_dir(run):
    return str(REPO / "runs/trained_models/imitator" / run)


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    # the JAX bench resolves the run's workdir ("runs") against the cwd
    monkeypatch.chdir(REPO)


@pytest.mark.parametrize("run", sorted(STORES))
def test_committed_store_loads_in_both_packages(run, monkeypatch):
    jcfg, pcfg = jcommon.load_run_config(run_dir(run)), common.load_run_config(run_dir(run))
    path = common.trajectories_path(pcfg)
    assert path == jcommon.trajectories_path(jcfg) == f"runs/expert_trajectories/{STORES[run]}"

    def refuse(*args, **kwargs):
        raise AssertionError("collected: the committed store was not found")

    monkeypatch.setattr(common, "collect_expert_trajectories", refuse)
    monkeypatch.setattr(jcommon.collect, "collect_expert_trajectories", refuse)
    got, want = common.ensure_trajectories(pcfg, "cpu"), jcommon.ensure_trajectories(jcfg)
    assert got.states.shape[0] == pcfg.mpc.train.num_trajectories
    for name in ("states", "actions", "rewards", "executed_actions", "dynamics_actions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    raw = load_trajectories(path, num_trajectories=100, trajectory_len=1000, min_reward=-1.0)
    assert raw.states.shape[0] == common.collection_size(pcfg)
    np.testing.assert_array_equal(raw.states, jax_load_trajectories(path, 100, 1000, -1.0).states)


def served_pair(run):
    """(JAX bench's ``_load_checkpoint`` tuple, the port bench's
    ``load_checkpoint``) of ``run`` on the CPU."""
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    return jax_bench._load_checkpoint(run_dir(run)), bench.load_checkpoint(run_dir(run), "cpu")


@pytest.fixture(scope="module", params=["cheetah_run/gan/4", "cartpole_balance/l2/0"])
def served(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return request.param, served_pair(request.param)


def test_bench_loader_matches_jax(served):
    run, ((jenv, jenv_params, name, horizon, iters, jnorm, _, params, history), ckpt) = served
    assert ckpt.name == name == f"{run.split('/')[0]} (trained ckpt)"
    assert (ckpt.policy.horizon, ckpt.policy.settings.max_iterations, ckpt.history) == (
        horizon, iters, history)
    assert ckpt.env.name == jenv.name
    assert [float(v) for v in jax.tree_util.tree_leaves(jenv_params)] == [
        np.float32(getattr(ckpt.env_params, k)) for k in type(jenv_params).__dataclass_fields__]
    for kind in ("state", "action"):
        mean, std = (np.asarray(getattr(jnorm, f"{kind}_{s}")) for s in ("mean", "std"))
        rms = np.sqrt(mean ** 2 + std ** 2)  # the size of the values reduced
        for field, want in (("mean", mean), ("std", std)):
            dev = np.abs(getattr(ckpt.normalizer, f"{kind}_{field}").numpy() - want)
            assert (dev <= 1e-6 * rms).all(), (f"{kind}_{field}", dev / rms)
    got = to_jax_params(ckpt.policy)
    assert sorted(got) == sorted(params)
    assert ("critic_params" in got) == (run != "cartpole_balance/l2/0")
    for comp in params:
        want, have = (jax.tree_util.tree_leaves_with_path(t) for t in (params[comp], got[comp]))
        assert [p for p, _ in have] == [p for p, _ in want], comp
        for (path, h), (_, w) in zip(have, want):
            np.testing.assert_array_equal(np.asarray(h), np.asarray(w), err_msg=f"{comp} {path}")


def _windows(norm, obs, acts, t, obs_scale=1.0, mean_scale=1.0):
    """The history-1 windows at step t from raw observations (B, T, x) and
    actions (B, T, u), as the closed loop builds them (zeros before the
    first step); JAX arrays, or torch tensors with ``norm`` the port's."""
    if isinstance(obs, torch.Tensor):
        zeros, stack = torch.zeros_like, torch.stack
    else:
        norm = norm.replace(state_mean=norm.state_mean * mean_scale)
        zeros, stack = jnp.zeros_like, jnp.stack
    state = lambda x: norm.normalize_state(x * obs_scale)
    prev = state(obs[:, t - 1]) if t > 0 else zeros(obs[:, 0])
    hx = stack([prev, state(obs[:, t])], 1)
    hu = (norm.normalize_action(acts[:, t - 1]) if t > 0 else zeros(acts[:, 0]))[:, None]
    return hx, hu


def test_served_steps_match_jax(served):
    _, ((jenv, jenv_params, _, _, _, jnorm, jpolicy, params, history), ckpt) = served
    assert history == 1
    act = jax.jit(jpolicy.act_batch)
    step = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    observe = jax.jit(jax.vmap(jenv.observe, in_axes=(None, 0)))
    state = jax.vmap(lambda k: jenv.reset(jenv_params, k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    obs, acts, pending = [], [], jnp.zeros((B, jenv.act_size))
    for t in range(T):  # JAX's closed loop
        obs.append(observe(jenv_params, state))
        u = act(params, *_windows(jnorm, jnp.stack(obs, 1), jnp.stack(acts + [pending], 1), t))
        acts.append(u)
        state, _ = step(jenv_params, state, u)
    O, A = jnp.stack(obs, 1), jnp.stack(acts, 1)
    O_t, A_t = torch.tensor(np.asarray(O)), torch.tensor(np.asarray(A))
    for t in range(T):
        want = np.asarray(A[:, t])
        spread = np.zeros(B)
        for kw in ([dict(obs_scale=s) for s in NUDGES] + [dict(mean_scale=s) for s in NUDGES]):
            nudged = np.asarray(act(params, *_windows(jnorm, O, A, t, **kw)))
            spread = np.maximum(spread, np.abs(nudged - want).max(-1))
        got = ckpt.policy.act_batch(*_windows(ckpt.normalizer, O_t, A_t, t)).numpy()
        dev, atol = np.abs(got - want).max(-1), np.maximum(1e-3, 2.0 * spread)
        assert (dev <= atol).all(), f"step {t}: |d| {dev} > {atol} (JAX's own spread {spread})"
