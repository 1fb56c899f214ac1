"""Port parity: the committed trained runs that the per-instance planning
path and goal projection unlock, served from their committed stores, as
``test_torch_trained_ckpts.py`` serves cheetah gan/4 (its loader and
served-step checks and their tolerances: each action within
max(1e-3, 2 x JAX's own spread under nudges of the observations and the
normalizer's mean)):

  * the stores of humanoid_stand gan/0-1 (``trajectories-e0c6da4a17``) and
    humanoid_walk gan/0-2 (``trajectories-645e56171c``), written by the JAX
    package's ``ensure_trajectories`` on each run's saved config, load
    bitwise in both packages and are the names the port's
    ``trajectories_path`` gives every one of those runs' configs;
    cheetah gan/0 resolves to gan/4's committed store;
  * humanoid_walk gan/0 (H=10, iLQR <= 30, dynamics 41->256->256->256->29,
    the action-goal cost): the loader against the JAX bench's
    ``_load_checkpoint``, and 2 envs closed-loop for 3 steps from JAX's
    resets, 8 nudges.

``test_torch_trained_ckpts_humanoid_stand.py`` serves humanoid_stand gan/0
(the 8-member ensemble at H=50) and ``test_torch_trained_ckpts_cheetah0.py``
cheetah gan/0 (goal projection), which this file leaves out to stay under
a minute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.data.trajectories import load_trajectories as jax_load_trajectories
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.data.trajectories import load_trajectories
from gan_mpc_tpu_torch.runners import common
from test_torch_pendulum import REPO
from test_torch_trained_ckpts import (  # noqa: F401  (the loader test, run here on these runs)
    _repo_cwd,
    _windows,
    run_dir,
    served_pair,
    test_bench_loader_matches_jax,
)

import jax_native_store

torch.set_num_threads(1)
pin_fp32()
jax_native_store.ensure()

STORES = {
    "humanoid_stand/gan/0": "humanoid_stand/trajectories-e0c6da4a17.gmts",
    "humanoid_stand/gan/1": "humanoid_stand/trajectories-e0c6da4a17.gmts",
    "humanoid_walk/gan/0": "humanoid_walk/trajectories-645e56171c.gmts",
    "humanoid_walk/gan/1": "humanoid_walk/trajectories-645e56171c.gmts",
    "humanoid_walk/gan/2": "humanoid_walk/trajectories-645e56171c.gmts",
    "cheetah_run/gan/0": "cheetah_run/trajectories-7f1480bbfd.gmts",
}
NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)


def test_store_names_of_every_unlocked_run():
    for run, store in STORES.items():
        jcfg, pcfg = jcommon.load_run_config(run_dir(run)), common.load_run_config(run_dir(run))
        assert common.trajectories_path(pcfg) == jcommon.trajectories_path(jcfg) == \
            f"runs/expert_trajectories/{store}", run


@pytest.mark.parametrize("run", ["humanoid_stand/gan/0", "humanoid_walk/gan/0"])
def test_committed_store_loads_in_both_packages(run, monkeypatch):
    jcfg, pcfg = jcommon.load_run_config(run_dir(run)), common.load_run_config(run_dir(run))
    path = common.trajectories_path(pcfg)

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


def check_served_steps(served, B, T, nudges, nudge_mean=True, jax_normalizer=False):
    """JAX's batch policy closes the loop over B envs for T steps from its
    resets (key 0); the port acts on the same observation histories,
    normalized by its own normalizer (by JAX's where ``jax_normalizer``);
    each action within max(1e-3, 2 x JAX's spread under ``nudges`` of the
    raw observations and (``nudge_mean``) of the normalizer's mean)."""
    _, ((jenv, jenv_params, _, _, _, jnorm, jpolicy, params, history), ckpt) = served
    norm = ckpt.normalizer
    if jax_normalizer:
        norm = dataclasses.replace(norm, **{
            f.name: torch.tensor(np.asarray(getattr(jnorm, f.name)))
            for f in dataclasses.fields(norm)})
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
        for kw in ([dict(obs_scale=s) for s in nudges]
                   + [dict(mean_scale=s) for s in nudges if nudge_mean]):
            nudged = np.asarray(act(params, *_windows(jnorm, O, A, t, **kw)))
            spread = np.maximum(spread, np.abs(nudged - want).max(-1))
        got = ckpt.policy.act_batch(*_windows(norm, O_t, A_t, t)).numpy()
        dev, atol = np.abs(got - want).max(-1), np.maximum(1e-3, 2.0 * spread)
        assert (dev <= atol).all(), f"step {t}: |d| {dev} > {atol} (JAX's own spread {spread})"


@pytest.fixture(scope="module")
def served():
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return "humanoid_walk/gan/0", served_pair("humanoid_walk/gan/0")


def test_served_steps_match_jax(served):
    _, (_, ckpt) = served
    assert ckpt.policy.batch_native and ckpt.policy.goal_projection == 0
    check_served_steps(served, B=2, T=3, nudges=NUDGES)
