"""Port parity: the cross-evaluation in the real dm_control suite tasks.

``gan_mpc_tpu_torch/envs/dm_eval.py`` against ``gan_mpc_tpu/envs/dm_eval.py``
and ``runners.l2.dm_cross_eval`` against the JAX runner's, on the CPU:

  * the observation flattening, the walker's joint permutation and the
    suite model's physics shift are bitwise JAX's on suite envs of all
    four tasks (pendulum, cart-pole, cheetah, walker), stepped a few
    times; the planar humanoids are refused by both;
  * one episode of 30 steps of a committed run, served as the benches
    load it, each package's ``evaluate_in_dm_control`` from the same
    suite seed (``check_cut_episode``; here cartpole_balance l2/0 from
    seed 0, in ``test_torch_dm_eval_gan9.py`` pendulum_swingup gan/9 on
    its own store from seed 14, a start near upright, so that the 30
    steps earn reward):

      - the port's first history is its normalizer on JAX's first raw
        observation, bitwise (the same observation reaches both);
      - at every step the port's action on JAX's history is within
        max(1e-3, 2 x JAX's own spread), the spread being the largest
        move of JAX's action when the raw observations or the
        normalizer's mean are scaled by 1 +- 1e-7 and 1 +- 2e-7 (the
        pattern of ``test_torch_trained_ckpts.py``: these trained solves
        run their whole budget, and the cart-pole's normalizer divides
        cos th by a std of 2e-5). The history is JAX's normalized one: the
        port's normalizer, held to JAX's in ``test_torch_trained_ckpts.py``,
        rounds cos th's mean and std otherwise, and on its own history
        the cart-pole's action moved by 2.3e-3 at step 13 (JAX's spread
        4.1e-4) when this was written;
      - each package's closed-loop return agrees within 1e-4 per step
        taken (3e-3 over 30 steps). The loops part only by the rounding
        above, and the rewards are smooth in the state; when this was
        written the cart-pole's returns (29.911) differed by 1.8e-4;

  * ``dm_cross_eval`` at the end of a tiny ``l2.run`` with
    ``dm_control_episodes: 1`` writes JAX's ``{"mean", "episodes"}``
    (rounded to 2 places), equal to JAX's ``dm_cross_eval`` on the saved
    params (its ``[dm_control]`` line too), and is None where dm_control
    does not import and for an env without a suite task.

``test_full_episodes_against_jax`` (``slow``) rolls episodes 0-1 of both
runs at full length in both packages and prints them beside the returns
the runs recorded.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.envs import dm_eval as jdm
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.envs import dm_eval
from gan_mpc_tpu_torch.runners import common, l2
from test_torch_trained_ckpts import _repo_cwd, run_dir, served_pair  # noqa: F401  (fixture)

import jax_native_store

torch.set_num_threads(1)
pin_fp32()
jax_native_store.ensure()
pytest.importorskip("dm_control.suite")

NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)
STEPS = 30
RETURN_TOL = 1e-4  # per step taken
# each suite task with a physics shift of the imitator's kind
SHIFTS = {
    "pendulum_swingup": [{"key": "body_mass_pole", "value": 1.3},
                         {"key": "jnt_stiffness_hinge", "value": 2.0}],
    "cartpole_balance": [{"key": "body_mass_cart", "value": 1.5},
                         {"key": "geom_size_pole_1", "value": 1.2}],
    "cheetah_run": [{"key": "body_mass_torso", "value": 3.0},
                    {"key": "jnt_stiffness_bthigh", "value": 0.5}],
    "walker_walk": [{"key": "body_mass_torso", "value": 1.5}],
}


def suite_env(name, seed=0):
    from dm_control import suite

    return suite.load(*dm_eval._SUITE_NAMES[name], task_kwargs={"random": seed})


@pytest.mark.parametrize("name", sorted(SHIFTS))
def test_observations_and_physics_shift_match_jax(name):
    assert dm_eval._SUITE_NAMES == jdm._SUITE_NAMES
    assert dm_eval.has_dm_counterpart(name) and jdm.has_dm_counterpart(name)
    assert dm_eval.dm_control_available() and jdm.dm_control_available()
    mine, theirs = suite_env(name), suite_env(name)
    dm_eval.apply_suite_physics_shift(mine, SHIFTS[name])
    jdm.apply_suite_physics_shift(theirs, SHIFTS[name])
    for field in ("body_mass", "geom_size", "jnt_stiffness"):
        got, want = (np.asarray(getattr(e.physics.model, field)) for e in (mine, theirs))
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert not np.array_equal(mine.physics.model.body_mass,
                              suite_env(name).physics.model.body_mass)
    rng = np.random.default_rng(0)
    ts, tj = mine.reset(), theirs.reset()
    for _ in range(5):
        got, want = dm_eval.flatten_observation(ts.observation), jdm.flatten_observation(
            tj.observation)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        if name == "walker_walk":
            obs = dm_eval._walker_obs(mine.physics)
            assert obs.shape == (17,)
            np.testing.assert_array_equal(obs, jdm._walker_obs(theirs.physics))
        u = rng.uniform(-1, 1, mine.action_spec().shape)
        ts, tj = mine.step(u), theirs.step(u)
    with pytest.raises(ValueError, match="unsupported physics-shift key"):
        dm_eval.apply_suite_physics_shift(mine, [{"key": "gravity", "value": 2.0}])


@pytest.mark.parametrize("name", ["humanoid_stand", "humanoid_walk"])
def test_planar_humanoid_is_refused(name):
    assert not dm_eval.has_dm_counterpart(name) and not jdm.has_dm_counterpart(name)
    for evaluate, args in ((dm_eval.evaluate_in_dm_control, (None, None)),
                           (jdm.evaluate_in_dm_control, (None, None, None))):
        with pytest.raises(ValueError, match="no dm_control counterpart"):
            evaluate(name, *args)


class RecordingNormalizer:
    """JAX's normalizer, keeping every raw observation it normalizes."""

    def __init__(self, norm):
        self.norm, self.raw = norm, []

    def normalize_state(self, x):
        self.raw.append(np.asarray(x))
        return self.norm.normalize_state(x)


def cross_evaluate(run, steps, episodes=1, seed=0):
    """Both packages' ``evaluate_in_dm_control`` on ``run`` from suite seed
    ``seed``. Returns (JAX's returns, the port's, JAX's records, the port's
    windows, the loaded pair): JAX's records hold per step the raw
    observations so far, the history, the past actions and the action."""
    (_, _, _, _, _, jnorm, jpolicy, params, history), ckpt = served_pair(run)
    cfg = common.load_run_config(run_dir(run))
    name = cfg.env.imitator.name
    shifts = [dict(kv) for kv in (cfg.env.imitator.get_path("physics") or [])]
    act = jax.jit(jpolicy.act)
    rec, windows = RecordingNormalizer(jnorm), []

    def jax_fn(p, hx, hu):
        u = act(p, hx, hu)
        rec_steps.append((list(rec.raw), np.asarray(hx), np.asarray(hu), np.asarray(u)))
        return u

    @torch.no_grad()
    def port_fn(hx, hu):
        windows.append(hx.numpy().copy())
        return ckpt.policy.act(hx[None], hu[None])[0]

    rec_steps = []
    _, want = jdm.evaluate_in_dm_control(name, jax_fn, params, rec, history=history,
                                         num_episodes=episodes, max_steps=steps, seed=seed,
                                         physics_shifts=shifts)
    _, got = dm_eval.evaluate_in_dm_control(name, port_fn, ckpt.normalizer, history=history,
                                            num_episodes=episodes, max_steps=steps,
                                            seed=seed, physics_shifts=shifts)
    return want, got, rec_steps, windows, (jnorm, act, params, history, ckpt)


def raw_window(raw, history, obs_scale=1.0):
    """The (history + 1, x) raw observations of the latest window, as
    ``evaluate_in_dm_control`` builds it (the first repeated before)."""
    seq = [raw[0]] * history + raw
    return np.stack(seq[-(history + 1):]) * np.float32(obs_scale)


def check_cut_episode(run, seed):
    want, got, records, windows, (jnorm, act, params, history, ckpt) = cross_evaluate(
        run, STEPS, seed=seed)
    assert len(records) == len(windows) == STEPS
    # the same first observation reaches both packages
    np.testing.assert_array_equal(
        windows[0], ckpt.normalizer.normalize_state(torch.tensor(
            raw_window(records[0][0], history))).numpy())
    for t, (raw, hx, hu, u) in enumerate(records):
        spread = 0.0
        for s in NUDGES:
            for norm, scale in ((jnorm, s), (jnorm.replace(state_mean=jnorm.state_mean * s), 1.0)):
                nudged = norm.normalize_state(jnp.asarray(raw_window(raw, history, scale)))
                spread = max(spread, float(np.abs(np.asarray(act(params, nudged, hu)) - u).max()))
        with torch.no_grad():
            mine = ckpt.policy.act(torch.tensor(hx)[None], torch.tensor(hu)[None])[0].numpy()
        dev, atol = float(np.abs(mine - u).max()), max(1e-3, 2.0 * spread)
        assert dev <= atol, f"step {t}: |d| {dev} > {atol} (JAX's own spread {spread})"
    assert abs(got[0] - want[0]) <= RETURN_TOL * STEPS, (got, want)
    return got[0], want[0]


def test_cut_episode_matches_jax():
    got, want = check_cut_episode("cartpole_balance/l2/0", seed=0)
    assert want > 25.0  # the pole balanced: the returns compared are not trivial


def test_dm_cross_eval_at_the_end_of_a_run(tmp_path, monkeypatch):
    from gan_mpc_tpu.config import Config as JaxConfig
    from gan_mpc_tpu.runners import common as jcommon
    from gan_mpc_tpu.runners import l2 as jl2
    from gan_mpc_tpu.runners.expert import load_pretrained_expert
    from gan_mpc_tpu.utils import io as jio
    from test_torch_run_l2 import tiny_config

    cfg = tiny_config(tmp_path, mpc__evaluate__dm_control_episodes=1,
                      mpc__evaluate__fresh_eval_episodes=2)
    logs = []
    out = l2.run(cfg, log_fn=logs.append, device="cpu")
    with open(os.path.join(out["run_dir"], "config.json")) as f:
        stamp = json.load(f)["dm_control_reward"]
    assert sorted(stamp) == ["episodes", "mean"] and len(stamp["episodes"]) == 1
    # JAX's dm_cross_eval on the saved run: its policy, params and the
    # normalizer on the same store
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    expert_model, expert_params = load_pretrained_expert(jcfg, 3, 1)
    policy, template = jcommon.build_policy(jcfg, 3, 1, expert_params=expert_params,
                                            expert_model=expert_model)
    params = jio.load_params(template, os.path.join(out["run_dir"], "params.msgpack"))
    norm = jcommon.build_normalizer(jcfg, jcommon.ensure_trajectories(jcfg))
    jlogs = []
    want = jl2.dm_cross_eval(jcfg, dict(policy=policy, params=params, normalizer=norm),
                             jlogs.append)
    assert stamp == want, (stamp, want)
    assert [m for m in logs if m.startswith("[dm_control]")] == jlogs
    # None for an env without a suite task, and where dm_control does not import
    assert l2.dm_cross_eval(cfg.replace(env__imitator__name="humanoid_stand"), {}) is None
    for name in [m for m in sys.modules if m == "dm_control" or m.startswith("dm_control.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "dm_control", None)  # import fails
    assert l2.dm_cross_eval(cfg, {}) is None


# the returns the committed runs recorded for their first two episodes
RECORDED = {"pendulum_swingup/gan/9": (923.0, 938.0),
            "cartpole_balance/l2/0": (982.92, 999.87)}


@pytest.mark.slow
@pytest.mark.parametrize("run", sorted(RECORDED))
def test_full_episodes_against_jax(run):
    """Episodes 0-1 at full length (1000 steps) in both packages, printed
    beside the returns the run recorded. Over 1000 closed-loop steps the
    rounding above can steer the loops apart, so the returns are held to
    1% of JAX's."""
    want, got, *_ = cross_evaluate(run, 1000, episodes=2)
    print(f"{run}: port {[round(r, 2) for r in got]}, JAX {[round(r, 2) for r in want]}, "
          f"recorded {list(RECORDED[run])}")
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-2 * abs(w), (got, want)
