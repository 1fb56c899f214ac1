"""Port parity: DAgger's collector and one DAgger round against JAX's.

``tests/jax_fused_reference.py dagger`` runs, in a fresh interpreter:

  * JAX's ``collect_dagger_trajectories`` on the tiny GAN policy of the
    fused-epoch tests (H=3, iLQR <= 3, identity normalizer): 3 policy
    episodes of 6 steps on the pendulum, 5 segments of 8 steps from the
    picked states with DART noise 0.25, uniform and reward-weighted;
    recorded: the policy rollout's resets and states, the picked indices
    and the segments' noise;
  * one round of JAX's ``runners/gan._dagger_rounds`` on the tiny run
    config of ``test_torch_run_l2.py`` (the committed pendulum store and
    expert; 2 policy episodes of 15 steps, 6 reward-weighted segments of
    12 steps, 2 fine-tune epochs, no extra epochs); recorded: the
    segments, the two window permutations, the fine-tune's minibatches,
    the fine-tuned expert and ``dagger_test_loss``.

The port's collector, given the resets, picks and noise, gives the same
segments (states, clean and executed actions, rewards: atol 1e-5) and
the policy's rollout the same states (atol 1e-5); its own draws pick
distinct states and repeat with the generator's seed. The port's
``runners.gan.dagger_rounds`` on the port's ``setup`` of the same config,
with JAX's segments, permutations and minibatches replayed, fine-tunes
the expert to JAX's within 1e-6 + 1% of how far JAX moved each parameter
(Adam's normalized steps), ``dagger_test_loss`` rtol 1e-4, and records
the round under JAX's names. Float32 on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.data.trajectories import TrajectorySet
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.params import expert_to_jax_params
from gan_mpc_tpu_torch.runners import common, gan, l2
from gan_mpc_tpu_torch.runners.collect import collect_dagger_trajectories
from test_torch_fused_epoch import leaves, run_reference, tensor, tiny_policy
from test_torch_run_l2 import tiny_config

torch.set_num_threads(1)

DAGGER = {"rounds": 1, "num_segments": 6, "segment_steps": 12, "policy_episodes": 2,
          "finetune_epochs": 2, "finetune_lr": 5e-5, "extra_epochs": 0,
          "state_weighting": "reward_weighted", "weight_power": 2.0, "weight_floor": 0.05}


def round_config(workdir):
    return tiny_config(workdir, expert_prediction__dagger=DAGGER,
                       mpc__evaluate__midrun_episodes=1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dagger")
    path = tmp / "config.json"
    path.write_text(json.dumps(round_config(tmp / "work").to_dict()))
    return run_reference("dagger", tmp, path)


@pytest.mark.parametrize("weighting", ["uniform", "reward_weighted"])
def test_collector_matches_jax(reference, weighting):
    ref = reference["collect"]
    kw, rec = ref["kwargs"], ref[weighting]
    policy = tiny_policy(ref["params"], True)
    env = make_env("pendulum_swingup", "cpu")
    norm = Normalizer.identity(env.obs_size, env.act_size, "cpu")
    reset = EnvState(tensor(rec["reset_qpos"]), tensor(rec["reset_qvel"]),
                     torch.zeros(kw["policy_episodes"], dtype=torch.int32))
    rollout = policy_rollout(env, env.default_params(), policy, norm,
                             num_steps=kw["policy_steps"], history=1,
                             num_envs=kw["policy_episodes"], init_state=reset)
    np.testing.assert_allclose(rollout.states.numpy(), rec["rollout_states"], atol=1e-5)
    got = collect_dagger_trajectories(
        env, env.default_params(), policy, norm, state_weighting=weighting,
        policy_reset=reset, picked=tensor(rec["picked"]).long(), noise=tensor(rec["noise"]),
        **kw)
    for name in ("states", "actions", "rewards", "executed_actions"):
        assert getattr(got, name).shape == rec["trajs"][name].shape, name
        np.testing.assert_allclose(getattr(got, name), rec["trajs"][name], atol=1e-5,
                                   err_msg=name)
    # the port's own draws: distinct states, the same for the same seed
    runs = [collect_dagger_trajectories(env, env.default_params(), policy, norm,
                                        torch.Generator().manual_seed(1),
                                        state_weighting=weighting, **kw) for _ in range(2)]
    for name in ("states", "actions", "rewards", "executed_actions"):
        np.testing.assert_array_equal(getattr(runs[0], name), getattr(runs[1], name))
    starts = {tuple(s) for s in runs[0].states[:, 0].round(6)}
    assert len(starts) == kw["num_segments"]


def test_dagger_round_matches_jax(reference, tmp_path, monkeypatch):
    ref = reference["round"]
    cfg = round_config(tmp_path)
    ctx = common.setup(cfg, True, device="cpu")
    for name, want in ref["normalizer"].items():
        np.testing.assert_allclose(getattr(ctx["normalizer"], name).numpy(), want, atol=1e-6)
    expert0 = dict(leaves(expert_to_jax_params(ctx["policy"].expert_model)))
    want0 = dict(leaves(ref["expert0"]))
    for name, w in want0.items():
        np.testing.assert_array_equal(expert0[name], w, err_msg=name)

    segments = TrajectorySet(**{k: np.asarray(v) for k, v in ref["segments"].items()})
    perms = iter(ref["perms"])
    split, train = gan.split_sequence_windows, gan.train_expert
    monkeypatch.setattr(gan, "collect_dagger_trajectories", lambda *a, **k: segments)
    monkeypatch.setattr(gan, "split_sequence_windows",
                        lambda s, a, seqlen, gen=None, start_oversample=0: split(
                            s, a, seqlen, start_oversample=start_oversample,
                            perm=tensor(next(perms)).long()))
    monkeypatch.setattr(gan, "train_expert", lambda *a, **k: train(
        *a, **k, indices=[tensor(m).long() for m in ref["minibatches"]]))

    class Metrics:
        rows = []

        def record(self, step, **values):
            self.rows.append(dict(step=step, **values))

    metrics, logs = Metrics(), []
    gan.dagger_rounds(cfg, ctx, gan.phase_optimizers(ctx), torch.Generator().manual_seed(0),
                      {}, metrics, l2.NO_BEST, logs.append)
    assert next(perms, None) is None
    assert logs == [f"[gan/dagger] round 1: 6 corrective segments, predictor test loss "
                    f"{metrics.rows[0]['dagger_test_loss']:.5f}"]
    assert [sorted(r) for r in metrics.rows] == [sorted(r) for r in ref["rows"]]
    assert metrics.rows[0]["dagger_round"] == 1
    np.testing.assert_allclose(metrics.rows[0]["dagger_test_loss"], ref["test_loss"], rtol=1e-4)
    got = dict(leaves(expert_to_jax_params(ctx["policy"].expert_model)))
    for name, w in dict(leaves(ref["tuned"])).items():
        moved = np.abs(w - want0[name]).max()
        assert moved > 0, name
        assert np.abs(got[name] - w).max() <= 1e-6 + 1e-2 * moved, name
    assert not any(p.requires_grad for p in ctx["policy"].expert_model.parameters())
    # no extra epochs: one evaluation of the refreshed predictor, pooled as a candidate
    assert len(ctx["candidates"]) == 1
