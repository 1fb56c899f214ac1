"""Port parity: the evaluation and model selection of the training runs.

  * ``l2.episode_returns`` on gan/9 (H=10, iLQR <= 30) against the JAX
    runner's: 4 episodes of 10 steps from JAX's resets scaled toward
    upright (so that the pendulum earns reward), per-episode returns
    equal (rewards are 0 or 1 a step). The reset key (0) is checked clear
    of the plan's rounding flips: resets scaled by 1 +- 1e-7 give JAX the
    same returns;
  * ``note_candidate`` and ``select_best_params`` with the evaluation
    stubbed to fixed scores: the same pool (trimmed to
    ``candidate_pool``) and the same winner as JAX's; pooled candidates
    keep their own values after further training, and each is evaluated
    loaded into the policy, the winner left loaded.
"""

import jax
import numpy as np
import pytest
import torch

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.runners import l2 as jl2
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.envs import EnvState
from gan_mpc_tpu_torch.runners import common, l2
from gan_mpc_tpu_torch.training.dynamics import update_pass
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components, policy_state
from test_end_to_end import TINY_OVERRIDES
from test_torch_gan import _NudgedResets
from test_torch_pendulum import REPO, gan9_configs, jax_gan9, port_gan9, trajectories
from test_torch_run_l2 import tiny_config

torch.set_num_threads(1)


def test_episode_returns_match_jax(monkeypatch):
    monkeypatch.chdir(REPO)
    jcfg, pcfg = gan9_configs(mpc__evaluate__max_interactions=10)
    jpolicy, params = jax_gan9(jcfg)
    jtrajs, trajs = trajectories(24, 1000)
    jnorm = jcommon.build_normalizer(jcfg, jtrajs)
    jenv, jenv_params = jcommon.imitator_env(jcfg)
    key, B, toward_upright = jax.random.PRNGKey(0), 4, 0.1

    def jax_returns(scale):
        ctx = dict(env_im=_NudgedResets(jenv, toward_upright * scale), env_im_params=jenv_params,
                   policy=jpolicy, params=params, normalizer=jnorm)
        return np.asarray(jl2.episode_returns(jcfg, ctx, key, num_runs=B))

    ref = jax_returns(1.0)
    for scale in (1 + 1e-7, 1 - 1e-7):
        np.testing.assert_array_equal(jax_returns(scale), ref)
    # the JAX rollout's resets: split(split(key)[0], num_envs)
    resets = jax.vmap(lambda k: _NudgedResets(jenv, toward_upright).reset(jenv_params, k))(
        jax.random.split(jax.random.split(key)[0], B))
    init = EnvState(torch.tensor(np.asarray(resets.qpos)), torch.tensor(np.asarray(resets.qvel)),
                    torch.zeros(B, dtype=torch.int32))
    env, env_params = common.imitator_env(pcfg, "cpu")
    ctx = dict(env_im=env, env_im_params=env_params, policy=port_gan9(pcfg),
               normalizer=common.build_normalizer(pcfg, trajs, "cpu"))
    got = l2.episode_returns(pcfg, ctx, None, num_runs=B, init_state=init)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < 10 * B  # some episodes earn reward, some do not


@pytest.fixture(scope="module")
def tiny_policy():
    return common.build_policy(Config.from_yaml_str(TINY_OVERRIDES), 3, 1, with_critic=True,
                               device="cpu")


def _weights_score(ctx):
    """A stub evaluation: the loaded policy's MPC weights, as a score."""
    return float(ctx["policy"].cost_model.weights.sum())


def test_selection_matches_jax(monkeypatch, tmp_path, tiny_policy):
    midrun = [3.0, 7.0, 5.0, 7.0, 1.0, 6.0]
    final_and_rerank = [4.0, 9.0, 2.0, 8.0]  # the 3 pooled, then the final params
    cfg = tiny_config(tmp_path, mpc__evaluate__candidate_pool=3)
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    picked = {}
    for name, mod, ctx in (("jax", jl2, {}), ("port", l2, {"policy": tiny_policy})):
        scores = iter(final_and_rerank)
        monkeypatch.setattr(mod, "evaluate", lambda *a, _s=scores, **k: next(_s))
        states = [policy_state(tiny_policy) for _ in midrun]
        for i, s in enumerate(midrun):
            mod.note_candidate(ctx, s, {"id": i} if name == "jax" else states[i],
                               config=jcfg if name == "jax" else cfg)
        pool = [s for s, _ in ctx["candidates"]]
        final = {"id": "final"} if name == "jax" else policy_state(tiny_policy)
        chosen = mod.select_best_params(jcfg if name == "jax" else cfg, ctx, final,
                                        jax.random.PRNGKey(0) if name == "jax"
                                        else torch.Generator().manual_seed(0))
        cands = [p for _, p in ctx["candidates"]] + [final]
        picked[name] = (pool, next(i for i, c in enumerate(cands) if c is chosen))
    assert picked["port"] == picked["jax"] == ([7.0, 7.0, 6.0], 1)


def test_pooled_candidates_keep_their_values(tmp_path, tiny_policy, monkeypatch):
    """Each candidate is a copy: training after it was pooled leaves it as
    it was, and the re-rank evaluates each one loaded into the policy."""
    ctx, policy = {"policy": tiny_policy}, tiny_policy
    opt = masked_adam(policy_components(policy), ["mpc_weights", "cost_params",
                                                  "expert_params", "critic_params"], 1e-2)
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(16, 3, 3, generator=gen)
    U = torch.randn(16, 3, 1, generator=gen)
    dyn = policy.dynamics_model
    weights = []
    for step in range(3):
        with torch.no_grad():
            policy.cost_model.weights.add_(1.0)  # a distinct score each
        weights.append(policy.cost_model.weights.detach().clone())
        l2.note_candidate(ctx, float(step), policy_state(policy), k=3)
        update_pass(dyn, opt, (X, U, X), torch.arange(16).reshape(2, 8), 0.9, True)
    pooled = [p for _, p in ctx["candidates"]]
    final = policy_state(policy)
    for a in pooled:
        assert not torch.equal(a["dynamics_params"][0], final["dynamics_params"][0])
    assert not torch.equal(pooled[0]["dynamics_params"][0], pooled[1]["dynamics_params"][0])
    seen = []

    def stub(config, ctx, generator, num_runs=None):
        seen.append(ctx["policy"].cost_model.weights.detach().clone())
        return _weights_score(ctx) if len(seen) != 2 else 1e9  # the 2nd pooled one wins

    monkeypatch.setattr(l2, "evaluate", stub)
    chosen = l2.select_best_params(tiny_config(tmp_path), ctx, final, torch.Generator())
    # pooled best first (scores 2, 1, 0), then the final params
    expect = [weights[2], weights[1], weights[0], final["mpc_weights"][0]]
    assert all(torch.equal(s, w) for s, w in zip(seen, expect)) and len(seen) == 4
    assert chosen is pooled[1]
    for p, q in zip(policy_components(policy)["dynamics_params"], pooled[1]["dynamics_params"]):
        assert torch.equal(p, q)  # the winner is left loaded
