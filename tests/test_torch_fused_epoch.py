"""Port parity: the fused GAN and L2 epochs against the JAX package's.

``tests/jax_fused_reference.py`` runs one fused GAN epoch and one fused
L2 epoch of JAX's ``training/fused_epoch.py`` (its chunked mode, which
JAX defines to give the single program's numbers) in a fresh interpreter,
on tiny pendulum setups: H=3, iLQR <= 3, 2 envs of 6 steps from
9.6 and 7.3 degrees from upright (the reward is 1 within 8) with collection
noise 0.2, 16 expert windows, a test split, 2 expert-refresh
steps; the GAN epoch teacher forced, the L2 one not. Every draw of the
epoch is recomputed from its key and replayed into the port's epoch
(``FusedDraws``), which starts from the same params (the JAX tree loaded
by ``params.from_jax_params``) with the same phase optimizers. Compared,
float32 on the CPU:

  * every metric, rtol 1e-4 (atol 1e-6);
  * the replay's windows after the collection, atol 1e-5;
  * every parameter after the epoch, within 1e-6 + 1% of how far the
    epoch moved it in JAX (Adam's steps normalize their gradients, so
    rounding-sized differences of a gradient move a step by more than
    rounding); the ones no phase trains bitwise unchanged.

Also: ``plan_chunk`` 1 and 3 against the unchunked epoch, from the same
draws. The planner's lanes are independent, so the only difference is
float32 sums taken in another order at another batch size: metrics rtol
1e-5, parameters atol 1e-6. And ``chunk_updates`` and
``collect_chunk_steps`` change nothing, bitwise; an epoch's draws from
its generator repeat with the generator's seed.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.critic import SequenceCritic
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import from_jax_params, to_jax_params
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
from gan_mpc_tpu_torch.training.fused_epoch import (
    FusedDraws,
    make_fused_gan_epoch,
    make_fused_l2_epoch,
)
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components
from jax_fused_reference import H, ITERS, LR, NO_GRADS

torch.set_num_threads(1)
pin_fp32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(case, out_dir, *args):
    """Run ``tests/jax_fused_reference.py <case>`` in a fresh interpreter
    and load what it wrote."""
    out = os.path.join(str(out_dir), f"{case}.pkl")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "jax_fused_reference.py"),
                           case, out, *map(str, args)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def tensor(a):
    return torch.tensor(np.asarray(a))


def tiny_policy(tree, with_critic, members=0):
    """The port's counterpart of the reference's tiny policy, with the JAX
    params ``tree``, no parameter requiring a gradient; its dynamics an
    ensemble of ``members`` residual MLPs where that is > 0."""
    env = make_env("pendulum_swingup", "cpu")
    x, u = env.obs_size, env.act_size
    dynamics = (EnsembleDynamics([ResidualMLPDynamicsNet(x, u, (16,)) for _ in range(members)])
                if members else LearnedDynamics(ResidualMLPDynamicsNet(x, u, (16,))))
    policy = MPCPolicy(
        MPCCost(CostFeatureNet(x, (8,), 2), H),
        dynamics,
        ExpertPredictor(x, u, arch="mlp", features=0, hidden=(8,)),
        SequenceCritic(x, 8, (8,)) if with_critic else None,
        horizon=H, settings=SolverSettings(max_iterations=ITERS))
    return from_jax_params(tree, policy).requires_grad_(False)


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("epochs", tmp_path_factory.mktemp("jax"))


def port_epoch(ref, plan_chunk=0, **extra):
    """(policy, replay, epoch) of the port on the reference's setup."""
    gan = "critic_loss" in ref["metrics"]
    policy = tiny_policy(ref["params0"], gan, ref.get("members", 0))
    comps = policy_components(policy)
    names = ("dynamics", "critic", "cost") if gan else ("dynamics", "cost")
    opts = {k: masked_adam(comps, [c for c in NO_GRADS[k] if c in comps], LR[k]) for k in names}
    env = make_env("pendulum_swingup", "cpu")
    make = make_fused_gan_epoch if gan else make_fused_l2_epoch
    kwargs = {**ref["kwargs"], **extra}
    epoch = make(policy, env, env.default_params(),
                 Normalizer.identity(env.obs_size, env.act_size, "cpu"), opts,
                 tensor(ref["exp_X"]), tensor(ref["exp_Y"]),
                 expert_history_X_test=tensor(ref["test_X"]),
                 expert_future_Y_test=tensor(ref["test_Y"]),
                 expert_dyn_windows=tuple(tensor(a) for a in ref["dyn"]), plan_chunk=plan_chunk,
                 **kwargs)
    return policy, ReplayBuffer.create(64, H, env.obs_size, env.act_size, "cpu"), epoch


def jax_draws(ref) -> FusedDraws:
    d = ref["draws"]
    perms = {k: tensor(d[k]).long() for k in ("dyn_perm", "exp_perm", "plan_idx", "shuffle",
                                               "crit_perm", "cost_perm") if k in d}
    return FusedDraws(reset=EnvState(tensor(d["reset_qpos"]), tensor(d["reset_qvel"]),
                                     tensor(d["reset_t"])), noise=tensor(d["noise"]), **perms)


def run_port(ref, plan_chunk=0, **extra):
    policy, replay, epoch = port_epoch(ref, plan_chunk, **extra)
    metrics = epoch(replay, torch.Generator(), ref["teacher_forcing"], jax_draws(ref))
    return metrics._asdict(), replay, dict(leaves(to_jax_params(policy)))


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_fused_epoch_matches_jax(reference, family):
    ref = reference[family]
    metrics, replay, params = run_port(ref)
    assert sorted(metrics) == sorted(ref["metrics"])
    for name, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[name], float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    n = ref["replay"]["size"]
    assert replay.size == n == 2 * (6 - H)
    for name in ("states", "actions", "next_states"):
        np.testing.assert_allclose(getattr(replay, name)[:n].numpy(), ref["replay"][name],
                                   atol=1e-5, err_msg=name)
    want, before = dict(leaves(ref["params1"])), dict(leaves(ref["params0"]))
    assert sorted(params) == sorted(want)
    trained = {"gan": ("mpc_weights", "cost_params", "dynamics_params", "critic_params"),
               "l2": ("mpc_weights", "cost_params", "dynamics_params")}[family]
    for name, w in want.items():
        moved = np.abs(w - before[name]).max()
        if name.startswith(trained):
            assert moved > 0, name
            assert np.abs(params[name] - w).max() <= 1e-6 + 1e-2 * moved, name
        else:
            np.testing.assert_array_equal(params[name], w, err_msg=name)


@pytest.mark.parametrize("plan_chunk", [1, 3])
@pytest.mark.parametrize("family", ["gan", "l2"])
def test_plan_chunk_matches_the_whole_batch(reference, family, plan_chunk):
    ref = reference[family]
    whole, _, whole_params = run_port(ref)
    chunked, _, chunked_params = run_port(ref, plan_chunk=plan_chunk)
    for name in whole:
        np.testing.assert_allclose(chunked[name], whole[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for name, p in whole_params.items():
        np.testing.assert_allclose(chunked_params[name], p, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_watchdog_knobs_change_nothing_and_draws_repeat(reference, family):
    ref = reference[family]
    outs = []
    for extra in ({}, {"chunk_updates": 2, "collect_chunk_steps": 3}):
        policy, replay, epoch = port_epoch(ref, **extra)
        metrics = epoch(replay, torch.Generator().manual_seed(4), ref["teacher_forcing"])
        outs.append((metrics, dict(leaves(to_jax_params(policy))), replay.states.clone()))
    (m0, p0, r0), (m1, p1, r1) = outs
    assert m0 == m1 and torch.equal(r0, r1)
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
    assert all(np.isfinite(v) for v in m0)
