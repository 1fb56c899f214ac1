"""The ported slice end to end: closed-loop batched MPC on cheetah_run.

JAX ``policy_rollout`` (the path ``bench.py`` times) against the port's
``policy_rollout`` over 3 control steps of 8 envs at full flagship width
(H=5, iLQR <= 5, weights carried across by ``from_jax_params``), both
starting from the JAX package's resets (``jax.random`` cannot be
reproduced in torch). Float32 on the CPU. Tolerances: actions and states
atol 1e-3 per step, rewards atol 1e-4.

With random weights the plan is discontinuous in its input (line-search
argmin, acceptance test), and the closed loop carries a flipped decision
into every later step. On many reset draws some lane sits within f32
rounding of such a flip, where JAX against itself with the input scaled
by 1 + 1e-7 moves an action by up to 0.2. The test uses a reset key
(42) whose 8 lanes stay clear of flips for the 3 steps, and checks that
itself: JAX against itself from resets scaled by 1 +- 1e-7 moves no action
by 5e-3. (A flip moves one by 1e-2 or more; rounding carried through the
stiff ground contact moves them by about 1e-3 at the third step.) So each
quantity is held per step to max(its tolerance, 2 x JAX's own spread under
those nudges): at the third step the port's states sit 1.44e-3 from JAX's,
where JAX's own nudges move them by 1.40e-3.

Also: the port (the control path, the dynamics trainer, a cost-trainer
step, the committed run gan/9 loaded and continued by a cut GAN epoch, a
tiny L2 training run from config to saved run, a tiny fused GAN run with
a DAgger round, a tiny GAN run from an empty workdir, which collects
its expert store and trains its expert, and configs/gan_walker.yaml and
configs/l2_cartpole_quality.yaml cut tiny, from empty workdirs)
runs with JAX, flax and the JAX package made unimportable, and its entry
points run on the card unless asked for the CPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gan_mpc_tpu.data.normalizer import Normalizer as JaxNormalizer
from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs.rollout import policy_rollout as jax_policy_rollout
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import flagship
from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.envs.cheetah import CheetahRun
from gan_mpc_tpu_torch.envs.pendulum import PendulumSwingup
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.params import from_jax_params
from test_end_to_end import TINY_OVERRIDES

torch.set_num_threads(1)
pin_fp32()

REPO = Path(__file__).resolve().parent.parent


class _NudgedResets:
    """The env with every reset state scaled by ``scale``."""

    def __init__(self, env, scale):
        self._env, self._scale = env, scale

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, params, key):
        s = self._env.reset(params, key)
        return s.replace(qpos=s.qpos * self._scale, qvel=s.qvel * self._scale)


def test_closed_loop_rollout_matches_jax():
    H, iters, B, steps = 5, 5, 8, 3
    jpolicy, jparams, x, u = graft._flagship(
        horizon=H, max_iterations=iters, x_size=17, u_size=6
    )
    jenv = jax_make_env("cheetah_run")
    key = jax.random.PRNGKey(42)

    def jax_rollout(env):
        return jax.jit(
            lambda p, k: jax_policy_rollout(
                env, env.default_params(), jpolicy, p, JaxNormalizer.identity(x, u),
                k, num_steps=steps, history=1, num_envs=B,
            )
        )(jparams, key)

    ref = jax_rollout(jenv)
    # the key's lanes stay clear of line-search flips: rounding-sized
    # changes to the resets move JAX's own actions by less than a flip would
    nudged = [jax_rollout(_NudgedResets(jenv, scale)) for scale in (1 + 1e-7, 1 - 1e-7)]
    for n in nudged:
        assert np.abs(np.asarray(n.actions) - np.asarray(ref.actions)).max() < 5e-3
    # the JAX rollout's own resets: split(split(key)[0], num_envs)
    resets = jax.vmap(lambda k: jenv.reset(jenv.default_params(), k))(
        jax.random.split(jax.random.split(key)[0], B)
    )
    init = EnvState(
        qpos=torch.tensor(np.asarray(resets.qpos)),
        qvel=torch.tensor(np.asarray(resets.qvel)),
        t=torch.zeros(B, dtype=torch.int32),
    )
    policy = from_jax_params(jax.device_get(jparams), flagship(H, iters, x, u, device="cpu"))
    env = make_env("cheetah_run", "cpu")
    got = policy_rollout(
        env, env.default_params(), policy, Normalizer.identity(x, u, "cpu"),
        num_steps=steps, history=1, num_envs=B, init_state=init,
    )
    for t in range(steps):
        for name, atol in [("states", 1e-3), ("actions", 1e-3), ("qpos", 1e-3),
                           ("qvel", 1e-3), ("rewards", 1e-4)]:
            want = np.asarray(getattr(ref, name))[:, t]
            spread = max(np.abs(np.asarray(getattr(n, name))[:, t] - want).max() for n in nudged)
            np.testing.assert_allclose(
                getattr(got, name)[:, t].numpy(), want,
                rtol=0, atol=max(atol, 2 * spread), err_msg=f"{name} at step {t}",
            )
    assert np.all(np.isfinite(got.states.numpy()))


BLOCKED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "flax", "gan_mpc_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import torch
    import gan_mpc_tpu_torch
    from gan_mpc_tpu_torch.bench import flagship
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.envs.rollout import policy_rollout
    from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_step

    mods = [m.name for m in pkgutil.walk_packages(
        gan_mpc_tpu_torch.__path__, "gan_mpc_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    torch.set_num_threads(1)
    env = make_env("cheetah_run", "cpu")
    for fused_ls in ("off", "on"):
        ep = policy_rollout(
            env, env.default_params(), flagship(device="cpu", seed=0, fused_ls=fused_ls),
            Normalizer.identity(17, 6, "cpu"), num_steps=2, history=1, num_envs=2,
            generator=torch.Generator().manual_seed(0),
        )
        assert ep.actions.shape == (2, 2, 6) and bool(torch.isfinite(ep.states).all())

    # the dynamics trainer, collecting with the policy it trains
    from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
    from gan_mpc_tpu_torch.data.windows import sequence_windows
    from gan_mpc_tpu_torch.training.dynamics import train_dynamics
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    policy = flagship(5, 1, device="cpu", seed=0)
    opt = masked_adam(policy_components(policy),
                      ["mpc_weights", "cost_params", "expert_params"], 1e-5)
    norm = Normalizer.fit(ep.states, ep.actions)
    _, returns, losses = train_dynamics(
        policy.dynamics_model, opt, sequence_windows(ep.states, ep.actions, 1),
        ReplayBuffer.create(20, 1, 17, 6, "cpu"),
        lambda gen: policy_rollout(env, env.default_params(), policy, norm, num_steps=3,
                                   history=1, num_envs=1, generator=gen),
        norm, num_episodes=1, num_updates=1, batch_size=2, discount_factor=0.9,
        teacher_forcing_factor=0.7, generator=torch.Generator().manual_seed(0), epoch=1,
        warm_start_updates=1,
    )
    assert len(losses) == 2 and all(l == l for l in losses + returns)

    # the cost trainer: one minibatch step through the implicit gradient
    from gan_mpc_tpu_torch.data.windows import cost_windows
    from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
    from gan_mpc_tpu_torch.training.cost import train_cost

    policy = flagship(3, 1, device="cpu", seed=0)
    opt = masked_adam(policy_components(policy), ["dynamics_params", "expert_params"], 1e-5,
                      weights_learning_rate=1e-3)
    windows = cost_windows(0.1 * torch.randn(1, 6, 17, generator=torch.Generator().manual_seed(0)),
                           1, 3)
    train_losses, test_losses = train_cost(
        policy, opt, windows, windows, l2_imitation_loss, num_updates=1, batch_size=2,
        polyak_factor=0.9, generator=torch.Generator().manual_seed(0))
    assert len(train_losses) == len(test_losses) == 1
    assert all(l == l for l in train_losses + test_losses)

    # the committed run gan/9 loaded and continued by one GAN epoch, cut
    from gan_mpc_tpu_torch.runners import common, gan

    g9 = "runs/trained_models/imitator/pendulum_swingup/gan/9"
    cfg = common.load_run_config(g9).replace(
        mpc__train__init_from_run=g9, mpc__solver__max_iterations=2,
        mpc__train__num_trajectories=2, mpc__train__trajectory_len=30,
        mpc__train__dynamics__max_interactions_per_episode=12,
        mpc__train__dynamics__warm_start_updates=1, mpc__train__dynamics__expert_updates=0,
        mpc__train__dynamics__num_updates=1, mpc__train__dynamics__batch_size=16,
        mpc__train__critic__plan_batch=4, mpc__train__critic__batch_size=4,
        mpc__train__critic__num_updates=1, mpc__train__cost__batch_size=4,
        mpc__train__cost__num_updates=1, mpc__train__cost__steps_per_update=1,
        mpc__train__cost__eval_windows=4)
    ctx = common.setup(cfg, True, "runs/expert_trajectories/pendulum_swingup/"
                       "trajectories-f690b23776.gmts", "cpu")
    record = gan.gan_epoch(ctx, gan.phase_optimizers(ctx), 1, torch.Generator().manual_seed(0))
    assert all(v and all(x == x for x in v) for v in record.values()), record

    # a tiny L2 training run, from its config to the saved run
    import os, shutil
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.runners import l2
    from gan_mpc_tpu_torch.utils.io import load_params

    work = sys.argv[1]
    shutil.copytree("runs/trained_models/expert/pendulum_swingup/0",
                    os.path.join(work, "trained_models/expert/pendulum_swingup/0"))
    cfg = Config.from_yaml_str(TINY_YAML).replace(
        runtime__workdir=work, mpc__evaluate__max_interactions=15,
        mpc__evaluate__fresh_eval_episodes=2,
        env__trajectories_path="runs/expert_trajectories/pendulum_swingup/"
        "trajectories-f690b23776.gmts")
    out = l2.run(cfg, log_fn=None, device="cpu")
    assert sorted(load_params(os.path.join(out["run_dir"], "params.msgpack"))) == [
        "cost_params", "dynamics_params", "expert_params", "mpc_weights"]

    # the fused epochs and a DAgger round with its extra fused epoch
    assert "gan_mpc_tpu_torch.training.fused_epoch" in mods
    logs = []
    out = gan.run(cfg.replace(runtime__fused_epochs=True, expert_prediction__dagger={
        "rounds": 1, "num_segments": 4, "segment_steps": 12, "policy_episodes": 2,
        "finetune_epochs": 1, "extra_epochs": 1}), log_fn=logs.append, device="cpu")
    assert sum(m.startswith("[gan/fused] epoch") for m in logs) == 2, logs
    assert sum(m.startswith("[gan/dagger] round 1") for m in logs) == 1, logs

    # a tiny GAN run from an empty workdir: runners.collect collects its
    # store, runners.expert trains its expert
    cfg = Config.from_yaml_str(TINY_YAML).replace(
        runtime__workdir=os.path.join(work, "fresh"), env__expert_episode_steps=200,
        mpc__evaluate__max_interactions=15, mpc__evaluate__fresh_eval_episodes=2)
    gan.run(cfg, log_fn=None, device="cpu")
    assert os.path.exists(common.trajectories_path(cfg))
    assert os.listdir(common.expert_model_dir(cfg)) == ["0"]

    # configs/gan_walker.yaml and configs/l2_cartpole_quality.yaml from
    # empty workdirs, cut tiny: collection, expert, fused epochs (DAgger)
    cuts = dict(env__expert_episode_steps=40, env__collect_trajectories=4,
                mpc__train__num_trajectories=2, mpc__train__trajectory_len=40,
                mpc__train__min_expert_reward=1.0, mpc__solver__max_iterations=1,
                mpc__train__num_epochs=1, mpc__train__dynamics__max_interactions_per_episode=12,
                mpc__train__dynamics__num_updates=1, mpc__train__dynamics__warm_start_updates=1,
                mpc__train__dynamics__batch_size=8, mpc__train__cost__num_updates=1,
                mpc__train__cost__batch_size=2, mpc__evaluate__dm_control_episodes=0,
                mpc__evaluate__max_interactions=6, mpc__evaluate__midrun_episodes=1,
                mpc__evaluate__candidate_pool=1, mpc__evaluate__selection_episodes=1,
                mpc__evaluate__num_runs_for_avg=1, mpc__evaluate__fresh_eval_episodes=1,
                expert_prediction__train__num_epochs=1, expert_prediction__eval_runs=1)
    walker = dict(mpc__train__critic__num_updates=1, mpc__train__critic__batch_size=2,
                  runtime__num_parallel_envs=2, expert_prediction__dagger={
                      "rounds": 1, "num_segments": 2, "segment_steps": 12, "policy_episodes": 1,
                      "finetune_epochs": 1, "extra_epochs": 0})
    for name, runner, extra in (("gan_walker", gan, walker), ("l2_cartpole_quality", l2, {})):
        cfg = Config.from_yaml(f"configs/{name}.yaml").replace(
            runtime__workdir=os.path.join(work, name), **cuts, **extra)
        out = runner.run(cfg, log_fn=None, device="cpu")
        assert os.path.exists(os.path.join(out["run_dir"], "params.msgpack"))
        assert os.listdir(common.expert_model_dir(cfg)) == ["0"]

    # the per-instance path: humanoid_stand gan/0 (8-member ensemble, H=50)
    # loaded from its committed run and store, one solve cut to one trip
    import dataclasses
    from gan_mpc_tpu_torch.bench import load_checkpoint

    assert "gan_mpc_tpu_torch.models.ensemble" in mods
    ckpt = load_checkpoint("runs/trained_models/imitator/humanoid_stand/gan/0", "cpu")
    policy = ckpt.policy
    assert policy.dynamics_model.num_members == 8 and not policy.batch_native
    policy.settings = dataclasses.replace(policy.settings, max_iterations=1)
    sol = policy.plan_batch(torch.zeros(1, 2, 29), torch.zeros(1, 1, 12))
    assert sol.U.shape == (1, 50, 12) and bool(torch.isfinite(sol.U).all())
    assert not [m for m in sys.modules if blocked(m)]
    print("imported", len(mods), "modules")
    """
).replace("TINY_YAML", repr(TINY_OVERRIDES))


def test_port_runs_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 16, proc.stdout


ENTRY_POINTS = {
    "flagship": lambda: flagship(2, 1, seed=0),
    "make_env": lambda: make_env("cheetah_run"),
    "CheetahRun": lambda: CheetahRun(),
    "PendulumSwingup": lambda: PendulumSwingup(),
    "Normalizer.identity": lambda: Normalizer.identity(17, 6),
    "ReplayBuffer.create": lambda: ReplayBuffer.create(10, 5, 17, 6),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Called without a device, an entry point runs on the card; on a host
    without one it raises rather than running quietly on the CPU."""
    if torch.cuda.is_available():
        made = ENTRY_POINTS[name]()
        tensor = {"flagship": lambda p: next(p.parameters()),
                  "make_env": lambda e: e.model(e.default_params()).mass,
                  "CheetahRun": lambda e: e.model(e.default_params()).mass,
                  "PendulumSwingup": lambda e: e.reset(e.default_params(), 2,
                                                       torch.Generator()).qpos,
                  "Normalizer.identity": lambda nrm: nrm.state_mean,
                  "ReplayBuffer.create": lambda buf: buf.states}[name](made)
        assert tensor.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name]()
