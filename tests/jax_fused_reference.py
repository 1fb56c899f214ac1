"""The JAX package's side of the port's fused-epoch and DAgger parity tests.

    python tests/jax_fused_reference.py epochs <out.pkl>
    python tests/jax_fused_reference.py mesh_epochs <out.pkl> [gan|l2]
    python tests/jax_fused_reference.py ensemble_epoch <out.pkl>
    python tests/jax_fused_reference.py dagger <out.pkl> <config.json>

XLA:CPU aborts a process that compiles the fused epoch after many other
programs (``tests/test_fused_epoch.py``), so the port's tests run this
module in a fresh interpreter (pytest does not collect it). It writes a
pickle of numpy trees:

  * ``epochs``: one fused GAN epoch and one fused L2 epoch
    (``training/fused_epoch.py`` in its chunked mode, ``chunk_updates=1``,
    which JAX defines to give the single program's numbers) on tiny
    pendulum setups (H=3, 2 envs of 6 steps from near upright, with collection noise, 16
    expert windows, a test split, an expert refresh): the params before
    and after, the metrics, the replay's windows, and every draw of the
    epoch recomputed from its key;
  * ``mesh_epochs``: the same two epochs in mesh mode (``mesh=make_mesh(2)``
    over two virtual CPU devices: the single program, since mesh mode
    excludes ``chunk_updates``), the GAN test split 4 histories so that it
    divides the mesh; one family where it is named;
  * ``dagger``: ``collect_dagger_trajectories`` on the tiny GAN policy,
    uniform and reward-weighted, with its draws recorded; then one round
    of ``runners/gan._dagger_rounds`` on the run config given (no extra
    epochs), with its collected segments, its two window permutations, the
    fine-tune's minibatch indices, the fine-tuned expert and
    ``dagger_test_loss`` recorded.
"""

import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
if __name__ == "__main__" and sys.argv[1:2] == ["mesh_epochs"]:
    jax.config.update("jax_num_cpu_devices", 2)  # before the first backend call

from gan_mpc_tpu.data.buffers import ReplayBuffer  # noqa: E402
from gan_mpc_tpu.data.normalizer import Normalizer  # noqa: E402
from gan_mpc_tpu.data.windows import minibatch_indices  # noqa: E402
from gan_mpc_tpu.envs import PendulumSwingup  # noqa: E402
from gan_mpc_tpu.models import (  # noqa: E402
    CostFeatureNet,
    ExpertPredictor,
    LearnedDynamics,
    MPCCost,
    ResidualMLPDynamicsNet,
    SequenceCritic,
)
from gan_mpc_tpu.models.ensemble import EnsembleDynamics  # noqa: E402
from gan_mpc_tpu.planner import SolverSettings  # noqa: E402
from gan_mpc_tpu.policies import MPCPolicy  # noqa: E402
from gan_mpc_tpu.training.fused_epoch import (  # noqa: E402
    make_fused_gan_epoch,
    make_fused_l2_epoch,
)
from gan_mpc_tpu.training.masking import masked_adam  # noqa: E402

KEY = jax.random.PRNGKey(0)
H = 3
ITERS = 3
N_WINDOWS = 16
COMMON = dict(num_envs=2, episode_steps=6, history=1, batch_size=4, gamma=0.9,
              polyak_factor=0.9, collect_noise=0.2, expert_dyn_updates=2, chunk_updates=1)
GAN = dict(COMMON, dynamics_updates=2, critic_updates=3, cost_updates=3, critic_plan_batch=4)
L2 = dict(COMMON, dynamics_updates=1, cost_updates=2)
NO_GRADS = {"dynamics": ["mpc_weights", "cost_params", "critic_params", "expert_params"],
            "critic": ["mpc_weights", "cost_params", "dynamics_params", "expert_params"],
            "cost": ["dynamics_params", "critic_params", "expert_params"]}
LR = {"dynamics": 1e-3, "critic": 1e-3, "cost": 1e-4}
# the epochs' 2 envs start 9.6 and 7.3 degrees from upright, the
# collector's 3 policy episodes 6.4, 8.6 and 7.6
EPOCH_RESET_SCALE, DAGGER_RESET_SCALE = 0.06, 0.07
ENSEMBLE_MEMBERS = 3
NUDGES = (1 + 1e-7, 1 - 1e-7)  # the ensemble epoch is rerun from its params scaled so


def tiny_policy(with_critic, reset_scale, members=0):
    """(env, policy, params); the env's reset angles scaled by
    ``reset_scale`` toward upright, so that some envs of the cases start
    inside the reward's 8-degree band and others outside it, and the
    returns and the reward weighting see rewards of 0 and of 1. With
    ``members`` > 0 the dynamics are an ensemble of that many of the
    residual MLPs."""
    env = PendulumSwingup()
    reset = env.reset
    env.reset = lambda p, k: (lambda s: s.replace(qpos=reset_scale * s.qpos))(reset(p, k))
    x, u = env.obs_size, env.act_size
    net = ResidualMLPDynamicsNet(x_size=x, hidden=(16,))
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(hidden=(8,), features_out=2), H),
        dynamics_model=EnsembleDynamics(net, members) if members else LearnedDynamics(net),
        expert_model=ExpertPredictor(x_size=x, u_size=u, arch="mlp", features=0, hidden=(8,)),
        critic_model=SequenceCritic(features=8, hidden=(8,)) if with_critic else None,
        horizon=H, settings=SolverSettings(max_iterations=ITERS))
    kw = {"critic_x_size": x} if with_critic else {}
    return env, policy, policy.init(KEY, (-2.0, 3.0, -3.0), u, **kw)


def expert_data(x, u):
    exp_X = 0.1 * jax.random.normal(KEY, (N_WINDOWS, 2, x))
    exp_Y = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (N_WINDOWS, H + 1, x))
    dyn = (exp_Y[:, : H - 1], 0.1 * exp_Y[:, : H - 1, :u], exp_Y[:, 1:H])
    return exp_X, exp_Y, dyn


def epoch_draws(key, env, kw, n_streams, replay_size, n_windows, n_dyn_windows):
    """JAX's draws of one fused epoch, from its key (``_epoch_body``'s
    order of streams; the collection's per-env keys of
    ``envs/rollout._batch_rollout_parts``)."""
    keys = jax.random.split(key, n_streams)
    k_collect, k_dyn = keys[0], keys[1]
    per_env = jax.vmap(jax.random.split)(jax.random.split(k_collect, kw["num_envs"]))
    reset = jax.vmap(lambda k: env.reset(env.default_params(), k))(per_env[:, 0])
    noise = np.stack([np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, t), (env.act_size,)))(per_env[:, 1]))
        for t in range(kw["episode_steps"])])
    B = kw["batch_size"]
    steps = kw["dynamics_updates"] * max(n_windows // B, 1)
    out = dict(reset_qpos=reset.qpos, reset_qvel=reset.qvel, reset_t=reset.t, noise=noise,
               dyn_perm=jax.random.randint(k_dyn, (steps, B), 0, max(replay_size, 1)),
               exp_perm=jax.random.randint(jax.random.fold_in(k_dyn, 1),
                                           (kw["expert_dyn_updates"], B), 0, n_dyn_windows))
    if n_streams == 6:
        k = kw["critic_plan_batch"]
        out.update(
            plan_idx=jax.random.choice(keys[2], n_windows, shape=(k,), replace=False),
            crit_perm=jax.random.randint(keys[3], (kw["critic_updates"], B), 0, 2 * k),
            cost_perm=minibatch_indices(keys[4], n_windows, kw["cost_updates"], B),
            shuffle=jax.random.permutation(keys[5], 2 * k))
    else:
        out["cost_perm"] = minibatch_indices(keys[2], n_windows, kw["cost_updates"], B)
    return jax.device_get(out)


def one_epoch(family, members=0, mesh=False):
    gan = family == "gan"
    env, policy, params = tiny_policy(gan, EPOCH_RESET_SCALE, members)
    x, u = env.obs_size, env.act_size
    names = ("dynamics", "critic", "cost") if gan else ("dynamics", "cost")
    no_grads = {k: [c for c in v if gan or c != "critic_params"] for k, v in NO_GRADS.items()}
    opts = {k: masked_adam(params, no_grads[k], LR[k])[0] for k in names}
    opt_states = {k: opt.init(params) for k, opt in opts.items()}
    exp_X, exp_Y, dyn = expert_data(x, u)
    kw = dict(GAN if gan else L2)
    test = (exp_X[:3], exp_Y[:3]) if gan and not mesh else (exp_X[:4], exp_Y[:4])
    make = make_fused_gan_epoch if gan else make_fused_l2_epoch
    extra = {}
    if mesh:
        from gan_mpc_tpu.parallel import make_mesh

        kw["chunk_updates"] = 0
        extra["mesh"] = make_mesh(2)
    epoch = make(policy, env, env.default_params(), Normalizer.identity(x, u), opts, exp_X,
                 exp_Y, expert_history_X_test=test[0], expert_future_Y_test=test[1],
                 expert_dyn_windows=dyn, **kw, **extra)
    replay = ReplayBuffer.create(64, H, x, u)
    key, teacher_forcing = jax.random.PRNGKey(5), gan
    new_params, _, replay, metrics = epoch(params, opt_states, replay, key,
                                           jnp.asarray(teacher_forcing))
    nudged = []
    for scale in NUDGES if members else ():
        out = epoch(jax.tree_util.tree_map(lambda a: a * np.float32(scale), params), opt_states,
                    ReplayBuffer.create(64, H, x, u), key, jnp.asarray(teacher_forcing))
        nudged.append(dict(params1=out[0], metrics=out[3]._asdict()))
    n_added = kw["num_envs"] * (kw["episode_steps"] - H)
    size = int(replay.size)
    return jax.device_get(dict(
        kwargs=kw, members=members, teacher_forcing=teacher_forcing, params0=params,
        params1=new_params, nudged=nudged,
        metrics=metrics._asdict(), exp_X=exp_X, exp_Y=exp_Y, test_X=test[0], test_Y=test[1],
        dyn=dyn, replay=dict(states=replay.states[:size], actions=replay.actions[:size],
                             next_states=replay.next_states[:size], size=size),
        draws=epoch_draws(key, env, kw, 6 if gan else 3, n_added, N_WINDOWS, N_WINDOWS)))


class Recorder:
    """Wraps ``module.name`` to record what each call returns (through
    ``keep``) while the block runs."""

    def __init__(self, module, name, keep=lambda args, kwargs, out: out):
        self.module, self.name, self.keep, self.calls = module, name, keep, []
        self.original = getattr(module, name)

    def __enter__(self):
        def wrapped(*args, **kwargs):
            out = self.original(*args, **kwargs)
            self.calls.append(jax.device_get(self.keep(args, kwargs, out)))
            return out
        setattr(self.module, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def dagger_collect():
    from gan_mpc_tpu.envs import rollout
    from gan_mpc_tpu.runners.collect import collect_dagger_trajectories

    env, policy, params = tiny_policy(True, DAGGER_RESET_SCALE)
    norm = Normalizer.identity(env.obs_size, env.act_size)
    kw = dict(num_segments=5, segment_steps=8, policy_steps=6, policy_episodes=3,
              noise_sigma=0.25, history=1)
    out = {"params": jax.device_get(params), "kwargs": kw}
    for weighting in ("uniform", "reward_weighted"):
        key = jax.random.PRNGKey(7)
        with Recorder(rollout, "policy_rollout") as rolls, \
                Recorder(jax.random, "choice") as picks:
            trajs = collect_dagger_trajectories(env, env.default_params(), policy, params, norm,
                                                key, state_weighting=weighting, **kw)
        _, _, k_noise = jax.random.split(key, 3)
        noise = np.stack([np.stack([np.asarray(jax.random.normal(kk, (env.act_size,)))
                                    for kk in jax.random.split(k, kw["segment_steps"])])
                          for k in jax.random.split(k_noise, kw["num_segments"])], axis=1)
        out[weighting] = dict(
            reset_qpos=rolls[0].qpos[:, 0], reset_qvel=rolls[0].qvel[:, 0],
            rollout_states=rolls[0].states, rewards=rolls[0].rewards, picked=picks[0],
            noise=noise, trajs=trajs._asdict())
    return out


def dagger_round(config_path):
    from gan_mpc_tpu.config import Config
    from gan_mpc_tpu.data import windows
    from gan_mpc_tpu.runners import collect, gan, l2
    from gan_mpc_tpu.training import expert

    with open(config_path) as f:
        cfg = Config.from_dict(json.load(f))
    ctx = l2.setup(cfg, with_critic=True)
    params = ctx["params"]
    tcfg = cfg.mpc.train
    opts = {name: masked_adam(params, c.no_grads, c.learning_rate)[0]
            for name, c in (("cost", tcfg.cost), ("dynamics", tcfg.dynamics),
                            ("critic", tcfg.critic))}
    opt_states = {k: opt.init(params) for k, opt in opts.items()}

    class Metrics:
        rows = []

        def record(self, step, **values):
            self.rows.append(dict(step=step, **values))

    def perm(args, kwargs, out):
        n, length = args[0].shape[:2]
        return jax.random.permutation(args[3], n * (length - args[2]))

    with Recorder(collect, "collect_dagger_trajectories",
                  lambda a, k, out: out._asdict()) as segments, \
            Recorder(windows, "split_sequence_windows", perm) as perms, \
            Recorder(expert, "minibatch_indices") as minibatches, \
            Recorder(expert, "train_expert", lambda a, k, out: (out[0], out[3])) as tuned:
        metrics = Metrics()
        gan._dagger_rounds(cfg, ctx, params, opts, opt_states, ctx["replay"],
                           jax.random.PRNGKey(3), {}, metrics, None, float("-inf"), None)
    return dict(expert0=jax.device_get(params["expert_params"]), segments=segments[0],
                perms=perms, minibatches=minibatches, tuned=tuned[0][0],
                test_loss=tuned[0][1], rows=metrics.rows,
                normalizer={k: np.asarray(getattr(ctx["normalizer"], k))
                            for k in ("state_mean", "state_std", "action_mean", "action_std")})


def main():
    case, out_path = sys.argv[1], sys.argv[2]
    if case == "epochs":
        result = {"gan": one_epoch("gan"), "l2": one_epoch("l2")}
    elif case == "mesh_epochs":
        result = {f: one_epoch(f, mesh=True) for f in (sys.argv[3:] or ["gan", "l2"])}
    elif case == "ensemble_epoch":
        result = {"gan": one_epoch("gan", members=ENSEMBLE_MEMBERS)}
    elif case == "dagger":
        result = {"collect": dagger_collect(), "round": dagger_round(sys.argv[3])}
    else:
        raise SystemExit(f"unknown case {case!r}")
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main()
