"""L2-MPC training run: from a config to a saved run.

Counterpart of ``gan_mpc_tpu/runners/l2.py``, the modular epoch loop: per
epoch the dynamics phase (on-policy), then the cost phase through the
planner's implicit gradient against the L2 loss to the expert's futures;
periodic evaluation that keeps the best checkpoints as candidates; at the
end the honest re-rank of the candidates (``select_best_params``), the
action-goal-gain calibration, the final and the fresh-seed evaluations,
and the saved run (``params.msgpack``, ``config.json``, the loss curves)
beside the metrics file ``<workdir>/metrics/<env>/l2.jsonl``. The GAN run
(``runners/gan.py``) shares all of it but the epoch.

    python -m gan_mpc_tpu_torch.runners.l2 <config.yaml>   # on the card

Randomness: one ``torch.Generator`` seeded from ``config.seed`` draws the
setup's splits, then, in a fixed order, one generator of its own per
epoch phase, periodic evaluation, selection, calibration and final
evaluation (``split``, the counterpart of ``jax.random.split``); its state
is checkpointed, so the same seed gives the same run and a resumed run
continues the uninterrupted one. The fresh-seed evaluation draws from a
generator of its own that the run never touches.

Parameters live in the policy. A candidate is a detached copy of every
component (``masking.policy_state``); evaluating one loads it into the
policy, and the selection leaves the winner there.

With ``runtime.fused_epochs`` the epochs are the fused ones
(``fused_epochs``, JAX's ``_run_fused_epochs``; ``training/fused_epoch.py``)
in place of the modular loop: the same checkpoints, evaluation and end,
the metrics under JAX's fused names and the ``[l2/fused]`` log lines. The
L2 run ignores ``expert_prediction.dagger``, as JAX's does.

At the end, ``dm_cross_eval`` rolls the policy in the real dm_control
task (``envs/dm_eval.py``; None where dm_control does not import) and,
with ``mpc.evaluate.save_video``, ``maybe_save_video`` renders one
evaluation episode into ``<run_dir>/video.mp4`` (a GIF where imageio has
no ffmpeg), as the JAX run does.

Differences from the JAX run: ``runtime.eval_chunk_steps`` is accepted and
the episode runs whole (JAX's chunked rollout is defined to be
bit-identical to the whole one); data-parallel runs are refused
(``common.check_supported``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.envs import dm_eval
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.params import to_jax_params
from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
from gan_mpc_tpu_torch.runners import common
from gan_mpc_tpu_torch.training.common import split
from gan_mpc_tpu_torch.training.calibrate import DEFAULT_GRID, calibrate_action_goal_gain
from gan_mpc_tpu_torch.training.cost import train_cost
from gan_mpc_tpu_torch.training.dynamics import _run_updates, train_dynamics
from gan_mpc_tpu_torch.training.fused_epoch import make_fused_gan_epoch, make_fused_l2_epoch
from gan_mpc_tpu_torch.training.masking import load_policy_state, policy_state
from gan_mpc_tpu_torch.utils import io, video
from gan_mpc_tpu_torch.utils.checkpoint import TrainCheckpointer
from gan_mpc_tpu_torch.utils.metrics import MetricsRecorder, profiler_trace

FRESH_EVAL_SEED = 987654321
L2_HISTORY = ("dynamics_train_losses", "cost_train_losses", "cost_test_losses",
              "episode_returns")


def checkpointer_for(config: Config, family: str) -> Optional[TrainCheckpointer]:
    every = config.get_path("runtime.checkpoint.every_epochs", 0)
    if not every:
        return None
    workdir = config.get_path("runtime.workdir", "runs")
    return TrainCheckpointer(os.path.join(workdir, "checkpoints", config.env.name, family),
                             keep=config.get_path("runtime.checkpoint.keep", 3), every=every)


def train_state(ctx: dict, opts: dict, generator: torch.Generator) -> dict:
    """Everything a run needs to continue bit for bit after its epoch."""
    replay = ctx["replay"]
    return {
        "params": policy_state(ctx["policy"]),
        "opt_states": {name: opt.state_dict() for name, opt in opts.items()},
        "replay": {"states": replay.states, "actions": replay.actions,
                   "next_states": replay.next_states, "ptr": replay.ptr, "size": replay.size},
        "generator": generator.get_state(),
    }


@torch.no_grad()
def restore_train_state(state: dict, ctx: dict, opts: dict, generator: torch.Generator) -> None:
    """Load a ``train_state`` into the live run (in place)."""
    load_policy_state(ctx["policy"], state["params"])
    for name, opt in opts.items():
        opt.load_state_dict(state["opt_states"][name])
    replay, saved = ctx["replay"], state["replay"]
    for name in ("states", "actions", "next_states"):
        getattr(replay, name).copy_(saved[name])
    replay.ptr, replay.size = int(saved["ptr"]), int(saved["size"])
    generator.set_state(state["generator"])


def maybe_resume(ckpt, ctx: dict, opts: dict, generator: torch.Generator, tag: str,
                 log_fn=None) -> int:
    """The first epoch to train: 1, or the one after the latest checkpoint,
    whose state is then loaded."""
    if ckpt is None or ckpt.latest_step() is None:
        return 1
    step = ckpt.latest_step()
    restore_train_state(ckpt.restore(step), ctx, opts, generator)
    if log_fn is not None:
        log_fn(f"[{tag}] resumed from checkpoint at epoch {step}")
    return step + 1


def note_candidate(ctx: dict, score: float, params: dict, k: int = 4,
                   config: Optional[Config] = None) -> None:
    """Keep the top-k periodically evaluated checkpoints (``policy_state``
    copies) as candidates for ``select_best_params``;
    ``mpc.evaluate.candidate_pool`` overrides k."""
    if config is not None:
        k = config.get_path("mpc.evaluate.candidate_pool", k)
    pool = ctx.setdefault("candidates", [])
    pool.append((float(score), params))
    pool.sort(key=lambda sp: -sp[0])
    del pool[k:]


def select_best_params(config: Config, ctx: dict, params: dict, generator: torch.Generator,
                       log_fn=None) -> dict:
    """Honest final model selection: re-evaluate the pooled candidates and
    ``params`` (the final ones) with ``mpc.evaluate.selection_episodes``
    episodes each and keep the winner, which is left loaded in the policy
    and returned. Without candidates (or with ``keep_best: false``)
    returns ``params``, the policy untouched."""
    pool = ctx.get("candidates") or []
    if not config.get_path("mpc.evaluate.keep_best", True) or not pool:
        return params
    cands = [p for _, p in pool] + [params]
    n_sel = config.get_path("mpc.evaluate.selection_episodes", None)
    scores = []
    for cand in cands:
        sub = split(generator)
        load_policy_state(ctx["policy"], cand)
        scores.append(evaluate(config, ctx, sub, num_runs=n_sel))
    best = max(range(len(scores)), key=scores.__getitem__)
    if log_fn is not None:
        log_fn("[select] honest re-rank of candidates: "
               + ", ".join(f"{s:.1f}" for s in scores) + f" -> keeping #{best}")
    load_policy_state(ctx["policy"], cands[best])
    return cands[best]


def dm_cross_eval(config: Config, ctx: dict, log_fn=None):
    """The final cross-check inside real dm_control (the reference's reward
    protocol): ``mpc.evaluate.dm_control_episodes`` episodes of
    ``mpc.evaluate.max_interactions`` steps of the policy's ``act`` in the
    suite task, the imitator's physics shift applied. Returns ``{"mean":
    ..., "episodes": [...]}`` rounded to 2 places, or None where the JAX
    run gives None: 0 episodes, dm_control not importable, or an env
    without a suite task."""
    episodes = config.get_path("mpc.evaluate.dm_control_episodes", 0)
    if not episodes:
        return None
    name = config.env.imitator.name
    if not dm_eval.dm_control_available() or not dm_eval.has_dm_counterpart(name):
        return None
    policy = ctx["policy"]

    @torch.no_grad()
    def act(hx, hu):
        return policy.act(hx[None], hu[None])[0]

    shifts = [dict(kv) for kv in (config.env.imitator.get_path("physics") or [])]
    mean_ret, per = dm_eval.evaluate_in_dm_control(
        name, act, ctx["normalizer"], history=config.mpc.history, num_episodes=episodes,
        max_steps=config.get_path("mpc.evaluate.max_interactions", 1000),
        physics_shifts=shifts)
    if log_fn is not None:
        log_fn(f"[dm_control] {name} mean {mean_ret:.1f} over {episodes} eps: "
               f"{[round(r, 1) for r in sorted(per)]}")
    return {"mean": round(mean_ret, 2), "episodes": [round(r, 2) for r in per]}


def video_episode(config: Config, ctx: dict, generator: Optional[torch.Generator] = None,
                  init_state=None):
    """The video's episode: one env for ``min(mpc.evaluate.max_interactions,
    300)`` control steps of the closed loop, from ``init_state`` where given,
    else a reset drawn from ``generator``."""
    steps = min(config.get_path("mpc.evaluate.max_interactions", 1000), 300)
    return policy_rollout(ctx["env_im"], ctx["env_im_params"], ctx["policy"], ctx["normalizer"],
                          num_steps=steps, history=config.mpc.history, num_envs=1,
                          init_state=init_state, generator=generator)


def maybe_save_video(config: Config, ctx: dict, run_dir: str,
                     generator: torch.Generator) -> Optional[str]:
    """With ``mpc.evaluate.save_video``: ``video_episode`` on the policy's
    device, its qpos rendered on the host (``utils/video.py``) into
    ``<run_dir>/video.mp4``, or a GIF beside it where imageio cannot write
    mp4. Returns the path written (None without the setting)."""
    if not config.get_path("mpc.evaluate.save_video", False):
        return None
    ep = video_episode(config, ctx, generator)
    frames = video.render_episode(ctx["env_im"].name, ep.qpos[0].cpu().numpy())
    return video.save_video(frames, os.path.join(run_dir, "video.mp4"))


def episode_returns(config: Config, ctx: dict, generator: Optional[torch.Generator],
                    num_runs: Optional[int] = None, init_state=None):
    """Per-episode returns (num_runs,) of one batched closed-loop rollout
    of ``mpc.evaluate.max_interactions`` steps on the imitator env, resets
    drawn from ``generator`` unless ``init_state`` is given; None for 0
    runs."""
    ecfg = config.mpc.evaluate
    num_runs = ecfg.num_runs_for_avg if num_runs is None else num_runs
    if num_runs <= 0:
        return None
    ep = policy_rollout(ctx["env_im"], ctx["env_im_params"], ctx["policy"], ctx["normalizer"],
                        num_steps=ecfg.max_interactions, history=config.mpc.history,
                        num_envs=max(num_runs, 1), init_state=init_state, generator=generator)
    return ep.rewards.sum(-1)


def evaluate(config: Config, ctx: dict, generator: torch.Generator,
             num_runs: Optional[int] = None) -> float:
    returns = episode_returns(config, ctx, generator, num_runs)
    return float(returns.mean()) if returns is not None else 0.0


def fresh_seed_eval(config: Config, ctx: dict, log_fn=None):
    """Held-out evaluation stamped next to ``reward``: the run's own stream
    has been consumed by the selection, so ``reward`` is selection-adjacent;
    this one draws from a generator seeded from (987654321, ``config.seed``)
    that the run never draws from, over ``mpc.evaluate.fresh_eval_episodes``
    (default 16; 0 disables)."""
    n = int(config.get_path("mpc.evaluate.fresh_eval_episodes", 16))
    if n <= 0:
        return None
    seed = np.random.SeedSequence([FRESH_EVAL_SEED, int(config.seed)]).generate_state(1)[0]
    returns = episode_returns(config, ctx, torch.Generator().manual_seed(int(seed)),
                              num_runs=n).cpu().numpy()
    eps = sorted(round(float(r), 2) for r in returns)
    mean, median = float(np.mean(returns)), float(np.median(returns))
    if log_fn is not None:
        log_fn(f"[fresh-eval] held-out {n}-episode eval: mean {mean:.1f} median {median:.1f} "
               f"(worst {eps[0]:.1f})")
    return {"mean": round(mean, 2), "median": round(median, 2), "num_episodes": n,
            "episodes": eps}


def calibrate_gain(config: Config, ctx: dict, generator: torch.Generator, log_fn=None):
    """The action-goal gain by state-moment matching
    (``training/calibrate.py``) where ``mpc.model.cost.calibrate_action_goal_gain``
    is set and the policy has an action-goal weight; every gain rolled out
    from the same start states (``num_runs_for_avg`` envs). Installs it in
    the policy and returns it (None where it does not run)."""
    ccfg = config.mpc.model.cost
    policy = ctx["policy"]
    if not ccfg.get_path("calibrate_action_goal_gain", False):
        return None
    if policy.cost_model.weights.shape[-1] < 4:
        return None
    ecfg = config.mpc.evaluate
    grid = ccfg.get_path("gain_grid") or DEFAULT_GRID
    device = policy.cost_model.weights.device
    # target moments from the raw demonstration states
    states = torch.tensor(ctx["trajs"].states, device=device)
    t_mean = states.mean(dim=(0, 1))
    t_std = states.std(dim=(0, 1), correction=0) + 1e-8
    env, env_params = ctx["env_im"], ctx["env_im_params"]
    n_envs = max(ecfg.num_runs_for_avg, 1)
    init = env.reset(env_params, n_envs, split(generator))

    def rollout_fn(p):
        return policy_rollout(env, env_params, p, ctx["normalizer"],
                              num_steps=ecfg.max_interactions, history=config.mpc.history,
                              num_envs=n_envs, init_state=init).states

    return calibrate_action_goal_gain(policy, rollout_fn, t_mean, t_std,
                                      grid=tuple(float(g) for g in grid), log=log_fn or print)


NO_BEST = (float("-inf"), None)


def midrun_eval(config: Config, ctx: dict, generator: torch.Generator, epoch: int, metrics,
                best: tuple, tag: str, log_fn=None) -> tuple:
    """The periodic evaluation after ``epoch`` (every
    ``mpc.evaluate.every_epochs``): records ``eval_reward`` and the
    solver's statistics, pools the params as a candidate. ``best`` is the
    best (score, params) so far (``NO_BEST`` at first); returns it updated,
    a later score that ties replacing an earlier one, as in JAX."""
    every = config.get_path("mpc.evaluate.every_epochs", 0)
    if not (every and epoch % every == 0):
        return best
    mid = evaluate(config, ctx, split(generator),
                   num_runs=config.get_path("mpc.evaluate.midrun_episodes", 3))
    metrics.record(epoch, eval_reward=mid)
    common.record_solver_stats(metrics, ctx["policy"], ctx["cost_data"][1], epoch)
    params = policy_state(ctx["policy"])
    if mid >= best[0]:
        best = (mid, params)
    note_candidate(ctx, mid, params, config=config)
    if log_fn is not None:
        log_fn(f"[{tag}] epoch {epoch} eval_reward {mid:.1f} (best {best[0]:.1f})")
    return best


# the fused epochs' metrics: field -> (history list, metrics-file name)
FUSED_RECORDS = {
    "l2": {"episode_return": ("episode_returns", "episode_return"),
           "dynamics_loss": ("dynamics_train_losses", "dynamics_train_loss"),
           "cost_loss": ("cost_train_losses", "cost_train_loss"),
           "cost_test_loss": ("cost_test_losses", "cost_test_loss")},
    "gan": {"episode_return": ("episode_returns", "episode_return"),
            "dynamics_loss": ("dynamics_train_losses", "dynamics_train_loss"),
            "critic_loss": ("critic_train_losses", "critic_train_loss"),
            "critic_test_loss": ("critic_test_losses", "critic_test_loss"),
            "generator_loss": ("cost_train_losses", "generator_train_loss"),
            "generator_test_loss": ("cost_test_losses", "generator_test_loss")},
}


def make_fused_epoch(config: Config, ctx: dict, opts: dict, family: str):
    """The config's fused epoch (``training/fused_epoch.py``) on the live
    run: the GAN epoch for ``family`` "gan", else the L2 epoch. Every minibatch has the cost phase's batch size; the critic
    plans ``min(critic.plan_batch or 64, N)`` of the N train histories."""
    tcfg = config.mpc.train
    ccfg, dcfg = tcfg.cost, tcfg.dynamics
    cost_train, cost_test = ctx["cost_data"]
    args = (ctx["policy"], ctx["env_im"], ctx["env_im_params"], ctx["normalizer"], opts,
            cost_train[0], cost_train[1])
    kwargs = dict(
        num_envs=config.get_path("runtime.num_parallel_envs", 1),
        episode_steps=dcfg.max_interactions_per_episode, history=config.mpc.history,
        dynamics_updates=dcfg.num_updates, cost_updates=ccfg.num_updates,
        batch_size=ccfg.batch_size, gamma=dcfg.discount_factor,
        polyak_factor=ccfg.polyak_factor, expert_history_X_test=cost_test[0],
        expert_future_Y_test=cost_test[1], expert_dyn_windows=ctx["dyn_train"],
        expert_dyn_updates=dcfg.get_path("expert_updates", 0),
        chunk_updates=config.get_path("runtime.fused_chunk_updates", 0),
        plan_chunk=config.get_path("runtime.fused_plan_chunk", 0),
        collect_noise=dcfg.get_path("collection_noise", 0.0),
        collect_chunk_steps=config.get_path("runtime.fused_collect_chunk", 0),
    )
    if family != "gan":
        return make_fused_l2_epoch(*args, **kwargs)
    qcfg = tcfg.critic
    return make_fused_gan_epoch(
        *args, critic_updates=qcfg.num_updates,
        critic_plan_batch=min(qcfg.get_path("plan_batch", 64), cost_train[0].shape[0]),
        **kwargs)


def fused_epochs(config: Config, ctx: dict, opts: dict, generator: torch.Generator,
                 history: dict, metrics, family: str, log_fn=None, ckpt=None,
                 start_epoch: int = 1) -> tuple:
    """The fused epoch loop (JAX's ``_run_fused_epochs``): at epoch 1 only,
    ``warm_start_updates`` dynamics passes on the expert windows (the
    dynamics batch size, teacher forced); then epochs ``start_epoch`` to
    ``num_epochs``, each one fused epoch with teacher forcing while epoch
    <= num_epochs * teacher_forcing_factor, its metrics appended to
    ``history`` and recorded, the run checkpointed (``ckpt``), and the
    periodic evaluation. Returns the best (score, params) of its
    evaluations (``NO_BEST`` without one)."""
    tcfg = config.mpc.train
    dcfg = tcfg.dynamics
    epoch_fn = make_fused_epoch(config, ctx, opts, family)
    warm = dcfg.get_path("warm_start_updates", 3)
    if start_epoch == 1 and warm > 0:
        _run_updates(ctx["policy"].dynamics_model, opts["dynamics"], ctx["dyn_train"], warm,
                     dcfg.batch_size, dcfg.discount_factor, 1.0, split(generator))
    records, tag = FUSED_RECORDS[family], f"{family}/fused"
    best = NO_BEST
    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        teacher_forcing = epoch <= tcfg.num_epochs * dcfg.teacher_forcing_factor
        m = epoch_fn(ctx["replay"], split(generator), teacher_forcing)._asdict()
        for field, (name, _) in records.items():
            history[name].append(m[field])
        metrics.record(epoch, **{key: m[field] for field, (_, key) in records.items()})
        if ckpt is not None:
            ckpt.maybe_save(epoch, train_state(ctx, opts, generator))
        if log_fn is not None:
            losses = (f"critic {m['critic_loss']:.5f} gen {m['generator_loss']:.5f}"
                      if family == "gan" else f"cost_loss {m['cost_loss']:.5f}")
            dyn = "dyn" if family == "gan" else "dyn_loss"
            log_fn(f"[{tag}] epoch {epoch} return {m['episode_return']:.1f} "
                   f"{dyn} {m['dynamics_loss']:.5f} {losses}")
        best = midrun_eval(config, ctx, generator, epoch, metrics, best, tag, log_fn)
    return best


def finish_run(config: Config, ctx: dict, generator: torch.Generator, history: dict, metrics,
               ckpt, family: str, log_fn=None) -> dict:
    """The end of a run: selection, calibration, the final, fresh and
    dm_control evaluations, the saved run and its video; then the
    checkpoints are cleared. Returns the run's result."""
    policy = ctx["policy"]
    select_best_params(config, ctx, policy_state(policy), split(generator), log_fn)
    calibrate_gain(config, ctx, split(generator), log_fn)
    avg_reward = evaluate(config, ctx, split(generator))
    fresh_result = fresh_seed_eval(config, ctx, log_fn)
    dm_result = dm_cross_eval(config, ctx, log_fn)

    run_dir = io.new_run_dir(common.imitator_model_dir(config, family))
    io.save_params(policy, os.path.join(run_dir, "params.msgpack"))

    def _last(name):  # curves can be empty (e.g. a 0-epoch resumed run)
        values = history[name]
        return round(values[-1], 5) if values else None

    loss = {"dynamics": {"train_loss": _last("dynamics_train_losses")},
            "cost": {"train_loss": _last("cost_train_losses"),
                     "test_loss": _last("cost_test_losses")}}
    if "critic_train_losses" in history:
        loss["critic"] = {"train_loss": _last("critic_train_losses"),
                          "test_loss": _last("critic_test_losses")}
    io.save_json({
        "seed": config.seed,
        "env": config.env.to_dict(),
        "reward": round(avg_reward, 2),
        "fresh_eval": fresh_result,
        "dm_control_reward": dm_result,
        "loss": loss,
        "policy": config.mpc.to_dict(),
        "expert_prediction": config.expert_prediction.to_dict(),
    }, os.path.join(run_dir, "config.json"))
    for name, values in history.items():
        io.save_json(values, os.path.join(run_dir, f"{name}.json"))
    maybe_save_video(config, ctx, run_dir, split(generator))
    metrics.close()
    if ckpt is not None:
        # a completed run leaves no resume state behind
        ckpt.clear()
        ckpt.close()
    if log_fn is not None:
        log_fn(f"[{family}] avg_reward {avg_reward:.2f} saved to {run_dir}")
    return {"params": to_jax_params(policy), "policy": policy, "run_dir": run_dir,
            "avg_reward": avg_reward, "history": history}


def metrics_recorder(config: Config, family: str) -> MetricsRecorder:
    return MetricsRecorder(os.path.join(config.get_path("runtime.workdir", "runs"), "metrics",
                                        config.env.name, f"{family}.jsonl"))


def run(config: Config, log_fn=print, device="cuda") -> dict:
    """Train an L2-MPC imitator from ``config`` and save the run, on the
    card unless ``device`` says otherwise."""
    common.check_supported(config)
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(config.seed)
    ctx = common.setup(config, with_critic=False, device=device, generator=generator)
    policy = ctx["policy"]
    tcfg = config.mpc.train
    ccfg, dcfg = tcfg.cost, tcfg.dynamics
    opts = common.phase_optimizers(ctx)
    history = {name: [] for name in L2_HISTORY}
    metrics = metrics_recorder(config, "l2")
    ckpt = checkpointer_for(config, "l2")
    start_epoch = maybe_resume(ckpt, ctx, opts, generator, "l2", log_fn)
    best = NO_BEST
    if config.get_path("runtime.fused_epochs", False):
        fused_epochs(config, ctx, opts, generator, history, metrics, "l2", log_fn, ckpt,
                     start_epoch)
        start_epoch = tcfg.num_epochs + 1  # no modular epoch
    profile_dir = config.get_path("runtime.profile_dir")
    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        k_dyn, k_cost = split(generator), split(generator)
        with profiler_trace(profile_dir if epoch == start_epoch else None), \
                metrics.timed("epoch", epoch):
            ctx["replay"], ep_returns, dyn_losses = train_dynamics(
                policy.dynamics_model, opts["dynamics"], ctx["dyn_train"], ctx["replay"],
                ctx["collect_fn"], ctx["normalizer"], num_episodes=dcfg.num_episodes,
                num_updates=dcfg.num_updates, batch_size=dcfg.batch_size,
                discount_factor=dcfg.discount_factor,
                teacher_forcing_factor=dcfg.teacher_forcing_factor, generator=k_dyn,
                epoch=epoch, warm_start_updates=dcfg.get_path("warm_start_updates", 3),
                expert_updates=dcfg.get_path("expert_updates", 0),
            )
            cost_losses, cost_tests = train_cost(
                policy, opts["cost"], ctx["cost_data"][0], ctx["cost_data"][1],
                l2_imitation_loss, num_updates=ccfg.num_updates, batch_size=ccfg.batch_size,
                polyak_factor=ccfg.polyak_factor, generator=k_cost,
                eval_windows=ccfg.get_path("eval_windows", None),
                max_steps_per_update=ccfg.get_path("steps_per_update", None),
            )
        history["dynamics_train_losses"] += dyn_losses
        history["cost_train_losses"] += cost_losses
        history["cost_test_losses"] += cost_tests
        history["episode_returns"] += ep_returns
        metrics.record(epoch, episode_return=ep_returns[-1], dynamics_train_loss=dyn_losses[-1],
                       cost_train_loss=cost_losses[-1],
                       cost_test_loss=cost_tests[-1] if cost_tests else 0.0)
        if ckpt is not None:
            ckpt.maybe_save(epoch, train_state(ctx, opts, generator))
        if log_fn is not None:
            log_fn(f"[l2] epoch {epoch} return {ep_returns[-1]:.1f} "
                   f"dyn_loss {dyn_losses[-1]:.5f} cost_loss {cost_losses[-1]:.5f}")
        best = midrun_eval(config, ctx, generator, epoch, metrics, best, "l2", log_fn)
    return finish_run(config, ctx, generator, history, metrics, ckpt, "l2", log_fn)


if __name__ == "__main__":
    import sys

    run(Config.from_yaml(sys.argv[1] if len(sys.argv) > 1 else "configs/l2_pendulum.yaml"))
