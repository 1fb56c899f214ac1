"""GAN-MPC training run: from a config to a saved run.

Counterpart of ``gan_mpc_tpu/runners/gan.py``, the modular epoch loop.
``gan_epoch`` is the loop's body: per epoch, the dynamics phase
(on-policy, with the collection noise of the config), then the critic
(discriminator on planned against expert futures), then the generator
(the cost trained through the planner's implicit gradient against the
critic), each with its own phase optimizer. ``run`` wraps it as the L2
run (``runners/l2.py``) wraps its own epoch: periodic evaluation and
candidates, checkpoint and resume, the honest re-rank, the gain
calibration, the final and fresh-seed evaluations, the metrics file
``<workdir>/metrics/<env>/gan.jsonl`` and the saved run.

    python -m gan_mpc_tpu_torch.runners.gan <config.yaml>   # on the card

    ctx = common.setup(config, with_critic=True, device=...)
    opts = phase_optimizers(ctx)
    record = gan_epoch(ctx, opts, epoch=1, generator=torch.Generator().manual_seed(0))

With ``runtime.fused_epochs`` the epochs are the fused ones
(``l2.fused_epochs`` with the fused GAN epoch of
``training/fused_epoch.py``), then the DAgger rounds of
``expert_prediction.dagger`` (``dagger_rounds``), as in JAX, where they
run in the fused branch only: the modular run ignores them.

The end (``l2.finish_run``) is the L2 run's: the dm_control
cross-evaluation and the video included. Not ported here, and refused by
``common.check_supported``: data-parallel runs.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data.windows import split_sequence_windows
from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
from gan_mpc_tpu_torch.runners import common, l2
from gan_mpc_tpu_torch.runners.collect import collect_dagger_trajectories
from gan_mpc_tpu_torch.runners.common import phase_optimizers
from gan_mpc_tpu_torch.training.common import split
from gan_mpc_tpu_torch.training.cost import train_cost
from gan_mpc_tpu_torch.training.critic import train_critic
from gan_mpc_tpu_torch.training.dynamics import train_dynamics
from gan_mpc_tpu_torch.training.expert import train_expert
from gan_mpc_tpu_torch.training.masking import ClippedAdam, load_policy_state, policy_state
from gan_mpc_tpu_torch.utils.metrics import profiler_trace

GAN_HISTORY = ("dynamics_train_losses", "critic_train_losses", "critic_test_losses",
               "cost_train_losses", "cost_test_losses", "episode_returns")


def gan_epoch(ctx: dict, opts: dict, epoch: int,
              generator: torch.Generator) -> Dict[str, List[float]]:
    """One modular GAN epoch on the live objects of ``common.setup``
    (updated in place: the policy, the replay buffer, the optimizers).
    Returns the epoch's records under the JAX runner's history names."""
    config, policy = ctx["config"], ctx["policy"]
    tcfg = config.mpc.train
    ccfg, dcfg, qcfg = tcfg.cost, tcfg.dynamics, tcfg.critic
    cost_train, cost_test = ctx["cost_data"]

    ctx["replay"], ep_returns, dyn_losses = train_dynamics(
        policy.dynamics_model, opts["dynamics"], ctx["dyn_train"], ctx["replay"],
        ctx["collect_fn"], ctx["normalizer"],
        num_episodes=dcfg.num_episodes, num_updates=dcfg.num_updates,
        batch_size=dcfg.batch_size, discount_factor=dcfg.discount_factor,
        teacher_forcing_factor=dcfg.teacher_forcing_factor, generator=generator,
        epoch=epoch, warm_start_updates=dcfg.get_path("warm_start_updates", 3),
        expert_updates=dcfg.get_path("expert_updates", 0),
    )
    critic_losses, critic_tests = train_critic(
        policy, opts["critic"], cost_train, cost_test, num_updates=qcfg.num_updates,
        batch_size=qcfg.batch_size, generator=generator,
        plan_batch=qcfg.get_path("plan_batch", 256),
    )
    # the GAN loss reads no targets; passing them keeps the reference's
    # minibatch stream
    gen_losses, gen_tests = train_cost(
        policy, opts["cost"], cost_train, cost_test, gan_generator_loss,
        num_updates=ccfg.num_updates, batch_size=ccfg.batch_size,
        polyak_factor=ccfg.polyak_factor, generator=generator, has_targets=True,
        eval_windows=ccfg.get_path("eval_windows", None),
        max_steps_per_update=ccfg.get_path("steps_per_update", None),
    )
    return {
        "episode_returns": ep_returns,
        "dynamics_train_losses": dyn_losses,
        "critic_train_losses": critic_losses,
        "critic_test_losses": critic_tests,
        "cost_train_losses": gen_losses,
        "cost_test_losses": gen_tests,
    }


def dagger_rounds(config: Config, ctx: dict, opts: dict, generator: torch.Generator,
                  history: dict, metrics, best: tuple, log_fn=None) -> tuple:
    """The DAgger rounds of ``expert_prediction.dagger`` (JAX's
    ``_dagger_rounds``). Each round loads the best evaluated params so far
    (where there are any), collects the scripted expert's corrective
    segments from states the policy visits
    (``collect.collect_dagger_trajectories``), fine-tunes the expert
    predictor on the base store's windows (with ``start_oversample``) and
    the segments' (train splits joined, test splits joined) with a fresh
    clip-100 Adam at ``finetune_lr`` for ``finetune_epochs``, teacher
    forced, and records ``dagger_round`` and ``dagger_test_loss``; then
    ``extra_epochs`` fused epochs (no warm start, no checkpoint) whose best
    evaluation competes with ``best``, or, without extra epochs, one
    evaluation that does. Returns the best (score, params)."""
    dag = config.get_path("expert_prediction.dagger")
    if dag is None or dag.get_path("rounds", 0) <= 0:
        return best
    tcfg = config.expert_prediction.train
    policy, norm, trajs = ctx["policy"], ctx["normalizer"], ctx["trajs"]
    device = policy.cost_model.weights.device
    normalized = lambda t: (norm.normalize_state(torch.tensor(t.states, device=device)),
                            norm.normalize_action(torch.tensor(t.actions, device=device)))
    base_states, base_actions = normalized(trajs)
    expert = policy.expert_model
    for rnd in range(1, dag.get_path("rounds", 0) + 1):
        k_col, k_win, k_ft = split(generator), split(generator), split(generator)
        if best[1] is not None:
            load_policy_state(policy, best[1])
        dtrajs = collect_dagger_trajectories(
            ctx["env"], ctx["env"].default_params(), policy, norm, k_col,
            num_segments=dag.get_path("num_segments", 256),
            segment_steps=dag.get_path("segment_steps", 120),
            policy_steps=config.get_path("mpc.evaluate.max_interactions", 1000),
            policy_episodes=dag.get_path("policy_episodes", 8),
            noise_sigma=config.get_path("env.expert_noise", 0.25),
            history=config.mpc.history, imitator_env=ctx["env_im"],
            imitator_env_params=ctx["env_im_params"],
            state_weighting=dag.get_path("state_weighting", "uniform"),
            weight_power=dag.get_path("weight_power", 2.0),
            weight_floor=dag.get_path("weight_floor", 0.05))
        base_train, base_test = split_sequence_windows(
            base_states, base_actions, tcfg.seqlen, k_win,
            start_oversample=tcfg.get_path("start_oversample", 20))
        seg_train, seg_test = split_sequence_windows(*normalized(dtrajs), tcfg.seqlen,
                                                     split(k_win))
        train_data = tuple(torch.cat([a, b]) for a, b in zip(base_train, seg_train))
        test_data = tuple(torch.cat([a, b]) for a, b in zip(base_test, seg_test))
        expert.requires_grad_(True)
        try:
            _, ft_test = train_expert(
                expert, ClippedAdam([(expert.parameters(), dag.get_path("finetune_lr", 5e-5))]),
                train_data, test_data, num_epochs=dag.get_path("finetune_epochs", 6),
                batch_size=tcfg.batch_size, generator=k_ft,
                discount_factor=tcfg.discount_factor, teacher_forcing_factor=1.0, log_fn=None)
        finally:
            expert.requires_grad_(False)
        metrics.record(rnd, dagger_round=rnd, dagger_test_loss=ft_test)
        if log_fn is not None:
            log_fn(f"[gan/dagger] round {rnd}: {dtrajs.states.shape[0]} corrective segments, "
                   f"predictor test loss {ft_test:.5f}")
        extra = dag.get_path("extra_epochs", 10)
        if extra > 0:
            more = config.replace(mpc__train__num_epochs=extra,
                                  mpc__train__dynamics__warm_start_updates=0)
            extra_best = l2.fused_epochs(more, ctx, opts, generator, history, metrics, "gan",
                                         log_fn)
            if extra_best[0] >= best[0]:
                best = extra_best
        else:
            # no continuation: the refreshed predictor stands on its own
            mid = l2.evaluate(config, ctx, split(generator),
                              num_runs=config.get_path("mpc.evaluate.midrun_episodes", 3))
            params = policy_state(policy)
            if mid >= best[0]:
                best = (mid, params)
            l2.note_candidate(ctx, mid, params, config=config)
    return best


def run(config: Config, log_fn=print, device="cuda") -> dict:
    """Train a GAN-MPC imitator from ``config`` and save the run, on the
    card unless ``device`` says otherwise."""
    common.check_supported(config)
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(config.seed)
    ctx = common.setup(config, with_critic=True, device=device, generator=generator)
    opts = phase_optimizers(ctx)
    history = {name: [] for name in GAN_HISTORY}
    metrics = l2.metrics_recorder(config, "gan")
    ckpt = l2.checkpointer_for(config, "gan")
    start_epoch = l2.maybe_resume(ckpt, ctx, opts, generator, "gan", log_fn)
    best = l2.NO_BEST
    if config.get_path("runtime.fused_epochs", False):
        best = l2.fused_epochs(config, ctx, opts, generator, history, metrics, "gan", log_fn,
                               ckpt, start_epoch)
        dagger_rounds(config, ctx, opts, generator, history, metrics, best, log_fn)
        start_epoch = config.mpc.train.num_epochs + 1  # no modular epoch
    profile_dir = config.get_path("runtime.profile_dir")
    for epoch in range(start_epoch, config.mpc.train.num_epochs + 1):
        with profiler_trace(profile_dir if epoch == start_epoch else None), \
                metrics.timed("epoch", epoch):
            record = gan_epoch(ctx, opts, epoch, split(generator))
        for name, values in record.items():
            history[name] += values
        metrics.record(epoch, episode_return=record["episode_returns"][-1],
                       dynamics_train_loss=record["dynamics_train_losses"][-1],
                       critic_train_loss=record["critic_train_losses"][-1],
                       generator_train_loss=record["cost_train_losses"][-1])
        if ckpt is not None:
            ckpt.maybe_save(epoch, l2.train_state(ctx, opts, generator))
        if log_fn is not None:
            log_fn(f"[gan] epoch {epoch} return {record['episode_returns'][-1]:.1f} "
                   f"dyn {record['dynamics_train_losses'][-1]:.5f} "
                   f"critic {record['critic_train_losses'][-1]:.5f} "
                   f"gen {record['cost_train_losses'][-1]:.5f}")
        best = l2.midrun_eval(config, ctx, generator, epoch, metrics, best, "gan", log_fn)
    return l2.finish_run(config, ctx, generator, history, metrics, ckpt, "gan", log_fn)


if __name__ == "__main__":
    import sys

    run(Config.from_yaml(sys.argv[1] if len(sys.argv) > 1 else "configs/gan_pendulum.yaml"))
