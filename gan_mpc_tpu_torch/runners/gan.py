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

Not ported here, and refused by ``common.check_supported``: the fused
epochs (``runtime.fused_epochs``), DAgger rounds, video and data-parallel
runs; the dm_control cross-evaluation raises where JAX would run it
(``l2.dm_cross_eval``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
from gan_mpc_tpu_torch.runners import common, l2
from gan_mpc_tpu_torch.runners.common import phase_optimizers
from gan_mpc_tpu_torch.training.cost import train_cost
from gan_mpc_tpu_torch.training.critic import train_critic
from gan_mpc_tpu_torch.training.dynamics import train_dynamics
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
    best_eval = float("-inf")
    profile_dir = config.get_path("runtime.profile_dir")
    for epoch in range(start_epoch, config.mpc.train.num_epochs + 1):
        with profiler_trace(profile_dir if epoch == start_epoch else None), \
                metrics.timed("epoch", epoch):
            record = gan_epoch(ctx, opts, epoch, common.split(generator))
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
        best_eval = l2.midrun_eval(config, ctx, generator, epoch, metrics, best_eval, "gan",
                                   log_fn)
    return l2.finish_run(config, ctx, generator, history, metrics, ckpt, "gan", log_fn)


if __name__ == "__main__":
    import sys

    run(Config.from_yaml(sys.argv[1] if len(sys.argv) > 1 else "configs/gan_pendulum.yaml"))
