"""GAN-MPC training: the modular epoch.

Counterpart of the body of the modular epoch loop in
``gan_mpc_tpu/runners/gan.py`` (``run``): per epoch, the dynamics phase
(on-policy, with the collection noise of the config), then the critic
(discriminator on planned against expert futures), then the generator
(the cost trained through the planner's implicit gradient against the
critic), each with its own phase optimizer.

    ctx = common.setup(config, with_critic=True, trajectories_path=..., device=...)
    opts = phase_optimizers(ctx)
    record = gan_epoch(ctx, opts, epoch=1, generator=torch.Generator().manual_seed(0))

Not ported here: the rest of ``run`` (the fused epochs, checkpointing and
resumption, periodic evaluation and selection, DAgger rounds, video,
metrics files and the saved run).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
from gan_mpc_tpu_torch.training.cost import train_cost
from gan_mpc_tpu_torch.training.critic import train_critic
from gan_mpc_tpu_torch.training.dynamics import train_dynamics
from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components


def phase_optimizers(ctx: dict) -> dict:
    """The three phase optimizers of the config (``masked_adam`` with each
    phase's ``no_grads`` and learning rate; the cost phase's MPC weights at
    ``weights_learning_rate`` where set)."""
    tcfg = ctx["config"].mpc.train
    comps = policy_components(ctx["policy"])
    ccfg, dcfg, qcfg = tcfg.cost, tcfg.dynamics, tcfg.critic
    return {
        "cost": masked_adam(comps, ccfg.no_grads, ccfg.learning_rate,
                            weights_learning_rate=ccfg.get_path("weights_learning_rate")),
        "dynamics": masked_adam(comps, dcfg.no_grads, dcfg.learning_rate),
        "critic": masked_adam(comps, qcfg.no_grads, qcfg.learning_rate),
    }


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
