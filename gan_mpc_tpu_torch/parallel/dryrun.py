"""``dryrun_multichip``: one tiny GAN-MPC training step of every sharded
kind over n ranks.

``dryrun_multichip(n, devices)`` is the counterpart of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:115-303``):
the same seven phases at the same tiny shapes (a pendulum-sized policy,
H=3, iLQR <= 3, 2 envs and 2 rows per device): sharded collection; the
dynamics, critic and generator steps; the ensemble over "ep"; dp x tp;
the fused GAN epoch in mesh mode. It prints JAX's line and returns the
losses. ``devices`` (default ``cuda:0..n-1``) may repeat a card or name
the CPU, as tests and the smoke script do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from gan_mpc_tpu_torch.parallel import launch
from gan_mpc_tpu_torch.parallel.mesh import default_devices, make_mesh, shard_batch

H, ITERS, HISTORY = 3, 3, 1


def _tiny_policy(device):
    """The JAX dryrun's tiny policy at the pendulum's sizes (``_flagship(
    horizon=3, max_iterations=3, tiny=True)``), flax-style weights from
    seed 0."""
    from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
    from gan_mpc_tpu_torch.models.critic import SequenceCritic
    from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
    from gan_mpc_tpu_torch.models.expert import ExpertPredictor
    from gan_mpc_tpu_torch.params import init_flax_like
    from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
    from gan_mpc_tpu_torch.policies.mpc import MPCPolicy

    x, u = 3, 1
    policy = MPCPolicy(
        MPCCost(CostFeatureNet(x, (16,), 4), H, mpc_weights=(-2.0, 3.0, -3.0)),
        LearnedDynamics(ResidualMLPDynamicsNet(x, u, (16,))),
        ExpertPredictor(x, u, arch="lstm", features=8, hidden=(16,)),
        SequenceCritic(x, 8, (16,)),
        horizon=H, settings=SolverSettings(max_iterations=ITERS))
    init_flax_like(policy, torch.Generator().manual_seed(0))
    return policy.requires_grad_(False).to(device), x, u


def dryrun_rank(device: torch.device, n: int) -> dict:
    """One rank of ``dryrun_multichip`` (inside a group of ``n`` ranks): the
    seven phases; the losses."""
    from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.models.dynamics import ResidualMLPDynamicsNet
    from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
    from gan_mpc_tpu_torch.params import init_flax_like
    from gan_mpc_tpu_torch.parallel import sharded
    from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
    from gan_mpc_tpu_torch.training.fused_epoch import make_fused_gan_epoch
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    mesh = make_mesh(n)
    policy, x, u = _tiny_policy(device)
    batch = 2 * n
    gen = torch.Generator().manual_seed(0)

    def normal(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device)

    # 1: on-policy collection, envs sharded over the mesh
    env = make_env("pendulum_swingup", device)
    params = env.default_params()
    norm = Normalizer.identity(x, u, device)
    collect = sharded.make_sharded_collect(env, params, policy.act_batch, norm, mesh,
                                           num_steps=4, history=HISTORY, envs_per_device=2)
    with torch.no_grad():
        episodes = collect(env.reset(params, batch, gen))
    if tuple(episodes.states.shape) != (batch, 4, x):
        raise RuntimeError(f"sharded collection gave states {tuple(episodes.states.shape)}")

    # 2: dynamics update on windows
    comps = policy_components(policy)
    others = ["mpc_weights", "cost_params", "dynamics_params", "critic_params", "expert_params"]
    dyn_opt = masked_adam(comps, [c for c in others if c != "dynamics_params"], 1e-4)
    Xw, Uw, Yw = normal(batch, H, x), normal(batch, H, u), normal(batch, H, x)
    dyn_loss = sharded.make_sharded_dynamics_step(policy.dynamics_model, dyn_opt, mesh, 0.9)(
        *shard_batch((Xw, Uw, Yw), mesh), True)

    # 3: critic update on labelled sequences
    critic_opt = masked_adam(comps, [c for c in others if c != "critic_params"], 1e-4)
    seqs = normal(batch, H + 1, x)
    labels = torch.where(torch.arange(batch, device=device) % 2 == 0, 1.0, -1.0)
    critic_loss = sharded.make_sharded_critic_step(policy, critic_opt, mesh)(
        *shard_batch((seqs, labels), mesh))

    # 4: bilevel generator update through the planner
    cost_opt = masked_adam(comps, ["dynamics_params", "critic_params", "expert_params"], 1e-5)
    hX, tY = normal(batch, HISTORY + 1, x, scale=0.1), normal(batch, H + 1, x, scale=0.1)
    gen_loss = sharded.make_sharded_cost_step(policy, cost_opt, mesh, gan_generator_loss)(
        *shard_batch((hX, tY), mesh))

    # 5: ensemble dynamics over "ep", one member per device
    ep_mesh = make_mesh(n, axis_names=("ep",))
    ens = EnsembleDynamics([ResidualMLPDynamicsNet(x, u, (16,)) for _ in range(n)])
    init_flax_like(ens, torch.Generator().manual_seed(1))
    ens = ens.to(device)
    ens_opt = torch.optim.Adam(ens.parameters(), lr=1e-3)
    ens_loss = sharded.make_sharded_ensemble_step(ens, ens_opt, ep_mesh, 0.9)(
        normal(n, 2, H, x), normal(n, 2, H, u), normal(n, 2, H, x), True)
    sharded.gather_members(ens, ep_mesh)

    # 6: hybrid dp x tp dynamics step
    tp = 2 if n % 2 == 0 else 1
    mesh2 = make_mesh(n, axis_names=("dp", "tp"), shape=(n // tp, tp))
    tp_loss = sharded.make_dp_tp_dynamics_step(policy.dynamics_model, dyn_opt, mesh2, 0.9)(
        Xw, Uw, Yw, True)

    # 7: the fused GAN epoch in mesh mode
    opts = {"dynamics": dyn_opt, "critic": critic_opt, "cost": cost_opt}
    fused = make_fused_gan_epoch(
        policy, env, params, norm, opts, hX, tY, num_envs=n, episode_steps=4,
        history=HISTORY, dynamics_updates=1, critic_updates=1, cost_updates=1, batch_size=n,
        gamma=0.9, polyak_factor=0.9, critic_plan_batch=n, mesh=mesh)
    replay = ReplayBuffer.create(32, H, x, u, device)
    metrics = fused(replay, torch.Generator().manual_seed(3), True)

    losses = {"dynamics": float(dyn_loss), "critic": float(critic_loss),
              "generator": float(gen_loss), "ensemble": float(ens_loss),
              "dp_tp_dynamics": float(tp_loss),
              "fused_epoch_generator": float(metrics.generator_loss)}
    for name, value in losses.items():
        if not math.isfinite(value):
            raise RuntimeError(f"dryrun_multichip: {name} loss is {value}")
    if replay.size <= 0:
        raise RuntimeError("the fused mesh epoch inserted no episodes")
    return losses


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     timeout: Optional[float] = None) -> dict:
    """One tiny GAN-MPC training step of every sharded kind over
    ``n_devices`` ranks (module docstring); prints JAX's line, returns
    the losses."""
    devices = default_devices(n_devices) if devices is None else list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for dryrun_multichip({n_devices})")
    losses = launch.spawn(dryrun_rank, devices, (n_devices,), timeout)
    print(dryrun_line(n_devices, losses), flush=True)
    return losses


def dryrun_line(n_devices: int, losses: dict) -> str:
    """JAX's line for ``dryrun_multichip(n_devices)``'s losses."""
    return (f"dryrun_multichip({n_devices}) ok: "
            f"dyn {losses['dynamics']:.4f} critic {losses['critic']:.4f} "
            f"gen {losses['generator']:.4f} ensemble {losses['ensemble']:.4f} "
            f"dp_tp {losses['dp_tp_dynamics']:.4f} "
            f"fused_gen {losses['fused_epoch_generator']:.4f}")
