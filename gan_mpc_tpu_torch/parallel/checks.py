"""Rank entry points that run one piece of the data-parallel path from
plain data (configs as dicts, JAX-layout parameter trees, numpy arrays),
on one rank per device (``parallel/launch.py``) or in one process: the
CPU tests hold them against the JAX package's steps and the smoke script
against the single-process run on the card.

  * ``fused_epoch_case(device, case, mesh_size)``: a policy rebuilt from
    a config and a parameter tree, the phase optimizers (with their
    states where the snapshot has them), the normalizer, the expert
    windows and the draws; one fused epoch with a mesh of ``mesh_size``
    ranks (none for 1); the metrics, the parameters, the replay's windows
    and the kernel launches;
  * ``sharded_steps_case(device, case, mesh_size)``: each sharded step of
    ``parallel/sharded.py`` once from fresh parameters (the dynamics step
    also over both axes of a hybrid mesh), the loss and the parameters
    after it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gan_mpc_tpu_torch.parallel import launch
from gan_mpc_tpu_torch.parallel.mesh import data_axes, make_hybrid_mesh, make_mesh, shard_batch


def _tensors(d, device, keys=None):
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in d.items()
            if keys is None or k in keys}


def fused_epoch_case(device, case: dict, mesh_size: int = 1) -> dict:
    """One fused epoch from the snapshot ``case`` (plain data): ``family``
    ("gan" or "l2"), ``config`` (a ``Config`` dict: the policy's widths,
    the env, the phase optimizers), ``sizes`` (x, u), ``params`` (a JAX
    tree), optionally ``opt_states`` ({phase: state_dict}) and
    ``normalizer`` (its four arrays; default identity), ``data`` (exp_X,
    exp_Y, test_X, test_Y, and dyn, the expert's (X, U, Y) windows),
    ``replay_capacity``, ``kwargs`` of the epoch, ``draws`` (``FusedDraws``
    fields as arrays, reset as reset_qpos, reset_qvel, reset_t) and
    ``teacher_forcing``. With ``mesh_size`` > 1 (inside ranks of that
    many) the epoch runs in mesh mode. Returns {"metrics", "params" (JAX
    tree), "replay" (the filled windows and size), "launches"}."""
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs.base import EnvState
    from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_kernel
    from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_backward, fused_mlp_forward
    from gan_mpc_tpu_torch.params import from_jax_params, to_jax_params
    from gan_mpc_tpu_torch.runners import common
    from gan_mpc_tpu_torch.training.fused_epoch import (
        FusedDraws, make_fused_gan_epoch, make_fused_l2_epoch)

    device = torch.device(device)
    gan = case["family"] == "gan"
    config = Config.from_dict(case["config"])
    x, u = case["sizes"]
    policy = common.build_policy(config, x, u, gan, device)
    from_jax_params(case["params"], policy)
    opts = common.phase_optimizers({"config": config, "policy": policy})
    for name, state in (case.get("opt_states") or {}).items():
        opts[name].load_state_dict(state)
    norm = Normalizer(**_tensors(case["normalizer"], device)) if case.get("normalizer") \
        else Normalizer.identity(x, u, device)
    env, env_params = common.imitator_env(config, device)
    data = _tensors(case["data"], device, ("exp_X", "exp_Y", "test_X", "test_Y"))
    dyn = tuple(torch.as_tensor(np.asarray(a)).to(device) for a in case["data"]["dyn"])
    d = case["draws"]
    perms = {k: torch.as_tensor(np.asarray(d[k])).long() for k in
             ("dyn_perm", "exp_perm", "plan_idx", "shuffle", "crit_perm", "cost_perm") if k in d}
    draws = FusedDraws(
        reset=EnvState(*(torch.as_tensor(np.asarray(d[k])).to(device)
                         for k in ("reset_qpos", "reset_qvel", "reset_t"))),
        noise=torch.as_tensor(np.asarray(d["noise"])).to(device) if "noise" in d else None,
        **perms)
    mesh = make_mesh(mesh_size) if mesh_size > 1 else None
    make = make_fused_gan_epoch if gan else make_fused_l2_epoch
    epoch = make(policy, env, env_params, norm, opts, data["exp_X"], data["exp_Y"],
                 expert_history_X_test=data.get("test_X"),
                 expert_future_Y_test=data.get("test_Y"), expert_dyn_windows=dyn, mesh=mesh,
                 **case["kwargs"])
    replay = ReplayBuffer.create(case["replay_capacity"], config.mpc.horizon, x, u, device)
    kernels = {"fused_mlp_fwd": fused_mlp_forward, "fused_mlp_bwd": fused_mlp_backward,
               "fused_ls_step": fused_ls_kernel}
    for k in kernels.values():
        k.launches = 0
    metrics = epoch(replay, torch.Generator(), case["teacher_forcing"], draws)
    n = replay.size
    return {"metrics": metrics._asdict(), "params": to_jax_params(policy),
            "replay": {"states": replay.states[:n].cpu().numpy(),
                       "actions": replay.actions[:n].cpu().numpy(),
                       "next_states": replay.next_states[:n].cpu().numpy(), "size": n},
            "launches": {name: k.launches for name, k in kernels.items()}}


def fused_epoch_on_ranks(case: dict, devices: Sequence, timeout: Optional[float] = None) -> dict:
    """``fused_epoch_case`` in mesh mode on one rank per entry of
    ``devices``; rank 0's result (every rank's is the same but for the
    launches, which count each rank's own)."""
    return launch.spawn(fused_epoch_case, list(devices), (case, len(devices)), timeout)


def _case_policy(case: dict, device):
    """The policy of ``case["config"]`` at ``case["sizes"]`` with the
    parameter tree ``case["params"]`` (its critic where the tree has
    one)."""
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.params import from_jax_params
    from gan_mpc_tpu_torch.runners import common

    x, u = case["sizes"]
    policy = common.build_policy(Config.from_dict(case["config"]), x, u,
                                 "critic_params" in case["params"], device)
    return from_jax_params(case["params"], policy)


def sharded_steps_case(device, case: dict, mesh_size: int = 1) -> dict:
    """Each step named in ``case`` from fresh parameters, data parallel over
    ``mesh_size`` ranks (each takes its block of the global batch):
    "cost", "dynamics", "critic" (the policy's steps with ``masked_adam``
    over all but ``no_grads`` at ``lr``), "collect" (the policy's
    ``act_batch`` from the global start states), "dp_tp" and "tp_apply"
    (a residual MLP of ``hidden`` from its own tree, Adam at ``lr``, tp 2
    where the mesh has an even number of ranks), "hybrid" (that MLP's step
    over both axes of ``make_hybrid_mesh(dcn_size=dcn)``, ``masked_adam``
    at ``lr``), "ensemble" (one member per rank, Adam at ``lr``). Returns {step: {"loss", "params"} or the collected
    states or the two forwards}."""
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.envs.base import EnvState
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
    from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
    from gan_mpc_tpu_torch.ops.fused_mlp import reference_forward
    from gan_mpc_tpu_torch.params import (
        dynamics_from_jax_params, dynamics_to_jax_params, to_jax_params)
    from gan_mpc_tpu_torch.parallel import sharded
    from gan_mpc_tpu_torch.policies.losses import gan_generator_loss, l2_imitation_loss
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    device = torch.device(device)
    mesh = make_mesh(mesh_size)
    x, u = case["sizes"]
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731
    out = {"mesh": {"shape": mesh.shape, "coords": mesh.coords}}

    def policy_step(name, make_step, keys, *extra):
        """``make_step(policy, opt)`` on this rank's block of ``keys``."""
        spec = case[name]
        policy = _case_policy(case, device)
        opt = masked_adam(policy_components(policy), spec["no_grads"], spec["lr"])
        data = shard_batch(tuple(t(spec[k]) for k in keys), mesh)
        loss = make_step(policy, opt)(*data, *extra)
        return {"loss": float(loss), "params": to_jax_params(policy)}

    if "cost" in case:
        loss_fn = {"l2": l2_imitation_loss, "gan": gan_generator_loss}[case["cost"]["loss"]]
        out["cost"] = policy_step("cost", lambda p, o: sharded.make_sharded_cost_step(
            p, o, mesh, loss_fn), ("X", "Y"))
    if "dynamics" in case:
        spec = case["dynamics"]
        out["dynamics"] = policy_step("dynamics", lambda p, o: sharded.make_sharded_dynamics_step(
            p.dynamics_model, o, mesh, spec["gamma"]), ("X", "U", "Y"), spec["teacher_forcing"])
    if "critic" in case:
        out["critic"] = policy_step("critic", lambda p, o: sharded.make_sharded_critic_step(
            p, o, mesh), ("seqs", "labels"))
    if "collect" in case:
        spec = case["collect"]
        policy = _case_policy(case, device)
        env = make_env(case["config"]["env"]["name"], device)
        n = spec["reset_qpos"].shape[0]
        collect = sharded.make_sharded_collect(
            env, env.default_params(), policy.act_batch, Normalizer.identity(x, u, device),
            mesh, spec["num_steps"], spec["history"], n // mesh.size)
        with torch.no_grad():
            ep = collect(EnvState(t(spec["reset_qpos"]), t(spec["reset_qvel"]),
                                  t(spec["reset_t"])))
        out["collect"] = {"states": ep.states.cpu().numpy(), "rewards": ep.rewards.cpu().numpy()}
    if "dp_tp" in case:
        spec = case["dp_tp"]
        tp = 2 if mesh_size % 2 == 0 else 1
        mesh2 = make_mesh(mesh_size, ("dp", "tp"), (mesh_size // tp, tp))
        model = LearnedDynamics(ResidualMLPDynamicsNet(x, u, tuple(spec["hidden"]))).to(device)
        dynamics_from_jax_params(spec["params"], model)
        with torch.no_grad():
            z = t(spec["z"])
            out["tp_apply"] = {
                "tp": sharded.tp_mlp_apply(z, model.net.stack(), mesh2, "tp").cpu().numpy(),
                "whole": reference_forward(z, model.net.stack()).cpu().numpy()}
        model.requires_grad_(True)
        opt = torch.optim.Adam(model.parameters(), lr=spec["lr"])
        loss = sharded.make_dp_tp_dynamics_step(model, opt, mesh2, spec["gamma"])(
            t(spec["X"]), t(spec["U"]), t(spec["Y"]), True)
        out["dp_tp"] = {"loss": float(loss), "params": dynamics_to_jax_params(model)}
    if "hybrid" in case:
        spec = case["hybrid"]
        hybrid = make_hybrid_mesh(dcn_size=spec["dcn"])
        axes = data_axes(hybrid)
        model = LearnedDynamics(ResidualMLPDynamicsNet(x, u, tuple(spec["hidden"]))).to(device)
        dynamics_from_jax_params(spec["params"], model)
        opt = masked_adam({"dynamics_params": list(model.parameters())}, [], spec["lr"])
        data = shard_batch(tuple(t(spec[k]) for k in ("X", "U", "Y")), hybrid, axes)
        loss = sharded.make_sharded_dynamics_step(model, opt, hybrid, spec["gamma"], axes)(
            *data, True)
        out["hybrid"] = {"shape": hybrid.shape, "axes": axes, "loss": float(loss),
                         "params": dynamics_to_jax_params(model)}
    if "ensemble" in case:
        spec = case["ensemble"]
        ep_mesh = make_mesh(mesh_size, ("ep",))
        ens = EnsembleDynamics([ResidualMLPDynamicsNet(x, u, tuple(spec["hidden"]))
                                for _ in range(spec["members"])]).to(device)
        dynamics_from_jax_params(spec["params"], ens)
        ens.requires_grad_(True)
        opt = torch.optim.Adam(ens.parameters(), lr=spec["lr"])
        loss = sharded.make_sharded_ensemble_step(ens, opt, ep_mesh, spec["gamma"])(
            t(spec["Xm"]), t(spec["Um"]), t(spec["Ym"]), True)
        sharded.gather_members(ens, ep_mesh)
        out["ensemble"] = {"loss": float(loss), "params": dynamics_to_jax_params(ens)}
    return out


def sharded_steps_on_ranks(case: dict, devices: Sequence, timeout: Optional[float] = None):
    """``sharded_steps_case`` on one rank per entry of ``devices``: rank
    0's result."""
    return launch.spawn(sharded_steps_case, list(devices), (case, len(devices)), timeout)
