"""Data-parallel training and collection steps.

Counterpart of ``gan_mpc_tpu/parallel/sharded.py``. There each step is a
``shard_map`` program: every device runs its shard, the parameters are
replicated, and gradients and losses are ``pmean``-reduced over the
mesh's axis. Here every rank runs the step on its own rows, with the
parameters replicated in its modules: backward, the gradients averaged
over the axis (``mesh.data_parallel_step``), then the optimizer's step
(``masking.ClippedAdam`` or a ``torch.optim`` optimizer over the
model's parameters), in place. Each step returns the pmean'd loss.

The step functions take this rank's block of the batch
(``mesh.shard_batch``), where JAX's take the global array sharded over
the mesh; ``make_dp_tp_dynamics_step`` takes the whole batch, as JAX's
does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gan_mpc_tpu_torch.parallel.mesh import (
    Axes, Mesh, apply_tensor_parallel, data_parallel_step, optimizer_params)
from gan_mpc_tpu_torch.policies.losses import critic_bce_loss
from gan_mpc_tpu_torch.training.dynamics import multistep_prediction_loss


def make_sharded_cost_step(policy, opt, mesh: Mesh, loss_fn: Callable, axis: Axes = "dp"):
    """One data-parallel bilevel cost (or generator) update through the
    planner's implicit gradient: ``step(X, Y) -> loss`` on this rank's
    histories X (b, h+1, x) and targets Y (b, H+1, x)."""

    def step(X, Y):
        return data_parallel_step(opt, lambda: policy.batched_loss(X, loss_fn, (Y,)), mesh,
                                  axis)

    return step


def make_sharded_dynamics_step(dynamics_model, opt, mesh: Mesh, gamma: float,
                               axis: Axes = "dp"):
    """One data-parallel multi-step dynamics update: ``step(X, U, Y,
    teacher_forcing) -> loss`` on this rank's windows (b, seq, ·)."""

    def step(X, U, Y, teacher_forcing):
        return data_parallel_step(opt, lambda: multistep_prediction_loss(
            dynamics_model, X, U, Y, gamma, bool(teacher_forcing)).mean(), mesh, axis)

    return step


def make_sharded_critic_step(policy, opt, mesh: Mesh, axis: Axes = "dp"):
    """One data-parallel critic (discriminator) BCE update: ``step(seqs,
    labels) -> loss`` on this rank's labelled sequences (b, seq, x)."""

    def step(seqs, labels):
        return data_parallel_step(
            opt, lambda: critic_bce_loss(policy.critic_model, seqs, labels).mean(), mesh, axis)

    return step


def make_sharded_collect(env, env_params, policy_fn: Callable, normalizer, mesh: Mesh,
                         num_steps: int, history: int, envs_per_device: int,
                         axis: Axes = "dp", action_noise: float = 0.0):
    """Batched closed-loop collection over the mesh: ``collect(init_state,
    noise=None)`` rolls this rank's ``envs_per_device`` envs of the global
    start states (mesh size x ``envs_per_device`` of them, the same on
    every rank; JAX's per-env keys) under ``policy_fn(hist_X, hist_U) ->
    (b, act)``, with the exploration noise (steps, envs, act) where given,
    and returns the global episode (every rank's envs, in rank order)."""
    from gan_mpc_tpu_torch.envs.base import EnvState
    from gan_mpc_tpu_torch.envs.rollout import EpisodeData, batch_policy_rollout

    def collect(init_state, noise: Optional[torch.Tensor] = None):
        total = mesh.axis_size(axis) * envs_per_device
        if init_state.qpos.shape[0] != total:
            raise ValueError(f"{init_state.qpos.shape[0]} start states for {total} envs "
                             f"({envs_per_device} per device)")
        local = EnvState(*(mesh.rows(t, axis) for t in
                           (init_state.qpos, init_state.qvel, init_state.t)))
        local_noise = None if noise is None else mesh.rows(noise.transpose(0, 1), axis) \
            .transpose(0, 1)
        ep = batch_policy_rollout(env, env_params, policy_fn, normalizer, num_steps, history,
                                  envs_per_device, init_state=local, action_noise=action_noise,
                                  noise=local_noise)
        return EpisodeData(*(mesh.gather(t, axis) for t in ep))

    return collect


def local_members(ensemble, mesh: Mesh, axis: str = "ep") -> range:
    """The ensemble members this rank owns: an equal block over ``axis``."""
    n = mesh.shape[axis]
    if ensemble.num_members % n:
        raise ValueError(f"{ensemble.num_members} members do not divide the {axis} axis "
                         f"size {n}")
    per = ensemble.num_members // n
    return range(mesh.coords[axis] * per, (mesh.coords[axis] + 1) * per)


def make_sharded_ensemble_step(ensemble, opt, mesh: Mesh, gamma: float, axis: str = "ep"):
    """One ensemble-parallel (EP) dynamics update: the members split over
    ``axis`` (``local_members``), each trained on its own minibatch with
    no communication, the mean loss alone averaged for the log.
    ``step(Xm, Um, Ym, teacher_forcing) -> mean loss`` on member-major
    data (E, b, seq, ·), every member's rows given on every rank.

    ``opt`` steps the ensemble's parameters; the other ranks' members get
    no gradient, so it leaves them (their state too) as they are. An
    unclipped optimizer keeps the members independent (JAX's
    ``optax.adam``); a clipping one would clip over this rank's members.
    ``gather_members`` then gives every rank every member."""

    def step(Xm, Um, Ym, teacher_forcing):
        mine = local_members(ensemble, mesh, axis)
        opt.zero_grad()
        losses = torch.stack([multistep_prediction_loss(
            ensemble.members[e], Xm[e], Um[e], Ym[e], gamma, bool(teacher_forcing)).mean()
            for e in mine])
        losses.sum().backward()
        opt.step()
        return mesh.pmean(losses.detach().mean(), axis)

    return step


@torch.no_grad()
def gather_members(ensemble, mesh: Mesh, axis: str = "ep") -> None:
    """Every member's parameters from the rank that owns it, in place."""
    per = ensemble.num_members // mesh.shape[axis]
    for e, member in enumerate(ensemble.members):
        owner = e // per
        for p in member.parameters():
            mesh.broadcast_(p, src=owner)


class _GatherColumns(torch.autograd.Function):
    """All-gather of column blocks along the last axis over ``axis``.
    Backward: the gradient summed over the axis (each rank holds a partial
    one, see ``make_dp_tp_dynamics_step``), then this rank's block: a
    reduce-scatter, written as a sum and a slice so that gloo runs it."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, x.shape[-1]
        return mesh.gather(x.movedim(-1, 0).contiguous(), axis).movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        full = ctx.mesh.psum(g.contiguous(), ctx.axis)
        i = ctx.mesh.axis_index(ctx.axis) * ctx.width
        return full[..., i:i + ctx.width], None, None


def tp_mlp_apply(z: torch.Tensor, layers, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """The relu MLP on rows z (N, fin), each layer column-parallel over
    ``axis`` where ``mlp_tensor_parallel_sharding`` splits it (this rank
    computes its column block from ``apply_tensor_parallel``'s blocks and
    the blocks are gathered), else whole on every rank. Plain
    ``torch.matmul``: JAX runs this path as plain XLA Dense layers, not
    through its Pallas kernel."""
    h = z
    for i, (w, b) in enumerate(layers):
        w_local, b_local = apply_tensor_parallel((w, b), mesh, axis)
        h = h @ w_local + b_local
        if w_local.shape[1] != w.shape[1]:
            h = _GatherColumns.apply(h, mesh, axis)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


class _ColumnParallelDynamics:
    """The residual MLP dynamics of ``model`` with ``tp_mlp_apply`` as its
    MLP (the two hooks ``multistep_prediction_loss`` calls)."""

    def __init__(self, model, mesh: Mesh, axis: str):
        net = model.net
        if getattr(net, "carry_size", 1) != 0 or not hasattr(net, "stack"):
            raise NotImplementedError("the dp x tp step takes the residual MLP dynamics")
        self.model, self.mesh, self.axis = model, mesh, axis

    def zero_carry(self, batch, device=None):
        return self.model.zero_carry(batch, device)

    def batch_apply(self, X, U):
        z = torch.cat([X, U], dim=-1)
        return X + tp_mlp_apply(z, self.model.net.stack(), self.mesh, self.axis)


def make_dp_tp_dynamics_step(dynamics_model, opt, mesh: Mesh, gamma: float,
                             dp_axis: str = "dp", tp_axis: str = "tp"):
    """The hybrid data x tensor parallel dynamics update: ``step(X, U, Y,
    teacher_forcing) -> loss`` on the whole batch, this rank's rows over
    ``dp_axis``, the MLP's hidden columns over ``tp_axis``
    (``tp_mlp_apply``, plain torch). The parameters stay whole and
    replicated in the model; a rank's gradients are partial over the tp
    axis (its column blocks, and 1/tp of the replicated part: the loss is
    divided by the tp size before the backward), so the gradients are
    summed over the whole mesh and divided by the dp size, then
    ``opt`` steps them. The numbers are the replicated step's up to float
    rounding (``tests/test_torch_parallel.py``)."""
    tp_model = _ColumnParallelDynamics(dynamics_model, mesh, tp_axis)
    tp = mesh.shape[tp_axis]

    def step(X, U, Y, teacher_forcing):
        X, U, Y = (mesh.rows(t, dp_axis) for t in (X, U, Y))
        opt.zero_grad()
        loss = multistep_prediction_loss(tp_model, X, U, Y, gamma, bool(teacher_forcing)).mean()
        (loss / tp).backward()
        mesh.reduce_gradients(optimizer_params(opt), None, divide_by=mesh.shape[dp_axis])
        opt.step()
        return mesh.pmean(loss.detach(), dp_axis)

    return step
