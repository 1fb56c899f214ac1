"""Weights for the port, two ways.

``from_jax_params`` loads the JAX policy's parameter tree (nested dicts
of numpy arrays, as ``jax.device_get`` returns them) into an
``MPCPolicy``: Dense stacks in ``Dense_i`` index order with (in, out)
kernels, the expert's ``OptimizedLSTMCell`` gate kernels and biases, and
its prediction heads. ``dynamics_from_jax_params`` loads the dynamics
part alone into a ``LearnedDynamics``.

``init_flax_like`` draws fresh weights from a ``torch.Generator`` with
flax's default initializers: lecun_normal (truncated normal, std
sqrt(1/fan_in)/0.8796) for Dense and LSTM input kernels, orthogonal for
the LSTM recurrent kernels, zero biases. It serves the card, which has
no JAX. The numbers differ from flax's (other generator), the
distribution is the same.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from gan_mpc_tpu_torch.models.expert import GATES, OptimizedLSTMCell
from gan_mpc_tpu_torch.ops.fused_mlp import Dense

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _load_dense_stack(layers, tree: Mapping) -> None:
    names = sorted(tree, key=lambda s: int(s.rsplit("_", 1)[1]))
    if len(names) != len(layers):
        raise ValueError(f"{len(names)} Dense layers for a stack of {len(layers)}")
    for d, name in zip(layers, names):
        _copy(d.kernel, tree[name]["kernel"])
        _copy(d.bias, tree[name]["bias"])


def from_jax_params(tree: Mapping, policy: nn.Module) -> nn.Module:
    """Load ``{"mpc_weights", "cost_params", "dynamics_params",
    "expert_params"[, "critic_params"]}`` into ``policy`` (in place; also
    returned). ``critic_params`` is ignored: the critic is not ported."""
    cost = policy.cost_model
    weights = np.asarray(tree["mpc_weights"], np.float32)
    cost.weights = nn.Parameter(
        torch.tensor(weights, device=cost.weights.device),
        requires_grad=cost.weights.requires_grad,
    )
    _load_dense_stack(cost.net.layers, tree["cost_params"]["params"])
    dynamics_from_jax_params(tree["dynamics_params"], policy.dynamics_model)
    cell = tree["expert_params"]["params"]["_LSTMCell_0"]
    lstm = policy.expert_model.cell.lstm
    for g in GATES:
        _copy(getattr(lstm, f"i{g}"), cell["OptimizedLSTMCell_0"][f"i{g}"]["kernel"])
        _copy(getattr(lstm, f"h{g}"), cell["OptimizedLSTMCell_0"][f"h{g}"]["kernel"])
        _copy(getattr(lstm, f"h{g}_bias"), cell["OptimizedLSTMCell_0"][f"h{g}"]["bias"])
    _load_dense_stack(policy.expert_model.cell.heads.layers, cell["_PredictionHeads_0"])
    return policy


def dynamics_from_jax_params(tree: Mapping, dynamics: nn.Module) -> nn.Module:
    """Load a JAX ``dynamics_params`` tree (``{"params": {"Dense_i": ...}}``)
    into a ``LearnedDynamics`` with a residual MLP net (in place; also
    returned)."""
    _load_dense_stack(dynamics.net.layers, tree["params"])
    return dynamics


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal for an (in, out) kernel."""
    std = math.sqrt(1.0 / w.shape[0]) / _TRUNC_STD
    with torch.no_grad():
        t = torch.empty(w.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.copy_(t * std)
    return w


def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        t = torch.empty(w.shape)
        nn.init.orthogonal_(t, generator=generator)
        w.copy_(t)
    return w


def init_flax_like(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh flax-default weights for every Dense and LSTM cell in
    ``module`` (in place; also returned). MPC weights are left as set."""
    for sub in module.modules():
        if isinstance(sub, Dense):
            lecun_normal_(sub.kernel, generator)
            with torch.no_grad():
                sub.bias.zero_()
        elif isinstance(sub, OptimizedLSTMCell):
            for g in GATES:
                lecun_normal_(getattr(sub, f"i{g}"), generator)
                orthogonal_(getattr(sub, f"h{g}"), generator)
                with torch.no_grad():
                    getattr(sub, f"h{g}_bias").zero_()
    return module
