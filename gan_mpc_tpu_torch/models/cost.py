"""Learned cost model: batch hooks of the planner.

Counterpart of ``gan_mpc_tpu/models/cost.py``: a relu feature net whose
squared feature norm is the terminal cost, and a closed-form running
cost that is a sigmoid-weighted sum of pseudo-Huber magnitudes of the
action and of the distance to a per-timestep goal state, with the
optional action-goal term (4th raw weight) and its gain (5th raw
weight).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gan_mpc_tpu_torch.ops.fused_mlp import (
    Dense,
    dense_stack,
    mlp_apply,
    mlp_value_and_jac,
)

_HUBER_ALPHA = 1e-2


class CostFeatureNet(nn.Module):
    """relu MLP from the planner state to a feature vector f; cost <f, f>."""

    def __init__(self, in_size: int, hidden: Sequence[int] = (128, 128),
                 features_out: int = 10):
        super().__init__()
        widths = [in_size, *hidden, features_out]
        self.layers = nn.ModuleList(
            Dense(a, b) for a, b in zip(widths[:-1], widths[1:])
        )

    def stack(self):
        return dense_stack(self.layers)


def pseudo_huber(v: torch.Tensor) -> torch.Tensor:
    """sqrt(|v|^2 + a^2) - a over the last axis, a = 1e-2."""
    a = _HUBER_ALPHA
    return torch.sqrt(torch.sum(v * v, -1) + a * a) - a


class MPCCost(nn.Module):
    """Planner-cost assembler around a CostFeatureNet.

    ``weights`` holds the raw (pre-sigmoid) MPC weights: (action, state,
    terminal), optionally followed by an action-goal weight and an
    action-goal gain.
    """

    def __init__(
        self,
        net: CostFeatureNet,
        horizon: int,
        mpc_weights: Sequence[float] = (-2.0, 3.0, -3.0),
        action_goal_scale: float = 1.0,
        action_goal_squared: bool = False,
    ):
        super().__init__()
        self.net = net
        self.horizon = horizon
        self.weights = nn.Parameter(torch.tensor(mpc_weights, dtype=torch.float32))
        self.action_goal_scale = float(action_goal_scale)
        self.action_goal_squared = bool(action_goal_squared)

    def stage_weights(self):
        """The running cost's weights, as every stage-cost path reads them:
        (wvec (1, 4) = [w_u, w_x, w_ag, gain], ag_scale).

        w_u, w_x are the sigmoids of raw weights 0 and 1; w_ag the sigmoid
        of raw weight 3, or 0 without one; gain raw weight 4, or 1 without
        one; ag_scale ``action_goal_scale``, or 0 without an action-goal
        weight. ``stage_cost_batch``, ``quad_batch`` and the fused
        line-search step (``ops/fused_ls.py``) all take them from here.
        """
        raw = self.weights
        w = torch.sigmoid(raw)
        has_ag = raw.shape[-1] > 3
        w_ag = w[3] if has_ag else torch.zeros((), dtype=raw.dtype, device=raw.device)
        gain = raw[4] if raw.shape[-1] > 4 else torch.ones((), dtype=raw.dtype,
                                                           device=raw.device)
        wvec = torch.stack([w[0], w[1], w_ag, gain]).reshape(1, 4)
        return wvec, (self.action_goal_scale if has_ag else 0.0)

    def stage_cost_batch(self, X, U, t, goal_tm, goal_u_tm=None):
        """X (B,K,n), U (B,K,m), goal_tm (T+1,B,gs) time-major -> (B,K)."""
        wvec, ag_scale = self.stage_weights()
        w_u, w_x, w_ag, gain = wvec[0]
        gs = goal_tm.shape[-1]
        d = X[..., :gs] - goal_tm[t][:, None]
        cost = w_u * pseudo_huber(U) + w_x * pseudo_huber(d)
        if ag_scale != 0.0 and goal_u_tm is not None:
            du = U - gain * goal_u_tm[t][:, None]
            if self.action_goal_squared:
                ag = ag_scale * torch.sum(du * du, -1)
            else:
                ag = ag_scale * pseudo_huber(du)
            cost = cost + w_ag * ag
        return cost

    def terminal_cost_batch(self, X, twice_differentiable: bool = False):
        """X (B,K,n) -> (B,K): w2 * |f(x)|^2 through the fused MLP
        (``twice_differentiable`` as in ``mlp_apply``)."""
        w = torch.sigmoid(self.weights)
        B, K, n = X.shape
        f = mlp_apply(X.reshape(B * K, n), self.net.stack(),
                      twice_differentiable=twice_differentiable)
        return w[2] * torch.sum(f * f, -1).reshape(B, K)

    def quad_batch(self, X, U, goal_tm, goal_u_tm=None):
        """Whole-horizon quadratization, time-major: X (T+1,B,n), U (T,B,m),
        goal_tm (T+1,B,gs) -> cx (T+1,B,n), cu (T,B,m), cxx (T+1,B,n,n),
        cuu (T,B,m,m), cux (T,B,m,n). Stage rows are closed-form; the
        terminal row is 2 w2 J^T f and 2 w2 J^T J from the feature net's
        value and Jacobian (exact for a relu net)."""
        wvec, ag_scale = self.stage_weights()
        w_u, w_x, w_ag, gain = wvec[0]
        w_T = torch.sigmoid(self.weights[2])
        T1, B, n = X.shape
        T = T1 - 1
        m = U.shape[-1]
        a = _HUBER_ALPHA
        gs = goal_tm.shape[-1]
        eye_g = torch.eye(gs, dtype=X.dtype, device=X.device)
        eye_m = torch.eye(m, dtype=X.dtype, device=X.device)

        def huber(v, eye):
            s = torch.sqrt(torch.sum(v * v, -1, keepdim=True) + a * a)
            g = v / s
            H = eye / s[..., None] - (v[..., :, None] * v[..., None, :]) / (
                s[..., None] ** 3
            )
            return g, H

        d = X[:T, :, :gs] - goal_tm[:T]
        gx, Hx = huber(d, eye_g)
        cx_s = torch.zeros((T, B, n), dtype=X.dtype, device=X.device)
        cx_s[..., :gs] = w_x * gx
        cxx_s = torch.zeros((T, B, n, n), dtype=X.dtype, device=X.device)
        cxx_s[..., :gs, :gs] = w_x * Hx
        gu, Hu = huber(U, eye_m)
        cu = w_u * gu
        cuu = w_u * Hu
        if ag_scale != 0.0 and goal_u_tm is not None:
            du = U - gain * goal_u_tm[:T]
            if self.action_goal_squared:
                gu2 = 2.0 * du
                Hu2 = (2.0 * eye_m).expand(du.shape[:-1] + (m, m))
            else:
                gu2, Hu2 = huber(du, eye_m)
            cu = cu + (w_ag * ag_scale) * gu2
            cuu = cuu + (w_ag * ag_scale) * Hu2
        cux = torch.zeros((T, B, m, n), dtype=X.dtype, device=X.device)

        f, J = mlp_value_and_jac(X[-1], self.net.stack())
        cx_T = 2.0 * w_T * torch.einsum("bo,boi->bi", f, J)
        cxx_T = 2.0 * w_T * torch.einsum("boi,boj->bij", J, J)

        cx = torch.cat([cx_s, cx_T[None]], dim=0)
        cxx = torch.cat([cxx_s, cxx_T[None]], dim=0)
        return cx, cu, cxx, cuu, cux
