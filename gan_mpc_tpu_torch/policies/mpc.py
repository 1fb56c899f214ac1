"""The MPC policy: learned cost + learned dynamics + expert goal generator
wired into the batch-native iLQR planner.

Counterpart of the batch path of ``gan_mpc_tpu/policies/mpc.py``
(``goals_and_warm_start``, ``plan_batch``, ``act_batch``,
``batch_native``). The single-instance differentiable planner
(``plan``/``act``, the bilevel VJP), goal projection and the critic are
not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_mpc_tpu_torch.models.cost import MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_step, split_w0
from gan_mpc_tpu_torch.planner.batch_ilqr import BatchProblem, batch_ilqr
from gan_mpc_tpu_torch.planner.ilqr import ILQRSolution, SolverSettings


class MPCPolicy(nn.Module):
    def __init__(
        self,
        cost_model: MPCCost,
        dynamics_model: LearnedDynamics,
        expert_model: ExpertPredictor,
        horizon: int = 5,
        settings: SolverSettings = SolverSettings(),
        goal_projection: int = 0,
    ):
        super().__init__()
        if goal_projection > 0:
            raise NotImplementedError("goal projection is not ported")
        self.cost_model = cost_model
        self.dynamics_model = dynamics_model
        self.expert_model = expert_model
        self.horizon = horizon
        self.x_size = dynamics_model.x_size
        self.settings = settings

    @property
    def batch_native(self) -> bool:
        """Whether the batch-major fused planner path applies."""
        return self.dynamics_model.is_batch_native

    def goals_and_warm_start(self, history_X: torch.Tensor):
        """Expert-predicted goal states (B, H+1, x) and warm-start actions
        (B, H, u) from the observed (normalized) history (B, h+1, x)."""
        carry = self.expert_model.warm_carry(history_X)
        return self.expert_model.generate(carry, self.horizon)

    @torch.no_grad()
    def plan_batch(self, history_X: torch.Tensor, history_U: torch.Tensor) -> ILQRSolution:
        """Solve a (B,)-batch of MPC problems in one batch-major solver.
        history_X (B, h+1, x); history_U (B, h, u). Carry-free dynamics
        have no carry to warm, so history_U is not read.

        ``settings.fused_ls`` picks the forward scans' step: "on" the fused
        step (``ops/fused_ls.py``: the CUDA kernel on the card, its plain
        version on the CPU), "off" the separate dynamics and stage-cost
        callbacks, "auto" the fused step for CUDA inputs only."""
        del history_U
        if not self.batch_native:
            raise NotImplementedError(
                "vmapped per-env planning (recurrent dynamics) is not ported"
            )
        goal_X, init_U = self.goals_and_warm_start(history_X)
        goal_tm = goal_X.transpose(0, 1)  # (T+1, B, x) time-major
        goal_u_tm = init_U.transpose(0, 1)  # action-goal target (T, B, u)
        cost, dyn = self.cost_model, self.dynamics_model
        cdt = self.settings.compute_dtype

        def dynamics_step(X, U, t):
            B, K, n = X.shape
            nx = dyn.batch_apply(X.reshape(B * K, n), U.reshape(B * K, -1), cdt)
            return nx.reshape(B, K, n)

        def dynamics_jac(X, U):
            T, B, n = X.shape
            _, A, Bm = dyn.batch_value_and_jac(
                X.reshape(T * B, n), U.reshape(T * B, -1), cdt
            )
            return A.reshape(T, B, n, n), Bm.reshape(T, B, n, -1)

        fused = self.settings.fused_ls
        ls_step = None
        if fused == "on" or (fused == "auto" and history_X.is_cuda):
            # everything the step reads but x and the iterate, once per plan
            wvec, ag_scale = cost.stage_weights()
            layers = split_w0(dyn.net.stack(), self.x_size)
            goal_c, goal_u_c = goal_tm.contiguous(), goal_u_tm.contiguous()
            gs = goal_tm.shape[-1]

            def ls_step(x, Xref, Uref, alphaBA, kt, Kt, t):
                return fused_ls_step(
                    x, Xref, Uref, alphaBA, kt, Kt, goal_c[t], goal_u_c[t], wvec,
                    layers, gs=gs, action_goal_squared=cost.action_goal_squared,
                    ag_scale=ag_scale, bf16=cdt == "bfloat16",
                )

        problem = BatchProblem(
            dynamics_step=dynamics_step,
            dynamics_jac=dynamics_jac,
            stage_cost=lambda X, U, t: cost.stage_cost_batch(
                X, U, t, goal_tm, goal_u_tm
            ),
            terminal_cost=cost.terminal_cost_batch,
            quad=lambda X, U: cost.quad_batch(X, U, goal_tm, goal_u_tm),
            ls_step=ls_step,
        )
        return batch_ilqr(problem, history_X[:, -1], init_U, self.settings)

    def act_batch(self, history_X, history_U) -> torch.Tensor:
        """(B, u) first optimal actions via the batch-native planner."""
        return self.plan_batch(history_X, history_U).U[:, 0]
