"""The MPC policy: learned cost + learned dynamics + expert goal generator
wired into the batch-native iLQR planner.

Counterpart of ``gan_mpc_tpu/policies/mpc.py``, batch-major throughout:

  * ``plan_batch`` / ``act_batch``, the serving path (no gradient);
  * ``plan`` / ``act``, the differentiable planner: one batch solve
    whose X, U and obj carry the implicit gradient
    (``planner/bilevel.py``) to the MPC weights, the cost net and the
    dynamics net. The JAX package's ``plan`` solves one instance and is
    ``vmap``ped; here a single instance is B = 1;
  * ``batched_loss`` / ``batched_loss_and_grad``, the outer loss of a batch
    of histories (the cost trainer's step).

``critic_model`` (a ``models.critic.SequenceCritic``, or None) is the GAN
discriminator the generator loss reads; the planner never calls it.
Goal projection and recurrent (LSTM) dynamics are not ported.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from gan_mpc_tpu_torch.models.cost import MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_step, split_w0
from gan_mpc_tpu_torch.planner.batch_ilqr import BatchProblem, batch_ilqr
from gan_mpc_tpu_torch.planner.bilevel import ImplicitPlanner
from gan_mpc_tpu_torch.planner.ilqr import ILQRSolution, SolverSettings
from gan_mpc_tpu_torch.training.masking import policy_components


class MPCPolicy(nn.Module):
    def __init__(
        self,
        cost_model: MPCCost,
        dynamics_model: LearnedDynamics,
        expert_model: ExpertPredictor,
        critic_model: nn.Module = None,
        horizon: int = 5,
        settings: SolverSettings = SolverSettings(),
        bilevel_solver: str = "dense",
        bilevel_ridge: float = 1e-5,
        goal_projection: int = 0,
    ):
        super().__init__()
        if goal_projection > 0:
            raise NotImplementedError("goal projection is not ported")
        self.cost_model = cost_model
        self.dynamics_model = dynamics_model
        self.expert_model = expert_model
        self.critic_model = critic_model
        self.horizon = horizon
        self.x_size = dynamics_model.x_size
        self.settings = settings
        self._plan = ImplicitPlanner(settings, solver=bilevel_solver, ridge=bilevel_ridge)

    @property
    def batch_native(self) -> bool:
        """Whether the batch-major fused planner path applies."""
        return self.dynamics_model.is_batch_native

    def _check_batch_native(self) -> None:
        if not self.batch_native:
            raise NotImplementedError(
                "vmapped per-env planning (recurrent dynamics) is not ported"
            )

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
        self._check_batch_native()
        goal_X, init_U = self.goals_and_warm_start(history_X)
        problem = self._problem(goal_X.transpose(0, 1), init_U.transpose(0, 1), order=0)
        return batch_ilqr(problem, history_X[:, -1], init_U, self.settings)

    def act_batch(self, history_X, history_U) -> torch.Tensor:
        """(B, u) first optimal actions via the batch-native planner."""
        return self.plan_batch(history_X, history_U).U[:, 0]

    def _problem(self, goal_tm, goal_u_tm, order: int) -> BatchProblem:
        """The planning problem on time-major goals (T+1, B, x) and action
        goals (T, B, u), built from the modules' own parameters.

        ``order`` is the derivative the caller will take
        (``planner/bilevel.py``): 0 for the solve, where ``settings.fused_ls``
        may route the forward scans through the fused step; 1 for first
        derivatives, every MLP through ``mlp_apply`` (on the card the
        fused kernels, under autograd ``FusedMlpFunction``); 2 for second
        derivatives, every MLP plain (``twice_differentiable``)."""
        cost, dyn = self.cost_model, self.dynamics_model
        cdt = self.settings.compute_dtype
        twice = order == 2

        def dynamics_step(X, U, t):
            B, K, n = X.shape
            nx = dyn.batch_apply(X.reshape(B * K, n), U.reshape(B * K, -1), cdt,
                                 twice_differentiable=twice)
            return nx.reshape(B, K, n)

        def dynamics_jac(X, U):
            T, B, n = X.shape
            _, A, Bm = dyn.batch_value_and_jac(
                X.reshape(T * B, n), U.reshape(T * B, -1), cdt
            )
            return A.reshape(T, B, n, n), Bm.reshape(T, B, n, -1)

        fused = self.settings.fused_ls
        ls_step = None
        if order == 0 and (fused == "on" or (fused == "auto" and goal_tm.is_cuda)):
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

        return BatchProblem(
            dynamics_step=dynamics_step,
            dynamics_jac=dynamics_jac,
            stage_cost=lambda X, U, t: cost.stage_cost_batch(
                X, U, t, goal_tm, goal_u_tm
            ),
            terminal_cost=lambda X: cost.terminal_cost_batch(
                X, twice_differentiable=twice
            ),
            quad=lambda X, U: cost.quad_batch(X, U, goal_tm, goal_u_tm),
            ls_step=ls_step,
        )

    # -- differentiable planning -----------------------------------------

    def plan(self, history_X: torch.Tensor, history_U: torch.Tensor = None,
             warm_start_carry: bool = True) -> ILQRSolution:
        """Solve the MPC problems of a (B, h+1, x) batch of observed
        (normalized) histories; X, U and obj are differentiable in the MPC
        weights, the cost net and the dynamics net through the implicit
        gradient. Goals and warm starts come from the expert without a
        gradient. Carry-free dynamics have no carry, so ``history_U`` and
        ``warm_start_carry`` change nothing."""
        del history_U, warm_start_carry
        self._check_batch_native()
        with torch.no_grad():
            goal_X, init_U = self.goals_and_warm_start(history_X)
        goal_tm, goal_u_tm = goal_X.transpose(0, 1), init_U.transpose(0, 1)
        theta = [self.cost_model.weights, *self.cost_model.net.parameters(),
                 *self.dynamics_model.parameters()]
        return self._plan(lambda order: self._problem(goal_tm, goal_u_tm, order), theta,
                          history_X[:, -1], init_U)

    def act(self, history_X, history_U=None) -> torch.Tensor:
        """(B, u) first optimal actions of ``plan``."""
        return self.plan(history_X, history_U).U[:, 0]

    def planned_states(self, sol: ILQRSolution) -> torch.Tensor:
        """Strip the packed dynamics carry: (..., horizon + 1, x_size)."""
        return sol.X[..., : self.x_size]

    # -- training --------------------------------------------------------

    def batched_loss(self, history_X: torch.Tensor, loss_fn: Callable,
                     loss_args: tuple = ()) -> torch.Tensor:
        """Mean over the batch of ``loss_fn(policy, sol, *loss_args)``, a
        (B,) per-instance loss of the planned solution, differentiable in
        the parameters through ``plan`` (train-time zero dynamics carry)."""
        sol = self.plan(history_X, warm_start_carry=False)
        return loss_fn(self, sol, *loss_args).mean()

    def batched_loss_and_grad(self, history_X: torch.Tensor, loss_fn: Callable,
                              loss_args: tuple = ()):
        """(mean loss, gradients): the gradients as a dict keyed by the JAX
        components (``training.masking.policy_components``), one tensor per parameter, zeros for
        the parameters that need no gradient and for the expert (whose
        goals are not differentiated)."""
        loss = self.batched_loss(history_X, loss_fn, loss_args)
        comps = policy_components(self)
        wrt = [p for ps in comps.values() for p in ps if p.requires_grad]
        got = dict(zip(map(id, wrt), torch.autograd.grad(loss, wrt, allow_unused=True)))
        grads = {
            name: [torch.zeros_like(p) if got.get(id(p)) is None else got[id(p)]
                   for p in ps]
            for name, ps in comps.items()
        }
        return loss.detach(), grads
