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

Dynamics that are not batch native (``models/ensemble.py``, the LSTM
dynamics of ``models/dynamics.py``) plan as the JAX package's vmapped
``plan`` does: from ``xc0 = [x, carry]``, the carry warmed from the
history (``history_U`` is read), through ``batch_ilqr`` on a problem
marked ``per_instance`` (lanes solve independently; ``fused_ls`` and
``compute_dtype`` are not read, so no fused line-search step launches;
``riccati`` is). ``compute_dtype="bfloat16"`` reaches the dynamics net of
the batch-native ``plan_batch`` alone: its forward scans (the forward
kernel's or the fused step's bf16 instance on the card) and its
linearization's Jacobian chain take bfloat16 products; the cost nets, the
solver's arithmetic and the differentiable ``plan`` stay f32, as in the
JAX package.
With ``goal_projection`` > 0 both paths first project the expert's goals
onto the learned dynamics' reachable states (``project_goals``); the
action-goal target stays the expert's unprojected actions.
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
        self.cost_model = cost_model
        self.dynamics_model = dynamics_model
        self.expert_model = expert_model
        self.critic_model = critic_model
        self.horizon = horizon
        self.x_size = dynamics_model.x_size
        self.settings = settings
        self.goal_projection = goal_projection
        self._plan = ImplicitPlanner(settings, solver=bilevel_solver, ridge=bilevel_ridge)

    @property
    def batch_native(self) -> bool:
        """Whether the batch-major fused planner path applies (carry-free
        MLP dynamics; the others plan per instance)."""
        return self.dynamics_model.is_batch_native

    def goals_and_warm_start(self, history_X: torch.Tensor):
        """Expert-predicted goal states (B, H+1, x) and warm-start actions
        (B, H, u) from the observed (normalized) history (B, h+1, x)."""
        carry = self.expert_model.warm_carry(history_X)
        return self.expert_model.generate(carry, self.horizon)

    @torch.no_grad()
    def project_goals(self, xc0: torch.Tensor, goal_X: torch.Tensor, init_U: torch.Tensor):
        """Project the expert's goals onto the learned dynamics' reachable
        states (the JAX ``project_goals``, batch-major): per step, from the
        current state xc (B, n), ``goal_projection`` damped Gauss-Newton
        steps on the action, whose residual r and Jacobian J_u (of the
        predicted next x against the next goal) come from one
        ``batch_value_and_jac``, each u <- u - (J^T J + 1e-6 I)^-1 J^T r
        (``torch.linalg.solve``, as ``jnp.linalg.solve``); then u clipped
        to [-1, 1] and the state advanced through ``batch_apply``. Returns
        the reachable goals (B, H+1, x), the first the expert's own, and
        the actions that reach them (B, H, u), the new warm start."""
        dyn, xs = self.dynamics_model, self.x_size
        m = init_U.shape[-1]
        ridge = 1e-6 * torch.eye(m, dtype=init_U.dtype, device=init_U.device)
        xc, goals, us = xc0, [goal_X[:, 0]], []
        for t in range(init_U.shape[1]):
            u, g_next = init_U[:, t], goal_X[:, t + 1]
            for _ in range(self.goal_projection):
                nx, _, Bm = dyn.batch_value_and_jac(xc, u)
                r, J = nx[:, :xs] - g_next, Bm[:, :xs]
                Jt = J.transpose(-1, -2)
                u = u - torch.linalg.solve(Jt @ J + ridge, (Jt @ r[..., None]))[..., 0]
            u = torch.clamp(u, -1.0, 1.0)
            xc = dyn.batch_apply(xc, u)
            goals.append(xc[:, :xs])
            us.append(u)
        return torch.stack(goals, 1), torch.stack(us, 1)

    def _start(self, history_X, history_U, warm_start_carry: bool = True):
        """(xc0 (B, n), goals (B, H+1, x), warm start (B, H, u), action
        goals (B, H, u)) of a batch of histories: the expert's goals and
        warm start without a gradient, the state extended by the dynamics'
        carry (warmed from the history where ``warm_start_carry``), the
        goals projected where ``goal_projection`` > 0. The action goals
        are the expert's actions before the projection."""
        with torch.no_grad():
            goal_X, init_U = self.goals_and_warm_start(history_X)
            xc0 = history_X[:, -1]
            if not self.batch_native:
                dyn = self.dynamics_model
                if warm_start_carry and history_U is not None:
                    carry = dyn.warm_carry(history_X[:, :-1], history_U)
                else:
                    carry = dyn.zero_carry(xc0.shape[0], xc0.device)
                xc0 = torch.cat([xc0, carry], -1)
            u_goal = init_U
            if self.goal_projection > 0:
                goal_X, init_U = self.project_goals(xc0, goal_X, init_U)
        return xc0, goal_X, init_U, u_goal

    @torch.no_grad()
    def plan_batch(self, history_X: torch.Tensor, history_U: torch.Tensor) -> ILQRSolution:
        """Solve a (B,)-batch of MPC problems in one batch-major solver.
        history_X (B, h+1, x); history_U (B, h, u), which warms the carry
        of recurrent dynamics (carry-free dynamics do not read it).

        On the batch-native path ``settings.fused_ls`` picks the forward
        scans' step: "on" the fused step (``ops/fused_ls.py``: the CUDA
        kernel on the card, its plain version on the CPU), "off" the
        separate dynamics and stage-cost callbacks, "auto" the fused step
        for CUDA inputs only. The per-instance path reads none."""
        xc0, goal_X, init_U, u_goal = self._start(history_X, history_U)
        problem = self._problem(goal_X.transpose(0, 1), u_goal.transpose(0, 1), order=0,
                                serving=True)
        return batch_ilqr(problem, xc0, init_U, self.settings)

    def act_batch(self, history_X, history_U) -> torch.Tensor:
        """(B, u) first optimal actions of ``plan_batch``."""
        return self.plan_batch(history_X, history_U).U[:, 0]

    def _problem(self, goal_tm, goal_u_tm, order: int, serving: bool = False) -> BatchProblem:
        """The planning problem on time-major goals (T+1, B, x) and action
        goals (T, B, u), built from the modules' own parameters.

        ``order`` is the derivative the caller will take
        (``planner/bilevel.py``): 0 for the solve, where ``settings.fused_ls``
        may route the forward scans through the fused step; 1 for first
        derivatives, every MLP through ``mlp_apply`` (on the card the
        fused kernels, under autograd ``FusedMlpFunction``); 2 for second
        derivatives, every MLP plain (``twice_differentiable``). The
        problem states whether the Gauss-Newton Hessian is exact: where the
        dynamics are piecewise linear (``piecewise_linear``).
        ``settings.compute_dtype`` reaches the dynamics' callbacks and the
        fused step where ``serving`` (``plan_batch``) on a batch-native
        policy: the JAX package's ``plan_batch`` reads it, its ``plan``
        (per-instance ``ilqr``) does not."""
        cost, dyn = self.cost_model, self.dynamics_model
        native = self.batch_native
        cdt = self.settings.compute_dtype if native and serving else None
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
        if native and order == 0 and (fused == "on" or (fused == "auto" and goal_tm.is_cuda)):
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
            per_instance=not native,
            gauss_newton_exact=dyn.piecewise_linear,
        )

    # -- differentiable planning -----------------------------------------

    def plan(self, history_X: torch.Tensor, history_U: torch.Tensor = None,
             warm_start_carry: bool = True) -> ILQRSolution:
        """Solve the MPC problems of a (B, h+1, x) batch of observed
        (normalized) histories; X, U and obj are differentiable in the MPC
        weights, the cost net and the dynamics net through the implicit
        gradient. Goals, warm starts and the goal projection are not
        differentiated (as in the JAX package). Recurrent dynamics warm
        their carry from ``history_U`` where ``warm_start_carry``, else
        start from a zero carry (the train-time simplification)."""
        xc0, goal_X, init_U, u_goal = self._start(history_X, history_U, warm_start_carry)
        goal_tm, goal_u_tm = goal_X.transpose(0, 1), u_goal.transpose(0, 1)
        theta = [self.cost_model.weights, *self.cost_model.net.parameters(),
                 *self.dynamics_model.parameters()]
        return self._plan(lambda order: self._problem(goal_tm, goal_u_tm, order), theta,
                          xc0, init_U)

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
