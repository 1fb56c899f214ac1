"""The long-horizon serving path end to end: closed-loop MPC on the planar
humanoid at H=20, where "auto" resolves to the materializing line search.

JAX ``policy_rollout`` against the port's over 3 control steps of 4
humanoid_stand envs, iLQR <= 5, with ``fused_ls`` off and on, at the
tiny flagship's widths (``__graft_entry__._flagship(tiny=True)``: cost
29->16->4, dynamics 41->16->29, LSTM expert of 8 features), weights
carried across by ``from_jax_params``, both packages starting from the
JAX package's resets of one key. Float32 on the CPU. Checked: the solves
materialize, every step's iterations are equal, actions atol 1e-3 and
rewards atol 1e-4 at every step.

The flagship's random dynamics grow every rollout over 20 steps (the
plans reach |U| ~ 1e4), and the plan is then chaotic in its input: from
resets scaled by 1 +- 1e-7, JAX's own actions move by 1e2-1e3 within 3
steps on every key tried (0-5), and by 0.3-2.6 even at one iLQR
iteration. So the dynamics' output layer is scaled by 1/32 in both
packages (a power of two: the same weights exactly), which keeps the
rollouts bounded. Even so some lanes sit on a line-search flip; the test
uses the reset key (2) whose lanes stay clear, and checks that itself:
JAX against itself from resets scaled by 1 +- 1e-7 moves no action by
1e-4 (3e-6 off and 8e-6 on when this was written; the port then agreed
with JAX to 3.3e-6 in actions and 3.6e-7 in rewards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gan_mpc_tpu.data.normalizer import Normalizer as JaxNormalizer
from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs.rollout import policy_rollout as jax_policy_rollout
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import from_jax_params
from gan_mpc_tpu_torch.planner import batch_ilqr as port_batch_ilqr
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies import mpc
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy

torch.set_num_threads(1)
pin_fp32()

H, ITERS, B, STEPS, KEY = 20, 5, 4, 3, 2
X, U = 29, 12
DYN_SCALE = 1.0 / 32.0


class _Scaled:
    """The env with its reset states scaled by a traced factor carried in
    the env params ``(params, scale)``, so that the nudged rollouts reuse
    one compiled program."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, p, key):
        s = self._env.reset(p[0], key)
        return s.replace(qpos=s.qpos * p[1], qvel=s.qvel * p[1])

    def step(self, p, s, a):
        return self._env.step(p[0], s, a)

    def observe(self, p, s):
        return self._env.observe(p[0], s)


class _Recorded:
    """The JAX policy, its batch plan's iterations handed to ``seen``."""

    batch_native = True

    def __init__(self, policy, seen):
        self._policy, self._seen = policy, seen

    def act_batch(self, params, hist_x, hist_u):
        sol = self._policy.plan_batch(params, hist_x, hist_u)
        jax.debug.callback(lambda it: self._seen.append(np.asarray(it)), sol.iterations,
                           ordered=True)
        return sol.U[:, 0]


def _jax_policy(fused):
    jpolicy, jparams, _, _ = graft._flagship(horizon=H, max_iterations=ITERS, tiny=True,
                                             x_size=X, u_size=U, fused_ls=fused)
    params = jax.device_get(jparams)
    dyn = dict(params["dynamics_params"]["params"])
    last = sorted(dyn)[-1]
    dyn[last] = {k: np.asarray(v) * np.float32(DYN_SCALE) for k, v in dyn[last].items()}
    return jpolicy, dict(params, dynamics_params={"params": dyn})


def _port_policy(params, fused):
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(X, hidden=(16,), features_out=4), H,
                           mpc_weights=(-2.0, 3.0, -3.0)),
        dynamics_model=LearnedDynamics(ResidualMLPDynamicsNet(X, U, hidden=(16,))),
        expert_model=ExpertPredictor(X, U, arch="lstm", features=8, hidden=(16,)),
        horizon=H,
        settings=SolverSettings(max_iterations=ITERS, fused_ls=fused),
    )
    return from_jax_params(params, policy).requires_grad_(False)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_humanoid_closed_loop_matches_jax(fused, monkeypatch):
    jpolicy, params = _jax_policy(fused)
    jenv = _Scaled(jax_make_env("humanoid_stand"))
    seen = []
    run = jax.jit(lambda p, ep, k: jax_policy_rollout(
        jenv, ep, _Recorded(jpolicy, seen), p, JaxNormalizer.identity(X, U), k,
        num_steps=STEPS, history=1, num_envs=B))
    key = jax.random.PRNGKey(KEY)
    base = jenv.default_params()
    ref = run(params, (base, jnp.float32(1.0)), key)
    jax.effects_barrier()
    ref_iters = list(seen)
    for scale in (1 + 1e-7, 1 - 1e-7):
        nudged = run(params, (base, jnp.float32(scale)), key)
        assert np.abs(np.asarray(nudged.actions) - np.asarray(ref.actions)).max() < 1e-4
    assert len(ref_iters) == STEPS

    resets = jax.vmap(lambda k: jenv.reset((base, 1.0), k))(
        jax.random.split(jax.random.split(key)[0], B))
    init = EnvState(qpos=torch.tensor(np.asarray(resets.qpos)),
                    qvel=torch.tensor(np.asarray(resets.qvel)),
                    t=torch.zeros(B, dtype=torch.int32))
    solves = []

    def recorded(problem, x0, U0, settings):
        assert port_batch_ilqr.ls_materializes(settings, H, B, X, U)
        sol = port_batch_ilqr.batch_ilqr(problem, x0, U0, settings)
        solves.append(sol.iterations.numpy())
        return sol

    monkeypatch.setattr(mpc, "batch_ilqr", recorded)
    env = make_env("humanoid_stand", "cpu")
    got = policy_rollout(env, env.default_params(), _port_policy(params, fused),
                         Normalizer.identity(X, U, "cpu"), num_steps=STEPS, history=1,
                         num_envs=B, init_state=init)
    for t in range(STEPS):
        np.testing.assert_array_equal(solves[t], ref_iters[t], err_msg=f"iterations at {t}")
        for name, atol in [("actions", 1e-3), ("rewards", 1e-4)]:
            np.testing.assert_allclose(
                getattr(got, name)[:, t].numpy(), np.asarray(getattr(ref, name))[:, t],
                rtol=0, atol=atol, err_msg=f"{name} at step {t}",
            )
