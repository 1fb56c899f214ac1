"""Port parity: gan/9 served and trained one GAN epoch, against the JAX package.

gan/9 (pendulum_swingup: H=10, iLQR <= 30, dynamics 4->200->200->200->3,
cost 3->128->128->10, LSTM expert of 128 features, critic of 64) is loaded
into both packages from its own ``config.json`` and ``params.msgpack``;
the normalizer is fitted on the committed expert store by both. Float32
on the CPU.

gan/9's solves are ill-conditioned (``scripts/diag_gan9_conditioning.py``):
on 180 of 256 expert histories the loop runs all 30 iterations without
meeting the gradient tolerance, and scaling a history by 1 +- 1e-7 moves
JAX's own plan by up to 4.6e-2, 1.4e-4 at the median (the port differs
from JAX by as much there). Only 8 of those 256 plans move by less than
1e-5 under such nudges, of the inputs and of the dynamics weights (by
1 +- 1e-6), with unchanged iteration counts: the plan test uses those 8
histories (``STABLE``) and checks that stability itself, as
``tests/test_torch_planner.py`` checks its inputs. The implicit gradient
is worse still (JAX's own moves by a median 3%, up to 25%, under the
same nudges), so the gradient test takes 8 histories whose plans
converge in 4-7 iterations and whose JAX gradient moves by less than
2e-6 of its max when they are scaled by 1 +- 1e-7 (``CONVERGED``;
``scripts/diag_gan9_conditioning.py --windows``).

  * ``plan_batch`` on the STABLE histories: U atol 1e-4, obj rel 1e-5,
    per-lane iterations equal (4 to 30), ``converged`` equal where a lane
    stopped before the last iteration;
  * the closed loop, 2 envs x 10 steps on the imitator's pendulum, from
    JAX's resets, without noise and with the collection noise (0.2) drawn
    by JAX and replayed: states and actions atol 1e-3, rewards equal. The
    reset key (9) is checked clear of flips: resets scaled by 1 +- 1e-7
    move JAX's own actions by less than 5e-3 (a flip moves one by 1e-2
    or more; rounding carried through these solves, by about 5e-4);
  * the generator's ``batched_loss_and_grad`` (``gan_generator_loss``,
    the CONVERGED histories): loss rel 1e-4, each component's gradient
    max|d| <= 1e-3 of its max|ref| (as the L2 loss's in
    ``test_torch_bilevel.py``);
  * the loop's early exit against all 30 trips (its exit check answered
    "still active"), on the CONVERGED histories: bitwise equal solutions,
    7 trips reported against 30, and the launch counts that follow.

One ``gan_epoch`` against the JAX loop body: ``test_torch_gan_epoch.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu.data.windows import cost_windows as jax_cost_windows
from gan_mpc_tpu.envs.rollout import policy_rollout as jax_policy_rollout
from gan_mpc_tpu.policies.losses import gan_generator_loss as jax_gan_loss
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.envs import EnvState
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.planner import batch_ilqr as batch_ilqr_module
from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
from gan_mpc_tpu_torch.runners import common
from gan_mpc_tpu_torch.training.masking import policy_components
from test_torch_pendulum import REPO, gan9_configs, jax_gan9, port_gan9, trajectories

torch.set_num_threads(1)
pin_fp32()


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)


# cost windows (history 1, H=10) of the whole normalized store (module doc)
STABLE = [1998, 2368, 4699, 4736, 5698, 7696, 9028, 9139]
CONVERGED = [7007, 8407, 1015, 9170, 1575, 8946, 5110, 8148]


@pytest.fixture(scope="module")
def gan9():
    """Both packages' gan/9 at the run's own settings, its normalizer on
    the whole store, and the STABLE and CONVERGED normalized expert
    histories."""
    jcfg, pcfg = gan9_configs()
    jpolicy, params = jax_gan9(jcfg)
    jtrajs, trajs = trajectories(24, 1000)
    jnorm = jcommon.build_normalizer(jcfg, jtrajs)
    norm = common.build_normalizer(pcfg, trajs, "cpu")
    X, Y = (np.array(a) for a in jax_cost_windows(
        jnorm.normalize_state(jnp.asarray(jtrajs.states)), 1, 10))
    return dict(jcfg=jcfg, pcfg=pcfg, jpolicy=jpolicy, params=params, jnorm=jnorm,
                norm=norm, policy=port_gan9(pcfg), X=X[STABLE], Xc=X[CONVERGED])


def _jax_leaves(tree, name):
    """A JAX gradient component's leaves in the port's parameter order:
    Dense stacks by index (kernel, bias); the critic's cell gates i, f, g,
    o (input kernel, hidden kernel, hidden bias), then its head."""
    if name == "mpc_weights":
        return [np.asarray(tree)]
    p = tree["params"]
    out = []
    if "ScanOptimizedLSTMCell_0" in p:
        cell = p["ScanOptimizedLSTMCell_0"]
        for g in "ifgo":
            out += [cell[f"i{g}"]["kernel"], cell[f"h{g}"]["kernel"], cell[f"h{g}"]["bias"]]
    for i in range(sum(k.startswith("Dense_") for k in p)):
        out += [p[f"Dense_{i}"]["kernel"], p[f"Dense_{i}"]["bias"]]
    return [np.asarray(a) for a in out]


def test_plan_batch_matches_jax(gan9):
    jpolicy, params, policy = gan9["jpolicy"], gan9["params"], gan9["policy"]
    X = gan9["X"]
    hU = np.zeros((8, 1, 1), np.float32)
    plan = jax.jit(jpolicy.plan_batch)
    ref = plan(params, jnp.asarray(X), jnp.asarray(hU))
    for x_scale, w_scale in ((1 + 1e-7, 1), (1 - 1e-7, 1), (1, 1 + 1e-6), (1, 1 - 1e-6)):
        nudged_params = dict(params, dynamics_params=jax.tree_util.tree_map(
            lambda a: a * w_scale, params["dynamics_params"]))
        nudged = plan(nudged_params, jnp.asarray(X * x_scale), jnp.asarray(hU))
        assert np.abs(np.asarray(nudged.U) - np.asarray(ref.U)).max() < 5e-5
        np.testing.assert_array_equal(np.asarray(nudged.iterations), np.asarray(ref.iterations))
    sol = policy.plan_batch(torch.from_numpy(X), torch.from_numpy(hU))
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sol.obj.numpy(), np.asarray(ref.obj), rtol=1e-5)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(ref.iterations))
    early = sol.iterations.numpy() < 30
    np.testing.assert_array_equal(sol.converged.numpy()[early], np.asarray(ref.converged)[early])
    assert sorted(set(sol.iterations.tolist())) == [4, 6, 30] and sol.trips == 30


class _NudgedResets:
    """The env with every reset angle scaled by ``scale``."""

    def __init__(self, env, scale):
        self._env, self._scale = env, scale

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, params, key):
        s = self._env.reset(params, key)
        return s.replace(qpos=s.qpos * self._scale)


@pytest.mark.parametrize("noise", [0.0, 0.2], ids=["clean", "collection_noise"])
def test_closed_loop_matches_jax(gan9, noise):
    jpolicy, params, policy = gan9["jpolicy"], gan9["params"], gan9["policy"]
    jenv, jenv_params = jcommon.imitator_env(gan9["jcfg"])
    env, env_params = common.imitator_env(gan9["pcfg"], "cpu")
    key, B, steps = jax.random.PRNGKey(9), 2, 10

    jax_rollout = jax.jit(lambda p, k, scale: jax_policy_rollout(
        _NudgedResets(jenv, scale), jenv_params, jpolicy, p, gan9["jnorm"], k,
        num_steps=steps, history=1, num_envs=B, action_noise=noise))
    ref = jax_rollout(params, key, 1.0)
    for scale in (1 + 1e-7, 1 - 1e-7):
        nudged = jax_rollout(params, key, scale)
        assert np.abs(np.asarray(nudged.actions) - np.asarray(ref.actions)).max() < 5e-3
    # the JAX rollout's draws: resets from split(split(key)[0], B), one
    # (B, 1) normal draw per step from split(split(key)[1], steps)
    k_reset, k_noise = jax.random.split(key)
    resets = jax.vmap(lambda k: jenv.reset(jenv_params, k))(jax.random.split(k_reset, B))
    draws = np.stack([np.asarray(jax.random.normal(k, (B, 1)))
                      for k in jax.random.split(k_noise, steps)])
    init = EnvState(torch.tensor(np.asarray(resets.qpos)), torch.tensor(np.asarray(resets.qvel)),
                    torch.zeros(B, dtype=torch.int32))
    got = policy_rollout(env, env_params, policy, gan9["norm"], num_steps=steps, history=1,
                         num_envs=B, init_state=init, action_noise=noise,
                         noise=torch.from_numpy(draws))
    for name in ("states", "actions", "qpos", "qvel"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(got.rewards.numpy(), np.asarray(ref.rewards))


def test_generator_gradient_matches_jax(gan9):
    jpolicy, params, policy = gan9["jpolicy"], gan9["params"], gan9["policy"]
    X = gan9["Xc"]
    jloss, jgrads = jax.jit(lambda p, x: jpolicy.batched_loss_and_grad(p, x, jax_gan_loss))(
        params, jnp.asarray(X))
    comps = ("mpc_weights", "cost_params", "dynamics_params", "critic_params")
    try:
        for name in comps:
            for p in policy_components(policy)[name]:
                p.requires_grad_(True)
        loss, grads = policy.batched_loss_and_grad(torch.from_numpy(X), gan_generator_loss)
    finally:
        policy.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for name in comps:
        ref = _jax_leaves(jgrads[name], name)
        assert len(grads[name]) == len(ref), name
        for i, (g, r) in enumerate(zip(grads[name], ref)):
            assert g.shape == r.shape, (name, i)
            assert np.abs(g.numpy() - r).max() <= 1e-3 * np.abs(r).max(), (name, i)
    assert all(not g.any() for g in grads["expert_params"])


def test_early_exit_equals_fixed_trips(gan9, monkeypatch):
    """The same plans bitwise whether the loop stops when no lane is
    active or, its exit check answered "still active" every trip, runs all
    30 trips; the reported trips give the launches ``mlp_calls_per_solve``
    counts."""
    policy, X = gan9["policy"], torch.from_numpy(gan9["Xc"])
    hU = torch.zeros((8, 1, 1))
    early = policy.plan_batch(X, hU)
    monkeypatch.setattr(batch_ilqr_module, "bool", lambda _: True, raising=False)
    fixed = policy.plan_batch(X, hU)
    for f in dataclasses.fields(fixed):
        if f.name != "trips":
            assert torch.equal(getattr(early, f.name), getattr(fixed, f.name)), f.name
    its = int(early.iterations.max())
    assert early.trips == its == 7 and fixed.trips == 30
    calls = mlp_calls_per_solve(10, early.trips, materialize=False)
    assert calls["fused_mlp_fwd"] == 10 * (1 + 2 * its) + 1 + its
    assert mlp_calls_per_solve(10, 2 * its, solves=2, materialize=False) == {
        k: 2 * v for k, v in calls.items()}
