"""Port parity: the fused line-search step (``ops/fused_ls.py``) and the
control path with ``fused_ls="on"``, against the JAX package.

Step inputs and weights come from a numpy seed (state 7, actions 3, goal
5 wide, dynamics 10->32->32->7) and go through both packages as float32
on the CPU, for 3, 4 and 5 raw MPC weights and both action-goal forms:

  1. the port's step against JAX ``fused_ls_step`` (its jnp path);
  2. the same against the TPU kernel ``_kernel`` itself, run in interpret
     mode with the lanes tiled to its 128-lane block;
  3. the port's fused step against the port's separate callbacks (control
     law, ``batch_apply``, ``stage_cost_batch``);
all at atol 1e-5 (float32; sums run in another order in XLA and torch).
Both cost paths take their weights from the one helper
``MPCCost.stage_weights``, with the JAX fused path's semantics.

Then at flagship width, weights carried across by ``from_jax_params``:
  4. one ``plan_batch`` solve with ``fused_ls="on"`` on 8 envs against
     JAX's (U atol 1e-4, equal ``iterations`` and ``converged``, obj rtol
     1e-5), after checking that this input is clear of line-search flips
     (JAX against itself with the input scaled by 1 + 1e-7);
  5. a 2-step closed loop of 8 envs with ``fused_ls="on"`` against JAX's,
     on a reset key whose lanes stay clear of flips, checked as
     ``tests/test_torch_slice.py`` checks its key. The fused loop flips
     more often than the unfused one: from key 42's resets scaled by
     1 + 1e-7, JAX's own fused actions move by 1.7 within 3 steps. Over 2
     steps key 9 is clear (JAX against itself 1.4e-5, the port 1.5e-5).
The CUDA kernel against the plain version is a ``gpu`` test that skips
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import __graft_entry__ as graft
import gan_mpc_tpu.ops.fused_ls as fl
from gan_mpc_tpu.data.normalizer import Normalizer as JaxNormalizer
from gan_mpc_tpu.envs import make_env as jax_make_env
from gan_mpc_tpu.envs.rollout import policy_rollout as jax_policy_rollout
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import flagship
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.envs import EnvState, make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.ops import fused_ls as tfl
from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_step, reference_ls_step, split_w0
from gan_mpc_tpu_torch.params import from_jax_params
from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

torch.set_num_threads(1)
pin_fp32()

ATOL = 1e-5
N, M, GS, HIDDEN = 7, 3, 5, (32, 32)
AG_SCALE = 7.0
# (raw MPC weights, action goal squared)
CASES = [(3, False), (4, False), (4, True), (5, True), (5, False)]
CASE_IDS = ["3w", "4w_huber", "4w_squared", "5w_squared", "5w_huber"]


def _draw(B, A, seed):
    """Step inputs and a dynamics stack, float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)
    inputs = dict(
        x3=f((B, A, N)), Xref=f((B, N)), Uref=f((B, M), 0.3),
        alphaBA=np.abs(f((B, A))), k=f((B, M), 0.2), K=f((B, M, N), 0.2),
        goal=f((B, GS)), goal_u=f((B, M), 0.3),
    )
    widths = [N + M, *HIDDEN, N]
    layers = [(f((a, b), 1 / np.sqrt(a)), f(b, 0.1)) for a, b in zip(widths[:-1], widths[1:])]
    return inputs, layers


def _raw(dim):
    return np.linspace(-0.5, 0.8, dim).astype(np.float32)


def _jax_fused_weights(raw):
    """The JAX fused path's weights, as ``policies/mpc.py`` builds them."""
    w = jax.nn.sigmoid(raw)
    has_ag = raw.shape[-1] > 3
    w_ag = w[3] if has_ag else jnp.zeros(())
    gain = raw[4] if raw.shape[-1] > 4 else jnp.ones((), jnp.float32)
    return jnp.stack([w[0], w[1], w_ag, gain]).reshape(1, 4), AG_SCALE if has_ag else 0.0


def _port_cost(raw, squared):
    return MPCCost(CostFeatureNet(N, hidden=(8,), features_out=3), horizon=6,
                   mpc_weights=tuple(raw), action_goal_scale=AG_SCALE,
                   action_goal_squared=squared)


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _torch_layers(layers):
    return split_w0([(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers], N)


def _port_step(inputs, layers, raw, squared):
    wvec, ag_scale = _port_cost(raw, squared).stage_weights()
    with torch.no_grad():
        return fused_ls_step(**_torch(inputs), wvec=wvec, layers=_torch_layers(layers),
                             gs=GS, action_goal_squared=squared, ag_scale=ag_scale)


def _jax_step(inputs, layers, raw, squared):
    wvec, ag_scale = _jax_fused_weights(jnp.asarray(raw))
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    return fl.fused_ls_step(
        j["x3"], j["Xref"], j["Uref"], j["alphaBA"], j["k"], j["K"], j["goal"],
        j["goal_u"], wvec, tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers),
        gs=GS, action_goal_squared=squared, ag_scale=ag_scale,
    )


def _assert_step_close(got, ref):
    for name, g, r in zip(("nx", "u", "cost"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("raw_dim,squared", CASES, ids=CASE_IDS)
def test_step_matches_jax(raw_dim, squared):
    inputs, layers = _draw(8, 4, raw_dim)
    raw = _raw(raw_dim)
    _assert_step_close(_port_step(inputs, layers, raw, squared),
                       _jax_step(inputs, layers, raw, squared))


@pytest.mark.parametrize("raw_dim,squared", CASES, ids=CASE_IDS)
def test_step_matches_pallas_kernel_interpreted(raw_dim, squared):
    """The TPU kernel ``_kernel`` itself, interpreted: 8 drawn lanes tiled
    to the kernel's 128-lane block."""
    small, layers = _draw(8, 4, 10 + raw_dim)
    inputs = {k: np.tile(v, (fl._B_TILE // 8,) + (1,) * (v.ndim - 1)) for k, v in small.items()}
    raw = _raw(raw_dim)
    saved = fl._INTERPRET
    fl._INTERPRET = True
    try:
        ref = _jax_step(inputs, layers, raw, squared)
    finally:
        fl._INTERPRET = saved
    _assert_step_close(_port_step(inputs, layers, raw, squared), ref)


@pytest.mark.parametrize("raw_dim,squared", CASES, ids=CASE_IDS)
def test_fused_step_matches_the_separate_callbacks(raw_dim, squared):
    inputs, layers = _draw(8, 4, 20 + raw_dim)
    raw = _raw(raw_dim)
    dyn = LearnedDynamics(ResidualMLPDynamicsNet(N, M, hidden=HIDDEN))
    with torch.no_grad():
        for d, (w, b) in zip(dyn.net.layers, layers):
            d.kernel.copy_(torch.from_numpy(w))
            d.bias.copy_(torch.from_numpy(b))
    cost = _port_cost(raw, squared)
    t = _torch(inputs)
    B, A = t["alphaBA"].shape
    with torch.no_grad():
        du = torch.einsum("bmn,ban->bam", t["K"], t["x3"] - t["Xref"][:, None])
        u = t["Uref"][:, None] + t["alphaBA"][..., None] * t["k"][:, None] + du
        c = cost.stage_cost_batch(t["x3"], u, 0, t["goal"][None], t["goal_u"][None])
        nx = dyn.batch_apply(t["x3"].reshape(B * A, N), u.reshape(B * A, M))
        got = _port_step(inputs, layers, raw, squared)
    _assert_step_close(got, (nx.reshape(B, A, N), u, c))


@pytest.mark.parametrize("raw_dim", [3, 4, 5])
def test_both_cost_paths_take_weights_from_one_helper(raw_dim, monkeypatch):
    """``stage_cost_batch`` (fused_ls off) and the fused step (on) read
    the same (wvec, ag_scale) from ``MPCCost.stage_weights``, and it
    matches the JAX fused path's semantics."""
    seen = []
    helper = MPCCost.stage_weights

    def spy(self):
        out = helper(self)
        seen.append(out)
        return out

    monkeypatch.setattr(MPCCost, "stage_weights", spy)
    raw = _raw(raw_dim)
    hX = torch.from_numpy(0.1 * np.random.default_rng(raw_dim).standard_normal((2, 2, 17)))
    paths = {}
    for fused in ("off", "on"):
        policy = flagship(2, 1, device="cpu", seed=0, fused_ls=fused)
        policy.cost_model.weights = nn.Parameter(torch.from_numpy(raw), requires_grad=False)
        policy.cost_model.action_goal_scale = AG_SCALE
        seen.clear()
        policy.plan_batch(hX.float(), torch.zeros(2, 1, 6))
        paths[fused] = list(seen)
    assert paths["off"] and paths["on"]
    first_wvec, first_scale = paths["off"][0]
    ref_wvec, ref_scale = _jax_fused_weights(jnp.asarray(raw))
    np.testing.assert_allclose(first_wvec.numpy(), np.asarray(ref_wvec), rtol=1e-6, atol=0)
    assert first_scale == ref_scale
    for wvec, ag_scale in paths["off"] + paths["on"]:
        torch.testing.assert_close(wvec, first_wvec, rtol=0, atol=0)
        assert ag_scale == first_scale


def test_kernel_entry_refuses_what_it_does_not_take():
    inputs, layers = _draw(2, 3, 30)
    wvec, ag_scale = _port_cost(_raw(5), False).stage_weights()
    args = dict(**_torch(inputs), wvec=wvec.detach(), layers=_torch_layers(layers), gs=GS,
                action_goal_squared=False, ag_scale=ag_scale)
    before = tfl.fused_ls_kernel.launches, tfl.fused_ls_kernel_bf16.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfl.fused_ls_kernel(**args)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.fused_ls_kernel_bf16(**args)
    # bf16 on CPU tensors runs the plain bf16 step (the refusal this test
    # once held is gone: tests/test_torch_bf16.py holds the step to JAX)
    with torch.no_grad():
        got = fused_ls_step(**args, bf16=True)
        ref = reference_ls_step(**args, bf16=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (tfl.fused_ls_kernel.launches, tfl.fused_ls_kernel_bf16.launches) == before


H, ITERS, B_PLAN = 5, 5, 8
REST = np.concatenate([[0.64, 0.0, 0.9, -0.75, 0.35, 0.0, 0.0, 0.0], np.zeros(9)])


def test_plan_batch_fused_matches_jax_at_flagship_width(monkeypatch):
    """One fused-on solve at the first control step's input (zero history,
    rest pose + 0.01 noise). The port's step is counted, and the separate
    dynamics callback must not run."""
    jpolicy, jparams, x, u = graft._flagship(
        horizon=H, max_iterations=ITERS, x_size=17, u_size=6, fused_ls="on"
    )
    policy = from_jax_params(jax.device_get(jparams),
                             flagship(H, ITERS, x, u, device="cpu", fused_ls="on"))
    hX = np.zeros((B_PLAN, 2, x), np.float32)
    hX[:, 1] = REST + 0.01 * np.random.default_rng(0).standard_normal((B_PLAN, x))
    hU = np.zeros((B_PLAN, 1, u), np.float32)
    ref = jpolicy.plan_batch(jparams, jnp.asarray(hX), jnp.asarray(hU))
    ref_nudged = jpolicy.plan_batch(jparams, jnp.asarray(hX * (1 + 1e-7)), jnp.asarray(hU))
    assert np.abs(np.asarray(ref_nudged.U) - np.asarray(ref.U)).max() < 1e-4

    import gan_mpc_tpu_torch.policies.mpc as mpc

    calls = {"step": 0, "dynamics": 0}

    def counted_step(*args, **kwargs):
        calls["step"] += 1
        return fused_ls_step(*args, **kwargs)

    def no_dynamics(*args, **kwargs):
        calls["dynamics"] += 1
        raise AssertionError("the fused path ran the separate dynamics callback")

    monkeypatch.setattr(mpc, "fused_ls_step", counted_step)
    monkeypatch.setattr(LearnedDynamics, "batch_apply", no_dynamics)
    got = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    assert calls == {"step": mlp_calls_per_solve(H, ITERS, fused=True,
                                                     materialize=False)["fused_ls_step"],
                     "dynamics": 0}
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(ref.obj), rtol=1e-5, atol=1e-5)


class _NudgedResets:
    """The env with every reset state scaled by ``scale``."""

    def __init__(self, env, scale):
        self._env, self._scale = env, scale

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, params, key):
        s = self._env.reset(params, key)
        return s.replace(qpos=s.qpos * self._scale, qvel=s.qvel * self._scale)


def test_closed_loop_fused_matches_jax():
    """2 control steps of 8 envs, ``fused_ls="on"`` in both packages, from
    the JAX package's resets of key 9 (tolerances as the unfused slice
    test: actions, states, qpos, qvel atol 1e-3, rewards 1e-4)."""
    B, steps = 8, 2
    jpolicy, jparams, x, u = graft._flagship(
        horizon=H, max_iterations=ITERS, x_size=17, u_size=6, fused_ls="on"
    )
    jenv = jax_make_env("cheetah_run")
    key = jax.random.PRNGKey(9)

    def jax_rollout(env):
        return jax.jit(
            lambda p, k: jax_policy_rollout(
                env, env.default_params(), jpolicy, p, JaxNormalizer.identity(x, u),
                k, num_steps=steps, history=1, num_envs=B,
            )
        )(jparams, key)

    ref = jax_rollout(jenv)
    # the key's lanes stay clear of flips: rounding-sized changes to the
    # resets move JAX's own actions by far less than the tolerance
    for scale in (1 + 1e-7, 1 - 1e-7):
        nudged = jax_rollout(_NudgedResets(jenv, scale))
        assert np.abs(np.asarray(nudged.actions) - np.asarray(ref.actions)).max() < 1e-4
    resets = jax.vmap(lambda k: jenv.reset(jenv.default_params(), k))(
        jax.random.split(jax.random.split(key)[0], B)
    )
    init = EnvState(qpos=torch.tensor(np.asarray(resets.qpos)),
                    qvel=torch.tensor(np.asarray(resets.qvel)),
                    t=torch.zeros(B, dtype=torch.int32))
    policy = from_jax_params(jax.device_get(jparams),
                             flagship(H, ITERS, x, u, device="cpu", fused_ls="on"))
    env = make_env("cheetah_run", "cpu")
    got = policy_rollout(env, env.default_params(), policy, Normalizer.identity(x, u, "cpu"),
                         num_steps=steps, history=1, num_envs=B, init_state=init)
    for t in range(steps):
        for name, atol in [("states", 1e-3), ("actions", 1e-3), ("qpos", 1e-3),
                           ("qvel", 1e-3), ("rewards", 1e-4)]:
            np.testing.assert_allclose(
                getattr(got, name)[:, t].numpy(), np.asarray(getattr(ref, name))[:, t],
                rtol=0, atol=atol, err_msg=f"{name} at step {t}",
            )


def test_auto_resolves_by_device():
    """``fused_ls="auto"`` takes the fused step for CUDA inputs only, so a
    CPU solve under "auto" runs the separate callbacks, as "off" does."""
    hX = torch.from_numpy(0.1 * np.random.default_rng(5).standard_normal((2, 2, 17))).float()
    sols = {}
    for fused in ("off", "auto"):
        policy = flagship(2, 2, device="cpu", seed=0, fused_ls=fused)
        sols[fused] = policy.plan_batch(hX, torch.zeros(2, 1, 6))
    torch.testing.assert_close(sols["auto"].U, sols["off"].U, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,alphas", [(512, 16), (512, 1), (1000, 16),
                                          (1, 16), (1, 1), (9, 1), (65, 1)])
def test_kernel_matches_reference_on_gpu(lanes, alphas):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs, layers = _draw(lanes, alphas, 40)
    wvec, ag_scale = _port_cost(_raw(5), True).stage_weights()
    args = dict(**{k: v.to(dev) for k, v in _torch(inputs).items()},
                wvec=wvec.detach().to(dev),
                layers=split_w0([(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev))
                                 for w, b in layers], N),
                gs=GS, action_goal_squared=True, ag_scale=ag_scale)
    with torch.no_grad():
        got = fused_ls_step(**args)
        ref = reference_ls_step(**args)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())
