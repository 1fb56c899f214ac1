"""Port parity: the bfloat16 compute path against the JAX package.

``compute_dtype="bfloat16"`` rounds both operands of the dynamics net's
products to bfloat16 (to nearest, ties to even) and accumulates in f32
(the JAX ``_mm``). Inputs and weights come from a numpy seed and go
through both packages as float32 on the CPU:

  1. ``mlp_apply`` and ``mlp_value_and_jac`` at bf16 on the 7->32->32->5
     stack of ``tests/test_ops.py`` and on 23->64->64->17, against JAX at
     bf16: atol 1e-5 (the products are exact in f32 in both; only the
     order of the f32 sums differs; measured 1.2e-7). The Jacobian chain
     rounds each f32 chain product to bfloat16 before the next GEMM, so a
     sum-order difference that straddles a bfloat16 rounding boundary moves
     the entries it feeds by up to one bfloat16 ulp (2^-8 relative): there
     at most 0.1% of the entries may exceed 1e-5, and every entry stays
     within 2^-8 max(1, max|J|) (measured: 21 of 117,300 at 1.6e-4). Each
     output is also held away from the f32 result (more than 1e-3), so that
     the test sees the rounding;
  2. the gradient of ``mlp_apply`` at bf16 against ``jax.grad``: atol
     1e-5 max(1, max|ref|). ``jax.grad`` rounds the cotangent of each
     product's operands to bfloat16 on its way back through the cast;
     autograd through ``bf16_round`` does the same, and without that
     rounding the gradients would differ by ~1e-2;
  3. the bf16 fused line-search step (``reference_ls_step``) against the
     JAX ``fused_ls_step(bf16=True)``, its jnp form and the Pallas kernel
     ``_kernel`` in interpret mode (which runs the bf16 dots), for 3, 4
     and 5 raw MPC weights and both action-goal forms, atol 1e-5; and
     against the port's own separate bf16 callbacks;
  4. one flagship ``plan_batch`` at bf16 (H=5, 2 iLQR trips) with fused_ls
     off and on, weights carried across by ``from_jax_params``, against
     JAX's: each lane's U within max(1e-4, twice JAX's own spread of that
     lane under 1 +- 1e-7 and 1 +- 2e-7 scalings of the histories), equal
     ``iterations`` and ``converged``. A bfloat16 solve amplifies rounding
     far more than an f32 one: a rounding flip of one operand is a 2^-8
     relative step, and at the flagship's 5 trips JAX against itself moves
     by up to 0.38 under those nudges (2.4e-3 at 2 trips; the port against
     JAX 3.5e-5 at 2 trips). The differentiable ``plan`` ignores the
     dtype, as JAX's ``plan`` (per-instance ``ilqr``) does.
The kernels' bf16 instances against their plain versions are ``gpu``
tests and skip without a card; ``chip_smoke.py`` phase 16 runs that check
on the card.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import gan_mpc_tpu.ops.fused_ls as fl
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import flagship
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.ops import fused_ls as tfl
from gan_mpc_tpu_torch.ops.fused_mlp import (
    bf16_round,
    compute_is_bf16,
    fused_mlp_forward_bf16,
    mlp_apply,
    mlp_value_and_jac,
    reference_forward,
)
from gan_mpc_tpu_torch.params import from_jax_params
from test_torch_fused_ls import (
    CASE_IDS,
    CASES,
    GS,
    M,
    N,
    _draw,
    _jax_fused_weights,
    _port_cost,
    _raw,
    _torch,
    _torch_layers,
)

jfm = importlib.import_module("gan_mpc_tpu.ops.fused_mlp")

torch.set_num_threads(1)
pin_fp32()

ATOL = 1e-5
STACKS = {"ops_test": [7, 32, 32, 5], "dynamics_class": [23, 64, 64, 17]}


def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.standard_normal(b)).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


def _inputs(rows, fin, seed):
    return np.random.default_rng(seed).standard_normal((rows, fin)).astype(np.float32)


def _tl(layers):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]


def _jl(layers):
    return tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)


def test_bf16_round_is_round_to_nearest_even():
    """bfloat16 keeps 8 significant bits: 1 + 2^-8 is a tie (to 1, the
    even neighbour), 1 + 3 * 2^-8 rounds up to 1 + 2^-6 (even), and the
    result is JAX's ``astype(jnp.bfloat16)`` on random values too."""
    t = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1 + 2 ** -7])
    assert bf16_round(t).tolist() == [1.0, 1 + 2 ** -6, -1.0, 1 + 2 ** -7]
    x = _inputs(64, 9, 3)
    np.testing.assert_array_equal(
        bf16_round(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))
    assert [compute_is_bf16(d) for d in (None, "float32", torch.float32, "bfloat16",
                                         torch.bfloat16)] == [False] * 3 + [True] * 2
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        compute_is_bf16("float16")


@pytest.mark.parametrize("widths", STACKS.values(), ids=STACKS.keys())
def test_mlp_apply_bf16_matches_jax(widths):
    layers = _layers(widths, 0)
    x = _inputs(300, widths[0], 1)
    ref = np.asarray(jfm.mlp_apply(jnp.asarray(x), _jl(layers), jnp.bfloat16))
    got = mlp_apply(torch.from_numpy(x), _tl(layers), "bfloat16")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert got.dtype == torch.float32
    f32 = mlp_apply(torch.from_numpy(x), _tl(layers))
    assert (got - f32).abs().max().item() > 1e-3
    np.testing.assert_array_equal(
        got.numpy(), reference_forward(torch.from_numpy(x), _tl(layers), True).numpy())


@pytest.mark.parametrize("widths", STACKS.values(), ids=STACKS.keys())
def test_value_and_jac_bf16_matches_jax(widths):
    """The forward and the Jacobian chain's products at bf16, the masks
    and the bias and relu tail f32."""
    layers = _layers(widths, 4)
    x = _inputs(300, widths[0], 5)
    y_ref, J_ref = jfm.mlp_value_and_jac(jnp.asarray(x), _jl(layers), jnp.bfloat16)
    y, J = mlp_value_and_jac(torch.from_numpy(x), _tl(layers), "bfloat16")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    J_ref = np.asarray(J_ref)
    d = np.abs(J.numpy() - J_ref)
    assert (d > ATOL).mean() <= 1e-3
    assert d.max() <= 2.0 ** -8 * max(1.0, np.abs(J_ref).max())
    _, J32 = mlp_value_and_jac(torch.from_numpy(x), _tl(layers))
    assert (J - J32).abs().max().item() > 1e-3


@pytest.mark.parametrize("widths", STACKS.values(), ids=STACKS.keys())
def test_bf16_gradient_matches_jax_grad(widths):
    layers = _layers(widths, 6)
    x = _inputs(300, widths[0], 7)
    g = _inputs(300, widths[-1], 8)

    def jloss(xj, params):
        return jnp.sum(jfm.mlp_apply(xj, params, jnp.bfloat16) * g)

    ref_x, ref_p = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), _jl(layers))
    xt = torch.from_numpy(x).requires_grad_()
    params = [(w.clone().requires_grad_(), b.clone().requires_grad_()) for w, b in _tl(layers)]
    (mlp_apply(xt, params, "bfloat16") * torch.from_numpy(g)).sum().backward()
    pairs = [(xt.grad, ref_x)] + [(t.grad, r) for (w, b), (rw, rb) in zip(params, ref_p)
                                  for t, r in ((w, rw), (b, rb))]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(ref).max()))


def _port_step(inputs, layers, raw, squared, bf16=True):
    wvec, ag_scale = _port_cost(raw, squared).stage_weights()
    with torch.no_grad():
        return tfl.fused_ls_step(**_torch(inputs), wvec=wvec, layers=_torch_layers(layers),
                                 gs=GS, action_goal_squared=squared, ag_scale=ag_scale,
                                 bf16=bf16)


def _jax_step(inputs, layers, raw, squared):
    wvec, ag_scale = _jax_fused_weights(jnp.asarray(raw))
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    return fl.fused_ls_step(
        j["x3"], j["Xref"], j["Uref"], j["alphaBA"], j["k"], j["K"], j["goal"], j["goal_u"],
        wvec, _jl(layers), gs=GS, action_goal_squared=squared, ag_scale=ag_scale, bf16=True)


def _assert_step_close(got, ref):
    for name, g, r in zip(("nx", "u", "cost"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("raw_dim,squared", CASES, ids=CASE_IDS)
def test_ls_step_bf16_matches_jax(raw_dim, squared):
    inputs, layers = _draw(8, 4, 40 + raw_dim)
    raw = _raw(raw_dim)
    got = _port_step(inputs, layers, raw, squared)
    _assert_step_close(got, _jax_step(inputs, layers, raw, squared))
    f32 = _port_step(inputs, layers, raw, squared, bf16=False)
    assert (got[0] - f32[0]).abs().max().item() > 1e-4  # the MLP's products are bf16's
    torch.testing.assert_close(got[1], f32[1], rtol=0, atol=0)  # the control law is f32
    torch.testing.assert_close(got[2], f32[2], rtol=0, atol=0)  # so is the stage cost


@pytest.mark.parametrize("raw_dim,squared", CASES, ids=CASE_IDS)
def test_ls_step_bf16_matches_pallas_kernel_interpreted(raw_dim, squared, monkeypatch):
    """The TPU kernel's bf16 variant itself, interpreted (its bf16 dots
    run in interpret mode): 8 drawn lanes tiled to the 128-lane block."""
    small, layers = _draw(8, 4, 50 + raw_dim)
    inputs = {k: np.tile(v, (fl._B_TILE // 8,) + (1,) * (v.ndim - 1)) for k, v in small.items()}
    raw = _raw(raw_dim)
    monkeypatch.setattr(fl, "_INTERPRET", True)
    ref = _jax_step(inputs, layers, raw, squared)
    _assert_step_close(_port_step(inputs, layers, raw, squared), ref)


@pytest.mark.parametrize("raw_dim,squared", CASES[:2], ids=CASE_IDS[:2])
def test_ls_step_bf16_matches_the_separate_callbacks(raw_dim, squared):
    """The bf16 step against the port's bf16 ``batch_apply`` and its
    stage cost (the fused_ls="off" path at bf16)."""
    inputs, layers = _draw(8, 4, 60 + raw_dim)
    raw = _raw(raw_dim)
    dyn = LearnedDynamics(ResidualMLPDynamicsNet(N, M, hidden=(32, 32)))
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
        nx = dyn.batch_apply(t["x3"].reshape(B * A, N), u.reshape(B * A, M), "bfloat16")
        got = _port_step(inputs, layers, raw, squared)
    _assert_step_close(got, (nx.reshape(B, A, N), u, c))


H, ITERS, B_PLAN = 5, 2, 8
REST = np.concatenate([[0.64, 0.0, 0.9, -0.75, 0.35, 0.0, 0.0, 0.0], np.zeros(9)])


def _policies(fused_ls, compute_dtype="bfloat16"):
    jpolicy, jparams, x, u = graft._flagship(horizon=H, max_iterations=ITERS, x_size=17,
                                             u_size=6, compute_dtype=compute_dtype,
                                             fused_ls=fused_ls)
    policy = from_jax_params(jax.device_get(jparams),
                             flagship(H, ITERS, x, u, device="cpu", fused_ls=fused_ls,
                                      compute_dtype=compute_dtype))
    return jpolicy, jparams, policy


def _histories():
    hX = np.zeros((B_PLAN, 2, 17), np.float32)
    hX[:, 1] = REST + 0.01 * np.random.default_rng(0).standard_normal((B_PLAN, 17))
    return hX, np.zeros((B_PLAN, 1, 6), np.float32)


@pytest.mark.parametrize("fused_ls", ["off", "on"])
def test_plan_batch_bf16_matches_jax(fused_ls):
    jpolicy, jparams, policy = _policies(fused_ls)
    hX, hU = _histories()
    ref = jpolicy.plan_batch(jparams, jnp.asarray(hX), jnp.asarray(hU))
    ref_U = np.asarray(ref.U)
    spread = np.zeros(B_PLAN)
    for scale in (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7):
        nudged = jpolicy.plan_batch(jparams, jnp.asarray(hX * scale), jnp.asarray(hU))
        spread = np.maximum(spread, np.abs(np.asarray(nudged.U) - ref_U).max(axis=(1, 2)))
    got = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    d = np.abs(got.U.numpy() - ref_U).max(axis=(1, 2))
    assert np.all(d <= np.maximum(1e-4, 2 * spread)), (d, spread)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    # and the dtype is in use: the f32 plan of the same weights differs
    f32 = dataclasses.replace(policy.settings, compute_dtype="float32")
    policy.settings = f32
    assert (policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU)).U
            - got.U).abs().max().item() > 1e-4


def test_plan_ignores_compute_dtype():
    """The differentiable ``plan`` solves in f32 at either dtype (the JAX
    ``plan`` runs the per-instance ``ilqr``, which does not read it)."""
    _, _, policy = _policies("off")
    hX, hU = _histories()
    hX, hU = torch.from_numpy(hX[:2]), torch.from_numpy(hU[:2])
    with torch.no_grad():
        bf = policy.plan(hX, hU)
        policy.settings = dataclasses.replace(policy.settings, compute_dtype="float32")
        f32 = policy.plan(hX, hU)
    torch.testing.assert_close(bf.U, f32.U, rtol=0, atol=0)


def test_bf16_kernel_entries_refuse_cpu_tensors():
    inputs, layers = _draw(2, 3, 70)
    wvec, ag_scale = _port_cost(_raw(5), False).stage_weights()
    args = dict(**_torch(inputs), wvec=wvec.detach(), layers=_torch_layers(layers), gs=GS,
                action_goal_squared=False, ag_scale=ag_scale)
    before = (tfl.fused_ls_kernel_bf16.launches, fused_mlp_forward_bf16.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.fused_ls_kernel_bf16(**args)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_forward_bf16(torch.from_numpy(_inputs(8, 7, 9)), _tl(_layers([7, 32, 5], 1)))
    assert (tfl.fused_ls_kernel_bf16.launches, fused_mlp_forward_bf16.launches) == before
    assert tfl.fused_ls_kernel_bf16.bf16 and fused_mlp_forward_bf16.bf16
    assert not tfl.fused_ls_kernel.bf16


# of the entries beyond 1e-4 of plain bf16: a flipped bfloat16 rounding of
# a hidden activation is rare, unrounded operands move nearly every entry
BF16_FAR_SHARE = 0.02


def _far_share(got, ref):
    return ((got - ref).abs() > 1e-4).float().mean().item()


def _on_card(t, offset, dev):
    """``t`` on ``dev``, ``offset`` floats into a buffer of its own (1: not
    16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


DYNAMICS = [23, 200, 200, 200, 17]


@pytest.mark.gpu
@pytest.mark.parametrize("widths,rows,offset", [
    (DYNAMICS, 8192, 0), (DYNAMICS, 512, 0), (DYNAMICS, 37, 0),
    # chip_smoke.py phase 16 (a)'s edge cases of the bf16 products: 256
    # columns on the 64-row tile (the ensemble member, gan/4),
    # 512 on the 16-row tile, 1 row, a ragged 64-row tile, unaligned weights
    ([41, 256, 256, 256, 29], 8192, 0), ([23, 256, 256, 256, 17], 8192, 0),
    ([23, 512, 512, 17], 512, 0), (DYNAMICS, 1, 0), (DYNAMICS, 8200, 0),
    (DYNAMICS, 8192, 1), (DYNAMICS, 512, 1)])
def test_fused_mlp_fwd_bf16_matches_plain_on_the_card(widths, rows, offset):
    """The forward kernel's bf16 instance against the plain bf16 forward:
    max|d| <= 1e-2 max(1, max|ref|) (an f32 sum in another order can flip
    a hidden activation's bfloat16 rounding by one ulp), and at most 2% of
    the entries beyond 1e-4 (unrounded operands move nearly all of them,
    as the f32 instance's output shows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    layers = [(_on_card(w, offset, dev), _on_card(b, offset, dev))
              for w, b in _tl(_layers(widths, 11))]
    x = torch.from_numpy(_inputs(rows, widths[0], 12)).to(dev)
    with torch.no_grad():
        got = mlp_apply(x, layers, "bfloat16")
        ref = reference_forward(x, layers, True)
        unrounded = mlp_apply(x, layers)
    assert (got - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item())
    assert _far_share(got, ref) <= BF16_FAR_SHARE < _far_share(unrounded, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,alphas,offset", [
    (512, 16, 0), (512, 1, 0), (128, 16, 0),
    # phase 16 (a)'s risky shapes: 1 row, a ragged 64-row tile, unaligned weights
    (1, 1, 0), (513, 16, 0), (512, 16, 1), (512, 1, 1)])
def test_fused_ls_step_bf16_matches_plain_on_the_card(lanes, alphas, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    inputs, layers = _draw(lanes, alphas, 71)
    wvec, ag_scale = _port_cost(_raw(5), False).stage_weights()
    card = lambda t: _on_card(t, offset, dev)  # noqa: E731
    args = dict(**{k: v.to(dev) for k, v in _torch(inputs).items()}, wvec=wvec.to(dev),
                layers=[(tuple(map(card, w)) if isinstance(w, tuple) else card(w), card(b))
                        for w, b in _torch_layers(layers)],
                gs=GS, action_goal_squared=False, ag_scale=ag_scale)
    with torch.no_grad():
        got = tfl.fused_ls_kernel_bf16(**args)
        ref = tfl.reference_ls_step(**args, bf16=True)
        unrounded = tfl.fused_ls_kernel(**args)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-2 * max(1.0, r.abs().max().item())
        assert _far_share(g, r) <= BF16_FAR_SHARE
    assert _far_share(unrounded[0], ref[0]) > BF16_FAR_SHARE


@pytest.mark.parametrize("fused_ls", ["off", "on"])
def test_mlp_calls_per_solve_names_the_bf16_instances(fused_ls, monkeypatch):
    """The launches a bf16 solve makes on the card, counted on the CPU: each
    plain forward stands for one launch of the instance its dtype selects
    (``mlp_apply`` on CUDA sends bf16 to ``fused_mlp_fwd_bf16``, f32 to
    ``fused_mlp_fwd``), each fused step for one ``fused_ls_step_bf16``;
    ``mlp_calls_per_solve(bf16=True)`` reckons them."""
    from gan_mpc_tpu_torch.ops import fused_mlp
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.policies import mpc

    counts = dict.fromkeys(("fused_mlp_fwd", "fused_ls_step", "fused_mlp_fwd_bf16",
                            "fused_ls_step_bf16"), 0)
    plain, step = fused_mlp.reference_forward, mpc.fused_ls_step

    def forward(x, layers, bf16=False):  # a call over 0 rows launches nothing
        counts["fused_mlp_fwd_bf16" if bf16 else "fused_mlp_fwd"] += x.shape[0] > 0
        return plain(x, layers, bf16)

    def fused(*args, bf16=False, **kwargs):
        counts["fused_ls_step_bf16" if bf16 else "fused_ls_step"] += args[0].numel() > 0
        return step(*args, bf16=bf16, **kwargs)

    monkeypatch.setattr(fused_mlp, "reference_forward", forward)
    monkeypatch.setattr(mpc, "fused_ls_step", fused)
    _, _, policy = _policies(fused_ls)
    hX, hU = _histories()
    sol = policy.plan_batch(torch.from_numpy(hX[:2]), torch.from_numpy(hU[:2]))
    assert counts == mlp_calls_per_solve(H, sol.trips, fused=fused_ls == "on", bf16=True)
    assert counts["fused_mlp_fwd_bf16" if fused_ls == "off" else "fused_ls_step_bf16"] > 0


def test_bench_knobs_reach_the_settings_and_the_row():
    """``--dtype``, ``--riccati`` and ``--num-steps`` (the JAX bench's
    BENCH_DTYPE, BENCH_RICCATI, BENCH_NUM_STEPS) reach the flagship's
    settings and are named in the row where they are not the defaults."""
    from gan_mpc_tpu_torch import bench

    policy = flagship(5, 1, device="cpu", compute_dtype="bfloat16", riccati="associative")
    s = policy.settings
    assert (s.compute_dtype, s.riccati) == ("bfloat16", "associative")
    row = bench.bench_row(1.0, "card", "off", compute_dtype="bfloat16", riccati="associative",
                          num_steps=10)
    assert ("fused_ls=off, dtype=bfloat16, riccati=associative, steps=10, torch port"
            in row["metric"])
    assert "dtype" not in bench.bench_row(1.0, "card", "off")["metric"]
