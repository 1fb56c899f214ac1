"""Port parity: ``gan_mpc_tpu_torch.ops.fused_mlp`` against the JAX op.

Inputs and weights come from a numpy seed and go through both packages
as float32 on the CPU. The fused forward is held against the JAX plain
forward and against the Pallas kernel itself, run in interpret mode as
``tests/test_ops.py`` runs it. Tolerance: atol 1e-5 (float32, summation
order differs between XLA and torch). The backward (``reference_backward``
and autograd through ``mlp_apply``) is held the same way against the JAX
custom VJP and the interpreted ``_bwd_kernel``, with atol 1e-6 *
max(1, max|ref|) per output: dW sums 300 rows of products, so its f32
rounding grows with its magnitude (about 32 on the dynamics stack).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.ops import _build
from gan_mpc_tpu_torch.ops.fused_mlp import (
    fused_mlp_backward,
    fused_mlp_forward,
    mlp_apply,
    mlp_value_and_jac,
    reference_backward,
    reference_forward,
)

# importlib: the JAX ops package re-exports a function under the module name
jfm = importlib.import_module("gan_mpc_tpu.ops.fused_mlp")

torch.set_num_threads(1)
pin_fp32()

ATOL = 1e-5
DYNAMICS = [23, 200, 200, 200, 17]  # flagship residual dynamics (fin > fout)
COST = [17, 128, 128, 10]  # flagship cost feature net (fin > fout)
WIDE = [23, 256, 256, 256, 17]  # the gan/4 checkpoint's dynamics widths
INPUT_SIDE = [6, 32, 32, 12]  # fout >= fin: input-side Jacobian chain
SINGLE = [3, 8]


def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [
        (
            (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            (0.1 * rng.standard_normal(b)).astype(np.float32),
        )
        for a, b in zip(widths[:-1], widths[1:])
    ]


def _inputs(rows, fin, seed):
    return np.random.default_rng(seed).standard_normal((rows, fin)).astype(np.float32)


def _torch(layers):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]


def _jax(layers):
    return tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)


@pytest.mark.parametrize("widths", [DYNAMICS, COST, WIDE, SINGLE],
                         ids=["dynamics", "cost", "wide", "single"])
def test_forward_matches_jax_reference(widths):
    layers = _layers(widths, 0)
    x = _inputs(300, widths[0], 1)  # ragged: not a multiple of any tile
    ref = np.asarray(jfm._reference_forward(jnp.asarray(x), _jax(layers)))
    got = mlp_apply(torch.from_numpy(x), _torch(layers))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), reference_forward(torch.from_numpy(x), _torch(layers)).numpy()
    )


@pytest.mark.parametrize("widths", [DYNAMICS, COST], ids=["dynamics", "cost"])
def test_forward_matches_pallas_kernel_interpreted(widths):
    """The TPU kernel ``_fwd_kernel`` itself, interpreted, on 300 rows
    padded to three 128-row tiles."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    layers = _layers(widths, 2)
    x = _inputs(300, widths[0], 3)
    wb_flat = [a for w, b in _jax(layers) for a in (w, b)]
    tile, padded, fout = 128, 384, widths[-1]
    xp = jfm._pad_rows(jnp.asarray(x), padded)
    out = pl.pallas_call(
        functools.partial(jfm._fwd_kernel, len(layers)),
        grid=(padded // tile,),
        in_specs=[
            pl.BlockSpec((tile, widths[0]), lambda i: (i, 0), memory_space=pltpu.VMEM)
        ]
        + [
            pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd,
                         memory_space=pltpu.VMEM)
            for a in wb_flat
        ],
        out_specs=pl.BlockSpec((tile, fout), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((padded, fout), jnp.float32),
        interpret=True,
    )(xp, *wb_flat)
    got = mlp_apply(torch.from_numpy(x), _torch(layers))
    np.testing.assert_allclose(got.numpy(), np.asarray(out[:300]), rtol=0, atol=ATOL)


def _assert_grads_close(got, ref):
    """got, ref: (dx, [(dW, db), ...]) as numpy-convertible arrays."""
    pairs = [("dx", got[0], ref[0])]
    for i, ((gw, gb), (rw, rb)) in enumerate(zip(got[1], ref[1])):
        pairs += [(f"dW{i}", gw, rw), (f"db{i}", gb, rb)]
    for name, g, r in pairs:
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


def _jax_vjp(x, layers, g):
    _, vjp = jax.vjp(jfm.fused_mlp, jnp.asarray(x), _jax(layers))
    dx, grads = vjp(jnp.asarray(g))
    return dx, list(grads)


@pytest.mark.parametrize("widths", [DYNAMICS, COST, WIDE, SINGLE],
                         ids=["dynamics", "cost", "wide", "single"])
def test_backward_matches_jax_vjp(widths):
    """``reference_backward`` and autograd through ``mlp_apply`` on the
    CPU, against ``jax.vjp`` of the JAX ``fused_mlp`` custom VJP."""
    layers = _layers(widths, 12)
    x = _inputs(300, widths[0], 13)
    g = _inputs(300, widths[-1], 14)
    ref = _jax_vjp(x, layers, g)
    got = reference_backward(torch.from_numpy(x), _torch(layers), torch.from_numpy(g))
    _assert_grads_close(got, ref)

    xt = torch.from_numpy(x).requires_grad_(True)
    lt = [(w.requires_grad_(True), b.requires_grad_(True)) for w, b in _torch(layers)]
    mlp_apply(xt, lt).backward(torch.from_numpy(g))
    _assert_grads_close((xt.grad, [(w.grad, b.grad) for w, b in lt]), ref)


@pytest.mark.parametrize("widths", [DYNAMICS, COST], ids=["dynamics", "cost"])
def test_backward_matches_pallas_kernel_interpreted(widths):
    """The TPU kernel ``_bwd_kernel`` itself, interpreted, on 300 rows
    padded to three 128-row tiles (its grid accumulates dW and db)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    layers = _layers(widths, 15)
    x = _inputs(300, widths[0], 16)
    g = _inputs(300, widths[-1], 17)
    wb_flat = [a for w, b in _jax(layers) for a in (w, b)]
    tile, padded, fin, fout = 128, 384, widths[0], widths[-1]
    vmem = lambda shape, index: pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)
    whole = [vmem(a.shape, lambda i, nd=a.ndim: (0,) * nd) for a in wb_flat]
    dx, *dwb = pl.pallas_call(
        functools.partial(jfm._bwd_kernel, len(layers)),
        grid=(padded // tile,),
        in_specs=[vmem((tile, fin), lambda i: (i, 0)),
                  vmem((tile, fout), lambda i: (i, 0))] + whole,
        out_specs=[vmem((tile, fin), lambda i: (i, 0))] + whole,
        out_shape=[jax.ShapeDtypeStruct((padded, fin), jnp.float32)]
        + [jax.ShapeDtypeStruct(a.shape, jnp.float32) for a in wb_flat],
        interpret=True,
    )(jfm._pad_rows(jnp.asarray(x), padded), jfm._pad_rows(jnp.asarray(g), padded), *wb_flat)
    ref = (dx[:300], list(zip(dwb[0::2], dwb[1::2])))
    got = reference_backward(torch.from_numpy(x), _torch(layers), torch.from_numpy(g))
    _assert_grads_close(got, ref)


@pytest.mark.parametrize("widths", [DYNAMICS, COST, INPUT_SIDE, SINGLE],
                         ids=["dynamics", "cost", "input_side", "single"])
def test_value_and_jac_matches_jax(widths):
    """Both chain directions: output-side (fout < fin) and input-side."""
    layers = _layers(widths, 4)
    x = _inputs(300, widths[0], 5)
    y_ref, J_ref = jfm.mlp_value_and_jac(jnp.asarray(x), _jax(layers))
    y, J = mlp_value_and_jac(torch.from_numpy(x), _torch(layers))
    assert J.shape == (300, widths[-1], widths[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=0, atol=ATOL)


def test_kernel_entry_refuses_cpu_tensors():
    layers = _torch(_layers(COST, 6))
    before = fused_mlp_forward.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_forward(torch.from_numpy(_inputs(8, 17, 7)), layers)
    assert fused_mlp_forward.launches == before


def test_backward_kernel_entry_refuses_cpu_tensors():
    layers = _torch(_layers(COST, 6))
    before = fused_mlp_backward.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_backward(torch.from_numpy(_inputs(8, 17, 7)), layers,
                           torch.from_numpy(_inputs(8, 10, 8)))
    assert fused_mlp_backward.launches == before


def test_bfloat16_compute_is_not_ported():
    """Once a refusal, now the bf16 path's parity on the cost stack (the
    dtype given as a torch dtype and as a name): ``mlp_apply`` and
    ``mlp_value_and_jac`` against JAX at bf16, atol 1e-5 (bfloat16 products
    are exact in f32; only the f32 sums' order differs). The dynamics-class
    stacks and the gradient: ``tests/test_torch_bf16.py``."""
    widths = _layers(COST, 8)
    layers = _torch(widths)
    x = _inputs(4, 17, 9)
    ref = jfm.mlp_apply(jnp.asarray(x), _jax(widths), jnp.bfloat16)
    got = mlp_apply(torch.from_numpy(x), layers, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    y_ref, J_ref = jfm.mlp_value_and_jac(jnp.asarray(x), _jax(widths), jnp.bfloat16)
    y, J = mlp_value_and_jac(torch.from_numpy(x), layers, "bfloat16")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=0, atol=ATOL)


def test_build_is_keyed_by_source_and_raises_when_nvcc_fails(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "k.cu"
    src.write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")  # exits 1
    first = _build.library_path("k")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_library("k")
    assert not first.exists()
    assert [p.suffix for p in (tmp_path / "_build").iterdir()] == [".log"]
    src.write_text("still not CUDA\n")
    assert _build.library_path("k") != first


@pytest.mark.gpu
@pytest.mark.parametrize("widths,rows", [(DYNAMICS, 8192), (DYNAMICS, 1000),
                                         (WIDE, 8192), (COST, 512),
                                         (DYNAMICS, 512), (DYNAMICS, 16), (DYNAMICS, 1),
                                         (COST, 8192), (WIDE, 512),
                                         ([23, 41, 17], 65), ([23, 512, 512, 17], 300)])
def test_kernel_matches_reference_on_gpu(widths, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    layers = [(w.to(dev), b.to(dev)) for w, b in _torch(_layers(widths, 10))]
    x = torch.from_numpy(_inputs(rows, widths[0], 11)).to(dev)
    ref = reference_forward(x, layers)
    got = mlp_apply(x, layers)
    bound = 1e-4 * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("widths,rows", [(DYNAMICS, 128), (DYNAMICS, 1000), (DYNAMICS, 8192),
                                         (WIDE, 128), (COST, 512),
                                         # no width a multiple of 8, ragged against 16 rows;
                                         # the humanoid-class widths, ragged
                                         ([23, 41, 17], 65), ([41, 200, 200, 200, 29], 130)])
def test_backward_kernel_matches_reference_on_gpu(widths, rows):
    """The backward kernel against ``reference_backward`` on the card, and
    autograd through ``mlp_apply`` launching it once per backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    layers = [(w.to(dev), b.to(dev)) for w, b in _torch(_layers(widths, 18))]
    x = torch.from_numpy(_inputs(rows, widths[0], 19)).to(dev)
    g = torch.from_numpy(_inputs(rows, widths[-1], 20)).to(dev)
    ref = reference_backward(x, layers, g)
    got = fused_mlp_backward(x, layers, g)
    outs = [(got[0], ref[0])] + [p for gw, rw in zip(got[1], ref[1]) for p in zip(gw, rw)]
    for k, r in outs:
        assert (k - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())

    params = [t.clone().requires_grad_(True) for wb in layers for t in wb]
    before = fused_mlp_backward.launches
    mlp_apply(x, list(zip(params[0::2], params[1::2]))).backward(g)
    assert fused_mlp_backward.launches == before + 1
    for p, (k, _) in zip(params, outs[1:]):
        assert torch.equal(p.grad, k)  # the kernel's sums do not depend on the run
