"""The kernels on stacks of any depth and width, on the card.

Every stack of ``chip_smoke.py``'s phase 19 (a) through each kernel
instance against its plain version, with one launch counted per call:
the forward at f32 and bf16 and the line-search step at f32 and bf16
(n = 17, m = 6, the same hidden widths), the backward on rows clear of
relu kinks, a second call bitwise equal. Bounds as phase 19 (a): the f32
instances 1e-4 max(1, max|ref|); the bf16 instances max|d| <= 1e-2 max(1,
max|ref|), and from 512 rows on a share of entries beyond 1e-4 within
max(2%, twice that of the same function on the tensor cores by cuBLAS).

These tests import no JAX, so they run on a host with a card alone:

    python -m pytest tests/test_torch_wide_stacks_gpu.py --noconftest -p no:cacheprovider

(``--noconftest``: the suite's conftest imports JAX). Without a card they
skip.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_kernel, fused_ls_kernel_bf16, reference_ls_step
from gan_mpc_tpu_torch.ops.fused_mlp import (
    bwd_route,
    fused_mlp_backward,
    fused_mlp_forward,
    fused_mlp_forward_bf16,
    fwd_route,
    reference_backward,
    reference_forward,
)

FWD = [(name, dims, rows) for name, dims in cs.G19_FWD for rows in cs.G19_FWD_ROWS]
STEP = [(name, dims, lanes, alphas) for name, dims in cs.G19_FWD for lanes, alphas in cs.G19_LS]
BWD = [(name, dims, rows) for name, dims in cs.G19_BWD for rows in cs.G19_BWD_ROWS]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_fp32()
    return torch.device("cuda")


def _share(a, b):
    return ((a - b).abs() > 1e-4).float().mean().item() if b.numel() else 0.0


def _launched(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


def _hold(got, ref, bf16=False, plain=None, rows=0):
    bound = None if plain is None else max(cs.BF16_FAR_SHARE,
                                           2 * max(_share(r, p) for r, p in zip(ref, plain)))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if not r.numel():
            continue
        tol = (cs.BF16_TOL if bf16 else 1e-4) * max(1.0, r.abs().max().item())
        assert (g - r).abs().max().item() <= tol
        if bound is not None and rows >= cs.G19_SHARE_ROWS:
            assert _share(g, r) <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("name,dims,rows", FWD, ids=[f"{n}-{r}" for n, _, r in FWD])
def test_wide_forward_matches_plain_and_counts_a_launch(dev, name, dims, rows):
    layers = cs.random_layers(dims, 7, dev)
    x = torch.tensor(np.random.default_rng(rows).standard_normal((rows, dims[0])),
                     dtype=torch.float32, device=dev)
    if rows:
        assert fwd_route(rows, dims, torch.cuda.get_device_properties(dev).multi_processor_count
                         )[0] == "wide"
    with torch.no_grad():
        got = _launched(fused_mlp_forward, lambda: fused_mlp_forward(x, layers))
        _hold((got,), (reference_forward(x, layers),))
        got = _launched(fused_mlp_forward_bf16, lambda: fused_mlp_forward_bf16(x, layers))
        with cs.tensor_core_products():
            plain = reference_forward(x, layers, True)
        _hold((got,), (reference_forward(x, layers, True),), True, (plain,), rows)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dims,lanes,alphas", STEP,
                         ids=[f"{n}-{b}x{a}" for n, _, b, a in STEP])
def test_wide_step_matches_plain_and_counts_a_launch(dev, name, dims, lanes, alphas):
    args = cs.ls_args(lanes, alphas, 17, 6, 17, cs.LS_WEIGHTS[3], 9, dev, hidden=dims[1:-1])
    with torch.no_grad():
        got = _launched(fused_ls_kernel, lambda: fused_ls_kernel(**args))
        _hold(got, reference_ls_step(**args))
        got = _launched(fused_ls_kernel_bf16, lambda: fused_ls_kernel_bf16(**args))
        with cs.tensor_core_products():
            plain = reference_ls_step(**args, bf16=True)
        _hold(got, reference_ls_step(**args, bf16=True), True, plain, lanes * alphas)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dims,rows", BWD, ids=[f"{n}-{r}" for n, _, r in BWD])
def test_wide_backward_matches_plain_and_counts_a_launch(dev, name, dims, rows):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert bwd_route(rows, dims, sms)[0] == "wide"
    layers = cs.random_layers(dims, 8, dev)
    rng = np.random.default_rng(rows)
    x, _ = cs.clear_of_kinks(rng, rows, layers, dev)
    g = torch.tensor(rng.standard_normal((rows, dims[-1])), dtype=torch.float32, device=dev)
    flat = lambda d, grads: [d] + [t for pair in grads for t in pair]  # noqa: E731
    got = flat(*_launched(fused_mlp_backward, lambda: fused_mlp_backward(x, layers, g)))
    _hold(got, flat(*reference_backward(x, layers, g)))
    again = flat(*fused_mlp_backward(x, layers, g))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
