"""The kernel wrappers launch on their operands' card whatever card is
current (``ops/fused_mlp.py``, ``ops/fused_ls.py``: each launch runs in
``torch.cuda.device(x.device)``; the libraries launch on the current
device and cache their per-device setup by it). Needs two cards: with
cuda:0 current, the forward and backward kernels fed cuda:1 tensors give
their plain versions' results on cuda:1 (1e-4 max(1, max|ref|), the
smoke script's bound for the forward; the backward's on rows drawn clear
of relu kinks, as there), and cuda:0 stays current."""

import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.ops.fused_mlp import (
    fused_mlp_backward,
    fused_mlp_forward,
    reference_backward,
    reference_forward,
)

WIDTHS = [23, 200, 200, 200, 17]


def layers_on(device, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.tensor(rng.standard_normal((a, b)) / np.sqrt(a), dtype=torch.float32,
                          device=device),
             torch.tensor(0.1 * rng.standard_normal(b), dtype=torch.float32, device=device))
            for a, b in zip(WIDTHS[:-1], WIDTHS[1:])]


@pytest.mark.gpu
def test_kernels_launch_on_the_operands_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    pin_fp32()
    other = torch.device("cuda:1")
    torch.cuda.set_device(0)
    layers = layers_on(other)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((512, WIDTHS[0])), dtype=torch.float32, device=other)
    g = torch.tensor(rng.standard_normal((512, WIDTHS[-1])), dtype=torch.float32, device=other)
    with torch.no_grad():
        got, ref = fused_mlp_forward(x, layers), reference_forward(x, layers)
        torch.cuda.synchronize(other)
        assert got.device == other and torch.cuda.current_device() == 0
        assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
        # rows whose hidden pre-activations all sit 1e-3 or more from zero
        pre, h = [], x
        for i, (w, b) in enumerate(layers[:-1]):
            h = h @ w + b
            pre.append(h.abs().min(dim=1).values)
            h = torch.relu(h)
        keep = torch.stack(pre).min(dim=0).values > 1e-3
        xs, gs = x[keep].contiguous(), g[keep].contiguous()
        assert xs.shape[0] > 16
        (dx, grads), (rdx, rgrads) = fused_mlp_backward(xs, layers, gs), \
            reference_backward(xs, layers, gs)
        torch.cuda.synchronize(other)
    assert dx.device == other and torch.cuda.current_device() == 0
    for a, b in [(dx, rdx)] + [(t, r) for pair, rpair in zip(grads, rgrads)
                               for t, r in zip(pair, rpair)]:
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())
