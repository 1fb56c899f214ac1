"""The kernels on stacks of any depth and width, on the card.

Every stack of ``chip_smoke.py``'s phase 19 (a) through each kernel
instance against its plain version, with one launch counted per call
(none at 0 rows, which launch nothing; the backward's walk and dW kernel
one a chunk of ``BWD_CHUNK_ROWS`` rows):
the forward at f32 and bf16 and the line-search step at f32 and bf16
(n = 17, m = 6, the same hidden widths), the backward on rows clear of
relu kinks, a second call bitwise equal. Bounds as phase 19 (a): the f32
instances 1e-4 max(1, max|ref|); the bf16 instances max|d| <= 1e-2 max(1,
max|ref|), and from 512 rows on a share of entries beyond 1e-4 within
max(2%, twice that of the same function on the tensor cores by cuBLAS).
The wide backward's memory: one call's growth of the allocator's peak
within its gradient set, dx and one chunk's workspace (23->1024^3->17 at
128 rows within 68.5 MB besides its workspace, 23->4096^3->17 at 8192
rows), 23->8192^4->17 at 8192 rows against the plain version (and its
forward and step), and two calls over two chunks bitwise equal. The
forward's and the step's cluster launches at the picker's edges (ragged
tiles and blocks, a block without columns, the non-portable size, one
block, activations streamed through a workspace, a table past the launch's
parameters) against the mirror's plan, and a wide forward and step
captured in a CUDA graph, replayed bitwise equal to eager calls.

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
    BWD_CHUNK_ROWS,
    bwd_route,
    bwd_wide_bytes,
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


def _launched(kernel, fn, times=1):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + times
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
        got = _launched(fused_mlp_forward, lambda: fused_mlp_forward(x, layers), rows > 0)
        _hold((got,), (reference_forward(x, layers),))
        got = _launched(fused_mlp_forward_bf16, lambda: fused_mlp_forward_bf16(x, layers),
                        rows > 0)
        with cs.tensor_core_products():
            plain = reference_forward(x, layers, True)
        _hold((got,), (reference_forward(x, layers, True),), True, (plain,), rows)


# the cluster picker's edges: a ragged last tile (37 rows, 8190 rows on
# 64-row tiles), a cluster whose last block owns fewer columns (520 on 4
# blocks) or none (a 17-wide last layer on 4 and 8 blocks), the non-portable
# size (16384 columns), a cluster of one (32 layers of 64), weights one
# float off 16-byte alignment (no TMA: a bulk copy a row at its phase); and
# the routes that take a workspace: hidden layers too wide for a cluster of
# 16 (their activations stream through device memory: 24576 columns, and
# 30000 beside 1000 at one row) and a stack deeper than the table the
# launch's parameters hold (70 layers)
CLUSTER_CASES = [
    ("1024-1024 37 rows", [23, 1024, 1024, 17], 37, 0),
    ("520 ragged blocks", [23, 520, 17], 512, 0),
    ("1024^3 8190 rows", [23, 1024, 1024, 1024, 17], 8190, 0),
    ("16384", [23, 16384, 17], 300, 0),
    ("64^30 one block", [23] + [64] * 30 + [17], 100, 0),
    ("1024-1024 unaligned", [23, 1024, 1024, 17], 512, 1),
    ("24576 streamed", [23, 24576, 17], 512, 0),
    ("1000-30000 streamed 1 row", [23, 1000, 30000, 17], 1, 0),
    ("70 layers", [23] + [32] * 69 + [17], 37, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dims,rows,offset", CLUSTER_CASES,
                         ids=[c[0] for c in CLUSTER_CASES])
def test_wide_launch_takes_the_planned_cluster(dev, name, dims, rows, offset):
    """The forward and the step launch the cluster the mirror plans
    (``fwd_route``: its tile height and size, on an H100 that places every
    size, and whether the activations stream), one launch a call, and match
    their plain versions (1e-4 max(1, max|ref|))."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layers = cs.offset_layers(cs.random_layers(dims, 13, dev), offset)
    x = torch.tensor(np.random.default_rng(13).standard_normal((rows, dims[0])),
                     dtype=torch.float32, device=dev)
    with torch.no_grad():
        got = _launched(fused_mlp_forward, lambda: fused_mlp_forward(x, layers))
        _hold((got,), (reference_forward(x, layers),))
        _, tile_rows, plan, cluster = fwd_route(rows, dims, sms)
        launch = fused_mlp_forward.wide_launch()
        assert (launch["tile_rows"], launch["cluster"]) == (tile_rows, cluster)
        assert launch["streamed"] == plan["streamed"]
        # the mirror plans aligned weights: unaligned ones go row by row, in wider stage rows
        assert launch["smem"] == plan["smem"] or offset
        assert launch["clusters"] == min(-(-rows // tile_rows), launch["clusters"]) >= 1
        if dims[-1] == 17:  # a dynamics stack for n = 17, m = 6
            args = cs.ls_args(rows, 1, 17, 6, 17, cs.LS_WEIGHTS[3], 13, dev, offset,
                              hidden=dims[1:-1])
            _hold(_launched(fused_ls_kernel, lambda: fused_ls_kernel(**args)),
                  reference_ls_step(**args))
            _, tile_rows, plan, cluster = fwd_route(rows, dims, sms, dims[0])
            launch = fused_ls_kernel.wide_launch()
            assert (launch["tile_rows"], launch["cluster"]) == (tile_rows, cluster)
            assert launch["streamed"] == plan["streamed"]


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [[23, 1024, 1024, 1024, 17], [23, 24576, 17]],
                         ids=["1024^3", "24576 streamed"])
def test_captured_wide_forward_and_step_replay_bitwise(dev, dims):
    """The wide forward and step launch nothing but the kernel (their
    table travels in the launch's parameters; a streamed plan's workspace
    comes from the graph's pool): each is captured in a CUDA graph, and the
    replays give the eager outputs bitwise (512 rows and 512 x 16)."""
    layers = cs.random_layers(dims, 14, dev)
    x = torch.tensor(np.random.default_rng(14).standard_normal((512, dims[0])),
                     dtype=torch.float32, device=dev)
    args = cs.ls_args(512, 16, 17, 6, 17, cs.LS_WEIGHTS[3], 14, dev, hidden=dims[1:-1])
    with torch.no_grad():
        eager_y = fused_mlp_forward(x, layers)
        eager_step = fused_ls_kernel(**args)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = fused_mlp_forward(x, layers)
            step = fused_ls_kernel(**args)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, eager_y)
            assert all(torch.equal(a, b) for a, b in zip(step, eager_step))


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
    chunks = -(-rows // BWD_CHUNK_ROWS)
    got = flat(*_launched(fused_mlp_backward.dw, lambda: _launched(
        fused_mlp_backward, lambda: fused_mlp_backward(x, layers, g), chunks), chunks))
    _hold(got, flat(*reference_backward(x, layers, g)))
    again = flat(*fused_mlp_backward(x, layers, g))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _grown(fn):
    """``fn()`` and the growth of the allocator's peak over what was
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


@pytest.mark.gpu
@pytest.mark.parametrize("dims,rows", [([23, 1024, 1024, 1024, 17], 128),
                                       ([23, 4096, 4096, 4096, 17], 8192)])
def test_wide_backward_keeps_one_gradient_set(dev, dims, rows):
    """The growth over one call: the gradient set, dx and the wide path's
    workspace (one chunk's planes), with 2 MiB for the allocator's
    rounding; not the SM count x the parameters (1.13 GB and 17.8 GB
    before). 23->1024^3->17 at 128 rows: within 68.5 MB besides its
    workspace."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route = bwd_route(rows, dims, sms)
    assert route[0] == "wide"
    layers = cs.random_layers(dims, 9, dev)
    rng = np.random.default_rng(rows)
    x = torch.tensor(rng.standard_normal((rows, dims[0])), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((rows, dims[-1])), dtype=torch.float32, device=dev)
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    _, grown = _grown(lambda: fused_mlp_backward(x, layers, g))
    assert grown <= 4 * (params + x.numel()) + bwd_wide_bytes(rows, dims, route[1]) + 2**21
    if rows == 128:
        assert grown - route[3] <= 68.5e6


@pytest.mark.gpu
def test_widest_backward_matches_plain(dev):
    """23->8192^4->17 at 8192 rows, past what 132 partial sets would hold
    (106.5 GB): within 1e-4 max(1, max|ref|) of the plain version on rows
    clear of relu kinks (32,768 hidden units a row: most rows are
    redrawn); two chunks, each one walk and one dW launch."""
    dims = [23] + [8192] * 4 + [17]
    layers = cs.random_layers(dims, 10, dev)
    rng = np.random.default_rng(8192)
    x, _ = cs.clear_of_kinks(rng, 8192, layers, dev)
    g = torch.tensor(rng.standard_normal((8192, dims[-1])), dtype=torch.float32, device=dev)
    flat = lambda d, grads: [d] + [t for pair in grads for t in pair]  # noqa: E731
    got = flat(*_launched(fused_mlp_backward.dw, lambda: _launched(
        fused_mlp_backward, lambda: fused_mlp_backward(x, layers, g), 2), 2))
    _hold(got, flat(*reference_backward(x, layers, g)))


@pytest.mark.gpu
def test_widest_forward_and_step_match_plain(dev):
    """23->8192^4->17: the f32 forward at 8192 rows and the step at 512 x
    16 within 1e-4 max(1, max|ref|) of the plain versions (the wide path
    sums each contraction in segments of 512 rows of K; one accumulator
    over 8192 rows lay 1.77-1.79 times that bound off the forward's plain
    version)."""
    dims = [23] + [8192] * 4 + [17]
    layers = cs.random_layers(dims, 12, dev)
    x = torch.tensor(np.random.default_rng(12).standard_normal((8192, dims[0])),
                     dtype=torch.float32, device=dev)
    with torch.no_grad():
        got = _launched(fused_mlp_forward, lambda: fused_mlp_forward(x, layers))
        _hold((got,), (reference_forward(x, layers),))
        args = cs.ls_args(512, 16, 17, 6, 17, cs.LS_WEIGHTS[3], 12, dev, hidden=dims[1:-1])
        _hold(_launched(fused_ls_kernel, lambda: fused_ls_kernel(**args)),
              reference_ls_step(**args))


@pytest.mark.gpu
def test_wide_backward_bits_repeat_over_chunks(dev):
    """23->1024^3->17 at 8192 rows runs two chunks (the second adds to the
    first's sums): two calls give the same bits."""
    dims = [23, 1024, 1024, 1024, 17]
    layers = cs.random_layers(dims, 11, dev)
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((8192, dims[0])), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((8192, dims[-1])), dtype=torch.float32, device=dev)
    first = _launched(fused_mlp_backward.dw, lambda: _launched(
        fused_mlp_backward, lambda: fused_mlp_backward(x, layers, g), 2), 2)
    again = fused_mlp_backward(x, layers, g)
    flat = lambda d, grads: [d] + [t for pair in grads for t in pair]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(*first), flat(*again)))
