"""The backward's memory against the reference's one gradient set, and what
the launch counters count, as far as a CPU can hold them.

The JAX backward kernel keeps one gradient set: its grid runs in order,
the first tile writes and later tiles add. On the card the backward sums
dW and db over its row tiles in a fixed order without atomics:

  1. on the shared-memory path (every committed stack) in slices, at most
     one an SM, each into a partial gradient set, then the slices in
     order. The wrapper allocates the launch's slices and no more
     (``bwd_partial_sets``): the Python rule against ``grid`` of
     ``csrc/fused_mlp_bwd.cu`` at the row counts the paths use;
  2. on the wide path in chunks of ``BWD_CHUNK_ROWS`` rows: a walk writes
     every layer's input and output cotangent of a chunk into the
     workspace, and the dW kernel takes dW and db of the chunk as products
     over its rows, the first chunk writing the gradient set and later ones
     adding to it. Here: the workspace is one chunk's planes whatever the
     SM count, the planes of a tile do not overlap, the dW kernel's
     fragment walk emulated in numpy (its loads, the m16n8k8 fragments,
     the epilogue and the column sums) gives a^T g, and the kernel's
     arithmetic model (``reference_backward_3xtf32`` with the wide path's
     chunks) through ``FusedMlpFunction`` matches ``jax.vjp`` of the JAX
     ``fused_mlp`` within 1e-4 max(1, max|ref|) on wide and deep stacks and
     on a call whose rows span two chunks;
  3. a call over 0 rows launches nothing and counts nothing, in every
     wrapper, with the kernel library mocked; the backward's counters add
     the launches its entry point reports (the walk's, one on the
     shared-memory path and one a chunk on the wide path, and the dW
     kernel's, one a chunk), which it counts where it launches.
"""

import contextlib
import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.ops import fused_ls as fl
from gan_mpc_tpu_torch.ops import fused_mlp as fm
from gan_mpc_tpu_torch.ops.fused_mlp import (
    BWD_CHUNK_ROWS,
    FusedMlpFunction,
    bwd_dw_blocks,
    bwd_model_args,
    bwd_partial_sets,
    bwd_route,
    bwd_slices,
    bwd_wide_plan,
    reference_backward_3xtf32,
    reference_forward,
    tf32_round,
)

jfm = importlib.import_module("gan_mpc_tpu.ops.fused_mlp")

torch.set_num_threads(1)
pin_fp32()

CU = Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_mlp_bwd.cu"
SMS = 132  # an H100's SMs
STACKS = {
    "dynamics": [23, 200, 200, 200, 17],
    "cost": [17, 128, 128, 10],
    "humanoid": [41, 200, 200, 200, 29],
    "256": [23, 256, 256, 256, 17],
    "512^3": [23, 512, 512, 512, 17],
    "1024^3": [23, 1024, 1024, 1024, 17],
    "64^30": [23] + [64] * 30 + [17],
}
# the trainers (128 and 16 rows), the cost trainer and serving (2048, 8192),
# the mesh ranks (64), phase 19 (a) (128, 512, 8192)
ROWS = (1, 16, 64, 128, 512, 2048, 4224, 4225, 8192)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", sorted(STACKS))
def test_partial_sets_are_the_launch_slices(name, rows):
    """The shared-memory path allocates the launch's slices where it has
    more than one (one slice writes the output), the wide path none; a
    slice sums tiles slice, slice + slices, ...: together they cover every
    tile once, one at one tile, never more than the SM count."""
    dims = STACKS[name]
    path, tile_rows, _, _ = bwd_route(rows, dims, SMS)
    tiles = -(-rows // tile_rows)
    slices = bwd_slices(rows, tile_rows, SMS)
    assert 1 <= slices <= SMS and (slices == 1) == (tiles == 1)
    assert sorted(t for s in range(slices) for t in range(s, tiles, slices)) == list(range(tiles))
    sets = bwd_partial_sets(rows, tuple(dims), SMS)
    assert sets == (slices if path == "tile" and slices > 1 else 0)
    if path == "tile" and rows == 128:
        assert sets == 8  # the trainers' call: 8 of 132 sets, not 132


def test_the_rules_match_the_cuda_source():
    """``bwd_slices`` is ``grid``; the wide path's chunk, dW blocks and
    workspace head are what ``launch_wide`` computes."""
    src = CU.read_text()
    grid = re.search(r"void grid\(int rows, int sms, int\* tiles, int\* slices, int\* shares\) "
                     r"\{(.*?)\n\}", src, re.S).group(1)
    assert "*tiles = (rows + 16 * MT - 1) / (16 * MT);" in grid
    assert "const int per_block = (*tiles + sms - 1) / sms;" in grid
    assert "*slices = (*tiles + per_block - 1) / per_block;" in grid
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kChunkRows") == BWD_CHUNK_ROWS
    assert (const("kDwRows"), const("kDwCols")) == (fm.DW_ROWS, fm.DW_COLS)
    wide = re.search(r"int launch_wide\(.*?\n\}", src, re.S).group(0)
    assert "const int chunk_tiles = min(tiles, kChunkRows / TM);" in wide
    assert ("blocks += (dims[l + 1] + kDwCols - 1) / kDwCols * ((dims[l] + kDwRows - 1) / "
            "kDwRows + 1);") in wide
    assert ("const size_t head = (descs + first_block.size() * sizeof(int) + 255) & "
            "~(size_t)255;") in wide
    plan = re.search(r"inline void plan_bwd_wide\(.*?\n\}", src, re.S).group(0)
    assert "p->gshift = t[L].at - t[1].at;" in plan
    assert "p->tile_floats = (size_t)floats + p->gshift;" in plan
    # the wide path allocates no partial sets: the entry point sums no slices after it
    assert "slices = 1;  // one gradient set" in src


@pytest.mark.parametrize("dims,rows", [(STACKS["1024^3"], 128), ([23, 4096, 4096, 4096, 17], 8192),
                                       ([23] + [8192] * 4 + [17], 8192),
                                       (STACKS["64^30"], 8192)])
def test_wide_workspace_is_one_chunk_whatever_the_sms(dims, rows):
    """The wide path's extra memory is the layer table and one chunk's
    planes (its inputs and cotangents, hi and lo, the widths padded to 16
    plus 4): it does not grow with the SM count, nor with the rows past a
    chunk. Against the partial sets it replaces (the SM count x the
    parameters): 23->1024^3->17 at 128 rows within 68.5 MB with its
    gradients, 23->4096^3->17 and 23->8192^4->17 at 8192 rows about a
    gradient set and a chunk."""
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    padded = sum(-(-d // 16) * 16 + 4 for d in dims)
    for sms in (SMS, 2 * SMS, 1000):
        path, tile_rows, plan, scratch = bwd_route(rows, dims, sms)
        assert path == "wide"
        chunk = min(rows, BWD_CHUNK_ROWS)
        planes = 4 * 2 * 2 * (-(-chunk // tile_rows) * tile_rows) * padded
        assert scratch <= planes + 4096
        assert scratch == bwd_route(rows + BWD_CHUNK_ROWS, dims, sms)[3] or rows < BWD_CHUNK_ROWS
        assert bwd_partial_sets(rows, tuple(dims), sms) == 0
    total = 4 * params + 4 * rows * dims[0] + bwd_route(rows, dims, SMS)[3]
    if dims == STACKS["1024^3"]:
        assert total <= 68.5e6 < 4 * params * SMS  # was 1.13 GB
    else:  # one gradient set and one chunk's planes
        assert total <= 4 * params + 1.1 * 4 * 4 * BWD_CHUNK_ROWS * sum(dims)
    if params > 1e7:  # 17.8 GB and 106.5 GB of partial sets before
        assert total < 4 * params * SMS / 10


@pytest.mark.parametrize("name", ["512^3", "1024^3", "64^30"])
@pytest.mark.parametrize("tile_rows", [16, 32])
def test_chunk_planes_do_not_overlap(name, tile_rows):
    """A tile's planes in the chunk buffer: the inputs a_0 .. a_{L-1} at
    ``at``, the cotangents g_1 .. g_L at ``at + gshift``, each hi then lo
    of tile_rows x sa floats; disjoint, 16-byte aligned, within
    ``tile_floats``, and the rows of consecutive dW blocks start where the
    last layer's end."""
    dims = STACKS[name]
    L = len(dims) - 1
    plan = bwd_wide_plan(dims, tile_rows)
    spans = [(plan["at"][l], 2 * tile_rows * plan["sa"][l]) for l in range(L)]
    spans += [(plan["at"][l] + plan["gshift"], 2 * tile_rows * plan["sa"][l])
              for l in range(1, L + 1)]
    spans.sort()
    assert spans[0][0] == 0 and sum(n for _, n in spans) == plan["tile_floats"]
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n == b and a % 4 == 0
    assert plan["tile_floats"] % 4 == 0
    assert plan["smem"] <= fm.MAX_SMEM and fm.MIN_STAGES <= plan["stages"] <= fm.MAX_STAGES
    starts = bwd_dw_blocks(dims)
    assert starts[0] == 0 and len(starts) == L + 1
    for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        assert starts[l + 1] - starts[l] == -(-n // fm.DW_COLS) * (-(-k // fm.DW_ROWS) + 1)


def _act_index(r, c, sa):
    """``act_index`` of ``csrc/mlp_tile_mma.cuh``: rows r and r + 8 of a
    16-row block interleaved element by element."""
    return ((r >> 4) * 8 + (r & 7)) * 2 * sa + 2 * c + ((r >> 3) & 1)


def _chunk_buffer(acts, cots, plan, tile_rows):
    """The chunk buffer the walk leaves: per tile, each a_l and g_{l+1}
    split into TF32 hi and lo planes in act_index's layout (float64 here)."""
    rows = acts[0].shape[0]
    tiles = -(-rows // tile_rows)
    buf = np.zeros(tiles * plan["tile_floats"])
    r = np.arange(tile_rows)[:, None]
    for tile in range(tiles):
        base = tile * plan["tile_floats"]
        for l, (a, g) in enumerate(zip(acts, cots)):
            for t, at, sa in ((a, plan["at"][l], plan["sa"][l]),
                              (g, plan["at"][l + 1] + plan["gshift"], plan["sa"][l + 1])):
                block = np.zeros((tile_rows, t.shape[1]), np.float32)
                part = t[tile * tile_rows:(tile + 1) * tile_rows]
                block[:len(part)] = part
                hi = tf32_round(torch.from_numpy(block)).numpy()
                lo = tf32_round(torch.from_numpy(block - hi)).numpy()
                idx = base + at + _act_index(r, np.arange(t.shape[1])[None], sa)
                buf[idx] = hi
                buf[idx + tile_rows * sa] = lo
    return buf


def _dw_kernel(buf, dims, plan, tile_rows, n_tiles, grads, first):
    """``fused_mlp_bwd_dw_kernel`` in numpy: every block and warp of the
    launch, each lane's fragment loads at the kernel's offsets, the
    m16n8k8 products on the fragments (a0 = A[g][t], a1 = A[g+8][t],
    a2 = A[g][t+4], a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0, c1
    = D[g][2t, 2t+1], c2, c3 = D[g+8][...]), the epilogue's entries, and
    the column sums of db. Entries written are counted in ``grads``'s
    second part."""
    mt = tile_rows // 16
    g, t = np.arange(8)[:, None], np.arange(4)[None]
    starts = bwd_dw_blocks(dims)
    offsets = plan["offset"]
    for block in range(starts[-1]):
        l = max(i for i in range(len(dims) - 1) if starts[i] <= block)
        K, N = dims[l], dims[l + 1]
        sa, sg = plan["sa"][l], plan["sa"][l + 1]
        nb, mb = -(-N // fm.DW_COLS), -(-K // fm.DW_ROWS)
        job = block - starts[l]
        g_base = plan["at"][l + 1] + plan["gshift"]
        dw = offsets[l]
        if job >= mb * nb:  # db: column sums, even tiles then odd tiles
            for c in range((job - mb * nb) * fm.DW_COLS,
                           min(N, (job - mb * nb + 1) * fm.DW_COLS)):
                halves = []
                for half in (0, 1):
                    s = 0.0
                    for tile in range(half, n_tiles, 2):
                        for r in range(tile_rows):
                            at = tile * plan["tile_floats"] + g_base + _act_index(r, c, sg)
                            s += buf[at] + buf[at + tile_rows * sg]
                    halves.append(s)
                v = halves[0] + halves[1]
                at = dw + K * N + c
                grads[0][at] = v if first else grads[0][at] + v
                grads[1][at] += 1
            continue
        for warp in range(8):
            m0 = job // nb * fm.DW_ROWS + warp // 4 * 32
            n0 = (job % nb * fm.DW_COLS + warp % 4 * 32) // 8
            n_tiles8 = -(-N // 8)
            if m0 >= K or n0 >= n_tiles8:
                continue
            acc = np.zeros((2, 4, 16, 8))
            a_at = plan["at"][l] + t * 2 * sa + 2 * (m0 + g)
            g_at = g_base + t * 2 * sg + 2 * (n0 * 8 + g)
            for tile in range(n_tiles):
                off = tile * plan["tile_floats"]
                for s in range(2 * mt):
                    frag_a, frag_b = [], []
                    for i in range(2):
                        o = off + a_at + s * 8 * sa + 32 * i
                        live = i == 0 or m0 + 16 < K
                        planes = [buf[o + p * tile_rows * sa + d] if live else 0 * o
                                  for p in (0, 1) for d in (0, 1, 16, 17)]
                        # h0.x h0.y h1.x h1.y -> A[g][t] A[g][t+4] A[g+8][t] A[g+8][t+4]
                        frag_a.append([np.block([[h0x, h0y], [h1x, h1y]])
                                       for h0x, h0y, h1x, h1y in (planes[:4], planes[4:])])
                    for j in range(4):
                        o = off + g_at + s * 8 * sg + 16 * j
                        live = n0 + j < n_tiles8
                        hx, hy, lx, ly = (buf[o + p * tile_rows * sg + d] if live else 0 * o
                                          for p in (0, 1) for d in (0, 1))
                        # B[k][n]: k = t (x) and t + 4 (y), n = g
                        frag_b.append([np.concatenate([hx.T, hy.T]),
                                       np.concatenate([lx.T, ly.T])])
                    for j in range(4):
                        for i in range(2):
                            (ah, al), (bh, bl) = frag_a[i], frag_b[j]
                            acc[i, j] += al @ bh
                            acc[i, j] += ah @ bl
                            acc[i, j] += ah @ bh
            for i in range(2):
                for j in range(4):
                    rr = m0 + 16 * i + np.arange(16)[:, None]
                    cc = 8 * (n0 + j) + np.arange(8)[None]
                    keep = (rr < K) & (cc < N)
                    at = dw + (rr * N + cc)[keep]
                    grads[0][at] = acc[i, j][keep] if first else grads[0][at] + acc[i, j][keep]
                    grads[1][at] += 1


@pytest.mark.parametrize("dims,rows,tile_rows", [([23, 40, 70, 17], 37, 16),
                                                 ([9, 130, 17], 70, 32)])
def test_dw_kernel_fragment_walk_gives_a_t_g(dims, rows, tile_rows):
    """The dW kernel's loads, fragments, products and stores, emulated on
    a chunk buffer laid out by the plan, over two chunks of the rows (the
    first writes, the second adds): dW = a^T g and db = sum g within
    float64's view of the three TF32 products (each drops lo x lo, 2^-22
    of it), every entry of the gradient set written once a chunk."""
    rng = np.random.default_rng(3)
    acts = [rng.standard_normal((rows, d)).astype(np.float32) for d in dims[:-1]]
    cots = [rng.standard_normal((rows, d)).astype(np.float32) for d in dims[1:]]
    plan = bwd_wide_plan(dims, tile_rows)
    total = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    grads = [np.full(total, np.nan), np.zeros(total, int)]
    cut = -(-rows // tile_rows) // 2 * tile_rows  # two chunks: whole tiles, then the rest
    for first, part in ((True, slice(0, cut)), (False, slice(cut, rows))):
        a, g = [t[part] for t in acts], [t[part] for t in cots]
        buf = _chunk_buffer(a, g, plan, tile_rows)
        _dw_kernel(buf, dims, plan, tile_rows, -(-len(a[0]) // tile_rows), grads, first)
    assert (grads[1] == 2).all()
    for l, (a, g) in enumerate(zip(acts, cots)):
        k, n = a.shape[1], g.shape[1]
        ref_w = a.astype(np.float64).T @ g.astype(np.float64)
        got = grads[0][plan["offset"][l]:plan["offset"][l] + k * n + n]
        scale = np.abs(a).max() * np.abs(g).max() * rows
        np.testing.assert_allclose(got[:k * n].reshape(k, n), ref_w, rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got[k * n:], g.astype(np.float64).sum(0), rtol=0,
                                   atol=1e-6 * scale)


def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.standard_normal(b)).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


def _clear_of_kinks(rng, rows, layers, margin=1e-4):
    fin = layers[0][0].shape[0]
    x = rng.standard_normal((rows, fin)).astype(np.float32)
    while True:
        h, near = x.astype(np.float64), np.zeros(rows, bool)
        for w, b in layers[:-1]:
            z = h @ w + b
            near |= (np.abs(z) < margin).any(1)
            h = np.maximum(z, 0)
        if not near.any():
            return x
        x[near] = rng.standard_normal((int(near.sum()), fin)).astype(np.float32)


MODEL_CASES = {"1024": ([23, 1024, 1024, 17], 64), "12 layers": ([23] + [96] * 11 + [17], 64),
               "two chunks": ([23] + [64] * 10 + [17], BWD_CHUNK_ROWS + 37)}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_wide_model_through_fused_vjp_matches_jax(name, monkeypatch):
    """``FusedMlpFunction`` with its kernels replaced, each counted, by the
    plain forward and by the backward kernel's arithmetic model as the
    call takes it (``bwd_model_args``: the wide path's tile height and
    chunks): dx and every dW, db against ``jax.vjp`` of the JAX
    ``fused_mlp`` within 1e-4 max(1, max|ref|), the bound ``chip_smoke.py``
    holds the kernel to; rows clear of relu kinks. The last case's rows
    span two chunks, so its dW is the first chunk's product plus the
    second's."""
    widths, rows = MODEL_CASES[name]
    layers = _layers(widths, 41)
    rng = np.random.default_rng(42)
    x = _clear_of_kinks(rng, rows, layers)
    g = rng.standard_normal((rows, widths[-1])).astype(np.float32)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    _, vjp = jax.vjp(jfm.fused_mlp, jnp.asarray(x), jl)
    dx_ref, grads_ref = vjp(jnp.asarray(g))
    model = bwd_model_args(rows, widths, SMS)
    assert model["chunk_rows"] == BWD_CHUNK_ROWS
    assert (rows > BWD_CHUNK_ROWS) == (name == "two chunks")
    calls = {"forward": 0, "backward": 0}

    def forward(x, layers):
        calls["forward"] += 1
        return reference_forward(x, layers)

    def backward(x, layers, g):
        calls["backward"] += 1
        return reference_backward_3xtf32(x, layers, g, **model)

    monkeypatch.setattr(fm, "fused_mlp_forward", forward)
    monkeypatch.setattr(fm, "fused_mlp_backward", backward)
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    xt = torch.from_numpy(x).requires_grad_(True)
    flat = [t.clone().requires_grad_(True) for wb in tl for t in wb]
    FusedMlpFunction.apply(xt, *flat).backward(torch.from_numpy(g))
    assert calls == {"forward": 1, "backward": 1}
    refs = [dx_ref] + [t for pair in grads_ref for t in pair]
    for got, ref in zip([xt.grad] + [p.grad for p in flat], refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))


class _Library:
    """A kernel library that launches nothing: every entry point returns
    0 and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls += 1
            return 0
        return entry


class _BwdLibrary(_Library):
    """The backward's library: each call reports ``launched`` (the walk's
    launches, the dW kernel's) through the entry point's out-parameter,
    none at 0 rows."""

    def __init__(self):
        super().__init__()
        self.launched = (1, 0)

    def __getattr__(self, name):
        def entry(*args):
            self.calls += 1
            out = args[11]
            out[0], out[1] = self.launched if args[6] else (0, 0)
            return 0
        return entry


@pytest.fixture
def mocked(monkeypatch):
    """The wrappers on CPU tensors with their libraries mocked: the CUDA
    checks and the device, stream and SM-count queries stubbed."""
    monkeypatch.setattr(fm, "_check_kernel_args", lambda *args: None)
    monkeypatch.setattr(fl, "_check_kernel_args", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=SMS))
    libs = {}
    for kernel in (fm.fused_mlp_forward, fm.fused_mlp_forward_bf16, fm.fused_mlp_backward,
                   fl.fused_ls_kernel, fl.fused_ls_kernel_bf16):
        libs[kernel.name] = _BwdLibrary() if kernel is fm.fused_mlp_backward else _Library()
        monkeypatch.setattr(kernel, "_lib", libs[kernel.name])
    return libs


def _torch_layers(widths):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in _layers(widths, 5)]


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_counts_launches_not_calls(mocked, bf16):
    kernel = fm.fused_mlp_forward_bf16 if bf16 else fm.fused_mlp_forward
    layers = _torch_layers(STACKS["dynamics"])
    before = kernel.launches
    assert kernel(torch.zeros((0, 23)), layers).shape == (0, 17)
    assert kernel.launches == before and mocked[kernel.name].calls == 1
    kernel(torch.zeros((5, 23)), layers)
    assert kernel.launches == before + 1


@pytest.mark.parametrize("name,launched", [("dynamics", (1, 0)), ("64^30", (2, 2))])
def test_backward_counts_launches_not_calls(mocked, name, launched):
    """0 rows: the entry point only zeroes the gradients and reports no
    launch, no count; else the counters add what the entry point reports
    (the shared-memory path's one walk; the wide path's walk and dW kernel
    once a chunk, here two)."""
    kernel = fm.fused_mlp_backward
    widths = STACKS[name]
    layers = _torch_layers(widths)
    mocked["fused_mlp_bwd"].launched = launched
    before, dw = kernel.launches, kernel.dw.launches
    kernel(torch.zeros((0, 23)), layers, torch.zeros((0, 17)))
    assert (kernel.launches, kernel.dw.launches) == (before, dw)
    kernel(torch.zeros((5, 23)), layers, torch.zeros((5, 17)))
    assert (kernel.launches, kernel.dw.launches) == (before + launched[0], dw + launched[1])
    assert mocked["fused_mlp_bwd"].calls == 2


def test_backward_entry_counts_where_it_launches():
    """``fused_mlp_bwd`` zeroes its two counts before any return (so a
    0-row call, which only zeroes the gradients, and a call refused for
    want of a workspace report none), counts the shared-memory walk once
    after a launch without error, and on the wide path counts the walk and
    the dW kernel in the chunk loop, after both launches and their error
    check."""
    src = CU.read_text()
    entry = re.search(r"int fused_mlp_bwd\(.*?\n\}", src, re.S).group(0)
    body = entry[entry.index("{"):]
    assert body.index("launched[0] = launched[1] = 0;") < body.index("return")
    assert body.index("launched[0] = launched[1] = 0;") < body.index("if (rows == 0)")
    assert "if (inline_path && err == 0) launched[0] = 1;" in body
    assert body.count("launched") == 5  # the zeroing (2), the walk's count, two launch_wide calls
    wide = re.search(r"int launch_wide\(.*?\n\}", src, re.S).group(0)
    loop = wide[wide.index("for (int tile0 = 0;"):]
    counts = loop.index("++launched[0];\n    ++launched[1];")
    assert loop.index("fused_mlp_bwd_wide_kernel<MT><<<") < loop.index(
        "fused_mlp_bwd_dw_kernel<MT><<<") < loop.index("e = cudaGetLastError();") < counts
    assert wide.index("return -2;") < wide.index("for (int tile0 = 0;")


@pytest.mark.parametrize("bf16", [False, True])
def test_step_counts_launches_not_calls(mocked, bf16):
    kernel = fl.fused_ls_kernel_bf16 if bf16 else fl.fused_ls_kernel
    n, m, gs, hidden = 17, 6, 17, 64
    (w0, b0), *rest = _torch_layers([n + m, hidden, hidden, n])
    layers = [((w0[:n], w0[n:]), b0)] + rest

    def args(lanes):
        z = lambda *shape: torch.zeros(shape)  # noqa: E731
        return (z(lanes, 16, n), z(lanes, n), z(lanes, m), z(lanes, 16), z(lanes, m),
                z(lanes, m, n), z(lanes, gs), z(lanes, m), z(1, 4), layers)

    kw = dict(gs=gs, action_goal_squared=False, ag_scale=1.0)
    before = kernel.launches
    kernel(*args(0), **kw)
    assert kernel.launches == before
    kernel(*args(3), **kw)
    assert kernel.launches == before + 1 and mocked[kernel.name].calls == 2
