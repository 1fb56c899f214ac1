"""Fused relu-MLP forward and backward, and the planner's value-and-Jacobian.

Counterpart of ``gan_mpc_tpu/ops/fused_mlp.py``. Layer lists are ordered
``(W, b)`` pairs with ``W`` stored (in, out), the JAX package's kernel
layout, so the two packages' tests compare like with like.

``mlp_apply`` dispatches by device: a CPU tensor runs
``reference_forward`` (plain torch, the tests' path; autograd
differentiates it); a CUDA tensor always launches the hand-written
kernels or raises. Without gradients that is ``csrc/fused_mlp_fwd.cu``;
with gradients ``FusedMlpFunction``, whose forward launches the same
kernel and whose backward launches ``csrc/fused_mlp_bwd.cu`` (the JAX
package's ``fused_mlp`` custom VJP). There is no fallback from a kernel to
the plain version.

``compute_dtype="bfloat16"`` is the JAX package's ``_mm``: both operands
of every product rounded to bfloat16 (to nearest, ties to even), the
product and its accumulator f32, the output f32. The plain version holds
the rounded values in f32 and multiplies them in f32 (``bf16_mm``; a
product of two bfloat16 values is exact in f32). Without gradients a CUDA
tensor launches the forward kernel's bf16 instance
(``fused_mlp_forward_bf16``); with gradients it runs the plain bf16
function under autograd, as the JAX package differentiates its plain
``_reference_forward`` (there is no bf16 backward kernel in either).

The kernels multiply on the tensor cores with every f32 operand split
into two TF32 parts and three products per term. ``tf32_round``,
``reference_forward_3xtf32`` and ``reference_backward_3xtf32`` are that
arithmetic in plain torch, and ``tile_plan``, ``weight_chunks`` and
``column_runs`` mirror how ``csrc/mlp_tile_mma.cuh`` lays a stack out in
shared memory (padded widths, ring stages, chunk starts, the two spans of
a split W0, the columns of each warp), ``bwd_tile_plan`` how
``csrc/fused_mlp_bwd.cu`` does, so that the CPU tests can hold them to
what the kernels rely on. Nothing on a successful launch calls them.

The kernels take any stack: any depth, any widths, any row count. The
committed stacks (at most ``INLINE_LAYERS`` layers, each layer one pass of
the warps' columns, activations in shared memory) take the path the
mirrors above describe; any other stack takes the kernels' wide path
(``wide_plan``, ``bwd_wide_plan``, ``column_passes``): layers in passes of
512 or 256 columns, activations in a device workspace where they do not
fit in shared memory, the layers read from a table in device memory.
``fwd_route`` and ``bwd_route`` say which path and tile height a call
takes. The wrappers allocate the wide path's workspace with
``torch.empty`` when the kernel asks for it.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` (in, out), as flax's Dense."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))


def dense_stack(layers: Iterable[Dense]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The ordered ``(W, b)`` list of a stack of Dense layers."""
    return [(d.kernel, d.bias) for d in layers]


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even, as
    ``astype(jnp.bfloat16)``) and held in float32. Autograd rounds the
    cotangent to bfloat16 on its way back through the cast, as ``jax.grad``
    does."""
    return t.to(torch.bfloat16).to(torch.float32)


def bf16_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with both operands rounded to bfloat16 and the product
    accumulated in f32 (the JAX ``_mm(a, w, bfloat16)``). Not a matmul on
    bfloat16 tensors, which would round the output to bfloat16 too."""
    return bf16_round(a) @ bf16_round(w)


def compute_is_bf16(compute_dtype) -> bool:
    """Whether ``compute_dtype`` (None, a name or a torch dtype) selects
    the bfloat16 products; raises for a dtype that is neither."""
    if compute_dtype in (None, "float32", torch.float32):
        return False
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return True
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")


def reference_forward(x: torch.Tensor, layers: Layers, bf16: bool = False) -> torch.Tensor:
    """Plain torch relu-MLP forward: the kernel's reference; with
    ``bf16`` the products are ``bf16_mm``'s."""
    mm = bf16_mm if bf16 else torch.matmul
    h = x
    for i, (w, b) in enumerate(layers):
        h = mm(h, w) + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest with ties away from zero: add half an ulp to the bit pattern
    and clear the low 13 bits, as the kernel's ``round_tf32`` does (the
    result of ``cvt.rna.tf32.f32``)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def reference_forward_3xtf32(x: torch.Tensor, layers: Layers, passes: int = 3) -> torch.Tensor:
    """The forward kernel's arithmetic in plain torch: per layer, both
    operands split into ``hi = tf32(v)`` and ``lo = tf32(v - hi)`` and the
    product taken as ``a_lo w_hi + a_hi w_lo + a_hi w_hi`` in float32, the
    bias added last. ``passes=1`` keeps only ``a_hi w_hi``: a single TF32
    pass, what the kernel must not be."""
    h = x
    for i, (w, b) in enumerate(layers):
        h_hi, w_hi = tf32_round(h), tf32_round(w)
        if passes == 3:
            h_lo, w_lo = tf32_round(h - h_hi), tf32_round(w - w_hi)
            h = (h_lo @ w_hi + h_hi @ w_lo) + h_hi @ w_hi + b
        else:
            h = h_hi @ w_hi + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


# csrc/mlp_tile_mma.cuh's constants
CONSUMER_WARPS = 16
WARP_TILES = 4
MAX_STAGES, MIN_STAGES = 4, 3
MAX_SMEM = 232448
BARRIER_BYTES = 128
INLINE_LAYERS = 8  # csrc/mlp_tile.cuh's kInlineLayers: the depth a launch's parameters carry
LAYER_DESC_BYTES = 40  # sizeof(LayerDesc): two pointers and six ints
NEED_WORKSPACE = -2  # the kernels' return value: call again with the workspace they ask for


def _up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def tile_plan(dims: Sequence[int], tile_rows: int, extra_floats: int = 0):
    """``plan_tile`` of ``csrc/mlp_tile_mma.cuh``: how a block of
    ``tile_rows`` (64 or 16) rows lays the stack ``dims`` out in shared
    memory, or None where the kernel does not take it at that tile.

    ``sa``: the activation planes' row stride (the widest layer padded to
    a multiple of 8, plus 4); ``stage_floats`` and ``stages``: the weight
    ring; ``step[l]``: weight rows per chunk of layer l (a multiple of 8);
    ``smem``: bytes."""
    col_groups = CONSUMER_WARPS // {64: 2, 16: 1}[tile_rows]  # warps: row x column groups
    widest, widest_out = max(dims), max(dims[1:])
    if widest_out > col_groups * 8 * WARP_TILES:
        return None
    sa = _up(widest, 8) + 4
    fixed = BARRIER_BYTES + 4 * (2 * tile_rows * sa + _up(extra_floats, 4) + 8)
    for rows in (64, 32, 16, 8):
        stage_floats = rows * _up(widest_out, 4)
        if fixed + MIN_STAGES * 4 * stage_floats > MAX_SMEM:
            continue
        stages = min(MAX_STAGES, (MAX_SMEM - fixed) // (4 * stage_floats))
        return dict(sa=sa, stage_floats=stage_floats, stages=stages,
                    step=[stage_floats // n // 8 * 8 for n in dims[1:]],
                    smem=fixed + stages * 4 * stage_floats)
    return None


def weight_chunks(dims: Sequence[int], step: Sequence[int], split: int = None):
    """The producer warp's schedule: per layer, the chunks ``(k0, rows,
    spans)`` it copies into ring stages. A chunk of a row-major (K, N)
    matrix is one span ``(tensor, first_row, rows, stage_row)``; with
    ``split`` the first layer's rows come from two tensors (0: its first
    ``split`` rows, 1: the rest), so a chunk across the seam is two. The
    stage is zero-filled from ``rows`` up to the next multiple of 8."""
    out = []
    for l, (K, st) in enumerate(zip(dims[:-1], step)):
        chunks = []
        for k0 in range(0, K, st):
            n = min(st, K - k0)
            cut = split if (split is not None and l == 0) else K
            head = max(0, min(n, cut - k0))
            spans = [(0, k0, head, 0)] if head else []
            if head < n:
                spans.append((1, k0 + head - cut, n - head, head))
            chunks.append((k0, n, spans))
        out.append(chunks)
    return out


def column_runs(n: int, col_groups: int):
    """How a layer's ``n`` columns are dealt to the consumer warps' column
    groups: runs of ``tb = ceil(tiles / col_groups)`` 8-column tiles.
    Returns ``(base, tiles)`` per group; the tiles of a group lie side by
    side from ``base`` on and cover ``[base, base + 8 * tiles)``, past
    ``n`` up to the next multiple of 8 (zeros in shared memory)."""
    tiles = -(-n // 8)
    tb = -(-tiles // col_groups)
    return [(g * tb * 8, max(0, min(tb, tiles - g * tb))) for g in range(col_groups)]


def pass_cols(tile_rows: int) -> int:
    """Columns one pass of the forward tile loop covers: 8 * WARP_TILES per
    column group, 16 groups on the 16-row tile, 8 on the 64-row tile."""
    return 8 * WARP_TILES * CONSUMER_WARPS // {64: 2, 16: 1}[tile_rows]


def column_passes(n: int, cols: int):
    """``(c0, width)`` of each pass over a layer's ``n`` columns, ``cols``
    at a time: the wide path's passes (one pass where ``n <= cols``)."""
    return [(c0, min(cols, n - c0)) for c0 in range(0, n, cols)]


def wide_plan(dims: Sequence[int], tile_rows: int, extra_floats: int = 0):
    """``plan_wide`` of ``csrc/mlp_tile_mma.cuh``: how a wide-path block
    of ``tile_rows`` (64 or 16) rows lays the stack ``dims`` out.

    ``sa``: the planes' row stride; ``pass_cols``: columns a pass; the
    ring (``stage_floats``, ``stages``) holds whole weight rows of a layer
    of at most ``pass_cols`` columns and column slabs ``pass_cols`` floats
    a row of a wider one; ``step[l]``: weight rows per chunk of layer l;
    ``planes_smem`` / ``extra_smem``: whether the two pairs of planes and
    the caller's buffer (the step's f32 input rows) sit in shared memory,
    else in the block's slot of the workspace, of ``slot_floats`` floats;
    ``smem``: bytes. The places are tried in that order, each with the
    deepest ring of 64-, 32-, 16- or 8-row stages of which MIN_STAGES fit;
    the last always fits."""
    cols = pass_cols(tile_rows)
    sa = _up(max(dims), 8) + 4
    extra = _up(extra_floats, 4)
    stride = min(_up(max(dims[1:]), 4), cols)
    planes = 4 * tile_rows * sa
    for planes_smem, extra_smem in ((True, True), (False, True), (False, False)):
        fixed = BARRIER_BYTES + 4 * (planes * planes_smem + extra * extra_smem + 8)
        for rows in (64, 32, 16, 8):
            stage_floats = rows * stride
            if fixed + MIN_STAGES * 4 * stage_floats > MAX_SMEM:
                continue
            stages = min(MAX_STAGES, (MAX_SMEM - fixed) // (4 * stage_floats))
            return dict(sa=sa, pass_cols=cols, extra_floats=extra, stage_floats=stage_floats,
                        stages=stages, planes_smem=planes_smem, extra_smem=extra_smem,
                        slot_floats=planes * (not planes_smem) + extra * (not extra_smem),
                        step=[stage_floats // min(n, cols) // 8 * 8 for n in dims[1:]],
                        smem=fixed + stages * 4 * stage_floats)
    raise AssertionError("unreachable: three stages of 8 rows always fit")


def table_bytes(entries: int) -> int:
    """Bytes of the layer table at the head of a wide-path workspace."""
    return _up(entries * LAYER_DESC_BYTES, 256)


def fwd_route(rows: int, dims: Sequence[int], sms: int, extra_per_row: int = 0):
    """The path ``fused_mlp_fwd`` (and, with ``extra_per_row = n + m``,
    ``fused_ls_step``) takes for ``rows`` rows on ``sms`` SMs, as
    ``(path, tile_rows, plan, workspace_bytes)``: ``"tile"`` with the
    64-row tile once 16-row tiles would take more than two waves and
    ``tile_plan`` takes the stack there, else the 16-row tile where it
    takes it; else ``"wide"`` (``wide_plan``) at the tile height the same
    rule picks, with one slot a block and a block an SM at most."""
    big = rows > 2 * sms * 16
    if len(dims) - 1 <= INLINE_LAYERS:
        for tile_rows in ((64, 16) if big else (16,)):
            plan = tile_plan(dims, tile_rows, tile_rows * extra_per_row)
            if plan is not None:
                return "tile", tile_rows, plan, 0
    tile_rows = 64 if big else 16
    plan = wide_plan(dims, tile_rows, tile_rows * extra_per_row)
    blocks = min(-(-rows // tile_rows), sms)
    return ("wide", tile_rows, plan,
            table_bytes(len(dims) - 1) + blocks * 4 * plan["slot_floats"])


BWD_TILE_ROWS = 16  # csrc/fused_mlp_bwd.cu's tiles: 16 rows, or 32 where the call is large
BWD_STAGE_ROWS = (64, 48, 32, 24, 16, 8)  # ... and kStageRows
CHAIN_COLS = CONSUMER_WARPS * 8 * WARP_TILES  # ... and kChainCols: a pass's columns
SLOT_SLACK = 256  # ... and kSlotSlack: floats past a slot's planes that dW's reads may touch
MAX_SHARES = 4  # ... and kMaxShares


def bwd_tile_plan(dims: Sequence[int], tile_rows: int = BWD_TILE_ROWS):
    """``plan_bwd`` of ``csrc/fused_mlp_bwd.cu``: how a block lays the
    stack ``dims`` out in shared memory for a tile of ``tile_rows`` (16 or
    32) rows, or None where it does not fit: at 16 rows the kernel refuses
    the stack, at 32 it stays on 16-row tiles.

    ``sa[l]``: the row stride of the hi and lo planes that hold layer l's
    input (``sa[L]``: the output cotangent's), its width padded to a
    multiple of 16, plus 4; ``at[l]``: where they start, in floats;
    ``stage_floats`` and ``stages``: the ring that carries the recompute's
    weights; ``step[l]``: weight rows per chunk of recompute layer l;
    ``smem``: bytes. Every width must be at most ``CHAIN_COLS`` (the
    recompute and the chain deal a layer out in one pass), and every
    layer's planes and at least ``MIN_STAGES`` stages of 8 rows of the
    widest hidden layer must fit in ``MAX_SMEM`` bytes."""
    if max(dims) > CHAIN_COLS:
        return None
    sa = [_up(d, 16) + 4 for d in dims]
    at = [2 * tile_rows * sum(sa[:l]) for l in range(len(dims))]
    floats = 2 * tile_rows * sum(sa)
    fixed = BARRIER_BYTES + 4 * (floats + 8)
    hidden = dims[1:-1]
    for rows in BWD_STAGE_ROWS:
        stage_floats = rows * _up(max([4] + hidden), 4)
        if fixed + MIN_STAGES * 4 * stage_floats > MAX_SMEM:
            continue
        stages = min(MAX_STAGES, (MAX_SMEM - fixed) // (4 * stage_floats))
        return dict(sa=sa, at=at, ring_at=floats, stage_floats=stage_floats, stages=stages,
                    step=[stage_floats // n // 8 * 8 for n in hidden],
                    smem=fixed + stages * 4 * stage_floats)
    return None


def bwd_wide_plan(dims: Sequence[int], tile_rows: int = BWD_TILE_ROWS):
    """``plan_bwd_wide`` of ``csrc/fused_mlp_bwd.cu``: the backward's wide
    path for tiles of ``tile_rows`` (16 or 32) rows. Every layer's planes
    as ``bwd_tile_plan`` lays them out (``sa``, ``at``; ``plane_floats`` in
    all), in shared memory where they fit beside a ring of MIN_STAGES
    stages (``planes_smem``), else in the block's slot of the workspace
    (``slot_floats``: the planes and ``SLOT_SLACK``); the ring's stages
    hold whole weight rows of a recompute layer of at most ``CHAIN_COLS``
    columns and column slabs ``CHAIN_COLS`` floats a row of a wider one;
    ``step[l]``: weight rows per chunk of recompute layer l; ``offset[l]``:
    where dW_l starts in a gradient set."""
    sa = [_up(d, 16) + 4 for d in dims]
    at = [2 * tile_rows * sum(sa[:l]) for l in range(len(dims))]
    offset = [sum(a * b + b for a, b in zip(dims[:l], dims[1:l + 1]))
              for l in range(len(dims) - 1)]
    floats = 2 * tile_rows * sum(sa)
    hidden = dims[1:-1]
    stride = min(_up(max([4] + hidden), 4), CHAIN_COLS)
    for planes_smem in (True, False):
        fixed = BARRIER_BYTES + 4 * (floats * planes_smem + 8)
        for rows in BWD_STAGE_ROWS:
            stage_floats = rows * stride
            if fixed + MIN_STAGES * 4 * stage_floats > MAX_SMEM:
                continue
            stages = min(MAX_STAGES, (MAX_SMEM - fixed) // (4 * stage_floats))
            return dict(sa=sa, at=at, offset=offset, plane_floats=floats,
                        stage_floats=stage_floats, stages=stages, planes_smem=planes_smem,
                        slot_floats=0 if planes_smem else floats + SLOT_SLACK,
                        step=[stage_floats // min(n, CHAIN_COLS) // 8 * 8 for n in hidden],
                        smem=fixed + stages * 4 * stage_floats)
    raise AssertionError("unreachable: three stages of 8 rows always fit")


def bwd_route(rows: int, dims: Sequence[int], sms: int):
    """The path ``fused_mlp_bwd`` takes for ``rows`` (> 0) rows on ``sms``
    SMs, as ``(path, tile_rows, plan, scratch_bytes)``: ``"tile"`` with
    32-row tiles once 16-row tiles would take more than two waves of blocks
    and the stack's planes fit twice (``bwd_tile_plan``), else 16-row tiles
    where they fit; else ``"wide"`` (``bwd_wide_plan``) at the tile height
    the same rule picks, one slot a block (up to ``MAX_SHARES`` blocks
    share a slice of tiles where the slices leave SMs idle)."""
    big = rows > 2 * sms * BWD_TILE_ROWS
    if len(dims) - 1 <= INLINE_LAYERS:
        for tile_rows in ((32, 16) if big else (16,)):
            plan = bwd_tile_plan(dims, tile_rows)
            if plan is not None:
                return "tile", tile_rows, plan, 0
    tile_rows = 2 * BWD_TILE_ROWS if big else BWD_TILE_ROWS
    plan = bwd_wide_plan(dims, tile_rows)
    tiles = -(-rows // tile_rows)
    per_block = -(-tiles // sms)
    slices = -(-tiles // per_block)
    shares = max(1, min(MAX_SHARES, sms // slices))
    return ("wide", tile_rows, plan,
            table_bytes(len(dims)) + slices * shares * 4 * plan["slot_floats"])


def bwd_tile_rows(rows: int, dims: Sequence[int], sms: int) -> int:
    """The tile height ``fused_mlp_bwd`` picks (``bwd_route``): 32 rows
    once 16-row tiles would take more than two waves of blocks on ``sms``
    SMs (on the shared-memory path where the stack's planes fit twice),
    else 16."""
    return bwd_route(rows, dims, sms)[1] if rows > 0 else BWD_TILE_ROWS


def reference_backward(x: torch.Tensor, layers: Layers, g: torch.Tensor):
    """Plain torch relu-MLP backward, the backward kernel's reference:
    recompute the forward, then backprop ``g`` (N, fout) through the relu
    masks, as ``_bwd_kernel`` does. Returns (dx, [(dW, db), ...])."""
    acts, h = [x], x
    for w, b in layers[:-1]:
        h = torch.relu(h @ w + b)
        acts.append(h)
    grads = [None] * len(layers)
    for i in reversed(range(len(layers))):
        grads[i] = (acts[i].T @ g, g.sum(0))
        g = g @ layers[i][0].T
        if i > 0:
            g = torch.where(acts[i] > 0, g, 0.0)
    return g, grads


def _split(t: torch.Tensor):
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _product_3xtf32(a, b):
    """``a @ b`` (batched or not) from parts ``(hi, lo)`` of both: the
    small terms first, as the kernels add them."""
    return (a[1] @ b[0] + a[0] @ b[1]) + a[0] @ b[0]


def reference_backward_3xtf32(x: torch.Tensor, layers: Layers, g: torch.Tensor,
                              tile_rows: int = BWD_TILE_ROWS):
    """The backward kernel's arithmetic in plain torch. Every operand is
    split into ``hi = tf32(v)`` and ``lo = tf32(v - hi)`` and every product
    taken as ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in float32: the
    recompute (``reference_forward_3xtf32``, whose activations are kept as
    their two parts), the chain ``g W^T`` masked where the activation's hi
    part is positive, and ``dW = a^T g``, which like ``db`` (a sum of
    ``g_hi + g_lo``) is taken per tile of ``tile_rows`` rows (rows past the
    last are zeros) and then summed over the tiles in order. Returns
    (dx, [(dW, db), ...]) as ``reference_backward``."""
    rows = x.shape[0]
    tiles = max(1, -(-rows // tile_rows))
    pad = lambda t: torch.cat([t, t.new_zeros((tiles * tile_rows - rows, t.shape[1]))])
    by_tile = lambda t: t.view(tiles, tile_rows, t.shape[1])

    def in_order(parts):  # (tiles, ...) summed from the first tile on
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    weights = [_split(w) for w, _ in layers]
    acts = [_split(pad(x))]
    for w, (_, b) in zip(weights[:-1], layers):
        acts.append(_split(torch.relu(_product_3xtf32(acts[-1], w) + b)))
    gs = _split(pad(g))
    grads = [None] * len(layers)
    for i in reversed(range(len(layers))):
        a_t = tuple(by_tile(p).transpose(1, 2) for p in acts[i])
        dw = in_order(_product_3xtf32(a_t, tuple(by_tile(p) for p in gs)))
        db = in_order(by_tile(gs[0] + gs[1]).sum(1))
        grads[i] = (dw, db)
        back = _product_3xtf32(gs, tuple(p.T for p in weights[i]))
        if i > 0:
            gs = _split(torch.where(acts[i][0] > 0, back, 0.0))
    return back[:rows], grads


class FusedMlpKernel:
    """One instance of the CUDA forward kernel, f32 or ``bf16``: built on
    first use, counted per launch."""

    source = "gan_mpc_tpu_torch/csrc/fused_mlp_fwd.cu"
    replaces = "gan_mpc_tpu/ops/fused_mlp.py:91"

    def __init__(self, bf16: bool = False):
        self.bf16 = bf16
        self.name = "fused_mlp_fwd_bf16" if bf16 else "fused_mlp_fwd"
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            from gan_mpc_tpu_torch.ops._build import load_library

            lib = load_library("fused_mlp_fwd")
            lib.fused_mlp_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int,
                *WORKSPACE_ARGS,
                ctypes.c_void_p,
            ]
            lib.fused_mlp_fwd.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, layers: Layers) -> torch.Tensor:
        _check_kernel_args(x, layers)
        if _records_grad(x, layers):
            raise RuntimeError(
                "fused_mlp_fwd records no autograd graph; call mlp_apply, "
                "which differentiates through FusedMlpFunction"
            )
        lib = self.load()
        n = len(layers)
        dims = [x.shape[1]] + [w.shape[1] for w, _ in layers]
        y = torch.empty((x.shape[0], dims[-1]), device=x.device, dtype=x.dtype)
        c_dims = (ctypes.c_int * (n + 1))(*dims)
        c_w = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in layers])
        c_b = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
        # the library launches on the current device: make it the operands'
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = call_with_workspace(
                lib.fused_mlp_fwd,
                (x.data_ptr(), y.data_ptr(), x.shape[0], n, c_dims, c_w, c_b, int(self.bf16)),
                x.device, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed with code {err} "
                f"(rows={x.shape[0]}, dims={dims})"
            )
        self.launches += 1
        return y


# a kernel's workspace arguments: its pointer, its bytes, where the bytes it
# needs go
WORKSPACE_ARGS = (ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t))


def call_with_workspace(fn, args, device, stream) -> int:
    """``fn(*args, work, work_bytes, &needed, stream)``, a kernel's C entry
    point: first without a workspace; where the kernel asks for one
    (``NEED_WORKSPACE``: the wide path), again with one of the bytes it
    asked for, allocated here on the current stream (the caching allocator
    hands the block to later work on this stream only). Returns the
    entry point's code."""
    need = ctypes.c_size_t(0)
    err = fn(*args, None, 0, ctypes.byref(need), stream)
    if err == NEED_WORKSPACE:
        work = torch.empty(need.value, dtype=torch.uint8, device=device)
        err = fn(*args, work.data_ptr(), need.value, ctypes.byref(need), stream)
    return err


def _records_grad(x: torch.Tensor, layers: Layers) -> bool:
    """Whether autograd would record a graph through this call."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for wb in layers for t in wb)
    )


def _check_kernel_args(x: torch.Tensor, layers: Layers) -> None:
    if not x.is_cuda:
        raise ValueError("the fused MLP kernel takes CUDA tensors only")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous 2-D float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if not layers:
        raise ValueError("the stack has no layer")
    width = x.shape[1]
    for i, (w, b) in enumerate(layers):
        for t in (w, b):
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(
                    f"layer {i}: weights must be contiguous float32 on {x.device}"
                )
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer {i}: W {tuple(w.shape)} / b {tuple(b.shape)} do not "
                f"chain from width {width}"
            )
        width = w.shape[1]
    if min([x.shape[1]] + [w.shape[1] for w, _ in layers]) < 1:
        raise ValueError("every layer must be at least 1 wide")


fused_mlp_forward = FusedMlpKernel()
fused_mlp_forward_bf16 = FusedMlpKernel(bf16=True)


class FusedMlpBwdKernel:
    """The CUDA backward kernel: built on first use, counted per launch.

    It takes any row count (0 and ragged tiles included) and any stack.
    Where the stack has at most ``INLINE_LAYERS`` layers of at most
    ``CHAIN_COLS`` columns and its 16-row tile fits in a block's shared
    memory (the hi and lo planes of all layers' inputs and of the output
    cotangent, plus a weight ring of at least 3 stages of 8 rows of the
    widest hidden layer, in 232,448 bytes: ``bwd_tile_plan``) the planes
    stay in shared memory: the dynamics (23->200->200->200->17), 256-wide
    (23->256->256->256->17), cost (17->128->128->10) and humanoid-class
    (41->200->200->200->29) stacks, 23->512->512->17 and up to seven
    200-wide hidden layers. Any other stack (six 256-wide or three
    512-wide hidden layers, 1024-wide ones, 32 layers) takes the wide path
    (``bwd_wide_plan``): every layer's activations in a device workspace
    of about rows x the sum of the widths, the recompute and the dx chain
    in passes of ``CHAIN_COLS`` columns. Both paths sum dW and db over the
    row tiles in a fixed order, without atomics."""

    source = "gan_mpc_tpu_torch/csrc/fused_mlp_bwd.cu"
    replaces = "gan_mpc_tpu/ops/fused_mlp.py:108"
    name = "fused_mlp_bwd"

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            from gan_mpc_tpu_torch.ops._build import load_library

            lib = load_library("fused_mlp_bwd")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.fused_mlp_bwd.argtypes = [p] * 5 + [i, i, i, ctypes.POINTER(i),
                                                    ctypes.POINTER(p), ctypes.POINTER(p),
                                                    *WORKSPACE_ARGS, p]
            lib.fused_mlp_bwd.restype = i
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, layers: Layers, g: torch.Tensor):
        """(dx, [(dW, db), ...]) for x (N, fin) and the output cotangent g
        (N, fout). The gradients are views of one flat tensor."""
        _check_kernel_args(x, layers)
        rows, fout = x.shape[0], layers[-1][0].shape[1]
        if g.device != x.device or g.dtype != torch.float32 or not g.is_contiguous() \
                or tuple(g.shape) != (rows, fout):
            raise ValueError(
                f"g must be a contiguous float32 ({rows}, {fout}) tensor on {x.device}, "
                f"got {g.dtype} {tuple(g.shape)} on {g.device}"
            )
        lib = self.load()
        n = len(layers)
        dims = [x.shape[1]] + [w.shape[1] for w, _ in layers]
        c_dims = (ctypes.c_int * (n + 1))(*dims)
        sizes = [a * b + b for a, b in zip(dims[:-1], dims[1:])]
        grads = torch.empty(sum(sizes), device=x.device, dtype=x.dtype)
        # one partial gradient set (padded to 4 floats) per slice of the
        # launch, at most one per SM; the caching allocator hands the same
        # block back on later calls
        parts = torch.cuda.get_device_properties(x.device).multi_processor_count
        work = torch.empty((parts, _up(sum(sizes), 4)), device=x.device, dtype=x.dtype)
        dx = torch.empty_like(x)
        c_w = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in layers])
        c_b = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
        # the library launches on the current device: make it the operands'
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = call_with_workspace(
                lib.fused_mlp_bwd,
                (x.data_ptr(), g.data_ptr(), dx.data_ptr(), grads.data_ptr(), work.data_ptr(),
                 parts, rows, n, c_dims, c_w, c_b),
                x.device, stream)
        if err != 0:
            raise RuntimeError(
                f"fused_mlp_bwd launch failed with code {err} (-1: arguments refused; "
                f"rows={rows}, dims={dims})"
            )
        self.launches += 1
        out = []
        for (a, b), chunk in zip(zip(dims[:-1], dims[1:]), torch.split(grads, sizes)):
            out.append((chunk[: a * b].view(a, b), chunk[a * b:]))
        return dx, out


fused_mlp_backward = FusedMlpBwdKernel()


class FusedMlpFunction(torch.autograd.Function):
    """The fused MLP under autograd on CUDA tensors: the forward kernel
    forward, the backward kernel backward (the JAX ``fused_mlp`` custom
    VJP). Arguments: x, then W0, b0, W1, b1, ..."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return fused_mlp_forward(x, _pairs(flat))

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, *flat = ctx.saved_tensors
        dx, grads = fused_mlp_backward(x, _pairs(flat), gy.contiguous())
        out = [dx] + [t for wb in grads for t in wb]
        return tuple(t if need else None for t, need in zip(out, ctx.needs_input_grad))


def _pairs(flat):
    return list(zip(flat[0::2], flat[1::2]))


def mlp_apply(x: torch.Tensor, layers: Layers, compute_dtype=None,
              twice_differentiable: bool = False) -> torch.Tensor:
    """relu-MLP forward on (N, fin) rows.

    CPU tensors run ``reference_forward`` (under autograd when it is on);
    CUDA tensors run the fused kernel at every row count (the JAX
    package's 8192-row threshold was a TPU crossover), through
    ``FusedMlpFunction`` when a gradient is to be taken.
    ``compute_dtype="bfloat16"`` (``compute_is_bf16``) takes bfloat16
    products: on CUDA tensors without a gradient the kernel's bf16
    instance, else the plain bf16 forward (the module's docstring).

    ``FusedMlpFunction`` is once differentiable. A caller that will take a
    second derivative through this call (the implicit planner's mixed
    term, ``planner/bilevel.py``) asks for ``twice_differentiable``: the
    plain ``reference_forward`` on every device, which autograd
    differentiates any number of times. The JAX package takes those
    derivatives in flax, outside its kernels, too.
    """
    bf16 = compute_is_bf16(compute_dtype)
    if not x.is_cuda or twice_differentiable or (bf16 and _records_grad(x, layers)):
        return reference_forward(x, layers, bf16)
    x = x.contiguous()
    if _records_grad(x, layers):
        return FusedMlpFunction.apply(x, *[t for wb in layers for t in wb])
    return (fused_mlp_forward_bf16 if bf16 else fused_mlp_forward)(x, layers)


def mlp_value_and_jac(x: torch.Tensor, layers: Layers, compute_dtype=None):
    """Forward value and exact input-Jacobian of a relu MLP, batch-major.

    x (N, fin) -> (y (N, fout), J (N, fout, fin)). The Jacobian chain of
    masked weight products runs from the cheaper side: output-side when
    fout < fin (the dynamics linearization), input-side otherwise. Plain
    ``torch.matmul``, as the JAX package leaves it to XLA; with
    ``compute_dtype="bfloat16"`` every product of the forward and of the
    chain is ``bf16_mm``'s, the masks and the bias and relu stay f32.
    """
    mm = bf16_mm if compute_is_bf16(compute_dtype) else torch.matmul
    n_layers = len(layers)
    N, fin = x.shape
    h = x
    masks = []
    for i, (w, b) in enumerate(layers):
        h = mm(h, w) + b
        if i < n_layers - 1:
            mask = (h > 0.0).to(h.dtype)
            h = h * mask
            masks.append(mask)
    fout = layers[-1][0].shape[1]

    if fout < fin:
        # R_L = W_{L-1};  R_i = W_i diag(m_{i+1}) R_{i+1}; J^T = R_0
        wl = layers[-1][0]
        R = wl.expand((N,) + tuple(wl.shape))
        if masks:
            R = R * masks[-1][..., None]
        for i in range(n_layers - 2, -1, -1):
            wi = layers[i][0]
            Rt = R.transpose(1, 2).reshape(N * fout, -1)
            R = mm(Rt, wi.T).reshape(N, fout, -1).transpose(1, 2)
            if i > 0:
                R = R * masks[i - 1][..., None]
        return h, R.transpose(1, 2)

    w0 = layers[0][0]
    J = w0.expand((N,) + tuple(w0.shape))
    if masks:
        J = J * masks[0][:, None, :]
    for i in range(1, n_layers):
        wi = layers[i][0]
        J = mm(J.reshape(N * fin, -1), wi).reshape(N, fin, -1)
        if i < n_layers - 1:
            J = J * masks[i][:, None, :]
    return h, J.transpose(1, 2)
