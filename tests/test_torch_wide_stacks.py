"""Stacks of any depth and width, as far as a CPU can hold them.

On the card every stack runs through the hand-written kernels: the
committed ones (at most ``INLINE_LAYERS`` layers, each layer one pass of
the warps' columns, activations in shared memory) on the path they took
before, any other on the kernels' wide path (the forward and the step: a
cluster of blocks a row tile, each a slice of every layer's columns,
activations in the blocks' shared memory; the backward: passes of 512 or
256 columns over a device workspace; the layers read from a table in
device memory). Here:

  1. the Python mirrors of the kernels' planners give a plan for every
     stack of ``chip_smoke.py``'s phase 19 (a), at every row count it
     uses, and each plan keeps what the kernels rely on (shared memory
     within a block's, whole k-steps a chunk, blocks' column runs and
     passes that cover the columns once, chunks that end at every segment);
     the forward's cluster picker at its edges (a ragged last block, one
     with no columns, the non-portable size);
  2. every committed stack keeps today's plan on the shared-memory path
     (forward at 64 and 16 rows, the step, the backward at 16 and 32),
     pinned as literals, and the routes still pick that path;
  3. the mirrors' constants against the CUDA sources;
  4. the port's plain path against the JAX package at wide and deep
     stacks, inputs from a numpy seed, weights carried across by
     ``params.from_jax_params`` / ``dynamics_from_jax_params``:
     ``mlp_apply``'s value and ``FusedMlpFunction``'s VJP (its kernels
     replaced by the plain forward and by the backward kernel's arithmetic
     model, ``reference_backward_3xtf32`` as the wide path takes the call)
     against JAX's ``fused_mlp`` at 23->1024->1024->17 and a 12-layer
     stack; ``fused_ls_step`` with a [512] * 4 stack against JAX's; one
     ``plan_batch`` of a 4-env configs/gan_cheetah.yaml policy with
     dynamics [512] * 4 against the JAX policy's; one dynamics-trainer
     update at [256] * 6 against JAX's ``_update_scan``. Tolerances are
     stated per test.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import gan_mpc_tpu.ops.fused_ls as jfl
import gan_mpc_tpu.training.dynamics as jdyn
from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.models.dynamics import LearnedDynamics as JaxLearnedDynamics
from gan_mpc_tpu.models.dynamics import ResidualMLPDynamicsNet as JaxResidualNet
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.training.masking import masked_adam as jax_masked_adam
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.ops import fused_mlp as fm
from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_step, split_w0
from gan_mpc_tpu_torch.ops.fused_mlp import (
    FusedMlpFunction,
    bwd_model_args,
    bwd_route,
    bwd_tile_plan,
    column_passes,
    column_runs,
    fwd_route,
    mlp_apply,
    pass_cols,
    reference_backward_3xtf32,
    reference_forward,
    tile_plan,
)
from gan_mpc_tpu_torch.params import dynamics_from_jax_params, from_jax_params
from gan_mpc_tpu_torch.runners import common
from gan_mpc_tpu_torch.training import dynamics as tdyn
from gan_mpc_tpu_torch.training.masking import masked_adam

jfm = importlib.import_module("gan_mpc_tpu.ops.fused_mlp")

torch.set_num_threads(1)
pin_fp32()

CSRC = Path(fm.__file__).resolve().parent.parent / "csrc"
SMS = 132  # an H100's SMs: the routes' rule depends on the count
CONFIG = "configs/gan_cheetah.yaml"


def _up(n, m):
    return -(-n // m) * m


def _stack_cases():
    """Every stack and row count of phase 19 (a): (kind, name, dims, rows, extra)."""
    cases = []
    for name, dims in chip_smoke.G19_FWD:
        for rows in chip_smoke.G19_FWD_ROWS[1:]:  # 0 rows launch nothing
            cases.append(("fwd", name, dims, rows, 0))
        for lanes, alphas in chip_smoke.G19_LS:
            cases.append(("step", name, dims, lanes * alphas, dims[0]))
    for name, dims in chip_smoke.G19_BWD:
        for rows in chip_smoke.G19_BWD_ROWS:
            cases.append(("bwd", name, dims, rows, 0))
    return cases


CASES = _stack_cases()


@pytest.mark.parametrize("kind,name,dims,rows,extra", CASES,
                         ids=[f"{k}-{n}-{r}" for k, n, _, r, _ in CASES])
def test_phase_19_stacks_get_a_wide_plan(kind, name, dims, rows, extra):
    """Each of phase 19 (a)'s calls takes the wide path with a plan that
    keeps the kernels' rules. The backward: shared memory within a block's,
    at least MIN_STAGES ring stages, chunks of whole k-steps of 8 that fit
    a stage at the layer's row stride, passes that cover each layer once
    and deal at most WARP_TILES tiles to a warp, 16-byte aligned tiles of
    its workspace. The forward and the step: a cluster (1, 2, 4, 8, or 16
    on 16-row tiles) whose blocks' column runs cover every layer once in
    passes of whole 8-column tiles, shared memory within a block's (the two
    buffers of the widest hidden slice and WIDE_PRODUCERS stages of
    1024-byte multiples: the step's input rows stay in device memory), chunks of a power of two rows of K that
    end at every multiple of SEGMENT_ROWS and whose weight rows and input
    planes fit a stage, and no workspace (no stream, a table the launch's
    parameters hold)."""
    if kind == "bwd":
        path, tile_rows, plan, scratch = bwd_route(rows, dims, SMS)
        cols = fm.CHAIN_COLS
        assert plan["sa"] == [_up(d, 16) + 4 for d in dims]
        assert plan["at"] == [2 * tile_rows * sum(plan["sa"][:l]) for l in range(len(dims))]
        # the inputs' planes, then the cotangents' (g_1 .. g_L) in one tile
        assert plan["tile_floats"] == 2 * tile_rows * (sum(plan["sa"]) + sum(plan["sa"][1:-1]))
        assert plan["offset"][0] == 0 and all(
            b - a == k * n + n for a, b, k, n in zip(plan["offset"], plan["offset"][1:],
                                                    dims, dims[1:]))
        fixed = fm.BARRIER_BYTES + 4 * 8  # the ring alone: the planes live in the workspace
        chunk_tiles = min(-(-rows // tile_rows), fm.BWD_CHUNK_ROWS // tile_rows)
        assert scratch == _up(len(dims) * (fm.LAYER_DESC_BYTES + 4), 256) \
            + chunk_tiles * 4 * plan["tile_floats"]
        assert plan["tile_floats"] % 4 == 0  # every tile of the chunk starts 16-byte aligned
        assert tile_rows == (32 if rows > 2 * SMS * 16 else 16)
        assert plan["smem"] == fixed + plan["stages"] * 4 * plan["stage_floats"] <= fm.MAX_SMEM
        assert fm.MIN_STAGES <= plan["stages"] <= fm.MAX_STAGES
        assert plan["stage_floats"] % 4 == 0 and plan["stage_floats"] <= 64 * cols
        for n, step in zip(dims[1:-1], plan["step"]):
            assert step % 8 == 0 and step >= 8 and step * min(n, cols) <= plan["stage_floats"]
        for n in dims[1:-1] + dims[:-1]:
            passes = column_passes(n, cols)
            assert [c for c0, w in passes for c in range(c0, c0 + w)] == list(range(n))
            for _, w in passes:
                assert all(t <= fm.WARP_TILES for _, t in column_runs(w, fm.CONSUMER_WARPS))
        return
    path, tile_rows, plan, cluster = fwd_route(rows, dims, SMS, extra)
    assert path == "wide" and cluster == plan["cluster"] in (1, 2, 4, 8, 16)
    assert not plan["streamed"] and len(dims) - 1 <= fm.TABLE_LAYERS
    assert fm.fwd_workspace_bytes(dims, tile_rows, plan, -(-rows // tile_rows)) == 0
    big = rows > 2 * SMS * 16
    at_64 = [c for c in (1, 2, 4, 8) if fm.wide_plan(dims, 64, c, extra > 0)]
    assert tile_rows == (64 if big and at_64 else 16)
    assert cluster <= (fm.PORTABLE_CLUSTER if tile_rows == 64 else fm.MAX_CLUSTER)
    cols = pass_cols(tile_rows)
    assert plan["pass_cols"] == cols
    for n, c in zip(dims[1:], plan["cols"]):
        assert c == 8 * -(-(-(-n // 8)) // cluster)
        passes = [p for r in range(cluster) for p in fm.block_passes(n, c, r, cols)]
        assert [i for c0, w in passes for i in range(c0, c0 + w)] == list(range(n))
        assert all(c0 % 8 == 0 and w <= cols for c0, w in passes)
        for _, w in passes:
            assert all(t <= fm.WARP_TILES for _, t in column_runs(w, fm.CONSUMER_WARPS
                                                                   // {64: 2, 16: 1}[tile_rows]))
    hidden = plan["cols"][:-1]
    assert plan["sb"] == (max(hidden) + 4 if hidden else 0) and plan["sb"] % 8 in (0, 4)
    assert plan["stages"] == fm.WIDE_PRODUCERS and plan["stage_floats"] % 256 == 0
    fixed = fm.BARRIER_BYTES + 1024 + 4 * (2 * tile_rows * plan["sb"] + 8)
    assert plan["smem"] == fixed + plan["stages"] * 4 * plan["stage_floats"] <= fm.MAX_SMEM
    for l, (n, c, mode, step) in enumerate(zip(dims[1:], plan["cols"], plan["mode"],
                                               plan["step"])):
        assert mode == fm.wide_mode(n, cols, extra > 0 and l == 0)
        assert step >= 8 and step & (step - 1) == 0 and fm.SEGMENT_ROWS % step == 0
        assert step <= (fm.MAX_BOX_ROWS if mode == fm.ROWS_BOXES else fm.SEGMENT_ROWS)
        wf = fm.wide_row_floats(mode, min(c, cols), n)
        assert step * wf + 2 * tile_rows * (step + 4) <= plan["stage_floats"]


@pytest.mark.parametrize("rows,dims,extra,want", [
    (512, [23, 1024, 1024, 1024, 17], 0, (16, 4)),    # one wave: 32 tiles x 4 blocks
    (8192, [23, 1024, 1024, 1024, 17], 0, (64, 4)),   # the smallest that fits
    (8192, [23, 2048, 2048, 17], 23, (64, 8)),
    (8192, [23, 4096, 17], 0, (16, 4)),               # 64-row tiles would need 16 blocks
    (1, [23, 4096, 17], 0, (16, 8)),                  # raised to the portable most
    (37, [23] + [200] * 8 + [17], 0, (16, 2)),        # a block's warps hold a tile each from 2
    (512, [23] + [64] * 30 + [17], 0, (16, 1)),
    (8192, [23] + [8192] * 4 + [17], 0, (16, 8)),
    (300, [23, 16384, 17], 0, (16, 16)),              # only the non-portable size holds it
    (512, [23, 520, 17], 0, (16, 4)),                 # a ragged last block
])
def test_cluster_picker(rows, dims, extra, want):
    """``wide_cluster``, the mirror of ``plan_launch``: the smallest cluster
    whose slices fit, raised to fill the SMs with one wave of clusters (to
    PORTABLE_CLUSTER, while some layer deals a block more tiles than it has
    column groups); the 64-row tile only on portable clusters."""
    tile_rows, plan = fm.wide_cluster(rows, dims, SMS, extra)
    assert (tile_rows, plan["cluster"]) == want
    assert plan == fm.wide_plan(dims, tile_rows, want[1], extra > 0)
    smaller = want[1] // 2
    tiles = -(-rows // tile_rows)
    if smaller and fm.wide_plan(dims, tile_rows, smaller, extra > 0):
        assert tiles * want[1] <= SMS  # raised only while a wave still fits


def _first_streamed_width():
    """The narrowest single hidden layer (in whole tiles of 8) whose slices
    no cluster of MAX_CLUSTER holds on the 16-row tile."""
    n = 8
    while fm.wide_plan([23, n, 17], 16, fm.MAX_CLUSTER) is not None:
        n += 8
    return n


def test_streamed_plans():
    """Past the widths a cluster of 16 holds, the forward and the step
    stream their activations: the 16-row tile, a plan whose two buffers
    (whole rows of the widest hidden layer, rounded up to 4) take no shared
    memory, the cluster picked as for any stack from 1, and a workspace of
    those buffers a cluster. The first such width lies between 18,432 (a
    cluster of 16 holds it) and 20,000."""
    first = _first_streamed_width()
    assert 18432 < first <= 20000
    held = fwd_route(300, [23, first - 8, 17], SMS)
    assert held[2]["cluster"] == fm.MAX_CLUSTER and not held[2]["streamed"]
    for rows, dims, extra, want in ((300, [23, first, 17], 0, (16, 4)),
                                    (8192, [23, 24576, 17], 0, (16, 1)),
                                    (37, [23, 24576, 24576, 17], 23, (16, 8)),
                                    (1, [23, 1000, 30000, 17], 0, (16, 8))):
        path, tile_rows, plan, cluster = fwd_route(rows, dims, SMS, extra)
        assert (path, tile_rows, cluster) == ("wide", *want) and plan["streamed"]
        assert plan == fm.wide_plan(dims, 16, cluster, extra > 0, True)
        assert plan["sb"] == _up(max(dims[1:-1]), 4)
        fixed = fm.BARRIER_BYTES + 1024 + 4 * 8  # the ring alone
        assert plan["smem"] == fixed + plan["stages"] * 4 * plan["stage_floats"] <= fm.MAX_SMEM
        clusters = min(-(-rows // 16), SMS // cluster)
        assert fm.fwd_workspace_bytes(dims, 16, plan, clusters) == \
            clusters * 2 * 16 * plan["sb"] * 4


def test_deep_tables_take_a_workspace_head():
    """A stack of at most TABLE_LAYERS layers travels in the launch's
    parameters; each further layer's WideLayer and tensor map go to the
    workspace's head (the WideLayers padded to 128, the whole to 256)."""
    for layers, want in ((fm.TABLE_LAYERS, 0), (fm.TABLE_LAYERS + 1, 256),
                         (70, _up(6 * 32, 128) + 6 * 128), (200, _up(136 * 32, 128) + 136 * 128)):
        dims = [23] + [32] * (layers - 1) + [17]
        _, tile_rows, plan, _ = fwd_route(37, dims, SMS)
        assert not plan["streamed"]
        assert fm.fwd_workspace_bytes(dims, tile_rows, plan, 3) == _up(want, 256)


def test_ragged_clusters():
    """A cluster whose last block owns fewer columns, or none: the blocks'
    runs still cover each layer once (17 columns on 4 blocks: 8, 8, 1, none;
    520 on 4: three of 136 and one of 112)."""
    for n, cluster, runs in ((17, 4, [8, 8, 1, 0]), (520, 4, [136, 136, 136, 112])):
        cols = 8 * -(-(-(-n // 8)) // cluster)
        got = [sum(w for _, w in fm.block_passes(n, cols, r, 512)) for r in range(cluster)]
        assert got == runs and sum(got) == n


# Today's plans of the committed stacks (dynamics, cost, gan/4's 256-wide
# dynamics, the humanoid-class stacks, the ensemble member, the 512-wide
# stack phase 16 holds, odd widths, gan/9's stacks, the LSTM dynamics'
# head; the step at each dynamics' n + m), as the shared-memory path lays
# them out
COMMITTED = {
    "dynamics": [23, 200, 200, 200, 17], "cost": [17, 128, 128, 10],
    "gan4": [23, 256, 256, 256, 17], "humanoid": [41, 200, 200, 200, 29],
    "humanoid_cost": [29, 128, 128, 10], "member": [41, 256, 256, 256, 29],
    "widest": [23, 512, 512, 17], "odd": [23, 41, 17], "gan9": [4, 200, 200, 200, 3],
    "gan9_cost": [3, 128, 128, 10], "lstm_head": [64, 128, 128, 17],
}
STEP_EXTRA = {"dynamics": 23, "gan4": 23, "humanoid": 41, "gan9": 4}
PLANS = {
    ('dynamics', 'fwd', 64): {'sa': 204, 'stage_floats': 6400, 'stages': 4, 'step': [32, 32, 32, 376], 'smem': 207008},
    ('dynamics', 'fwd', 16): {'sa': 204, 'stage_floats': 12800, 'stages': 4, 'step': [64, 64, 64, 752], 'smem': 231072},
    ('dynamics', 'bwd', 16): {'sa': [36, 212, 212, 212, 36], 'at': [0, 1152, 7936, 14720, 21504], 'ring_at': 22656, 'stage_floats': 9600, 'stages': 3, 'step': [48, 48, 48], 'smem': 205984},
    ('dynamics', 'bwd', 32): {'sa': [36, 212, 212, 212, 36], 'at': [0, 2304, 15872, 29440, 43008], 'ring_at': 45312, 'stage_floats': 3200, 'stages': 3, 'step': [16, 16, 16], 'smem': 219808},
    ('cost', 'fwd', 64): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 816], 'smem': 198816},
    ('cost', 'fwd', 16): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 816], 'smem': 148128},
    ('cost', 'bwd', 16): {'sa': [36, 132, 132, 20], 'at': [0, 1152, 5376, 9600], 'ring_at': 10240, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 172192},
    ('cost', 'bwd', 32): {'sa': [36, 132, 132, 20], 'at': [0, 2304, 10752, 19200], 'ring_at': 20480, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 213152},
    ('gan4', 'fwd', 64): {'sa': 260, 'stage_floats': 8192, 'stages': 3, 'step': [32, 32, 32, 480], 'smem': 231584},
    ('gan4', 'fwd', 16): {'sa': 260, 'stage_floats': 16384, 'stages': 3, 'step': [64, 64, 64, 960], 'smem': 230048},
    ('gan4', 'bwd', 16): {'sa': [36, 260, 260, 260, 36], 'at': [0, 1152, 9472, 17792, 26112], 'ring_at': 27264, 'stage_floats': 8192, 'stages': 3, 'step': [32, 32, 32], 'smem': 207520},
    ('gan4', 'bwd', 32): None,
    ('humanoid', 'fwd', 64): {'sa': 204, 'stage_floats': 6400, 'stages': 4, 'step': [32, 32, 32, 216], 'smem': 207008},
    ('humanoid', 'fwd', 16): {'sa': 204, 'stage_floats': 12800, 'stages': 4, 'step': [64, 64, 64, 440], 'smem': 231072},
    ('humanoid', 'bwd', 16): {'sa': [52, 212, 212, 212, 36], 'at': [0, 1664, 8448, 15232, 22016], 'ring_at': 23168, 'stage_floats': 9600, 'stages': 3, 'step': [48, 48, 48], 'smem': 208032},
    ('humanoid', 'bwd', 32): {'sa': [52, 212, 212, 212, 36], 'at': [0, 3328, 16896, 30464, 44032], 'ring_at': 46336, 'stage_floats': 3200, 'stages': 3, 'step': [16, 16, 16], 'smem': 223904},
    ('humanoid_cost', 'fwd', 64): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 816], 'smem': 198816},
    ('humanoid_cost', 'fwd', 16): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 816], 'smem': 148128},
    ('humanoid_cost', 'bwd', 16): {'sa': [36, 132, 132, 20], 'at': [0, 1152, 5376, 9600], 'ring_at': 10240, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 172192},
    ('humanoid_cost', 'bwd', 32): {'sa': [36, 132, 132, 20], 'at': [0, 2304, 10752, 19200], 'ring_at': 20480, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 213152},
    ('member', 'fwd', 64): {'sa': 260, 'stage_floats': 8192, 'stages': 3, 'step': [32, 32, 32, 280], 'smem': 231584},
    ('member', 'fwd', 16): {'sa': 260, 'stage_floats': 16384, 'stages': 3, 'step': [64, 64, 64, 560], 'smem': 230048},
    ('member', 'bwd', 16): {'sa': [52, 260, 260, 260, 36], 'at': [0, 1664, 9984, 18304, 26624], 'ring_at': 27776, 'stage_floats': 8192, 'stages': 3, 'step': [32, 32, 32], 'smem': 209568},
    ('member', 'bwd', 32): None,
    ('widest', 'fwd', 64): None,
    ('widest', 'fwd', 16): {'sa': 516, 'stage_floats': 8192, 'stages': 4, 'step': [16, 16, 480], 'smem': 197280},
    ('widest', 'bwd', 16): {'sa': [36, 516, 516, 36], 'at': [0, 1152, 17664, 34176], 'ring_at': 35328, 'stage_floats': 4096, 'stages': 4, 'step': [8, 8], 'smem': 207008},
    ('widest', 'bwd', 32): None,
    ('odd', 'fwd', 64): {'sa': 52, 'stage_floats': 2816, 'stages': 4, 'step': [64, 160], 'smem': 71840},
    ('odd', 'fwd', 16): {'sa': 52, 'stage_floats': 2816, 'stages': 4, 'step': [64, 160], 'smem': 51872},
    ('odd', 'bwd', 16): {'sa': [36, 52, 36], 'at': [0, 1152, 2816], 'ring_at': 3968, 'stage_floats': 2816, 'stages': 4, 'step': [64], 'smem': 61088},
    ('odd', 'bwd', 32): {'sa': [36, 52, 36], 'at': [0, 2304, 5632], 'ring_at': 7936, 'stage_floats': 2816, 'stages': 4, 'step': [64], 'smem': 76960},
    ('gan9', 'fwd', 64): {'sa': 204, 'stage_floats': 6400, 'stages': 4, 'step': [32, 32, 32, 2128], 'smem': 207008},
    ('gan9', 'fwd', 16): {'sa': 204, 'stage_floats': 12800, 'stages': 4, 'step': [64, 64, 64, 4264], 'smem': 231072},
    ('gan9', 'bwd', 16): {'sa': [20, 212, 212, 212, 20], 'at': [0, 640, 7424, 14208, 20992], 'ring_at': 21632, 'stage_floats': 9600, 'stages': 3, 'step': [48, 48, 48], 'smem': 201888},
    ('gan9', 'bwd', 32): {'sa': [20, 212, 212, 212, 20], 'at': [0, 1280, 14848, 28416, 41984], 'ring_at': 43264, 'stage_floats': 4800, 'stages': 3, 'step': [24, 24, 24], 'smem': 230816},
    ('gan9_cost', 'fwd', 64): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 816], 'smem': 198816},
    ('gan9_cost', 'fwd', 16): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 816], 'smem': 148128},
    ('gan9_cost', 'bwd', 16): {'sa': [20, 132, 132, 20], 'at': [0, 640, 4864, 9088], 'ring_at': 9728, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 170144},
    ('gan9_cost', 'bwd', 32): {'sa': [20, 132, 132, 20], 'at': [0, 1280, 9728, 18176], 'ring_at': 19456, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 209056},
    ('lstm_head', 'fwd', 64): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 480], 'smem': 198816},
    ('lstm_head', 'fwd', 16): {'sa': 132, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64, 480], 'smem': 148128},
    ('lstm_head', 'bwd', 16): {'sa': [68, 132, 132, 36], 'at': [0, 2176, 6400, 10624], 'ring_at': 11776, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 178336},
    ('lstm_head', 'bwd', 32): {'sa': [68, 132, 132, 36], 'at': [0, 4352, 12800, 21248], 'ring_at': 23552, 'stage_floats': 8192, 'stages': 4, 'step': [64, 64], 'smem': 225440},
    ('dynamics', 'step', 64): {'sa': 204, 'stage_floats': 6400, 'stages': 4, 'step': [32, 32, 32, 376], 'smem': 212896},
    ('dynamics', 'step', 16): {'sa': 204, 'stage_floats': 12800, 'stages': 3, 'step': [64, 64, 64, 752], 'smem': 181344},
    ('gan4', 'step', 64): {'sa': 260, 'stage_floats': 4096, 'stages': 4, 'step': [16, 16, 16, 240], 'smem': 204704},
    ('gan4', 'step', 16): {'sa': 260, 'stage_floats': 16384, 'stages': 3, 'step': [64, 64, 64, 960], 'smem': 231520},
    ('humanoid', 'step', 64): {'sa': 204, 'stage_floats': 6400, 'stages': 4, 'step': [32, 32, 32, 216], 'smem': 217504},
    ('humanoid', 'step', 16): {'sa': 204, 'stage_floats': 12800, 'stages': 3, 'step': [64, 64, 64, 440], 'smem': 182496},
    ('gan9', 'step', 64): {'sa': 204, 'stage_floats': 6400, 'stages': 4, 'step': [32, 32, 32, 2128], 'smem': 208032},
    ('gan9', 'step', 16): {'sa': 204, 'stage_floats': 12800, 'stages': 4, 'step': [64, 64, 64, 4264], 'smem': 231328},
}


@pytest.mark.parametrize("key", list(PLANS), ids=["-".join(map(str, k)) for k in PLANS])
def test_committed_stacks_keep_their_plans(key):
    """The mirror gives today's plan, and the route takes the shared-memory
    path with it: the forward and the step at 8192 rows on the 64-row tile
    where it takes the stack, else (and at 512 rows) on the 16-row tile;
    the backward at 128 rows on 16-row tiles, at 8192 on 32-row tiles
    where they fit."""
    name, kind, tile_rows = key
    dims = COMMITTED[name]
    if kind == "bwd":
        assert bwd_tile_plan(dims, tile_rows) == PLANS[key]
        big = PLANS[(name, "bwd", 32)] is not None
        for rows, want in ((128, 16), (8192, 32 if big else 16)):
            path, got_rows, plan, scratch = bwd_route(rows, dims, SMS)
            assert (path, got_rows, plan, scratch) == ("tile", want, PLANS[(name, kind, want)], 0)
        return
    extra = STEP_EXTRA[name] if kind == "step" else 0
    assert tile_plan(dims, tile_rows, tile_rows * extra) == PLANS[key]
    big = PLANS[(name, kind, 64)] is not None
    for rows, want in ((512, 16), (8192, 64 if big else 16)):
        path, got_rows, plan, work = fwd_route(rows, dims, SMS, extra)
        assert (path, got_rows, plan, work) == ("tile", want, PLANS[(name, kind, want)], 0)


def test_depth_and_width_are_not_capped():
    """No constant refuses a stack: 64 and 100 layers, a 16384-wide layer,
    20000- and 24576-wide ones (which stream), a 1-wide one, all get plans
    on the wide path."""
    for dims in ([23] + [64] * 63 + [17], [23] + [32] * 99 + [17], [23, 16384, 17],
                 [23, 20000, 17], [23, 24576, 17], [1, 1, 1], [5000, 3]):
        for rows in (1, 8192):
            assert fwd_route(rows, dims, SMS)[0] in ("tile", "wide")
            assert fwd_route(rows, dims, SMS, dims[0])[2] is not None
            assert bwd_route(rows, dims, SMS)[2] is not None
    assert fwd_route(8192, [23] + [64] * 63 + [17], SMS)[0] == "wide"
    assert fwd_route(1, [23, 24576, 17], SMS)[2]["streamed"]
    assert bwd_route(128, [23, 16384, 17], SMS)[0] == "wide"
    assert not hasattr(fm, "MAX_WIDTH") and not hasattr(fm, "MAX_LAYERS")


def test_mirror_constants_match_the_cuda_sources():
    const = lambda src, name: int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))
    tile = (CSRC / "mlp_tile.cuh").read_text()
    bwd = (CSRC / "fused_mlp_bwd.cu").read_text()
    mma = (CSRC / "mlp_tile_mma.cuh").read_text()
    assert const(tile, "kInlineLayers") == fm.INLINE_LAYERS
    assert "kMaxLayers" not in tile and "kMaxWidth" not in tile
    assert "kSlotSlack" not in bwd  # the wide backward's planes are a chunk's, read in bounds
    assert const(bwd, "kChunkRows") == fm.BWD_CHUNK_ROWS
    assert "constexpr int kChainCols = kConsumerWarps * 8 * kWarpTiles;" in bwd
    # LayerDesc (the backward's table): two pointers and six ints, 40 bytes
    desc = re.search(r"struct LayerDesc \{(.*?)\};", tile, re.S).group(1)
    assert len(re.findall(r"const float\* \w+;", desc)) == 2
    assert sum(len(re.findall(r"\w+", m)) for m in re.findall(r"int ([\w, ]+);", desc)) == 6
    assert 8 * 2 + 4 * 6 == fm.LAYER_DESC_BYTES
    # WideLayer (the forward kernels' table): two pointers and four ints, 32 bytes
    desc = re.search(r"struct WideLayer \{(.*?)\};", mma, re.S).group(1)
    assert len(re.findall(r"const float\* \w+;", desc)) == 2
    assert sum(len(re.findall(r"\w+", m)) for m in re.findall(r"int ([\w, ]+);", desc)) == 4
    assert 8 * 2 + 4 * 4 == fm.WIDE_LAYER_BYTES
    assert const(mma, "kSegmentRows") == fm.SEGMENT_ROWS
    assert const(mma, "kPortableCluster") == fm.PORTABLE_CLUSTER
    assert const(mma, "kMaxCluster") == fm.MAX_CLUSTER
    assert const(mma, "kWideProducers") == fm.WIDE_PRODUCERS
    assert const(mma, "kBoxCols") == fm.BOX_COLS and const(mma, "kMaxBoxRows") == fm.MAX_BOX_ROWS
    modes = re.search(r"constexpr int kRowsWhole = (\d), kRowsBoxes = (\d), kRowsEach = (\d);",
                      mma).groups()
    assert tuple(map(int, modes)) == (fm.ROWS_WHOLE, fm.ROWS_BOXES, fm.ROWS_EACH)
    assert "return ((pw + 3 + 23) & ~31) + 8;" in mma  # wide_row_floats, rows at their phase
    # the forward's table: kTableLayers layers in the launch's parameters, the
    # further ones' WideLayers padded to 128 and their maps at the workspace's
    # head, padded to 256, then a streamed plan's buffers (four bytes a float)
    assert const(mma, "kTableLayers") == fm.TABLE_LAYERS
    assert "const int far = max(0, n - kTableLayers);" in mma
    assert "((size_t)far * sizeof(WideLayer) + 127) & ~(size_t)127" in mma
    assert "(far_head + (size_t)far * sizeof(CUtensorMap) + 255) & ~(size_t)255" in mma
    assert "(size_t)clusters * 2 * tile_rows * plan.sb * sizeof(float)" in mma
    assert "p->sb = streamed ? (hidden + 3) & ~3 : slice > 0 ? slice + 4 : 0;" in mma
    assert "resident_copy" not in mma + tile and "WIDE_CLOCKS" not in mma
    # every kernel asks for its workspace with -2: the backward's walk, the
    # forward's and the step's streamed plans and deep tables
    assert fm.NEED_WORKSPACE == -2 and "constexpr int kNeedWorkspace = -2;" in mma
    for name in ("fused_mlp_fwd.cu", "fused_ls_step.cu", "fused_mlp_bwd.cu"):
        src = (CSRC / name).read_text()
        assert "n_layers <= kInlineLayers" in src
        assert ("return -2;" in src) == (name == "fused_mlp_bwd.cu")
        assert ("launch_clusters(kernel, TM, plan, clusters, stream" in src) == \
            (name != "fused_mlp_bwd.cu")
        if name != "fused_mlp_bwd.cu":  # the table travels as a __grid_constant__ parameter
            assert "const __grid_constant__ WideTable table" in src
            assert "most == kMaxCluster, &plan, &clusters" in src  # streamed on the 16-row tile
    assert "return -2;" in re.search(r"int launch_wide\(.*?\n\}", bwd, re.S).group(0)
    # pass_cols: the warps' columns on the 16-row tile's 16 column groups, the 64-row tile's 8
    assert "8 * kWarpTiles * kConsumerWarps / (tile_rows == 64 ? 2 : 1)" in mma



def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.standard_normal(b)).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


def _clear_of_kinks(rng, rows, layers, margin=1e-4):
    """(rows, fin) inputs whose hidden pre-activations all sit ``margin`` or
    more from the relu kink (each row redrawn until it does)."""
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


WIDE_STACKS = {"1024": [23, 1024, 1024, 17], "12 layers": [23] + [96] * 11 + [17]}


@pytest.mark.parametrize("name", list(WIDE_STACKS))
def test_mlp_apply_and_fused_vjp_match_jax(name, monkeypatch):
    """64 rows clear of relu kinks. The value of ``mlp_apply`` (the plain
    forward on the CPU) against JAX's ``fused_mlp``: atol 1e-5 max(1,
    max|ref|). ``FusedMlpFunction`` with its two kernels replaced, each
    counted, by the plain forward and by the backward kernel's arithmetic
    model at the tile height the wide path takes: dx and every dW, db
    against ``jax.vjp`` of ``fused_mlp`` within 1e-4 max(1, max|ref|), the
    bound ``chip_smoke.py`` holds the kernel to (each product drops its lo
    x lo term, dW sums 64 rows, in one product over the wide path's chunk:
    ``bwd_model_args``)."""
    widths = WIDE_STACKS[name]
    layers = _layers(widths, 31)
    rng = np.random.default_rng(32)
    x = _clear_of_kinks(rng, 64, layers)
    g = rng.standard_normal((64, widths[-1])).astype(np.float32)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    y_ref, vjp = jax.vjp(jfm.fused_mlp, jnp.asarray(x), jl)
    dx_ref, grads_ref = vjp(jnp.asarray(g))
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    y = mlp_apply(torch.from_numpy(x), tl)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(y_ref).max())))

    route = bwd_route(64, widths, SMS)
    assert route[0] == "wide"
    calls = {"forward": 0, "backward": 0}

    def forward(x, layers):
        calls["forward"] += 1
        return reference_forward(x, layers)

    def backward(x, layers, g):
        calls["backward"] += 1
        return reference_backward_3xtf32(x, layers, g, **bwd_model_args(64, widths, SMS))

    monkeypatch.setattr(fm, "fused_mlp_forward", forward)
    monkeypatch.setattr(fm, "fused_mlp_backward", backward)
    xt = torch.from_numpy(x).requires_grad_(True)
    flat = [t.clone().requires_grad_(True) for wb in tl for t in wb]
    FusedMlpFunction.apply(xt, *flat).backward(torch.from_numpy(g))
    assert calls == {"forward": 1, "backward": 1}
    refs = [dx_ref] + [t for pair in grads_ref for t in pair]
    for got, ref in zip([xt.grad] + [p.grad for p in flat], refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_fused_ls_step_with_a_512x4_stack_matches_jax():
    """8 lanes x 4 step sizes, n = 17, m = 6, gs = 12, squared action goal,
    dynamics 23->512^4->17: the port's step (the plain version on the CPU)
    against JAX's ``fused_ls_step``, atol 1e-5 max(1, max|ref|) per output
    (float32 sums over 512 terms in another order)."""
    n, m, gs, B, A = 17, 6, 12, 8, 4
    rng = np.random.default_rng(33)
    f = lambda shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    inputs = dict(x3=f((B, A, n)), Xref=f((B, n)), Uref=f((B, m), 0.3),
                  alphaBA=np.abs(f((B, A))), k=f((B, m), 0.2), K=f((B, m, n), 0.2),
                  goal=f((B, gs)), goal_u=f((B, m), 0.3))
    layers = _layers([n + m, 512, 512, 512, 512, n], 34)
    raw = np.linspace(-0.5, 0.8, 5).astype(np.float32)
    cost = MPCCost(CostFeatureNet(n, hidden=(8,), features_out=3), horizon=5,
                   mpc_weights=tuple(raw), action_goal_scale=7.0, action_goal_squared=True)
    wvec, ag_scale = cost.stage_weights()
    with torch.no_grad():
        got = fused_ls_step(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                            wvec=wvec, gs=gs, action_goal_squared=True, ag_scale=ag_scale,
                            layers=split_w0([(torch.from_numpy(w), torch.from_numpy(b))
                                             for w, b in layers], n))
    w = jax.nn.sigmoid(jnp.asarray(raw))
    jw = jnp.stack([w[0], w[1], w[3], jnp.asarray(raw[4])]).reshape(1, 4)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref = jfl.fused_ls_step(j["x3"], j["Xref"], j["Uref"], j["alphaBA"], j["k"], j["K"],
                            j["goal"], j["goal_u"], jw,
                            tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in layers),
                            gs=gs, action_goal_squared=True, ag_scale=7.0)
    for out, g, r in zip(("nx", "u", "cost"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(r).max())), err_msg=out)


def test_plan_batch_with_512x4_dynamics_matches_jax():
    """configs/gan_cheetah.yaml with dynamics hidden [512] * 4 and iLQR cut
    to 3 trips, 4 envs of random histories: the port's ``plan_batch`` (the
    JAX policy's weights carried across) against the JAX policy's, on the
    lanes whose JAX plan is stable (moves < 1e-4 under 1 +- 1e-7 scalings
    of the histories), at least 2 of them: U, X and obj atol 1e-4."""
    over = dict(mpc__model__dynamics__mlp__hidden=[512] * 4, mpc__solver__max_iterations=3)
    jpolicy, jparams = jcommon.build_policy(JaxConfig.from_yaml(CONFIG).replace(**over), 17, 6)
    tree = jax.device_get(jparams)
    policy = from_jax_params(
        tree, common.build_policy(Config.from_yaml(CONFIG).replace(**over), 17, 6,
                                  device="cpu"))
    rng = np.random.default_rng(35)
    hX = (0.3 * rng.standard_normal((4, 2, 17))).astype(np.float32)
    hU = (0.3 * rng.standard_normal((4, 1, 6))).astype(np.float32)
    plan = jax.jit(jpolicy.plan_batch)
    ref = plan(jparams, jnp.asarray(hX), jnp.asarray(hU))
    spread = np.max([np.abs(np.asarray(plan(jparams, jnp.asarray(hX * np.float32(s)),
                                            jnp.asarray(hU)).U) - np.asarray(ref.U)).max((1, 2))
                     for s in (1 + 1e-7, 1 - 1e-7)], 0)
    lanes = np.nonzero(spread < 1e-4)[0]
    assert len(lanes) >= 2, f"only lanes {lanes} are stable: spread {spread}"
    with torch.no_grad():
        got = policy.plan_batch(torch.from_numpy(hX), torch.from_numpy(hU))
    for name in ("U", "X", "obj"):
        np.testing.assert_allclose(getattr(got, name).numpy()[lanes],
                                   np.asarray(getattr(ref, name))[lanes], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_dynamics_update_on_256x6_matches_jax():
    """One optimizer step of the dynamics trainer (configs/gan_cheetah.yaml's
    lr 1e-5 and discount 0.9, teacher forcing on) at 23->256^6->17, 16
    windows, an 8-window minibatch: the port's ``update_pass`` against
    JAX's ``_update_scan`` on the same weights and rows. Loss rtol 1e-5;
    parameters atol 2 lr (Adam's first step is about lr * sign(g), which
    flips where |g| is near 0)."""
    widths, lr, gamma = [23] + [256] * 6 + [17], 1e-5, 0.9
    rng = np.random.default_rng(36)
    tree = {"params": {f"Dense_{i}": {"kernel": w, "bias": b}
                       for i, (w, b) in enumerate(_layers(widths, 37))}}
    jmodel = JaxLearnedDynamics(JaxResidualNet(17, hidden=tuple(widths[1:-1])))
    tmodel = dynamics_from_jax_params(
        tree, LearnedDynamics(ResidualMLPDynamicsNet(17, 6, hidden=tuple(widths[1:-1]))))
    X = rng.standard_normal((16, 5, 17)).astype(np.float32)
    U = rng.uniform(-1, 1, (16, 5, 6)).astype(np.float32)
    Y = (0.9 * X + 0.1 * rng.standard_normal(X.shape)).astype(np.float32)
    rows = rng.integers(0, 16, (1, 8))
    params = {"dynamics_params": jax.tree_util.tree_map(jnp.asarray, tree)}
    opt, opt_state = jax_masked_adam(params, no_grads=(), learning_rate=lr)
    params, _, loss_ref = jdyn._update_scan(jmodel, opt, params, opt_state, jnp.asarray(rows),
                                            tuple(jnp.asarray(d) for d in (X, U, Y)), gamma,
                                            jnp.asarray(True))
    topt = masked_adam({"dynamics_params": list(tmodel.parameters())}, (), lr)
    loss = tdyn.update_pass(tmodel, topt, tuple(torch.from_numpy(d) for d in (X, U, Y)),
                            torch.from_numpy(rows), gamma, True)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    got = [(d.kernel.detach().numpy(), d.bias.detach().numpy()) for d in tmodel.net.layers]
    p = params["dynamics_params"]["params"]
    for i, (gw, gb) in enumerate(got):
        np.testing.assert_allclose(gw, np.asarray(p[f"Dense_{i}"]["kernel"]), rtol=0, atol=2 * lr)
        np.testing.assert_allclose(gb, np.asarray(p[f"Dense_{i}"]["bias"]), rtol=0, atol=2 * lr)
