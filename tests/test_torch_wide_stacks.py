"""Stacks of any depth and width, as far as a CPU can hold them.

On the card every stack runs through the hand-written kernels: the
committed ones (at most ``INLINE_LAYERS`` layers, each layer one pass of
the warps' columns, activations in shared memory) on the path they took
before, any other on the kernels' wide path (layers in passes of 512 or
256 columns, activations in a device workspace where shared memory does
not hold them, the layers read from a table in device memory). Here:

  1. the Python mirrors of the kernels' planners give a plan for every
     stack of ``chip_smoke.py``'s phase 19 (a), at every row count it
     uses, and each plan keeps what the kernels rely on (shared memory
     within a block's, whole k-steps a chunk, passes that cover the
     columns once, aligned slots);
  2. every committed stack keeps today's plan on the shared-memory path
     (forward at 64 and 16 rows, the step, the backward at 16 and 32),
     pinned as literals, and the routes still pick that path;
  3. the mirrors' constants against the CUDA sources;
  4. the port's plain path against the JAX package at wide and deep
     stacks, inputs from a numpy seed, weights carried across by
     ``params.from_jax_params`` / ``dynamics_from_jax_params``:
     ``mlp_apply``'s value and ``FusedMlpFunction``'s VJP (its kernels
     replaced by the plain forward and by the backward kernel's arithmetic
     model, ``reference_backward_3xtf32`` at the wide path's tile height)
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
    keeps the kernels' rules: shared memory within a block's, at least
    MIN_STAGES ring stages, chunks of whole k-steps of 8 that fit a stage
    at the layer's row stride, passes that cover each layer once and deal
    at most WARP_TILES tiles to a warp, 16-byte aligned slots."""
    if kind == "bwd":
        path, tile_rows, plan, scratch = bwd_route(rows, dims, SMS)
        cols = fm.CHAIN_COLS
        assert plan["sa"] == [_up(d, 16) + 4 for d in dims]
        assert plan["at"] == [2 * tile_rows * sum(plan["sa"][:l]) for l in range(len(dims))]
        assert plan["plane_floats"] == 2 * tile_rows * sum(plan["sa"])
        assert plan["offset"][0] == 0 and all(
            b - a == k * n + n for a, b, k, n in zip(plan["offset"], plan["offset"][1:],
                                                    dims, dims[1:]))
        fixed = fm.BARRIER_BYTES + 4 * (plan["plane_floats"] * plan["planes_smem"] + 8)
        assert plan["slot_floats"] == (0 if plan["planes_smem"]
                                       else plan["plane_floats"] + fm.SLOT_SLACK)
        recompute = dims[1:-1]
        assert len(plan["step"]) == len(recompute)
        chained = dims[:-1]  # the chain's result columns: every layer's input
    else:
        path, tile_rows, plan, work = fwd_route(rows, dims, SMS, extra)
        cols = pass_cols(tile_rows)
        assert plan["pass_cols"] == cols
        assert plan["sa"] == _up(max(dims), 8) + 4 and plan["sa"] % 8 == 4
        planes = 4 * tile_rows * plan["sa"]
        fixed = fm.BARRIER_BYTES + 4 * (planes * plan["planes_smem"]
                                        + plan["extra_floats"] * plan["extra_smem"] + 8)
        assert plan["extra_floats"] == _up(tile_rows * extra, 4)
        recompute = dims[1:]
        assert len(plan["step"]) == len(recompute)
        chained = []
        blocks = min(-(-rows // tile_rows), SMS)
        assert work == fm.table_bytes(len(dims) - 1) + blocks * 4 * plan["slot_floats"]
    assert path == "wide"
    assert tile_rows == ((64 if kind != "bwd" else 32) if rows > 2 * SMS * 16 else 16)
    assert plan["slot_floats"] % 4 == 0  # every slot starts 16-byte aligned
    assert plan["smem"] == fixed + plan["stages"] * 4 * plan["stage_floats"] <= fm.MAX_SMEM
    assert fm.MIN_STAGES <= plan["stages"] <= fm.MAX_STAGES
    assert plan["stage_floats"] % 4 == 0 and plan["stage_floats"] <= 64 * cols
    for n, step in zip(recompute, plan["step"]):
        # a chunk holds whole rows of a layer of at most `cols` columns, or
        # column slabs `cols` floats a row of a wider one, with its zero rows
        assert step % 8 == 0 and step >= 8 and step * min(n, cols) <= plan["stage_floats"]
    groups = fm.CONSUMER_WARPS // {64: 2, 32: 1, 16: 1}[tile_rows]
    for n in list(recompute) + chained:
        passes = column_passes(n, cols)
        assert [c for c0, w in passes for c in range(c0, c0 + w)] == list(range(n))
        assert all(c0 % 8 == 0 and w <= cols for c0, w in passes)
        for _, w in passes:
            assert all(t <= fm.WARP_TILES for _, t in column_runs(w, groups))


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
    a 1-wide one, all get plans on the wide path."""
    for dims in ([23] + [64] * 63 + [17], [23] + [32] * 99 + [17], [23, 16384, 17],
                 [1, 1, 1], [5000, 3]):
        for rows in (1, 8192):
            assert fwd_route(rows, dims, SMS)[0] in ("tile", "wide")
            assert fwd_route(rows, dims, SMS, dims[0])[2] is not None
            assert bwd_route(rows, dims, SMS)[2] is not None
    assert fwd_route(8192, [23] + [64] * 63 + [17], SMS)[0] == "wide"
    assert bwd_route(128, [23, 16384, 17], SMS)[0] == "wide"
    assert not hasattr(fm, "MAX_WIDTH") and not hasattr(fm, "MAX_LAYERS")


def test_mirror_constants_match_the_cuda_sources():
    const = lambda src, name: int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))
    tile = (CSRC / "mlp_tile.cuh").read_text()
    bwd = (CSRC / "fused_mlp_bwd.cu").read_text()
    assert const(tile, "kInlineLayers") == fm.INLINE_LAYERS
    assert "kMaxLayers" not in tile and "kMaxWidth" not in tile
    assert const(bwd, "kSlotSlack") == fm.SLOT_SLACK
    assert const(bwd, "kMaxShares") == fm.MAX_SHARES
    assert "constexpr int kChainCols = kConsumerWarps * 8 * kWarpTiles;" in bwd
    # LayerDesc: two pointers and six ints, 40 bytes
    desc = re.search(r"struct LayerDesc \{(.*?)\};", tile, re.S).group(1)
    assert len(re.findall(r"const float\* \w+;", desc)) == 2
    assert sum(len(re.findall(r"\w+", m)) for m in re.findall(r"int ([\w, ]+);", desc)) == 6
    assert 8 * 2 + 4 * 6 == fm.LAYER_DESC_BYTES
    mma = (CSRC / "mlp_tile_mma.cuh").read_text()
    helper = re.search(r"inline int wide_workspace\(.*?\n\}", mma, re.S).group(0)
    assert "return -2;" in helper and fm.NEED_WORKSPACE == -2
    for name in ("fused_mlp_fwd.cu", "fused_ls_step.cu", "fused_mlp_bwd.cu"):
        src = (CSRC / name).read_text()
        assert "wide_workspace(" in src and "n_layers <= kInlineLayers" in src
    for name in ("fused_mlp_fwd.cu", "fused_ls_step.cu"):
        assert "8 * kWarpTiles * kConsumerWarps / WM" in (CSRC / name).read_text()  # pass_cols


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
    x lo term, dW sums 64 rows)."""
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
        return reference_backward_3xtf32(x, layers, g, route[1])

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
