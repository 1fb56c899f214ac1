"""The forward kernels' tensor-core arithmetic and shared-memory layout,
as far as a CPU can hold them.

``csrc/mlp_tile_mma.cuh`` multiplies with every float32 operand split into
two TF32 parts (``hi = tf32(v)``, ``lo = tf32(v - hi)``) and three products
per term. ``tf32_round`` and ``reference_forward_3xtf32`` are that
arithmetic in plain torch; here they are held against the float32
reference of both packages on seeded numpy inputs. Tolerance of the
three-pass forward: 1e-5 * max(1, max|ref|). Each product drops only its
``lo * lo`` term, 2^-22 of it, and a layer sums at most 256 of them, so a
layer adds about 256 * 2^-22 = 6e-5 of a term's size at worst and 1e-6 in
practice, over 3 or 4 layers; float32 summation order adds as much. A
single TF32 pass, which keeps 11 bits of each operand, must exceed that
bound on the same inputs, or the test could not tell a kernel model that
lost its compensation.

The rest mirrors what the kernel does with widths that are no multiple of
8, with the weight ring and with the line-search step's split W0
(``tile_plan``, ``weight_chunks``, ``column_runs``), and holds the mirror's
constants against the CUDA source.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.ops import fused_mlp as fm
from gan_mpc_tpu_torch.ops.fused_mlp import (
    column_runs,
    reference_forward,
    reference_forward_3xtf32,
    tf32_round,
    tile_plan,
    weight_chunks,
)

jfm = importlib.import_module("gan_mpc_tpu.ops.fused_mlp")

torch.set_num_threads(1)
pin_fp32()

STACKS = {
    "dynamics": [23, 200, 200, 200, 17],
    "cost": [17, 128, 128, 10],
    "wide": [23, 256, 256, 256, 17],
    "humanoid": [41, 200, 200, 200, 29],
    "odd": [23, 41, 17],
}
CUH = Path(fm.__file__).resolve().parent.parent / "csrc" / "mlp_tile_mma.cuh"


def _magnitudes(seed, n=4096):
    """Normal float32 values of both signs over 60 binades."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)).astype(np.float32)


def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.standard_normal(b)).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


def test_tf32_round_keeps_ten_mantissa_bits():
    v = torch.from_numpy(_magnitudes(0))
    bits = tf32_round(v).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert torch.equal(tf32_round(torch.zeros(3)), torch.zeros(3))


def test_tf32_round_is_idempotent():
    hi = tf32_round(torch.from_numpy(_magnitudes(1)))
    assert torch.equal(tf32_round(hi), hi)


def test_tf32_round_rounds_to_nearest():
    v = torch.from_numpy(_magnitudes(2)).double()
    hi = tf32_round(v.float()).double()
    ulp = 2.0 ** (torch.floor(torch.log2(v.abs())) - 10)  # TF32 spacing at v
    assert bool(((v - hi).abs() <= ulp / 2).all())
    # a tie goes away from zero: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tf32_round(tie), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


def test_two_tf32_parts_leave_less_than_2_pow_minus_21():
    v = torch.from_numpy(_magnitudes(3))
    hi = tf32_round(v)
    lo = tf32_round(v - hi)
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert bool((rest < 2.0 ** -21 * v.double().abs()).all())
    assert bool(((v - hi).abs().double() <= 2.0 ** -11 * v.double().abs()).all())


@pytest.mark.parametrize("name", ["dynamics", "cost", "wide", "humanoid"])
def test_three_pass_forward_matches_float32_references(name):
    widths = STACKS[name]
    layers = _layers(widths, 4)
    x = np.random.default_rng(5).standard_normal((300, widths[0])).astype(np.float32)
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    got = reference_forward_3xtf32(torch.from_numpy(x), tl).numpy()
    ref_torch = reference_forward(torch.from_numpy(x), tl).numpy()
    ref_jax = np.asarray(jfm._reference_forward(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)))
    for ref in (ref_torch, ref_jax):
        bound = 1e-5 * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got - ref).max()) <= bound


@pytest.mark.parametrize("name", ["dynamics", "cost", "wide", "humanoid"])
def test_single_tf32_pass_exceeds_the_bound(name):
    widths = STACKS[name]
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in _layers(widths, 4)]
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((300, widths[0])).astype(np.float32))
    ref = reference_forward(x, tl)
    one = reference_forward_3xtf32(x, tl, passes=1)
    assert (one - ref).abs().max().item() > 1e-5 * max(1.0, ref.abs().max().item())


def test_mirror_constants_match_the_cuda_source():
    src = CUH.read_text()
    const = lambda name: int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))
    assert const("kConsumerWarps") == fm.CONSUMER_WARPS
    assert const("kWarpTiles") == fm.WARP_TILES
    assert (const("kMaxStages"), const("kMinStages")) == (fm.MAX_STAGES, fm.MIN_STAGES)
    assert const("kMaxSmem") == fm.MAX_SMEM
    assert const("kBarrierBytes") == fm.BARRIER_BYTES
    # one pass of the warps' columns: the 16-row tile's 16 column groups, the
    # 64-row tile's 8 (fused_mlp_fwd.cu and fused_ls_step.cu plan_wide calls)
    assert fm.pass_cols(16) == 16 * 8 * fm.WARP_TILES
    assert fm.pass_cols(64) == 8 * 8 * fm.WARP_TILES


@pytest.mark.parametrize("width,padded", [(17, 24), (23, 24), (10, 16), (29, 32), (41, 48)])
def test_odd_widths_are_padded_to_whole_tiles(width, padded):
    """A layer's column runs cover [0, padded) exactly once, and the
    activation stride holds the padded width."""
    for groups in (8, 16):
        runs = column_runs(width, groups)
        covered = [c for base, tiles in runs for c in range(base, base + 8 * tiles)]
        assert covered == list(range(padded))
        assert all(tiles <= fm.WARP_TILES for _, tiles in runs)
    plan = tile_plan([width, 64, width], 16)
    assert plan["sa"] >= padded and plan["sa"] % 8 == 4  # 2 * sa = 8 (mod 16): no bank conflict


@pytest.mark.parametrize("name,tile_rows", [
    ("dynamics", 64), ("dynamics", 16), ("cost", 64), ("cost", 16), ("wide", 64),
    ("wide", 16), ("humanoid", 64), ("humanoid", 16), ("odd", 64), ("odd", 16)])
def test_ring_fits_and_chunks_start_on_whole_k_steps(name, tile_rows):
    dims = STACKS[name]
    plan = tile_plan(dims, tile_rows, extra_floats=tile_rows * dims[0])
    assert plan["smem"] <= fm.MAX_SMEM and plan["stages"] >= fm.MIN_STAGES
    for (K, N), step, chunks in zip(zip(dims[:-1], dims[1:]), plan["step"],
                                    weight_chunks(dims, plan["step"])):
        assert step % 8 == 0 and step >= 8
        assert _up8(min(step, K)) * N <= plan["stage_floats"]  # with its zero rows
        assert [k0 for k0, _, _ in chunks] == list(range(0, K, step))
        assert sum(n for _, n, _ in chunks) == K
        for k0, n, spans in chunks:
            # a multiple of 4 rows starts 16-byte aligned whatever N is: bulk copy
            assert k0 % 4 == 0 and (k0 * N * 4) % 16 == 0
            assert spans == [(0, k0, n, 0)]


def _up8(n):
    return (n + 7) // 8 * 8


@pytest.mark.parametrize("n,m", [(17, 6), (29, 12)])
def test_split_w0_is_two_spans_of_the_first_chunk(n, m):
    dims = [n + m, 200, 200, 200, n]
    plan = tile_plan(dims, 64, extra_floats=64 * (n + m))
    first = weight_chunks(dims, plan["step"], split=n)[0]
    assert first[0] == (0, min(n + m, plan["step"][0]),
                        [(0, 0, n, 0), (1, 0, min(m, plan["step"][0] - n), n)])
    rows = sorted((t, r) for _, _, spans in first for t, r0, k, _ in spans
                  for r in range(r0, r0 + k))
    assert rows == [(0, r) for r in range(n)] + [(1, r) for r in range(m)]
    # the second span lands 16-byte aligned in the stage: n rows of 200 floats
    assert (n * 200 * 4) % 16 == 0
    later = weight_chunks(dims, plan["step"], split=n)[1:]
    assert all(t == 0 for chunks in later for _, _, spans in chunks for t, *_ in spans)


def test_tiles_the_kernels_refuse():
    """The shared-memory tiles still refuse what they did; the kernels take
    those stacks on the wide path, in passes of the tile's columns."""
    assert tile_plan([23, 512, 512, 17], 64) is None  # wider than the 64-row tile's 256
    assert tile_plan([23, 512, 512, 17], 16) is not None
    assert tile_plan([23, 520, 17], 16) is None
    assert fm.fwd_route(8192, [23, 512, 512, 17], 132)[:2] == ("tile", 16)
    for rows, tile_rows, passes in ((8192, 64, [(0, 256), (256, 256), (512, 8)]),
                                    (512, 16, [(0, 512), (512, 8)])):
        path, got_rows, plan, work = fm.fwd_route(rows, [23, 520, 17], 132)
        assert (path, got_rows) == ("wide", tile_rows) and work > 0
        assert fm.column_passes(520, plan["pass_cols"]) == passes
