"""The backward kernel's arithmetic and shared-memory layout as far as a
CPU can hold them, the port's msgpack reader, and the bench window.

``csrc/fused_mlp_bwd.cu`` takes its three products (recompute, dx chain,
dW) on the tensor cores with every float32 operand split into two TF32
parts and three products per term, and sums dW per tile of 16 (or 32)
rows and then over the tiles. ``reference_backward_3xtf32`` is that
arithmetic in plain torch; here it is held against the float32 plain
version ``reference_backward`` and against ``jax.vjp`` of the JAX
package's ``_reference_forward``, on seeded numpy inputs whose hidden
pre-activations all sit 1e-4 or more from a relu kink (at a kink two
forwards that round differently disagree on the mask, and the gradient
moves by a whole term). Tolerance: 1e-4 * max(1, max|ref|) per output,
the bound ``chip_smoke.py`` holds the kernel to: each product drops its
lo x lo term, 2^-22 of it, dW sums up to 300 rows of products of size up
to ~30, and float32 sums run in another order.

``bwd_tile_plan`` and ``bwd_tile_rows`` mirror how the kernel lays a stack
out in shared memory and which tile height it picks; the mirror is held
to the bank and alignment rules the kernel's loads rely on and to the
constants of the CUDA source.

``params.load_msgpack`` is held against ``flax.serialization`` on every
committed ``params.msgpack``.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gan_mpc_tpu.models.dynamics import LearnedDynamics as JaxLearnedDynamics
from gan_mpc_tpu.models.dynamics import ResidualMLPDynamicsNet as JaxResidualNet
from gan_mpc_tpu_torch import bench, pin_fp32
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.ops import fused_mlp as fm
from gan_mpc_tpu_torch.ops.fused_mlp import (
    bwd_tile_plan,
    bwd_tile_rows,
    reference_backward,
    reference_backward_3xtf32,
)
from gan_mpc_tpu_torch.params import dynamics_from_jax_params, load_msgpack

jfm = importlib.import_module("gan_mpc_tpu.ops.fused_mlp")

torch.set_num_threads(1)
pin_fp32()

REPO = Path(__file__).resolve().parent.parent
STACKS = {
    "dynamics": [23, 200, 200, 200, 17],
    "wide": [23, 256, 256, 256, 17],
    "cost": [17, 128, 128, 10],
    "odd": [23, 41, 17],
    "humanoid": [41, 200, 200, 200, 29],
}
CU = Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_mlp_bwd.cu"
# every checkpoint the repository holds (git ls-files runs | grep msgpack)
CHECKPOINTS = sorted(str(p.relative_to(REPO))
                     for p in (REPO / "runs" / "trained_models").rglob("params.msgpack"))
GAN4 = "runs/trained_models/imitator/cheetah_run/gan/4/params.msgpack"


def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.standard_normal(b)).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


def _clear_of_kinks(rng, rows, layers, margin=1e-4):
    """(rows, fin) float32 inputs, each row redrawn until no hidden
    pre-activation lies within ``margin`` of 0 (in float64)."""
    fin = layers[0][0].shape[0]
    x = rng.standard_normal((rows, fin)).astype(np.float32)
    while True:
        h, near = x.astype(np.float64), np.zeros(rows, bool)
        for w, b in layers[:-1]:
            z = h @ w + b
            near |= (np.abs(z) < margin).any(1)
            h = np.maximum(z, 0.0)
        if not near.any():
            return x
        x[near] = rng.standard_normal((int(near.sum()), fin)).astype(np.float32)


def _flat(out):
    return [np.asarray(out[0])] + [np.asarray(t) for pair in out[1] for t in pair]


def _assert_within(got, ref):
    for i, (g, r) in enumerate(zip(_flat(got), _flat(ref))):
        assert g.shape == r.shape
        bound = 1e-4 * max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g - r).max()) <= bound, f"output {i}"


@pytest.mark.parametrize("rows", [9, 128, 300])
@pytest.mark.parametrize("name", ["dynamics", "wide", "cost", "odd"])
def test_three_pass_backward_matches_float32_backward(name, rows):
    widths = STACKS[name]
    layers = _layers(widths, 21)
    rng = np.random.default_rng(22)
    x = _clear_of_kinks(rng, rows, layers)
    g = rng.standard_normal((rows, widths[-1])).astype(np.float32)
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    got = reference_backward_3xtf32(torch.from_numpy(x), tl, torch.from_numpy(g))
    _assert_within(got, reference_backward(torch.from_numpy(x), tl, torch.from_numpy(g)))


@pytest.mark.parametrize("rows", [9, 128, 300])
@pytest.mark.parametrize("name", ["dynamics", "wide", "cost", "odd"])
def test_three_pass_backward_matches_jax_vjp(name, rows):
    widths = STACKS[name]
    layers = _layers(widths, 23)
    rng = np.random.default_rng(24)
    x = _clear_of_kinks(rng, rows, layers)
    g = rng.standard_normal((rows, widths[-1])).astype(np.float32)
    jl = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    _, vjp = jax.vjp(jfm._reference_forward, jnp.asarray(x), jl)
    dx, grads = vjp(jnp.asarray(g))
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    got = reference_backward_3xtf32(torch.from_numpy(x), tl, torch.from_numpy(g))
    _assert_within(got, (dx, list(grads)))


def test_tile_height_changes_only_the_order_of_the_sums():
    """dW and db per 16- and per 32-row tile agree to float32 rounding;
    dx does not depend on the tiles at all."""
    widths = STACKS["dynamics"]
    layers = _layers(widths, 25)
    rng = np.random.default_rng(26)
    x = torch.from_numpy(_clear_of_kinks(rng, 300, layers))
    g = torch.from_numpy(rng.standard_normal((300, widths[-1])).astype(np.float32))
    tl = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    a, b = reference_backward_3xtf32(x, tl, g, 16), reference_backward_3xtf32(x, tl, g, 32)
    assert torch.equal(a[0], b[0])
    _assert_within(a, b)
    assert any(not np.array_equal(p, q) for p, q in zip(_flat(a)[1:], _flat(b)[1:]))


@pytest.mark.parametrize("tile_rows", [16, 32])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_backward_plan_fits_and_keeps_the_loads_aligned(name, tile_rows):
    dims = STACKS[name]
    plan = bwd_tile_plan(dims, tile_rows)
    if plan is None:  # only the 256-wide stack, twice: the kernel stays on 16-row tiles
        assert (name, tile_rows) == ("wide", 32)
        return
    assert plan["smem"] <= fm.MAX_SMEM and fm.MIN_STAGES <= plan["stages"] <= fm.MAX_STAGES
    assert plan["smem"] == fm.BARRIER_BYTES + 4 * (plan["ring_at"] + 8) \
        + plan["stages"] * 4 * plan["stage_floats"]
    for d, sa, at in zip(dims, plan["sa"], plan["at"]):
        # the chain contracts 16 columns a round: the pad to 16 lies inside the row;
        # 2 * sa = 8 (mod 16): fragment loads of a row pair miss each other's banks
        assert sa >= -(-d // 16) * 16 and sa % 8 == 4
        assert at % 4 == 0  # 16-byte loads of a plane stay aligned
    assert plan["at"] == [2 * tile_rows * sum(plan["sa"][:l]) for l in range(len(dims))]
    assert plan["ring_at"] == 2 * tile_rows * sum(plan["sa"]) and plan["ring_at"] % 4 == 0
    assert plan["stage_floats"] % 4 == 0  # bulk copies land 16-byte aligned
    # the ring carries the recompute's layers: all but the last
    assert len(plan["step"]) == len(dims) - 2
    for n, step in zip(dims[1:-1], plan["step"]):
        assert step % 8 == 0 and step >= 8 and step * n <= plan["stage_floats"]


def test_backward_refuses_what_does_not_fit():
    """The shared-memory plan still refuses what does not fit in a block
    (and layers wider than one pass of the warps' columns); those stacks,
    and any deeper than INLINE_LAYERS, take the wide path: every layer's
    planes in the block's slot of a workspace."""
    assert bwd_tile_plan([23, 512, 512, 17]) is not None
    assert bwd_tile_plan([23] + [200] * 7 + [17]) is not None
    assert bwd_tile_plan([23] + [200] * 8 + [17]) is None  # the planes alone pass the limit
    assert bwd_tile_plan([23] + [256] * 6 + [17]) is None
    assert bwd_tile_plan([23, 512, 512, 512, 17]) is None
    assert bwd_tile_plan([23, 520, 17]) is None  # wider than one pass of the warps' columns
    assert bwd_tile_plan([23] + [8] * 9 + [17]) is not None  # fits, but 10 layers deep
    assert bwd_tile_plan([3, 8]) is not None  # a single layer: no recompute, no ring use
    for dims in ([23] + [200] * 8 + [17], [23] + [256] * 6 + [17], [23, 512, 512, 512, 17],
                 [23, 520, 17], [23] + [8] * 9 + [17]):
        path, tile_rows, plan, scratch = fm.bwd_route(128, dims, 132)
        assert (path, tile_rows) == ("wide", 16)
        # the planes stay in shared memory where they fit beside the ring
        assert plan["planes_smem"] == (dims in ([23, 520, 17], [23] + [8] * 9 + [17]))
        assert scratch >= fm.table_bytes(len(dims)) + 4 * plan["slot_floats"]
    assert fm.bwd_route(128, [23, 512, 512, 17], 132)[:2] == ("tile", 16)


@pytest.mark.parametrize("rows,name,sms,expected", [
    (128, "dynamics", 132, 16), (512, "dynamics", 132, 16), (4224, "dynamics", 132, 16),
    (4225, "dynamics", 132, 32), (8192, "dynamics", 132, 32), (8192, "humanoid", 132, 32),
    (8192, "wide", 132, 16), (8192, "dynamics", 1024, 16), (0, "dynamics", 132, 16)])
def test_backward_tile_height(rows, name, sms, expected):
    assert bwd_tile_rows(rows, STACKS[name], sms) == expected


def test_backward_mirror_constants_match_the_cuda_source():
    src = CU.read_text()
    stage_rows = re.search(r"constexpr int kStageRows\[\] = \{([\d, ]+)\};", src).group(1)
    assert tuple(int(v) for v in stage_rows.split(",")) == fm.BWD_STAGE_ROWS
    assert '#include "mlp_tile_mma.cuh"' in src  # kMaxSmem, kMinStages, ... as the forwards'
    assert "& ~15) + 4" in src  # the planes' row stride: the width padded to 16, plus 4
    assert "rows > 2 * sms * 16 && plan_bwd(mlp, 32, &plan)" in src  # bwd_tile_rows
    assert "plan_bwd(mlp, 16, &plan)" in src
    # the f32 FMA loop and its copies have left the sources
    csrc = "".join(p.read_text() for p in CU.parent.glob("*.cu*"))
    for gone in ("layer_tile(", "chain_tile(", "dw_tile(", "copy_chunk_t", "BY_WIDTH",
                 "copy_chunk<"):
        assert gone not in csrc


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def test_every_committed_checkpoint_is_listed():
    assert len(CHECKPOINTS) == 25 and GAN4 in CHECKPOINTS


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_load_msgpack_matches_flax(path):
    got = dict(_leaves(load_msgpack(REPO / path)))
    ref = dict(_leaves(serialization.msgpack_restore((REPO / path).read_bytes())))
    assert list(got) == list(ref) and len(ref) > 0
    for key, r in ref.items():
        g, r = got[key], np.asarray(r)
        assert isinstance(g, np.ndarray), key
        assert g.shape == r.shape and g.dtype == r.dtype and g.tobytes() == r.tobytes(), key


def test_load_msgpack_refuses_what_it_does_not_read(tmp_path):
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\x81\xa1a\xc1")  # 0xc1 is never used in msgpack
    with pytest.raises(ValueError, match="0xc1"):
        load_msgpack(bad)
    bad.write_bytes(b"\x81\xa1a\x01\x00")  # a byte after the tree
    with pytest.raises(ValueError, match="after the tree"):
        load_msgpack(bad)
    bad.write_bytes(b"\x81\xa1a\xc4\x05ab")  # a bin cut short
    with pytest.raises(ValueError, match="ends inside"):
        load_msgpack(bad)
    with pytest.raises(FileNotFoundError):
        load_msgpack(tmp_path / "missing.msgpack")


def test_loaded_checkpoint_dynamics_match_jax():
    """The gan/4 dynamics (23->256->256->256->17), read without flax, give
    the JAX ``LearnedDynamics``'s ``batch_apply`` on the same inputs
    (atol 1e-5: float32, other summation order)."""
    tree = load_msgpack(REPO / GAN4)["dynamics_params"]
    dyn = dynamics_from_jax_params(
        tree, LearnedDynamics(ResidualMLPDynamicsNet(17, 6, hidden=(256, 256, 256))))
    rng = np.random.default_rng(27)
    X = rng.standard_normal((40, 17)).astype(np.float32)
    U = rng.uniform(-1, 1, (40, 6)).astype(np.float32)
    jdyn = JaxLearnedDynamics(JaxResidualNet(x_size=17, hidden=(256, 256, 256)))
    ref = jdyn.batch_apply(jax.tree_util.tree_map(jnp.asarray, tree), X, U)
    with torch.no_grad():
        got = dyn.batch_apply(torch.from_numpy(X), torch.from_numpy(U))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_bench_window_is_the_reference_one():
    """One full warmup episode, then the mean of three 50-step episodes,
    at the flagship's envs or the row's own (the humanoid-class row's 128)."""
    assert (bench.STEPS, bench.WARMUP_EPISODES, bench.REPS) == (50, 1, 3)
    calls = []

    def fake_run_steps(policy, env, norm, num_steps, generator, num_envs):
        calls.append((num_steps, num_envs))
        return None, float(len(calls))

    real, bench.run_steps = bench.run_steps, fake_run_steps
    try:
        mean = bench.timed_episodes(None, None, None, None)
        bench.timed_episodes(None, None, None, None, 128)
    finally:
        bench.run_steps = real
    assert calls == [(50, 512)] * 4 + [(50, 128)] * 4
    assert mean == (2.0 + 3.0 + 4.0) / 3  # the warmup episode is not in the mean
    row = bench.bench_row(1.0, "card", "off")
    assert set(row) == {"metric", "value", "unit", "vs_baseline"} and row["unit"] == "steps/sec"
    assert "cheetah_run, 512 envs, iLQR<= 5 iters, H=5, fused_ls=off, torch port" in row["metric"]
    row = bench.bench_row(1.0, "card", "on", "humanoid_stand", 128, 5, 50, 16, "recompute")
    assert ("humanoid_stand, 128 envs, iLQR<= 5 iters, H=50, fused_ls=on, "
            "ls_materialize=recompute, torch port") in row["metric"]
