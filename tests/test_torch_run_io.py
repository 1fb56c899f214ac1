"""Port parity: the pieces a training run is built from.

  * ``params.to_jax_params`` + ``save_msgpack`` of a port policy (with a
    critic and without) restore in the JAX package (``utils/io.load_params``
    into the ``build_policy`` template, and ``flax.serialization.msgpack_restore``)
    bitwise equal to the port's tensors, and the file's bytes equal
    ``flax.serialization.to_bytes`` of that tree: flax copies the tree
    before packing, which leaves every map's keys sorted, and the writer
    sorts them too; the committed run gan/9, loaded and written again by
    the port, gives back the committed file byte for byte; the writer
    against ``msgpack_serialize`` on ints, scalars and maps of every
    header size;
  * ``collection_fingerprint`` and ``trajectories_path`` equal to JAX's
    strings for every committed config of an env the port has;
  * ``moment_distance`` (rtol 1e-5) and ``calibrate_action_goal_gain``
    with 4 and 5 raw weights against JAX on the same states: the same
    distances (rtol 1e-5), the same gain, the same weights after;
  * ``TrainCheckpointer`` keeps its cadence and its newest steps, and
    ``profiler_trace`` writes a trace.
"""

import glob
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch import nn

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu.training import calibrate as jcalibrate
from gan_mpc_tpu.utils import io as jio
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.params import (
    _pack, from_jax_params, load_msgpack, save_msgpack, to_jax_params,
)
from gan_mpc_tpu_torch.runners import common
from gan_mpc_tpu_torch.training import calibrate
from gan_mpc_tpu_torch.training.masking import policy_components
from gan_mpc_tpu_torch.utils.checkpoint import TrainCheckpointer
from gan_mpc_tpu_torch.utils.metrics import profiler_trace
from test_end_to_end import TINY_OVERRIDES
from test_torch_pendulum import G9, REPO, gan9_configs, port_gan9

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("with_critic", [True, False], ids=["critic", "no_critic"])
def test_saved_params_restore_in_jax_bitwise(tmp_path, with_critic):
    pcfg = Config.from_yaml_str(TINY_OVERRIDES)
    policy = common.build_policy(pcfg, 3, 1, with_critic=with_critic, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    tree = to_jax_params(policy)
    assert ("critic_params" in tree) == with_critic
    path = str(tmp_path / "params.msgpack")
    save_msgpack(tree, path)
    _, template = jcommon.build_policy(JaxConfig.from_yaml_str(TINY_OVERRIDES), 3, 1,
                                       with_critic=with_critic)
    restored = jax.device_get(jio.load_params(template, path))
    _assert_trees_equal(restored, tree)
    with open(path, "rb") as f:
        data = f.read()
    _assert_trees_equal(serialization.msgpack_restore(data), tree)
    # the same bytes flax writes for the same tree
    assert data == serialization.to_bytes(restored)
    # and back into a fresh port policy
    other = common.build_policy(pcfg, 3, 1, with_critic=with_critic, device="cpu",
                                generator=torch.Generator().manual_seed(4))
    from_jax_params(load_msgpack(path), other)
    for name, ps in policy_components(policy).items():
        for p, q in zip(ps, policy_components(other)[name]):
            assert torch.equal(p, q), name


def test_gan9_written_again_is_the_committed_file(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    _, pcfg = gan9_configs()
    path = str(tmp_path / "params.msgpack")
    save_msgpack(to_jax_params(port_gan9(pcfg)), path)
    with open(path, "rb") as f, open(REPO / G9 / "params.msgpack", "rb") as g:
        data, committed = f.read(), g.read()
    assert data == committed
    _assert_trees_equal(serialization.msgpack_restore(data),
                        serialization.msgpack_restore(committed))


@pytest.mark.parametrize("tree", [
    {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
              -32768, -32769, -2 ** 31 - 1], "flags": [True, False, None], "x": 1.5},
    {"scalar": np.float32(2.5), "int_scalar": np.int64(-7), "empty": np.zeros((0, 3), np.float32),
     "f64": np.arange(6, dtype=np.float64).reshape(2, 3), "i32": np.arange(40, dtype=np.int32)},
    {f"key_{i}": {"kernel": np.full((2,), i, np.float32)} for i in range(17)},
    {"s" * 40: "t" * 300, "bin": b"\x00" * 300},
], ids=["python", "numpy", "wide_map", "long_strings"])
def test_writer_matches_flax(tree):
    assert _pack(tree) == serialization.msgpack_serialize(tree)


# -- the collection fingerprint and the store path -----------------------------

PORTED_CONFIGS = sorted(
    p for p in glob.glob(str(REPO / "configs" / "*.yaml"))
    if Config.from_yaml(p).env.name in ("pendulum_swingup", "cheetah_run")
)


@pytest.mark.parametrize("path", PORTED_CONFIGS, ids=[Path(p).stem for p in PORTED_CONFIGS])
def test_fingerprint_and_store_path_match_jax(path, tmp_path):
    jcfg = JaxConfig.from_yaml(path).replace(runtime__workdir=str(tmp_path))
    pcfg = Config.from_yaml(path).replace(runtime__workdir=str(tmp_path))
    fp = jcommon.collection_fingerprint(jcfg)
    assert common.collection_fingerprint(pcfg) == fp
    # no store yet, then an .npz store, then a .gmts beside it
    assert common.trajectories_path(pcfg) == jcommon.trajectories_path(jcfg)
    base = tmp_path / "expert_trajectories" / jcfg.env.name
    base.mkdir(parents=True)
    for suffix in ("npz", "gmts"):
        (base / f"trajectories-{fp}.{suffix}").write_bytes(b"")
        assert common.trajectories_path(pcfg) == jcommon.trajectories_path(jcfg)
        assert common.trajectories_path(pcfg).endswith(suffix)


def test_store_resolver_names_the_store_and_never_collects(tmp_path):
    pcfg = Config.from_yaml(str(REPO / "configs" / "gan_pendulum.yaml")).replace(
        runtime__workdir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="does not collect"):
        common.resolve_trajectories(pcfg)
    assert not (tmp_path / "expert_trajectories").exists()
    store = str(REPO / "runs/expert_trajectories/pendulum_swingup/trajectories-f690b23776.gmts")
    assert common.resolve_trajectories(pcfg.replace(env__trajectories_path=store)) == store


# -- calibration ---------------------------------------------------------------

def _states(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 30, 3)) * [1.0, 0.5, 2.0] + [0.2, -0.1, 0.0]).astype(
        np.float32)


def test_moment_distance_matches_jax():
    s, t = _states(0), _states(1)
    mean, std = t.mean((0, 1)), t.std((0, 1)) + 1e-8
    ref = float(jcalibrate.moment_distance(jnp.asarray(s), jnp.asarray(mean), jnp.asarray(std)))
    got = float(calibrate.moment_distance(torch.from_numpy(s), torch.from_numpy(mean),
                                          torch.from_numpy(std)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("weights", [(-2.0, 3.0, -3.0, 0.5), (-2.0, 3.0, -3.0, 0.5, 1.1)],
                         ids=["4_weights", "5_weights"])
def test_calibrate_gain_matches_jax(weights, monkeypatch):
    """Each gain's rollout stubbed by states whose spread grows with the
    gain; the demonstrations' match at 1.3."""
    base, target = _states(2), _states(2) * 1.3
    mean, std = target.mean((0, 1)), target.std((0, 1)) + 1e-8
    grid = (1.0, 1.2, 1.4, 1.6)
    dists = {"jax": [], "port": []}
    for name, mod in (("jax", jcalibrate), ("port", calibrate)):
        original = mod.moment_distance

        def recording(*args, _name=name, _fn=original):
            d = _fn(*args)
            dists[_name].append(float(d))
            return d
        monkeypatch.setattr(mod, "moment_distance", recording)
    ref = jcalibrate.calibrate_action_goal_gain(
        None, {"mpc_weights": jnp.asarray(weights, jnp.float32)},
        lambda p: jnp.asarray(base) * p["mpc_weights"][4], jnp.asarray(mean), jnp.asarray(std),
        grid=grid, log=lambda m: None)
    policy = types.SimpleNamespace(cost_model=types.SimpleNamespace(
        weights=nn.Parameter(torch.tensor(weights), requires_grad=False)))
    gain = calibrate.calibrate_action_goal_gain(
        policy, lambda p: torch.from_numpy(base) * p.cost_model.weights[4],
        torch.from_numpy(mean), torch.from_numpy(std), grid=grid, log=lambda m: None)
    np.testing.assert_allclose(dists["port"], dists["jax"], rtol=1e-5)
    assert len(dists["port"]) == len(grid)
    assert gain == 1.4 and np.asarray(ref["mpc_weights"])[4] == np.float32(1.4)
    np.testing.assert_array_equal(policy.cost_model.weights.numpy(),
                                  np.asarray(ref["mpc_weights"]))


def test_calibrate_leaves_three_weights_alone():
    policy = types.SimpleNamespace(cost_model=types.SimpleNamespace(
        weights=nn.Parameter(torch.tensor([-2.0, 3.0, -3.0]), requires_grad=False)))
    assert calibrate.calibrate_action_goal_gain(policy, None, 0.0, 1.0) is None
    assert policy.cost_model.weights.shape == (3,)


# -- checkpoints and traces ------------------------------------------------------

def test_checkpointer_cadence_keep_and_clear(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), keep=2, every=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    saved = [ckpt.maybe_save(step, {"x": torch.full((3,), float(step)), "ptr": step,
                                    "gen": torch.Generator().manual_seed(step).get_state()})
             for step in range(1, 7)]
    assert saved == [False, True, False, True, False, True]
    assert ckpt.all_steps() == [4, 6] and ckpt.latest_step() == 6
    assert sorted(os.listdir(tmp_path / "ck")) == ["4.pt", "6.pt"]  # no temporary left
    state = ckpt.restore()
    assert state["ptr"] == 6 and torch.equal(state["x"], torch.full((3,), 6.0))
    assert ckpt.restore(4)["ptr"] == 4
    ckpt.clear()
    assert ckpt.latest_step() is None
    ckpt.close()


def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(None):
        torch.ones(3).sum()
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
