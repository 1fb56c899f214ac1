"""The port's expert store writer against the JAX package.

  * ``write_gmts`` / ``save_trajectories`` to ``.gmts`` give the bytes of
    JAX's native ``native_store.write_trajectories`` for the same arrays
    (``gan_mpc_tpu/native/trajstore.cpp``), and the ``.exec.npz`` sidecar's
    arrays equal JAX's;
  * each package's ``load_trajectories`` reads the other's store, in each
    of the three formats (``.gmts``, ``.npz``, JSON), through the same
    reward gate: equal arrays, bitwise;
  * ``ensure_trajectories`` on a tiny pendulum config in an empty workdir
    collects ``collection_size`` episodes into the fingerprinted store
    that JAX's ``trajectories_path`` names, and a second call reads it
    without collecting; a gate that fewer trajectories clear than asked
    for prints JAX's warning;
  * ``jax_native_store.ensure`` loads the JAX package's native library in
    a process that kept a failed load of a half-written one (the race of
    test workers in a fresh checkout), by building it to a temporary name
    and renaming it into place.
"""

import os

import numpy as np
import pytest

from gan_mpc_tpu.config import Config as JaxConfig
from gan_mpc_tpu.data import native_store
from gan_mpc_tpu.data import trajectories as jtraj
from gan_mpc_tpu.runners import common as jcommon
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data import trajectories as traj
from gan_mpc_tpu_torch.runners import common
from test_end_to_end import TINY_OVERRIDES

import jax_native_store

jax_native_store.ensure()

FIELDS = ("states", "actions", "rewards", "executed_actions")


def _arrays(n=5, length=12, x=4, u=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(n, length, x), f(n, length, u), np.abs(f(n, length)), f(n, length, u)


def test_native_store_recovers_from_a_half_written_library(tmp_path, monkeypatch):
    """A process that loaded the library while another was still writing
    it keeps the failure (``_lib_load_failed``); ``ensure`` rebuilds the
    library in place and clears it, and the store reads again."""
    lib = tmp_path / "libtrajstore.so"
    lib.write_bytes(b"\x7fELF" + b"\0" * 60)  # a linker's output cut short
    monkeypatch.setattr(native_store, "_LIB", str(lib))
    monkeypatch.setattr(native_store, "_lib", None)
    monkeypatch.setattr(native_store, "_lib_load_failed", False)
    assert not native_store.available()  # the failed load is kept
    assert native_store._lib_load_failed and not native_store.available()
    assert jax_native_store.ensure() is not None
    assert native_store.available() and lib.stat().st_size > 64
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libtrajstore.so"]
    s, a, r, _ = _arrays()
    native_store.write_trajectories(str(tmp_path / "x.gmts"), jtraj.TrajectorySet(s, a, r))
    np.testing.assert_array_equal(traj.read_gmts(str(tmp_path / "x.gmts"))[0], s)


def test_gmts_bytes_match_the_native_writer(tmp_path):
    if not native_store.available():
        pytest.skip("the JAX package's native store library does not build here")
    s, a, r, _ = _arrays()
    native_store.write_trajectories(str(tmp_path / "jax.gmts"), jtraj.TrajectorySet(s, a, r))
    traj.write_gmts(str(tmp_path / "port.gmts"), s, a, r)
    assert (tmp_path / "port.gmts").read_bytes() == (tmp_path / "jax.gmts").read_bytes()


@pytest.mark.parametrize("suffix", ["gmts", "npz", "json"])
def test_each_package_reads_the_others_store(tmp_path, suffix):
    if suffix == "gmts" and not native_store.available():
        pytest.skip("the JAX package's native store library does not build here")
    s, a, r, e = _arrays()
    jax_path, port_path = str(tmp_path / f"jax.{suffix}"), str(tmp_path / f"port.{suffix}")
    jtraj.save_trajectories(jax_path, jtraj.TrajectorySet(s, a, r, e))
    traj.save_trajectories(port_path, traj.TrajectorySet(s, a, r, e))
    if suffix == "gmts":
        assert open(port_path, "rb").read() == open(jax_path, "rb").read()
        np.testing.assert_array_equal(np.load(port_path + ".exec.npz")["executed_actions"],
                                      np.load(jax_path + ".exec.npz")["executed_actions"])
    gate = dict(num_trajectories=3, trajectory_len=7, min_reward=float(np.sort(r.sum(1))[1]))
    for path in (jax_path, port_path):
        got = traj.load_trajectories(path, **gate)
        want = jtraj.load_trajectories(path, **gate)
        assert got.states.shape == (3, 7, 4)
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def _tiny(workdir, **overrides):
    cfg = Config.from_yaml_str(TINY_OVERRIDES).replace(
        runtime__workdir=str(workdir), env__expert_episode_steps=200, **overrides)
    jcfg = JaxConfig.from_yaml_str(TINY_OVERRIDES).replace(
        runtime__workdir=str(workdir), env__expert_episode_steps=200, **overrides)
    return cfg, jcfg


def test_ensure_trajectories_collects_once_into_the_fingerprinted_store(tmp_path, monkeypatch):
    cfg, jcfg = _tiny(tmp_path)
    trajs = common.ensure_trajectories(cfg, "cpu")
    path = common.trajectories_path(cfg)
    assert os.path.exists(path) and os.path.exists(path + ".exec.npz")
    assert path == jcommon.trajectories_path(jcfg)
    assert os.path.basename(path) == f"trajectories-{common.collection_fingerprint(cfg)}.gmts"
    stored = traj.load_trajectories(path, min_reward=-np.inf)
    assert stored.states.shape == (common.collection_size(cfg), 200, 3)
    assert trajs.states.shape == (cfg.mpc.train.num_trajectories, cfg.mpc.train.trajectory_len, 3)

    def no_collection(*args, **kwargs):
        raise AssertionError("collected a store that exists")

    monkeypatch.setattr(common, "collect_expert_trajectories", no_collection)
    again = common.ensure_trajectories(cfg, "cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(again, name), getattr(trajs, name))


def test_ensure_trajectories_warns_on_a_short_gate(tmp_path, capsys):
    cfg, _ = _tiny(tmp_path, mpc__train__num_trajectories=4, mpc__train__min_expert_reward=-1.0)
    path = common.trajectories_path(cfg)
    s, a, r, e = _arrays(n=4, length=200, x=3, u=1)
    r[:2] = -1.0  # two of four trajectories fall under the gate
    traj.save_trajectories(path, traj.TrajectorySet(s, a, r, e))
    trajs = common.ensure_trajectories(cfg, "cpu")
    assert trajs.states.shape[0] == 2
    assert "WARNING: only 2 of the requested 4 trajectories clear" in capsys.readouterr().out
