"""A data-parallel training run on two gloo ranks on the CPU.

The tiny GAN config of ``tests/test_torch_run_l2.py`` (the committed
pendulum store and expert, H=3, iLQR <= 12) with the fused epochs, 2
envs, 1 epoch and a checkpoint after it, run two ways:

  * in one process (``runtime.data_parallel_devices`` 1);
  * with ``data_parallel_devices: 2`` on ``devices=["cpu", "cpu"]``,
    interrupted by its log function at the epoch-1 line (rank 0's
    exception stops both ranks), then again, resuming from the epoch-1
    checkpoint into the end of the run.

Checked: rank 0 alone logs and writes (one run directory, one metrics row
for the epoch, the log lines once each), the resume, and the saved
parameters and the epoch's metrics against the one-process run's, at the
tolerances of JAX's own mesh-against-single-device test
(``tests/fused_epoch_cases.py:189-198``: parameters atol 5e-5, metrics
atol 5e-4 and rtol 1e-3), the expert's parameters bitwise. The tighter
bound of ``tests/test_torch_fused_epoch_mesh.py`` (1e-6 + 1% of each
parameter's movement) holds for one epoch at that test's learning rates;
at this config's 1e-5 Adam's normalized steps turn rounding-sized
differences of near-zero gradients (the ranks sum their halves of each
minibatch) into steps of either sign: the dynamics weights differ by up
to 1.6e-5 of a 7.1e-4 movement. Also: ``check_supported`` passes the
setting, the modular path ignores it, and ``maybe_mesh`` refuses more
CUDA devices than are attached.
"""

import json
import os

import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch.params import to_jax_params
from gan_mpc_tpu_torch.parallel import launch
from gan_mpc_tpu_torch.runners import common, gan, l2
from test_torch_run_l2 import leaves, tiny_config

torch.set_num_threads(1)

DP = dict(runtime__fused_epochs=True, runtime__num_parallel_envs=2, mpc__train__num_epochs=1,
          runtime__checkpoint={"every_epochs": 1, "keep": 2},
          mpc__evaluate__fresh_eval_episodes=2)


class Crash(RuntimeError):
    pass


class FileLog:
    """A log function the ranks can be sent (a picklable object): each
    line appended to ``path``; raises ``Crash`` after the line that starts
    with ``crash_at``."""

    def __init__(self, path, crash_at=None):
        self.path, self.crash_at = str(path), crash_at

    def __call__(self, msg):
        with open(self.path, "a") as f:
            f.write(msg + "\n")
        if self.crash_at is not None and msg.startswith(self.crash_at):
            raise Crash(msg)

    def lines(self):
        with open(self.path) as f:
            return f.read().splitlines()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    launch_timeout = launch.DEFAULT_TIMEOUT
    launch.DEFAULT_TIMEOUT = 60.0
    try:
        one = gan.run(tiny_config(root / "one", **DP), log_fn=None, device="cpu")
        cfg = tiny_config(root / "dp", runtime__data_parallel_devices=2, **DP)
        first = FileLog(root / "first.log", crash_at="[gan/fused] epoch 1 ")
        with pytest.raises(Crash):
            gan.run(cfg, log_fn=first, device="cpu", devices=["cpu", "cpu"])
        second = FileLog(root / "second.log")
        dp = gan.run(cfg, log_fn=second, device="cpu", devices=["cpu", "cpu"])
    finally:
        launch.DEFAULT_TIMEOUT = launch_timeout
    start = to_jax_params(common.setup(tiny_config(root / "start", **DP), True,
                                       device="cpu")["policy"])
    return dict(one=one, dp=dp, cfg=cfg, first=first.lines(), second=second.lines(),
                start=start)


def test_rank_0_alone_logs_and_writes(runs):
    cfg = runs["cfg"]
    assert runs["first"][-1].startswith("[gan/fused] epoch 1 ")
    assert sum(m.startswith("[gan/fused] epoch 1 ") for m in runs["first"]) == 1
    assert "[gan] resumed from checkpoint at epoch 1" in runs["second"]
    assert len(runs["second"]) == len(set(runs["second"]))
    assert not [m for m in runs["second"] if m.startswith("[gan/fused] epoch")]
    assert runs["second"][-1].startswith("[gan] avg_reward ")
    family_dir = os.path.dirname(runs["dp"]["run_dir"])
    assert os.listdir(family_dir) == [os.path.basename(runs["dp"]["run_dir"])]
    assert [r["step"] for r in metrics_rows(cfg) if "episode_return" in r] == [1]
    assert os.listdir(os.path.join(cfg.runtime.workdir, "checkpoints", "pendulum_swingup",
                                   "gan")) == []
    assert "policy" not in runs["dp"]


def metrics_rows(cfg):
    with open(os.path.join(cfg.runtime.workdir, "metrics", "pendulum_swingup",
                           "gan.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_saved_params_match_the_one_process_run(runs):
    got, want = dict(leaves(runs["dp"]["params"])), dict(leaves(runs["one"]["params"]))
    start = dict(leaves(runs["start"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name.startswith("expert_params"):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], w, rtol=0, atol=5e-5, err_msg=name)
    for component in ("mpc_weights", "cost_params", "dynamics_params", "critic_params"):
        assert max(np.abs(w - start[n]).max() for n, w in want.items()
                   if n.startswith(component)) > 0, component
    # the resumed run's curves are empty: its epoch ran before the interruption
    assert not any(runs["dp"]["history"].values())
    (dp_row,) = [r for r in metrics_rows(runs["cfg"]) if "episode_return" in r]
    one = runs["one"]["history"]
    for name, key in l2.FUSED_RECORDS["gan"].values():
        np.testing.assert_allclose(dp_row[key], one[name][0], rtol=1e-3, atol=5e-4, err_msg=key)


def test_data_parallel_setting_is_supported_and_checked(tmp_path, monkeypatch):
    cfg = tiny_config(tmp_path, runtime__data_parallel_devices=2, **DP)
    common.check_supported(cfg)
    # the modular epochs ignore the mesh, as JAX's do
    assert common.data_parallel_devices(cfg.replace(runtime__fused_epochs=False)) is None
    assert common.data_parallel_devices(cfg, ["cpu", "cpu"]) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="2 devices given"):
        common.data_parallel_devices(cfg.replace(runtime__data_parallel_devices=3),
                                     ["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for refuse in (common.maybe_mesh, common.data_parallel_devices):
        with pytest.raises(ValueError, match="only 1 CUDA devices are attached"):
            refuse(cfg)
    assert common.maybe_mesh(cfg.replace(runtime__data_parallel_devices=1)) is None
    with pytest.raises(ValueError, match="only 1 CUDA devices are attached"):
        l2.run(cfg, log_fn=None, device="cpu")
    assert not os.path.exists(os.path.join(tmp_path, "metrics"))
