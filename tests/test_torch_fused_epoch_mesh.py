"""Port parity: the fused GAN and L2 epochs in mesh mode on two ranks.

``tests/jax_fused_reference.py mesh_epochs`` runs JAX's fused epochs in
mesh mode (``mesh=make_mesh(2)`` over two virtual CPU devices, the single
program) on the tiny pendulum setups of ``tests/test_torch_fused_epoch.py``
(the GAN test split 4 histories, so that it divides the mesh), in fresh
interpreters, one a family, run at once. The port's epochs run in mesh mode on two gloo ranks on the
CPU (``parallel.checks.fused_epoch_on_ranks``: the policy rebuilt from a
config of the same widths and JAX's params, JAX's draws replayed), and
in one process from the same draws (``fused_epoch_case``). Compared at
the tolerances of ``tests/test_torch_fused_epoch.py``: every metric rtol
1e-4 (atol 1e-6), the replay's windows atol 1e-5, every trained
parameter within 1e-6 + 1% of how far JAX's epoch moved it, the others
bitwise. Also: the port's refusals of mesh mode are JAX's, message for
message.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan_mpc_tpu_torch.parallel.checks import fused_epoch_case, fused_epoch_on_ranks
from gan_mpc_tpu_torch.parallel.mesh import Mesh
from jax_fused_reference import H, ITERS, LR, NO_GRADS
from test_torch_fused_epoch import REPO, leaves

torch.set_num_threads(1)

RANKS = ["cpu", "cpu"]
TIMEOUT = 60.0  # seconds a collective may wait


def tiny_config(family: str) -> dict:
    """The config whose ``build_policy`` gives the reference's tiny policy
    (``jax_fused_reference.tiny_policy``) and whose phase optimizers are
    its ``masked_adam``s."""
    gan = family == "gan"
    phases = ("dynamics", "critic", "cost") if gan else ("dynamics", "cost")
    train = {k: {"learning_rate": LR[k],
                 "no_grads": [c for c in NO_GRADS[k] if gan or c != "critic_params"]}
             for k in phases}
    return {
        "seed": 0,
        "env": {"name": "pendulum_swingup", "imitator": {"name": "pendulum_swingup"}},
        "mpc": {"horizon": H, "history": 1, "solver": {"max_iterations": ITERS},
                "model": {"cost": {"weights": {"action": -2.0, "state": 3.0, "terminal": -3.0},
                                   "mlp": {"hidden": [8], "features_out": 2}},
                          "dynamics": {"use": "mlp", "mlp": {"hidden": [16]}},
                          "critic": {"use": "lstm", "lstm": {"features": 8, "hidden": [8]}}},
                "train": train},
        "expert_prediction": {"model": {"use": "mlp", "mlp": {"hidden": [8]}}},
        "runtime": {"workdir": "runs"},
    }


def case_of(ref: dict, family: str) -> dict:
    return {"family": family, "config": tiny_config(family), "sizes": (3, 1),
            "params": ref["params0"],
            "data": {"exp_X": ref["exp_X"], "exp_Y": ref["exp_Y"], "test_X": ref["test_X"],
                     "test_Y": ref["test_Y"], "dyn": ref["dyn"]},
            "replay_capacity": 64, "kwargs": ref["kwargs"], "draws": ref["draws"],
            "teacher_forcing": ref["teacher_forcing"]}


def mesh_references(out_dir):
    """JAX's mesh epoch of each family, each in a fresh interpreter
    (``tests/jax_fused_reference.py mesh_epochs``), the two started at
    once; yields (family, reference), the L2 one (the quicker) first."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    procs = {}
    for family in ("l2", "gan"):
        path = os.path.join(str(out_dir), f"mesh_{family}.pkl")
        procs[family] = (path, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "jax_fused_reference.py"),
             "mesh_epochs", path, family], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        for family, (path, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout[-2000:] + stderr[-3000:]
            with open(path, "rb") as f:
                yield family, pickle.load(f)[family]
    finally:  # a failing family leaves no interpreter behind
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{family: (JAX's mesh epoch, the port's on two ranks, the port's in
    one process)}; each family's port runs while the other's JAX epoch
    may still compile."""
    out = {}
    for family, ref in mesh_references(tmp_path_factory.mktemp("jax")):
        case = case_of(ref, family)
        out[family] = (ref, fused_epoch_on_ranks(case, RANKS, TIMEOUT),
                       fused_epoch_case("cpu", case, 1))
    return out


def assert_epoch_close(got: dict, ref: dict, family: str, want_metrics: dict, want_replay: dict,
                       want_params: dict):
    for name, want in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][name], float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    n = want_replay["size"]
    assert got["replay"]["size"] == n == 2 * (6 - H)
    for name in ("states", "actions", "next_states"):
        np.testing.assert_allclose(got["replay"][name], want_replay[name][:n], atol=1e-5,
                                   err_msg=name)
    params, before = dict(leaves(got["params"])), dict(leaves(ref["params0"]))
    want = dict(leaves(want_params))
    assert sorted(params) == sorted(want)
    trained = {"gan": ("mpc_weights", "cost_params", "dynamics_params", "critic_params"),
               "l2": ("mpc_weights", "cost_params", "dynamics_params")}[family]
    for name, w in want.items():
        moved = np.abs(dict(leaves(ref["params1"]))[name] - before[name]).max()
        if name.startswith(trained):
            assert moved > 0, name
            assert np.abs(params[name] - w).max() <= 1e-6 + 1e-2 * moved, name
        else:
            np.testing.assert_array_equal(params[name], w, err_msg=name)


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_mesh_epoch_matches_jax_mesh_epoch(runs, family):
    ref, ranks, _ = runs[family]
    assert ref["test_X"].shape[0] == 4
    assert_epoch_close(ranks, ref, family, ref["metrics"], ref["replay"], ref["params1"])


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_mesh_epoch_matches_the_single_process_epoch(runs, family):
    ref, ranks, single = runs[family]
    assert sorted(ranks["metrics"]) == sorted(single["metrics"])
    assert_epoch_close(ranks, ref, family, single["metrics"], single["replay"],
                       single["params"])


def _refusal(make, **kw):
    with pytest.raises(ValueError) as e:
        make(**kw)
    return str(e.value)


@pytest.mark.parametrize("family", ["gan", "l2"])
def test_mesh_refusals_are_jax_s(runs, family):
    """chunk_updates, and each size that does not divide the mesh, raise
    JAX's ValueError with JAX's message, before any work."""
    import jax.numpy as jnp

    from gan_mpc_tpu.parallel import make_mesh as jax_mesh
    from gan_mpc_tpu.training import fused_epoch as jfe
    from gan_mpc_tpu_torch.training import fused_epoch as tfe

    ref = runs[family][0]
    gan = family == "gan"
    base = dict(ref["kwargs"], chunk_updates=0)
    bad = [dict(chunk_updates=1), dict(num_envs=3), dict(batch_size=3)]
    if gan:
        bad += [dict(critic_plan_batch=3), dict(test_plan_batch=3)]
    name = "make_fused_gan_epoch" if gan else "make_fused_l2_epoch"
    X, Y = ref["exp_X"], ref["exp_Y"]
    for change in bad:
        kw = dict(base, **change)
        want = _refusal(getattr(jfe, name), policy=None, env=None, env_params=None,
                        normalizer=None, optimizers={}, expert_history_X=jnp.asarray(X),
                        expert_future_Y=jnp.asarray(Y), expert_history_X_test=jnp.asarray(X),
                        expert_future_Y_test=jnp.asarray(Y), mesh=jax_mesh(2), **kw)
        got = _refusal(getattr(tfe, name), policy=None, env=None, env_params=None,
                       normalizer=None, optimizers={}, expert_history_X=torch.tensor(X),
                       expert_future_Y=torch.tensor(Y), expert_history_X_test=torch.tensor(X),
                       expert_future_Y_test=torch.tensor(Y), mesh=Mesh(("dp",), (2,)), **kw)
        assert got == want, change
