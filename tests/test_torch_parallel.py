"""Port parity for ``parallel/``: the sharded steps on two gloo ranks on the
CPU against the JAX package's sharded steps on a mesh of two of the
conftest's virtual CPU devices (``tests/test_parallel.py``'s cases).

The ranks run ``parallel.checks.sharded_steps_case`` once (a session of
two ranks) on the same numpy-seeded inputs and JAX-layout parameters as
the JAX steps, the policy rebuilt from a config of the JAX tiny
policy's widths. Compared, float32: each step's loss (rtol 1e-4) and the
parameters after it, the trained ones within 1e-6 + 1% of how far JAX's
step moved them, the others bitwise (the tolerance of
``tests/test_torch_fused_epoch.py``); the collected episodes (atol
1e-4); the dp x tp step against JAX's single-device step and the
tensor-parallel forward against the whole one, at ``tests/test_parallel.py``'s
tolerances (rtol 1e-5 and atol 1e-5); the ensemble step over "ep" against
JAX's (``tests/test_ensemble_walker.py:78``, two members on two devices).
Also the mesh's shape and coordinates, and that shapes that do not
divide the mesh raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_mpc_tpu.envs import PendulumSwingup
from gan_mpc_tpu.models import (
    CostFeatureNet,
    ExpertPredictor,
    LearnedDynamics,
    MPCCost,
    ResidualMLPDynamicsNet,
    SequenceCritic,
)
from gan_mpc_tpu.models.ensemble import EnsembleDynamics
from gan_mpc_tpu.parallel import (
    make_mesh,
    make_sharded_collect,
    make_sharded_cost_step,
    make_sharded_critic_step,
    make_sharded_dynamics_step,
    make_sharded_ensemble_step,
    shard_batch,
)
from gan_mpc_tpu.planner import SolverSettings
from gan_mpc_tpu.policies import MPCPolicy
from gan_mpc_tpu.policies.losses import l2_imitation_loss
from gan_mpc_tpu.training.dynamics import multistep_prediction_loss
from gan_mpc_tpu.training.masking import masked_adam
from gan_mpc_tpu_torch.envs.base import EnvState
from gan_mpc_tpu_torch.parallel import mesh as tmesh
from gan_mpc_tpu_torch.parallel.checks import sharded_steps_on_ranks
from gan_mpc_tpu_torch.parallel.sharded import local_members, make_sharded_collect as t_collect
from test_torch_fused_epoch import leaves

torch.set_num_threads(1)

X, U, H = 3, 1, 3
KEY = jax.random.PRNGKey(0)
RANKS = ["cpu", "cpu"]
COMPONENTS = ("mpc_weights", "cost_params", "dynamics_params", "expert_params",
              "critic_params")
NO_GRADS = {"cost": ["dynamics_params", "expert_params", "critic_params"],
            "dynamics": ["mpc_weights", "cost_params", "expert_params", "critic_params"],
            "critic": ["mpc_weights", "cost_params", "dynamics_params", "expert_params"]}
LR = {"cost": 1e-4, "dynamics": 1e-3, "critic": 1e-3}
COLLECT_STEPS, ENVS = 10, 4
TP_HIDDEN, ENS_HIDDEN = (64, 64), (16,)


def jax_policy():
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(hidden=(16,), features_out=4), H),
        dynamics_model=LearnedDynamics(ResidualMLPDynamicsNet(x_size=X, hidden=(16,))),
        expert_model=ExpertPredictor(x_size=X, u_size=U, arch="mlp", features=0, hidden=(16,)),
        critic_model=SequenceCritic(features=8, hidden=(16,)),
        horizon=H, settings=SolverSettings(max_iterations=5))
    return policy, policy.init(KEY, (-2.0, 3.0, -3.0), U, critic_x_size=X)


PORT_CONFIG = {
    "seed": 0,
    "env": {"name": "pendulum_swingup", "imitator": {"name": "pendulum_swingup"}},
    "mpc": {"horizon": H, "history": 1, "solver": {"max_iterations": 5},
            "model": {"cost": {"weights": {"action": -2.0, "state": 3.0, "terminal": -3.0},
                               "mlp": {"hidden": [16], "features_out": 4}},
                      "dynamics": {"use": "mlp", "mlp": {"hidden": [16]}},
                      "critic": {"use": "lstm", "lstm": {"features": 8, "hidden": [16]}}}},
    "expert_prediction": {"model": {"use": "mlp", "mlp": {"hidden": [16]}}},
    "runtime": {"workdir": "runs"},
}


def inputs():
    """Every step's inputs, numpy, from fixed keys."""
    k = jax.random.split(KEY, 12)
    n = lambda i, *shape, s=1.0: np.asarray(s * jax.random.normal(k[i], shape))  # noqa: E731
    env = PendulumSwingup()
    env_keys = jax.random.split(k[11], ENVS)
    resets = jax.vmap(lambda kk: env.reset(env.default_params(), jax.random.split(kk)[0]))(
        env_keys)
    return {
        "cost": {"X": n(0, 16, 2, X, s=0.1), "Y": n(1, 16, H + 1, X, s=0.1)},
        "dynamics": {"X": n(2, 32, H, X), "U": n(3, 32, H, U), "Y": n(4, 32, H, X)},
        "critic": {"seqs": n(5, 16, H + 1, X),
                   "labels": np.where(np.arange(16) % 2 == 0, 1.0, -1.0).astype(np.float32)},
        "collect": {"keys": np.asarray(env_keys), "reset_qpos": np.asarray(resets.qpos),
                    "reset_qvel": np.asarray(resets.qvel),
                    "reset_t": np.asarray(resets.t).astype(np.int32)},
        "dp_tp": {"X": n(6, 8, 4, X), "U": n(7, 8, 4, U), "Y": n(8, 8, 4, X),
                  "z": n(9, 5, X + U)},
        "ensemble": {"Xm": n(10, 2, 4, H, X), "Um": n(9, 2, 4, H, U), "Ym": n(8, 2, 4, H, X)},
    }


@pytest.fixture(scope="module")
def jax_side():
    """The JAX steps on a two-device mesh (the dp x tp step: JAX's
    single-device step, which ``tests/test_parallel.py`` holds its own
    against)."""
    data = inputs()
    policy, params = jax_policy()
    mesh = make_mesh(2)
    out = {"params0": jax.device_get(params)}
    opt, state = masked_adam(params, NO_GRADS["cost"], LR["cost"])
    p, _, loss = make_sharded_cost_step(policy, opt, mesh, l2_imitation_loss)(
        params, state, *shard_batch((data["cost"]["X"], data["cost"]["Y"]), mesh))
    out["cost"] = {"loss": float(loss), "params": jax.device_get(p)}
    opt, state = masked_adam(params, NO_GRADS["dynamics"], LR["dynamics"])
    d = data["dynamics"]
    p, _, loss = make_sharded_dynamics_step(policy.dynamics_model, opt, mesh, gamma=0.9)(
        params, state, *shard_batch((d["X"], d["U"], d["Y"]), mesh), jnp.asarray(True))
    out["dynamics"] = {"loss": float(loss), "params": jax.device_get(p)}
    opt, state = masked_adam(params, NO_GRADS["critic"], LR["critic"])
    c = data["critic"]
    p, _, loss = make_sharded_critic_step(policy, opt, mesh)(
        params, state, *shard_batch((c["seqs"], c["labels"]), mesh))
    out["critic"] = {"loss": float(loss), "params": jax.device_get(p)}
    env = PendulumSwingup()
    from gan_mpc_tpu.data.normalizer import Normalizer

    collect = make_sharded_collect(env, env.default_params(), policy.act,
                                   Normalizer.identity(X, U), mesh, num_steps=COLLECT_STEPS,
                                   history=1, envs_per_device=ENVS // 2)
    ep = collect(params, shard_batch(jnp.asarray(data["collect"]["keys"]), mesh))
    out["collect"] = {"states": np.asarray(ep.states), "rewards": np.asarray(ep.rewards)}

    dyn = LearnedDynamics(ResidualMLPDynamicsNet(x_size=X, hidden=TP_HIDDEN))
    dparams = {"dynamics_params": dyn.init(KEY, U)}
    adam = optax.adam(1e-3)
    t = data["dp_tp"]

    def loss_fn(p):
        return jnp.mean(jax.vmap(lambda x, u, y: multistep_prediction_loss(
            dyn, p["dynamics_params"], x, u, y, 0.9, jnp.asarray(True)))(t["X"], t["U"], t["Y"]))

    loss, grads = jax.value_and_grad(loss_fn)(dparams)
    updates, _ = adam.update(grads, adam.init(dparams), dparams)
    out["dp_tp"] = {"params0": jax.device_get(dparams["dynamics_params"]), "loss": float(loss),
                    "params": jax.device_get(optax.apply_updates(dparams, updates)
                                             ["dynamics_params"])}

    ens = EnsembleDynamics(ResidualMLPDynamicsNet(x_size=X, hidden=ENS_HIDDEN), num_members=2)
    eparams = ens.init(KEY, U)
    estate = adam.init(eparams)
    e = data["ensemble"]
    ep_mesh = make_mesh(2, axis_names=("ep",))
    step = make_sharded_ensemble_step(ens, adam, ep_mesh, gamma=0.9, opt_state_template=estate)
    sharded = shard_batch((eparams, e["Xm"], e["Um"], e["Ym"]), ep_mesh, axis="ep")
    p, _, loss = step(sharded[0], estate, *sharded[1:], jnp.asarray(True))
    out["ensemble"] = {"params0": jax.device_get(eparams), "loss": float(loss),
                       "params": jax.device_get(p)}
    return data, out


@pytest.fixture(scope="module")
def port_side(jax_side):
    data, ref = jax_side
    case = {"config": PORT_CONFIG, "sizes": (X, U), "params": ref["params0"],
            "cost": dict(data["cost"], loss="l2", no_grads=NO_GRADS["cost"], lr=LR["cost"]),
            "dynamics": dict(data["dynamics"], no_grads=NO_GRADS["dynamics"],
                             lr=LR["dynamics"], gamma=0.9, teacher_forcing=True),
            "critic": dict(data["critic"], no_grads=NO_GRADS["critic"], lr=LR["critic"]),
            "collect": dict(data["collect"], num_steps=COLLECT_STEPS, history=1),
            "dp_tp": dict(data["dp_tp"], hidden=TP_HIDDEN, lr=1e-3, gamma=0.9,
                          params=ref["dp_tp"]["params0"]),
            "ensemble": dict(data["ensemble"], members=2, hidden=ENS_HIDDEN, lr=1e-3,
                             gamma=0.9, params=ref["ensemble"]["params0"])}
    return sharded_steps_on_ranks(case, RANKS, timeout=60.0)


def assert_step_close(got, want, before, trained):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    g, w, b = dict(leaves(got["params"])), dict(leaves(want["params"])), dict(leaves(before))
    assert sorted(g) == sorted(w)
    moved_any = False
    for name, wv in w.items():
        moved = np.abs(wv - b[name]).max()
        if name.startswith(trained):
            moved_any |= moved > 0
            assert np.abs(g[name] - wv).max() <= 1e-6 + 1e-2 * moved, name
        else:
            np.testing.assert_array_equal(g[name], wv, err_msg=name)
    assert moved_any


def test_mesh_has_two_ranks(port_side):
    assert port_side["mesh"] == {"shape": {"dp": 2}, "coords": {"dp": 0}}


@pytest.mark.parametrize("step", ["cost", "dynamics", "critic"])
def test_sharded_step_matches_jax(jax_side, port_side, step):
    ref = jax_side[1]
    trained = tuple(c for c in COMPONENTS if c not in NO_GRADS[step])
    assert_step_close(port_side[step], ref[step], ref["params0"], trained)


def test_sharded_collect_matches_jax(jax_side, port_side):
    ref, got = jax_side[1]["collect"], port_side["collect"]
    assert got["states"].shape == (ENVS, COLLECT_STEPS, X)
    np.testing.assert_allclose(got["states"], ref["states"], atol=1e-4)
    np.testing.assert_allclose(got["rewards"], ref["rewards"], atol=1e-4)


def test_dp_tp_dynamics_step_matches_single_device(jax_side, port_side):
    ref, got = jax_side[1]["dp_tp"], port_side["dp_tp"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    g, w = dict(leaves(got["params"])), dict(leaves(ref["params"]))
    assert sorted(g) == sorted(w)
    for name, wv in w.items():
        np.testing.assert_allclose(g[name], wv, atol=1e-5, err_msg=name)


def test_tensor_parallel_forward_matches_replicated(port_side):
    got = port_side["tp_apply"]
    np.testing.assert_allclose(got["tp"], got["whole"], rtol=1e-5, atol=1e-7)


def test_sharded_ensemble_step_matches_jax(jax_side, port_side):
    ref = jax_side[1]["ensemble"]
    assert_step_close(port_side["ensemble"], ref, ref["params0"], ("params",))


def test_tensor_parallel_sharding_splits_the_columns_that_divide():
    """JAX's rule: the last axis of a kernel or bias split over "tp" where
    it divides the axis size, else whole; this rank's block."""
    mesh = tmesh.Mesh(("tp",), (2,))  # rank 0's view
    w, b, w_out = torch.arange(12.0).view(3, 4), torch.arange(4.0), torch.ones(4, 3)
    specs = tmesh.mlp_tensor_parallel_sharding({"w": w, "b": b, "out": w_out}, mesh)
    assert specs["w"].spec == (None, "tp") and specs["b"].spec == ("tp",)
    assert specs["out"].spec == ()
    local = tmesh.apply_tensor_parallel({"w": w, "b": b, "out": w_out}, mesh)
    assert torch.equal(local["w"], w[:, :2]) and torch.equal(local["b"], b[:2])
    assert torch.equal(local["out"], w_out)


def test_rank_devices_name_the_current_card(monkeypatch):
    """A rank's "cuda" is the launching process's current card: a spawned
    process's own current card would be cuda:0 whatever the caller's."""
    from gan_mpc_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert launch.rank_devices(["cuda", torch.device("cuda:1"), "cpu"]) == \
        ["cuda:3", "cuda:1", "cpu"]
    assert tmesh.backend_for(launch.rank_devices(["cuda", "cuda:1"])) == "nccl"


def test_shapes_that_do_not_divide_raise():
    mesh = tmesh.Mesh(("dp",), (2,))
    with pytest.raises(ValueError, match="3 rows do not divide"):
        tmesh.shard_batch((torch.zeros(3, 2),), mesh)
    with pytest.raises(ValueError, match="mesh shape"):
        tmesh.make_mesh(4, shape=(3,))
    with pytest.raises(ValueError, match="group of 1 ranks"):
        tmesh.make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 start states for 4 envs"):
        t_collect(None, None, None, None, mesh, 2, 1, envs_per_device=2)(
            EnvState(torch.zeros(3, 1), torch.zeros(3, 1), torch.zeros(3)))

    class Ensemble:
        num_members = 3

    with pytest.raises(ValueError, match="3 members do not divide"):
        local_members(Ensemble(), tmesh.Mesh(("ep",), (2,)))
