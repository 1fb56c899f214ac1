"""Port parity for the hybrid mesh (``tests/test_multihost.py``): four
gloo ranks on the CPU as a (2, 2) ("dcn", "ici") mesh
(``make_hybrid_mesh(dcn_size=2)``; one launcher numbers one host's ranks
contiguously, so the rows are hosts, as JAX's rows are processes).

Checked: the mesh's shape and ``data_axes``; a dynamics step with its
batch sharded over both axes (``parallel.checks.sharded_steps_case``,
gradients and loss averaged over the whole mesh) against JAX's step on
one device over the full batch (loss rtol 1e-5, parameters atol 1e-5,
``tests/test_multihost.py``'s tolerances); and the dp x tp step on the
(2, 2) ("dp", "tp") mesh against JAX's single-device step, at
``tests/test_parallel.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_mpc_tpu.models import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu.training.dynamics import multistep_prediction_loss
from gan_mpc_tpu.training.masking import masked_adam
from gan_mpc_tpu_torch.parallel.checks import sharded_steps_on_ranks
from test_torch_fused_epoch import leaves
from test_torch_parallel import PORT_CONFIG

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
X_SIZE, U_SIZE, SEQ, BATCH = 3, 1, 4, 16
RANKS = ["cpu"] * 4


def data(hidden):
    dyn = LearnedDynamics(ResidualMLPDynamicsNet(x_size=X_SIZE, hidden=hidden))
    params = {"dynamics_params": dyn.init(KEY, U_SIZE)}
    k1, k2, k3 = jax.random.split(KEY, 3)
    batch = (jax.random.normal(k1, (BATCH, SEQ, X_SIZE)),
             jax.random.normal(k2, (BATCH, SEQ, U_SIZE)),
             jax.random.normal(k3, (BATCH, SEQ, X_SIZE)))
    return dyn, params, batch


def full_batch_step(hidden, opt):
    """JAX's update on one device over the full batch."""
    dyn, params, (Xb, Ub, Yb) = data(hidden)

    def loss_fn(p):
        return jnp.mean(jax.vmap(lambda x, u, y: multistep_prediction_loss(
            dyn, p["dynamics_params"], x, u, y, 0.9, jnp.asarray(True)))(Xb, Ub, Yb))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    inputs = {"X": np.asarray(Xb), "U": np.asarray(Ub), "Y": np.asarray(Yb)}
    return (jax.device_get(params["dynamics_params"]), float(loss),
            jax.device_get(new["dynamics_params"]), inputs)


@pytest.fixture(scope="module")
def runs():
    _, params, _ = data((16,))
    hybrid = full_batch_step((16,), masked_adam(params, [], 1e-3)[0])
    tp = full_batch_step((64, 64), optax.adam(1e-3))
    case = {"config": PORT_CONFIG, "sizes": (X_SIZE, U_SIZE),
            "hybrid": dict(hybrid[3], dcn=2, hidden=(16,), lr=1e-3, gamma=0.9, params=hybrid[0]),
            "dp_tp": dict(tp[3], z=np.ones((2, X_SIZE + U_SIZE), np.float32), hidden=(64, 64),
                          lr=1e-3, gamma=0.9, params=tp[0])}
    return {"hybrid": hybrid, "dp_tp": tp}, sharded_steps_on_ranks(case, RANKS, timeout=60.0)


def test_hybrid_mesh_shape_and_axes(runs):
    got = runs[1]
    assert got["mesh"]["shape"] == {"dp": 4}
    assert got["hybrid"]["shape"] == {"dcn": 2, "ici": 2}
    assert tuple(got["hybrid"]["axes"]) == ("dcn", "ici")


@pytest.mark.parametrize("step", ["hybrid", "dp_tp"])
def test_step_over_both_axes_agrees_with_one_device(runs, step):
    _, loss, want, _ = runs[0][step]
    got = runs[1][step]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    g, w = dict(leaves(got["params"])), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for name, wv in w.items():
        np.testing.assert_allclose(g[name], wv, atol=1e-5, err_msg=name)
