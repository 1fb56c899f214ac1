"""Port parity: training with LSTM dynamics against the JAX package.

The widths, weights and inputs of ``test_torch_train_ensemble.py``, with
the dynamics an ``LSTMDynamicsNet`` of 4 features and a 4->8->4 relu
head (x = 4, u = 2, H = 4); the planner state xc = [x, h, c] is 12 wide
and the cost net reads all of it. Float32 on the CPU. Compared:

  * ``multistep_prediction_loss`` over 6 windows, teacher forcing on and
    off (the carry threads on from the prediction either way): losses
    rtol 1e-5, the gradients of every cell and head tensor each max|d|
    <= 1e-4 max|ref|;
  * one ``_update_scan`` of 3 minibatch steps on the same index rows, the
    clip inactive and active: losses rtol 1e-5, parameters atol 2 k lr;
  * ``batched_loss_and_grad`` with the L2 and the generator losses
    through the per-instance implicit gradient, ``dense`` and ``cg``,
    on histories whose JAX plan is stable, the head's output layer at its
    flax scale (the ensemble's tests scale theirs by 1/16; at 1/16 the
    LSTM's curvature moves the gradient by 6e-4 of its size, below the
    bound, at 1 by 175%): the loss rtol 1e-4, each
    gradient leaf max|d| <= 1e-3 max|ref|. JAX takes the exact Hessian
    (``jax.jacfwd`` or ``jax.jvp`` of ``jax.grad``); the port's problem
    states that Gauss-Newton is not exact for these dynamics, and the
    port takes the Hessian's products by double backward;
  * the same gradients with the Gauss-Newton product forced on the LSTM
    (the port before it took the exact Hessian) miss that bound, by more
    than 10x on some leaf: the cell's curvature, which Gauss-Newton
    drops.
"""

import numpy as np
import pytest

from gan_mpc_tpu_torch.models.dynamics import LSTMDynamicsNet
from test_torch_train_ensemble import (
    assert_grads_match,
    check_multistep_loss,
    check_update_scan,
    implicit_grads,
    leaves,
)

COMPONENTS = {"l2": ("mpc_weights", "cost_params", "dynamics_params"),
              "gan": ("mpc_weights", "cost_params", "dynamics_params", "critic_params")}


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_multistep_loss_and_gradients_match_jax(teacher_forcing):
    check_multistep_loss("lstm", teacher_forcing)


@pytest.mark.parametrize("target_scale", [1.0, 300.0], ids=["unclipped", "clipped"])
def test_update_scan_step_matches_jax(target_scale):
    check_update_scan("lstm", target_scale)


@pytest.mark.parametrize("loss", ["l2", "gan"])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_batched_loss_and_grad_matches_jax(solver, loss):
    jl, jg, tl, tg = implicit_grads("lstm", solver, loss, seed=5, dyn_scale=1.0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert_grads_match(tg, jg, COMPONENTS[loss], 1e-3)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_gauss_newton_alone_misses_the_lstm_gradient(solver, monkeypatch):
    """The L2 gradient with the problem claiming Gauss-Newton is exact for
    the LSTM: some leaf is off JAX's by more than 10 x 1e-3 of its max."""
    monkeypatch.setattr(LSTMDynamicsNet, "piecewise_linear", True)
    jl, jg, tl, tg = implicit_grads("lstm", solver, "l2", seed=5, dyn_scale=1.0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)  # the solve is the same
    got, want = dict(leaves(tg)), dict(leaves(jg))
    worst = max(np.abs(got[k] - np.asarray(want[k])).max() / np.abs(np.asarray(want[k])).max()
                for k in want if k.startswith(COMPONENTS["l2"]))
    assert worst > 1e-2, worst
