"""Port parity: ``gan_mpc_tpu_torch/utils/debug.py`` against
``gan_mpc_tpu/utils/debug.py`` (whose own test is ``tests/test_aux.py``'s
``test_debug_checks_and_interfaces``), on the same trees and arrays:

  * ``assert_finite`` passes the finite trees and raises
    ``FloatingPointError`` with JAX's message, the leaf's path included,
    on the others; an ``nn.Module`` is walked by its ``state_dict`` names;
  * ``checkify_finite`` returns x where every entry is finite and x * NaN
    otherwise, as JAX's does;
  * ``debug_checks`` turns autograd's anomaly mode on in its scope and
    restores it after (JAX's turns ``jax_debug_nans`` on); inside it a
    backward that produces NaN raises; ``enable_debug_checks`` sets it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gan_mpc_tpu.utils import debug as jdebug
from gan_mpc_tpu_torch.utils import debug

NAN, INF = float("nan"), float("inf")
TREES = {
    "flat": {"a": [1.0, 2.0, 3.0]},
    "nan_leaf": {"a": [1.0, NAN]},
    "nested": {"b": [[1.0], {"c": [0.5, INF], "d": [1.0]}], "a": [[2.0, 3.0]]},
    "list": [[1.0], [2.0, -INF]],
    "tuple_in_dict": {"x": ([1.0], [NAN, 1.0]), "w": [0.0]},
}


def as_tree(tree, array):
    if isinstance(tree, dict):
        return {k: as_tree(v, array) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(as_tree(v, array) for v in tree)
    if isinstance(tree, list) and tree and isinstance(tree[0], (list, dict, tuple)):
        return [as_tree(v, array) for v in tree]
    return array(np.asarray(tree, np.float32))


def outcome(check, tree, label):
    try:
        check(tree, label)
        return None
    except FloatingPointError as e:
        return str(e)


@pytest.mark.parametrize("name", sorted(TREES))
def test_assert_finite_matches_jax(name):
    want = outcome(jdebug.assert_finite, as_tree(TREES[name], jnp.asarray), "params")
    got = outcome(debug.assert_finite, as_tree(TREES[name], torch.tensor), "params")
    assert got == want
    assert (want is None) == (name in ("flat",))


def test_assert_finite_on_a_module():
    net = nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2))
    debug.assert_finite(net, "net")
    debug.assert_finite({"net": net, "w": torch.ones(2)})
    with torch.no_grad():
        net[2].bias[1] = NAN
    with pytest.raises(FloatingPointError, match=r"^net\['2.bias'\] contains non-finite"):
        debug.assert_finite(net, "net")
    with pytest.raises(FloatingPointError, match=r"^value\['m'\]\['2.bias'\]"):
        debug.assert_finite({"m": net})


@pytest.mark.parametrize("values", [[1.0, -2.0, 3.5], [1.0, NAN, 2.0], [INF, 0.0, 1.0], []],
                         ids=["finite", "nan", "inf", "empty"])
def test_checkify_finite_matches_jax(values):
    x = np.asarray(values, np.float32)
    want = np.asarray(jdebug.checkify_finite(jnp.asarray(x)))
    got = debug.checkify_finite(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where NaN
    if np.isfinite(x).all():
        np.testing.assert_array_equal(got, x)
    else:
        assert np.isnan(got).all()


def test_debug_checks_scope_and_anomaly():
    assert not torch.is_anomaly_enabled()
    with debug.debug_checks(), jdebug.debug_checks():
        assert torch.is_anomaly_enabled() and jax.config.jax_debug_nans
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        y = torch.sqrt(x).sum()  # NaN at -1, and a NaN gradient behind it
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert not torch.is_anomaly_enabled() and not jax.config.jax_debug_nans
    try:
        debug.enable_debug_checks()
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_debug_checks(False)
    assert not torch.is_anomaly_enabled()
