"""The walker's and the cart-pole's scripted experts and their collection
against the JAX package: the tests of ``test_torch_collect.py`` (their
tolerances stated there) on walker_walk (the state-indexed phase-PD gait,
its observations checked clear of phase-match near-ties) and
cartpole_balance (the linear balance feedback, no switch but the clip).
"""

import pytest
import torch

from test_torch_collect import (  # noqa: F401  (the tests, run here on walker and cartpole)
    collections_of,
    test_collection_matches_jax,
    test_expert_action_matches_jax,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["walker_walk", "cartpole_balance"])
def collections(request):
    return collections_of(request.param)
