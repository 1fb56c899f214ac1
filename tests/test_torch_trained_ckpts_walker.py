"""The JAX comparisons of ``test_torch_trained_ckpts.py`` (its tolerances
stated there) on walker_walk gan/0: the port bench's loader against the
JAX bench's ``_load_checkpoint``, and the served control steps. The
walker's ground contact adds to the trained solves' ill-conditioning:
JAX's own actions move by up to 0.1 under the nudges there.
"""

import pytest
import torch

from test_torch_pendulum import REPO
from test_torch_trained_ckpts import (  # noqa: F401  (the tests, run here on walker gan/0)
    _repo_cwd,
    served_pair,
    test_bench_loader_matches_jax,
    test_served_steps_match_jax,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return "walker_walk/gan/0", served_pair("walker_walk/gan/0")
