"""The JAX comparisons of ``test_torch_trained_ckpts_humanoid.py`` (its
tolerances stated there) on cheetah_run gan/0: H=10, iLQR <= 30, dynamics
23->256->256->256->17, torso x3, and ``goal_projection_iters: 2``, so that
every plan first projects the expert's goals onto the learned dynamics'
reachable states (on the batch-native path). The loader against the JAX
bench's ``_load_checkpoint``, and 2 envs closed-loop for 3 steps from
JAX's resets, 8 nudges. Its store is gan/4's committed one.
"""

import pytest
import torch

from test_torch_pendulum import REPO
from test_torch_trained_ckpts import (  # noqa: F401  (the loader test, run here)
    _repo_cwd,
    served_pair,
    test_bench_loader_matches_jax,
)
from test_torch_trained_ckpts_humanoid import NUDGES, check_served_steps

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return "cheetah_run/gan/0", served_pair("cheetah_run/gan/0")


def test_served_steps_match_jax(served):
    _, (_, ckpt) = served
    assert ckpt.policy.batch_native and ckpt.policy.goal_projection == 2
    check_served_steps(served, B=2, T=3, nudges=NUDGES)
