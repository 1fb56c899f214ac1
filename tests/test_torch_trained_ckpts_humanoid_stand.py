"""The JAX comparisons of ``test_torch_trained_ckpts_humanoid.py`` (its
tolerances stated there) on humanoid_stand gan/0: an 8-member ensemble of
41->256->256->256->29 residual MLPs planned on its mean, H=50, iLQR <= 30,
CG bilevel, the action-goal cost, torso x1.5. JAX plans it per instance
(``vmap(plan)``), the port through ``batch_ilqr`` on a per-instance
problem. The loader against the JAX bench's ``_load_checkpoint`` (the
stacked member leaves round-tripped bitwise), and 1 env closed-loop for 2
steps from JAX's resets, each action within max(1e-3, 2 x JAX's spread
under 1 +- 1e-7 nudges of the observations): a JAX solve of this run takes
about 2 s here, so the window and the nudges are cut to stay under a
minute.
"""

import pytest
import torch

from test_torch_pendulum import REPO
from test_torch_trained_ckpts import (  # noqa: F401  (the loader test, run here)
    _repo_cwd,
    served_pair,
    test_bench_loader_matches_jax,
)
from test_torch_trained_ckpts_humanoid import check_served_steps

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return "humanoid_stand/gan/0", served_pair("humanoid_stand/gan/0")


def test_served_steps_match_jax(served):
    _, (_, ckpt) = served
    assert ckpt.policy.dynamics_model.num_members == 8 and not ckpt.policy.batch_native
    check_served_steps(served, B=1, T=2, nudges=(1 + 1e-7, 1 - 1e-7), nudge_mean=False)
