"""The JAX comparisons of ``test_torch_trained_ckpts.py`` (its tolerances
stated there) on the committed cheetah_run runs gan/5, 6 and 7: gan/4's
stacks (H=10, iLQR <= 30, dynamics 23->256->256->256->17, the
action-goal cost, critic, torso x3), trained on from it, each served
from gan/4's committed store (``trajectories-7f1480bbfd.gmts``, the name
both packages' ``trajectories_path`` give their configs). The loader
against the JAX bench's ``_load_checkpoint``, and 2 envs closed-loop for
2 steps (gan/4's 3, cut to keep the file under a minute) from JAX's
resets, each action within max(1e-3, 2 x JAX's own spread under the 8
nudges).
"""

import pytest
import torch

from test_torch_pendulum import REPO
from test_torch_trained_ckpts import (  # noqa: F401  (the loader test, run here on each run)
    _repo_cwd,
    check_committed_store,
    served_pair,
    test_bench_loader_matches_jax,
)
from test_torch_trained_ckpts_humanoid import NUDGES, check_served_steps

torch.set_num_threads(1)

RUNS = [f"cheetah_run/gan/{n}" for n in (5, 6, 7)]


@pytest.mark.parametrize("run", RUNS)
def test_store_is_gan4s(run, monkeypatch):
    check_committed_store(run, "cheetah_run/trajectories-7f1480bbfd.gmts", monkeypatch)


@pytest.fixture(scope="module", params=RUNS)
def served(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return request.param, served_pair(request.param)


def test_served_steps_match_jax(served):
    check_served_steps(served, B=2, T=2, nudges=NUDGES)
