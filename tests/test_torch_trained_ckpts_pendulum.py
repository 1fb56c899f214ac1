"""The JAX comparisons of ``test_torch_trained_ckpts.py`` (its tolerances
stated there) on the committed pendulum_swingup runs gan/2, 7, 8, 9, 10
and 11 (H=10, iLQR <= 30, dynamics 4->200->200->200->3, cost
3->128->128->10, critic), each served from its own store:

  * the three stores (``trajectories-f71d22530f.gmts`` of gan/2,
    ``-3332439a79`` of gan/7-10, ``-fc3f8af2b2`` of gan/11), written by
    the JAX package's ``ensure_trajectories`` on each run's saved config,
    are named by both packages' ``trajectories_path`` and load bitwise
    equal in both;
  * each run: the port bench's loader against the JAX bench's
    ``_load_checkpoint`` (the normalizer within 1e-6 of each channel's
    root mean square), and 2 envs closed-loop for 3 steps from JAX's
    resets, each action within max(1e-3, 2 x JAX's own spread under the
    8 nudges). The port acts on JAX's normalized histories: these solves
    are the most ill-conditioned of the committed runs (gan/2's first
    actions move by up to 0.31 under 1e-6 nudges of the observations),
    and the normalizers' own rounding (gan/2's std differs from JAX's by
    1.1e-7 of itself) moved gan/2's action at step 1 by 4.0e-3 against
    JAX's spread of 5.9e-4 under the nudges when this was written; on
    JAX's normalized histories the port's action there is within 2.4e-6.
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

STORES = {
    "pendulum_swingup/gan/2": "pendulum_swingup/trajectories-f71d22530f.gmts",
    "pendulum_swingup/gan/9": "pendulum_swingup/trajectories-3332439a79.gmts",
    "pendulum_swingup/gan/11": "pendulum_swingup/trajectories-fc3f8af2b2.gmts",
}
RUNS = [f"pendulum_swingup/gan/{n}" for n in (2, 7, 8, 9, 10, 11)]


@pytest.mark.parametrize("run", sorted(STORES))
def test_committed_store_loads_in_both_packages(run, monkeypatch):
    check_committed_store(run, STORES[run], monkeypatch)


@pytest.fixture(scope="module", params=RUNS)
def served(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        return request.param, served_pair(request.param)


def test_served_steps_match_jax(served):
    check_served_steps(served, B=2, T=3, nudges=NUDGES, jax_normalizer=True)
