"""The cut dm_control episode of ``test_torch_dm_eval.py`` (its tolerances
stated there) on pendulum_swingup gan/9, served on its own committed
store (``trajectories-3332439a79.gmts``, the one both packages'
``trajectories_path`` name for its config), from suite seed 14: a start
near upright, so that the 30 steps earn reward.
"""

import torch

from test_torch_dm_eval import _repo_cwd, check_cut_episode  # noqa: F401  (fixture)

torch.set_num_threads(1)


def test_cut_episode_matches_jax():
    got, want = check_cut_episode("pendulum_swingup/gan/9", seed=14)
    assert want > 10.0  # the pole kept up: the returns compared are not trivial
