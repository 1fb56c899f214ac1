"""Port parity: the evaluation video (``gan_mpc_tpu_torch/utils/video.py``
and ``runners.l2.maybe_save_video``) against the JAX package's, on the CPU.

  * each of the six env names of ``_RENDERERS`` renders frames bitwise
    equal to JAX's on the same qpos (12 frames drawn from a seed; the
    planar skeletons through each package's forward kinematics in
    float32);
  * ``save_video``: where imageio writes (the mp4 branch) it is handed the
    path, the frames and the rate as JAX hands them; where it cannot (no
    ffmpeg, as on this host) the GIF written through PIL is byte for byte
    JAX's and reads back frame for frame;
  * the video's episode of a tiny run (``video_episode``: one env,
    ``min(max_interactions, 300)`` steps) against JAX's ``episode_rollout``
    from the reset JAX draws from the same key, on the same weights and
    normalizer: qpos within 1e-5 and actions within 1e-3 (JAX's
    per-instance ``act`` against the port's batch solve; 1.2e-6 and
    4.5e-4 over keys 0-3 when this was written), rewards equal; and
    ``maybe_save_video`` writes the frames of the episode its generator
    draws (a GIF here, whose writer merges a frame equal to the one
    before it; an mp4 where imageio has ffmpeg).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_mpc_tpu.utils import video as jvideo
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.envs import EnvState
from gan_mpc_tpu_torch.runners import common, l2
from gan_mpc_tpu_torch.utils import video
from test_torch_run_l2 import tiny_config

torch.set_num_threads(1)
pin_fp32()

NQ = {"pendulum_swingup": 1, "cartpole_balance": 2, "cheetah_run": 9, "walker_walk": 9,
      "humanoid_stand": 15, "humanoid_walk": 15}
FRAMES = 12


def qpos_of(name, seed=0):
    rng = np.random.default_rng(seed)
    q = 0.7 * rng.standard_normal((FRAMES, NQ[name]))
    if NQ[name] > 2:  # a planar root: x along the track, z above the ground
        q[:, 0] += np.linspace(0.0, 2.0, FRAMES)
        q[:, 1] = 1.0 + 0.2 * q[:, 1]
    return q.astype(np.float32)


@pytest.mark.parametrize("name", sorted(NQ))
def test_frames_match_jax(name):
    assert sorted(video._RENDERERS) == sorted(jvideo._RENDERERS) == sorted(NQ)
    q = qpos_of(name)
    got, want = video.render_episode(name, q), jvideo.render_episode(name, q)
    assert got.shape == (FRAMES, 240, 320, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len({f.tobytes() for f in got}) > 1  # the episode moves


def test_unknown_env_is_refused():
    with pytest.raises(ValueError, match="no renderer"):
        video.render_episode("reacher_easy", np.zeros((2, 2), np.float32))


def frames_of(name="cheetah_run"):
    return video.render_episode(name, qpos_of(name))


def test_save_video_hands_imageio_what_jax_hands_it(tmp_path, monkeypatch):
    import imageio.v2 as imageio

    calls = []
    monkeypatch.setattr(imageio, "mimwrite", lambda path, frames, fps: calls.append(
        (path, np.stack(frames), fps)))
    frames = frames_of()
    for package, sub in ((video, "port"), (jvideo, "jax")):
        path = str(tmp_path / sub / "video.mp4")
        assert package.save_video(frames, path) == path
        assert os.path.isdir(tmp_path / sub)
    (p0, f0, r0), (p1, f1, r1) = calls
    assert (os.path.basename(p0), r0) == (os.path.basename(p1), r1) == ("video.mp4", 30)
    np.testing.assert_array_equal(f0, f1)
    np.testing.assert_array_equal(f0, frames)


def test_save_video_falls_back_to_the_gif_jax_writes(tmp_path, monkeypatch):
    import imageio.v2 as imageio

    def no_ffmpeg(*args, **kwargs):
        raise ValueError("Could not find a backend to open with iomode 'wI'")

    monkeypatch.setattr(imageio, "mimwrite", no_ffmpeg)
    frames = frames_of()
    got = video.save_video(frames, str(tmp_path / "port" / "v.mp4"), fps=20)
    want = jvideo.save_video(frames, str(tmp_path / "jax" / "v.mp4"), fps=20)
    assert got.endswith("port/v.gif") and want.endswith("jax/v.gif")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    with Image.open(got) as gif:
        assert gif.n_frames == FRAMES and gif.info["duration"] == 50
        for i in range(FRAMES):
            gif.seek(i)
            np.testing.assert_array_equal(np.asarray(gif.convert("RGB")), frames[i])


def jax_side(cfg, ctx):
    """JAX's policy on the port's weights, its imitator env, and the port's
    normalizer as a JAX one."""
    from gan_mpc_tpu.config import Config as JaxConfig
    from gan_mpc_tpu.data.normalizer import Normalizer as JaxNormalizer
    from gan_mpc_tpu.runners import common as jcommon
    from gan_mpc_tpu.runners.expert import load_pretrained_expert
    from gan_mpc_tpu_torch.params import to_jax_params

    jcfg = JaxConfig.from_dict(cfg.to_dict())
    expert_model, expert_params = load_pretrained_expert(jcfg, 3, 1)
    policy, _ = jcommon.build_policy(jcfg, 3, 1, expert_params=expert_params,
                                     expert_model=expert_model)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(ctx["policy"]))
    n = ctx["normalizer"]
    norm = JaxNormalizer(*(jnp.asarray(t.numpy()) for t in (
        n.state_mean, n.state_std, n.action_mean, n.action_std)))
    return policy, params, norm, jcommon.imitator_env(jcfg)


def test_video_episode_matches_jax_and_is_saved(tmp_path):
    from gan_mpc_tpu.envs.rollout import episode_rollout

    cfg = tiny_config(tmp_path, mpc__evaluate__save_video=True)
    ctx = common.setup(cfg, False, device="cpu")
    policy, params, norm, (jenv, jenv_params) = jax_side(cfg, ctx)
    steps = min(cfg.mpc.evaluate.max_interactions, 300)
    rollout = jax.jit(lambda p, k: episode_rollout(jenv, jenv_params, policy.act, p, norm, k,
                                                   num_steps=steps, history=cfg.mpc.history))
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        ref = rollout(params, key)
        reset = jenv.reset(jenv_params, jax.random.split(key)[0])  # the rollout's reset draw
        init = EnvState(torch.tensor(np.asarray(reset.qpos))[None],
                        torch.tensor(np.asarray(reset.qvel))[None],
                        torch.zeros(1, dtype=torch.int32))
        got = l2.video_episode(cfg, ctx, init_state=init)
        assert got.qpos.shape == (1, steps, 1)
        np.testing.assert_allclose(got.qpos[0].numpy(), np.asarray(ref.qpos), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.actions[0].numpy(), np.asarray(ref.actions), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(got.rewards[0].numpy(), np.asarray(ref.rewards))

    # the saved file holds the frames of the episode its generator draws
    path = l2.maybe_save_video(cfg, ctx, str(tmp_path / "run"), torch.Generator().manual_seed(5))
    assert l2.maybe_save_video(cfg.replace(mpc__evaluate__save_video=False), ctx,
                               str(tmp_path / "off"), torch.Generator()) is None
    assert not os.path.exists(tmp_path / "off")
    ep = l2.video_episode(cfg, ctx, torch.Generator().manual_seed(5))
    frames = video.render_episode("pendulum_swingup", ep.qpos[0].numpy())
    assert os.path.basename(path) in ("video.mp4", "video.gif")
    if path.endswith(".gif"):
        # PIL's GIF writer merges a frame equal to the one before it
        kept = [f for i, f in enumerate(frames) if i == 0 or not np.array_equal(f, frames[i - 1])]
        with Image.open(path) as gif:
            assert gif.n_frames == len(kept) >= steps // 2
            for i, frame in enumerate(kept):
                gif.seek(i)
                np.testing.assert_array_equal(np.asarray(gif.convert("RGB")), frame)

