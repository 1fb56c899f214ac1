"""Evaluation videos rendered from logged states (host side, off the hot path).

Counterpart of ``gan_mpc_tpu/utils/video.py``: the rollout runs on the
policy's device and logs only ``qpos``; afterwards a small rasterizer
(PIL) redraws the episode on the host, one frame a control step. The
planar skeletons come from the envs' forward kinematics, run in float32
on the CPU. ``save_video`` writes mp4 through imageio and falls back to a
GIF through PIL where imageio cannot (no ffmpeg).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

_W, _H = 320, 240
_SCALE = 60.0  # pixels per meter
_BG = (240, 240, 245)
_FG = (40, 60, 90)
_ACCENT = (200, 80, 60)


def _canvas():
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (_W, _H), _BG)
    return img, ImageDraw.Draw(img)


def _to_px(x, z, cx=0.0, ground_px=None):
    px = _W / 2 + (x - cx) * _SCALE
    base = ground_px if ground_px is not None else _H / 2
    pz = base - z * _SCALE
    return px, pz


def _kinematics(env):
    """fk(q (nq,)) -> (world angles (nb,), joint origins (nb, 2)) of the
    env's default model: numpy float32, computed in float32 on the CPU."""
    from gan_mpc_tpu_torch.envs.planar import forward_kinematics

    model = env.model(env.default_params())

    def fk(q):
        q = torch.as_tensor(q, dtype=torch.float32)[None]
        angles, origins, _ = forward_kinematics(model, q)
        return angles[0].numpy(), origins[0].numpy()

    return fk


def render_pendulum(qpos: np.ndarray) -> np.ndarray:
    """qpos (T, 1) pole angle (0 = up) -> (T, H, W, 3) uint8 frames."""
    frames = []
    for (th,) in qpos:
        img, d = _canvas()
        ox, oz = _W / 2, _H / 2
        x = ox + _SCALE * np.sin(th)
        z = oz - _SCALE * np.cos(th)
        d.line([(ox, oz), (x, z)], fill=_FG, width=5)
        d.ellipse([x - 6, z - 6, x + 6, z + 6], fill=_ACCENT)
        frames.append(np.asarray(img))
    return np.stack(frames)


def render_cartpole(qpos: np.ndarray) -> np.ndarray:
    """qpos (T, 2) = (cart_x, pole_angle)."""
    frames = []
    for cart_x, th in qpos:
        img, d = _canvas()
        gy = _H * 0.6
        d.line([(0, gy), (_W, gy)], fill=(150, 150, 160), width=2)
        cx, _ = _to_px(cart_x, 0)
        d.rectangle([cx - 18, gy - 12, cx + 18, gy + 2], fill=_FG)
        tip_x = cx + _SCALE * np.sin(th)
        tip_y = gy - 12 - _SCALE * np.cos(th)
        d.line([(cx, gy - 12), (tip_x, tip_y)], fill=_ACCENT, width=4)
        frames.append(np.asarray(img))
    return np.stack(frames)


def render_cheetah(qpos: np.ndarray) -> np.ndarray:
    """qpos (T, 9); the link skeleton by forward kinematics, the camera
    tracking the root x."""
    from gan_mpc_tpu_torch.envs.cheetah import CheetahRun

    fk = _kinematics(CheetahRun("cpu"))
    lengths = {1: 0.29, 2: 0.30, 3: 0.19, 4: 0.27, 5: 0.21, 6: 0.14}
    frames = []
    for q in qpos:
        angles, origins = fk(q)
        img, d = _canvas()
        gy = _H * 0.8
        d.line([(0, gy), (_W, gy)], fill=(150, 150, 160), width=2)
        cx = q[0]
        # torso segment
        a0 = angles[0]
        p_rear = origins[0] + 0.5 * np.array([-np.cos(a0), -np.sin(a0)])
        p_front = origins[0] + 0.5 * np.array([np.cos(a0), np.sin(a0)])
        x1, y1 = _to_px(p_rear[0], p_rear[1], cx, gy)
        x2, y2 = _to_px(p_front[0], p_front[1], cx, gy)
        d.line([(x1, y1), (x2, y2)], fill=_FG, width=6)
        # limbs: each link extends along its local -z
        for b, ln in lengths.items():
            a = angles[b]
            start = origins[b]
            end = start + ln * np.array([np.sin(a), -np.cos(a)])
            x1, y1 = _to_px(start[0], start[1], cx, gy)
            x2, y2 = _to_px(end[0], end[1], cx, gy)
            color = _ACCENT if b in (3, 6) else _FG
            d.line([(x1, y1), (x2, y2)], fill=color, width=4)
        frames.append(np.asarray(img))
    return np.stack(frames)


def render_walker(qpos: np.ndarray) -> np.ndarray:
    """qpos (T, 9); the biped skeleton by forward kinematics, the camera
    tracking the root x. The torso extends up from the hip; feet
    accented."""
    from gan_mpc_tpu_torch.envs.walker import WalkerWalk

    fk = _kinematics(WalkerWalk("cpu"))
    lengths = {1: 0.45, 2: 0.5, 3: 0.2, 4: 0.45, 5: 0.5, 6: 0.2}
    frames = []
    for q in qpos:
        angles, origins = fk(q)
        img, d = _canvas()
        gy = _H * 0.8
        d.line([(0, gy), (_W, gy)], fill=(150, 150, 160), width=2)
        cx = q[0]
        # torso: from the hip (root origin) up along local +z
        a0 = angles[0]
        hip = origins[0]
        head = hip + 0.6 * np.array([-np.sin(a0), np.cos(a0)])
        x1, y1 = _to_px(hip[0], hip[1], cx, gy)
        x2, y2 = _to_px(head[0], head[1], cx, gy)
        d.line([(x1, y1), (x2, y2)], fill=_FG, width=6)
        # limbs extend along local -z
        for b, ln in lengths.items():
            a = angles[b]
            start = origins[b]
            end = start + ln * np.array([np.sin(a), -np.cos(a)])
            x1, y1 = _to_px(start[0], start[1], cx, gy)
            x2, y2 = _to_px(end[0], end[1], cx, gy)
            color = _ACCENT if b in (3, 6) else _FG
            d.line([(x1, y1), (x2, y2)], fill=color, width=4)
        frames.append(np.asarray(img))
    return np.stack(frames)


def render_humanoid(qpos: np.ndarray) -> np.ndarray:
    """qpos (T, 15); the 13-link humanoid skeleton by forward kinematics.
    Torso and head extend up (+z local), limbs down; feet accented."""
    from gan_mpc_tpu_torch.envs.humanoid import _LENGTHS, HumanoidStand

    fk = _kinematics(HumanoidStand("cpu"))
    up_bodies = {1, 2}  # torso, head
    frames = []
    for q in qpos:
        angles, origins = fk(q)
        img, d = _canvas()
        gy = _H * 0.85
        d.line([(0, gy), (_W, gy)], fill=(150, 150, 160), width=2)
        cx = q[0]
        for b in range(len(_LENGTHS)):
            a, start, ln = angles[b], origins[b], float(_LENGTHS[b])
            if b == 0:  # the pelvis straddles its origin
                lo = start - 0.1 * np.array([-np.sin(a), np.cos(a)])
                hi = start + 0.1 * np.array([-np.sin(a), np.cos(a)])
            elif b in up_bodies:
                lo, hi = start, start + ln * np.array([-np.sin(a), np.cos(a)])
            else:
                lo, hi = start, start + ln * np.array([np.sin(a), -np.cos(a)])
            x1, y1 = _to_px(lo[0], lo[1], cx, gy)
            x2, y2 = _to_px(hi[0], hi[1], cx, gy)
            color = _ACCENT if b in (5, 8) else _FG
            width = 6 if b in (0, 1) else 4
            d.line([(x1, y1), (x2, y2)], fill=color, width=width)
        # the head
        hx, hy = _to_px(*(origins[2] + 0.25 * np.array(
            [-np.sin(angles[2]), np.cos(angles[2])]
        )), cx, gy)
        d.ellipse([hx - 7, hy - 7, hx + 7, hy + 7], fill=_FG)
        frames.append(np.asarray(img))
    return np.stack(frames)


_RENDERERS = {
    "pendulum_swingup": render_pendulum,
    "cartpole_balance": render_cartpole,
    "cheetah_run": render_cheetah,
    "walker_walk": render_walker,
    "humanoid_stand": render_humanoid,
    "humanoid_walk": render_humanoid,
}


def render_episode(env_name: str, qpos: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 frames of one episode's (T, nq) qpos."""
    try:
        renderer = _RENDERERS[env_name]
    except KeyError:
        raise ValueError(f"no renderer for env {env_name!r}")
    return renderer(np.asarray(qpos))


def save_video(frames: Sequence[np.ndarray], path: str, fps: int = 30) -> str:
    """Write mp4 (imageio with ffmpeg), else a GIF beside it through PIL.
    Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:
        from PIL import Image

        gif_path = os.path.splitext(path)[0] + ".gif"
        imgs = [Image.fromarray(np.asarray(f)) for f in frames]
        imgs[0].save(
            gif_path,
            save_all=True,
            append_images=imgs[1:],
            duration=int(1000 / fps),
            loop=0,
        )
        return gif_path
