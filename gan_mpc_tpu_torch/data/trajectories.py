"""Expert trajectory stores: writing, reading and the quality gate.

Counterpart of ``TrajectorySet``, ``save_trajectories`` and
``load_trajectories`` in ``gan_mpc_tpu/data/trajectories.py``, numpy only
(no native library). Three formats:

  * ``.gmts``, the binary store that ``gan_mpc_tpu/native/trajstore.cpp``
    writes: a 40-byte header (uint64 magic "GANMPCTS", int64 n_traj,
    traj_len, x_size, u_size, little-endian), then the float32 states
    (n, len, x), actions (n, len, u) and rewards (n, len), each
    contiguous. The executed actions ride in a sidecar ``<path>.exec.npz``;
  * ``.npz`` with states, actions, rewards[, executed_actions];
  * JSON with the same keys.

The gate keeps the trajectories whose total reward exceeds
``min_reward``, best first, at most ``num_trajectories`` of them, each
cut to ``trajectory_len`` steps: the JAX loader's order and slicing.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np

GMTS_MAGIC = 0x47414E4D50435453  # "GANMPCTS"
_HEADER = np.dtype([("magic", "<u8"), ("n_traj", "<i8"), ("traj_len", "<i8"),
                    ("x_size", "<i8"), ("u_size", "<i8")])


class TrajectorySet(NamedTuple):
    states: np.ndarray  # (N, L, x)
    actions: np.ndarray  # (N, L, u) the expert's clean actions
    rewards: np.ndarray  # (N, L)
    # the actions executed during collection (the clean ones plus any
    # exploration noise): the dynamics learns from these
    executed_actions: Optional[np.ndarray] = None

    @property
    def dynamics_actions(self) -> np.ndarray:
        return self.executed_actions if self.executed_actions is not None else self.actions


def read_gmts(path: str):
    """(states, actions, rewards) of a ``.gmts`` store."""
    with open(path, "rb") as f:
        data = f.read()
    head = np.frombuffer(data, _HEADER, count=1)[0]
    if int(head["magic"]) != GMTS_MAGIC:
        raise ValueError(f"{path} is not a trajectory store (bad magic)")
    n, length, x, u = (int(head[k]) for k in ("n_traj", "traj_len", "x_size", "u_size"))
    sizes = [n * length * x, n * length * u, n * length]
    body = np.frombuffer(data, np.float32, offset=_HEADER.itemsize)
    if body.size != sum(sizes):
        raise ValueError(f"{path}: {body.size} floats after the header, {sum(sizes)} expected")
    s, a, r = np.split(body, np.cumsum(sizes)[:2])
    return (s.reshape(n, length, x).copy(), a.reshape(n, length, u).copy(),
            r.reshape(n, length).copy())


def write_gmts(path: str, states, actions, rewards) -> None:
    """Write a ``.gmts`` store: the bytes ``traj_write`` of
    ``gan_mpc_tpu/native/trajstore.cpp`` writes for the same arrays."""
    s, a, r = (np.ascontiguousarray(v, dtype=np.float32) for v in (states, actions, rewards))
    n, length, x = s.shape
    head = np.array([(GMTS_MAGIC, n, length, x, a.shape[-1])], _HEADER)
    with open(path, "wb") as f:
        for block in (head, s, a, r):
            f.write(block.tobytes())


def save_trajectories(path: str, trajs: TrajectorySet) -> None:
    """Write ``trajs`` to ``path`` in the format its suffix names (``.gmts``
    with the executed actions in ``<path>.exec.npz``, ``.npz``, else JSON),
    as the JAX ``save_trajectories`` does."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    extra = {}
    if trajs.executed_actions is not None:
        extra["executed_actions"] = trajs.executed_actions
    if path.endswith(".gmts"):
        write_gmts(path, trajs.states, trajs.actions, trajs.rewards)
        if extra:
            np.savez_compressed(path + ".exec.npz", **extra)
    elif path.endswith(".npz"):
        np.savez_compressed(path, states=trajs.states, actions=trajs.actions,
                            rewards=trajs.rewards, **extra)
    else:
        with open(path, "w") as fp:
            json.dump({"states": trajs.states.tolist(), "actions": trajs.actions.tolist(),
                       "rewards": trajs.rewards.tolist(),
                       **{k: v.tolist() for k, v in extra.items()}}, fp)


def load_trajectories(path: str, num_trajectories: Optional[int] = None,
                      trajectory_len: Optional[int] = None,
                      min_reward: float = 500.0) -> TrajectorySet:
    """Load a store and apply the quality gate (see the module doc)."""
    executed = None
    if path.endswith(".gmts"):
        states, actions, rewards = read_gmts(path)
        if os.path.exists(path + ".exec.npz"):
            executed = np.asarray(np.load(path + ".exec.npz")["executed_actions"], np.float32)
    else:
        if path.endswith(".npz"):
            data = np.load(path)
        else:
            with open(path, "r") as fp:
                data = json.load(fp)
        states, actions, rewards = (np.asarray(data[k], np.float32)
                                    for k in ("states", "actions", "rewards"))
        if "executed_actions" in data:
            executed = np.asarray(data["executed_actions"], np.float32)

    totals = rewards.sum(axis=1)
    order = [i for i in np.argsort(-totals) if totals[i] > min_reward]
    if num_trajectories is not None:
        order = order[:num_trajectories]
    if not order:
        raise ValueError(f"no trajectories in {path!r} exceed total reward {min_reward}")
    sl = slice(None, trajectory_len)
    return TrajectorySet(
        states=states[order, sl],
        actions=actions[order, sl],
        rewards=rewards[order, sl],
        executed_actions=executed[order, sl] if executed is not None else None,
    )
