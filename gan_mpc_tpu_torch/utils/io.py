"""Run persistence: numbered run directories, params, JSON artifacts.

Counterpart of ``gan_mpc_tpu/utils/io.py``: each run gets the next integer
directory under a model family's path, and its params, ``config.json``
and loss curves are written there. Params go through the port's own
msgpack writer and reader (``params.save_msgpack`` / ``load_msgpack``), so
a run saved here loads in the JAX package and the other way round.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from gan_mpc_tpu_torch.params import load_msgpack, save_msgpack, to_jax_params


def new_run_dir(base_dir: str) -> str:
    """Create and return ``base_dir/<n+1>``, n the largest existing integer
    subdirectory (0 when there is none)."""
    os.makedirs(base_dir, exist_ok=True)
    existing = [int(d) for d in os.listdir(base_dir) if d.isdigit()]
    run_id = max(existing) + 1 if existing else 0
    path = os.path.join(base_dir, str(run_id))
    os.makedirs(path, exist_ok=True)
    return path


def save_json(data, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fp:
        json.dump(data, fp, indent=2, sort_keys=True)


def load_json(path: str):
    with open(path, "r") as fp:
        return json.load(fp)


def save_params(policy, path: str) -> None:
    """``policy``'s weights under the JAX names, as ``params.msgpack``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_msgpack(to_jax_params(policy), path)


def load_params(path: str) -> dict:
    """The parameter tree of a ``params.msgpack`` (load it into a policy
    with ``params.from_jax_params``)."""
    return load_msgpack(path)


def latest_run_dir(base_dir: str, run_id: Optional[str] = None) -> str:
    if run_id is not None:
        return os.path.join(base_dir, str(run_id))
    existing = [int(d) for d in os.listdir(base_dir) if d.isdigit()]
    if not existing:
        raise FileNotFoundError(f"no runs under {base_dir!r}")
    return os.path.join(base_dir, str(max(existing)))
