"""Structured metrics and phase timing.

Counterpart of ``gan_mpc_tpu/utils/metrics.py``: an append-only JSONL
recorder with in-memory history and phase timers, the planner's
convergence statistics, and a profiler trace of a code region
(``torch.profiler`` here, ``jax.profiler`` there).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class MetricsRecorder:
    def __init__(self, path: Optional[str] = None):
        self._path = path
        self.history: Dict[str, list] = defaultdict(list)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fp = open(path, "a")
        else:
            self._fp = None

    def record(self, step: int, **values) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in values.items():
            v = float(v) if hasattr(v, "__float__") else v
            row[k] = v
            self.history[k].append((step, v))
        if self._fp:
            self._fp.write(json.dumps(row) + "\n")
            self._fp.flush()

    @contextlib.contextmanager
    def timed(self, name: str, step: int = 0):
        """Phase timer: records ``<name>_seconds``."""
        t0 = time.perf_counter()
        yield
        self.record(step, **{f"{name}_seconds": time.perf_counter() - t0})

    def latest(self, name: str):
        return self.history[name][-1][1] if self.history[name] else None

    def close(self):
        if self._fp:
            self._fp.close()


def solver_stats(solution) -> dict:
    """The planner's convergence diagnostics of an ``ILQRSolution``."""
    its = torch.atleast_1d(solution.iterations).float()
    conv = torch.atleast_1d(solution.converged).float()
    return {
        "ilqr_iterations_mean": float(its.mean()),
        "ilqr_iterations_max": float(its.max()),
        "ilqr_converged_frac": float(conv.mean()),
        "ilqr_obj_mean": float(torch.atleast_1d(solution.obj).mean()),
    }


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the block (the card's kernels too,
    where there is one), written to ``logdir/trace.json``; nothing when
    ``logdir`` is None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
