"""One process per rank: the port's stand-in for JAX's one process that
sees many devices.

``spawn(fn, devices, args)`` starts ``len(devices)`` processes with the
``spawn`` method (CUDA does not survive ``fork``), joins them into one
process group and calls ``fn(device, *args)`` in each, the same call on
every rank (SPMD). It returns what rank 0's call returns, or raises what
a rank raised (rank 0's first), the rank's traceback attached as a note.

Each rank is a fresh interpreter, so it redoes the process-wide setup:
``torch.cuda.set_device`` for a CUDA rank, ``pin_fp32``, one intra-op
thread for a CPU rank (several ranks share the host), and the kernel
libraries loaded before the group forms (``ops/_build.py`` builds them
safely across processes). The rendezvous is a file in a temporary
directory, not a TCP port, so that concurrent launches on one host
cannot collide; gloo's pair sockets are on the loopback device unless
``GLOO_SOCKET_IFNAME`` says otherwise. Every collective raises after
``timeout`` seconds instead of hanging, and once a rank has failed the
others are stopped after a grace of a few seconds.

``fn`` and ``args`` are pickled by import path: ``fn`` is a module-level
function and ``args`` plain data (configs as dicts, paths, numpy
arrays), never live CUDA objects.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gan_mpc_tpu_torch.parallel.mesh import backend_for

DEFAULT_TIMEOUT = 7200.0  # seconds a collective may wait (rank 0 training an expert, say)
FAILURE_GRACE = 10.0  # seconds the other ranks get to stop by themselves after a failure


class RankFailed(RuntimeError):
    """A rank raised something that could not be sent back as it was."""


def spawn(fn: Callable, devices: Sequence, args: tuple = (), timeout: float = None):
    """``fn(device, *args)`` on one rank per entry of ``devices`` (e.g.
    ``["cuda:0", "cuda:1"]``, or ``["cpu", "cpu"]``; "cuda" is this
    process's current card); rank 0's result."""
    devices = rank_devices(devices)
    timeout = DEFAULT_TIMEOUT if timeout is None else float(timeout)
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="gan_mpc_ranks_")
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, devices, workdir, timeout, fn, args))
                 for rank in range(len(devices))]
        for p in procs:
            p.start()
        _join(procs)
        outcomes = [_read(os.path.join(workdir, f"rank{r}.pkl"), p.exitcode)
                    for r, p in enumerate(procs)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    failed = [o for o in outcomes if o[0] != "ok"]
    if failed:
        raise failed[0][1]
    return outcomes[0][1]


def rank_devices(devices) -> list:
    """``devices`` as strings, each "cuda" without an index resolved to this
    process's current card (a spawned rank's current card is cuda:0)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(str(d))
    return out


def _join(procs) -> None:
    """Wait for every rank; once one has failed, give the others
    ``FAILURE_GRACE`` seconds, then stop them."""
    failed_at = None
    while any(p.is_alive() for p in procs):
        if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > FAILURE_GRACE:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        time.sleep(0.05)
    for p in procs:
        p.join()


def _read(path: str, exitcode):
    if not os.path.exists(path):
        return ("error", RankFailed(f"a rank exited with code {exitcode} and no result"))
    # a spawned rank imports the launching script as __mp_main__: its
    # classes come back under that name
    sys.modules.setdefault("__mp_main__", sys.modules["__main__"])
    with open(path, "rb") as f:  # written by the rank this launch started
        try:
            return pickle.load(f)
        except Exception as e:  # the rank's exception type does not import here
            return ("error", RankFailed(f"a rank's result could not be read back: {e!r}"))


def _rank_main(rank: int, devices, workdir: str, timeout: float, fn, args) -> None:
    """A rank's body: set up the process, join the group, run ``fn``,
    write its outcome (``("ok", result)`` on rank 0, ``("ok", None)``
    elsewhere, or ``("error", exception)``) for the launcher."""
    outcome = ("error", RankFailed("the rank stopped before its result"))
    try:
        device = torch.device(devices[rank])
        _setup_process(device)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        backend = backend_for(devices)
        # NCCL binds the rank to its card (else it guesses the card by rank)
        dist.init_process_group(backend,
                                init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                                world_size=len(devices), rank=rank,
                                timeout=datetime.timedelta(seconds=timeout),
                                device_id=device if backend == "nccl" else None)
        try:
            result = fn(device, *args)
        finally:
            dist.destroy_process_group()
        outcome = ("ok", result if rank == 0 else None)
    except BaseException as e:  # sent back to the launcher, which raises it
        note = f"on rank {rank}:\n{traceback.format_exc()}"
        if hasattr(e, "add_note"):
            e.add_note(note)
        outcome = ("error", e)
    path = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        blob = pickle.dumps(outcome)
    except Exception as e:  # an unpicklable result or exception
        blob = pickle.dumps(("error", RankFailed(f"rank {rank}: {outcome[1]!r} ({e!r})")))
    with open(path + ".tmp", "wb") as f:
        f.write(blob)
    os.replace(path + ".tmp", path)


def _setup_process(device: torch.device) -> None:
    from gan_mpc_tpu_torch import pin_fp32

    pin_fp32()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_kernel
        from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_backward, fused_mlp_forward

        for kernel in (fused_mlp_forward, fused_mlp_backward, fused_ls_kernel):
            kernel.load()
    else:
        torch.set_num_threads(1)


def rank_log(log_fn, mesh):
    """``log_fn`` on rank 0 only, as a log function every rank calls at
    the same points: an exception ``log_fn`` raises on rank 0 stops every
    rank there (the others raise ``RankFailed``), so that a caller can
    interrupt a run at a log line. None for None."""
    if log_fn is None:
        return None

    def log(msg):
        error = None
        if mesh.rank == 0:
            try:
                log_fn(msg)
            except BaseException as e:  # re-raised below, once every rank knows
                error = e
        if mesh.size > 1 and mesh.broadcast_object(error is not None):
            if error is None:
                raise RankFailed(f"rank 0's log function raised at {msg!r}")
        if error is not None:
            raise error

    return log
