"""The JAX package's native trajectory store, built once and loaded.

``gan_mpc_tpu/data/native_store.py`` builds ``libtrajstore.so`` with g++
straight into its final path the first time a process asks for it, and a
process whose load fails keeps that failure: from then on every ``.gmts``
read and write through the JAX package raises "native trajstore
unavailable", and its ``trajectories_path`` names an ``.npz`` in place of
the ``.gmts``. In a fresh checkout the library is not there yet, so test
workers that start together race: one loads the library while another's
linker is still writing it (one of six processes started together lost
that race in a test of it).

``ensure()`` builds the library under a lock to a temporary name and
renames it into place, then clears a failure this process kept, so that
the parity tests read the stores through the JAX package whatever ran
first. The parity test modules that read or write ``.gmts`` through the
JAX package call it when they are imported.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile

from gan_mpc_tpu.data import native_store


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def ensure():
    """The loaded library of ``native_store``; built first where it is
    missing or does not load, under an exclusive lock in the temporary
    directory (one per library path). None where g++ cannot build it."""
    if native_store._lib is not None:
        return native_store._lib
    lib_path = os.path.abspath(native_store._LIB)
    name = hashlib.sha256(lib_path.encode()).hexdigest()[:12]
    with open(os.path.join(tempfile.gettempdir(), f"trajstore-{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (os.path.exists(lib_path) and _loads(lib_path)):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            built = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, native_store._SRC,
                 "-lpthread"], capture_output=True)
            if built.returncode != 0:
                return None
            os.replace(tmp, lib_path)
        native_store._lib_load_failed = False
        return native_store.load_library()
