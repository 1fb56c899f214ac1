"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` into a shared library and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in
``gan_mpc_tpu_torch/_build/`` under a name keyed by a hash of the source,
the shared device headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.
Nothing here runs at import time: the first CUDA call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source, headers and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists.

    Raises RuntimeError when nvcc is missing or the compile fails. The
    compiler's output (ptxas register and shared-memory report included)
    is kept beside the library as ``.log``.
    """
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build_libraries(names) -> list:
    """Build several kernels at once, one nvcc process each; the paths in
    the order of ``names``. Raises as ``build_library`` does."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(build_library, n) for n in names]
        return [f.result() for f in futures]


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
