"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; it may
include the ``csrc/*.cuh`` headers.  It is compiled at first use for Hopper
(``sm_90a``) into ``openvis_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name that carries a hash of the source, the headers and the flags, so
an edited source or header is rebuilt and a stale library is never loaded.
Only sources in this repository are built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# what each build printed (ptxas register / shared-memory report) and took
build_logs: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` as it stands now is built."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    build_logs[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return lib


def build_all(names: Sequence[str]) -> None:
    """Compile several sources at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
