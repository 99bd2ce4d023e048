"""ctypes loader for the native RLE kernels (``rle_ops.c``).

Port of ``openvis_tpu/native/__init__.py``.  The library is compiled with
``cc`` at first use into ``openvis_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded; nothing
is written next to the source.  A failed build raises: the port has no silent
fallback (the pure-Python encoder of ``data/rle.py`` is the plain version the
tests hold the library to).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "rle_ops.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library of ``rle_ops.c`` as it stands now is built."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librle_ops-{digest}.so"


def build() -> Path:
    """Compile ``rle_ops.c`` unless an up-to-date library exists; raises
    ``RuntimeError`` if ``cc`` fails or is missing."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["cc", *CC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run cc to build {_SRC.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed to build {_SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL:
    """The compiled kernels (built at first call)."""
    lib = ctypes.CDLL(str(build()))
    lp = ctypes.POINTER(ctypes.c_long)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rle_encode.restype = ctypes.c_long
    lib.rle_encode.argtypes = [u8p, ctypes.c_long, lp, ctypes.c_long]
    lib.rle_decode.restype = ctypes.c_long
    lib.rle_decode.argtypes = [lp, ctypes.c_long, u8p, ctypes.c_long]
    lib.rle_area.restype = ctypes.c_long
    lib.rle_area.argtypes = [lp, ctypes.c_long]
    lib.rle_intersection_union.restype = None
    lib.rle_intersection_union.argtypes = [lp, ctypes.c_long, lp, ctypes.c_long, lp, lp]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [lp, lp, ctypes.c_long, lp, lp, ctypes.c_long, u8p, dp]
    return lib


def _as_long(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def native_intersection_union(counts_a: np.ndarray, counts_b: np.ndarray) -> Tuple[int, int]:
    ca = np.ascontiguousarray(counts_a, dtype=np.int64)
    cb = np.ascontiguousarray(counts_b, dtype=np.int64)
    inter = ctypes.c_long()
    uni = ctypes.c_long()
    get_lib().rle_intersection_union(
        _as_long(ca), len(ca), _as_long(cb), len(cb), ctypes.byref(inter), ctypes.byref(uni),
    )
    return int(inter.value), int(uni.value)


def native_iou_matrix(
    counts_a: "list[np.ndarray]", counts_b: "list[np.ndarray]",
    iscrowd_b: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pairwise IoU between two lists of RLE count arrays -> (na, nb) f64.
    ``iscrowd_b``: optional bool per b-entry (crowd: union = area(a))."""
    lib = get_lib()
    na, nb = len(counts_a), len(counts_b)
    out = np.zeros((na, nb), np.float64)
    if na == 0 or nb == 0:
        return out
    off_a = np.zeros(na + 1, np.int64)
    off_b = np.zeros(nb + 1, np.int64)
    off_a[1:] = np.cumsum([len(c) for c in counts_a])
    off_b[1:] = np.cumsum([len(c) for c in counts_b])
    flat_a = np.ascontiguousarray(
        np.concatenate([np.asarray(c, np.int64) for c in counts_a])
        if off_a[-1] else np.zeros(0, np.int64))
    flat_b = np.ascontiguousarray(
        np.concatenate([np.asarray(c, np.int64) for c in counts_b])
        if off_b[-1] else np.zeros(0, np.int64))
    crowd = (np.ascontiguousarray(iscrowd_b, np.uint8) if iscrowd_b is not None
             else np.zeros(nb, np.uint8))
    lib.rle_iou_matrix(
        _as_long(flat_a), _as_long(off_a), na, _as_long(flat_b), _as_long(off_b), nb,
        crowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def native_encode_flat(flat: np.ndarray) -> np.ndarray:
    """Run lengths of a mask already flattened in column-major order."""
    flat = np.ascontiguousarray(flat, dtype=np.uint8).reshape(-1)
    out = np.empty(flat.size + 2, dtype=np.int64)
    k = get_lib().rle_encode(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size,
                             _as_long(out), out.size)
    if k < 0:  # cannot happen: a mask of n pixels has at most n + 1 runs
        raise RuntimeError("rle_encode overflowed its output")
    return out[:k]


def native_encode(mask: np.ndarray) -> np.ndarray:
    """(H, W) binary mask -> run lengths, column-major, starting with 0s."""
    return native_encode_flat(np.asarray(mask).reshape(-1, order="F"))


def native_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    ca = np.ascontiguousarray(counts, dtype=np.int64)
    flat = np.empty(h * w, dtype=np.uint8)
    rc = get_lib().rle_decode(_as_long(ca), len(ca),
                              flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size)
    if rc != 0:
        raise ValueError(f"run lengths cover more than the {h}x{w} mask")
    return flat.reshape((h, w), order="F")
