"""ctypes bindings for the native ingest core, `bedops.cpp` (port of
terastructure_tpu/native).

The library is built at first use with g++ (the reference's flags) into
the git-ignored `_build/`, under a name keyed by a hash of the source,
the flags and what `-march=native` means on this host, so an edited
source, or a checkout copied to another CPU, builds anew. A failed build
raises: nothing falls back to numpy behind the caller's back. The numpy
versions (data/pack.py, data/bed.py's LUT) stay as the twins that
`native=False` selects.

Nothing here runs at import time. ctypes releases the GIL for the
length of each call, so a gather in a worker thread leaves the caller's
thread running.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "bedops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread"]

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
SIGNATURES = {
    "bed_translate": [_P, _P, _I64, _I],
    "pack2bit": [_P, _P, _I64, _I64],
    "unpack2bit": [_P, _P, _I64, _I64, _I64],
    "gather_groups": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64],
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The hash-named library for this source, these flags and this
    host's -march=native: the target options the g++ driver expands it to
    (`-###` prints them; its temporary file names are left out)."""
    driver = subprocess.run(
        ["g++", *FLAGS, "-###", "-x", "c++", "-c", "-", "-o", os.devnull],
        input="", capture_output=True, text=True, check=True).stderr
    target = sorted(set(re.findall(r"(?<!\S)(?:-m|--param)\S*", driver)))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(" ".join(target).encode())
    return BUILD_DIR / f"libbedops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile bedops.cpp unless the hash-named library exists; raise
    RuntimeError with g++'s message if it fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # processes that start at once (the ranks of a multi-card fit) build
    # it once: the others wait on the lock and find the library
    with open(BUILD_DIR / "bedops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return so if so.exists() else _compile(so)


def _compile(so: Path) -> Path:
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC.name}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = handle
    return _lib


def bed_translate(raw: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Translate PLINK-coded packed bytes to our code space (or back)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty_like(raw)
    lib().bed_translate(raw.ctypes.data, out.ctypes.data, raw.size,
                        int(inverse))
    return out


def pack2bit(x: np.ndarray) -> np.ndarray:
    """(rows, n) int8 genotypes -> (rows, ceil(n/4)) packed bytes."""
    x = np.ascontiguousarray(x, dtype=np.int8)
    rows, n = x.shape
    out = np.empty((rows, (n + 3) // 4), dtype=np.uint8)
    lib().pack2bit(x.ctypes.data, out.ctypes.data, rows, n)
    return out


def unpack2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """(rows, w) packed bytes -> (rows, n) int8 genotypes."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    rows, w = packed.shape
    if n > 4 * w:
        raise ValueError(f"n={n} exceeds capacity of {w} bytes")
    out = np.empty((rows, n), dtype=np.int8)
    lib().unpack2bit(packed.ctypes.data, out.ctypes.data, rows, w, n)
    return out


def gather_groups(packed: np.ndarray, starts: np.ndarray, g: int,
                  out: np.ndarray) -> None:
    """Copy len(starts) groups of g consecutive rows (wrapping at L) of a
    C-contiguous packed (L, W) matrix (an ndarray or np.memmap) into out
    (len(starts) * g, Wp >= W), threaded memcpy. Columns [W, Wp) of `out`
    are left untouched."""
    l, w = packed.shape
    wp = out.shape[1]
    if (packed.dtype != np.uint8 or out.dtype != np.uint8
            or not packed.flags.c_contiguous or not out.flags.c_contiguous
            or out.shape[0] != len(starts) * g or wp < w):
        raise ValueError("gather_groups: bad buffer shapes/contiguity")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if len(starts) and (starts.min() < 0 or starts.max() >= l):
        raise ValueError("gather_groups: group start out of range")
    lib().gather_groups(packed.ctypes.data, l, w, starts.ctypes.data,
                        len(starts), g, out.ctypes.data, wp)
