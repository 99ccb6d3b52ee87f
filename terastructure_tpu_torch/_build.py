"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled at first use with nvcc for
sm_90a, one nvcc process per source, all started together, and linked
into one shared library with a plain C interface, loaded with ctypes.
The library lands in `_build/` under a name keyed by a hash of the
sources and flags, so an edited source builds anew and an unchanged one
is reused. Tensor pointers (`data_ptr()`) and the current CUDA
stream are passed as `c_void_p`; every C entry point returns
`cudaGetLastError()`, which `check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry points: name -> argtypes (all return int, the CUDA error code).
SIGNATURES = {
    # out, src, starts, n_blocks, block_bytes, stream
    "tt_gather_row_blocks": [_P, _P, _P, _L, _L, _P],
    # R, rows, u_planes, t1, t0, l0, l1, part, B, W, K, nsplit, approx,
    # rows_stride, stream (R replicates, rows_stride bytes apart, 0 shared)
    "tt_lambda_stats_packed": [_I] + [_P] * 7 + [_I] * 5 + [_L, _P],
    # R, rows, u_planes, lamb_init, lamb_out, g_out, lam, mid, t, part,
    # dpart, active, gpart, B, W, K, nsplit_w, nsplit_b, local_iters,
    # local_tol, beta_a, beta_b, warm_start, approx_div, accel, stream
    "tt_fused_local_solve": [_I] + [_P] * 12 + [_I] * 6 + [_F] * 3
                            + [_I] * 3 + [_P],
    # idx0, packed, L, group, then as tt_fused_local_solve from u_planes
    "tt_fused_local_solve_dma": [_P, _P, _L, _I] + [_P] * 11 + [_I] * 6
                                + [_F] * 3 + [_I] * 3 + [_P],
    # the bf16 bodies of K4, K1 and K2: the same arguments and, after part
    # (K4) or gpart (K1, K2), the scratch of the rounded u (ub) and t (tb)
    "tt_lambda_stats_packed_bf16": [_I] + [_P] * 8 + [_I] * 5 + [_L, _P],
    "tt_fused_local_solve_bf16": [_I] + [_P] * 14 + [_I] * 6 + [_F] * 3
                                 + [_I] * 3 + [_P],
    "tt_fused_local_solve_dma_bf16": [_P, _P, _L, _I] + [_P] * 13 + [_I] * 6
                                     + [_F] * 3 + [_I] * 3 + [_P],
    # R, a1, a0, u_planes, t1, t0, l0, l1, part, B, W, K, nsplit, approx,
    # stream (R replicates, every array R x the single call's); bf16: ub
    # after part
    "tt_lambda_stats_acat": [_I] + [_P] * 8 + [_I] * 5 + [_P],
    "tt_lambda_stats_acat_bf16": [_I] + [_P] * 9 + [_I] * 5 + [_P],
    # R, rows, u_planes, t1, t0, g, gpart, B, W, K, nsplit, stream; bf16:
    # tb after gpart
    "tt_gamma_stats_packed": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    "tt_gamma_stats_packed_bf16": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    # lo, hi (float bit patterns), bad (one uint64), stream: the bf16
    # passes' exact reciprocal checked against the IEEE one
    "tt_rcp_rn_check": [ctypes.c_uint, ctypes.c_uint, _P, _P],
    # R, rows, u_planes, t1, t0, l0, l1, g, lpart, gpart, B, W, K,
    # tile_rows, tile_cols, approx, stream
    # (K6 calls it at approx 0)
    "tt_batch_stats_fused_v2": [_I] + [_P] * 9 + [_I] * 6 + [_P],
    # the bf16 bodies of K7 and K6: the same arguments
    "tt_batch_stats_fused_v2_bf16": [_I] + [_P] * 9 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None       # wall time of the nvcc run, None if reused
source_seconds = {}        # source -> seconds until its nvcc finished


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hash-named library unless it exists.
    The ptxas report (registers, spills) is kept beside it as .log.
    Processes that start at once (the ranks of a multi-card fit) build
    it once: the first takes a file lock, the others wait on it and find
    the library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return so if so.exists() else _build(so)


def _build(so: Path) -> Path:
    global build_seconds
    cu, _ = _sources()
    nvcc = _nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in cu]
    t0 = time.time()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                               "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for p, o in zip(cu, objs)]
    # drain each process in its own thread, so that each source's time is
    # read when its nvcc ends (ptxas -v fills the pipes)
    outs = [None] * len(procs)

    def drain(i):
        outs[i] = procs[i].communicate()
        source_seconds[cu[i].name] = time.time() - t0

    threads = [threading.Thread(target=drain, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logs, failed = [], []
    for p, proc, (out, err) in zip(cu, procs, outs):
        logs.append(f"== {p.name} ({source_seconds[p.name]:.1f} s)\n"
                    f"{out}{err}")
        if proc.returncode:
            failed.append(f"{p.name} ({proc.returncode}):\n{err[-4000:]}")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    build_seconds = time.time() - t0
    so.with_suffix(".log").write_text("\n".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Once loaded it is
    returned without taking the lock: every kernel launch calls this."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    """The device's current CUDA stream as an int, from torch's raw query:
    `torch.cuda.current_stream` makes a Stream object a call (~5 µs)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


_sm90 = {}                 # device -> whether it runs sm_90a code


def require_cuda(name: str, *tensors, dtypes) -> None:
    """Validate device, dtype and contiguity of a kernel's inputs. The
    device's compute capability is asked once per device."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    ok = _sm90.get(dev)
    if ok is None:
        ok = _sm90[dev] = torch.cuda.get_device_capability(dev)[0] >= 9
    if not ok:
        raise RuntimeError(f"{name}: the kernels are built for sm_90a")
