"""The shuffle's send side on the card: fused murmur3 row hash → partition id.

CUDA counterpart of the JAX package's Pallas kernel
(``cylon_tpu/ops/hash_pallas.py``): ``csrc/partition_hash.cu`` computes
``partition_ids(row_hash(cols, validities), nparts)`` of ``ops/hash.py``
bit for bit, in one pass over the key columns.

The source is compiled with ``nvcc`` into a shared library with a plain C
interface the first time a CUDA tensor reaches ``partition_ids_fused``, and
loaded with ctypes; the build goes under ``build/cylon_tpu_torch/`` at the
root of the checkout.  Importing this module builds nothing.

A launch takes at most ``MAX_KEY_COLS`` key columns.  More columns hash
in groups of ``MAX_KEY_COLS``, launched in order on the current stream
through the kernel's chained entry: each group starts every row from the
running hash the group before wrote, and the last group writes the ids.
The combine ``h = 31*h + col_hash`` chains, so the ids are bit for bit
the single pass's.  The plain version takes any number of columns.

``launches`` counts kernel launches (a chained call counts each group);
``launches_chained`` counts the launches made by chained calls.  CPU calls
(the plain version) count neither.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..status import Code, CylonError, Status
from . import hash as plain_hash

MAX_KEY_COLS = 16     # key columns of one launch (csrc CYLON_MAX_KEY_COLS)

# must match the enum in csrc/partition_hash.cu
_DTYPE_CODE = {
    torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3,
    torch.uint16: 4, torch.int32: 5, torch.uint32: 6, torch.int64: 7,
    torch.uint64: 8, torch.float16: 9, torch.float32: 10, torch.float64: 11,
}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "partition_hash.cu"
BUILD_DIR = _PKG.parent / "build" / "cylon_tpu_torch"
LIBRARY = BUILD_DIR / "libpartition_hash.so"

launches = 0          # kernel launches since the last reset (set it to 0)
launches_chained = 0  # of those, launches of chained (k > 16) calls
# the same launches by partition count (clear it with ``launches``)
launches_by_nparts: dict = {}
build_log = ""        # nvcc's output (with -Xptxas -v) from this process's build

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise CylonError(Status(Code.ExecutionError,
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "cannot build the partition-hash kernel"))


def build() -> Path:
    """Compile the kernel (every call) and return the library's path."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        raise CylonError(Status(Code.ExecutionError,
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{build_log}"))
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load():
    """Build (once per process) and load the kernel library.  The build
    and load is one ``observe.compile`` build event (``compile.builds``,
    a ``compile.build`` span, charged to an open EXPLAIN ANALYZE); a
    library already loaded in this process is a ``compile.cache_hits``."""
    global _lib
    from .. import trace
    from ..observe import compile as obcompile
    with _lib_lock:
        if _lib is not None:
            trace.count("compile.cache_hits")
        else:
            key = (SOURCE.name, "sm_90a")
            obcompile.note_build("hash_cuda.load", key)
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build()))
            fn = lib.cylon_partition_hash
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                           ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            chained = lib.cylon_partition_hash_chained
            chained.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int32, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_void_p,
                                ctypes.c_int32, ctypes.c_void_p,
                                ctypes.c_void_p]
            chained.restype = ctypes.c_int
            _lib = lib
            obcompile.record_build("hash_cuda.load", key,
                                   (time.perf_counter() - t0) * 1e3, t0)
    return _lib


def _check(cols: Sequence[torch.Tensor],
           validities: Sequence[Optional[torch.Tensor]], nparts: int):
    if not cols or len(cols) != len(validities):
        raise CylonError(Status(Code.Invalid,
            "partition_ids_fused: need one validity (or None) per key column"))
    if int(nparts) < 1:
        raise CylonError(Status(Code.Invalid,
            f"partition_ids_fused: nparts must be >= 1, got {nparts}"))
    n = cols[0].shape[0]
    dev = cols[0].device
    for c, v in zip(cols, validities):
        if c.device != dev or (v is not None and v.device != dev):
            raise CylonError(Status(Code.Invalid,
                "partition_ids_fused: key columns on different devices"))
        if c.dim() != 1 or c.shape[0] != n:
            raise CylonError(Status(Code.Invalid,
                f"partition_ids_fused: key columns must be 1-D of {n} rows"))
        if v is not None and (v.dtype != torch.bool or v.shape != c.shape):
            raise CylonError(Status(Code.Invalid,
                "partition_ids_fused: validity must be bool of the column's "
                "shape"))
    return n, dev


def partition_ids_fused(cols: Sequence[torch.Tensor],
                        validities: Sequence[Optional[torch.Tensor]],
                        nparts: int) -> torch.Tensor:
    """``partition_ids(row_hash(cols, validities), nparts)`` as int32[n].

    CPU tensors take the plain version (ops/hash.py), for any number of
    key columns.  CUDA tensors launch the kernel on the current stream
    (one launch per group of ``MAX_KEY_COLS`` columns), or raise.
    """
    n, dev = _check(cols, validities, nparts)
    if dev.type == "cpu":
        return plain_hash.partition_ids(plain_hash.row_hash(cols, validities),
                                        nparts)
    if dev.type != "cuda":
        raise CylonError(Status(Code.NotImplemented,
            f"partition_ids_fused: no kernel for device {dev}"))
    for c, v in zip(cols, validities):
        if c.dtype not in _DTYPE_CODE:
            raise CylonError(Status(Code.TypeError,
                f"partition_ids_fused: unsupported key dtype {c.dtype}"))
        if not c.is_contiguous() or (v is not None and not v.is_contiguous()):
            raise CylonError(Status(Code.Invalid,
                "partition_ids_fused: key columns must be contiguous"))
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load()
    k = len(cols)
    groups = [range(g, min(g + MAX_KEY_COLS, k))
              for g in range(0, k, MAX_KEY_COLS)]
    # the groups alternate between two buffers so no launch reads the
    # buffer it writes; the parity puts the last group's write in ``out``
    spare = (torch.empty(n, dtype=torch.int32, device=dev)
             if len(groups) > 1 else None)
    prev = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for j, grp in enumerate(groups):
            data = (ctypes.c_void_p * len(grp))(
                *[cols[c].data_ptr() for c in grp])
            valid = (ctypes.c_void_p * len(grp))(
                *[0 if validities[c] is None else validities[c].data_ptr()
                  for c in grp])
            codes = (ctypes.c_int32 * len(grp))(
                *[_DTYPE_CODE[cols[c].dtype] for c in grp])
            if len(groups) == 1:
                rc = lib.cylon_partition_hash(data, valid, codes, len(grp),
                                              n, int(nparts), out.data_ptr(),
                                              stream)
            else:
                dst = out if (len(groups) - 1 - j) % 2 == 0 else spare
                rc = lib.cylon_partition_hash_chained(
                    data, valid, codes, len(grp), n, int(nparts),
                    None if prev is None else prev.data_ptr(),
                    int(j == len(groups) - 1), dst.data_ptr(), stream)
                prev = dst
            if rc != 0:
                raise CylonError(Status(Code.ExecutionError,
                    f"partition-hash kernel launch failed: cudaError {rc}"))
            _count(nparts, chained=len(groups) > 1)
    return out


def _count(nparts: int, chained: bool) -> None:
    global launches, launches_chained
    launches += 1
    if chained:
        launches_chained += 1
    launches_by_nparts[int(nparts)] = \
        launches_by_nparts.get(int(nparts), 0) + 1
