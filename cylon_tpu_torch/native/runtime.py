"""Host-side runtime: string dictionary encoding, murmur3 of raw bytes and
the staging arena of the ingest path.

Mirror of ``cylon_tpu/native/runtime.py`` with its numpy paths only (the
C++ extension is optional there too; reference parity targets:
util/murmur3.cpp for MurmurHash3_x86_32, ctx/memory_pool.hpp:25-66 for
the staging arena).  ``have_native()`` is always False here.

``hash64_strings`` is vectorized: the encoded byte strings are grouped by
length, each group is a ``[m, L]`` byte matrix read as little-endian
uint32 words plus 0-3 tail bytes, and murmur3 runs column by column in
uint32 numpy arithmetic.  ``murmur3_32_bytes`` is the scalar routine it
equals bit for bit.

``StagingArena`` is a bump-pointer host arena.  For a card it holds a
page-locked ``torch.uint8`` block (``spill.pool.pinned_empty``), so the
H2D copies of the blocks it hands out run asynchronously; for the CPU it
is a numpy buffer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def have_native() -> bool:
    return False


# ---------------------------------------------------------------------------
# dictionary encode
# ---------------------------------------------------------------------------

def dictionary_encode(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """values (1-D object/str/bytes array) -> (int32 codes, sorted dictionary).

    Sorted dictionary ⇒ codes preserve lexical order.
    """
    if len(values) == 0:
        return np.empty((0,), np.int32), np.empty((0,), object)
    dictionary, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32).reshape(-1), dictionary


# ---------------------------------------------------------------------------
# murmur3 of byte strings
# ---------------------------------------------------------------------------

_H64_SEED0, _H64_SEED1 = 0x9747B28C, 0x85EBCA6B
_M32 = 0xFFFFFFFF
_C1, _C2 = 0xCC9E2D51, 0x1B873593


def murmur3_32_bytes(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32 of a byte string, one string at a time (the plain
    version ``hash64_strings`` is held to)."""
    M = _M32
    c1, c2 = _C1, _C2
    h = seed & M
    n = len(data)
    for i in range(0, n - n % 4, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & M
        k = ((k << 15) | (k >> 17)) & M
        k = (k * c2) & M
        h ^= k
        h = ((h << 13) | (h >> 19)) & M
        h = (h * 5 + 0xE6546B64) & M
    tail = data[n - n % 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & M
        k = ((k << 15) | (k >> 17)) & M
        k = (k * c2) & M
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M
    return h ^ (h >> 16)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix32(h: np.ndarray) -> np.ndarray:
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _mix_k(k: np.ndarray) -> np.ndarray:
    k = k * np.uint32(_C1)
    k = _rotl32(k, 15)
    return k * np.uint32(_C2)


def _murmur3_rows(mat: np.ndarray, seeds) -> list:
    """MurmurHash3_x86_32 of every row of a ``[m, L]`` uint8 matrix (each
    row one string of L bytes), under each seed: one uint32[m] per seed."""
    m, L = mat.shape
    nw = L // 4
    words = (np.ascontiguousarray(mat[:, :4 * nw]).view("<u4")
             .astype(np.uint32) if nw else None)
    tail = mat[:, 4 * nw:].astype(np.uint32)
    out = []
    with np.errstate(over="ignore"):
        kw = [_mix_k(words[:, j]) for j in range(nw)]
        kt = None
        if L % 4:
            kt = np.zeros(m, np.uint32)
            for b in range(L % 4 - 1, -1, -1):
                kt ^= tail[:, b] << np.uint32(8 * b)
            kt = _mix_k(kt)
        for seed in seeds:
            h = np.full(m, seed & _M32, np.uint32)
            for k in kw:
                h ^= k
                h = _rotl32(h, 13)
                h = h * np.uint32(5) + np.uint32(0xE6546B64)
            if kt is not None:
                h ^= kt
            h ^= np.uint32(L)
            out.append(_fmix32(h))
    return out


def _utf8_buffers(values: np.ndarray):
    """(concatenated bytes uint8, start offsets int64, lengths int64,
    non-null mask) of an object array of str / bytes / None.  Arrays of
    one kind convert in pyarrow's C loop when pyarrow is installed;
    anything else is encoded one value at a time."""
    try:
        import pyarrow as pa
    except ImportError:
        pa = None
    if pa is not None:
        for typ in (pa.large_string(), pa.large_binary()):
            try:
                arr = pa.array(values, type=typ)
            except (pa.ArrowException, TypeError, ValueError):
                continue
            if arr.null_count:
                valid = np.asarray(arr.is_valid().to_numpy(
                    zero_copy_only=False), bool)
            else:
                valid = np.ones(len(arr), bool)
            offs = np.frombuffer(arr.buffers()[1], np.int64)[
                arr.offset:arr.offset + len(arr) + 1]
            data = arr.buffers()[2]
            flat = (np.frombuffer(data, np.uint8) if data is not None
                    else np.zeros(0, np.uint8))
            return flat, offs[:-1], np.diff(offs), valid
    valid = values != None  # noqa: E711 — elementwise on an object array
    enc = [v.encode() if isinstance(v, str) else bytes(v)
           for v in values[valid]]
    lengths = np.zeros(len(values), np.int64)
    lengths[valid] = np.fromiter((len(b) for b in enc), np.int64, len(enc))
    starts = np.zeros(len(values), np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return np.frombuffer(b"".join(enc), np.uint8), starts, lengths, valid


def hash64_strings(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """values (1-D object array of str/bytes/None) → two uint32 murmur3
    lanes under independent seeds — the 64-bit key identity the device
    joins and shuffles on.  ``None`` hashes to (0, 0); callers mask nulls
    through validity.  Strings hash their UTF-8 bytes."""
    values = np.asarray(values, dtype=object).reshape(-1)
    n = len(values)
    h0 = np.zeros(n, np.uint32)
    h1 = np.zeros(n, np.uint32)
    if not n:
        return h0, h1
    flat, starts, lengths, valid = _utf8_buffers(values)
    rows = np.flatnonzero(valid)
    order = rows[np.argsort(lengths[rows], kind="stable")]
    bounds = np.flatnonzero(np.diff(lengths[order])) + 1
    for grp in np.split(order, bounds):
        if not len(grp):
            continue
        L = int(lengths[grp[0]])
        first = int(starts[grp[0]])
        if L and int(starts[grp[-1]]) - first == L * (len(grp) - 1) and \
                bool((np.diff(starts[grp]) == L).all()):
            # back-to-back strings of one length: a view, no gather
            mat = flat[first:first + L * len(grp)].reshape(len(grp), L)
        else:
            mat = (flat[starts[grp][:, None] + np.arange(L)] if L
                   else np.zeros((len(grp), 0), np.uint8))
        h0[grp], h1[grp] = _murmur3_rows(mat, (_H64_SEED0, _H64_SEED1))
    return h0, h1


# ---------------------------------------------------------------------------
# murmur3 of fixed-width words (host version; the device one is ops/hash.py)
# ---------------------------------------------------------------------------

def murmur3_32_u32(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """MurmurHash3_x86_32 of each 4-byte little-endian word, vectorized.

    Matches reference util/murmur3.cpp for len==4 inputs — the case the
    partition kernels use for 32-bit keys.
    """
    k = np.asarray(keys, np.uint32).copy()
    with np.errstate(over="ignore"):
        k = _mix_k(k)
        h = np.full_like(k, np.uint32(seed))
        h ^= k
        h = _rotl32(h, 13)
        h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= np.uint32(4)  # length tail
        return _fmix32(h)


def murmur3_32_u64(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """MurmurHash3_x86_32 of each 8-byte little-endian word (two blocks)."""
    kk = np.asarray(keys, np.uint64)
    lo = (kk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (kk >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(kk.shape, np.uint32(seed))
        for k in (lo, hi):
            h ^= _mix_k(k)
            h = _rotl32(h, 13)
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= np.uint32(8)
        return _fmix32(h)


# ---------------------------------------------------------------------------
# staging arena (host buffers for H2D batches)
# ---------------------------------------------------------------------------

class StagingArena:
    """Bump-pointer host arena for assembling H2D transfer batches.

    reference: ctx/memory_pool.hpp:25-66.  Blocks are 64-byte aligned;
    ``allocate`` raises ``MemoryError`` when the arena is exhausted, and
    ``reset`` hands the whole arena out again (the caller must know that
    nothing still reads the old blocks).  With ``device`` a card the
    arena is one page-locked block (a failed pin raises ``Code.
    OutOfMemory``); otherwise a numpy buffer."""

    def __init__(self, capacity_bytes: int = 64 << 20,
                 device: Optional[torch.device] = None):
        dev = torch.device("cpu") if device is None else torch.device(device)
        if dev.type == "cuda":
            from ..spill.pool import pinned_empty
            self._tensor = pinned_empty((int(capacity_bytes),), torch.uint8,
                                        dev)
            self._buf = self._tensor.numpy()
        else:
            self._buf = np.empty((int(capacity_bytes),), np.uint8)
            self._tensor = torch.from_numpy(self._buf)
        self._off = 0

    @property
    def pinned(self) -> bool:
        return self._tensor.is_pinned()

    def _bump(self, nbytes: int) -> int:
        aligned = (nbytes + 63) & ~63
        if self._off + aligned > self._buf.size:
            raise MemoryError("staging arena exhausted")
        off = self._off
        self._off += aligned
        return off

    def allocate(self, nbytes: int) -> memoryview:
        off = self._bump(int(nbytes))
        return memoryview(self._buf[off:off + int(nbytes)])

    def allocate_tensor(self, nbytes: int) -> torch.Tensor:
        """``allocate`` as a ``torch.uint8`` view of the arena (page-locked
        for a card, so a ``non_blocking`` copy from it is asynchronous)."""
        off = self._bump(int(nbytes))
        return self._tensor[off:off + int(nbytes)]

    def reset(self) -> None:
        self._off = 0

    @property
    def bytes_in_use(self) -> int:
        return self._off
