"""Device-truth memory: read the allocator's watermarks, not the model.

The port of ``cylon_tpu/observe/devmem.py``.

  * On a CUDA device :func:`snapshot` reads PyTorch's caching allocator,
    ``torch.cuda.memory_stats(device)``: ``allocated_bytes.all.current``
    (live bytes) and ``allocated_bytes.all.peak`` (the high-water mark
    since the caller last reset it), source ``"memory_stats"``.  It never
    resets the peak itself: whoever measures a window owns that reset
    (``torch.cuda.reset_peak_memory_stats``).
  * On the CPU there are no allocator statistics, so it degrades to
    **portable live-tensor accounting**: the summed bytes of the live
    tensors the garbage collector tracks on that device (source
    ``"live-tensors"``).  Honest caveat, stated rather than hidden: the
    walk sees only tensors Python objects still reference, never the
    transients inside one operator, so an observed exchange delta on the
    CPU is a lower bound (the result block, not the in-flight send and
    receive pair).

:func:`observed_exchange_bytes` turns a before/after snapshot pair into
the observed transient of one exchange window.  Sampling is not on the
production hot path: the shuffle samples only under an active plan
capture (EXPLAIN ANALYZE).
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["DevMemSample", "snapshot", "observed_exchange_bytes"]


@dataclass(frozen=True)
class DevMemSample:
    """One memory reading of one device."""

    live_bytes: int                 # bytes currently allocated / live
    peak_bytes: Optional[int]       # allocator high-water mark (None
    #                                 without allocator statistics)
    source: str                     # "memory_stats" | "live-tensors"


def _live_tensor_bytes(device: torch.device) -> int:
    """Summed bytes of the distinct storages of live tensors on
    ``device`` (the portable fallback; a view shares its base's
    storage, which counts once)."""
    seen = set()
    total = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads ``__class__``, which
        # lazy module proxies answer with deprecation warnings
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if obj.device != device:
                continue
            st = obj.untyped_storage()
            key = st.data_ptr()
            if key in seen:
                continue
            seen.add(key)
            total += int(st.nbytes())
        except Exception:  # graftlint: ok[broad-except]
            # a tensor freed or odd mid-walk: skip it
            continue
    return total


def snapshot(device=None) -> DevMemSample:
    """One reading of ``device`` (default: the current CUDA device when a
    card is present, else the CPU).  Allocator truth on CUDA, live-tensor
    accounting otherwise; bumps ``devmem.samples``."""
    from .. import trace
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    trace.count("devmem.samples")
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        return DevMemSample(int(stats.get("allocated_bytes.all.current", 0)),
                            int(stats.get("allocated_bytes.all.peak", 0)),
                            "memory_stats")
    return DevMemSample(_live_tensor_bytes(device), None, "live-tensors")


def observed_exchange_bytes(before: Optional[DevMemSample],
                            after: Optional[DevMemSample]
                            ) -> Optional[int]:
    """Observed transient of the window between two snapshots.

    With allocator stats: when the high-water mark MOVED inside the
    window, the transient is ``peak_after - live_before`` (the peak was
    set by this window's allocations).  When it did not move, the window
    stayed under some earlier peak: fall back to the live delta, the
    same lower-bound semantics as the CPU path.  Clamped at zero; None
    when either snapshot is missing."""
    if before is None or after is None:
        return None
    if (after.peak_bytes is not None and before.peak_bytes is not None
            and after.peak_bytes > before.peak_bytes):
        return max(after.peak_bytes - before.live_bytes, 0)
    return max(after.live_bytes - before.live_bytes, 0)
