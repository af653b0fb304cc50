"""Mask → index compaction with a static output capacity.

Mirror of ``cylon_tpu/ops/compact.py``.  Data-dependent output sizes follow
a synchronous two-phase protocol: phase 1 computes the exact row counts on
the device, the host reads them and rounds them up to a size-class bucket
(``next_bucket``), and phase 2 materializes into that capacity.  Compaction
produces a fixed-capacity index vector padded with a fill value plus a
valid count, so capacities (and the layout of distributed blocks) match
the JAX package's exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def read_host(t: torch.Tensor) -> np.ndarray:
    """The host's blocking read of a device count tensor (the sync-floor
    unit): counted as ``host.read``."""
    from .. import trace
    trace.count("host.read")
    return t.cpu().numpy()


def read_counts(t: torch.Tensor) -> np.ndarray:
    """The shuffle's blocking count read: :func:`read_host` behind the
    ``compact.read_counts`` fault point, retried under the session
    ``resilience`` policy (the read has no side effect, so a transient
    transfer failure is safely retried).  One ``host.read`` however many
    attempts."""
    from .. import faults, resilience, trace
    trace.count("host.read")

    def attempt():
        faults.check("compact.read_counts")
        return t.cpu().numpy()

    return resilience.retry_call(attempt, point="compact.read_counts")


def scatter_drop(size: int, tgt: torch.Tensor, values: torch.Tensor,
                 fill=0, dtype=None) -> torch.Tensor:
    """``full(size, fill).at[tgt].set(values, mode="drop")``: targets outside
    ``[0, size)`` are dropped (torch would raise, or assert on the card)."""
    dtype = values.dtype if dtype is None else dtype
    out = torch.full((size + 1,), fill, dtype=dtype, device=values.device)
    tgt = tgt.to(torch.int64)
    tgt = torch.where((tgt >= 0) & (tgt < size), tgt, size)
    out.scatter_(0, tgt, values.to(dtype))
    return out[:size]


def compact_indices(mask: torch.Tensor, size: int, fill: int = -1) -> torch.Tensor:
    """Indices of True entries in order, padded with ``fill`` to ``size``
    (int32); entries past ``size`` are dropped."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask, pos, size)
    return scatter_drop(size, tgt,
                        torch.arange(n, dtype=torch.int32, device=mask.device),
                        fill=fill)


def mask_to_indices(mask: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of True entries, padded with −1 to ``capacity``; plus count."""
    idx = compact_indices(mask, capacity, fill=-1)
    return idx, torch.sum(mask).to(torch.int32)


def pad_to(x: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    """Right-pad axis 0 to ``capacity`` with ``fill``."""
    n = x.shape[0]
    if n == capacity:
        return x
    if n > capacity:
        raise ValueError(f"cannot pad length {n} into capacity {capacity}")
    pad = torch.full((capacity - n,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def next_bucket(n: int, minimum: int = 1024) -> int:
    """Round a dynamic size up to a quarter-step size-class bucket
    (2^k · {4,5,6,7}/4 — ≤25% padding overhead vs ≤100% for pure powers
    of two).  Identical to the JAX package's rule, so capacities match.
    """
    cap = max(int(n), minimum)
    pow2 = 1 << (cap - 1).bit_length()
    for num in (5, 6, 7):  # 2^(k-1)·{1.25, 1.5, 1.75}
        q = (pow2 // 8) * num
        if q >= cap:
            return q
    return pow2
