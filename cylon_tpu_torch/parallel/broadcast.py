"""Replicated small tables: one all_gather in place of a shuffle.

Mirror of ``cylon_tpu/parallel/broadcast.py``'s ``rows_if_small`` and
``replicate_table``.  ``replicate_table`` gathers every leaf of a
(collapsed) DTable through the communicator's ``all_gather``, drops the
per-shard padding, and packs the rows into one block bucketed by
``next_bucket`` that every shard holds.  The counts say which shards own
the rows:

  ALL   ``counts[i] = total`` on every shard (the broadcast-join probe
        form);
  HEAD  ``counts = [total, 0, …]``: every shard holds the rows but only
        shard 0's copy is valid, so nothing is counted twice (the
        groupby's combine form).

``rows_if_small`` is the planner predicate: an upper bound on the rows
when it is at most the threshold and the replica fits the memory budget,
read from ingest-cached counts or else the capacity bound ``P * cap``,
never from the device.  The JAX package's replica cache (keyed by the
small side's array identity) belongs to the broadcast joins and is not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import broadcast_join_threshold, device_memory_budget
from ..ops import compact as ops_compact
from ..ops.gather import signed_view
from .dtable import DColumn, DTable

ALL = "all"
HEAD = "head"


def _row_bytes(leaves) -> int:
    """Payload width of one row across the leaves (validity = 1 byte)."""
    return sum(lf.element_size() for lf in leaves)


def price_replicate(nparts: int, cap: int, outcap: int, rbytes: int) -> int:
    """Peak bytes of a replica: the all-gathered [P·cap] blocks plus the
    compacted [outcap] replica (the JAX package's ``cost.price_replicate``
    ``peak_bytes``)."""
    return int((nparts * cap + outcap) * rbytes)


def rows_if_small(dt: DTable, threshold: Optional[int]) -> Optional[int]:
    """Global-row upper bound if ``dt`` provably holds ≤ ``threshold`` rows
    AND its replica fits the memory budget, else None — with no device
    read.  ``threshold`` None reads the process-wide knob; ≤ 0 disables."""
    if threshold is None:
        threshold = broadcast_join_threshold()
    if threshold <= 0:
        return None
    ch = dt._counts_host
    if ch is not None and dt.pending_mask is None:
        n = int(ch.sum())
        rows = n if n <= threshold else None
    else:
        bound = dt.nparts * dt.cap
        rows = bound if bound <= threshold else None
    if rows is None:
        return None
    rbytes = max(_row_bytes([lf for c in dt.columns
                             for lf in (c.data, c.validity)
                             if lf is not None]), 1)
    outcap = ops_compact.next_bucket(max(rows, 1), minimum=8)
    if price_replicate(dt.nparts, dt.cap, outcap, rbytes) \
            > device_memory_budget(dt.ctx.device):
        return None
    return rows


def replicate_table(dt: DTable, mode: str = ALL) -> DTable:
    """Gather ``dt``'s rows into a replicated DTable: every shard's block
    holds all rows, in shard order.  ``dt`` must carry no pending mask
    (callers collapse first).  Schema, dictionaries and column order are
    kept, so the result drops into any per-shard kernel."""
    if dt.pending_mask is not None:
        raise ValueError("replicate_table: collapse the pending mask first")
    if mode not in (ALL, HEAD):
        raise ValueError(f"replicate_table: unknown mode {mode!r}")
    comm = dt.ctx.comm
    P, cap = dt.nparts, dt.cap
    ch = dt._counts_host
    total_bound = int(ch.sum()) if ch is not None else P * cap
    outcap = ops_compact.next_bucket(max(total_bound, 1), minimum=8)
    gcnts = comm.all_gather(dt.counts)                                # [P]
    valid = (torch.arange(cap, device=gcnts.device)[None, :]
             < gcnts[:, None]).reshape(-1)
    idx = ops_compact.compact_indices(valid, outcap, fill=0).long()
    total = torch.sum(gcnts).to(torch.int32)
    keep = torch.arange(outcap, device=gcnts.device) < total

    def gather(leaf: torch.Tensor) -> torch.Tensor:
        g = comm.all_gather(signed_view(leaf).view(P, cap)).reshape(-1)
        block = torch.where(keep, g[idx], 0).to(g.dtype)
        return block.repeat(P).view(leaf.dtype)      # one copy per shard

    cols = [DColumn(c.name, c.dtype, gather(c.data),
                    None if c.validity is None else gather(c.validity),
                    c.dictionary, c.arrow_type)
            for c in dt.columns]
    if mode == HEAD:
        counts = torch.cat([total.reshape(1),
                            torch.zeros(P - 1, dtype=torch.int32,
                                        device=total.device)])
    else:
        counts = total.reshape(1).repeat(P)
    return DTable(dt.ctx, cols, outcap, counts)
