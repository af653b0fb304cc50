"""Row shuffle: the single-shot two-phase all_to_all exchange.

Mirror of the single-shot path of ``cylon_tpu/parallel/shuffle.py``
(``_counts_fn``, ``_exchange_fn`` and ``shuffle_leaves``; reference:
cpp/src/cylon/table_api.cpp:214-297 Shuffle — HashPartition + split +
AllToAll + concat).  Both phases run batched over the P shards of a
DTable's flat ``[P*cap]`` leaves, and reach the other ranks only through
the context's communicator:

  1. counts    per-shard ``bincount`` of the target ids → ``[P_src, P_dst]``
               (gathered to every rank), read by the host to size the
               exchange (``block`` = largest cell, ``outcap`` = largest
               receive total, both bucketed by ``next_bucket``);
  2. exchange  per shard: rows grouped by target (stable sort), gathered
               into a ``[P_dst, block]`` send buffer, one ``all_to_all``,
               then the received rows compacted into ``[outcap]``.

Rows keep sender order within a target, and senders arrive in rank order,
so every shard's output rows come out in the same order as the JAX
package's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..analysis import plan_check
from ..observe import devmem
from ..observe.metrics import row_bytes
from ..ops import gather as ops_gather
from ..ops.compact import next_bucket, read_host


def exchange_sizes(counts: np.ndarray) -> Tuple[int, int, np.ndarray]:
    """counts [P, P] → (block, outcap, per_recv), the single-shot sizing
    rule of the JAX package (parallel/cost.py exchange_sizes)."""
    block = next_bucket(max(int(counts.max(initial=0)), 1), minimum=8)
    per_recv = counts.sum(axis=0)
    outcap = next_bucket(max(int(per_recv.max(initial=0)), 1), minimum=8)
    return block, outcap, per_recv


def _shard_offsets(P: int, cap: int, device) -> torch.Tensor:
    """[P*cap] shard id of every flat row, times ``P + 1`` (bincount bins)."""
    return torch.arange(P, device=device).repeat_interleave(cap) * (P + 1)


def _counts(comm, pid: torch.Tensor) -> torch.Tensor:
    """pid [P*cap] → counts [P_src, P_dst] int32; pid P (padding) dropped."""
    P = comm.world
    cap = pid.shape[0] // P
    flat = pid.to(torch.int64) + _shard_offsets(P, cap, pid.device)
    cnt = torch.bincount(flat, minlength=P * (P + 1)).view(P, P + 1)[:, :P]
    return comm.all_gather(cnt.to(torch.int32))


def _exchange(comm, pid: torch.Tensor, leaves: Sequence[torch.Tensor],
              block: int, outcap: int):
    """Group-by-target, all_to_all, compact.  Returns (counts [P] int32,
    new leaves [P*outcap])."""
    P = comm.world
    dev = pid.device
    cap = pid.shape[0] // P
    shard_base = torch.arange(P, device=dev) * cap                    # [P]
    # stable sort by (shard, target): each shard's rows grouped by target,
    # in row order within a target — argsort per shard, batched
    flat = pid.to(torch.int64) + _shard_offsets(P, cap, dev)
    order = torch.sort(flat, stable=True).indices                     # [P*cap]
    cnt = torch.bincount(flat, minlength=P * (P + 1)).view(P, P + 1)[:, :P]
    offs = torch.cumsum(cnt, 1) - cnt                                 # [P, P]
    jj = torch.arange(block, device=dev)
    gather_pos = torch.clamp(offs[:, :, None] + jj, 0, cap - 1)       # [P,P,blk]
    send_idx = order[(shard_base[:, None, None] + gather_pos).reshape(-1)]
    valid_send = (jj < cnt[:, :, None]).reshape(-1)                  # [P*P*blk]

    # the 8-int header of mpi_channel.cpp, as one exchange of counts
    rcnt = comm.all_to_all(cnt)                                       # [P_dst, P_src]
    recv_valid = (jj < rcnt[:, :, None]).reshape(P, P * block)
    pos = torch.cumsum(recv_valid, 1) - 1
    slots = torch.where(recv_valid & (pos < outcap), pos, outcap)
    vidx = torch.zeros((P, outcap + 1), dtype=torch.int64, device=dev)
    vidx.scatter_(1, slots, torch.arange(P * block, device=dev).expand(P, -1))
    vidx = vidx[:, :outcap] + (torch.arange(P, device=dev) * (P * block))[:, None]
    newcount = rcnt.sum(1).to(torch.int32)                            # [P]
    keep = (torch.arange(outcap, device=dev) < newcount[:, None]).reshape(-1)

    outs: List[torch.Tensor] = [None] * len(leaves)
    for M, positions, dtypes in ops_gather.pack_columns(leaves):
        C = M.shape[1]
        S = torch.where(valid_send[:, None], M[send_idx], 0)          # [P*P*blk, C]
        R = comm.all_to_all(S.view(P, P, block, C))                   # [P_dst, P_src, blk, C]
        got = R.view(P * P * block, C)[vidx.reshape(-1)]              # [P*outcap, C]
        got = torch.where(keep[:, None], got, 0)
        for col, p in zip(ops_gather.unpack_columns(got, dtypes), positions):
            outs[p] = col
    return newcount, outs


def _devmem_before(ctx):
    """Pre-exchange device-memory snapshot (observe.devmem), taken only
    under an active plan capture (EXPLAIN ANALYZE): production exchanges
    pay nothing."""
    if not plan_check.capturing():
        return None
    return devmem.snapshot(ctx.device)


def _note_exchange_peak(ctx, dm0) -> None:
    """Under a plan capture, annotate the exchange just run with the
    device memory it was observed to take (``peak=observed N bytes``)
    and watermark it as ``devmem.peak_bytes``."""
    if dm0 is None:
        return
    obs = devmem.observed_exchange_bytes(dm0, devmem.snapshot(ctx.device))
    if obs is not None:
        trace.count_max("devmem.peak_bytes", obs)
        plan_check.annotate_append("peak", f"observed {obs} bytes "
                                           f"({dm0.source})")


def shuffle_leaves(ctx, pid: torch.Tensor, leaves: Sequence[torch.Tensor],
                   owner: str = "", combine: bool = False
                   ) -> Tuple[List[torch.Tensor], torch.Tensor, int]:
    """Repartition rows of flat ``[P*cap]`` ``leaves`` by target ids ``pid``
    (int32 ``[P*cap]``; padding rows carry P and are dropped).  A leaf with
    trailing dimensions (``[P*cap, M]`` sketch state) moves by row.

    Counts the rows that leave their shard (the count matrix's
    off-diagonal) as ``shuffle.rows_sent`` and times the row width as
    ``shuffle.bytes_sent``; ``owner="groupby"`` also adds the bytes to
    ``groupby.bytes_moved``, and ``combine`` (a partial-group table)
    counts every partial row as ``groupby.partials_rows``.  Spans:
    ``shuffle.counts`` (the count matrix) and ``shuffle.exchange`` (the
    host read of the counts, the all_to_all and the compaction).

    Returns ``(new_leaves [P*outcap], counts [P], outcap)``.
    """
    comm = ctx.comm
    trace.count("shuffle.exchanges")
    rbytes = max(row_bytes(leaves), 1)
    with trace.span("shuffle.counts"):
        cnt_dev = _counts(comm, pid)
    dm0 = _devmem_before(ctx)
    with trace.span_sync("shuffle.exchange") as sp:
        counts = read_host(cnt_dev)  # the one host read
        moved = int(counts.sum() - np.trace(counts))
        trace.count("shuffle.rows_sent", moved)
        trace.count("shuffle.bytes_sent", moved * rbytes)
        if owner == "groupby":
            trace.count("groupby.bytes_moved", moved * rbytes)
        if combine:
            trace.count("groupby.partials_rows", int(counts.sum()))
        block, outcap, _ = exchange_sizes(counts)
        newcounts, outs = _exchange(comm, pid, leaves, block, outcap)
        sp.sync(outs)
    trace.count("shuffle.strategy.single_shot")
    trace.count_max("shuffle.exchange_bytes_peak",
                    price_single_shot(comm.world, block, outcap, rbytes))
    plan_check.annotate_append("exchange", "single-shot: the one lowering")
    _note_exchange_peak(ctx, dm0)
    return outs, newcounts, outcap


def price_single_shot(P: int, block: int, outcap: int, rbytes: int) -> int:
    """Peak bytes per device of a single-shot exchange: the send and
    receive blocks ``[P, block]`` plus the compacted ``[outcap]`` output
    (the JAX package's ``cost.price_single_shot`` peak)."""
    return int((2 * P * block + outcap) * rbytes)
