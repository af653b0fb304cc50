"""Row shuffle: the two-phase exchange and its costed lowerings.

Mirror of ``cylon_tpu/parallel/shuffle.py`` (reference:
cpp/src/cylon/table_api.cpp:214-297 Shuffle — HashPartition + split +
AllToAll + concat).  Every phase runs batched over the L local shards of
a DTable's flat ``[L*cap]`` leaves (``L = P`` with one process), and
reaches the other ranks only through the context's communicator
(``all_to_all``, ``all_gather``, ``ppermute``, the first and last also
group-local over a ``(slow, fast)`` split).  Source axes are the L local
ranks, target axes the P ranks of the world; anything indexed by rank id
uses the GLOBAL rank ``first_rank + l``:

  1. counts    per-shard ``bincount`` of the target ids → ``[P_src, P_dst]``
               (gathered to every rank of every process, so every
               process sizes and chooses alike), read by the host through the
               optimistic count protocol (``ops/compact``): with a size
               hint for the shuffle's signature the single-shot exchange
               is dispatched at the hinted sizes while the counts travel
               (inside ``run_pipeline`` the read joins the region's one
               batched flush), and redone if they were too small;
  2. choice    the costed chooser (``parallel/cost.py``) prices the
               candidate lowerings from the count matrix against
               ``resilience.exchange_budget()`` and picks the cheapest
               that fits; single-shot wins whenever it fits; a signature
               that degraded waits for its counts and re-chooses every
               call until single-shot fits again;
  3. exchange  the chosen lowering:

     ``single-shot``   per shard: rows grouped by target (stable sort),
                       gathered into a ``[P_dst, block]`` send buffer, one
                       ``all_to_all``, the received rows compacted into
                       ``[outcap]`` (sender order);
     ``chunked``       K rounds of the single-shot exchange over rank
                       slices of ≤ C rows per (sender, target) cell,
                       folded receiver-side round after round; a
                       partial-group payload (``combine``) folds BY KEY,
                       so the accumulator grows with the groups;
     ``ring``          own rows first, then P−1 ``ppermute`` rounds, round
                       r moving each shard's (me → me+r) cell whole;
     ``allgather``     every shard's block gathered, each shard keeping
                       its rows (sender order);
     ``hierarchical``  one fast-axis ``all_to_all`` to the target's fast
                       coordinate, then a slow-axis ring (the combine
                       spelling pre-combines by key between the stages).

Every lowering gives the same per-shard row multiset; within a shard the
order is the lowering's own and equal to the JAX package's for the same
lowering.  The choice and its reason are annotated on the plan
(``exchange=…``, ``degraded=…``) and counted in ``shuffle.strategy.*``.
A lowering that fails (a CUDA out-of-memory error included) propagates:
nothing here catches it and reroutes.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..analysis import plan_check
from ..analysis._abstract import is_abstract
from ..observe import devmem
from ..observe.locks import OrderedLock
from ..observe.metrics import row_bytes
from ..ops import compact as ops_compact
from ..ops import gather as ops_gather
from ..ops.compact import bincount, next_bucket, read_counts
from . import cost

# warn-once keys this module has used (skew, budget floor), so
# clear_chunk_state can forget them
_warned: set = set()
_warned_lock = threading.Lock()


# Last (send block, receive capacity) per shuffle signature — lets the next
# same-shaped shuffle dispatch the exchange before the host has read the
# count matrix (the count read then overlaps device work).  Validated after
# the fact; an undersized hint re-runs at the true sizes
# (ops/compact.optimistic_dispatch).
_block_hints: dict = {}

# The costed chooser's degraded-signature state: shuffle signatures whose
# last sized exchange chose a NON-single-shot lowering.  These skip the
# optimistic dispatch entirely — waiting on the count matrix is the price
# of not allocating an over-budget exchange — and re-run the chooser per
# call until single-shot prices back under budget (then they
# self-promote).  Lock-guarded: the serving layer runs exchanges from its
# dispatcher thread while clients submit; membership reads stay lock-free
# (a stale read costs one optimistic dispatch or one count wait, never
# correctness).
_chunked_keys: set = set()
_chunk_lock = OrderedLock("shuffle.chunk_state")

# The contract: this module's writes to the chooser's signature state hold
# _chunk_lock.  The hint UPDATE inside ops_compact.optimistic_dispatch
# (update_size_hint on the dict passed to it) is deliberately lock-free: a
# lost grow/shrink race costs at most one redone dispatch — hints are
# validated against the true counts every call — and serializing it would
# put a lock acquisition on the optimistic hot path for no correctness
# gain.
GUARDED_STATE = {"_chunked_keys": "_chunk_lock",
                 "_block_hints": "_chunk_lock"}


def clear_chunk_state() -> None:
    """Forget the shuffle's per-signature chooser state: which signatures
    are degraded, and the skew and budget-floor warnings already given
    (test isolation).  The size hints stay (``_block_hints.clear()``)."""
    from .. import logging as glog
    with _chunk_lock:
        _chunked_keys.clear()
    with _warned_lock:
        keys = list(_warned)
        _warned.clear()
    for key in keys:
        glog.reset_warn_once(key)


def _mark_degraded(sig) -> None:
    with _chunk_lock:
        _chunked_keys.add(sig)


def _mark_promoted(sig, reseed=None) -> None:
    """Lift a signature's degrade; ``reseed`` re-records its single-shot
    size hint under the same lock hold."""
    with _chunk_lock:
        _chunked_keys.discard(sig)
        if reseed is not None:
            _block_hints[sig] = (reseed, 0)


class _OverBudget(Exception):
    """Raised by the count protocol's post() when the chooser picks a
    non-single-shot lowering — carries the (already read) count matrix
    and the priced choice, so shuffle_leaves runs the degraded lowering
    without a second host read or a re-choose.  Internal control flow,
    never user-visible."""

    def __init__(self, counts, need, choice, reason):
        super().__init__(f"exchange degraded to {choice.strategy}")
        self.counts = counts
        self.need = need
        self.choice = choice
        self.reason = reason


def _warn_once(key, msg: str, *args) -> None:
    from .. import logging as glog
    with _warned_lock:
        _warned.add(key)
    glog.warn_once(key, msg, *args)


# ---------------------------------------------------------------------------
# batched building blocks
# ---------------------------------------------------------------------------

def _shard_offsets(L: int, cap: int, device, bins: int) -> torch.Tensor:
    """[L*cap] local shard id of every flat row, times ``bins`` (bincount
    bins per shard)."""
    return torch.arange(L, device=device).repeat_interleave(cap) * bins


def _compact_rows(mask: torch.Tensor, size: int):
    """mask [R, n] → (idx [R, size] int64, fill 0; count [R]): per row,
    the positions of its True entries in order; entries past ``size``
    are dropped."""
    R, n = mask.shape
    pos = torch.cumsum(mask, 1) - 1
    slots = torch.where(mask & (pos < size), pos, size)
    idx = torch.zeros((R, size + 1), dtype=torch.int64, device=mask.device)
    idx.scatter_(1, slots, torch.arange(n, device=mask.device).expand(R, -1))
    return idx[:, :size], mask.sum(1)


def _gather_rows(M: torch.Tensor, L: int, idx: torch.Tensor) -> torch.Tensor:
    """M [L*n, C], idx [L, k] (per-shard row positions) → [L, k, C]."""
    n = M.shape[0] // L
    base = (torch.arange(L, device=M.device) * n)[:, None]
    return M[(base + idx).reshape(-1)].view(L, idx.shape[1], M.shape[1])


def _scatter_rows(acc: torch.Tensor, slots: torch.Tensor,
                  src: torch.Tensor) -> None:
    """acc [P, m+1, ...] (row m drops), slots [P, k] in [0, m], src
    [P, k, ...]: ``acc[p, slots[p, j]] = src[p, j]``."""
    P, m1 = acc.shape[0], acc.shape[1]
    flat = ((torch.arange(P, device=acc.device) * m1)[:, None]
            + slots).reshape(-1)
    acc.view((P * m1,) + tuple(acc.shape[2:]))[flat] = \
        src.reshape((-1,) + tuple(acc.shape[2:]))


def _where_rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (x.dim()
                                                         - mask.dim())),
                       x, torch.zeros((), dtype=x.dtype, device=x.device))


def _counts(comm, pid: torch.Tensor) -> torch.Tensor:
    """pid [L*cap] → counts [P_src, P_dst] int32, all-gathered; pid P
    (padding) dropped."""
    P, L = comm.world, comm.local
    cap = pid.shape[0] // L
    flat = pid.to(torch.int64) + _shard_offsets(L, cap, pid.device, P + 1)
    cnt = bincount(flat, L * (P + 1)).view(L, P + 1)[:, :P]
    return comm.all_gather(cnt.to(torch.int32))


def _send_plan(pid: torch.Tensor, L: int, T: int):
    """pid [L*cap] → (order [L*cap], cnt [L, T]): a stable sort by
    (shard, target) — each shard's rows grouped by target, in row order
    within a target (argsort per shard, batched) — and the per-cell
    counts; target ``T`` (padding) dropped."""
    cap = pid.shape[0] // L
    flat = pid.to(torch.int64) + _shard_offsets(L, cap, pid.device, T + 1)
    order = torch.sort(flat, stable=True).indices                     # [L*cap]
    cnt = bincount(flat, L * (T + 1)).view(L, T + 1)[:, :T]
    return order, cnt


def _exchange(comm, pid: torch.Tensor, leaves: Sequence[torch.Tensor],
              block: int, outcap: int, split=None, plan=None,
              start: int = 0, take: Optional[int] = None):
    """Group-by-target, all_to_all, compact.  Returns (counts [L] int32,
    new leaves [L*outcap]).  With ``split`` = (slow, fast) the targets
    are fast coordinates (``fast`` = drop) and the all_to_all runs
    inside each slow group: the first stage of the hierarchical
    exchange.  With ``plan`` (``_send_plan`` of ``pid``) and ``take``
    only the rank slice [start, start + take) of every (sender, target)
    cell moves: one chunked round, every round cut from the one sort."""
    L = comm.local
    T = comm.world if split is None else int(split[1])  # targets per shard
    a2a = ({} if split is None else {"split": split, "axis": "fast"})
    dev = pid.device
    cap = pid.shape[0] // L
    shard_base = torch.arange(L, device=dev) * cap                    # [L]
    order, cnt = _send_plan(pid, L, T) if plan is None else plan
    offs = torch.cumsum(cnt, 1) - cnt                                 # [L, T]
    if take is not None:
        offs = offs + start
        cnt = torch.clamp(cnt - start, 0, take)
    jj = torch.arange(block, device=dev)
    gather_pos = torch.clamp(offs[:, :, None] + jj, 0, cap - 1)       # [L,T,blk]
    send_idx = order[(shard_base[:, None, None] + gather_pos).reshape(-1)]
    valid_send = (jj < cnt[:, :, None]).reshape(-1)                  # [L*T*blk]

    # the 8-int header of mpi_channel.cpp, as one exchange of counts
    rcnt = comm.all_to_all(cnt, **a2a)                                # [L, T_src]
    recv_valid = (jj < rcnt[:, :, None]).reshape(L, T * block)
    vidx, _ = _compact_rows(recv_valid, outcap)
    vidx = vidx + (torch.arange(L, device=dev) * (T * block))[:, None]
    newcount = rcnt.sum(1).to(torch.int32)                            # [L]
    keep = (torch.arange(outcap, device=dev) < newcount[:, None]).reshape(-1)

    outs: List[torch.Tensor] = [None] * len(leaves)
    for M, positions, dtypes in ops_gather.pack_columns(leaves):
        C = M.shape[1]
        S = torch.where(valid_send[:, None], M[send_idx], 0)          # [L*T*blk, C]
        R = comm.all_to_all(S.view(L, T, block, C), **a2a)           # [L, T_src, blk, C]
        got = R.view(L * T * block, C)[vidx.reshape(-1)]              # [L*outcap, C]
        got = torch.where(keep[:, None], got, 0)
        for col, p in zip(ops_gather.unpack_columns(got, dtypes), positions):
            outs[p] = col
    return newcount, outs


def _ring_exchange(comm, pid: torch.Tensor, leaves: Sequence[torch.Tensor],
                   block: int, outcap: int, split=None):
    """Staged ring: own rows first, then T−1 ``ppermute`` rounds, round
    r moving each shard's whole (me → me+r) cell as one [block] buffer
    and landing it after the rows already received.  With ``split`` the
    ring runs along the slow axis (``pid`` holds slow coordinates, the
    slow extent = drop): the second stage of the hierarchical exchange.
    ``me`` is each local shard's GLOBAL rank (or its slow coordinate).
    Returns (counts [L] int32, new leaves [L*outcap])."""
    L = comm.local
    dev = pid.device
    ranks = comm.first_rank + torch.arange(L, device=dev)
    if split is None:
        T, me, perm = comm.world, ranks, {}
    else:
        T = int(split[0])
        me = ranks // int(split[1])
        perm = {"split": split, "axis": "slow"}
    cap = pid.shape[0] // L
    pid2 = pid.view(L, cap).to(torch.int64)
    iota = torch.arange(block, device=dev)
    groups = ops_gather.pack_columns(leaves)
    # round 0 (no wire): own rows compact straight into the result
    vidx0, total = _compact_rows(pid2 == me[:, None], outcap)
    keep0 = torch.arange(outcap, device=dev) < total[:, None]
    accs = []
    for M, _, _ in groups:
        acc = torch.zeros((L, outcap + 1, M.shape[1]), dtype=M.dtype,
                          device=dev)
        acc[:, :outcap] = _where_rows(keep0, _gather_rows(M, L, vidx0))
        accs.append(acc)
    for r in range(1, T):
        sel = pid2 == ((me + r) % T)[:, None]
        idx, cnt = _compact_rows(sel, block)
        valid = iota < cnt[:, None]
        rcnt = comm.ppermute(cnt, r, **perm)
        rvalid = iota < rcnt[:, None]
        slots = torch.where(rvalid, total[:, None] + iota, outcap)
        slots = torch.clamp(slots, max=outcap)
        for (M, _, _), acc in zip(groups, accs):
            S = _where_rows(valid, _gather_rows(M, L, idx))
            R = _where_rows(rvalid, comm.ppermute(S, r, **perm))
            _scatter_rows(acc, slots, R)
        total = total + rcnt
    outs: List[torch.Tensor] = [None] * len(leaves)
    for (_, positions, dtypes), acc in zip(groups, accs):
        A = acc[:, :outcap].reshape(L * outcap, acc.shape[2])
        for col, p in zip(ops_gather.unpack_columns(A, dtypes), positions):
            outs[p] = col
    return total.to(torch.int32), outs


def _allgather_exchange(comm, pid: torch.Tensor,
                        leaves: Sequence[torch.Tensor], outcap: int):
    """Replicate-and-filter: every shard's block gathered to every shard
    (pid lane included), each shard keeping the rows targeted at it in
    gathered order, which is sender order."""
    P, L, r0 = comm.world, comm.local, comm.first_rank
    dev = pid.device
    cap = pid.shape[0] // L
    gpid = comm.all_gather(pid.view(L, cap)).reshape(-1).to(torch.int64)
    # each receiver's rows of the gathered block, in gathered order: a
    # stable sort by target lists every receiver's rows contiguously
    order = torch.sort(gpid, stable=True).indices
    cnt_all = bincount(gpid, P + 1)[:P]
    # this process's receivers
    offs = (torch.cumsum(cnt_all, 0) - cnt_all)[r0:r0 + L]
    cnt = cnt_all[r0:r0 + L]
    jj = torch.arange(outcap, device=dev)
    vidx = order[torch.clamp(offs[:, None] + jj, max=P * cap - 1)]
    keep = (jj < cnt[:, None]).reshape(-1)
    outs: List[torch.Tensor] = [None] * len(leaves)
    for M, positions, dtypes in ops_gather.pack_columns(leaves):
        G = comm.all_gather(M.view(L, cap, M.shape[1])).reshape(P * cap, -1)
        got = torch.where(keep[:, None], G[vidx.reshape(-1)], 0)
        for col, p in zip(ops_gather.unpack_columns(got, dtypes), positions):
            outs[p] = col
    return cnt.to(torch.int32), outs


def _fold(acc, acc_cnt, rleaves, rcnt, P: int, incap: int, outcap: int):
    """Receiver-side concatenation of one round's compacted output into
    the result block: per shard, the round's ``rcnt`` rows land at
    offset ``acc_cnt`` (rounds back to back).  ``acc`` None starts a
    zeroed block.  The block is kept as ``[P, outcap + 1, ...]`` (row
    ``outcap`` drops) until :func:`_fold_done`.  Returns (acc_cnt,
    acc)."""
    dev = rcnt.device
    if acc is None:
        acc_cnt = torch.zeros_like(rcnt)
        acc = [torch.zeros((P, outcap + 1) + tuple(lf.shape[1:]),
                           dtype=lf.dtype, device=dev) for lf in rleaves]
    idx = torch.arange(incap, device=dev)
    keep = idx < rcnt[:, None]
    tgt = torch.clamp(torch.where(keep, acc_cnt[:, None] + idx, outcap),
                      max=outcap)
    for a, lf in zip(acc, rleaves):
        _scatter_rows(a, tgt, _where_rows(
            keep, lf.view((P, incap) + tuple(lf.shape[1:]))))
    return acc_cnt + rcnt, acc


def _fold_done(acc, P: int, outcap: int) -> List[torch.Tensor]:
    """The folded result block as flat ``[P*outcap]`` leaves."""
    return [a[:, :outcap].reshape((P * outcap,) + tuple(a.shape[2:]))
            for a in acc]


def _combine_shard(spec, pieces, out_cap: int):
    """One shard's fold that COMBINES partial-group rows by key: the local
    groupby over the concatenated ``pieces`` (each ``(count, leaves)``,
    the count a device scalar, the leaves ``[n_i, ...]``) with the combine
    ops (sum of sums / counts, min of mins, max of maxes).  ``spec`` =
    ``(key_slots, val_slots)`` over the wire leaf positions.  Returns
    (leaves ``[out_cap, ...]`` in the wire dtypes, group count); rows past
    the group count are unspecified."""
    from ..ops import groupby as ops_groupby
    key_slots, val_slots = spec
    first = pieces[0][1]
    dev = first[0].device
    leaves = [torch.cat([lvs[j] for _, lvs in pieces]) if len(pieces) > 1
              else first[j] for j in range(len(first))]
    row_valid = torch.cat([torch.arange(lvs[0].shape[0], device=dev) < cnt
                           for cnt, lvs in pieces])
    kpairs = tuple((leaves[d], None if v is None else leaves[v])
                   for d, v in key_slots)
    key_idx, aggs, agg_valids, ng = ops_groupby.groupby_aggregate(
        tuple(d for d, _ in kpairs), tuple(v for _, v in kpairs),
        tuple(leaves[d] for d, _v, _op in val_slots),
        tuple(None if v is None else leaves[v] for _d, v, _op in val_slots),
        tuple(op for _d, _v, op in val_slots),
        row_valid=row_valid, out_capacity=out_cap)
    del leaves, row_valid
    keys_out = ops_gather.take_many(kpairs, key_idx, fill_null=False)
    outs: List[torch.Tensor] = [None] * len(first)
    for (d, v), (kd, kv) in zip(key_slots, keys_out):
        outs[d] = kd.to(first[d].dtype)
        if v is not None:
            outs[v] = kv.to(first[v].dtype)
    for (d, v, _op), arr, av in zip(val_slots, aggs, agg_valids):
        outs[d] = arr.to(first[d].dtype)
        if v is not None:
            outs[v] = (torch.ones(out_cap, dtype=torch.bool, device=dev)
                       if av is None else av.to(torch.bool))
    return outs, ng


def _fold_combine(spec, P: int, parts, out_cap: int):
    """Fold-by-key of flat exchange outputs: per shard, ``_combine_shard``
    over the shard's slice of every part (each ``(count [P], leaves
    [P*cap_i])``).  Returns (groups [P] int32, leaves [P*out_cap]).  One
    groupby per shard, each writing its slice of the result in place:
    only one shard's sort and scans are live at a time.  (One groupby
    over (shard, keys) for all P shards held every shard's working set at
    once: 6.9 GB against 1.1 GB at SF 10, PERF.md run H.)"""
    first = parts[0][1]
    dev = parts[0][0].device
    outs = [torch.empty((P * out_cap,) + tuple(lf.shape[1:]), dtype=lf.dtype,
                        device=dev) for lf in first]
    ngs = torch.zeros(P, dtype=torch.int32, device=dev)
    for s in range(P):
        pieces = [(cnt[s], [lf[s * (lf.shape[0] // P):
                               (s + 1) * (lf.shape[0] // P)] for lf in lvs])
                  for cnt, lvs in parts]
        got, ng = _combine_shard(spec, pieces, out_cap)
        for o, g in zip(outs, got):
            o[s * out_cap:(s + 1) * out_cap] = g
        ngs[s] = ng
    return ngs, outs


class _RoundFold:
    """Receiver-side fold of an exchange's rounds (the chunked and the
    staged-spill lowerings): round k's compacted output either lands back
    to back in the result block (``_fold``), or, under a ``combine``
    spec, folds BY KEY into an accumulator of one row per distinct group
    so far, sized exactly from the previous fold's group count (one host
    read per round), so it grows with the groups, not the rows received.

    The by-key accumulator is kept as one block per shard: each shard's
    previous block is freed right after that shard's fold, so the two
    accumulator generations overlap by one shard, not by all P; the
    result is assembled into the flat ``[P*cap]`` leaves at the end, each
    shard's block freed as it is copied."""

    def __init__(self, comm, counts: np.ndarray, rounds: int, C: int,
                 outcap_k: int, outcap_total: int, rbytes: int,
                 priced: int, combine=None):
        # Pn: the local shards the fold runs over; the count matrix and
        # the group counts that size it are global (replicated)
        self.comm, self.Pn = comm, comm.local
        self.counts, self.rounds, self.C = counts, rounds, C
        self.outcap_k, self.outcap_total = outcap_k, outcap_total
        self.rbytes, self.priced, self.combine = rbytes, priced, combine
        self.acc = self.acc_cnt = None
        self.acc_cap = outcap_total
        self.acc_groups = None  # per-shard distinct-group counts (combine)

    def add(self, k: int, cnt_k: torch.Tensor, outs_k) -> None:
        Pn, incap = self.Pn, self.outcap_k
        if self.combine is None:
            self.acc_cnt, self.acc = _fold(self.acc, self.acc_cnt, outs_k,
                                           cnt_k, Pn, incap,
                                           self.outcap_total)
            return
        trace.count("shuffle.fold_combined")
        if self.acc is None:
            # round 0 already combines: groups <= received rows, so
            # capacity outcap_k can never overflow
            prev_cap, out_cap = 0, incap
        else:
            # exact: groups after the fold <= groups in the accumulator +
            # rows this round adds
            recv_k = np.minimum(np.maximum(self.counts - k * self.C, 0),
                                self.C).sum(axis=0)
            bound = self.acc_groups + recv_k
            prev_cap = self.acc_cap
            out_cap = next_bucket(max(int(bound.max(initial=0)), 1),
                                  minimum=8)
        blocks, ngs = [], []
        for s in range(Pn):
            rnd = (cnt_k[s], [lf[s * incap:(s + 1) * incap] for lf in outs_k])
            pieces = [rnd] if self.acc is None else \
                [(self.acc_cnt[s], self.acc[s]), rnd]
            got, ng = _combine_shard(self.combine, pieces, out_cap)
            del pieces, rnd
            if self.acc is not None:
                self.acc[s] = None   # this shard's previous block goes now
            blocks.append(got)
            ngs.append(ng)
        self.acc = blocks
        self.acc_cnt = torch.stack(ngs).to(torch.int32)
        self.acc_cap = out_cap
        # the fold's transient as the JAX package prices it: the round
        # blocks + both accumulator generations
        trace.count_max("shuffle.exchange_bytes_peak",
                        self.priced + (prev_cap + out_cap) * self.rbytes)
        if k + 1 < self.rounds:
            self.acc_groups = read_counts(self.comm.all_gather(self.acc_cnt))

    def done(self):
        """(flat result leaves, counts [P], capacity)."""
        if self.combine is None:
            return (_fold_done(self.acc, self.Pn, self.outcap_total),
                    self.acc_cnt, self.outcap_total)
        Pn, cap = self.Pn, self.acc_cap
        outs = []
        for j in range(len(self.acc[0])):
            ref = self.acc[0][j]
            flat = torch.empty((Pn * cap,) + tuple(ref.shape[1:]),
                               dtype=ref.dtype, device=ref.device)
            del ref
            for s in range(Pn):
                flat[s * cap:(s + 1) * cap] = self.acc[s][j]
                self.acc[s][j] = None
            outs.append(flat)
        self.acc = None
        return outs, self.acc_cnt, cap


def _cell_rank(pid: torch.Tensor, L: int, P: int) -> torch.Tensor:
    """[L*cap] int32 rank of every row within its (shard, target) cell, in
    row order, without sorting the pid lane: one masked cumsum per
    target (P of them)."""
    cap = pid.shape[0] // L
    pid2 = pid.view(L, cap)
    rank = torch.zeros((L, cap), dtype=torch.int32, device=pid.device)
    for t in range(P):
        m = pid2 == t
        rank = torch.where(m, torch.cumsum(m, 1, dtype=torch.int32) - 1, rank)
        del m
    return rank.view(-1)


def _rank_morsel(pid: torch.Tensor, leaves, rank: torch.Tensor, L: int,
                 P: int, lo: int, hi: int, mcap: int):
    """The rows of rank ``[lo, hi)`` in their (shard, target) cells, moved
    to the front of the L local shards' ``[mcap]`` blocks in row order
    (padding: pid ``P``, zero leaves): one chunked round's morsel, which
    the single-shot ``_exchange`` then sends as that round.  Returns (pid
    [L*mcap], leaves)."""
    cap = pid.shape[0] // L
    dev = pid.device
    src = torch.nonzero((pid < P) & (rank >= lo) & (rank < hi)).squeeze(1)
    shard = torch.div(src, cap, rounding_mode="floor")
    n = torch.bincount(shard, minlength=L)
    start = torch.cumsum(n, 0) - n
    dst = shard * mcap + (torch.arange(src.shape[0], device=dev)
                          - start[shard])
    del shard, n, start
    pid_m = torch.full((L * mcap,), P, dtype=pid.dtype, device=dev)
    pid_m[dst] = pid[src]
    out = []
    for lf in leaves:
        m = torch.zeros((L * mcap,) + tuple(lf.shape[1:]), dtype=lf.dtype,
                        device=dev)
        m[dst] = lf[src]
        out.append(m)
    return pid_m, out


# ---------------------------------------------------------------------------
# accounting, choice, instrumentation
# ---------------------------------------------------------------------------

def _account(counts: np.ndarray, rbytes: int, combine=None,
             owner: str = "", split=None, mine=None) -> None:
    """Exchange-volume accounting of THIS process's senders (``mine`` =
    ``(first_rank, L)``, every rank with one process): the rows of the
    count matrix's off-diagonal they send as ``shuffle.rows_sent`` /
    ``shuffle.bytes_sent`` (``owner="groupby"`` also
    ``groupby.bytes_moved``); a partial-group payload (``combine``)
    counts every partial row as ``groupby.partials_rows``; otherwise,
    under a non-trivial ``(slow, fast)`` split, the rows crossing slow
    groups as ``shuffle.rows_sent_slow``."""
    c = np.asarray(counts)
    r0, L = mine if mine is not None else (0, c.shape[0])
    sent = c[r0:r0 + L]
    moved = int(sent.sum() - np.trace(c[r0:r0 + L, r0:r0 + L]))
    trace.count("shuffle.rows_sent", moved)
    trace.count("shuffle.bytes_sent", moved * rbytes)
    if owner == "groupby":
        trace.count("groupby.bytes_moved", moved * rbytes)
    if combine is not None:
        trace.count("groupby.partials_rows", int(sent.sum()))
    elif split is not None:
        slow, fast = split
        if slow > 1 and fast > 1 and c.shape[0] == slow * fast:
            slow_of = np.arange(slow * fast) // fast
            cross = slow_of[:, None] != slow_of[None, :]
            trace.count("shuffle.rows_sent_slow",
                        int(c[r0:r0 + L][cross[r0:r0 + L]].sum()))


def _axis_split_of(ctx):
    """``topology.axis_split(ctx)`` when NON-trivial and tiling the
    world, else None (flat: no hierarchy to price)."""
    from .. import topology
    slow, fast = topology.axis_split(ctx)
    if slow > 1 and fast > 1 and slow * fast == ctx.get_world_size():
        return (slow, fast)
    return None


def _warn_skew(Pn: int, sig, per_recv: np.ndarray, outcap: int) -> None:
    """The hot-key-skew warning, once per shuffle signature: every
    shard's receive block is sized to the hottest receiver."""
    mean_recv = max(float(per_recv.mean()), 1.0)
    if not (Pn > 1 and outcap >= 65536 and outcap > 4 * mean_recv):
        return
    _warn_once(
        ("shuffle.skew", sig),
        "skewed exchange: hottest receiver gets %d rows "
        "(%.1fx the %.0f mean); every shard's receive block is "
        "bucketed to %d — peak memory ~%.1fx the data "
        "(warned once per shuffle signature per session)",
        int(per_recv.max(initial=0)), per_recv.max() / mean_recv,
        mean_recv, outcap, outcap / mean_recv)


def _choose(Pn: int, cap: int, counts: np.ndarray, rbytes: int,
            budget: int, combine, ctx=None):
    """Run the costed chooser for one sized exchange: a feasible
    single-shot takes the fast path; otherwise enumerate the candidate
    lowerings (a combine-spec payload only those that fold by key) and
    pick under ``budget``, honouring the ``CYLON_EXCHANGE_STRATEGY``
    override; past every resident lowering, the host-tier staged-spill
    one when the spill tier is on.  Returns ``(price, reason,
    feasible)``.  Inside a replanned recovery attempt
    (``resilience.demoted_exchanges``) the demoted strategies are
    excluded and the fast path is skipped: the lowering that just failed
    must not be re-picked."""
    from .. import resilience
    from ..config import exchange_strategy, spill_enabled
    forced = exchange_strategy()
    split = _axis_split_of(ctx) if ctx is not None else None
    exclude = resilience.exchange_demotions()
    # the host tier stages one process's blocks: across processes the
    # chooser leaves it out, and says so in the decision's reason
    procs = ctx.get_process_count() if ctx is not None else 1
    spill_ok = spill_enabled() and procs == 1
    if forced is None and not exclude:
        # fast path: a feasible single-shot wins the (rounds, wire,
        # catalogue) order outright
        block, outcap, _ = cost.exchange_sizes(counts)
        ss = cost.price_single_shot(Pn, block, outcap, rbytes)
        if ss.peak_bytes <= budget:
            ss = cost.slow_share(ss, Pn, split)
            return ss, f"{ss.describe()} <= budget {budget} B", True
    cands = cost.enumerate_strategies(Pn, cap, counts, rbytes, budget,
                                      staged_ok=combine is None,
                                      spill_ok=spill_ok, split=split)
    choice, reason, feasible = cost.choose(cands, budget, forced,
                                           exclude=exclude)
    if procs > 1 and spill_enabled():
        reason = (f"{cost.STAGED_SPILL} excluded: the process "
                  f"communicator spans {procs} processes; {reason}")
    return choice, reason, feasible


def _note_choice(choice, reason: str, nparts=None) -> None:
    """Record one chooser decision: the per-strategy counter, the slow
    axis bytes, a downgrade (counter + flight-recorder event) and the
    plan annotation ``exchange=<strategy>: <reason>``.  The recovery
    driver's per-attempt record (``resilience.note_strategy_choice``)
    gets the pick too: a resource-classed failure demotes the chooser
    off it."""
    from ..observe import flightrec
    from ..resilience import note_strategy_choice
    trace.count(cost.strategy_counter(choice.strategy))
    if nparts is not None and choice.slow_wire_bytes:
        trace.count("shuffle.bytes_sent_slow",
                    int(choice.slow_wire_bytes) * int(nparts))
    note_strategy_choice(choice.strategy)
    if choice.strategy != cost.SINGLE_SHOT:
        trace.count("shuffle.strategy.downgrades")
        flightrec.note("exchange_choice", strategy=choice.strategy,
                       reason=reason[:200])
    plan_check.annotate_append("exchange", f"{choice.strategy}: {reason}")


def _watchdog_dispatch(point: str, thunk, device):
    """Bounded-timeout guard around one collective dispatch.  With
    ``CYLON_EXCHANGE_TIMEOUT_MS`` set, the dispatch and its completion
    wait run on a helper thread, on the CALLER's CUDA stream (so its
    work stays ordered with the caller's), waited with
    ``torch.cuda.synchronize``; a breach raises a
    :class:`faults.TransientFault` naming the point and bumps
    ``shuffle.watchdog_timeouts``.  The wedged helper is left behind (a
    daemon): a stuck collective cannot be interrupted from the host.
    Off (the default) this is one knob read and a direct call."""
    from ..config import exchange_timeout_ms
    timeout_ms = exchange_timeout_ms()
    if not timeout_ms:
        return thunk()
    cuda = device.type == "cuda"
    stream = torch.cuda.current_stream(device) if cuda else None
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            if cuda:
                with torch.cuda.stream(stream):
                    out = thunk()
                torch.cuda.synchronize(device)
            else:
                out = thunk()
            box["out"] = out
        except BaseException as e:  # re-raised on the caller's thread
            box["err"] = e
        finally:
            done.set()

    th = threading.Thread(target=run, name="cylon-exchange-watchdog",
                          daemon=True)
    th.start()
    if not done.wait(timeout_ms / 1e3):
        from .. import faults
        trace.count("shuffle.watchdog_timeouts")
        raise faults.TransientFault(point, detail=(
            f"exchange watchdog: collective dispatch at {point!r} "
            f"exceeded CYLON_EXCHANGE_TIMEOUT_MS={timeout_ms} ms — "
            "treating the exchange as wedged (transient class)"))
    if "err" in box:
        raise box["err"]
    return box["out"]


def _devmem_before(ctx):
    """Pre-exchange device-memory snapshot (observe.devmem), taken only
    under an active plan capture (EXPLAIN ANALYZE): production exchanges
    pay nothing, nor does an abstract plan run."""
    if not plan_check.capturing() or ctx.device.type == "meta":
        return None
    return devmem.snapshot(ctx.device)


def _note_exchange_ms(ctx, choice, dm0) -> None:
    """Under a plan capture, annotate the exchange just run with its
    priced peak against the device memory it was observed to take
    (``peak=<strategy>: predicted N / observed M bytes``) and watermark
    the observation as ``devmem.peak_bytes``.  The predicted-time half
    needs a probed mesh profile (``parallel/meshprobe.py``), which the
    port does not have: it stays silent, as in the JAX package without
    a probe."""
    if dm0 is None:
        return
    after = devmem.snapshot(ctx.device)
    obs = devmem.observed_exchange_bytes(dm0, after)
    if obs is not None:
        trace.count_max("devmem.peak_bytes", obs)
        plan_check.annotate_append(
            "peak", f"{choice.strategy}: predicted {choice.peak_bytes} / "
                    f"observed {obs} bytes ({after.source})")


# ---------------------------------------------------------------------------
# the staged lowerings
# ---------------------------------------------------------------------------

def _staged_exchange(ctx, pid, leaves, choice, outcap_total: int):
    """Dispatch one ring / allgather exchange (sized by the chooser:
    ``choice.sizes`` = (block | cap, outcap))."""
    comm = ctx.comm
    trace.count_max("shuffle.exchange_bytes_peak", choice.peak_bytes)
    dm0 = _devmem_before(ctx)
    with trace.span_sync("shuffle.exchange") as sp:
        if choice.strategy == cost.RING:
            block = choice.sizes[0]
            newcounts, outs = _watchdog_dispatch(
                "shuffle.exchange", lambda: _ring_exchange(
                    comm, pid, leaves, block, outcap_total), ctx.device)
        else:
            newcounts, outs = _watchdog_dispatch(
                "shuffle.exchange", lambda: _allgather_exchange(
                    comm, pid, leaves, outcap_total), ctx.device)
        sp.sync(outs)
    _note_exchange_ms(ctx, choice, dm0)
    return list(outs), newcounts, outcap_total


def _chunked_exchange(ctx, pid, leaves, counts: np.ndarray, rbytes: int,
                      budget: int, outcap_total: int, combine=None,
                      plan=None, choice=None):
    """Run the K bounded rounds and fold them into the result block.
    Each round's transient is priced ≤ budget (best-effort once the
    per-cell floor C = 1 is reached); the result block is the shuffle's
    RESULT, the capacity single-shot returns.  Rows land round-major,
    each round in sender order.

    With a ``combine`` spec the rounds fold BY GROUP KEY
    (:func:`_fold_combine`): the accumulator holds one row per distinct
    group so far, sized exactly from the previous fold's group count
    (one host read per round), so it grows with the groups, not the
    rows received."""
    comm, Pn, L = ctx.comm, ctx.get_world_size(), ctx.get_local_world_size()
    cap = pid.shape[0] // L
    rounds, C, block, outcap_k = (plan if plan is not None else
                                  cost.chunk_plan(Pn, counts, rbytes, budget))
    trace.count("shuffle.chunked")
    trace.count("shuffle.chunked_rounds", rounds)
    priced_k = cost.single_shot_bytes(Pn, (block, outcap_k), rbytes)
    trace.count_max("shuffle.exchange_bytes_peak", priced_k)
    if priced_k > budget:
        _warn_once(
            ("shuffle.budget_floor", str(ctx.device), Pn),
            "memory budget %d B is below the smallest possible exchange "
            "round (%d B at 1 row/cell) — running best-effort chunked "
            "rounds anyway", budget, priced_k)
    plan_check.annotate(
        degraded=f"chunked shuffle: {rounds} rounds of <= {C} rows/cell "
                 f"({priced_k} B/round vs {budget} B budget)")
    dm0 = _devmem_before(ctx)
    fold = _RoundFold(comm, counts, rounds, C, outcap_k, outcap_total, rbytes,
                      priced_k, combine)
    with trace.span_sync("shuffle.exchange") as sp:
        if combine is None:
            # one sort for every round: round k moves the rank slice
            # [k·C, (k+1)·C) of each (sender, target) cell, a contiguous
            # run of the sorted cell
            plan_k = _send_plan(pid, L, Pn)
            round_k = lambda k: _exchange(  # noqa: E731
                comm, pid, leaves, block, outcap_k, plan=plan_k,
                start=k * C, take=C)
        else:
            # a by-key fold holds its accumulator beside the rounds: the
            # rounds are cut from one int32 rank lane instead of a full
            # sort of the pid lane, each round's rows moved to a
            # morsel-sized block first
            rank = _cell_rank(pid, L, Pn)
            mcap = next_bucket(max(min(Pn * C, cap), 1), minimum=8)

            def round_k(k):
                pid_m, leaves_m = _rank_morsel(pid, leaves, rank, L, Pn,
                                               k * C, (k + 1) * C, mcap)
                return _exchange(comm, pid_m, leaves_m, block, outcap_k)
        for k in range(rounds):
            cnt_k, outs_k = _watchdog_dispatch(
                "shuffle.exchange", lambda k=k: round_k(k), ctx.device)
            fold.add(k, cnt_k, outs_k)
            del cnt_k, outs_k
        # the send plan / rank lane go before the result is assembled
        round_k = plan_k = rank = None
        acc, acc_cnt, acc_cap = fold.done()
        sp.sync(acc)
    if choice is not None:
        _note_exchange_ms(ctx, choice, dm0)
    return list(acc), acc_cnt, acc_cap


def _spill_plan(hpid: np.ndarray, Pn: int, cap: int):
    """Host-side round plan of a staged-spill exchange: one stable sort of
    the rows by (shard, target) cell.  Returns ``(order, start, count)``:
    cell ``(i, t)``'s rows, in row order, are ``order[start[i, t] :
    start[i, t] + count[i, t]]``, so round k's rows of the cell are the
    rank slice ``[k·C, (k+1)·C)`` of that run (padding rows, target
    ``Pn``, sort past each shard's cells).  The cell id fits a uint16 lane
    for any world up to 255, and numpy's stable sort of a uint16 lane is
    a radix sort."""
    width = Pn + 1
    lane = np.uint16 if Pn * width <= 0xFFFF else np.int64
    cell = np.repeat(np.arange(Pn, dtype=lane) * lane(width), cap)
    cell += hpid.astype(lane)
    order = np.argsort(cell, kind="stable")
    count = np.bincount(cell, minlength=Pn * width).reshape(Pn, width)
    start = (np.cumsum(count) - count.reshape(-1)).reshape(Pn, width)
    return order, start[:, :Pn], count[:, :Pn]


def _staged_spill_exchange(ctx, pid, leaves, counts: np.ndarray, rbytes: int,
                           budget: int, outcap_total: int, choice,
                           combine=None):
    """The host-tier lowering: stage the payload OUT to the spill pool,
    then stream it back in ``rounds`` rank-sliced morsels, each a
    ``[P, bucket(C)]``-shaped bounded exchange over a morsel-sized staged
    block, folded receiver-side like the chunked rounds (plain concat, or
    fold-by-key under ``combine``).  The same rows, order, shard placement
    and ``(block, outcap)`` as the chunked plan.

    The payload and two morsel staging blocks are reserved against the
    host budget first (an over-budget exchange raises the typed
    OutOfMemory before any copy).  Host work: one sort of the staged pid
    lane by (shard, target) cell (``_spill_plan``), then per round a
    gather of each cell's rank slice into one of two pinned staging
    blocks, reused across rounds (a block is refilled only after the
    copy that last read it completed).  A morsel holds each shard's rows
    grouped by target, in row order within a target: the exchange's own
    stable sort by target keeps that order, so each round sends what the
    chunked plan's round sends.  Morsel k+1's
    gather and host→device copy run on a ``HostPipeline`` worker while
    morsel k's exchange runs; the consumer's stream waits on each
    morsel's copy event."""
    from ..context import refuse_multiprocess
    from ..spill import pool as spill_pool
    from .streaming import HostPipeline
    refuse_multiprocess("the staged-spill exchange", ctx)
    comm, Pn = ctx.comm, ctx.get_world_size()
    rounds, C, block, outcap_k = choice.sizes
    trace.count("spill.exchanges")
    trace.count_max("shuffle.exchange_bytes_peak", choice.peak_bytes)
    plan_check.annotate(
        degraded=f"staged-spill shuffle: {rounds} host-staged morsels "
                 f"of <= {C} rows/cell ({choice.peak_bytes} B/morsel "
                 f"vs {budget} B budget)")
    cap = pid.shape[0] // max(Pn, 1)
    mcap = next_bucket(max(min(Pn * C, cap), 1), minimum=8)
    payload = [pid] + list(leaves)
    per_row = sum(lf.element_size()
                  * int(np.prod(tuple(lf.shape[1:]), dtype=np.int64))
                  for lf in payload)
    reserve = cap * Pn * per_row + 2 * Pn * mcap * per_row
    the_pool = spill_pool.get_pool()
    the_pool.reserve_transient(reserve)
    pipe = None
    try:
        hosts = spill_pool.stage_out_arrays(payload)
        del payload
        hnp = [h.numpy() for h in hosts]
        order, start, count = _spill_plan(hnp[0], Pn, cap)
        staging = [[spill_pool.pinned_empty((Pn * mcap,) + tuple(h.shape[1:]),
                                            h.dtype, ctx.device)
                    for h in hosts] for _ in range(2)]
        last_read = [None, None]   # the copy event that last read each set

        def stage(k: int):
            bufs = staging[k % 2]
            if last_read[k % 2] is not None:
                last_read[k % 2].synchronize()
            bnp = [b.numpy() for b in bufs]
            bnp[0].fill(Pn)
            for b in bnp[1:]:
                b.fill(0)
            lo = k * C
            for i in range(Pn):
                rows = np.concatenate([
                    order[start[i, t] + min(lo, count[i, t]):
                          start[i, t] + min(lo + C, count[i, t])]
                    for t in range(Pn)])
                at = i * mcap
                for b, h in zip(bnp, hnp):
                    np.take(h, rows, axis=0, out=b[at:at + len(rows)])
            staged = spill_pool.stage_in_arrays(ctx, bufs, defer=True)
            last_read[k % 2] = staged.event
            return staged

        dm0 = _devmem_before(ctx)
        fold = _RoundFold(comm, counts, rounds, C, outcap_k, outcap_total,
                          rbytes, choice.peak_bytes, combine)
        pipe = HostPipeline(name="spill-exchange")
        with trace.span_sync("shuffle.exchange") as sp:
            nxt = pipe.submit(lambda: stage(0))
            for k in range(rounds):
                morsel = nxt.wait().ready()
                if k + 1 < rounds:
                    nxt = pipe.submit(lambda k=k: stage(k + 1))
                trace.count("spill.morsels")
                cnt_k, outs_k = _watchdog_dispatch(
                    "shuffle.exchange", lambda m=morsel: _exchange(
                        comm, m[0], m[1:], block, outcap_k), ctx.device)
                del morsel
                fold.add(k, cnt_k, outs_k)
                del cnt_k, outs_k
            acc, acc_cnt, acc_cap = fold.done()
            sp.sync(acc)
    finally:
        if pipe is not None:
            pipe.close()
        the_pool.release_transient(reserve)
    _note_exchange_ms(ctx, choice, dm0)
    return list(acc), acc_cnt, acc_cap


def _hierarchical_exchange(ctx, pid, leaves, counts: np.ndarray,
                           rbytes: int, outcap_total: int, choice,
                           combine=None):
    """Dispatch one two-level exchange (``hierarchical`` /
    ``hierarchical-combine``, sized by ``cost.hier_plan``): a fast-axis
    all_to_all routes every row (its pid riding as an extra int32 lane)
    to its target's fast coordinate, then a slow-axis ring keyed on
    ``pid // F`` delivers the slow hop.  The combine spelling folds the
    first stage's landing by (keys, pid) BEFORE the slow axis, and each
    slow round's received cell into the accumulator, so the slow edge
    carries per-group partials only (``groupby.axis_precombine_rows``)."""
    comm, Pn, L = ctx.comm, ctx.get_world_size(), ctx.get_local_world_size()
    S, F, block1, outcap1, block2, _outcap_ss = choice.sizes
    split = (S, F)
    dev = pid.device
    trace.count_max("shuffle.exchange_bytes_peak", choice.peak_bytes)
    dm0 = _devmem_before(ctx)
    try:
        with trace.span_sync("shuffle.exchange") as sp:
            tf = torch.where(pid < Pn, pid % F, F).to(torch.int32)
            cnt1, outs1 = _watchdog_dispatch(
                "shuffle.exchange", lambda: _exchange(
                    comm, tf, list(leaves) + [pid], block1, outcap1,
                    split=split), dev)
            pid_idx = len(leaves)
            landed = outs1[pid_idx].view(L, outcap1).to(torch.int64)
            valid1 = torch.arange(outcap1, device=dev) < cnt1[:, None]
            if combine is None:
                pid2 = torch.where(valid1 & (landed < Pn), landed // F,
                                   S).reshape(-1)
                cnt2, outs2 = _watchdog_dispatch(
                    "shuffle.exchange", lambda: _ring_exchange(
                        comm, pid2, outs1[:pid_idx], block2, outcap_total,
                        split=split), dev)
                sp.sync(outs2)
                return list(outs2), cnt2, outcap_total
            # combine path: axis-local pre-combine, then per-round folds
            trace.count("groupby.axis_precombine")
            key_slots, val_slots = combine
            spec2 = (tuple(key_slots) + ((pid_idx, None),),
                     tuple(val_slots))
            ngc, comb = _fold_combine(spec2, L, [(cnt1, outs1)], outcap1)
            trace.count("shuffle.fold_combined")
            cpid = comb[pid_idx].view(L, outcap1).to(torch.int64)
            cvalid = torch.arange(outcap1, device=dev) < ngc[:, None]
            ts = torch.where(cvalid & (cpid < Pn), cpid // F, S)  # [L, cap]
            c2 = torch.stack([(ts == s).sum(1) for s in range(S)], 1)
            c2c = read_counts(comm.all_gather(c2.to(torch.int32)))
            slow_of = np.arange(Pn) // F
            fast_of = np.arange(Pn) % F
            cross = c2c.copy()
            cross[np.arange(Pn), slow_of] = 0
            moved_slow = int(cross.sum())
            trace.count("shuffle.rows_sent_slow", moved_slow)
            trace.count("groupby.axis_precombine_rows", moved_slow)
            block_own = next_bucket(
                max(int(c2c[np.arange(Pn), slow_of].max(initial=0)), 1),
                minimum=8)
            block_x = next_bucket(max(int(cross.max(initial=0)), 1),
                                  minimum=8)
            me = (comm.first_rank + torch.arange(L, device=dev)) // F
            per_recv = np.zeros((Pn,), np.int64)
            acc = acc_cnt = None
            acc_cap = 0
            for r in range(S):
                blk_r = block_own if r == 0 else block_x
                src = ((slow_of - r) % S) * F + fast_of
                per_recv += c2c[src, slow_of]
                out_cap = next_bucket(max(int(per_recv.max(initial=0)), 1),
                                      minimum=8)
                rcnt, cells = _watchdog_dispatch(
                    "shuffle.exchange",
                    lambda blk=blk_r, rr=r: _slow_cell(
                        comm, ts, comb, me, S, rr, blk, split), dev)
                parts = ([(rcnt, cells)] if acc is None
                         else [(acc_cnt, acc), (rcnt, cells)])
                acc_cnt, acc = _fold_combine(spec2, L, parts, out_cap)
                trace.count("shuffle.fold_combined")
                trace.count_max("shuffle.exchange_bytes_peak",
                                choice.peak_bytes
                                + (acc_cap + out_cap) * rbytes)
                acc_cap = out_cap
            sp.sync(acc)
            return list(acc[:pid_idx]), acc_cnt, acc_cap
    finally:
        _note_exchange_ms(ctx, choice, dm0)


def _slow_cell(comm, ts, leaves, me, S: int, r: int, block: int, split):
    """One slow-ring round of the hierarchical COMBINE path: each shard
    compacts its rows bound for slow group (me + r) % S into a [block]
    cell and (r > 0) permutes it r hops along the slow axis.  Returns
    (received count [L], received leaves [L*block])."""
    L = comm.local
    dev = ts.device
    idx, cnt = _compact_rows(ts == ((me + r) % S)[:, None], block)
    valid = torch.arange(block, device=dev) < cnt[:, None]
    perm = {"split": split, "axis": "slow"}
    rcnt = cnt if r == 0 else comm.ppermute(cnt, r, **perm)
    rvalid = torch.arange(block, device=dev) < rcnt[:, None]
    outs: List[torch.Tensor] = [None] * len(leaves)
    for M, positions, dtypes in ops_gather.pack_columns(leaves):
        C = _where_rows(valid, _gather_rows(M, L, idx))
        if r:
            C = _where_rows(rvalid, comm.ppermute(C, r, **perm))
        C = C.reshape(L * block, M.shape[1])
        for col, p in zip(ops_gather.unpack_columns(C, dtypes), positions):
            outs[p] = col
    return rcnt.to(torch.int32), outs


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def shuffle_leaves(ctx, pid: torch.Tensor, leaves: Sequence[torch.Tensor],
                   owner: str = "", combine=None
                   ) -> Tuple[List[torch.Tensor], torch.Tensor, int]:
    """Repartition rows of flat ``[P*cap]`` ``leaves`` by target ids ``pid``
    (int32 ``[P*cap]``; padding rows carry P and are dropped).  A leaf with
    trailing dimensions (``[P*cap, M]`` sketch state) moves by row.

    The count matrix goes through the optimistic count protocol
    (``ops/compact.optimistic_dispatch``) under the shuffle signature
    ``(device, P, rows)``: with a size hint the single-shot exchange is
    dispatched at the hinted (block, outcap) while the counts travel to
    the host, and redone if undersized; inside ``run_pipeline`` its
    validation is deferred to the region's one batched read.  The count
    matrix's ``post`` counts the rows that leave their shard
    (``_account``) and runs the costed chooser under
    ``resilience.exchange_budget(ctx.device)``: a feasible single-shot
    keeps the fast path; a non-single-shot choice marks the signature
    degraded and runs the chosen lowering (inside a deferred flush the
    flush is invalidated instead, and the replay takes the degraded
    branch).  A degraded signature (or a demoted recovery attempt,
    ``resilience.exchange_demotions``) skips the optimism, waits for the
    counts and re-chooses every call, self-promoting back to single-shot
    once it fits.  An abstract plan run (meta tensors) prices from zeroed
    counts and never degrades.

    ``owner="groupby"`` attributes the bytes to ``groupby.bytes_moved``;
    ``combine`` — the ``(key_slots, val_slots)`` leaf spec of a
    partial-group table (``dist_ops._combine_leaf_spec``) — lets the
    chunked and hierarchical lowerings fold rounds by key.  Spans:
    ``shuffle.counts`` (the count matrix) and ``shuffle.exchange`` (the
    count read and the single-shot exchange; a degraded lowering runs in
    a ``shuffle.exchange`` span of its own).

    Returns ``(new_leaves [P*outcap], counts [P], outcap)``.
    """
    from .. import resilience
    comm = ctx.comm
    Pn = comm.world
    trace.count("shuffle.exchanges")
    rbytes = max(row_bytes(leaves), 1)
    split = _axis_split_of(ctx)
    sig = (str(ctx.device), Pn, pid.shape[0])
    with trace.span("shuffle.counts"):
        cnt_dev = _counts(comm, pid)
    # an abstract plan run prices from zeroed counts and must never
    # degrade: the budget guardrail is a runtime concern
    budget = None if is_abstract(pid) \
        else resilience.exchange_budget(ctx.device)
    cap = pid.shape[0] // max(comm.local, 1)
    mine = (comm.first_rank, comm.local)

    def dispatch(sizes):
        return _watchdog_dispatch(
            "shuffle.exchange",
            lambda: _exchange(comm, pid, leaves, sizes[0], sizes[1]),
            ctx.device)

    def post(counts):
        # exchange-volume accounting lives HERE, not after the dispatch:
        # post() sees the count matrix in immediate mode AND at the
        # deferred flush, so a pipeline tallies the rows and bytes a
        # blocking run would
        _account(counts, rbytes, combine, owner, split=split, mine=mine)
        block, outcap, per_recv = cost.exchange_sizes(counts)
        _warn_skew(Pn, sig, per_recv, outcap)
        need = (block, outcap)
        if budget is None:
            # abstract plan run: static pricing from zeroed counts —
            # never degrades; the annotation keeps the strategy surface
            # visible in the static EXPLAIN
            plan_check.annotate_append(
                "exchange", "single-shot (static: priced from zeroed "
                            "counts; re-chosen per execution)")
            return need
        # the costed chooser: a non-single-shot choice aborts the
        # optimistic dispatch instead of allocating it.  In immediate
        # mode the raise carries the choice out.  Inside a deferred
        # flush, raising would corrupt the batch walk: the hinted
        # dispatch already RAN (its output is valid — hints are sizes,
        # and over budget is not undersized), so mark the signature,
        # fail the flush, and let the replay re-enter through the
        # degraded branch below (which re-chooses)
        choice, reason, _ = _choose(Pn, cap, counts, rbytes, budget,
                                    combine, ctx=ctx)
        if choice.strategy == cost.SINGLE_SHOT:
            _note_choice(choice, reason, nparts=comm.local)
            return need
        _mark_degraded(sig)
        if ops_compact.in_flush():
            ops_compact.invalidate_flush()
        else:
            # drop the stale optimism before aborting the dispatch (in
            # the flush path update_size_hint re-records need right after
            # post() returns; the _chunked_keys gate is what keeps an
            # over-budget hint from being dispatched, and promotion
            # overwrites it)
            with _chunk_lock:
                _block_hints.pop(sig, None)
            raise _OverBudget(np.asarray(counts).copy(), need, choice,
                              reason)
        return need

    if (sig in _chunked_keys or resilience.exchange_demotions()) \
            and budget is not None:
        # degraded steady state — or a demoted recovery attempt (the
        # replanned re-execution must not re-dispatch the single-shot
        # exchange that just failed): skip the optimistic dispatch (its
        # single-shot exchange is what blew the budget), wait for the
        # counts — riding the region's batched read in deferred mode —
        # and re-choose: the chooser picks a degraded lowering again or
        # self-promotes the signature back to single-shot
        counts = read_counts(cnt_dev)
        _account(counts, rbytes, combine, owner, split=split, mine=mine)
        block, outcap, per_recv = cost.exchange_sizes(counts)
        _warn_skew(Pn, sig, per_recv, outcap)
        need = (block, outcap)
        choice, reason, _ = _choose(Pn, cap, counts, rbytes, budget,
                                    combine, ctx=ctx)
        _note_choice(choice, reason, nparts=comm.local)
        if choice.strategy == cost.SINGLE_SHOT:
            # this call prices back under budget (the data shrank):
            # promote to the single-shot path and reseed the optimism
            # for the NEXT same-signature call
            _mark_promoted(sig, reseed=need)
            trace.count_max("shuffle.exchange_bytes_peak",
                            choice.peak_bytes)
            dm0 = _devmem_before(ctx)
            with trace.span_sync("shuffle.exchange") as sp:
                newcounts, outs = dispatch(need)
                sp.sync(outs)
            _note_exchange_ms(ctx, choice, dm0)
            return outs, newcounts, outcap
        return _degraded(ctx, pid, leaves, counts, rbytes, budget, outcap,
                         choice, combine)

    try:
        dm0 = _devmem_before(ctx)
        with trace.span_sync("shuffle.exchange") as sp:
            (newcounts, outs), used, _ = ops_compact.optimistic_dispatch(
                _block_hints, sig, dispatch, cnt_dev, post)
            sp.sync(outs)
    except _OverBudget as ob:
        # the hinted dispatch (if any) was launched before the counts came
        # back — its result is discarded; the chosen degraded lowering
        # recovers from the counts the exception carries
        _note_choice(ob.choice, ob.reason, nparts=comm.local)
        return _degraded(ctx, pid, leaves, ob.counts, rbytes, budget,
                         ob.need[1], ob.choice, combine)
    if budget is not None:
        price = cost.price_single_shot(Pn, used[0], used[1], rbytes)
        trace.count_max("shuffle.exchange_bytes_peak", price.peak_bytes)
        _note_exchange_ms(ctx, price, dm0)
    return outs, newcounts, used[1]


def _degraded(ctx, pid, leaves, counts: np.ndarray, rbytes: int,
              budget: int, outcap: int, choice, combine):
    """Run the non-single-shot lowering ``choice`` picked."""
    if choice.strategy == cost.CHUNKED:
        return _chunked_exchange(ctx, pid, leaves, counts, rbytes, budget,
                                 outcap, combine, plan=choice.sizes,
                                 choice=choice)
    if choice.strategy == cost.STAGED_SPILL:
        return _staged_spill_exchange(ctx, pid, leaves, counts, rbytes,
                                      budget, outcap, choice, combine)
    if choice.strategy in (cost.HIERARCHICAL, cost.HIER_COMBINE):
        return _hierarchical_exchange(ctx, pid, leaves, counts, rbytes,
                                      outcap, choice, combine)
    return _staged_exchange(ctx, pid, leaves, choice, outcap)
