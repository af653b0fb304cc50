"""Distributed Table: columns as P fixed-capacity row shards.

Mirror of ``cylon_tpu/parallel/dtable.py``, with the same layout: each
column is ONE flat tensor of shape ``[L * cap]`` on the context's device,
one block per LOCAL rank (``L = P`` with one process) — local shard *i*
holds rows ``[i*cap, i*cap + counts[i])``; the rest of its block is zero
padding.  ``counts`` is an int32 ``[L]`` tensor on the device.  ``cap`` is
the same in every process of a world that spans processes; host reads of
the counts (``counts_host``, ``num_rows``) and the exports are GLOBAL and
the same in every process, as the JAX package's replicated counts and
export are.

The reference has no separate distributed-table type: an ``arrow::Table``
per rank *is* the partition (reference: cpp/src/cylon/table.hpp:39-278).
Here all P ranks' shards live in one process, so the partitioned state is
a first-class object, as in the JAX package.

The host tier: ``spill()`` moves the leaves to the spill pool
(``spill/pool.py``) and drops the device tensors; ``columns`` and
``counts`` are properties that fault them back in on first device use.
Metadata (names, dtypes, row counts) answers host-side without a
fault-in.

Ingest (``from_arrow`` / ``from_pandas`` / ``from_partitions`` /
``from_table``) assembles each column's padded ``[P*cap]`` block on the
host and hands it to ``StagedIngest``: on the card the blocks are built
in a page-locked staging arena and copied on the copy stream while the
next column is assembled.  String columns carry ONE host dictionary
shared by all shards; ``from_partitions`` re-encodes per-partition
dictionaries onto a merged one.  ``append`` grows a table in place and
bumps its ``content_epoch``.
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..analysis._abstract import is_abstract
from ..context import CylonContext
from ..dtypes import DataType, is_dictionary_encoded
from ..ops import compact as ops_compact
from ..ops.compact import to_device
from ..ops.gather import signed_view
from ..status import Code, CylonError, Status
from ..table import Column, Table, host_batch


class _SpilledLeaf:
    """Placeholder leaf of a spilled column: metadata stays readable, and
    any device use that bypasses the fault-in fails loudly."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<spilled>"


_SPILLED = _SpilledLeaf()


@dataclass
class DColumn:
    """One distributed column: ``[P*cap]`` data + optional bool validity."""

    name: str
    dtype: DataType
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None
    dictionary: Optional[np.ndarray] = None
    arrow_type: Any = None


def _block_layout(n: int, Pn: int, cap: Optional[int]):
    """Sizes, offsets and ``cap`` of a block distribution of ``n`` rows
    over ``Pn`` shards: shard *i* gets the i-th contiguous slice, the first
    ``n % Pn`` shards one row more."""
    base, rem = divmod(n, Pn)
    sizes = np.array([base + (1 if i < rem else 0) for i in range(Pn)],
                     np.int32)
    if cap is None:
        cap = ops_compact.next_bucket(max(int(sizes.max(initial=0)), 1),
                                      minimum=8)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return sizes, offs, cap


class DTable:
    """Partitioned table: padded per-shard blocks + valid counts.

    ``pending_mask`` (set only by ``dist_select(compact=False)``) is a
    deferred row filter: a [P*cap] bool mask, already AND'ed with the
    valid-row mask, not yet compacted; ``pending_cnts`` holds its [P]
    survivor counts.  Consumers that fold a row mask into their own work
    (groupby / aggregate ``where``, further selects) read it; every other
    operator first calls ``_collapse_pending()``, which compacts in place,
    so no result depends on a consumer knowing about the mask."""

    def __init__(self, ctx: CylonContext, columns: List[DColumn], cap: int,
                 counts: torch.Tensor,
                 pending_mask: Optional[torch.Tensor] = None,
                 pending_cnts: Optional[torch.Tensor] = None):
        self.ctx = ctx
        # host-tier state: while _spill_entry is set the leaves live in the
        # spill pool and the columns / counts properties fault them back
        # in.  _spill_sig is the content signature: it survives a fault-in
        # (an unchanged table re-spills without a device read) and is
        # cleared whenever the contents change (_collapse_pending)
        self._spill_entry = None
        self._spill_sig: Optional[int] = None
        self.columns = columns
        self.cap = int(cap)
        self.counts = counts               # [P] int32
        self.pending_mask = pending_mask   # [P*cap] bool or None
        self.pending_cnts = pending_cnts   # [P] survivor counts or None
        self._counts_host: Optional[np.ndarray] = None
        # the content epoch: bumped by every change of the logical
        # contents made through the ingest path (append).  _deltas holds
        # the last few appended batches keyed by the epoch each created,
        # so a consumer holding an older epoch can fold forward in
        # O(delta) instead of recomputing
        self._epoch: int = 0
        self._deltas: Dict[int, "DTable"] = {}

    # -- the host tier -------------------------------------------------------

    @property
    def columns(self) -> List[DColumn]:
        if self._spill_entry is not None:
            self._fault_in()
        return self._columns

    @columns.setter
    def columns(self, v: List[DColumn]) -> None:
        self._columns = v

    @property
    def counts(self) -> torch.Tensor:
        if self._spill_entry is not None:
            self._fault_in()
        return self._counts

    @counts.setter
    def counts(self, v: torch.Tensor) -> None:
        self._counts = v

    @property
    def is_spilled(self) -> bool:
        """Whether the leaves currently live host-side (spill pool)."""
        return self._spill_entry is not None

    def spill(self) -> "DTable":
        """Move this table's leaves to the host-tier spill pool and drop
        the device tensors.  Metadata (names, dtypes, row counts) stays
        readable host-side, any device use faults the leaves back in, and
        the morsel scan (``spill/morsel.py``) stages row slices straight
        from the pool.  Idempotent; returns self."""
        from ..spill import pool as spill_pool
        spill_pool.spill_table(self)
        return self

    def ensure_device(self) -> "DTable":
        """Fault spilled leaves back onto the device now (the eager form
        of the properties' transparent fault-in); returns self."""
        if self._spill_entry is not None:
            self._fault_in()
        return self

    def _fault_in(self) -> None:
        from ..spill import pool as spill_pool
        spill_pool.ensure_device(self)

    def _collapse_pending(self) -> None:
        """Materialize a deferred select IN PLACE (the handle keeps
        working for callers that hold it)."""
        if self.pending_mask is None:
            return
        from . import dist_ops  # runtime import: dist_ops imports this module
        mask, cnts = self.pending_mask, self.pending_cnts
        self.pending_mask = self.pending_cnts = None
        out = dist_ops._compact_survivors(
            self, mask, cnts,
            ("pmat", str(self.ctx.device), self.cap, self.num_columns))
        self.columns = out.columns
        self.cap = out.cap
        self.counts = out.counts
        self._counts_host = None
        self._spill_sig = None  # new contents: a pooled copy no longer matches

    # -- shape ---------------------------------------------------------------

    @property
    def nparts(self) -> int:
        """P, the shards of the whole world."""
        return self.ctx.get_world_size()

    @property
    def nlocal(self) -> int:
        """L, the shards this process holds (the leading axis of its
        leaves and counts)."""
        return self.ctx.get_local_world_size()

    @property
    def num_columns(self) -> int:
        return len(self._columns)   # metadata: never faults a spill in

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self._columns]

    def counts_host(self) -> np.ndarray:
        """Per-shard valid row counts of all P shards on the host (one
        read, then cached; a spilled table answers from the counts cached
        at its spill).  Across processes the counts are all-gathered
        first, so every process reads the same ``[P]``.
        Inside a deferred region the read rides the region's batched
        flush (queued validations first; an undersized one aborts for
        replay instead of materializing poisoned counts)."""
        self._collapse_pending()
        if self._counts_host is not None:
            return self._counts_host
        if is_abstract(self._counts):
            # abstract plan run: the counts of a derived table are data-
            # dependent by definition — a plan that needs them on the
            # host is a plan that cannot be checked without executing
            raise CylonError(Status(Code.ExecutionError,
                "plan_check: host row counts of a derived table are "
                "data-dependent (only ingest-cached counts are known "
                "at plan time)"))
        cnt = self.counts
        if self.ctx.get_process_count() > 1:
            cnt = self.ctx.comm.all_gather(cnt)
        self._counts_host = ops_compact.read_host(cnt)
        return self._counts_host

    @property
    def num_rows(self) -> int:
        return int(self.counts_host().sum())

    def column(self, i: Union[int, str]) -> DColumn:
        return self.columns[self.column_index(i)]

    def column_index(self, i: Union[int, str]) -> int:
        if isinstance(i, str):
            for j, c in enumerate(self._columns):   # metadata only
                if c.name == i:
                    return j
            raise CylonError(Status(Code.KeyError, f"no column {i!r}"))
        return i

    def verify_same_schema(self, other: "DTable") -> None:
        """reference: table_api.cpp:566 (VerifyTableSchema)."""
        if self.num_columns != other.num_columns:
            raise CylonError(Status(Code.Invalid,
                f"column count mismatch {self.num_columns} vs {other.num_columns}"))
        for a, b in zip(self._columns, other._columns):
            if a.dtype.type != b.dtype.type:
                raise CylonError(Status(Code.TypeError,
                    f"type mismatch {a.name}:{a.dtype.type.name} vs "
                    f"{b.name}:{b.dtype.type.name}"))

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_table(ctx: CylonContext, table: Table, cap: Optional[int] = None
                   ) -> "DTable":
        """Block-distribute a local table's rows over the P shards: shard
        *i* gets the i-th contiguous slice, the first ``n % P`` shards one
        row more.  The columns come to the host (their host copies where
        they carry them, else one batched read) and go back through
        ``StagedIngest``, as in the JAX package.  Across processes every
        process passes the same table (SPMD inputs) and keeps the slices
        of its own ranks."""
        sizes, offs, cap = _block_layout(table.num_rows,
                                         ctx.get_world_size(), cap)
        lsizes, loffs = _local_slice(ctx, sizes, offs)
        hosts, valids = _host_leaves(table.columns)
        cols: List[DColumn] = []
        staged = StagedIngest(ctx)
        try:
            for c, hd, hv in zip(table.columns, hosts, valids):
                cols.append(DColumn(
                    c.name, c.dtype, staged.put(hd, lsizes, loffs, cap),
                    None if hv is None else staged.put(hv, lsizes, loffs,
                                                       cap),
                    c.dictionary, c.arrow_type))
        finally:
            staged.finish()
        return DTable._ingested(ctx, cols, cap, sizes)

    @staticmethod
    def _ingested(ctx: CylonContext, cols: List[DColumn], cap: int,
                  sizes: np.ndarray) -> "DTable":
        """The ingested table; ``sizes`` are all P shards' row counts."""
        r0 = ctx.get_rank()
        local = sizes[r0:r0 + ctx.get_local_world_size()]
        out = DTable(ctx, cols, cap, to_device(local.copy(), ctx.device))
        # ingest knows the per-shard sizes statically: cached, so planners
        # (the broadcast threshold) never pay a host read here
        out._counts_host = sizes.copy()
        return out

    @staticmethod
    def from_arrow(ctx: CylonContext, atable, cap: Optional[int] = None
                   ) -> "DTable":
        """Block-distribute an arrow table directly from host memory (no
        intermediate single-device Table).  Across processes: the same
        table in every process, each keeping its own ranks' slices."""
        from ..table import host_columns_from_arrow
        sizes, offs, cap = _block_layout(atable.num_rows,
                                         ctx.get_world_size(), cap)
        sizes_l, offs_l = _local_slice(ctx, sizes, offs)
        cols: List[DColumn] = []
        staged = StagedIngest(ctx)
        try:
            for name, t, npv, mask, dictionary, ftype in \
                    host_columns_from_arrow(atable):
                data = staged.put(npv, sizes_l, offs_l, cap)
                validity = (None if mask is None else
                            staged.put(mask.astype(bool), sizes_l, offs_l,
                                       cap))
                cols.append(DColumn(name, DataType(t), data, validity,
                                    dictionary, ftype))
        finally:
            staged.finish()
        return DTable._ingested(ctx, cols, cap, sizes)

    @staticmethod
    def from_pandas(ctx: CylonContext, df, cap: Optional[int] = None
                    ) -> "DTable":
        import pyarrow as pa

        return DTable.from_arrow(
            ctx, pa.Table.from_pandas(df, preserve_index=False), cap)

    @staticmethod
    def from_partitions(ctx: CylonContext, parts: Sequence[Table],
                        cap: Optional[int] = None) -> "DTable":
        """Build from one local Table per shard (the per-rank-CSV ingest
        path: reference examples/bench/table_join_dist_test.cpp:87-91 reads
        ``csv1_<rank>.csv`` on each rank).  Per-partition dictionaries are
        re-encoded onto their sorted union.  Across processes each process
        passes the partitions of its OWN ranks; the row counts, ``cap``
        (the largest partition's bucket) and the dictionary union are
        agreed through one host all-gather."""
        Ln = ctx.get_local_world_size()
        if len(parts) != Ln:
            raise CylonError(Status(Code.Invalid,
                f"{len(parts)} partitions for {Ln} local shards of a "
                f"{ctx.get_world_size()}-shard world"))
        head = parts[0]
        for p in parts[1:]:
            head.verify_same_schema(p)
        lsizes = np.array([p.num_rows for p in parts], np.int32)
        offs = np.concatenate([[0], np.cumsum(lsizes)])
        dict_cols = [j for j, c0 in enumerate(head.columns)
                     if is_dictionary_encoded(c0.dtype.type)]
        agreed = ctx.comm.all_gather_object(
            (lsizes, {j: [p.columns[j].dictionary for p in parts]
                      for j in dict_cols},
             [j for j in range(head.num_columns)
              if any(p.columns[j].validity is not None for p in parts)]))
        nullable = {j for a in agreed for j in a[2]}
        sizes = np.concatenate([a[0] for a in agreed]).astype(np.int32)
        if cap is None:
            cap = ops_compact.next_bucket(max(int(sizes.max(initial=0)), 1),
                                          minimum=8)
        cols: List[DColumn] = []
        staged = StagedIngest(ctx)
        try:
            for j, c0 in enumerate(head.columns):
                pcols = [p.columns[j] for p in parts]
                hosts, valids = _host_leaves(pcols)
                dictionary = None
                if is_dictionary_encoded(c0.dtype.type):
                    dicts = [pc.dictionary for pc in pcols]
                    every = [d for a in agreed for d in a[1][j]]
                    dictionary = np.unique(np.concatenate(every)) if any(
                        len(d) for d in every) else every[0]
                    # an empty-dictionary partition holds only null rows
                    # (the sorted-encode invariant): zero its codes so
                    # nothing decodes against the merged dictionary
                    hosts = [np.searchsorted(dictionary, d)[h].astype(np.int32)
                             if len(d) else np.zeros_like(h, dtype=np.int32)
                             for h, d in zip(hosts, dicts)]
                data = staged.put(np.concatenate(hosts), lsizes, offs, cap)
                validity = None
                if j in nullable:
                    validity = staged.put(np.concatenate(
                        [np.ones(len(h), bool) if v is None else v
                         for h, v in zip(hosts, valids)]), lsizes, offs, cap)
                cols.append(DColumn(c0.name, c0.dtype, data, validity,
                                    dictionary, c0.arrow_type))
        finally:
            staged.finish()
        return DTable._ingested(ctx, cols, cap, sizes)

    # -- export --------------------------------------------------------------

    def _export(self, takes: Sequence[int]) -> Table:
        """Gather ``takes[i]`` leading rows of each of the P shards as a
        local Table (the same in every process).

        Rows are compacted on the device (one gather per column), then
        every gathered tensor comes to the host in ONE batched transfer
        (inside a deferred region, the same read as the region's flush);
        the host copies ride along on the columns, so ``to_arrow`` reads
        nothing back.  On an abstract table the gathered meta tensors
        ARE the export: an abstract local Table, no transfer
        (``Table.to_arrow`` marks the plan boundary)."""
        self._collapse_pending()
        dev = self.ctx.device
        abstract = self._is_abstract()
        leaf = self._global_leaf if sum(takes) else (lambda x: x)
        if abstract:
            idx = torch.empty((int(sum(takes)),), dtype=torch.int64,
                              device=dev)
        else:
            idx_host = np.concatenate(
                [i * self.cap + np.arange(t, dtype=np.int64)
                 for i, t in enumerate(takes)]) if sum(takes) else \
                np.empty((0,), np.int64)
            idx = to_device(idx_host, dev)
        pulls = []
        for c in self.columns:
            pulls.append(signed_view(leaf(c.data))[idx].view(c.data.dtype))
            if c.validity is not None:
                pulls.append(leaf(c.validity)[idx])
        if abstract:
            cols: List[Column] = []
            hi = 0
            for c in self.columns:
                d = pulls[hi]
                hi += 1
                v = None
                if c.validity is not None:
                    v = pulls[hi]
                    hi += 1
                cols.append(Column(c.name, c.dtype, d, v,
                                   dictionary=c.dictionary,
                                   arrow_type=c.arrow_type))
            return Table(self.ctx, cols)
        if ops_compact.deferred_mode():
            ok, hosts = ops_compact.flush_pending_with(pulls)
            if not ok:
                # inside a failed deferred attempt: abort for replay
                # rather than hand truncated rows to the caller
                ops_compact._abort_if_poisoned()
        else:
            from .. import trace
            trace.count("host.read")  # one batched export transfer
            hosts = host_batch(pulls)
        return Table(self.ctx, self._columns_from_host(pulls, hosts))

    def _global_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ([L*cap] local blocks) as the ``[P*cap]`` blocks of every
        rank: an all-gather across processes (the export gives every
        process the global rows, as the JAX package's does), ``x``
        itself with one process."""
        comm = self.ctx.comm
        if comm.nproc == 1:
            return x
        tail = tuple(x.shape[1:])
        return comm.all_gather(x.view((comm.local, self.cap) + tail)
                               ).reshape((comm.world * self.cap,) + tail)

    def _is_abstract(self) -> bool:
        """Whether this table's leaves are meta tensors (an abstract plan
        run, ``analysis/plan_check``)."""
        return is_abstract(self._counts) or any(
            is_abstract(c.data) for c in self._columns)

    def _columns_from_host(self, devs: Sequence[torch.Tensor],
                           hosts: Sequence[np.ndarray]) -> List[Column]:
        """Unflatten gathered device tensors and their host copies (data,
        then validity where nullable, per column) into local Columns that
        carry their host copies."""
        cols: List[Column] = []
        hi = 0
        for c in self.columns:
            data, hd = devs[hi], hosts[hi]
            hi += 1
            validity, hv = None, None
            if c.validity is not None:
                validity, hv = devs[hi], hosts[hi]
                hi += 1
            cols.append(Column(c.name, c.dtype, data, validity,
                               dictionary=c.dictionary,
                               arrow_type=c.arrow_type,
                               host_data=hd, host_validity=hv))
        return cols

    def to_table(self) -> Table:
        """Gather all shards to one local Table (drops padding).  On an
        abstract table the export gathers the capacity bound (row counts
        are data-dependent; shapes are what the plan check checks)."""
        if self._is_abstract():
            self._collapse_pending()
            return self._export([self.cap] * self.nparts)
        return self._export([int(c) for c in self.counts_host()])

    def head(self, n: int) -> Table:
        """First ``n`` global rows (shard-major order) as a local Table.

        One read of the counts, then a gather of just the rows taken (the
        JAX package's counts-based export; its fused path for small ``n``
        saves a TPU round trip and returns the same rows)."""
        self._collapse_pending()
        n_eff = min(int(n), self.nparts * self.cap)
        if self._is_abstract() and n_eff > 0:
            # abstract plan run: per-shard takes are data-dependent —
            # export the capacity bound instead
            return self._export([min(n_eff, self.cap)] * self.nparts)
        takes, remaining = [], max(n_eff, 0)
        for c in self.counts_host():
            t = min(int(c), remaining)
            takes.append(t)
            remaining -= t
        return self._export(takes)

    def partition(self, i: int) -> Table:
        """Shard *i*'s rows as a local Table (a rank's-eye view)."""
        cnts = self.counts_host()
        return self._export([int(cnts[j]) if j == i else 0
                             for j in range(self.nparts)])

    def rename(self, names: Sequence[str]) -> "DTable":
        out = DTable(self.ctx, [replace(c, name=n)
                                for c, n in zip(self.columns, names)],
                     self.cap, self.counts, self.pending_mask,
                     self.pending_cnts)
        out._counts_host = self._counts_host  # same rows, same counts
        return out

    # -- the ingest-delta path ------------------------------------------------

    @property
    def content_epoch(self) -> int:
        """Monotone version of this handle's logical contents.  Layout
        changes (compaction, spill round trips, a re-mesh) do not bump it;
        only the ingest path (:meth:`append`) does."""
        return self._epoch

    def delta_for(self, epoch: int) -> Optional["DTable"]:
        """The appended batch that moved this table TO ``epoch``, while it
        is still retained (the input of an O(delta) fold)."""
        return self._deltas.get(epoch)

    # appended batches that stay reachable for folding; a consumer more
    # epochs behind recomputes (bounded, so a table ingesting forever
    # does not retain its whole history)
    _DELTA_KEEP = 8

    def append(self, other: "DTable") -> "DTable":
        """UNION ALL ``other``'s rows into THIS handle, in place.

        Identity-preserving: every holder of this handle observes the
        grown table.  The merge round-trips through Arrow (decode, concat,
        re-ingest), which re-buckets ``cap`` and rebuilds dictionary
        columns on the sorted union.  A spilled table's pooled host copy
        describes the old contents and is dropped, and so are replicas
        cached from the old columns.  The batch is kept under the new
        content epoch.  Returns ``self``."""
        import pyarrow as pa

        from . import broadcast
        self.verify_same_schema(other)
        spilled_sig = (self._spill_entry.sig
                       if self._spill_entry is not None else None)
        merged = pa.concat_tables(
            [self.to_table().to_arrow(), other.to_table().to_arrow()]
        ).combine_chunks()
        grown = DTable.from_arrow(self.ctx, merged)
        if spilled_sig is not None:
            from ..spill.pool import get_pool
            get_pool().drop_entry(spilled_sig)
        broadcast.forget_replicas_of(self._columns)
        self._spill_entry = None
        self._spill_sig = None
        self._columns = grown._columns
        self.cap = grown.cap
        self._counts = grown._counts
        self.pending_mask = None
        self.pending_cnts = None
        self._counts_host = grown._counts_host
        self._epoch += 1
        self._deltas[self._epoch] = other
        for e in sorted(self._deltas):
            if len(self._deltas) <= self._DELTA_KEEP:
                break
            del self._deltas[e]
        return self

    def explain(self, plan=None, *, tables=None, validate: bool = False,
                analyze: bool = False, optimize: bool = False,
                concrete: Sequence[str] = ()):
        """Describe, check or measure a plan.

        ``dt.explain()`` returns a structural summary of the table itself;
        with ``validate=True`` it first checks the shape invariants the
        kernels assume (counts dtype and width, leaf lengths, validity
        dtypes, dictionary sort order, the pending mask).

        ``dt.explain(plan, tables=..., analyze=True)`` is **EXPLAIN
        ANALYZE**: ``plan`` (a callable receiving this table, or the dict
        ``tables``) runs FOR REAL, once, with tracing on and every
        distributed operator instrumented; the returned ``PlanReport``'s
        nodes carry rows in/out, bytes moved, the planner's decision and
        wall-clock, and ``report.output`` holds the result.
        ``optimize=True`` routes the plan through the logical planner
        first, so the report describes the OPTIMIZED plan (rule fires as
        ``optimizer=…`` annotations, the plan-cache traffic in
        ``totals["optimizer"]``).

        ``dt.explain(plan, tables=..., validate=..., concrete=...)``
        without ``analyze`` is the static form: the plan is abstract-
        interpreted over meta tensors (``analysis.plan_check.explain``) —
        every operator's shapes and dtypes are checked, no row moves, no
        count is read and no kernel launches — and the returned
        ``PlanReport`` lists the operators and the result schema;
        ``validate=True`` raises ``PlanValidationError`` on a plan bug.
        ``concrete`` names tables of ``tables`` whose values the plan
        reads at build time (the TPC-H queries' nation and region
        lookups); it does not apply to an analyze run."""
        from ..analysis import plan_check
        if plan is None:
            if analyze:
                raise CylonError(Status(Code.Invalid,
                    "explain(analyze=True) needs a plan callable — there "
                    "is nothing to run"))
            if validate:
                plan_check._check_table("explain", self)
            cols = ", ".join(f"{c.name}:{c.dtype.type.name}"
                             for c in self._columns)
            ch = self._counts_host
            rows = (f"{int(ch.sum())} rows" if ch is not None
                    else "rows data-dependent")
            mask = ", deferred-select mask pending" \
                if self.pending_mask is not None else ""
            spilled = ", spilled to host" if self.is_spilled else ""
            return (f"DTable[{rows} over {self.nparts} shards, "
                    f"cap={self.cap}{mask}{spilled}]({cols})")
        target = tables if tables is not None else self
        op = plan
        if optimize:
            from .. import plan as planner
            ctx = self.ctx

            def op(tgt, _plan=plan, _ctx=ctx):  # noqa: F811 — optimized form
                return planner.run(_ctx, _plan, tgt)
        if analyze:
            from .. import observe
            return observe.analyze(op, target)
        return plan_check.explain(op, target, validate=validate,
                                  concrete=concrete)

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.type.name}"
                         for c in self._columns)
        spilled = ", spilled to host" if self.is_spilled else ""
        # an abstract table (a plan run) says so: a repr (a user print, a
        # debugger, an error formatter) must never read counts
        rows = ("abstract rows, " if self._counts_host is None
                and is_abstract(self._counts) else "")
        return (f"DTable[{rows}P={self.nparts}, cap={self.cap}{spilled}]"
                f"({cols})")


def _local_slice(ctx: CylonContext, sizes: np.ndarray, offs: np.ndarray):
    """The block layout's sizes and offsets of this process's ranks."""
    r0, L = ctx.get_rank(), ctx.get_local_world_size()
    return sizes[r0:r0 + L], offs[r0:r0 + L + 1]


def _host_leaves(cols: Sequence[Column]):
    """(host data, host validity or None) per local column: their host
    copies, every missing one in one batched read."""
    pulled = iter(host_batch(
        [c.data for c in cols if c.host_data is None]
        + [c.validity for c in cols
           if c.validity is not None and c.host_validity is None]))
    data = [np.asarray(c.host_data) if c.host_data is not None
            else next(pulled) for c in cols]
    valid = [None if c.validity is None else np.asarray(
        c.host_validity if c.host_validity is not None else next(pulled),
        bool) for c in cols]
    return data, valid


# ---------------------------------------------------------------------------
# staged ingest
# ---------------------------------------------------------------------------

_ARENA_CAP = 256 << 20
_arena = None
_arena_lock = threading.Lock()
# diagnostic switch (the ingest A/B): False stages every column in a
# one-off block even on the card
ARENA_ENABLED = True


class StagedIngest:
    """One table's staged host→device transfers through the shared arena.

    Each column's padded ``[P*cap]`` block is assembled in a block
    bump-allocated from the shared ``StagingArena`` (reference: the role
    ctx/memory_pool.hpp:25-66 plays on its ingest path) and copied to the
    device ``non_blocking`` on the copy stream, so a column's transfer
    overlaps the next column's assembly.  ``finish()`` makes the
    consumer's stream wait for the copies, blocks ONCE until they have
    read their host blocks, and only then resets the arena.

    On the CPU a device tensor aliases its numpy block, so a reused block
    would clobber a live column: the arena engages only for a card (or
    with ``force_arena``, where each CPU column is copied out of the
    arena).  The arena has one owner at a time: a second concurrent
    ingest, a column that does not fit what is left, and any ingest with
    ``ARENA_ENABLED`` false take one-off blocks (page-locked on a card,
    so the copy stays asynchronous)."""

    def __init__(self, ctx: CylonContext, force_arena: bool = False):
        global _arena
        self._dev = ctx.device
        self._cuda = self._dev.type == "cuda"
        self._owns_arena = False
        self._arena = None
        if (self._cuda or force_arena) and ARENA_ENABLED:
            # exclusive ownership: a second concurrent ingest must not
            # reset the arena under the first one's in-flight copies
            if _arena_lock.acquire(blocking=False):
                self._owns_arena = True
                # a card stages from page-locked memory, the CPU from a
                # numpy buffer: the arena is made for the device in use
                if _arena is None or _arena.pinned != self._cuda:
                    from ..native.runtime import StagingArena
                    _arena = StagingArena(_ARENA_CAP, device=self._dev)
                self._arena = _arena
        self._pending: List[torch.Tensor] = []
        self._sources: List[torch.Tensor] = []   # host blocks being read
        self.one_off_blocks = 0   # blocks that did not come from the arena
        self.done = None          # the copy stream's event (set by finish)

    def _host_block(self, nbytes: int):
        """(uint8 host tensor of ``nbytes``, whether it is arena memory)."""
        if self._arena is not None:
            try:
                return self._arena.allocate_tensor(nbytes), True
            except MemoryError:
                pass
        self.one_off_blocks += 1
        if self._cuda:
            from ..spill.pool import pinned_empty
            return pinned_empty((nbytes,), torch.uint8, self._dev), False
        return torch.empty(nbytes, dtype=torch.uint8), False

    def put(self, host: np.ndarray, sizes: np.ndarray, offs: np.ndarray,
            cap: int) -> torch.Tensor:
        """Assemble one column's padded shard blocks; start its copy.  The
        returned device tensor is for use after ``finish()``."""
        from ..dtypes import _TORCH_OF_NUMPY
        host = np.asarray(host)
        Pn = len(sizes)
        shape = (Pn * cap,) + tuple(host.shape[1:])
        nbytes = int(np.prod(shape, dtype=np.int64)) * host.dtype.itemsize
        raw, in_arena = self._host_block(max(nbytes, 1))
        src = raw[:nbytes].view(_TORCH_OF_NUMPY[host.dtype]).reshape(shape)
        with warnings.catch_warnings():
            # zero-copy Arrow buffers are read-only; they are only read
            warnings.simplefilter("ignore", UserWarning)
            rows = torch.from_numpy(np.ascontiguousarray(host))
        for i in range(Pn):
            # torch's CPU copy runs on the intra-op threads (numpy's on one)
            src[i * cap:i * cap + sizes[i]].copy_(rows[offs[i]:offs[i + 1]])
            src[i * cap + sizes[i]:(i + 1) * cap].zero_()
        if not self._cuda:
            out = src.clone() if in_arena else src
            return out.to(self._dev)
        from ..spill.pool import _copy_stream
        copy = _copy_stream(self._dev)
        with torch.cuda.stream(copy):
            out = torch.empty(shape, dtype=src.dtype, device=self._dev)
            out.copy_(src, non_blocking=True)
        self._pending.append(out)
        self._sources.append(raw)
        return out

    def finish(self) -> None:
        """Make the consumer's stream wait for the copies, wait once until
        they have read the host blocks, then reset and release the arena.
        Idempotent; callers run it in a ``finally``."""
        try:
            if self._cuda and self._pending:
                from ..spill.pool import _copy_stream
                done = torch.cuda.Event()
                done.record(_copy_stream(self._dev))
                consumer = torch.cuda.current_stream(self._dev)
                consumer.wait_event(done)
                for t in self._pending:
                    t.record_stream(consumer)
                self.done = done
                done.synchronize()   # the host blocks have been read
            if self._arena is not None:
                self._arena.reset()
        finally:
            self._pending = []
            self._sources = []
            self._arena = None
            if self._owns_arena:
                self._owns_arena = False
                _arena_lock.release()
