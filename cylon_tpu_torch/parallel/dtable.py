"""Distributed Table: columns as P fixed-capacity row shards.

Mirror of ``cylon_tpu/parallel/dtable.py``, with the same layout: each
column is ONE flat tensor of shape ``[P * cap]`` on the context's device —
shard *i* holds rows ``[i*cap, i*cap + counts[i])``; the rest of its block
is zero padding.  ``counts`` is an int32 ``[P]`` tensor on the device.

The reference has no separate distributed-table type: an ``arrow::Table``
per rank *is* the partition (reference: cpp/src/cylon/table.hpp:39-278).
Here all P ranks' shards live in one process, so the partitioned state is
a first-class object, as in the JAX package.

The host tier: ``spill()`` moves the leaves to the spill pool
(``spill/pool.py``) and drops the device tensors; ``columns`` and
``counts`` are properties that fault them back in on first device use.
Metadata (names, dtypes, row counts) answers host-side without a
fault-in.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from ..context import CylonContext
from ..dtypes import DataType
from ..ops import compact as ops_compact
from ..ops.gather import signed_view
from ..status import Code, CylonError, Status
from ..table import Column, Table


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


def _blocks(x: torch.Tensor, sizes: np.ndarray, offs: np.ndarray,
            cap: int) -> torch.Tensor:
    """Rows of ``x`` cut at ``offs`` into P zero-padded blocks of ``cap``."""
    P = len(sizes)
    out = torch.zeros((P, cap) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for i in range(P):
        out[i, :sizes[i]] = x[offs[i]:offs[i + 1]]
    return out.reshape((P * cap,) + tuple(x.shape[1:]))


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
        out = dist_ops._compact_survivors(self, mask, cnts)
        self.columns = out.columns
        self.cap = out.cap
        self.counts = out.counts
        self._counts_host = None
        self._spill_sig = None  # new contents: a pooled copy no longer matches

    # -- shape ---------------------------------------------------------------

    @property
    def nparts(self) -> int:
        return self.ctx.get_world_size()

    @property
    def num_columns(self) -> int:
        return len(self._columns)   # metadata: never faults a spill in

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self._columns]

    def counts_host(self) -> np.ndarray:
        """Per-shard valid row counts on the host (one read, then cached;
        a spilled table answers from the counts cached at its spill)."""
        self._collapse_pending()
        if self._counts_host is None:
            self._counts_host = ops_compact.read_host(self.counts)
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
        """Block-distribute a local table's rows over the P shards, on the
        device: shard *i* gets the i-th contiguous slice, the first
        ``n % P`` shards one row more (the JAX package's sizes, offsets
        and ``cap``)."""
        Pn = ctx.get_world_size()
        n = table.num_rows
        base, rem = divmod(n, Pn)
        sizes = np.array([base + (1 if i < rem else 0) for i in range(Pn)],
                         np.int32)
        if cap is None:
            cap = ops_compact.next_bucket(max(int(sizes.max(initial=0)), 1),
                                          minimum=8)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        cols = [DColumn(c.name, c.dtype,
                        _blocks(c.data.to(ctx.device), sizes, offs, cap),
                        None if c.validity is None else
                        _blocks(c.validity.to(ctx.device), sizes, offs, cap),
                        c.dictionary, c.arrow_type)
                for c in table.columns]
        out = DTable(ctx, cols, cap, torch.from_numpy(sizes).to(ctx.device))
        out._counts_host = sizes.copy()  # statically known at ingest
        return out

    # -- export --------------------------------------------------------------

    def _export(self, takes: Sequence[int]) -> Table:
        """Gather ``takes[i]`` leading rows of each shard as a local Table."""
        self._collapse_pending()
        dev = self.ctx.device
        idx = torch.cat([i * self.cap + torch.arange(t, device=dev)
                         for i, t in enumerate(takes)]) if sum(takes) else \
            torch.zeros(0, dtype=torch.int64, device=dev)
        cols = []
        for c in self.columns:
            data = signed_view(c.data)[idx].view(c.data.dtype)
            validity = None if c.validity is None else c.validity[idx]
            cols.append(Column(c.name, c.dtype, data, validity,
                               dictionary=c.dictionary,
                               arrow_type=c.arrow_type))
        return Table(self.ctx, cols)

    def to_table(self) -> Table:
        """Gather all shards to one local Table (drops padding)."""
        return self._export([int(c) for c in self.counts_host()])

    def head(self, n: int) -> Table:
        """First ``n`` global rows (shard-major order) as a local Table.

        One read of the counts, then a gather of just the rows taken (the
        JAX package's counts-based export; its fused path for small ``n``
        saves a TPU round trip and returns the same rows)."""
        self._collapse_pending()
        n_eff = min(int(n), self.nparts * self.cap)
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

    def explain(self, plan=None, *, tables=None, validate: bool = False,
                analyze: bool = False, optimize: bool = False):
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

        The static form, ``dt.explain(plan)`` without ``analyze``
        (abstract interpretation of the plan), is not ported yet."""
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
        if not analyze:
            raise CylonError(Status(Code.NotImplemented,
                "explain(plan) without analyze=True is the abstract plan "
                "checker, not ported yet (ROADMAP A11b); pass "
                "analyze=True to run and measure the plan"))
        target = tables if tables is not None else self
        op = plan
        if optimize:
            from .. import plan as planner
            ctx = self.ctx

            def op(tgt, _plan=plan, _ctx=ctx):  # noqa: F811 — optimized form
                return planner.run(_ctx, _plan, tgt)
        from .. import observe
        return observe.analyze(op, target)

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.type.name}"
                         for c in self._columns)
        spilled = ", spilled to host" if self.is_spilled else ""
        return f"DTable[P={self.nparts}, cap={self.cap}{spilled}]({cols})"
