"""Distributed Table: columns as P fixed-capacity row shards.

Mirror of ``cylon_tpu/parallel/dtable.py``, with the same layout: each
column is ONE flat tensor of shape ``[P * cap]`` on the context's device —
shard *i* holds rows ``[i*cap, i*cap + counts[i])``; the rest of its block
is zero padding.  ``counts`` is an int32 ``[P]`` tensor on the device.

The reference has no separate distributed-table type: an ``arrow::Table``
per rank *is* the partition (reference: cpp/src/cylon/table.hpp:39-278).
Here all P ranks' shards live in one process, so the partitioned state is
a first-class object, as in the JAX package.
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
    """Partitioned table: padded per-shard blocks + valid counts."""

    def __init__(self, ctx: CylonContext, columns: List[DColumn], cap: int,
                 counts: torch.Tensor):
        self.ctx = ctx
        self.columns = columns
        self.cap = int(cap)
        self.counts = counts               # [P] int32
        self._counts_host: Optional[np.ndarray] = None

    # -- shape ---------------------------------------------------------------

    @property
    def nparts(self) -> int:
        return self.ctx.get_world_size()

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def counts_host(self) -> np.ndarray:
        """Per-shard valid row counts on the host (one read, then cached)."""
        if self._counts_host is None:
            self._counts_host = self.counts.cpu().numpy()
        return self._counts_host

    @property
    def num_rows(self) -> int:
        return int(self.counts_host().sum())

    def column(self, i: Union[int, str]) -> DColumn:
        return self.columns[self.column_index(i)]

    def column_index(self, i: Union[int, str]) -> int:
        if isinstance(i, str):
            for j, c in enumerate(self.columns):
                if c.name == i:
                    return j
            raise CylonError(Status(Code.KeyError, f"no column {i!r}"))
        return i

    def verify_same_schema(self, other: "DTable") -> None:
        """reference: table_api.cpp:566 (VerifyTableSchema)."""
        if self.num_columns != other.num_columns:
            raise CylonError(Status(Code.Invalid,
                f"column count mismatch {self.num_columns} vs {other.num_columns}"))
        for a, b in zip(self.columns, other.columns):
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
                     self.cap, self.counts)
        out._counts_host = self._counts_host  # same rows, same counts
        return out

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.type.name}" for c in self.columns)
        return f"DTable[P={self.nparts}, cap={self.cap}]({cols})"
