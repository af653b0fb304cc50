"""Shared helpers for the PyTorch-port parity tests (a plain module, not a
conftest): the ``jax_trace_shim`` fixture, carry a JAX ``Table`` over to
the port through numpy, and read either package's tables as comparable
rows.

Rows are tuples of Python values: ``None`` for a null, the decoded string
for a dictionary column, and ``"NaN"`` for a float NaN (so equal rows
compare equal).  A ``Table`` reads as one list of rows; a ``DTable`` as one
list per shard.  ``ordered=False`` sorts each list, for multiset compares.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import cylon_tpu_torch as pt


@pytest.fixture
def jax_trace_shim(monkeypatch):
    """Lets the JAX package's distributed path run on this JAX version:
    it reads ``jax.core.trace_state_clean``, which JAX keeps under
    ``jax._src.core`` only, so the attribute is set for one test and
    restored after.  Also clears the JAX package's optimistic size hints
    (shuffle blocks, join, groupby and select capacities), its select
    kernel cache and its broadcast replica cache, so its capacities come
    from this call's counts (as the port's always do) rather than from an
    earlier call of the same shape.  JAX is imported here, not at module
    level: the card-only tests import this module on a machine without
    JAX."""
    import jax
    from jax._src import core as jcore

    from cylon_tpu.parallel import broadcast, dist_ops, shuffle
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jcore.trace_state_clean, raising=False)
    shuffle._block_hints.clear()
    dist_ops._capacity_hints.clear()
    dist_ops._group_cap_hints.clear()
    dist_ops._select_cap_hints.clear()
    dist_ops._select_cache.clear()
    broadcast.clear_replica_cache()
    yield


def port_table_from_jax(table, device="cpu"):
    """A JAX ``cylon_tpu.Table`` → the port's ``Table`` (data, validity,
    dictionary, names and logical types carried through numpy)."""
    ctx = pt.CylonContext(device=device)
    cols = []
    for c in table.columns:
        data = torch.from_numpy(np.array(c.data)).to(device)
        validity = (None if c.validity is None
                    else torch.from_numpy(np.array(c.validity, dtype=bool)).to(device))
        cols.append(pt.Column(c.name, pt.DataType(pt.Type(int(c.dtype.type))),
                              data, validity, dictionary=c.dictionary,
                              arrow_type=c.arrow_type))
    return pt.Table(ctx, cols)


def _cell(v, valid, dictionary):
    if not valid:
        return None
    if dictionary is not None:
        return dictionary[v]
    if isinstance(v, float) and v != v:
        return "NaN"
    return v


def _rows(cols, start: int, n: int):
    """cols: [(np data, np validity | None, dictionary | None)]."""
    lists = []
    for data, valid, dictionary in cols:
        d = data[start:start + n].tolist()
        v = [True] * n if valid is None else valid[start:start + n].tolist()
        lists.append([_cell(x, ok, dictionary) for x, ok in zip(d, v)])
    return list(zip(*lists)) if lists else []


def _dict_of(c):
    return c.dictionary if c.dictionary is not None and c.dtype.type in (
        pt.Type.STRING, pt.Type.BINARY) else None


def _host(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _read(t, ordered: bool):
    cols = [(_host(c.data), _host(c.validity), _dict_of(c)) for c in t.columns]
    if hasattr(t, "cap"):  # a DTable: rows per shard
        counts = [int(x) for x in t.counts_host()]
        shards = [_rows(cols, s * t.cap, counts[s]) for s in range(len(counts))]
        return shards if ordered else [sorted(s, key=repr) for s in shards]
    rows = _rows(cols, 0, t.num_rows)
    return rows if ordered else sorted(rows, key=repr)


def jax_rows(t, ordered: bool = False):
    """Rows of a JAX ``Table`` (a list) or ``DTable`` (a list per shard)."""
    return _read(t, ordered)


def port_rows(t, ordered: bool = False):
    """Rows of a port ``Table`` (a list) or ``DTable`` (a list per shard)."""
    return _read(t, ordered)


def schema(t):
    """(name, logical type number) per column, comparable across packages."""
    return [(c.name, int(c.dtype.type)) for c in t.columns]


def float_rtols(t, f64: float = 1e-12, f32: float = 1e-6):
    """Per-column relative tolerance of a table's values: ``f64`` for a
    float64 column, ``f32`` for a float32 one, exact (0) otherwise."""
    out = []
    for c in t.columns:
        dt = c.data.dtype
        out.append(f64 if dt in (torch.float64, np.float64) else
                   f32 if dt in (torch.float32, np.float32) else 0.0)
    return out


def _cell_close(a, b, rtol: float) -> bool:
    if a == b:
        return True
    if rtol and isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    return False


def assert_rows_close(got, want, rtols) -> None:
    """Rows (a list of tuples, or one list per shard) equal in order, each
    float cell within its column's relative tolerance; keys, counts,
    integers, nulls and NaN exactly."""
    if got and isinstance(got[0], list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_rows_close(g, w, rtols)
        return
    assert len(got) == len(want), (len(got), len(want))
    for i, (rg, rw) in enumerate(zip(got, want)):
        assert len(rg) == len(rw)
        for j, (a, b) in enumerate(zip(rg, rw)):
            assert _cell_close(a, b, rtols[j]), (i, j, rg, rw)
