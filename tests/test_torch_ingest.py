"""Ingest and the ingest-delta path: the port's ``DTable.from_arrow`` /
``from_pandas`` / ``from_partitions`` / ``from_table``, ``StagedIngest``
and its staging arena, the batched export with host copies, and
``append`` / ``content_epoch`` / ``delta_for`` against the JAX package's
(``cylon_tpu/parallel/dtable.py``, ``cylon_tpu/native/runtime.py``), at
world 1 and on the 8 virtual CPU devices, on the same numpy-seeded
inputs.  Layout means everything a shard holds: sizes, ``cap``, the
padded blocks (padding included), validity, the merged dictionary and
``_counts_host``."""
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cylon_tpu as ct
from cylon_tpu.native import runtime as jruntime
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.spill import pool as jpool

import cylon_tpu_torch as pt
from cylon_tpu_torch import compute as tcompute
from cylon_tpu_torch.native import runtime as truntime
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dtable as tdtable
from cylon_tpu_torch.spill import pool as tpool
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import jax_rows, jax_trace_shim, port_rows  # noqa: F401

WORLDS = [1, 8]


@pytest.fixture(autouse=True)
def _fresh_pools():
    for mod in (tpool, jpool):
        mod.clear_pool()
    tbroadcast.clear_replica_cache()
    yield
    for mod in (tpool, jpool):
        mod.clear_pool()
    tbroadcast.clear_replica_cache()


def _ctxs(dctx, world):
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    return jctx, pt.CylonContext(device="cpu", world=world)


def _arrow(seed: int, n: int, all_null_strings: bool = False):
    rng = np.random.default_rng(seed)
    words = np.array(["pear", "apple", "fig", "kiwi", "date", "éclair"],
                     dtype=object)
    smask = np.ones(n, bool) if all_null_strings else rng.random(n) < 0.3
    return pa.table({
        "i64": pa.array(rng.integers(-2**62, 2**62, n), pa.int64(),
                        mask=rng.random(n) < 0.2),
        "i32": pa.array(rng.integers(-1000, 1000, n, dtype=np.int32)),
        "f64": pa.array(rng.standard_normal(n), pa.float64()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32),
                        mask=rng.random(n) < 0.1),
        "u32": pa.array(rng.integers(0, 2**32, n, dtype=np.uint32)),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(words, n), pa.string(), mask=smask),
    })


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def layout(dt):
    """Everything a DTable's shards hold, as comparable host values."""
    cols = []
    for c in dt.columns:
        cols.append((c.name, int(c.dtype.type), _np(c.data).tolist(),
                     _np(c.data).dtype.str,
                     None if c.validity is None else _np(c.validity).tolist(),
                     None if c.dictionary is None else list(c.dictionary)))
    return {"cap": dt.cap, "counts": [int(x) for x in _np(dt.counts)],
            "counts_host": [int(x) for x in dt._counts_host], "cols": cols}


def assert_same_layout(got, want):
    lg, lw = layout(got), layout(want)
    assert lg["cap"] == lw["cap"]
    assert lg["counts"] == lw["counts"] == lg["counts_host"] == \
        lw["counts_host"]
    assert len(lg["cols"]) == len(lw["cols"])
    for cg, cw in zip(lg["cols"], lw["cols"]):
        name = cg[0]
        assert cg[:2] == cw[:2], name
        assert cg[3] == cw[3], (name, cg[3], cw[3])
        # float payloads compare by bits (NaN-safe)
        a, b = np.array(cg[2], dtype=cg[3]), np.array(cw[2], dtype=cw[3])
        assert a.tobytes() == b.tobytes(), name
        assert cg[4] == cw[4], name
        assert cg[5] == cw[5], name


# ---------------------------------------------------------------------------
# the ingest entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [0, 13, 300])
def test_from_arrow_layout_equals_jax(dctx, world, n):
    jctx, tctx = _ctxs(dctx, world)
    at = _arrow(10 + n, n)
    assert_same_layout(TDTable.from_arrow(tctx, at),
                       JDTable.from_arrow(jctx, at))


@pytest.mark.parametrize("world", WORLDS)
def test_from_pandas_layout_and_round_trip(dctx, jax_trace_shim, world):
    jctx, tctx = _ctxs(dctx, world)
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"k": rng.integers(0, 50, 77).astype(np.int64),
                       "s": rng.choice(["a", None, "c"], 77),
                       "x": rng.standard_normal(77)})
    got, want = TDTable.from_pandas(tctx, df), JDTable.from_pandas(jctx, df)
    assert_same_layout(got, want)
    assert got.to_table().to_arrow().equals(want.to_table().to_arrow())
    back = got.to_table().to_pandas()
    pd.testing.assert_frame_equal(back, df, check_dtype=False)


@pytest.mark.parametrize("world", WORLDS)
def test_from_partitions_layout_equals_jax(ctx, dctx, world):
    """Per-partition dictionaries merge onto their sorted union; an empty
    partition and an all-null string partition included."""
    jctx, tctx = _ctxs(dctx, world)
    shapes = [(23, False), (0, False), (9, True), (31, False), (1, False),
              (0, False), (17, True), (5, False)][:world]
    if world == 1:
        shapes = [(9, True)]
    ats = [_arrow(40 + i, n, all_null) for i, (n, all_null)
           in enumerate(shapes)]
    # a partition without the nullable lanes (no nulls anywhere)
    if world > 1:
        ats[3] = ats[3].drop_null()
    jparts = [ct.Table.from_arrow(ctx, a) for a in ats]
    tparts = [pt.Table.from_arrow(pt.CylonContext(device="cpu"), a)
              for a in ats]
    got = TDTable.from_partitions(tctx, tparts)
    want = JDTable.from_partitions(jctx, jparts)
    assert_same_layout(got, want)


def test_from_partitions_rejects_wrong_count(dctx):
    tctx = pt.CylonContext(device="cpu", world=4)
    t = pt.Table.from_arrow(pt.CylonContext(device="cpu"), _arrow(1, 4))
    with pytest.raises(TCylonError):
        TDTable.from_partitions(tctx, [t, t])


@pytest.mark.parametrize("world", WORLDS)
def test_from_table_layout_equals_jax(ctx, dctx, world):
    """``from_table`` goes through StagedIngest too: the same sizes,
    offsets, ``cap`` and ``_counts_host``, from a table with host copies
    (Arrow ingest) and from one without (numpy ingest)."""
    jctx, tctx = _ctxs(dctx, world)
    at = _arrow(5, 101)
    assert_same_layout(
        TDTable.from_table(tctx, pt.Table.from_arrow(tctx, at)),
        JDTable.from_table(jctx, ct.Table.from_arrow(ctx, at)))
    data = {"k": np.arange(37, dtype=np.int32),
            "v": np.linspace(0, 1, 37, dtype=np.float32)}
    t = pt.Table.from_columns(tctx, data)
    assert t.columns[0].host_data is None
    assert_same_layout(TDTable.from_table(tctx, t, cap=64),
                       JDTable.from_table(jctx, ct.Table.from_columns(
                           ctx, data), cap=64))


# ---------------------------------------------------------------------------
# StagedIngest and the staging arena
# ---------------------------------------------------------------------------

def _plain_block(x, sizes, offs, cap):
    out = np.zeros((len(sizes) * cap,) + x.shape[1:], x.dtype)
    for i in range(len(sizes)):
        out[i * cap:i * cap + sizes[i]] = x[offs[i]:offs[i + 1]]
    return out


@pytest.mark.parametrize("mode", ["plain", "force_arena", "arena_disabled"])
def test_staged_ingest_on_cpu_equals_plain_build(monkeypatch, mode):
    if mode == "arena_disabled":
        monkeypatch.setattr(tdtable, "ARENA_ENABLED", False)
    ctx = pt.CylonContext(device="cpu", world=3)
    rng = np.random.default_rng(8)
    cols = [rng.integers(-5, 5, 20).astype(np.int8),
            rng.standard_normal(20), rng.random(20) < 0.5,
            rng.integers(0, 2**63, 20, dtype=np.uint64)]
    sizes = np.array([7, 7, 6], np.int32)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    outs = []
    for rep in range(2):   # the second ingest reuses the reset arena
        staged = tdtable.StagedIngest(ctx, force_arena=mode == "force_arena")
        try:
            outs.append([staged.put(c, sizes, offs, 8) for c in cols])
            in_use = staged._arena.bytes_in_use if staged._arena else 0
        finally:
            staged.finish()
        assert in_use == (sum(((24 * c.dtype.itemsize) + 63) & ~63
                              for c in cols) if mode == "force_arena" else 0)
    for got in outs:  # the first ingest's columns survived the second
        for g, c in zip(got, cols):
            assert g.device.type == "cpu"
            assert g.numpy().tobytes() == _plain_block(
                c, sizes, offs, 8).tobytes()
    if mode == "force_arena":
        assert tdtable._arena.bytes_in_use == 0


def test_staged_ingest_arena_overflow_takes_one_off_block(monkeypatch):
    monkeypatch.setattr(tdtable, "_arena", truntime.StagingArena(256))
    ctx = pt.CylonContext(device="cpu", world=2)
    x = np.arange(100, dtype=np.int32)
    sizes, offs = np.array([50, 50], np.int32), np.array([0, 50, 100])
    staged = tdtable.StagedIngest(ctx, force_arena=True)
    try:
        small = staged.put(x[:10], np.array([5, 5], np.int32),
                           np.array([0, 5, 10]), 8)
        big = staged.put(x, sizes, offs, 64)   # 512 B: past the arena
    finally:
        staged.finish()
    assert staged.one_off_blocks == 1
    assert big.numpy().tobytes() == _plain_block(x, sizes, offs, 64).tobytes()
    assert small.numpy().tolist()[:5] == [0, 1, 2, 3, 4]


def test_second_concurrent_ingest_takes_one_off_blocks():
    ctx = pt.CylonContext(device="cpu", world=2)
    first = tdtable.StagedIngest(ctx, force_arena=True)
    got = {}

    def other():
        s = tdtable.StagedIngest(ctx, force_arena=True)
        try:
            got["arena"] = s._arena
            got["t"] = s.put(np.arange(4, dtype=np.int64), np.array([2, 2]),
                             np.array([0, 2, 4]), 8)
        finally:
            s.finish()
        got["one_off"] = s.one_off_blocks

    try:
        assert first._arena is not None
        th = threading.Thread(target=other)
        th.start()
        th.join()
    finally:
        first.finish()
    assert got["arena"] is None and got["one_off"] == 1
    assert got["t"].tolist() == [0, 1, 0, 0, 0, 0, 0, 0,
                                 2, 3, 0, 0, 0, 0, 0, 0]
    # released: the next ingest owns the arena again
    again = tdtable.StagedIngest(ctx, force_arena=True)
    assert again._arena is not None
    again.finish()


def test_arena_semantics_equal_jax():
    """allocate / 64-byte alignment / exhaustion / reset / reuse, step by
    step against the JAX package's numpy arena."""
    assert not jruntime.have_native() and not truntime.have_native()
    ta, ja = truntime.StagingArena(1 << 12), jruntime.StagingArena(1 << 12)
    for nbytes in (1, 64, 65, 1000, 7, 128):
        bt, bj = ta.allocate(nbytes), ja.allocate(nbytes)
        assert len(bt) == len(bj) == nbytes
        assert ta.bytes_in_use == ja.bytes_in_use
        np.frombuffer(bt, np.uint8)[:] = 7
    kept = np.frombuffer(ta.allocate(1024), dtype=np.int32, count=256)
    kept[:] = np.arange(256)
    snapshot = kept.copy()
    ja.allocate(1024)
    for arena in (ta, ja):
        with pytest.raises(MemoryError):
            arena.allocate(1 << 20)
    assert ta.bytes_in_use == ja.bytes_in_use
    ta.reset()
    ja.reset()
    assert ta.bytes_in_use == ja.bytes_in_use == 0
    np.testing.assert_array_equal(snapshot, np.arange(256))
    t = ta.allocate_tensor(256)
    assert t.dtype == torch.uint8 and t.numel() == 256
    assert ta.bytes_in_use == 256 and not ta.pinned


# ---------------------------------------------------------------------------
# the batched export and host copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_export_carries_host_copies_like_jax(dctx, jax_trace_shim, world):
    jctx, tctx = _ctxs(dctx, world)
    at = _arrow(77, 150)
    got = TDTable.from_arrow(tctx, at)
    want = JDTable.from_arrow(jctx, at)
    for tt, jt in ((got.to_table(), want.to_table()),
                   (got.head(40), want.head(40)),
                   (got.partition(world - 1), want.partition(world - 1))):
        assert port_rows(tt, ordered=True) == jax_rows(jt, ordered=True)
        for c, jc in zip(tt.columns, jt.columns):
            assert c.host_data is not None
            assert c.host_data.tobytes() == np.asarray(jc.host_data).tobytes()
            assert (c.host_validity is None) == (jc.host_validity is None)
            assert c.host_data.tobytes() == _np(c.data).tobytes()
        tt._verify_host_caches()
        assert tt.to_arrow().equals(jt.to_arrow())


def test_to_arrow_reads_host_copies_and_guards_stale_ones(monkeypatch):
    ctx = pt.CylonContext(device="cpu")
    t = TDTable.from_arrow(pt.CylonContext(device="cpu", world=2),
                           _arrow(4, 20)).to_table()
    calls = []
    real = pt.table.host_batch
    monkeypatch.setattr(pt.table, "host_batch",
                        lambda ts: calls.append(len(ts)) or real(ts))
    t.to_arrow()
    assert calls == [0]   # every column carries its host copies
    # a contents change that bypasses with_data is caught at export ...
    from dataclasses import replace
    c0 = t.columns[0]
    bad = pt.Table(ctx, [replace(c0, data=c0.data[:5],
                                 validity=c0.validity[:5])])
    with pytest.raises(TCylonError, match="stale host_data"):
        bad.to_arrow()
    # ... and by the content check when the length is unchanged
    flipped = pt.Table(ctx, [replace(c0, data=c0.data + 1)])
    with pytest.raises(TCylonError, match="disagrees"):
        flipped._verify_host_caches()
    # with_data drops the copies: the export pulls the new contents
    fresh = pt.Table(ctx, [c0.with_data(c0.data + 1)])
    assert fresh.columns[0].host_data is None
    assert fresh.columns[0].host_validity is None
    assert fresh.to_arrow().column(0).to_pylist() == [
        None if v is None else v + 1
        for v in t.to_arrow().column(0).to_pylist()]


def test_local_ops_on_an_export_use_its_host_copies(ctx, dctx,
                                                    jax_trace_shim):
    """``compute.sort_multi`` of an exported table sorts the host copies
    (the result carries them); a slice keeps them sliced; the empty
    groupby's keys drop them.  Each equals the JAX package's."""
    from cylon_tpu import compute as jcompute
    jctx, tctx = _ctxs(dctx, 8)
    at = _arrow(12, 90)
    tt = TDTable.from_arrow(tctx, at).to_table()
    jt = JDTable.from_arrow(jctx, at).to_table()
    for keys, asc in ((["i32", "s"], [True, False]), (["b", "f32"], False),
                      (["u32"], True)):
        got = tcompute.sort_multi(tt, keys, asc)
        want = jcompute.sort_multi(jt, keys, asc)
        assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
        assert all(c.host_data is not None for c in got.columns)
        got._verify_host_caches()
    sl = tcompute._slice_columns(list(tt.columns), 7)
    assert all(c.host_data.shape[0] == 7 for c in sl)
    pt.Table(tctx, sl)._verify_host_caches()
    empty = tcompute.groupby(pt.Table(tctx, tcompute._slice_columns(
        list(tt.columns), 0)), ["i32"], [("f64", "sum")])
    assert empty.num_rows == 0 and empty.columns[0].host_data is None


# ---------------------------------------------------------------------------
# append / content_epoch / delta_for
# ---------------------------------------------------------------------------

def _both(dctx, world, seed, n):
    jctx, tctx = _ctxs(dctx, world)
    at = _arrow(seed, n)
    return TDTable.from_arrow(tctx, at), JDTable.from_arrow(jctx, at)


@pytest.mark.parametrize("world", WORLDS)
def test_append_equals_jax(dctx, jax_trace_shim, world):
    tb, jb = _both(dctx, world, 21, 64)
    td, jd = _both(dctx, world, 22, 19)
    handle = tb
    assert tb.content_epoch == jb.content_epoch == 0
    assert tb.append(td) is handle and jb.append(jd) is jb
    assert tb.content_epoch == jb.content_epoch == 1
    assert tb.delta_for(1) is td and tb.delta_for(0) is None
    assert_same_layout(tb, jb)
    assert tb.num_rows == 83
    assert tb.to_table().to_arrow().equals(jb.to_table().to_arrow())


def test_append_keeps_the_last_deltas(dctx, jax_trace_shim):
    tb, jb = _both(dctx, 8, 30, 16)
    for i in range(TDTable._DELTA_KEEP + 3):
        td, jd = _both(dctx, 8, 31 + i, 3 + i)
        tb.append(td)
        jb.append(jd)
    assert TDTable._DELTA_KEEP == JDTable._DELTA_KEEP == 8
    assert sorted(tb._deltas) == sorted(jb._deltas) == list(range(4, 12))
    assert tb.content_epoch == jb.content_epoch == 11
    assert [tb.delta_for(e).num_rows for e in range(4, 12)] == \
        [jb.delta_for(e).num_rows for e in range(4, 12)]
    assert_same_layout(tb, jb)


@pytest.mark.parametrize("world", WORLDS)
def test_append_to_a_spilled_table(dctx, jax_trace_shim, world):
    """The pooled host copy of the pre-append contents is dropped (the
    port holds no entry for the table after); the result equals the
    resident append's and the JAX package's."""
    tb, jb = _both(dctx, world, 50, 40)
    tr, _ = _both(dctx, world, 50, 40)
    td, jd = _both(dctx, world, 51, 11)
    tb.spill()
    jb.spill()
    assert tb.is_spilled and tpool.get_pool().entries() == 1
    tb.append(td)
    jb.append(jd)
    tr.append(td)
    assert not tb.is_spilled and tpool.get_pool().entries() == 0
    assert tb._spill_sig is None
    assert_same_layout(tb, tr)
    assert_same_layout(tb, jb)
    assert tb.content_epoch == 1


def test_append_does_not_serve_a_stale_replica():
    """A replica cached before an append is forgotten: the broadcast of
    the grown table holds every row."""
    ctx = pt.CylonContext(device="cpu", world=4)
    base = TDTable.from_arrow(ctx, _arrow(60, 10))
    rep = tbroadcast.replicate_table(base)
    assert rep.num_rows == 4 * 10
    assert len(tbroadcast._replica_cache) == 1
    base.append(TDTable.from_arrow(ctx, _arrow(61, 6)))
    assert len(tbroadcast._replica_cache) == 0
    assert tbroadcast.replicate_table(base).num_rows == 4 * 16


def test_append_rejects_another_schema():
    ctx = pt.CylonContext(device="cpu", world=2)
    a = TDTable.from_arrow(ctx, _arrow(1, 5))
    b = TDTable.from_arrow(ctx, _arrow(1, 5).drop_columns(["s"]))
    with pytest.raises(TCylonError):
        a.append(b)
    assert a.content_epoch == 0 and a.num_rows == 5
