"""Streaming parity: the port's ``dist_join_streaming`` (the right side
co-partitioned once, the left side in row slices, the per-slice outputs
concatenated and compacted) against the JAX package's at world 1 and on
the 8 virtual CPU devices, on the same numpy inputs with null and string
keys and uneven slices: the same rows on the same shards in the same
order, the same ``cap`` and ``counts``, and the same row multiset as the
port's one-shot ``dist_join``.  Also the one-shot fallbacks, the
slice / repack helpers with trailing-dimension leaves (``[n, M]`` sketch
state through ``pack_columns``, ``take_many`` and the exchange), and
``HostPipeline``: FIFO order, error delivery, backpressure at ``depth``
and an idempotent ``close``."""
import threading
import time

import numpy as np
import pytest
import torch

from cylon_tpu.parallel import dist_join_streaming as jstreaming
from cylon_tpu.parallel import streaming as jstreaming_mod

import cylon_tpu_torch as pt
from cylon_tpu_torch.ops import gather as tgather
from cylon_tpu_torch.parallel import DColumn, DTable
from cylon_tpu_torch.parallel import dist_join as tdist_join
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import streaming as tstreaming
from cylon_tpu_torch.parallel import HostPipeline

from test_torch_common import (jax_rows, jax_trace_shim, port_rows,  # noqa: F401
                               schema)
from test_torch_dist_join import _both_dtables, _configs, _pair

CASES = ([(8, how, alg, keys) for how in ("inner", "left")
          for alg in ("hash", "sort") for keys in ("int", "string")]
         + [(1, how, alg, "int") for how in ("inner", "left")
            for alg in ("hash", "sort")])


def _sides(ctx, dctx, world, strings, seed=70):
    at, bt = _pair(np.random.default_rng(seed), 137, 93, strings=strings)
    return _both_dtables(ctx, dctx, world, at), _both_dtables(ctx, dctx,
                                                              world, bt)


@pytest.mark.parametrize("world,how,alg,keys", CASES)
def test_streaming_join_matches_jax(ctx, dctx, jax_trace_shim, world, how,
                                    alg, keys):
    (jl, tl), (jr, tr) = _sides(ctx, dctx, world, keys == "string")
    key = ("s", "k") if keys == "string" else "k"
    jcfg, tcfg = _configs(how, alg, key, key)
    want = jstreaming(jl, jr, jcfg, chunks=3)
    got = tstreaming.dist_join_streaming(tl, tr, tcfg, chunks=3)
    assert schema(got) == schema(want)
    assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
    # the same rows as the one-shot join
    oneshot = tdist_join(tl, tr, tcfg)
    assert sorted((r for s in port_rows(got) for r in s), key=repr) \
        == sorted((r for s in port_rows(oneshot) for r in s), key=repr)


@pytest.mark.parametrize("how,chunks", [("right", 3), ("full_outer", 3),
                                        ("inner", 1), ("left", 0),
                                        ("inner", 4096)])
def test_streaming_falls_back_to_one_shot(monkeypatch, how, chunks):
    """RIGHT / FULL_OUTER, ``chunks <= 1`` and a left block narrower than
    ``chunks`` dispatch to ``dist_join``."""
    called = []
    real = tstreaming.dist_join

    def spy(left, right, config):
        called.append(how)
        return real(left, right, config)

    monkeypatch.setattr(tstreaming, "dist_join", spy)
    at, bt = _pair(np.random.default_rng(71), 60, 40)
    tctx = pt.CylonContext(device="cpu", world=4)
    tl = DTable.from_table(tctx, pt.Table.from_arrow(tctx, at))
    tr = DTable.from_table(tctx, pt.Table.from_arrow(tctx, bt))
    _, tcfg = _configs(how, "hash")
    got = tstreaming.dist_join_streaming(tl, tr, tcfg, chunks=chunks)
    assert called == [how]
    assert port_rows(got) == port_rows(real(tl, tr, tcfg))


def test_slice_and_concat_match_jax(ctx, dctx, jax_trace_shim):
    (jl, tl), _ = _sides(ctx, dctx, 8, True, seed=72)
    for lo, hi in ((0, 8), (8, 16), (5, tl.cap)):
        want = jstreaming_mod._slice_rows(jl, lo, hi)
        got = tstreaming._slice_rows(tl, lo, hi)
        assert got.cap == want.cap
        np.testing.assert_array_equal(got.counts_host(), want.counts_host())
        assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
    parts_j = [jstreaming_mod._slice_rows(jl, 0, 8),
               jstreaming_mod._slice_rows(jl, 8, jl.cap)]
    parts_t = [tstreaming._slice_rows(tl, 0, 8),
               tstreaming._slice_rows(tl, 8, tl.cap)]
    want = jstreaming_mod._concat_compact(parts_j)
    got = tstreaming._concat_compact(parts_t)
    assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


# -- trailing-dimension leaves ---------------------------------------------------

def _trailing_table(world=4, n=50, M=6):
    """``k`` int32 plus a ``[rows, M]`` int32 leaf ``m`` (row i holds
    ``k[i]·100 + j``) and a ``[rows, M]`` uint32 leaf ``u``."""
    tctx = pt.CylonContext(device="cpu", world=world)
    base = DTable.from_table(tctx, pt.Table.from_columns(
        tctx, {"k": np.arange(n, dtype=np.int32) * 7 % 23}))
    k = base.column("k").data
    m = k[:, None] * 100 + torch.arange(M, dtype=torch.int32)
    u = (k[:, None].to(torch.int64) * 3 + 0xFFFFFF00
         + torch.arange(M)).to(torch.uint32)
    return DTable(tctx, base.columns + [
        DColumn("m", base.column("k").dtype, m),
        DColumn("u", pt.DataType(pt.Type.UINT32), u)], base.cap, base.counts)


def _check_trailing(dt):
    k = dt.column("k").data.to(torch.int64)
    m = dt.column("m").data
    u = dt.column("u").data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rows = torch.cat([torch.arange(c) + s * dt.cap
                      for s, c in enumerate(dt.counts_host().tolist())])
    ar = torch.arange(m.shape[1])
    assert torch.equal(m[rows].to(torch.int64), k[rows, None] * 100 + ar)
    assert torch.equal(u[rows], k[rows, None] * 3 + 0xFFFFFF00 + ar)


def test_trailing_dim_leaves_through_shuffle_slice_and_concat():
    dt = _trailing_table()
    sh = tdist_ops._shuffle_by_keys(dt, 1)
    assert tuple(sh.column("m").data.shape) == (4 * sh.cap, 6)
    assert sh.num_rows == 50
    _check_trailing(sh)
    parts = [tstreaming._slice_rows(sh, 0, 8),
             tstreaming._slice_rows(sh, 8, sh.cap)]
    for p in parts:
        _check_trailing(p)
    cc = tstreaming._concat_compact(parts)
    assert cc.num_rows == 50
    _check_trailing(cc)


def test_pack_take_and_unpack_with_trailing_leaves():
    rng = np.random.default_rng(73)
    n = 40
    leaves = [torch.from_numpy(rng.random((n, 3)) < 0.5),
              torch.from_numpy(rng.integers(0, 9, n).astype(np.int64)),
              torch.from_numpy(rng.random((n, 4)).astype(np.float32)),
              torch.from_numpy(rng.random(n).astype(np.float32))]
    packed = tgather.pack_columns(leaves)
    # every leaf in exactly one class; a trailing-dimension leaf alone
    assert sorted(p for _, pos, _ in packed for p in pos) == [0, 1, 2, 3]
    assert [pos for _, pos, dts in packed if isinstance(dts[0], tuple)] \
        == [[0], [2]]
    back = [None] * len(leaves)
    for wide, pos, dts in packed:
        for col, p in zip(tgather.unpack_columns(wide, dts), pos):
            back[p] = col
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    idx = torch.tensor([3, -1, 0, 39, 7], dtype=torch.int32)
    valid = torch.from_numpy(rng.random(n) < 0.7)
    pairs = [(leaves[0], valid), (leaves[1], None), (leaves[2], None),
             (leaves[3], valid)]
    for fill in (False, True):
        many = tgather.take_many(pairs, idx, fill_null=fill)
        for (d, v), got in zip(pairs, many):
            want = tgather.take(d, v, idx, fill_null=fill)
            assert torch.equal(got[0], want[0])
            assert (got[1] is None) == (want[1] is None)
            if want[1] is not None:
                assert torch.equal(got[1], want[1])


# -- HostPipeline ----------------------------------------------------------------

def test_host_pipeline_is_fifo_and_returns_results():
    out = []
    pipe = HostPipeline(workers=1, depth=4)
    tasks = [pipe.submit(lambda i=i: out.append(i) or i * i)
             for i in range(50)]
    assert [t.wait(10) for t in tasks] == [i * i for i in range(50)]
    assert out == list(range(50))
    pipe.close()


def test_host_pipeline_delivers_errors_to_wait():
    pipe = HostPipeline()

    def boom():
        raise ValueError("export failed")

    bad = pipe.submit(boom)
    good = pipe.submit(lambda: 7)
    with pytest.raises(ValueError, match="export failed"):
        bad.wait(10)
    assert good.wait(10) == 7 and bad.done()
    pipe.close()


def test_host_pipeline_backpressure_at_depth():
    gate = threading.Event()
    pipe = HostPipeline(workers=1, depth=2)
    first = pipe.submit(gate.wait)            # the worker blocks here
    time.sleep(0.05)
    pipe.submit(lambda: 1)
    pipe.submit(lambda: 2)                    # the queue is now full
    submitted = threading.Event()

    def producer():
        pipe.submit(lambda: 3)
        submitted.set()

    t = threading.Thread(target=producer)
    t.start()
    assert not submitted.wait(0.2), "submit past depth must block"
    gate.set()
    assert submitted.wait(10)
    t.join(10)
    assert first.wait(10) is True
    pipe.close()


def test_host_pipeline_close_is_idempotent_and_final():
    pipe = HostPipeline(workers=2)
    t = pipe.submit(lambda: 5)
    pipe.close()
    assert t.done() and t.wait() == 5
    pipe.close()
    with pytest.raises(pt.CylonError):
        pipe.submit(lambda: 1)
    for bad in ({"workers": 0}, {"depth": 0}):
        with pytest.raises(pt.CylonError):
            HostPipeline(**bad)


def test_host_pipeline_keeps_no_result_alive():
    """Once the submitter drops its task, the result is freed even while
    the worker sits idle (an export's result can be a device table)."""
    import gc
    import weakref

    class Result:
        pass

    pipe = HostPipeline()
    task = pipe.submit(Result)
    ref = weakref.ref(task.wait(10))
    del task
    gc.collect()
    assert ref() is None
    pipe.close()


def test_host_task_wait_times_out():
    gate = threading.Event()
    pipe = HostPipeline()
    t = pipe.submit(gate.wait)
    with pytest.raises(pt.CylonError):
        t.wait(0.05)
    gate.set()
    pipe.close()


def test_host_pipeline_submit_close_race_loses_no_task():
    """16 producers against 4 workers with ``close`` racing them and a
    short switch interval: every task whose ``submit`` returned runs, and
    every later ``submit`` raises."""
    import sys
    pipe = HostPipeline(workers=4, depth=2)
    accepted, refused, lock = [], [], threading.Lock()

    def producer(p):
        for i in range(50):
            try:
                t = pipe.submit(lambda v=(p, i): v)
            except pt.CylonError:
                with lock:
                    refused.append((p, i))
                return
            with lock:
                accepted.append(((p, i), t))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(16)]
        for t in threads:
            t.start()
        time.sleep(0.01)
        pipe.close(timeout=10)
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    for key, task in accepted:
        assert task.wait(10) == key
    assert len(accepted) + len(refused) <= 16 * 50
