"""Span parity: the port's distributed operators record the same ordered
sequence of ``(name, depth)`` spans as the JAX package's on the same
numpy inputs, at world 1 and 8 (the shape of ``tests/test_trace.py``'s
phase tests); with tracing disabled the port records no span and no
barrier (``trace.sync`` stays 0).

Both packages run with tracing on and a cleared trace state.  The JAX
package's ``compile.build`` spans (its XLA compiles, recorded on the
first call of each kernel signature in the process) have no per-call
counterpart in the port, so both sequences drop them before comparing.
"""
import dataclasses

import numpy as np
import pyarrow as pa
import pytest

import cylon_tpu as ct
from cylon_tpu import trace as jtrace
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import broadcast as jbroadcast
from cylon_tpu.parallel import dist_ops as jops

import cylon_tpu_torch as pt
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_ops as tops

from test_torch_common import jax_rows, jax_trace_shim, port_rows  # noqa: F401

WORLDS = (1, 8)


def _tables(ctx, dctx, world, at):
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    jt = JDTable.from_table(jctx, ct.Table.from_arrow(ctx, at))
    tctx = pt.CylonContext(device="cpu", world=world)
    tt = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, at))
    return jt, tt


def _data(seed, n=400):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "v": pa.array(rng.random(n)),
        "w": pa.array(rng.integers(-9, 9, n).astype(np.int32))})


def _spans(trace_mod, fn):
    """``fn()`` under a fresh, enabled trace: its result and the
    ``(name, depth)`` sequence of every recorded span, builds dropped."""
    trace_mod.reset()
    trace_mod.enable()
    try:
        out = fn()
        spans = [(n, d) for n, d, _ in trace_mod.get_spans()
                 if n != "compile.build"]
    finally:
        trace_mod.disable()
        trace_mod.reset()
    return out, spans


def _join_cfgs(alg, threshold):
    jc = dataclasses.replace(
        ct.JoinConfig(ct.JoinType.INNER, ct.JoinAlgorithm(alg), "k", "k"),
        broadcast_threshold=threshold)
    tc = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm(alg), "k", "k",
                       broadcast_threshold=threshold)
    return jc, tc


def _case(name, jt, tt, jt2, tt2):
    """The (JAX call, port call) of one named operator case."""
    if name in ("join_hash", "join_sort", "join_broadcast"):
        alg = "sort" if name == "join_sort" else "hash"
        jc, tc = _join_cfgs(alg, 1 << 20 if name == "join_broadcast" else 0)
        return (lambda: jops.dist_join(jt, jt2, jc),
                lambda: tops.dist_join(tt, tt2, tc))
    if name == "sort":
        return (lambda: jops.dist_sort(jt, "k"),
                lambda: tops.dist_sort(tt, "k"))
    if name in ("groupby_preagg", "groupby_shuffle"):
        pre = name == "groupby_preagg"
        aggs = [("v", "sum"), ("w", "max"), ("v", "mean")]
        return (lambda: jops.dist_groupby(jt, ["k"], aggs,
                                          pre_aggregate=pre),
                lambda: tops.dist_groupby(tt, ["k"], aggs,
                                          pre_aggregate=pre))
    if name == "union":
        return (lambda: jops.dist_union(jt, jt2),
                lambda: tops.dist_union(tt, tt2))
    raise AssertionError(name)


CASES = ("join_hash", "join_sort", "join_broadcast", "sort",
         "groupby_preagg", "groupby_shuffle", "union")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_span_sequence_matches_jax(ctx, dctx, jax_trace_shim, name, world):
    jt, tt = _tables(ctx, dctx, world, _data(1))
    jt2, tt2 = _tables(ctx, dctx, world, _data(2, 120))
    jbroadcast.clear_replica_cache()
    tbroadcast.clear_replica_cache()
    jfn, tfn = _case(name, jt, tt, jt2, tt2)
    want, jspans = _spans(jtrace, jfn)
    got, tspans = _spans(ttrace, tfn)
    assert tspans == jspans
    assert port_rows(got) == jax_rows(want)
    assert len(tspans) > 0


@pytest.mark.parametrize("name", CASES)
def test_disabled_tracing_records_nothing(name):
    """Tracing off, counters on: no span, no device barrier."""
    tctx = pt.CylonContext(device="cpu", world=8)
    tt = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _data(1)))
    tt2 = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _data(2, 120)))
    tbroadcast.clear_replica_cache()
    _, tfn = _case(name, None, tt, None, tt2)
    ttrace.reset()
    ttrace.disable()
    ttrace.enable_counters()
    try:
        tfn()
        assert ttrace.get_span_records(all_threads=True) == []
        c = ttrace.counters()
        assert c.get("trace.sync", 0) == 0
        assert c.get("host.read", 0) > 0  # the counters did run
    finally:
        ttrace.disable_counters()
        ttrace.reset()


def test_enabled_span_counts_every_barrier():
    """Each span sync is one ``trace.sync`` and one nested ``sync`` span."""
    tctx = pt.CylonContext(device="cpu", world=8)
    tt = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, _data(3)))
    ttrace.reset()
    ttrace.enable()
    try:
        tops.dist_sort(tt, "k")
        syncs = ttrace.counters().get("trace.sync", 0)
        spans = ttrace.get_spans()
    finally:
        ttrace.disable()
        ttrace.reset()
    assert syncs == sum(1 for n, _, _ in spans if n == "sync") > 0


def test_span_records_and_nests():
    ttrace.reset()
    ttrace.enable()
    try:
        with ttrace.span("outer"):
            with ttrace.span("inner"):
                pass
        spans = ttrace.get_spans()
        assert [(n, d) for n, d, _ in spans] == [("inner", 1), ("outer", 0)]
        assert "inner" in ttrace.report() and "outer" in ttrace.report()
    finally:
        ttrace.disable()
        ttrace.reset()


def test_counters_merge_across_threads():
    import threading

    ttrace.reset()
    ttrace.enable_counters()
    try:
        ttrace.count("xthread", 1)

        def worker():
            ttrace.count("xthread", 5)
            ttrace.count_max("xthread_peak", 99)

        ts = [threading.Thread(target=worker) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        c = ttrace.counters()
        assert c["xthread"] == 16 and c["xthread_peak"] == 99
    finally:
        ttrace.disable_counters()
        ttrace.reset()


def test_bench_line_matches_jax():
    """The reference's benchmark line, built from the same spans."""
    lines = []
    for mod in (jtrace, ttrace):
        mod.reset()
        mod.enable()
        try:
            mod.record_span("join.shuffle", 0.0, 1.25)
            mod.record_span("join.gather", 1.0, 2.5, depth=1)
            lines.append(mod.bench_line("join", 12.5, 0.1, 42))
        finally:
            mod.disable()
            mod.reset()
    assert lines[0] == lines[1]
    assert lines[1] == ("join j_t 12.50 w_t 0.10 lines 42 "
                        "join.shuffle 1.25 join.gather 2.50")


def test_chrome_export_matches_jax(tmp_path):
    """The same recorded spans and counter bumps export to the same
    Chrome events once timestamps, process and thread ids are removed."""
    import json

    docs = []
    for mod in (jtrace, ttrace):
        mod.reset()
        mod.enable()
        try:
            with mod.trace_context("q1"):
                mod.record_span("serve.queue", 0.5, 2.0,
                                args={"price": 7})
            mod.record_span("join.shuffle", 1.0, 3.0, depth=1)
            mod.count("shuffle.rows_sent", 5)
            mod.count("shuffle.rows_sent", 2)
            mod.count_max("shuffle.exchange_bytes_peak", 64)
            path = tmp_path / f"{mod.__name__}.json"
            doc = mod.export_chrome_trace(str(path))
            assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
            docs.append(doc)
        finally:
            mod.disable()
            mod.reset()

    def strip(doc):
        out = []
        for e in doc["traceEvents"]:
            e = {k: v for k, v in e.items() if k not in ("ts", "pid", "tid")}
            out.append(e)
        return out

    assert strip(docs[0]) == strip(docs[1])
    names = [e["name"] for e in docs[1]["traceEvents"]]
    assert "thread_name" in names and "join.shuffle" in names


def test_tail_sampling_matches_jax():
    """finish_trace keeps / drops a query's spans, as in the JAX package."""
    for mod in (jtrace, ttrace):
        mod.reset()
        mod.enable()
        prev = mod.set_tail_budget(1)
        try:
            for q in ("a", "b", "c"):
                with mod.trace_context(q):
                    mod.record_span(f"run.{q}", 0.0, 1.0)
            assert mod.finish_trace("a", keep=True) == 0
            assert mod.finish_trace("b", keep=False) == 1
            assert mod.finish_trace("c", keep=True) == 1  # evicts "a"
            names = [r[0] for r in mod.get_span_records(all_threads=True)]
            assert names == ["run.c"]
            c = mod.counters()
            assert c["trace.tail_kept"] == 2 and c["trace.sampled_out"] == 2
        finally:
            mod.set_tail_budget(prev)
            mod.disable()
            mod.reset()


def test_profile_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    path = tmp_path / "prof.json"
    with ttrace.profile(str(path)):
        torch.ones(64).sum()
    assert "traceEvents" in json.loads(path.read_text())
