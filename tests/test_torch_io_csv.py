"""CSV I/O: the port's ``io`` (``CSVReadOptions`` / ``CSVWriteOptions``,
``read_csv``, ``read_csv_many``, ``write_csv``) against the JAX package's
``cylon_tpu.io`` on the same numpy-seeded files.  Mirrors the 6 tests of
``tests/test_io_compat.py::TestCSV``, then the ``io.csv.read`` fault
point (a transient fault retried, a permanent one propagated), the
option lowering, the sequential and the concurrent multi-file read, and
the per-rank CSV path into ``DTable.from_partitions`` at world 1 and 8."""
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as ct
from cylon_tpu import io as jio
from cylon_tpu.parallel import DTable as JDTable

import cylon_tpu_torch as pt
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import io as tio
from cylon_tpu_torch import resilience as tres
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.status import Code as TCode
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import jax_rows, port_rows, schema
from test_torch_ingest import assert_same_layout


@pytest.fixture
def tctx():
    return pt.CylonContext(device="cpu")


@pytest.fixture
def csv_pair(tmp_path):
    rng = np.random.default_rng(42)
    n = 200
    df1 = pd.DataFrame({"k": rng.integers(0, 50, n),
                        "v": np.round(rng.random(n), 3)})
    df2 = pd.DataFrame({"k": rng.integers(0, 50, n),
                        "w": np.round(rng.random(n), 3)})
    p1, p2 = tmp_path / "a.csv", tmp_path / "b.csv"
    df1.to_csv(p1, index=False)
    df2.to_csv(p2, index=False)
    return str(p1), str(p2), df1, df2


# ---------------------------------------------------------------------------
# tests/test_io_compat.py::TestCSV, on the port and against the JAX package
# ---------------------------------------------------------------------------

def test_read_roundtrip(ctx, tctx, csv_pair, tmp_path):
    p1, _, df1, _ = csv_pair
    t = tio.read_csv(tctx, p1)
    assert t.num_rows == len(df1)
    assert t.column_names == ["k", "v"]
    pd.testing.assert_frame_equal(t.to_pandas(), df1, check_dtype=False)
    want = jio.read_csv(ctx, p1)
    assert schema(t) == schema(want)
    assert port_rows(t, ordered=True) == jax_rows(want, ordered=True)
    out = tmp_path / "out.csv"
    tio.write_csv(t, str(out))
    pd.testing.assert_frame_equal(pd.read_csv(out), df1, check_dtype=False)
    jout = tmp_path / "jout.csv"
    jio.write_csv(want, str(jout))
    assert out.read_bytes() == jout.read_bytes()


def test_options(ctx, tctx, tmp_path):
    p = tmp_path / "t.tsv"
    p.write_text("x\ty\n1\tNA\n2\t5\n")
    opts = (tio.CSVReadOptions().WithDelimiter("\t").NullValues(["NA"])
            .BlockSize(1 << 16))
    t = tio.read_csv(tctx, str(p), opts)
    assert t.num_rows == 2
    assert t.column("y").has_nulls()
    want = jio.read_csv(ctx, str(p), jio.CSVReadOptions().WithDelimiter("\t")
                        .NullValues(["NA"]).BlockSize(1 << 16))
    assert port_rows(t, ordered=True) == jax_rows(want, ordered=True)
    assert port_rows(t, ordered=True) == [(1, None), (2, 5)]


def test_include_columns(tctx, csv_pair):
    p1, _, _, _ = csv_pair
    t = tio.read_csv(tctx, p1, tio.CSVReadOptions().IncludeColumns(["v"]))
    assert t.column_names == ["v"]


def test_multi_file_concurrent(ctx, tctx, csv_pair):
    p1, p2, df1, df2 = csv_pair
    ts = tio.read_csv_many(tctx, [p1, p2])
    assert [t.num_rows for t in ts] == [len(df1), len(df2)]
    want = jio.read_csv_many(ctx, [p1, p2])
    for t, w in zip(ts, want):
        assert schema(t) == schema(w)
        assert port_rows(t, ordered=True) == jax_rows(w, ordered=True)
    # a list of paths to read_csv is the multi-file read
    assert [t.num_rows for t in tio.read_csv(tctx, [p2, p1])] == \
        [len(df2), len(df1)]


def test_missing_file_raises(tctx):
    with pytest.raises(TCylonError) as e:
        tio.read_csv(tctx, "/nonexistent/x.csv")
    assert e.value.status.code == TCode.IOError


def test_write_delimiter(tctx, csv_pair, tmp_path):
    p1, _, df1, _ = csv_pair
    t = tio.read_csv(tctx, p1)
    out = tmp_path / "semi.csv"
    tio.write_csv(t, str(out), tio.CSVWriteOptions().WithDelimiter(";"))
    pd.testing.assert_frame_equal(pd.read_csv(out, sep=";"), df1,
                                  check_dtype=False)


# ---------------------------------------------------------------------------
# the io.csv.read fault point
# ---------------------------------------------------------------------------

def _no_sleep():
    return tres.set_retry_policy(tres.RetryPolicy(max_attempts=3,
                                                  base_delay_s=0.0))


def test_transient_read_fault_is_retried(tctx, csv_pair):
    p1, _, df1, _ = csv_pair
    prev = _no_sleep()
    ttrace.enable_counters()
    ttrace.reset()
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
        "io.csv.read", kind="transient", nth=1)])
    try:
        with tfaults.active(plan):
            t = tio.read_csv(tctx, p1)
        c = ttrace.counters()
    finally:
        tres.set_retry_policy(prev)
        ttrace.disable_counters()
        ttrace.reset()
    assert plan.fired == [("io.csv.read", "transient")]
    assert c["retry.attempts"] == 1 and c["fault.injected"] == 1
    pd.testing.assert_frame_equal(t.to_pandas(), df1, check_dtype=False)


def test_permanent_read_fault_propagates_typed(tctx, csv_pair):
    p1, _, _, _ = csv_pair
    prev = _no_sleep()
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
        "io.csv.read", kind="permanent")])
    try:
        with tfaults.active(plan):
            with pytest.raises(tfaults.PermanentFault):
                tio.read_csv(tctx, p1)
    finally:
        tres.set_retry_policy(prev)
    assert plan.fired == [("io.csv.read", "permanent")]


def test_unparsable_file_raises_io_error(tctx, tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("a,b\n1,2\n3\n")
    with pytest.raises(TCylonError) as e:
        tio.read_csv(tctx, str(p))
    assert e.value.status.code == TCode.IOError and "bad.csv" in str(e.value)


# ---------------------------------------------------------------------------
# options, sequential reads and the per-rank path
# ---------------------------------------------------------------------------

def test_option_lowering_equals_jax():
    def build(m):
        return (m.CSVReadOptions().UseThreads(False).WithDelimiter("|")
                .IgnoreEmptyLines(False).ColumnNames(["a", "b"])
                .BlockSize(4096).SkipRows(1).UseQuoting(False)
                .DoubleQuote(False).UseEscaping(True).EscapingCharacter("^")
                .NullValues(["-"]).StringsCanBeNull(True)
                .IncludeColumns(["b"]).ConcurrentFileReads(False))
    got, want = build(tio).to_pyarrow(), build(jio).to_pyarrow()
    for g, w in zip(got, want):
        assert g.equals(w)
    assert tio.CSVReadOptions().with_delimiter is not None
    w = tio.CSVWriteOptions().with_delimiter(";").column_names(["x"])
    assert (w._delimiter, w._column_names) == (";", ["x"])


def test_sequential_read_and_renamed_write(tctx, csv_pair, tmp_path):
    p1, p2, df1, df2 = csv_pair
    ts = tio.read_csv_many(tctx, [p1, p2],
                           tio.CSVReadOptions().ConcurrentFileReads(False))
    pd.testing.assert_frame_equal(ts[1].to_pandas(), df2, check_dtype=False)
    out = tmp_path / "renamed.csv"
    tio.write_csv(ts[0], str(out), tio.CSVWriteOptions().ColumnNames(
        ["key", "val"]))
    assert list(pd.read_csv(out).columns) == ["key", "val"]


@pytest.mark.parametrize("world", [1, 8])
def test_per_rank_csv_into_from_partitions(ctx, dctx, tmp_path, world):
    """One CSV per shard (reference table_join_dist_test.cpp:87-91), read
    concurrently, into ``DTable.from_partitions``: the layout equals the
    JAX package's, and ``write_csv`` of one partition round-trips."""
    rng = np.random.default_rng(70 + world)
    paths = []
    for r in range(world):
        n = int(rng.integers(0, 40))
        df = pd.DataFrame({"k": rng.integers(0, 9, n).astype(np.int32),
                           "s": rng.choice(["x", "y", "z"], n),
                           "v": np.round(rng.random(n), 4)})
        paths.append(str(tmp_path / f"part_{r}.csv"))
        df.to_csv(paths[-1], index=False)
    opts = tio.CSVReadOptions().WithColumnTypes(
        {"k": __import__("pyarrow").int32()})
    jopts = jio.CSVReadOptions().WithColumnTypes(
        {"k": __import__("pyarrow").int32()})
    lctx = pt.CylonContext(device="cpu")
    tparts = tio.read_csv_many(lctx, paths, opts)
    jparts = jio.read_csv_many(ctx, paths, jopts)
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    got = TDTable.from_partitions(pt.CylonContext(device="cpu", world=world),
                                  tparts)
    assert_same_layout(got, JDTable.from_partitions(jctx, jparts))
    out = tmp_path / "back.csv"
    tio.write_csv(got.partition(world - 1), str(out))
    back = tio.read_csv(lctx, str(out), opts)
    assert port_rows(back, ordered=True) == \
        port_rows(tparts[world - 1], ordered=True)
