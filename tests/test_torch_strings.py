"""Hash64 string keys and the host runtime: the port's ``strings.py`` and
``native/runtime.py`` against the JAX package's (``cylon_tpu/strings.py``,
the numpy paths of ``cylon_tpu/native/runtime.py``) on the same
numpy-seeded inputs: the two murmur3 lanes bit for bit (the vectorized
path against the scalar routine too), dictionary encoding, the
``StringStore`` (registration, collision detection, ``resolve`` /
``resolve_frame`` with join prefixes), ``encode_frame`` with nullable
lanes, and the hash64 join and groupby at world 1 and 8 against the JAX
package and pandas.  Null keys decode to ``None`` (the documented
contract of ``resolve_frame``) and group as the dictionary path does."""
import sys

import numpy as np
import pandas as pd
import pytest

from cylon_tpu import JoinConfig as JJoinConfig
from cylon_tpu import strings as jstr
from cylon_tpu.native import runtime as jruntime
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import dist_groupby as jgroupby
from cylon_tpu.parallel import dist_join as jjoin

import cylon_tpu as ct
import cylon_tpu_torch as pt
from cylon_tpu_torch import strings as tstr
from cylon_tpu_torch.native import runtime as truntime
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_groupby as tgroupby
from cylon_tpu_torch.parallel import dist_join as tjoin
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import jax_trace_shim  # noqa: F401

WORLDS = [1, 8]

VALUE_SETS = {
    "ascii": np.array(["", "a", "ab", "abc", "abcd", "abcde", "user-42",
                       "the quick brown fox"], dtype=object),
    "non_ascii": np.array(["é", "日本語", "γδε", "naïve café", "🙂x",
                           "Ωmega-ω"], dtype=object),
    "bytes_and_none": np.array([b"", b"\x00", b"raw\xff", None, "mixed",
                                None, b"\x01\x02\x03\x04\x05"], dtype=object),
    "long": np.array(["x" * 1001, "y" * 4096, "z" * 63 + "é",
                      "".join(chr(65 + i % 26) for i in range(777))],
                     dtype=object),
}


def _ctxs(dctx, world):
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    return jctx, pt.CylonContext(device="cpu", world=world)


def _rand_strings(rng, n, n_distinct):
    pool = np.array([f"user-{i:08x}-{i * 2654435761 % 97:02d}"
                     for i in range(n_distinct)], dtype=object)
    return pool[rng.integers(0, n_distinct, n)]


# ---------------------------------------------------------------------------
# the host runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(VALUE_SETS))
def test_hash64_strings_equal_jax(kind):
    vals = VALUE_SETS[kind]
    got, want = truntime.hash64_strings(vals), jruntime.hash64_strings(vals)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 == w.dtype
        np.testing.assert_array_equal(g, w)
    none = np.array([v is None for v in vals])
    assert (got[0][none] == 0).all() and (got[1][none] == 0).all()


@pytest.mark.parametrize("route", ["arrow", "python"])
def test_vectorized_hash64_equals_the_scalar_routine(monkeypatch, route):
    """Every tail length (0-3 bytes) at many lengths, random bytes and
    text, against ``murmur3_32_bytes`` one string at a time; the UTF-8
    bytes from pyarrow's buffers and, without pyarrow, from Python."""
    if route == "python":
        monkeypatch.setitem(sys.modules, "pyarrow", None)
    rng = np.random.default_rng(5)
    vals = [bytes(rng.integers(0, 256, n, dtype=np.uint8).tolist())
            for n in rng.integers(0, 70, 400)]
    vals += ["".join(chr(c) for c in rng.integers(32, 0x3000, n))
             for n in rng.integers(0, 30, 200)]
    vals = np.array(vals + [None], dtype=object)
    h0, h1 = truntime.hash64_strings(vals)
    for v, a, b in zip(vals, h0, h1):
        if v is None:
            assert a == b == 0
            continue
        raw = v.encode() if isinstance(v, str) else v
        assert a == truntime.murmur3_32_bytes(raw, 0x9747B28C)
        assert b == truntime.murmur3_32_bytes(raw, 0x85EBCA6B)
        assert a == jruntime.murmur3_32_bytes(raw, 0x9747B28C)
    assert len({len(v) % 4 for v in vals[:-1]}) == 4


def test_word_hashes_and_dictionary_encode_equal_jax():
    rng = np.random.default_rng(9)
    u32 = rng.integers(0, 2**32, 500, dtype=np.uint32)
    u64 = rng.integers(0, 2**63, 500, dtype=np.uint64) * np.uint64(2)
    for seed in (0, 0x9747B28C):
        np.testing.assert_array_equal(truntime.murmur3_32_u32(u32, seed),
                                      jruntime.murmur3_32_u32(u32, seed))
        np.testing.assert_array_equal(truntime.murmur3_32_u64(u64, seed),
                                      jruntime.murmur3_32_u64(u64, seed))
    words = _rand_strings(rng, 300, 40)
    for vals in (words, np.empty(0, object),
                 np.array([b"b", b"a", b"b"], object)):
        tc, td = truntime.dictionary_encode(vals)
        jc, jd = jruntime.dictionary_encode(vals)
        assert tc.dtype == np.int32
        np.testing.assert_array_equal(tc, jc)
        assert list(td) == list(jd)
    got0, got1 = tstr.hash_lanes(words)
    want0, want1 = jstr.hash_lanes(words)
    assert got0.dtype == np.int32
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got1, want1)
    assert tstr.key_of("k") == jstr.key_of("k") == ("k#h0", "k#h1")


# ---------------------------------------------------------------------------
# the store and the frame codec
# ---------------------------------------------------------------------------

def test_encode_resolve_round_trip_equals_jax():
    rng = np.random.default_rng(11)
    df = pd.DataFrame({"k": _rand_strings(rng, 500, 200),
                       "v": rng.normal(size=500),
                       "name": rng.choice(["ann", "bob"], 500)})
    tenc, tstore = tstr.encode_frame(df)
    jenc, jstore = jstr.encode_frame(df)
    assert list(tenc.columns) == list(jenc.columns) == \
        ["k#h0", "k#h1", "v", "name#h0", "name#h1"]
    pd.testing.assert_frame_equal(tenc, jenc)
    assert tenc["k#h0"].dtype == np.int32
    back = tstore.resolve_frame(tenc)
    pd.testing.assert_frame_equal(back, jstore.resolve_frame(jenc))
    np.testing.assert_array_equal(back["k"].to_numpy(), df["k"].to_numpy())
    only = tstore.resolve_frame(tenc, columns=["name"])
    assert list(only.columns) == ["k#h0", "k#h1", "v", "name"]


def test_collision_detected_at_ingest():
    """Two different strings forced onto one 64-bit hash raise, within a
    batch and across batches, as in the JAX package."""
    for mod in (tstr, jstr):
        store = mod.StringStore()
        h0 = np.array([7, 7], dtype=np.int32)
        h1 = np.array([9, 9], dtype=np.int32)
        store.register("k", np.array(["a", "a"], dtype=object), h0, h1)
        with pytest.raises(Exception, match="collision"):
            store.register("k", np.array(["b"], dtype=object),
                           h0[:1], h1[:1])
        with pytest.raises(Exception, match="collision"):
            mod.StringStore().register(
                "k", np.array(["a", "b"], dtype=object), h0, h1)
    store = tstr.StringStore()
    with pytest.raises(TCylonError, match="collision"):
        store.register("k", np.array(["a", "b"], dtype=object),
                       np.array([1, 1], np.int32), np.array([2, 2], np.int32))
    with pytest.raises(TCylonError):
        store.resolve("missing", np.zeros(1, np.int32), np.zeros(1, np.int32))


def test_resolve_unknown_pairs_and_prefixes():
    store = tstr.StringStore()
    vals = np.array(["x", "y"], dtype=object)
    h0, h1 = tstr.hash_lanes(vals)
    store.register("k", vals, h0, h1)
    got = store.resolve("k", np.array([h0[1], 5], np.int32),
                        np.array([h1[1], 6], np.int32))
    assert got.tolist() == ["y", None]
    frame = pd.DataFrame({"lt-k#h0": h0, "lt-k#h1": h1,
                          "rt-k#h0": pd.array([h0[0], None], "Int32"),
                          "rt-k#h1": pd.array([h1[0], None], "Int32"),
                          "v": [1.0, 2.0]})
    out = store.resolve_frame(frame)
    assert out["lt-k"].tolist() == ["x", "y"]
    assert out["rt-k"].tolist() == ["x", None]
    assert list(out.columns) == ["v", "lt-k", "rt-k"]


def test_null_keys_encode_nullable_lanes_and_decode_to_none(dctx):
    """``None`` keys emit nullable lanes (DTable ingest marks them null)
    and decode back to ``None`` — the documented contract, held also on
    pandas 3, where an exported int32-with-nulls lane reads back as
    float64 with NaN."""
    store = tstr.StringStore()
    enc, _ = tstr.encode_frame(
        pd.DataFrame({"k": np.array(["x", None, "y"], dtype=object)}),
        ["k"], store)
    jenc, _ = jstr.encode_frame(
        pd.DataFrame({"k": np.array(["x", None, "y"], dtype=object)}), ["k"])
    pd.testing.assert_frame_equal(enc, jenc)
    assert str(enc["k#h0"].dtype) == "Int32"
    assert enc["k#h0"].isna().tolist() == [False, True, False]
    dt = TDTable.from_pandas(pt.CylonContext(device="cpu", world=2), enc)
    for lane in ("k#h0", "k#h1"):
        assert dt.column(lane).validity is not None
    back = store.resolve_frame(enc)
    assert back["k"].tolist() == ["x", None, "y"]
    assert back["k"].dtype == object
    exported = dt.to_table().to_pandas()
    assert str(exported["k#h0"].dtype) in ("float64", "Int32")
    assert store.resolve_frame(exported)["k"].tolist() == ["x", None, "y"]


# ---------------------------------------------------------------------------
# the data plane on the lanes
# ---------------------------------------------------------------------------

def _sorted_frame(df, cols):
    return df.sort_values(cols).reset_index(drop=True)


@pytest.mark.parametrize("world", WORLDS)
def test_hash64_join_equals_jax_and_pandas(dctx, jax_trace_shim, world):
    """The join on the lane pair: nothing is dictionary-encoded, the
    kernel wrapper hashes two int32 key columns, and the resolved rows
    equal the JAX package's and pandas' merge."""
    jctx, tctx = _ctxs(dctx, world)
    rng = np.random.default_rng(12)
    ldf = pd.DataFrame({"k": _rand_strings(rng, 800, 300),
                        "a": rng.normal(size=800)})
    rdf = pd.DataFrame({"k": np.array(sorted(set(ldf["k"]))[:250],
                                      dtype=object),
                        "b": rng.normal(size=250)})
    outs = []
    for mod, D, join, cfg, ctx in (
            (tstr, TDTable, tjoin, pt.JoinConfig, tctx),
            (jstr, JDTable, jjoin, JJoinConfig, jctx)):
        store = mod.StringStore()
        lenc, _ = mod.encode_frame(ldf, ["k"], store)
        renc, _ = mod.encode_frame(rdf, ["k"], store)
        lt, rt = D.from_pandas(ctx, lenc), D.from_pandas(ctx, renc)
        assert all(c.dictionary is None for c in lt.columns + rt.columns)
        c = cfg.InnerJoin(("k#h0", "k#h1"), ("k#h0", "k#h1"))
        out = join(lt, rt, c).to_table().to_pandas()
        got = store.resolve_frame(out)
        outs.append(_sorted_frame(got[["lt-k", "lt-a", "rt-b"]],
                                  ["lt-k", "lt-a", "rt-b"]))
    pd.testing.assert_frame_equal(outs[0], outs[1])
    exp = ldf.merge(rdf, on="k", how="inner").rename(
        columns={"k": "lt-k", "a": "lt-a", "b": "rt-b"})
    pd.testing.assert_frame_equal(
        outs[0], _sorted_frame(exp, ["lt-k", "lt-a", "rt-b"]),
        check_dtype=False)


@pytest.mark.parametrize("world", WORLDS)
def test_hash64_left_join_misses_decode_to_none(dctx, jax_trace_shim, world):
    jctx, tctx = _ctxs(dctx, world)
    ldf = pd.DataFrame({"k": np.array(["a", "b", "c", "d"], object),
                        "a": [1.0, 2.0, 3.0, 4.0]})
    rdf = pd.DataFrame({"k": np.array(["b", "d", "e"], object),
                        "b": [20.0, 40.0, 50.0]})
    store = tstr.StringStore()
    lenc, _ = tstr.encode_frame(ldf, ["k"], store)
    renc, _ = tstr.encode_frame(rdf, ["k"], store)
    out = tjoin(TDTable.from_pandas(tctx, lenc),
                TDTable.from_pandas(tctx, renc),
                pt.JoinConfig.LeftJoin(("k#h0", "k#h1"), ("k#h0", "k#h1")))
    got = _sorted_frame(store.resolve_frame(out.to_table().to_pandas()),
                        ["lt-a"])
    assert got["lt-k"].tolist() == ["a", "b", "c", "d"]
    assert got["rt-k"].tolist() == [None, "b", None, "d"]


@pytest.mark.parametrize("world", WORLDS)
def test_hash64_groupby_equals_jax_and_pandas(dctx, jax_trace_shim, world):
    jctx, tctx = _ctxs(dctx, world)
    rng = np.random.default_rng(13)
    df = pd.DataFrame({"k": _rand_strings(rng, 600, 40),
                       "v": rng.normal(size=600)})
    res = []
    for mod, D, gb, ctx in ((tstr, TDTable, tgroupby, tctx),
                            (jstr, JDTable, jgroupby, jctx)):
        enc, store = mod.encode_frame(df, ["k"])
        g = gb(D.from_pandas(ctx, enc), ["k#h0", "k#h1"],
               [("v", "sum"), ("v", "count")])
        res.append(_sorted_frame(store.resolve_frame(
            g.to_table().to_pandas()), ["k"]))
    pd.testing.assert_frame_equal(res[0], res[1], check_dtype=False,
                                  rtol=1e-12)
    exp = _sorted_frame(df.groupby("k")["v"].agg(["sum", "count"])
                        .reset_index(), ["k"])
    np.testing.assert_array_equal(res[0]["k"].to_numpy(),
                                  exp["k"].to_numpy())
    np.testing.assert_allclose(res[0]["sum_v"].to_numpy(),
                               exp["sum"].to_numpy(), rtol=1e-12)
    np.testing.assert_array_equal(res[0]["count_v"].to_numpy(),
                                  exp["count"].to_numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_null_keys_group_like_the_dictionary_path(dctx, world):
    """A groupby over hash64 lanes with ``None`` keys gives the
    dictionary-string path's groups, the null group decoding to
    ``None``."""
    _, tctx = _ctxs(dctx, world)
    ks = np.array(["a", None, "b", "a", None, "b", "a", None], dtype=object)
    df = pd.DataFrame({"k": ks, "v": np.arange(8.0)})
    gd = tgroupby(TDTable.from_pandas(tctx, df), ["k"],
                  [("v", "sum"), ("v", "count")]).to_table().to_pandas()
    enc, store = tstr.encode_frame(df, ["k"])
    gh = store.resolve_frame(tgroupby(
        TDTable.from_pandas(tctx, enc), ["k#h0", "k#h1"],
        [("v", "sum"), ("v", "count")]).to_table().to_pandas())
    gd = gd.sort_values("k", na_position="last").reset_index(drop=True)
    gh = gh.sort_values("k", na_position="last").reset_index(drop=True)
    assert gh["k"].tolist() == ["a", "b", None]
    assert list(gd["k"].fillna("~null~")) == list(gh["k"].fillna("~null~"))
    np.testing.assert_array_equal(gd["sum_v"].to_numpy(),
                                  gh["sum_v"].to_numpy())
    np.testing.assert_array_equal(gd["count_v"].to_numpy(),
                                  gh["count_v"].to_numpy())


def test_lanes_reach_the_partition_hash_as_two_key_columns(monkeypatch):
    """A hash64 key is two int32 lanes at the kernel wrapper: the shuffle
    calls ``partition_ids_fused`` with both."""
    from cylon_tpu_torch.parallel import dist_ops
    seen = []
    real = hash_cuda.partition_ids_fused

    def spy(cols, vals, nparts):
        seen.append(tuple(c.dtype for c in cols))
        return real(cols, vals, nparts)

    monkeypatch.setattr(dist_ops, "partition_ids_fused", spy)
    from cylon_tpu_torch.parallel import shuffle_table
    enc, _ = tstr.encode_frame(pd.DataFrame({
        "k": np.array(["p", "q", "r", "p"], object), "v": [1, 2, 3, 4]}))
    dt = TDTable.from_pandas(pt.CylonContext(device="cpu", world=4), enc)
    shuffle_table(dt, list(tstr.key_of("k")))
    import torch
    assert seen == [(torch.int32, torch.int32)]
