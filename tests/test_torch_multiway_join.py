"""Multiway (star) join parity: the port's ``dist_multiway_join`` against
the JAX package's at world 1 and on the 8 virtual CPU devices, on the same
numpy inputs (integer, LEFT-fact, dictionary-string, null, composite and
dense-FK keys, an empty dimension; per-edge broadcast thresholds that
replicate, shuffle, or mix): the same rows on the same shards in the same
order, the same ``cap`` and ``counts``.  The port's result also holds the
same row multiset as its binary ``dist_join`` cascade over the same
edges, and every probe leaves one ``multiway.<label>`` decision.  The edge
validation errors are the JAX package's."""
import numpy as np
import pyarrow as pa
import pytest

from cylon_tpu.parallel import dist_ops as jdist_ops

import cylon_tpu_torch as pt
from cylon_tpu_torch.parallel import dist_ops as tdist_ops

from test_torch_common import (jax_rows, jax_trace_shim, port_rows,  # noqa: F401
                               schema)
from test_torch_dist_join import _both_dtables


def _strip_names(names):
    out = []
    for n in names:
        while n.startswith(("lt-", "rt-")):
            n = n[3:]
        out.append(n)
    return out


def _star(rng, n_fact=1200, n_d1=300, n_d2=40):
    fact = pa.table({
        "fk1": pa.array(rng.integers(0, n_d1, n_fact).astype(np.int32)),
        "fk2": pa.array(rng.integers(0, n_d2, n_fact).astype(np.int32)),
        "fv": pa.array(rng.random(n_fact).astype(np.float32)),
    })
    d1 = pa.table({"k1": pa.array(rng.permutation(n_d1).astype(np.int32)),
                   "w": pa.array(rng.random(n_d1).astype(np.float32))})
    d2 = pa.table({"k2": pa.array(np.arange(n_d2, dtype=np.int32)),
                   "x": pa.array(rng.random(n_d2).astype(np.float32))})
    return fact, [d1, d2]


def _edges(fact, dims, specs):
    """Edge tuples from ``(how, fact_on, dim_on, dkr, thr)`` specs; every
    probe but the last renames its output back to the bare names (the
    binary cascade's prefix strip)."""
    names = list(fact.column_names)
    edges = []
    for j, (dim, (how, fon, don, dkr, thr)) in enumerate(zip(dims, specs)):
        out = ["lt-" + n for n in names] + ["rt-" + n
                                            for n in dim.column_names]
        last = j == len(specs) - 1
        ren = () if last else tuple(zip(out, _strip_names(out)))
        names = out if last else _strip_names(out)
        edges.append((how, "sort", tuple(fon), tuple(don), dkr, thr, ren))
    return edges


def _cascade(fact, dims, edges):
    """The port's binary cascade over the same edges."""
    cur = fact
    for dim, (how, alg, fon, don, dkr, thr, ren) in zip(dims, edges):
        cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm(alg),
                            fon[0] if len(fon) == 1 else fon,
                            don[0] if len(don) == 1 else don,
                            broadcast_threshold=thr)
        cur = tdist_ops._multiway_rename(tdist_ops.dist_join(cur, dim, cfg,
                                                             dkr), ren)
    return cur


def _flat(dt):
    return sorted((r for s in port_rows(dt) for r in s), key=repr)


def _check(ctx, dctx, world, fact, dims, specs):
    jf, tf = _both_dtables(ctx, dctx, world, fact)
    pairs = [_both_dtables(ctx, dctx, world, d) for d in dims]
    edges = _edges(fact, dims, specs)
    want = jdist_ops.dist_multiway_join(jf, [j for j, _ in pairs], edges)
    tdist_ops.decisions.clear()
    got = tdist_ops.dist_multiway_join(tf, [t for _, t in pairs], edges)
    labels = {k: v for k, v in tdist_ops.decisions.items()
              if k.startswith("multiway.")}
    assert sum(labels.values()) == len(edges)
    if world == 1:
        assert labels == {"multiway.local": len(edges)}
    assert schema(got) == schema(want)
    assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)
    assert _flat(got) == _flat(_cascade(tf, [t for _, t in pairs], edges))
    return got, labels


STAR = [("inner", ["fk1"], ["k1"], None, None),
        ("inner", ["fk2"], ["k2"], None, None)]


@pytest.mark.parametrize("world,thr", [(1, None), (8, None), (8, 0),
                                       (8, 64)])
def test_multiway_int_keys_match_jax(ctx, dctx, jax_trace_shim, world, thr):
    """thr None: both dimensions replicate; 0: both shuffle; 64: the
    40-row dimension replicates, the 300-row one is over the crossover
    ``P·cap / (P − 1)`` and shuffles."""
    fact, dims = _star(np.random.default_rng(50))
    specs = [s[:4] + (thr,) for s in STAR]
    _, labels = _check(ctx, dctx, world, fact, dims, specs)
    if world > 1:
        want = {None: {"multiway.broadcast": 2}, 0: {"multiway.shuffle": 2},
                64: {"multiway.shuffle": 1, "multiway.broadcast": 1}}[thr]
        assert labels == want


@pytest.mark.parametrize("world", [1, 8])
def test_multiway_left_fact_edges_match_jax(ctx, dctx, jax_trace_shim, world):
    """LEFT edges keep every fact row; a dimension holding half the keys
    null-fills the rest."""
    fact, (d1, d2) = _star(np.random.default_rng(51))
    d1 = d1.filter(pa.array(np.asarray(d1["k1"]) < 150))
    specs = [("left", ["fk1"], ["k1"], None, 0),
             ("left", ["fk2"], ["k2"], None, None)]
    got, _ = _check(ctx, dctx, world, fact, [d1, d2], specs)
    assert got.num_rows == fact.num_rows


def test_multiway_dictionary_string_keys_match_jax(ctx, dctx, jax_trace_shim):
    rng = np.random.default_rng(52)
    pool = np.array([f"key-{i:03d}" for i in range(60)], dtype=object)
    fact = pa.table({"sk": pa.array(pool[rng.integers(0, 60, 500)]),
                     "ik": pa.array(rng.integers(0, 40, 500).astype(np.int32)),
                     "fv": pa.array(rng.normal(size=500))})
    d1 = pa.table({"dk": pa.array(rng.permutation(pool)[:45]),
                   "w": pa.array(rng.normal(size=45))})
    d2 = pa.table({"k2": pa.array(np.arange(40, dtype=np.int32)),
                   "x": pa.array(rng.normal(size=40))})
    specs = [("inner", ["sk"], ["dk"], None, 0),
             ("inner", ["ik"], ["k2"], None, None)]
    _check(ctx, dctx, 8, fact, [d1, d2], specs)


def test_multiway_null_keys_match_jax(ctx, dctx, jax_trace_shim):
    """Null keys follow the join kernels' null == null rule on both
    probes."""
    rng = np.random.default_rng(53)
    fact = pa.table({
        "fk": pa.array(rng.integers(0, 40, 400), mask=rng.random(400) < 0.15),
        "ik": pa.array(rng.integers(0, 20, 400).astype(np.int32)),
        "fv": pa.array(rng.normal(size=400))})
    d1 = pa.table({"dk": pa.array(rng.permutation(40)[:30],
                                  mask=rng.random(30) < 0.2),
                   "w": pa.array(rng.normal(size=30))})
    d2 = pa.table({"k2": pa.array(np.arange(20, dtype=np.int32)),
                   "x": pa.array(rng.normal(size=20))})
    specs = [("inner", ["fk"], ["dk"], None, 0),
             ("left", ["ik"], ["k2"], None, None)]
    _check(ctx, dctx, 8, fact, [d1, d2], specs)


def test_multiway_composite_keys_match_jax(ctx, dctx, jax_trace_shim):
    rng = np.random.default_rng(54)
    fact = pa.table({
        "a": pa.array(rng.integers(0, 12, 500).astype(np.int32)),
        "b": pa.array(rng.integers(0, 9, 500).astype(np.int32)),
        "ik": pa.array(rng.integers(0, 30, 500).astype(np.int32)),
        "fv": pa.array(rng.normal(size=500))})
    pick = rng.permutation(108)[:70]
    d1 = pa.table({"ca": pa.array((pick // 9).astype(np.int32)),
                   "cb": pa.array((pick % 9).astype(np.int32)),
                   "w": pa.array(rng.normal(size=70))})
    d2 = pa.table({"k2": pa.array(np.arange(30, dtype=np.int32)),
                   "x": pa.array(rng.normal(size=30))})
    specs = [("inner", ["a", "b"], ["ca", "cb"], None, 0),
             ("inner", ["ik"], ["k2"], None, None)]
    _check(ctx, dctx, 8, fact, [d1, d2], specs)


def test_multiway_dense_fk_edge_matches_jax(ctx, dctx, jax_trace_shim):
    """A dense-FK hint on an edge takes the key→row-map probe."""
    fact, dims = _star(np.random.default_rng(55))
    specs = [("inner", ["fk1"], ["k1"], (0, 299), 0),
             ("left", ["fk2"], ["k2"], (0, 39), None)]
    _check(ctx, dctx, 8, fact, dims, specs)


def test_multiway_empty_dimension_matches_jax(ctx, dctx, jax_trace_shim):
    fact, (d1, _) = _star(np.random.default_rng(56))
    empty = pa.table({"k2": pa.array(np.array([], np.int32)),
                      "x": pa.array(np.array([], np.float32))})
    got, _ = _check(ctx, dctx, 8, fact, [d1, empty], STAR)
    assert got.num_rows == 0


def test_multiway_edge_validation():
    tctx = pt.CylonContext(device="cpu", world=2)
    fact, (d1, _) = _star(np.random.default_rng(57), 40, 10, 5)
    tf = pt.parallel.DTable.from_table(tctx, pt.Table.from_arrow(tctx, fact))
    td = pt.parallel.DTable.from_table(tctx, pt.Table.from_arrow(tctx, d1))
    for edges in (
            [("right", "sort", ("fk1",), ("k1",), None, None, ())],
            [],
            [("inner", "sort", ("fk1", "fk2"), ("k1",), None, None, ())],
            [("inner", "sort", ("fk1",), ("k1",), None, None, ())] * 2):
        with pytest.raises(pt.CylonError):
            tdist_ops.dist_multiway_join(tf, [td], edges)
