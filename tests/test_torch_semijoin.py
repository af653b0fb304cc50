"""Semi / anti join parity: the port's ``dist_semi_join`` /
``dist_anti_join`` and ``ops.join.semi_mask`` against the JAX package's
at world 1 and on the 8 virtual CPU devices, on the same numpy inputs,
on every path: the sorted probe after a hash shuffle, the dense probe
(presence bits) after the modulo routing, and both against a replicated
(broadcast) right side.  Every shard must keep the same left rows in the
same order; null keys match null keys, as in the joins."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from cylon_tpu.ops import join as jjoin
from cylon_tpu.parallel import dist_anti_join as jdist_anti_join
from cylon_tpu.parallel import dist_select as jdist_select
from cylon_tpu.parallel import dist_semi_join as jdist_semi_join
from cylon_tpu.status import CylonError as JCylonError

import cylon_tpu_torch as pt
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import dist_anti_join as tdist_anti_join
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import dist_select as tdist_select
from cylon_tpu_torch.parallel import dist_semi_join as tdist_semi_join

from test_torch_common import jax_rows, jax_trace_shim, port_rows, schema  # noqa: F401
from test_torch_dist_join import _both_dtables

# path → (dense_key_range, broadcast_threshold)
PATHS = {"sort": (None, 0), "dense": ((0, 39), 0),
         "broadcast": (None, 10_000), "broadcast-dense": ((0, 39), 10_000)}
OPS = {"semi": (jdist_semi_join, tdist_semi_join),
       "anti": (jdist_anti_join, tdist_anti_join)}


def _same_rows(got, want):
    """The same schema, survivors per shard and rows in order (the JAX
    package may bucket its capacity from an earlier call's hint, so
    ``cap`` is not compared)."""
    assert schema(got) == schema(want)
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


def _sides(rng, n_l=300, n_r=120, right_nulls=True):
    """int64 keys in [0, 40) with ~8% nulls on the left; the right side
    repeats its keys (each matching left row must still come out once)."""
    lk = pa.array(rng.integers(0, 40, n_l), mask=rng.random(n_l) < 0.08)
    rk = np.repeat(rng.integers(0, 40, n_r // 4), 4)
    rmask = (rng.random(n_r) < 0.05) if right_nulls else None
    lt = pa.table({"k": lk, "a": pa.array(rng.normal(size=n_l)),
                   "s": pa.array([f"v{i % 7}" for i in range(n_l)])})
    rt = pa.table({"k": pa.array(rk, mask=rmask),
                   "b": pa.array(rng.integers(0, 9, n_r).astype(np.int32))})
    return lt, rt


def _run(ctx, dctx, world, lt, rt, op, keys=("k", "k"), **kw):
    jop, top = OPS[op]
    jl, tl = _both_dtables(ctx, dctx, world, lt)
    jr, tr = _both_dtables(ctx, dctx, world, rt)
    want = jop(jl, jr, *keys, **kw)
    tdist_ops.decisions.clear()
    got = top(tl, tr, *keys, **kw)
    return got, want, dict(tdist_ops.decisions)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("op", list(OPS))
def test_semi_anti_matches_jax(ctx, dctx, jax_trace_shim, world, path, op):
    dense, thr = PATHS[path]
    lt, rt = _sides(np.random.default_rng(200))
    got, want, taken = _run(ctx, dctx, world, lt, rt, op,
                            dense_key_range=dense, broadcast_threshold=thr)
    _same_rows(got, want)
    probe = "dense" if dense else "sort"
    route = ("local" if world == 1 else
             "broadcast" if thr else "shuffle")
    assert taken == {f"semi.{route}.{probe}": 1}


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("op", list(OPS))
def test_composite_and_string_keys(ctx, dctx, jax_trace_shim, world, op):
    """(string, int) keys: the dictionaries unify before the hash shuffle
    and the sorted probe."""
    rng = np.random.default_rng(201)
    lt = pa.table({"s": pa.array(rng.choice(["x", "y", "z", "w"], 160)),
                   "n": pa.array(rng.integers(0, 5, 160)),
                   "a": pa.array(np.arange(160, dtype=np.float64))})
    rt = pa.table({"s": pa.array(rng.choice(["x", "y", "q"], 60)),
                   "n": pa.array(rng.integers(0, 5, 60))})
    got, want, _ = _run(ctx, dctx, world, lt, rt, op,
                        keys=(("s", "n"), ("s", "n")), broadcast_threshold=0)
    _same_rows(got, want)
    rset = set(zip(rt["s"].to_pylist(), rt["n"].to_pylist()))
    hits = sum((s, n) in rset for s, n in zip(lt["s"].to_pylist(),
                                               lt["n"].to_pylist()))
    assert got.num_rows == (hits if op == "semi" else 160 - hits)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("right_nulls", [True, False])
def test_null_keys(ctx, dctx, jax_trace_shim, path, right_nulls):
    """A null left key is kept by semi (dropped by anti) iff its probe
    sees a null right key; with no null right key anti keeps them all."""
    dense, thr = PATHS[path]
    rng = np.random.default_rng(202)
    lt, rt = _sides(rng, right_nulls=right_nulls)
    for op in OPS:
        got, want, _ = _run(ctx, dctx, 8, lt, rt, op,
                            dense_key_range=dense, broadcast_threshold=thr)
        _same_rows(got, want)
    null_left = int(pa.compute.sum(lt["k"].is_null()).as_py())
    anti_nulls = sum(r[0] is None for s in port_rows(got) for r in s)
    assert anti_nulls == (0 if right_nulls else null_left)


@pytest.mark.parametrize("path", list(PATHS))
def test_empty_right_side(ctx, dctx, jax_trace_shim, path):
    dense, thr = PATHS[path]
    lt, _ = _sides(np.random.default_rng(203))
    rt = pa.table({"k": pa.array(np.zeros(0, np.int64)),
                   "b": pa.array(np.zeros(0, np.int32))})
    for op in OPS:
        got, want, _ = _run(ctx, dctx, 8, lt, rt, op,
                            dense_key_range=dense, broadcast_threshold=thr)
        _same_rows(got, want)
        assert got.num_rows == (0 if op == "semi" else lt.num_rows)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("op", list(OPS))
def test_deferred_select_inputs(ctx, dctx, jax_trace_shim, path, op):
    """Both sides carry a deferred select: the shuffle folds the masks
    into the routing, the dense probe into the valid rows, the sorted
    probe compacts first; the result is the same either way."""
    dense, thr = PATHS[path]
    lt, rt = _sides(np.random.default_rng(204))
    jop, top = OPS[op]
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    lpred = lambda env: env["a"] > 0.0  # noqa: E731
    rpred = lambda env: env["b"] < 6  # noqa: E731
    jl, tl = (jdist_select(jl, lpred, compact=False),
              tdist_select(tl, lpred, compact=False))
    jr, tr = (jdist_select(jr, rpred, compact=False),
              tdist_select(tr, rpred, compact=False))
    kw = {"dense_key_range": dense, "broadcast_threshold": thr}
    got = top(tl, tr, "k", "k", **kw)
    _same_rows(got, jop(jl, jr, "k", "k", **kw))
    compacted = top(tdist_select(_both_dtables(ctx, dctx, 8, lt)[1], lpred),
                    tdist_select(_both_dtables(ctx, dctx, 8, rt)[1], rpred),
                    "k", "k", **kw)
    assert sorted((r for s in port_rows(got) for r in s), key=repr) == \
        sorted((r for s in port_rows(compacted) for r in s), key=repr)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("side", ["left", "right"])
def test_dense_range_violation_raises(ctx, dctx, jax_trace_shim, world,
                                      side):
    """Keys reach 39; the range (0, 19) is violated by the side that is
    not cut below 20."""
    lt, rt = _sides(np.random.default_rng(205))
    jl, tl = _both_dtables(ctx, dctx, world, lt)
    jr, tr = _both_dtables(ctx, dctx, world, rt)
    cut = lambda env: env["k"] < 20  # noqa: E731
    if side == "left":
        jr, tr = jdist_select(jr, cut), tdist_select(tr, cut)
    else:
        jl, tl = jdist_select(jl, cut), tdist_select(tl, cut)
    with pytest.raises(JCylonError, match="dense_key_range"):
        jdist_semi_join(jl, jr, "k", "k", dense_key_range=(0, 19),
                        broadcast_threshold=0)
    with pytest.raises(pt.CylonError, match="dense_key_range"):
        tdist_semi_join(tl, tr, "k", "k", dense_key_range=(0, 19),
                        broadcast_threshold=0)


@pytest.mark.parametrize("with_counts", [False, True])
def test_semi_mask_matches_jax(with_counts):
    """The primitive on padded blocks with nulls and composite keys:
    bit for bit the JAX package's presence bits."""
    rng = np.random.default_rng(206)
    n_l, n_r = 97, 61
    lk = [rng.integers(0, 12, n_l), rng.integers(0, 3, n_l)]
    rk = [rng.integers(0, 12, n_r), rng.integers(0, 3, n_r)]
    lv = [rng.random(n_l) < 0.9, None]
    rv = [rng.random(n_r) < 0.9, None]
    counts = {"l_count": 80, "r_count": 50} if with_counts else {}
    want = np.asarray(jjoin.semi_mask(
        tuple(lk), tuple(lv), tuple(rk), tuple(rv), **counts))
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = tjoin.semi_mask(tuple(map(t, lk)), tuple(map(t, lv)),
                          tuple(map(t, rk)), tuple(map(t, rv)), **counts)
    np.testing.assert_array_equal(got.numpy(), want)
