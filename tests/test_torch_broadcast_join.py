"""Broadcast and dense FK join parity: the port's ``dist_join`` on the
replicated-small-side path and on the ``dense_key_range`` (FK → PK) path
against the JAX package's on the 8 virtual CPU devices (and at world 1
for the FK join), on the same numpy inputs.  Every shard must hold the
same rows in the same order as in JAX (the broadcast join keeps the
large side's layout); each result must also equal the port's own shuffle
path as a row multiset.  Also: RIGHT / FULL_OUTER never broadcast, the
threshold takes effect exactly at the boundary, the replica cache
gathers once and is keyed on metadata, and FK contract violations
raise."""
import numpy as np
import pyarrow as pa
import pytest

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu.parallel import dist_join as jdist_join
from cylon_tpu.parallel import dist_select as jdist_select
from cylon_tpu.status import CylonError as JCylonError

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.parallel import dist_join as tdist_join
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import dist_project as tdist_project
from cylon_tpu_torch.parallel import dist_select as tdist_select

from test_torch_common import jax_rows, jax_trace_shim, port_rows, schema  # noqa: F401
from test_torch_dist_join import _both_dtables


@pytest.fixture(autouse=True)
def _fresh_replicas():
    tbroadcast.clear_replica_cache()
    yield
    tbroadcast.clear_replica_cache()


def _cfgs(how="inner", thr=None, lkey="k", rkey="k"):
    return (ct.JoinConfig(ct.JoinType(how), ct.JoinAlgorithm.SORT, lkey,
                          rkey, broadcast_threshold=thr),
            pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm.SORT, lkey,
                          rkey, broadcast_threshold=thr))


def _same_rows(got, want):
    """Schema, rows per shard and rows in order (not ``cap``: the JAX
    package may bucket a capacity from an earlier call's size hint)."""
    assert schema(got) == schema(want)
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


def _multiset(t):
    return sorted((r for s in port_rows(t) for r in s), key=repr)


def _frames(rng, kind="int", n_l=311, n_r=29):
    """A big left side and a small right side per key flavour."""
    if kind == "int":
        lk = pa.array(rng.integers(0, 40, n_l))
        rk = pa.array(rng.permutation(40)[:n_r])
    elif kind == "str":
        pool = np.array([f"key-{i:03d}" for i in range(40)], dtype=object)
        lk = pa.array(pool[rng.integers(0, 40, n_l)])
        rk = pa.array(rng.permutation(pool)[:n_r])
    else:  # nullable int keys
        lk = pa.array(rng.integers(0, 40, n_l), mask=rng.random(n_l) < 0.12)
        rk = pa.array(rng.permutation(40)[:n_r], mask=rng.random(n_r) < 0.2)
    return (pa.table({"k": lk, "a": pa.array(rng.normal(size=n_l))}),
            pa.table({"k": rk, "b": pa.array(rng.normal(size=n_r))}))


def _join(ctx, dctx, world, lt, rt, how="inner", thr=None, **kw):
    """(port result, JAX result, port decisions)."""
    jl, tl = _both_dtables(ctx, dctx, world, lt)
    jr, tr = _both_dtables(ctx, dctx, world, rt)
    jcfg, tcfg = _cfgs(how, thr)
    want = jdist_join(jl, jr, jcfg, **kw)
    tdist_ops.decisions.clear()
    got = tdist_join(tl, tr, tcfg, **kw)
    return got, want, dict(tdist_ops.decisions)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("kind", ["int", "str", "nullint"])
def test_broadcast_join_matches_jax_and_shuffle(ctx, dctx, jax_trace_shim,
                                                how, kind):
    lt, rt = _frames(np.random.default_rng(300), kind)
    got, want, taken = _join(ctx, dctx, 8, lt, rt, how, thr=10_000)
    assert taken == {"join.broadcast": 1}
    _same_rows(got, want)
    shuffled, _, taken = _join(ctx, dctx, 8, lt, rt, how, thr=0)
    assert taken == {"join.shuffle": 1}
    assert _multiset(got) == _multiset(shuffled)


def test_broadcast_inner_replicates_the_small_left_side(ctx, dctx,
                                                        jax_trace_shim):
    rt, lt = _frames(np.random.default_rng(301))
    lt = lt.rename_columns(["k", "a"])
    rt = rt.rename_columns(["k", "b"])
    got, want, taken = _join(ctx, dctx, 8, lt, rt, "inner", thr=10_000)
    assert taken == {"join.broadcast": 1}
    _same_rows(got, want)
    # the big (right) side stays in place: its layout is the output's
    assert list(got.counts_host()) != [got.num_rows] + [0] * 7


@pytest.mark.parametrize("how", ["right", "full_outer"])
def test_right_and_full_outer_stay_on_the_shuffle(ctx, dctx, jax_trace_shim,
                                                  how):
    lt, rt = _frames(np.random.default_rng(302))
    got, want, taken = _join(ctx, dctx, 8, lt, rt, how, thr=10_000)
    assert taken == {"join.shuffle": 1}
    _same_rows(got, want)


def test_threshold_takes_effect_at_the_boundary(ctx, dctx, jax_trace_shim):
    """Rows == threshold broadcasts, rows == threshold + 1 shuffles (the
    ingest-cached counts make the decision exact)."""
    lt, rt = _frames(np.random.default_rng(303))
    n = rt.num_rows
    for thr, path in ((n, "join.broadcast"), (n - 1, "join.shuffle")):
        got, want, taken = _join(ctx, dctx, 8, lt, rt, thr=thr)
        assert taken == {path: 1}
        _same_rows(got, want)


def test_process_wide_threshold(ctx, dctx, jax_trace_shim):
    """With no per-call override the process-wide knob decides; None
    disables broadcast joins."""
    lt, rt = _frames(np.random.default_rng(304))
    jprev = jconfig.set_broadcast_join_threshold(None)
    tprev = tconfig.set_broadcast_join_threshold(None)
    try:
        got, want, taken = _join(ctx, dctx, 8, lt, rt)
        assert taken == {"join.shuffle": 1}
        _same_rows(got, want)
    finally:
        jconfig.set_broadcast_join_threshold(jprev)
        tconfig.set_broadcast_join_threshold(tprev)
    got, want, taken = _join(ctx, dctx, 8, lt, rt)
    assert taken == {"join.broadcast": 1}
    _same_rows(got, want)


def test_broadcast_empty_small_side(ctx, dctx, jax_trace_shim):
    lt, rt = _frames(np.random.default_rng(305))
    rt = rt.slice(0, 0)
    for how in ("inner", "left"):
        got, want, taken = _join(ctx, dctx, 8, lt, rt, how, thr=10_000)
        assert taken == {"join.broadcast": 1}
        _same_rows(got, want)
        assert got.num_rows == (0 if how == "inner" else lt.num_rows)


def test_broadcast_after_deferred_select(ctx, dctx, jax_trace_shim):
    """A small side with a deferred select collapses before it is
    replicated (its capacity bound decides)."""
    lt, rt = _frames(np.random.default_rng(306))
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    pred = lambda env: env["k"] < 20  # noqa: E731
    jcfg, tcfg = _cfgs(thr=10_000)
    _same_rows(tdist_join(tl, tdist_select(tr, pred, compact=False), tcfg),
               jdist_join(jl, jdist_select(jr, pred, compact=False), jcfg))


def test_composite_key_broadcast(ctx, dctx, jax_trace_shim):
    rng = np.random.default_rng(307)
    lt = pa.table({"k1": pa.array(rng.integers(0, 8, 257)),
                   "k2": pa.array(rng.integers(0, 5, 257)),
                   "a": pa.array(rng.normal(size=257))})
    rt = pa.table({"k1": pa.array(rng.integers(0, 8, 21)),
                   "k2": pa.array(rng.integers(0, 5, 21)),
                   "b": pa.array(rng.normal(size=21))})
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    jcfg, tcfg = _cfgs(thr=10_000, lkey=("k1", "k2"), rkey=("k1", "k2"))
    _same_rows(tdist_join(tl, tr, tcfg), jdist_join(jl, jr, jcfg))


def test_replica_cache_gathers_once(ctx, dctx, jax_trace_shim):
    """Three joins against re-projections of one small table gather it
    once: the cache is keyed by the source tensors' identity."""
    lt, rt = _frames(np.random.default_rng(308))
    _, tl = _both_dtables(ctx, dctx, 8, lt)
    _, tr = _both_dtables(ctx, dctx, 8, rt)
    _, tcfg = _cfgs(thr=10_000)
    before = tbroadcast.gathers
    outs = [tdist_join(tl, tdist_project(tr, ["k", "b"]), tcfg)
            for _ in range(3)]
    assert tbroadcast.gathers == before + 1
    assert _multiset(outs[0]) == _multiset(outs[2])


def test_replica_cache_keyed_on_metadata(ctx, dctx, jax_trace_shim):
    """A renamed handle shares the tensors but must not hit the replica
    cached under the old names."""
    lt, rt = _frames(np.random.default_rng(309))
    _, tl = _both_dtables(ctx, dctx, 8, lt)
    _, tr = _both_dtables(ctx, dctx, 8, rt)
    tdist_join(tl, tr, _cfgs(thr=10_000)[1])
    before = tbroadcast.gathers
    out = tdist_join(tl, tr.rename(["key", "val"]), pt.JoinConfig(
        pt.JoinType.INNER, pt.JoinAlgorithm.SORT, "k", "key",
        broadcast_threshold=10_000))
    assert tbroadcast.gathers == before + 1
    assert out.column_names == ["lt-k", "lt-a", "rt-key", "rt-val"]


# ---------------------------------------------------------------------------
# the dense FK join (dense_key_range)
# ---------------------------------------------------------------------------

def _fk_frames(rng, n_l=311, n_r=29, left_nulls=True):
    """Right: unique keys 1..n_r (the PK); left: FKs in [1, n_r + 4]
    (some unmatched) with nulls."""
    lk = pa.array(rng.integers(1, n_r + 5, n_l),
                  mask=(rng.random(n_l) < 0.07) if left_nulls else None)
    rt = pa.table({"k": pa.array(rng.permutation(n_r) + 1),
                   "b": pa.array(rng.normal(size=n_r)),
                   "c": pa.array(rng.integers(0, 9, n_r).astype(np.int32))})
    return pa.table({"k": lk, "a": pa.array(rng.normal(size=n_l))}), rt


@pytest.mark.parametrize("world,thr", [(1, None), (8, 10_000), (8, 0)])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_fk_join_matches_jax(ctx, dctx, jax_trace_shim, world, thr, how):
    lt, rt = _fk_frames(np.random.default_rng(310))
    got, want, taken = _join(ctx, dctx, world, lt, rt, how, thr=thr,
                             dense_key_range=(1, 29))
    path = ("join.fk-dense" if world == 1 else
            "join.fk-dense+broadcast" if thr else "join.fk-dense+shuffle")
    assert taken == {path: 1}
    _same_rows(got, want)
    general, _, _ = _join(ctx, dctx, world, lt, rt, how, thr=0)
    assert _multiset(got) == _multiset(general)
    if how == "left":
        assert got.num_rows == lt.num_rows


@pytest.mark.parametrize("thr", [10_000, 0])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_fk_join_deferred_probe_side(ctx, dctx, jax_trace_shim, thr, how):
    """INNER folds a deferred probe-side select into its matches; LEFT
    keeps it deferred on the zero-copy output."""
    lt, rt = _fk_frames(np.random.default_rng(311))
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    pred = lambda env: env["a"] > 0.0  # noqa: E731
    jcfg, tcfg = _cfgs(how, thr)
    got = tdist_join(tdist_select(tl, pred, compact=False), tr, tcfg,
                     dense_key_range=(1, 29))
    want = jdist_join(jdist_select(jl, pred, compact=False), jr, jcfg,
                      dense_key_range=(1, 29))
    assert (got.pending_mask is not None) == (want.pending_mask is not None)
    _same_rows(got, want)


@pytest.mark.parametrize("thr", [10_000, 0])
@pytest.mark.parametrize("fault", ["duplicate", "null", "out of range"])
def test_fk_contract_violation_raises(ctx, dctx, jax_trace_shim, thr,
                                      fault):
    lt, rt = _fk_frames(np.random.default_rng(312))
    keys = rt["k"].to_numpy().copy()
    mask = None
    if fault == "duplicate":
        keys[3] = keys[4]
    elif fault == "null":
        mask = np.zeros(len(keys), bool)
        mask[5] = True
    else:
        keys[6] = 40
    rt = rt.set_column(0, "k", pa.array(keys, mask=mask))
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    jcfg, tcfg = _cfgs("inner", thr)
    with pytest.raises(JCylonError, match="contract violated"):
        jdist_join(jl, jr, jcfg, dense_key_range=(1, 29)).to_table()
    # counted once per shard that builds the map (every shard when the
    # right side is replicated), as in the JAX package
    counted = r"[1-9]\d* " + {"duplicate": "duplicate keys",
                                "null": "null keys",
                                "out of range": "keys out of range"}[fault]
    with pytest.raises(pt.CylonError, match=counted):
        tdist_join(tl, tr, tcfg, dense_key_range=(1, 29))


@pytest.mark.parametrize("how,keys", [("right", ("k", "k")),
                                      ("inner", (("k", "a"), ("k", "b")))])
def test_fk_hint_ignored_where_ineligible(ctx, dctx, jax_trace_shim, how,
                                          keys):
    """RIGHT joins and composite keys take the general path."""
    lt, rt = _fk_frames(np.random.default_rng(313), left_nulls=False)
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    jcfg, tcfg = _cfgs(how, 0, *keys)
    tdist_ops.decisions.clear()
    got = tdist_join(tl, tr, tcfg, dense_key_range=(1, 29))
    assert dict(tdist_ops.decisions) == {"join.shuffle": 1}
    _same_rows(got, jdist_join(jl, jr, jcfg, dense_key_range=(1, 29)))


def test_small_side_reason_names_its_evidence(ctx, dctx):
    """Ingest-cached counts prove a base table small; after a select only
    the capacity bound does."""
    _, rt = _frames(np.random.default_rng(314))
    _, tr = _both_dtables(ctx, dctx, 8, rt)
    assert tbroadcast.small_side_reason(tr, 29) == \
        "29 rows <= threshold (ingest-cached counts)"
    sel = tdist_select(tr, lambda env: env["k"] < 20, compact=False)
    rows = tbroadcast.rows_if_small(sel, 10_000)
    assert rows == 8 * sel.cap
    assert tbroadcast.small_side_reason(sel, rows) == \
        f"capacity bound 8x{sel.cap} = {rows} <= threshold"
