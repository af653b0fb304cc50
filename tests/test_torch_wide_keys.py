"""Hash partitions on more than 16 key columns: the partition kernel takes
at most 16 key columns a launch, and its wrapper hashes more in chained
groups on the card; the plain version (CPU tensors) takes any number.
The set ops hash every column, so ``dist_union`` / ``dist_intersect`` /
``dist_subtract`` of 16-, 17- and 24-column tables, ``shuffle_table`` and
the shuffle groupby on 17 keys, and a HASH join on 17 keys are held to
the JAX package (which has no cap) at world 1 and 8: the same rows, in
the same order, on the same shards, with the same ``cap`` and counts.
A hash64 string key adds two lanes, so a 16-column table with one hashed
string column is already 17 key columns."""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import cylon_tpu as ct
from cylon_tpu import config as jconfig
from cylon_tpu import strings as jstr
from cylon_tpu.ops import hash as jhash
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import dist_groupby as jdist_groupby
from cylon_tpu.parallel import dist_intersect as jdist_intersect
from cylon_tpu.parallel import dist_join as jdist_join
from cylon_tpu.parallel import dist_subtract as jdist_subtract
from cylon_tpu.parallel import dist_union as jdist_union
from cylon_tpu.parallel import shuffle_table as jshuffle_table

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import strings as tstr
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_groupby as tdist_groupby
from cylon_tpu_torch.parallel import dist_intersect as tdist_intersect
from cylon_tpu_torch.parallel import dist_join as tdist_join
from cylon_tpu_torch.parallel import dist_subtract as tdist_subtract
from cylon_tpu_torch.parallel import dist_union as tdist_union
from cylon_tpu_torch.parallel import shuffle_table as tshuffle_table

from test_torch_common import (assert_rows_close, float_rtols,  # noqa: F401
                               jax_rows, jax_trace_shim, port_rows, schema)
from test_torch_dist_join import _both_dtables, _same

WORLDS = [1, 8]
_KINDS = ("i32", "f32", "i64")
_JDIST = {"union": jdist_union, "intersect": jdist_intersect,
          "subtract": jdist_subtract}
_TDIST = {"union": tdist_union, "intersect": tdist_intersect,
          "subtract": tdist_subtract}


def _columns(rng, n, width):
    """``width`` columns cycling int32 / float32 / int64, few distinct
    values each (so rows repeat), every third column nullable."""
    cols = {}
    for j in range(width):
        kind = _KINDS[j % 3]
        base = rng.integers(0, 3, n)
        mask = rng.random(n) < 0.15 if j % 3 == 0 else None
        if kind == "i32":
            arr = pa.array(base.astype(np.int32), mask=mask)
        elif kind == "f32":
            arr = pa.array((base * 0.5 - 0.5).astype(np.float32), mask=mask)
        else:
            arr = pa.array(base.astype(np.int64) * (1 << 40), mask=mask)
        cols[f"c{j}"] = arr
    return pa.table(cols)


def _pair(seed, width, n_a=60, n_b=50):
    """A and B with half of B's rows taken from A."""
    rng = np.random.default_rng(seed)
    a = _columns(rng, n_a, width)
    b = _columns(rng, n_b, width)
    shared = a.slice(0, n_b // 2)
    return a, pa.concat_tables([shared, b.slice(n_b // 2)]).combine_chunks()


def _same_placement(got, want):
    """The same rows on the same shards, in the same order, with the same
    counts.  ``cap`` is left out: the JAX shuffle sizes its second call
    of a set op from the first call's size hint (the port from its own
    counts), so a union's ``cap`` can differ while no row does."""
    assert schema(got) == schema(want)
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


@pytest.mark.parametrize("width", [16, 17, 24])
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", sorted(_JDIST))
def test_wide_set_ops_equal_jax(ctx, dctx, jax_trace_shim, op, world, width):
    at, bt = _pair(100 + width, width)
    ja, ta = _both_dtables(ctx, dctx, world, at)
    jb, tb = _both_dtables(ctx, dctx, world, bt)
    before = hash_cuda.launches
    _same_placement(_TDIST[op](ta, tb), _JDIST[op](ja, jb))
    assert hash_cuda.launches == before   # CPU tensors: the plain version


@pytest.mark.parametrize("world", WORLDS)
def test_shuffle_table_on_17_keys_equals_jax(ctx, dctx, jax_trace_shim,
                                             world):
    at, _ = _pair(7, 20, n_a=90)
    keys = [f"c{j}" for j in range(17)]
    jt, tt = _both_dtables(ctx, dctx, world, at)
    _same(tshuffle_table(tt, keys), jshuffle_table(jt, keys))


@pytest.mark.parametrize("world", WORLDS)
def test_shuffle_groupby_on_17_keys_equals_jax(ctx, dctx, jax_trace_shim,
                                               world):
    at, _ = _pair(8, 18, n_a=120)
    keys = [f"c{j}" for j in range(17)]
    jt, tt = _both_dtables(ctx, dctx, world, at)
    aggs = [("c17", "sum"), ("c17", "count")]
    # a threshold of 1 row: the combine takes the shuffle (None would
    # disable broadcasts in both packages, the same for this test)
    prev = (jconfig.set_broadcast_join_threshold(1),
            tconfig.set_broadcast_join_threshold(1))
    try:
        for kw in ({}, {"pre_aggregate": False}):
            got = tdist_groupby(tt, keys, aggs, **kw)
            want = jdist_groupby(jt, keys, aggs, **kw)
            assert got.cap == want.cap
            np.testing.assert_array_equal(got.counts_host(),
                                          want.counts_host())
            assert_rows_close(port_rows(got, ordered=True),
                              jax_rows(want, ordered=True), float_rtols(got))
    finally:
        jconfig.set_broadcast_join_threshold(prev[0])
        tconfig.set_broadcast_join_threshold(prev[1])


def test_hash_join_on_17_keys_equals_jax(ctx, dctx, jax_trace_shim):
    at, bt = _pair(9, 17, n_a=80, n_b=70)
    keys = [f"c{j}" for j in range(17)]
    jl, tl = _both_dtables(ctx, dctx, 8, at)
    jr, tr = _both_dtables(ctx, dctx, 8, bt)
    jcfg = ct.JoinConfig(ct.JoinType.INNER, ct.JoinAlgorithm.HASH, keys,
                         keys, broadcast_threshold=0)
    tcfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, keys,
                         keys, broadcast_threshold=0)
    got, want = tdist_join(tl, tr, tcfg), jdist_join(jl, jr, jcfg)
    assert port_rows(got) == jax_rows(want)
    assert got.num_rows > 0


@pytest.mark.parametrize("width", [17, 24, 40])
def test_plain_partition_ids_past_16_columns_equal_jax(width):
    """The wrapper's CPU path at any width = the JAX package's row hash →
    partition id, with nulls, at every group boundary."""
    rng = np.random.default_rng(width)
    n = 257
    cols, vals = [], []
    for j in range(width):
        dt = (np.int32, np.float32, np.int64)[j % 3]
        cols.append((rng.standard_normal(n) * 1e6).astype(dt))
        vals.append(rng.random(n) < 0.8 if j % 2 else None)
    tv = [None if v is None else torch.from_numpy(v) for v in vals]
    got = hash_cuda.partition_ids_fused(
        [torch.from_numpy(c) for c in cols], tv, 7)
    want = jhash.partition_ids(jhash.row_hash(
        [jnp.asarray(c) for c in cols],
        [None if v is None else jnp.asarray(v) for v in vals]), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the chain the card runs: a group's hash continues the groups before
    h = torch.zeros(n, dtype=torch.int64)
    step = hash_cuda.MAX_KEY_COLS
    for g in range(0, width, step):
        group = [torch.from_numpy(c) for c in cols[g:g + step]]
        part = thash.row_hash(group, tv[g:g + step])
        h = (h * pow(31, len(group), 1 << 32) + part) & 0xFFFFFFFF
    np.testing.assert_array_equal(thash.partition_ids(h, 7).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_hash64_string_key_makes_a_17_column_set_op(dctx, jax_trace_shim,
                                                    world):
    """15 numeric columns + one string column hashed into two lanes = 17
    key columns for ``dist_union``; equal to the JAX package's."""
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    tctx = pt.CylonContext(device="cpu", world=world)
    rng = np.random.default_rng(11)
    df = _columns(rng, 70, 15).to_pandas()
    df["name"] = rng.choice(np.array(["ann", "bob", "cyd"], object), 70)
    outs = []
    for mod, D, union, ctx in ((tstr, TDTable, tdist_union, tctx),
                               (jstr, JDTable, jdist_union, jctx)):
        enc, store = mod.encode_frame(df, ["name"])
        assert enc.shape[1] == 17
        a = D.from_pandas(ctx, enc)
        b = D.from_pandas(ctx, enc.iloc[::2].reset_index(drop=True))
        out = union(a, b)
        outs.append((out, store.resolve_frame(out.to_table().to_pandas())))
    _same_placement(outs[0][0], outs[1][0])
    pd.testing.assert_frame_equal(outs[0][1], outs[1][1])
    assert len(outs[0][1]) == len(df.drop_duplicates())
