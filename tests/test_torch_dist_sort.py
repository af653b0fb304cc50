"""Distributed sort parity: the port's ``dist_sort`` / ``dist_sort_multi``
/ ``dist_head``, ``DTable.head`` / ``partition`` and the sample-sort
splitters against the JAX package's, on the same numpy inputs, at world 1
and on the 8 virtual CPU devices.  Shards must hold the same rows in the
same order, with the same ``cap`` and ``counts``; the splitters must be
equal (NaN equal to NaN)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from cylon_tpu.parallel import dist_head as jdist_head
from cylon_tpu.parallel import dist_sort as jdist_sort
from cylon_tpu.parallel import dist_sort_multi as jdist_sort_multi
from cylon_tpu.parallel.dist_ops import _sample_splitters as j_splitters

from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import dist_head as tdist_head
from cylon_tpu_torch.parallel import dist_sort as tdist_sort
from cylon_tpu_torch.parallel import dist_sort_multi as tdist_sort_multi
from cylon_tpu_torch.parallel.dist_ops import _sample_splitters as t_splitters

from test_torch_common import jax_rows, jax_trace_shim, port_rows, schema  # noqa: F401
from test_torch_dist_join import _both_dtables, _same


def _table(rng, n, kind):
    """``skew``: int64 key, 60% of rows on one value, nulls; ``nan``:
    float64 key with ~40% NaN, −0.0 and nulls; plus a float payload, a
    dictionary string and a row id."""
    if kind == "skew":
        k = np.where(rng.random(n) < 0.6, 3, rng.integers(-50, 50, n))
        key = pa.array(k, pa.int64(), mask=rng.random(n) < 0.1)
    else:
        k = rng.integers(-30, 30, n).astype(np.float64)
        k[rng.random(n) < 0.4] = np.nan
        k[rng.random(n) < 0.05] = -0.0
        key = pa.array(k, pa.float64(), mask=rng.random(n) < 0.05)
    return pa.table({
        "k": key,
        "f": pa.array(rng.choice(np.array([np.nan, 1.0, -1.0, 2.5]), n)),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 7, n)]),
        "id": pa.array(np.arange(n, dtype=np.int32)),
    })


def _sizes(kind):
    # the NaN case needs enough rows per shard that the pooled samples
    # reach the NaN tail (the sampling rule under-covers small shards)
    return 8 * 640 if kind == "nan" else 700


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("kind", ["skew", "nan"])
@pytest.mark.parametrize("ascending", [True, False])
def test_dist_sort_matches_jax(ctx, dctx, jax_trace_shim, world, kind,
                               ascending):
    at = _table(np.random.default_rng(70), _sizes(kind), kind)
    jt, tt = _both_dtables(ctx, dctx, world, at)
    want = jdist_sort(jt, "k", ascending)
    before = hash_cuda.launches
    got = tdist_sort(tt, "k", ascending)
    assert hash_cuda.launches == before  # range partitioning: no hash
    _same(got, want)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("columns,ascending", [
    (["k", "f"], [True, False]), (["s", "k", "id"], [False, True, False]),
    (["k", "s"], True)])
def test_dist_sort_multi_matches_jax(ctx, dctx, jax_trace_shim, world,
                                     columns, ascending):
    at = _table(np.random.default_rng(71), 650, "skew")
    jt, tt = _both_dtables(ctx, dctx, world, at)
    _same(tdist_sort_multi(tt, columns, ascending),
          jdist_sort_multi(jt, columns, ascending))


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("n", [0, 5, 300, 10_000])
def test_dist_head_matches_jax(ctx, dctx, jax_trace_shim, world, n):
    """``n`` inside shard 0, across shards, and past the row count."""
    at = _table(np.random.default_rng(72), 700, "skew")
    jt, tt = _both_dtables(ctx, dctx, world, at)
    want = jdist_head(jdist_sort(jt, "k"), n)
    got = tdist_head(tdist_sort(tt, "k"), n)
    assert schema(got) == schema(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


def test_dtable_partition_matches_jax(ctx, dctx, jax_trace_shim):
    at = _table(np.random.default_rng(73), 500, "skew")
    jt, tt = _both_dtables(ctx, dctx, 8, at)
    jt, tt = jdist_sort(jt, "k"), tdist_sort(tt, "k")
    for i in range(8):
        assert (port_rows(tt.partition(i), ordered=True)
                == jax_rows(jt.partition(i), ordered=True))


@pytest.mark.parametrize("kind", ["skew", "nan"])
@pytest.mark.parametrize("ascending", [True, False])
def test_sample_splitters_match_jax(ctx, dctx, jax_trace_shim, kind,
                                    ascending):
    """One side and two sides (a join's pool), on uneven shards."""
    rng = np.random.default_rng(74)
    a = _table(rng, _sizes(kind), kind)
    b = _table(rng, _sizes(kind) // 3, kind)
    ja, ta = _both_dtables(ctx, dctx, 8, a)
    jb, tb = _both_dtables(ctx, dctx, 8, b)
    for jsides, tsides in (([(ja, 0)], [(ta, 0)]),
                           ([(ja, 0), (jb, 0)], [(ta, 0), (tb, 0)])):
        want = np.asarray(j_splitters(jsides, ascending))
        got = t_splitters(tsides, ascending).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if kind == "nan":
            assert np.isnan(want).any()


def test_sample_splitters_without_valid_samples(ctx, dctx, jax_trace_shim):
    """All keys null: the splitters are the dtype's extreme value."""
    at = pa.table({"k": pa.array([None] * 40, pa.int32()),
                   "v": pa.array(np.arange(40, dtype=np.int32))})
    jt, tt = _both_dtables(ctx, dctx, 8, at)
    for ascending in (True, False):
        want = np.asarray(j_splitters([(jt, 0)], ascending))
        np.testing.assert_array_equal(
            t_splitters([(tt, 0)], ascending).numpy(), want)
    _same(tdist_sort(tt, "k"), jdist_sort(jt, "k"))


def test_descending_nan_rows_go_to_shard_0(ctx, dctx, jax_trace_shim):
    """The reference's descending range partition counts splitters > x,
    which is 0 for NaN: NaN rows land on shard 0 while every shard sorts
    NaN last.  The port keeps that placement."""
    at = _table(np.random.default_rng(75), 8 * 640, "nan")
    jt, tt = _both_dtables(ctx, dctx, 8, at)
    want = jdist_sort(jt, "k", ascending=False)
    got = tdist_sort(tt, "k", ascending=False)
    _same(got, want)
    shards = port_rows(got, ordered=True)
    nan_shards = {s for s, rows in enumerate(shards)
                  for r in rows if r[0] == "NaN"}
    assert nan_shards == {0}
    k0 = [r[0] for r in shards[0] if r[0] is not None]
    assert k0[-1] == "NaN" and k0[0] != "NaN"


def test_searchsorted_nan_order_differs_between_libraries():
    """Why the port maps float keys to a total-order integer before
    ``torch.searchsorted``: with NaN among the splitters the two
    libraries disagree, and the port must follow ``jnp.searchsorted``."""
    import jax.numpy as jnp

    from cylon_tpu_torch.parallel.dist_ops import _total_order

    sp = np.array([0.0, np.nan, np.nan])
    x = np.array([np.nan, -0.0, 1.0, -1.0, np.inf])
    want = np.asarray(jnp.searchsorted(jnp.asarray(sp), jnp.asarray(x),
                                       side="right"))
    assert want.tolist() == [3, 1, 1, 0, 1]
    raw = torch.searchsorted(torch.from_numpy(sp), torch.from_numpy(x),
                             right=True)
    assert raw.tolist() != want.tolist()
    got = torch.searchsorted(_total_order(torch.from_numpy(sp)),
                             _total_order(torch.from_numpy(x)), right=True)
    assert got.tolist() == want.tolist()
