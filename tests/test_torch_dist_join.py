"""Distributed parity: the port's ``shuffle_table`` and ``dist_join``
(HASH and SORT) on its simulated world against the JAX package's on the 8
virtual CPU devices, on the same numpy inputs.  Every shard must hold the
same rows in the same order, so the row multisets and the shard placement
are equal; under SORT that placement follows from the sampled splitters.

The JAX distributed path reads ``jax.core.trace_state_clean``, which this
JAX version keeps under ``jax._src.core`` only; the ``jax_trace_shim``
fixture (``test_torch_common.py``) sets the attribute for one test and
restores it after.  Broadcast
joins are pinned off in both packages (``broadcast_threshold=0``): these
tests hold the shuffle path; ``test_torch_broadcast_join.py`` holds the
broadcast and dense FK paths."""

import numpy as np
import pyarrow as pa
import pytest

import cylon_tpu as ct
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import dist_join as jdist_join
from cylon_tpu.parallel import shuffle_table as jshuffle_table

import cylon_tpu_torch as pt
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_join as tdist_join
from cylon_tpu_torch.parallel import shuffle_table as tshuffle_table

from test_torch_common import jax_rows, jax_trace_shim, port_rows, schema  # noqa: F401

HOWS = ["inner", "left", "right", "full_outer"]
ALGS = ["hash", "sort"]


def _jctx(dctx, world):
    return dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})


def _pair(rng, n_l, n_r, null_frac=0.1, strings=False):
    kl = rng.integers(0, 40, n_l)
    kr = rng.integers(0, 40, n_r)
    lt = {"k": pa.array(kl, pa.int64(), mask=rng.random(n_l) < null_frac),
          "v": pa.array(rng.random(n_l).astype(np.float32))}
    rt = {"k": pa.array(kr, pa.int64(), mask=rng.random(n_r) < null_frac),
          "w": pa.array(rng.integers(-99, 99, n_r).astype(np.int32))}
    if strings:
        lt["s"] = pa.array([f"g{v % 4}" for v in kl])
        rt["s"] = pa.array([f"g{v % 3}" for v in kr])
    return pa.table(lt), pa.table(rt)


def _both_dtables(ctx, dctx, world, at):
    jt = JDTable.from_table(_jctx(dctx, world), ct.Table.from_arrow(ctx, at))
    tctx = pt.CylonContext(device="cpu", world=world)
    tt = TDTable.from_table(tctx, pt.Table.from_arrow(tctx, at))
    return jt, tt


def _same(got, want):
    assert schema(got) == schema(want)
    assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    # the same rows on the same shards (multiset), and in the same order
    assert port_rows(got) == jax_rows(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


@pytest.mark.parametrize("keys", [["k"], ["k", "v"]])
def test_shuffle_table_matches_jax(ctx, dctx, jax_trace_shim, keys):
    at, _ = _pair(np.random.default_rng(30), 300, 1)
    jt, tt = _both_dtables(ctx, dctx, 8, at)
    _same(tshuffle_table(tt, keys), jshuffle_table(jt, keys))


def _configs(how, alg, lkey=0, rkey=0):
    """The same join for both packages; broadcast pinned off in both (the
    broadcast path has tests of its own)."""
    return (ct.JoinConfig(ct.JoinType(how), ct.JoinAlgorithm(alg), lkey, rkey,
                          broadcast_threshold=0),
            pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm(alg), lkey, rkey,
                          broadcast_threshold=0))


def _join_both(jl, jr, tl, tr, how, alg, lkey=0, rkey=0):
    """(port result, JAX result); checks the port launched no kernel
    (CPU tensors take the plain version)."""
    jcfg, tcfg = _configs(how, alg, lkey, rkey)
    want = jdist_join(jl, jr, jcfg)
    before = hash_cuda.launches
    got = tdist_join(tl, tr, tcfg)
    assert hash_cuda.launches == before
    return got, want


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("how", HOWS)
def test_dist_join_hash_matches_jax(ctx, dctx, jax_trace_shim, world, how):
    lt, rt = _pair(np.random.default_rng(31), 260, 190)
    jl, tl = _both_dtables(ctx, dctx, world, lt)
    jr, tr = _both_dtables(ctx, dctx, world, rt)
    _same(*_join_both(jl, jr, tl, tr, how, "hash"))


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("how", HOWS)
def test_dist_join_sort_matches_jax(ctx, dctx, jax_trace_shim, world, how):
    lt, rt = _pair(np.random.default_rng(31), 260, 190)
    jl, tl = _both_dtables(ctx, dctx, world, lt)
    jr, tr = _both_dtables(ctx, dctx, world, rt)
    got, want = _join_both(jl, jr, tl, tr, how, "sort")
    _same(got, want)
    # range partitioning: every shard's keys precede the next shard's
    keys = [[r[0] for r in shard if r[0] is not None]
            for shard in port_rows(got, ordered=True)]
    flat = [k for shard in keys for k in shard]
    if how == "inner":
        assert flat == sorted(flat)


def _composite_string_keys(ctx, dctx, alg):
    lt, rt = _pair(np.random.default_rng(32), 150, 170, strings=True)
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    _same(*_join_both(jl, jr, tl, tr, "full_outer", alg, ("k", "s"),
                      ("k", "s")))


def test_dist_join_composite_string_keys_matches_jax(ctx, dctx,
                                                      jax_trace_shim):
    _composite_string_keys(ctx, dctx, "hash")


def test_dist_join_sort_composite_string_keys_matches_jax(ctx, dctx,
                                                           jax_trace_shim):
    """Only the primary key is sampled and range-partitioned; dictionary
    keys are partitioned on their codes after unification."""
    _composite_string_keys(ctx, dctx, "sort")


def _skewed_and_empty_side(ctx, dctx, alg):
    rng = np.random.default_rng(33)
    lt = pa.table({"k": pa.array(np.where(rng.random(200) < 0.8, 7,
                                          rng.integers(0, 50, 200)), pa.int64()),
                   "v": pa.array(np.arange(200, dtype=np.int32))})
    rt = pa.table({"k": pa.array(np.zeros(0, np.int64)),
                   "w": pa.array(np.zeros(0, np.float32))})
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    for how in ("left", "full_outer", "inner"):
        _same(*_join_both(jl, jr, tl, tr, how, alg))
        _same(*_join_both(jr, jl, tr, tl, how, alg))


def test_dist_join_skewed_and_empty_side(ctx, dctx, jax_trace_shim):
    """One hot key (most rows on one shard) joined with an empty side."""
    _skewed_and_empty_side(ctx, dctx, "hash")


def test_dist_join_sort_skewed_and_empty_side(ctx, dctx, jax_trace_shim):
    """The same under SORT: the hot key's rows all land on one shard, and
    the empty side contributes no samples."""
    _skewed_and_empty_side(ctx, dctx, "sort")


@pytest.mark.parametrize("how", HOWS)
def test_dist_join_sort_nan_splitters_match_jax(ctx, dctx, jax_trace_shim,
                                                how):
    """A float64 key with ~40% NaN at 8 × 640 rows: the pooled samples hold
    NaN at the top, so the JAX splitters contain NaN, and the port must
    place rows as ``jnp.searchsorted`` does (NaN above every number)."""
    from cylon_tpu.parallel.dist_ops import _sample_splitters

    rng = np.random.default_rng(34)
    n = 8 * 640

    def side(m):
        k = rng.integers(-20, 20, m).astype(np.float64)
        k[rng.random(m) < 0.4] = np.nan
        k[rng.random(m) < 0.05] = -0.0
        return pa.table({"k": pa.array(k, pa.float64(),
                                       mask=rng.random(m) < 0.05),
                         "v": pa.array(np.arange(m, dtype=np.int32))})
    lt, rt = side(n), side(n - 37)
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    sp = np.asarray(_sample_splitters([(jl, 0), (jr, 0)], ascending=True))
    assert np.isnan(sp).any()
    _same(*_join_both(jl, jr, tl, tr, how, "sort"))


@pytest.mark.parametrize("alg", ALGS)
def test_dist_join_uint64_key_matches_jax(ctx, dctx, jax_trace_shim, alg):
    """uint64 keys on both sides of 2^63 (torch has no uint64 sort or
    searchsorted on the CPU: the port maps them to an ordered int64)."""
    rng = np.random.default_rng(35)
    pool = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1, 77, 2**40],
                    np.uint64)

    def side(m):
        return pa.table({"k": pa.array(rng.choice(pool, m), pa.uint64(),
                                       mask=rng.random(m) < 0.1),
                         "v": pa.array(rng.random(m).astype(np.float32))})
    jl, tl = _both_dtables(ctx, dctx, 8, side(300))
    jr, tr = _both_dtables(ctx, dctx, 8, side(220))
    for how in ("inner", "full_outer"):
        _same(*_join_both(jl, jr, tl, tr, how, alg))


def test_dist_join_sort_algorithm_is_refused(ctx, dctx, jax_trace_shim):
    """SORT, the default algorithm, is no longer refused: a plain
    ``JoinConfig.InnerJoin(0, 0)`` runs and equals the JAX package's
    default-config join (both replicate the 150-row side)."""
    lt, rt = _pair(np.random.default_rng(36), 180, 150)
    jl, tl = _both_dtables(ctx, dctx, 8, lt)
    jr, tr = _both_dtables(ctx, dctx, 8, rt)
    assert pt.JoinConfig.InnerJoin(0, 0).algorithm == pt.JoinAlgorithm.SORT
    want = jdist_join(jl, jr, ct.JoinConfig.InnerJoin(0, 0))
    _same(tdist_join(tl, tr, pt.JoinConfig.InnerJoin(0, 0)), want)
