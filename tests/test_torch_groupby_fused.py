"""Fused groupby parity: the port's ``dist_groupby_fused`` in its three
modes (``psum``: the combine inside one ``all_reduce`` over the dense
slot space of dictionary keys; ``pre-aggregate``: local partials, a hash
shuffle of the partial table and the combine; ``shuffle``: raw rows move
once) against the JAX package's at world 1 and on the 8 virtual CPU
devices, on the same numpy inputs, over integer, dictionary-string,
nullable dictionary and composite nullable dictionary keys.  Every shard
must hold the same groups in the same order with the same ``cap`` and
``counts``: keys, counts, integer sums and validity exactly, float64
results within 1e-12 relative, float32 sums within 1e-6.  The port must
take the same mode (``dist_ops.decisions``) and call the partition kernel's
wrapper exactly where a hash shuffle runs: never in the ``psum`` mode."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from cylon_tpu.parallel import dist_ops as jdist_ops
from cylon_tpu.parallel import dist_select as jdist_select

import cylon_tpu_torch as pt
from cylon_tpu_torch.parallel import dist_ops as tdist_ops
from cylon_tpu_torch.parallel import dist_select as tdist_select

from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_dist_groupby import _same_close, pid_calls  # noqa: F401
from test_torch_dist_join import _both_dtables

SUMS = [("v", "sum"), ("v", "mean"), ("v", "count"), ("w", "sum"),
        ("w", "mean"), ("f", "sum"), ("f", "mean"), ("w", "count")]
ALL = SUMS + [("w", "min"), ("w", "max"), ("v", "min"), ("f", "max")]
KEYS = {"int": ["k"], "dict": ["s"], "dict_null": ["sn"],
        "composite": ["sn", "t"]}


def _table(rng, n, wide=False):
    """``k`` int64 in [0, 40) with 10% nulls; ``s`` a dictionary string of
    5 values; ``sn`` one of 4 values with 15% nulls; ``t`` one of 3 (70
    each with ``wide``, so ``sn × t`` exceeds the psum slot cap); ``v``
    float64 with nulls; ``w`` int32; ``f`` float32."""
    nt = 70 if wide else 3
    ns = 70 if wide else 4
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 5, n)]),
        "sn": pa.array([f"n{v}" for v in rng.integers(0, ns, n)],
                       mask=rng.random(n) < 0.15),
        "t": pa.array([f"t{v:02d}" for v in rng.integers(0, nt, n)]),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-99, 99, n).astype(np.int32)),
        "f": pa.array(rng.random(n).astype(np.float32)),
    })


def _run(jt, tt, keys, aggs, **kw):
    tdist_ops.decisions.clear()
    want = jdist_ops.dist_groupby_fused(jt, keys, aggs, **kw)
    got = tdist_ops.dist_groupby_fused(tt, keys, aggs, **kw)
    return got, want, dict(tdist_ops.decisions)


# every mode × key flavour at world 8; at world 1 every mode runs the
# local groupby, so one case per flavour (and psum's local fallback)
CASES = ([(8, "psum", flavour, "sums") for flavour in KEYS]
         + [(8, mode, flavour, "all") for mode in ("pre-aggregate", "shuffle")
            for flavour in KEYS]
         + [(1, "pre-aggregate", flavour, "all") for flavour in KEYS]
         + [(1, "psum", "composite", "sums")])


@pytest.mark.parametrize("world,mode,flavour,aggs", CASES)
def test_fused_groupby_matches_jax(ctx, dctx, jax_trace_shim, pid_calls,
                                   world, mode, flavour, aggs):
    jt, tt = _both_dtables(ctx, dctx, world,
                           _table(np.random.default_rng(90), 1500))
    got, want, taken = _run(jt, tt, KEYS[flavour],
                            SUMS if aggs == "sums" else ALL, mode=mode)
    _same_close(got, want)
    if world == 1:
        ran = "local"
    elif mode == "psum":
        # an integer key has no dictionary: the psum re-check degrades
        ran = "pre-aggregate" if flavour == "int" else "psum"
    else:
        ran = mode
    assert taken == {f"groupby.{ran}": 1}
    assert len(pid_calls) == (0 if ran in ("local", "psum") else 1)


def _where(env):
    return env["w"] > -40


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("mode", ["psum", "pre-aggregate"])
def test_fused_where_and_deferred_select_match_jax(ctx, dctx, jax_trace_shim,
                                                   world, mode):
    jt, tt = _both_dtables(ctx, dctx, world,
                           _table(np.random.default_rng(91), 1200))
    got, want, _ = _run(jt, tt, ["sn", "s"], SUMS, mode=mode, where=_where)
    _same_close(got, want)
    # a deferred select's pending mask folds in like ``where``
    jd = jdist_select(jt, _where, compact=False)
    td = tdist_select(tt, _where, compact=False)
    got, want, _ = _run(jd, td, ["s"], SUMS, mode=mode)
    _same_close(got, want)


@pytest.mark.parametrize("case", ["min_max", "int_key", "wide_domain"])
def test_psum_degrades_to_pre_aggregate(ctx, dctx, jax_trace_shim, pid_calls,
                                        case):
    """Min/max (no sum all-reduce), a key without a dictionary, and a
    composite domain over ``_PSUM_SLOT_CAP`` take the partial exchange."""
    jt, tt = _both_dtables(ctx, dctx, 8, _table(
        np.random.default_rng(92), 2000, wide=case == "wide_domain"))
    keys, aggs = {"min_max": (["s"], ALL), "int_key": (["k"], SUMS),
                  "wide_domain": (["sn", "t"], SUMS)}[case]
    if case == "wide_domain":
        assert (len(tt.column("sn").dictionary) + 1) \
            * len(tt.column("t").dictionary) > tdist_ops._PSUM_SLOT_CAP
    got, want, taken = _run(jt, tt, keys, aggs, mode="psum")
    _same_close(got, want)
    assert taken == {"groupby.pre-aggregate": 1}
    assert len(pid_calls) == 1


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("mode", ["psum", "pre-aggregate"])
def test_fused_emit_empty_matches_jax(ctx, dctx, jax_trace_shim, world, mode):
    """``emit_empty`` with a dense key range wider than the keys seen:
    every key of the range emits (psum defers to the partial exchange)."""
    jt, tt = _both_dtables(ctx, dctx, world,
                           _table(np.random.default_rng(93), 900))
    got, want, _ = _run(jt, tt, ["k"], ALL, mode=mode,
                        dense_key_range=(0, 49), emit_empty=True)
    _same_close(got, want)
    assert got.num_rows == 51  # 50 keys and the null-key group


def test_fused_rejects_unknown_mode_and_op():
    tctx = pt.CylonContext(device="cpu", world=2)
    tt = pt.parallel.DTable.from_table(tctx, pt.Table.from_arrow(
        tctx, _table(np.random.default_rng(94), 50)))
    with pytest.raises(pt.CylonError):
        tdist_ops.dist_groupby_fused(tt, ["s"], SUMS, mode="tree")
    with pytest.raises(pt.CylonError):
        tdist_ops.dist_groupby_fused(tt, ["s"], [("v", "median")])


def test_combine_leaf_spec_matches_jax(ctx, dctx, jax_trace_shim):
    jt, tt = _both_dtables(ctx, dctx, 8,
                           _table(np.random.default_rng(95), 600))
    partial = [(4, "sum"), (4, "count"), (5, "min"), (6, "max")]
    jp = jdist_ops.dist_groupby(jt, [2, 0], partial, pre_aggregate=False,
                                _local_only=True)
    tp = tdist_ops.dist_groupby(tt, [2, 0], partial, pre_aggregate=False,
                                _local_only=True)
    ops = [op for _, op in partial]
    assert tdist_ops._combine_leaf_spec(tp, 2, ops) \
        == jdist_ops._combine_leaf_spec(jp, 2, ops)


def test_all_reduce_sums_over_ranks():
    comm = pt.CylonContext(device="cpu", world=3).comm
    x = torch.arange(3 * 4 * 2, dtype=torch.int64).view(3, 4, 2)
    assert torch.equal(comm.all_reduce(x), x[0] + x[1] + x[2])
    with pytest.raises(pt.CylonError):
        comm.all_reduce(torch.zeros(2, 4))
