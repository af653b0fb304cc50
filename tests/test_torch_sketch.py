"""Sketch parity: the port's ``ops/sketch.py`` function by function, bit
for bit against the JAX package's ``cylon_tpu/ops/sketch.py`` on the same
seeded numpy inputs, and ``dist_groupby_sketch`` against the JAX
package's at world 1 and on the 8 virtual CPU devices (keys, estimates
and quantiles exact).  The sample priorities seed from the global row id
``shard·cap + row``, so both packages' inputs must have the same ``cap``;
each parity test asserts that first.  The port sizes the partial blocks
by the per-shard group count, not by the input capacity: at world 1 (no
shuffle) the output capacity therefore differs from the JAX package's,
while the rows do not.  Then the error-bound, small-group and op-parsing
cases of the JAX package's sketch tests, on the port alone."""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import sketch as jsk
from cylon_tpu.parallel import dist_ops as jdist_ops

import cylon_tpu_torch as pt
from cylon_tpu_torch.ops import sketch as tsk
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_ops as tdist_ops

from test_torch_common import (jax_rows, jax_trace_shim, port_rows,  # noqa: F401
                               schema)
from test_torch_dist_join import _both_dtables

N = 4099


def _j(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _u32(x: np.ndarray) -> np.ndarray:
    """uint32 values (any integer array) as int64, the port's carrier."""
    return np.asarray(x).astype(np.uint32).astype(np.int64)


@pytest.fixture(scope="module")
def rows():
    """Sorted group slots with padding, per-row value bits, global ids
    and validity: the inputs of the build functions."""
    rng = np.random.default_rng(11)
    out_cap = 37
    slot = np.sort(rng.integers(0, out_cap, N)).astype(np.int32)
    slot[-200:] = out_cap                      # padding rows, dropped
    bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    bits[:7] = [0, 1, 0xFF, 0x100, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000]
    gidx = (np.arange(N) + 3 * 4096).astype(np.uint32)
    vmask = rng.random(N) < 0.9
    vals = (rng.standard_normal(N) * 100).astype(np.float32)
    vals[:3] = [np.nan, -0.0, np.inf]
    return out_cap, slot, bits, gidx, vmask, vals


def test_mix32_is_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = _j(jsk.mix32(jnp.asarray(x)))
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(tsk.mix32(_t(_u32(x))).numpy(), _u32(want))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64, np.int8, np.uint32, np.bool_])
def test_value_bits32_is_bit_exact(dtype):
    rng = np.random.default_rng(2)
    if np.issubdtype(dtype, np.floating):
        x = (rng.standard_normal(5000) * 1e3).astype(dtype)
        x[:5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
    elif dtype == np.bool_:
        x = rng.random(5000) < 0.5
    else:
        x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, 5000,
                         dtype=dtype, endpoint=True)
    want = _j(jsk.value_bits32(jnp.asarray(x)))
    np.testing.assert_array_equal(tsk.value_bits32(_t(x)).numpy(),
                                  _u32(want))


def test_hll_rank_is_bit_exact_including_zero_suffix():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    # w = h >> P = 0 saturates the rank at 32 − P + 1
    h[:8] = [0, 0xFF, 0x100, 0x1FF, 0x80000000, 0xFFFFFFFF, 0x200, 0x7FFF]
    want = _j(jsk._hll_rank(jnp.asarray(h)))
    got = tsk._hll_rank(_t(_u32(h))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == 32 - tsk.HLL_P + 1


def test_sorted_slots_and_rank_within_slot(rows):
    out_cap, slot, _, _, vmask, _ = rows
    is_first = np.concatenate([[True], slot[1:] != slot[:-1]])
    rv = slot < out_cap
    ws, wk = jsk.sorted_slots(jnp.asarray(is_first), jnp.asarray(rv),
                              out_cap)
    gs, gk = tsk.sorted_slots(_t(is_first), _t(rv), out_cap)
    np.testing.assert_array_equal(gs.numpy(), _j(ws))
    np.testing.assert_array_equal(gk.numpy(), _j(wk))
    np.testing.assert_array_equal(
        tsk._rank_within_slot(_t(slot.astype(np.int64))).numpy(),
        _j(jsk._rank_within_slot(jnp.asarray(slot))))


def test_hll_build_merge_estimate_are_bit_exact(rows):
    out_cap, slot, bits, _, vmask, _ = rows
    want = _j(jsk.hll_build(jnp.asarray(slot), out_cap, jnp.asarray(bits),
                            jnp.asarray(vmask)))
    got = tsk.hll_build(_t(slot), out_cap, _t(_u32(bits)), _t(vmask))
    assert got.dtype == torch.int32 and got.shape == (out_cap, tsk.HLL_M)
    np.testing.assert_array_equal(got.numpy(), want)
    # merge: each register row is one partial sketch
    rng = np.random.default_rng(4)
    m = 300
    # registers of a realistic cardinality: rank r with probability 2^-r
    regs = np.minimum(rng.geometric(0.5, (m, tsk.HLL_M)), 25)
    regs[rng.random((m, tsk.HLL_M)) < 0.3] = 0
    regs = regs.astype(np.int32)
    mslot = np.sort(rng.integers(0, 20, m)).astype(np.int32)
    mvalid = rng.random(m) < 0.85
    want_m = _j(jsk.hll_merge_rows(jnp.asarray(mslot), 20,
                                   jnp.asarray(regs), jnp.asarray(mvalid)))
    got_m = tsk.hll_merge_rows(_t(mslot), 20, _t(regs), _t(mvalid)).numpy()
    np.testing.assert_array_equal(got_m, want_m)
    for r in (want, want_m):
        np.testing.assert_array_equal(
            tsk.hll_estimate(_t(r)).numpy(),
            _j(jsk.hll_estimate(jnp.asarray(r))))


def test_hll_estimate_of_saturated_registers_within_two_ulps():
    """Registers uniform over 0..25 (a cardinality near 2^32 per group):
    XLA's float32 ``exp2`` is inexact from 2^-13 down and its row-sum
    order is its own, so its ``z`` can differ from the port's exactly
    rounded sum by an ulp, and the raw estimate (about 1e9, not an
    integer in float32) by that and its own rounding: two float32 ulps."""
    rng = np.random.default_rng(6)
    regs = rng.integers(0, 26, (500, tsk.HLL_M)).astype(np.int32)
    got = tsk.hll_estimate(_t(regs)).numpy().astype(np.float64)
    want = _j(jsk.hll_estimate(jnp.asarray(regs))).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=2 * 2.0**-23, atol=0)


def test_hll_estimate_is_exact_over_register_mixes():
    """Every zero-register count 0..256 (the small-range branch) and
    geometric register mixes (the raw branch): the estimates equal the JAX
    package's exactly."""
    rng = np.random.default_rng(5)
    out = []
    for v in range(257):
        r = rng.integers(1, 6, tsk.HLL_M)
        r[:v] = 0
        out.append(rng.permutation(r))
    for _ in range(3000):
        r = np.minimum(rng.geometric(0.5, tsk.HLL_M), 25)
        r[rng.random(tsk.HLL_M) < rng.random() * 0.5] = 0
        out.append(r)
    regs = np.array(out, np.int32)
    np.testing.assert_array_equal(tsk.hll_estimate(_t(regs)).numpy(),
                                  _j(jsk.hll_estimate(jnp.asarray(regs))))


def test_bottomk_build_merge_quantile_are_bit_exact(rows):
    out_cap, slot, bits, gidx, vmask, vals = rows
    wv, wp = jsk.bottomk_build(jnp.asarray(slot), out_cap, jnp.asarray(vals),
                               jnp.asarray(bits), jnp.asarray(gidx),
                               jnp.asarray(vmask))
    gv, gp = tsk.bottomk_build(_t(slot), out_cap, _t(vals), _t(_u32(bits)),
                               _t(_u32(gidx)), _t(vmask))
    assert gp.dtype == torch.uint32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                  _j(wv).view(np.int32))
    np.testing.assert_array_equal(gp.numpy(), _j(wp))
    # merge the per-group lanes as rows of a partial table, twice each
    # (a re-delivered partial merges idempotently)
    mslot = np.repeat(np.arange(out_cap, dtype=np.int32) // 3, 2)
    mvalid = np.ones(2 * out_cap, bool)
    mvalid[-2:] = False
    mv, mp = np.repeat(_j(wv), 2, axis=0), np.repeat(_j(wp), 2, axis=0)
    cap2 = out_cap // 3 + 1
    wmv, wmp = jsk.bottomk_merge_rows(jnp.asarray(mslot), cap2,
                                      jnp.asarray(mv), jnp.asarray(mp),
                                      jnp.asarray(mvalid))
    gmv, gmp = tsk.bottomk_merge_rows(_t(mslot), cap2, _t(mv), _t(mp),
                                      _t(mvalid))
    np.testing.assert_array_equal(gmv.numpy().view(np.int32),
                                  _j(wmv).view(np.int32))
    np.testing.assert_array_equal(gmp.numpy(), _j(wmp))
    for q in (0.0, 0.1, 0.5, 0.95, 1.0):
        we, wn = jsk.bottomk_quantile(wmv, wmp, q)
        ge, gn = tsk.bottomk_quantile(gmv, gmp, q)
        np.testing.assert_array_equal(ge.numpy().view(np.int32),
                                      _j(we).view(np.int32))
        np.testing.assert_array_equal(gn.numpy(), _j(wn))


def _sketch_table(rng, n):
    return pa.table({
        "g": pa.array(rng.integers(0, 7, n)),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 3, n)]),
        "ids": pa.array(rng.integers(0, 900, n), mask=rng.random(n) < 0.05),
        "x": pa.array(rng.standard_normal(n) * 50.0,
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.random(n).astype(np.float32)),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
    })


SKETCH_AGGS = [("ids", "approx_distinct"), ("x", "approx_quantile:0.5"),
               ("f", "approx_distinct"), ("i", "approx_quantile:0.95"),
               ("x", "approx_distinct"), ("f", "approx_quantile")]


def _same_sketch(got, want, world):
    assert schema(got) == schema(want)
    if world > 1:
        # past the shuffle both capacities come from the same counts
        assert got.cap == want.cap
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("keys", [["g"], ["s", "g"], ["ids"]])
def test_dist_groupby_sketch_matches_jax(ctx, dctx, jax_trace_shim, world,
                                         keys):
    jt, tt = _both_dtables(ctx, dctx, world, _sketch_table(
        np.random.default_rng(12), 3000))
    assert tt.cap == jt.cap  # the priorities seed from shard·cap + row
    want = jdist_ops.dist_groupby_sketch(jt, keys, SKETCH_AGGS)
    got = tdist_ops.dist_groupby_sketch(tt, keys, SKETCH_AGGS)
    _same_sketch(got, want, world)


@pytest.mark.parametrize("world", [1, 8])
def test_dist_groupby_sketch_where_matches_jax(ctx, dctx, jax_trace_shim,
                                               world):
    jt, tt = _both_dtables(ctx, dctx, world, _sketch_table(
        np.random.default_rng(13), 2000))
    assert tt.cap == jt.cap
    aggs = SKETCH_AGGS[:2]

    def where(env):
        return env["i"] > -10

    want = jdist_ops.dist_groupby_sketch(jt, ["s"], aggs, where=where)
    got = tdist_ops.dist_groupby_sketch(tt, ["s"], aggs, where=where)
    _same_sketch(got, want, world)


def test_partial_blocks_sized_by_groups_not_rows(ctx, dctx, jax_trace_shim):
    """The per-shard partial block holds the next size class of the
    largest per-shard group count (7 groups → 8 rows), not the input
    capacity; the global row ids still use the input capacity."""
    tctx = pt.CylonContext(device="cpu", world=4)
    df = pd.DataFrame({"g": np.arange(4000) % 7,
                       "v": np.arange(4000, dtype=np.float64)})
    tt = TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df))
    part = tdist_ops._sketch_partial_table(
        tt, [0], [1, 1], ("distinct", "quantile"), None, 0, tt.cap)
    assert tt.cap == 1024 and part.cap == 8
    assert tuple(part.column("__hll0").data.shape) == (4 * 8, tsk.HLL_M)
    assert tuple(part.column("__bkp1").data.shape) == (4 * 8,
                                                        tsk.QUANTILE_K)


# -- the JAX package's own sketch cases, on the port ---------------------------

@pytest.fixture(scope="module")
def groups_df():
    rng = np.random.default_rng(41)
    n = 40000
    return pd.DataFrame({"g": rng.integers(0, 6, n),
                         "ids": rng.integers(0, 4000, n),
                         "x": rng.standard_normal(n) * 50.0})


def _frame(dt):
    return dt.to_table().to_pandas()


def _port(df, world=8):
    tctx = pt.CylonContext(device="cpu", world=world)
    return TDTable.from_table(tctx, pt.Table.from_pandas(tctx, df))


def test_sketch_op_parsing():
    assert tdist_ops._parse_sketch_op("approx_distinct") == ("distinct", None)
    assert tdist_ops._parse_sketch_op("approx_quantile") == ("quantile", 0.5)
    assert tdist_ops._parse_sketch_op("approx_quantile:0.9") == (
        "quantile", 0.9)
    for bad in ("approx_quantile:2.0", "approx_quantile:x", "median"):
        with pytest.raises(pt.CylonError):
            tdist_ops._parse_sketch_op(bad)
    assert tdist_ops.sketch_output_name("v", "approx_distinct") \
        == "approx_distinct_v"
    assert tdist_ops.sketch_output_name("v", "approx_quantile:0.9") \
        == "p90_v"


def test_distinct_within_advertised_bound(groups_df):
    out = _frame(tdist_ops.dist_groupby_sketch(
        _port(groups_df), ["g"], [("ids", "approx_distinct")]))
    exact = groups_df.groupby("g")["ids"].nunique()
    assert len(out) == len(exact)
    for _, r in out.iterrows():
        e = exact[r["g"]]
        rel = abs(int(r["approx_distinct_ids"]) - e) / e
        assert rel <= tsk.HLL_ERROR_BOUND, (r["g"], rel)


def test_quantile_within_advertised_rank_bound(groups_df):
    out = _frame(tdist_ops.dist_groupby_sketch(
        _port(groups_df), ["g"],
        [("x", "approx_quantile:0.5"), ("x", "approx_quantile:0.95")]))
    assert len(out) == 6
    for _, r in out.iterrows():
        vals = np.sort(groups_df[groups_df["g"] == r["g"]]["x"].to_numpy())
        for col, q in (("p50_x", 0.5), ("p95_x", 0.95)):
            rank = np.searchsorted(vals, r[col]) / len(vals)
            assert abs(rank - q) <= tsk.QUANTILE_RANK_ERROR_BOUND, (col, rank)


@pytest.mark.parametrize("world", [1, 8])
def test_small_group_quantile_is_exact(world):
    """A group with <= K rows keeps every row in its sample: the estimate
    is the exact empirical quantile."""
    df = pd.DataFrame({"g": np.zeros(100, np.int64), "x": np.arange(100.0)})
    out = _frame(tdist_ops.dist_groupby_sketch(
        _port(df, world), ["g"], [("x", "approx_quantile:0.5")]))
    assert float(out["p50_x"].iloc[0]) == 50.0


def test_all_null_group_quantile_is_null_and_distinct_zero():
    df = pd.DataFrame({"g": np.array([0, 0, 1, 1, 1], np.int64),
                       "x": [np.nan, np.nan, 1.0, 2.0, 3.0]})
    t = pt.Table.from_pandas(pt.CylonContext(device="cpu"), df)
    tctx = pt.CylonContext(device="cpu", world=2)
    out = tdist_ops.dist_groupby_sketch(
        TDTable.from_table(tctx, t), ["g"],
        [("x", "approx_quantile:0.5"), ("x", "approx_distinct")])
    rows = sorted(r for s in port_rows(out, ordered=True) for r in s)
    assert rows == [(0, None, 0), (1, 2.0, 3)]
