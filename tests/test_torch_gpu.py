"""The PyTorch port on the card: the CUDA partition-hash kernel against its
plain version, and the distributed join (HASH and SORT, broadcast and
dense FK), semi / anti joins, sort, set ops, groupby (every path), select,
scalar aggregate and the TPC-H generator on CUDA tensors against the same
calls on the CPU, every TPC-H query through the planner against its eager
run on the card, the kernel wrapper's meta arm, and the abstract plan
check and ``run_pipeline`` on two TPC-H queries, the mesh probe through
``LocalCommunicator`` and NCCL, the join under the measured ranking, and
sanitizer mode (the sync guard, the NaN trap, the join under sanitize),
the one-command gate (``analysis/ci.py`` at its defaults, the
``benchdiff`` CLI), and the Java launcher spawned with the Java binding's
argv.
Every test here needs a CUDA device (``gpu`` marker) and skips itself
without one.  This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import cylon_tpu_torch as pt
from cylon_tpu_torch.ops import hash as plain_hash
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch import compute
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.parallel import (DTable, dist_aggregate,
                                      dist_anti_join, dist_groupby,
                                      dist_intersect, dist_join, dist_select,
                                      dist_semi_join, dist_sort,
                                      dist_subtract, dist_union)
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import trace
from cylon_tpu_torch.tpch import datagen_device
from cylon_tpu_torch.tpch import queries as tpch_queries

from test_torch_common import assert_rows_close, float_rtols, port_rows

DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
          torch.uint16, torch.uint32, torch.uint64, torch.bool,
          torch.float16, torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _column(rng, dtype, n):
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.standard_normal(n) * 1e3).to(dtype)
        x[:5] = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), 1e-40])
        return x
    return torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                                         endpoint=True)).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_matches_plain_on_card(card, dtype):
    """Bit for bit, with a nullable second column, nparts 1/7/16, on an
    odd row count."""
    rng = np.random.default_rng(40)
    n = (1 << 20) + 17
    k1 = _column(rng, dtype, n).to(card)
    k2 = torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(card)
    v2 = torch.from_numpy(rng.random(n) < 0.8).to(card)
    for nparts in (1, 7, 16):
        want = plain_hash.partition_ids(plain_hash.row_hash((k1, k2), (None, v2)),
                                        nparts)
        before = hash_cuda.launches
        got = hash_cuda.partition_ids_fused((k1, k2), (None, v2), nparts)
        torch.cuda.synchronize()
        assert hash_cuda.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_rejects_non_contiguous(card):
    x = torch.zeros(16, dtype=torch.int32, device=card)[::2]
    with pytest.raises(pt.CylonError):
        hash_cuda.partition_ids_fused((x,), (None,), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "full_outer"])
def test_dist_join_on_card_matches_cpu(card, how):
    """World 4 on the card (kernel partitioning) vs world 4 on the CPU
    (plain partitioning): the same rows on the same shards, in order."""
    rng = np.random.default_rng(41)
    data_l = {"k": rng.integers(0, 500, 3000).astype(np.int64),
              "v": rng.random(3000).astype(np.float32)}
    data_r = {"k": rng.integers(0, 500, 2000).astype(np.int64),
              "w": rng.integers(-9, 9, 2000).astype(np.int32)}
    # broadcast pinned off: the 2,000-row side would be replicated
    cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm.HASH, 0, 0,
                        broadcast_threshold=0)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
        rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
        before = hash_cuda.launches
        outs.append(dist_join(lt, rt, cfg))
        assert hash_cuda.launches - before == (2 if device == "cuda" else 0)
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


def _sides(rng):
    data_l = {"k": rng.integers(0, 500, 3000).astype(np.int64),
              "v": rng.random(3000).astype(np.float32)}
    data_r = {"k": rng.integers(0, 500, 2000).astype(np.int64),
              "w": rng.integers(-9, 9, 2000).astype(np.int32)}
    return data_l, data_r


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "full_outer"])
def test_dist_join_sort_on_card_matches_cpu(card, how):
    """SORT (range partitioning, no kernel launch) at world 4: the same
    rows on the same shards, in order, on the card as on the CPU."""
    data_l, data_r = _sides(np.random.default_rng(42))
    cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm.SORT, 0, 0)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
        rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
        before = hash_cuda.launches
        outs.append(dist_join(lt, rt, cfg))
        assert hash_cuda.launches == before
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
@pytest.mark.parametrize("ascending", [True, False])
def test_dist_sort_on_card_matches_cpu(card, ascending):
    rng = np.random.default_rng(43)
    k = rng.standard_normal(5000)
    k[rng.random(5000) < 0.3] = np.nan
    data = {"k": k, "v": np.arange(5000, dtype=np.int32)}
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
        outs.append(dist_sort(t, "k", ascending))
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
@pytest.mark.parametrize("op", [dist_union, dist_intersect, dist_subtract])
def test_dist_set_op_on_card_matches_cpu(card, op):
    """World 4: the kernel partitions every column of both tables (two
    launches), and the result equals the CPU's shard for shard."""
    rng = np.random.default_rng(44)
    a = {"k": rng.integers(0, 50, 3000).astype(np.int64),
         "f": rng.integers(0, 4, 3000).astype(np.float32)}
    b = {"k": np.concatenate([a["k"][:1000], rng.integers(0, 80, 1500)]),
         "f": np.concatenate([a["f"][:1000],
                              rng.integers(0, 4, 1500).astype(np.float32)])}
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        ta = DTable.from_table(ctx, pt.Table.from_columns(ctx, a))
        tb = DTable.from_table(ctx, pt.Table.from_columns(ctx, b))
        before = hash_cuda.launches
        outs.append(op(ta, tb))
        assert hash_cuda.launches - before == (2 if device == "cuda" else 0)
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


def _groupby_data(rng, n=6000):
    v = rng.normal(size=n)
    v[rng.random(n) < 0.02] = np.nan
    return {"k": rng.integers(0, 800, n).astype(np.int64),
            "g": rng.integers(0, 3, n).astype(np.int32),
            "v": v, "w": rng.integers(-9, 9, n).astype(np.int32),
            "f": rng.random(n).astype(np.float32)}


GB_AGGS = [("v", "sum"), ("v", "mean"), ("w", "min"), ("v", "max"),
           ("w", "count"), ("w", "sum"), ("f", "sum")]

# mode → (keys, kwargs, broadcast threshold, kernel launches at world 4)
GB_MODES = {
    "broadcast_combine": (["g"], {}, None, 0),
    "shuffle_combine": (["k"], {}, 8, 1),
    "raw_shuffle": (["k", "g"], {"pre_aggregate": False}, None, 1),
    "dense": (["k"], {"dense_key_range": (0, 799)}, None, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(GB_MODES))
def test_dist_groupby_on_card_matches_cpu(card, mode):
    """World 4: the same groups, in the same order on the same shards, on
    the card as on the CPU; the kernel runs once on a shuffle and never on
    the broadcast combine or the dense path."""
    data = _groupby_data(np.random.default_rng(45))
    keys, kwargs, threshold, launches = GB_MODES[mode]
    prev = tconfig.set_broadcast_join_threshold(
        threshold or tconfig.DEFAULT_BROADCAST_JOIN_THRESHOLD)
    try:
        outs = []
        for device in ("cpu", "cuda"):
            ctx = pt.CylonContext(device=device, world=4)
            t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
            before = hash_cuda.launches
            outs.append(dist_groupby(t, keys, GB_AGGS, **kwargs))
            assert hash_cuda.launches - before == \
                (launches if device == "cuda" else 0)
    finally:
        tconfig.set_broadcast_join_threshold(prev)
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert list(gpu.counts_host()) == list(cpu.counts_host())
    assert_rows_close(port_rows(gpu, ordered=True),
                      port_rows(cpu, ordered=True), float_rtols(cpu))


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [None, (0, 99_999)])
def test_groupby_float_sums_deterministic_on_card(card, dense):
    """Two runs on the card give the same bits: no float atomics."""
    rng = np.random.default_rng(46)
    n = 1 << 20
    data = {"k": rng.integers(0, 100_000, n).astype(np.int64),
            "v": rng.normal(size=n) * 1e6,
            "f": rng.random(n).astype(np.float32)}
    ctx = pt.CylonContext(device="cuda", world=4)
    t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
    aggs = [("v", "sum"), ("v", "mean"), ("f", "sum"), ("v", "min")]
    a = dist_groupby(t, ["k"], aggs, dense_key_range=dense)
    b = dist_groupby(t, ["k"], aggs, dense_key_range=dense)
    for ca, cb in zip(a.columns, b.columns):
        assert torch.equal(ca.data, cb.data)


@pytest.mark.gpu
def test_groupby_nan_and_signed_zero_keys_on_card(card):
    """NaN keys stay one group per row after every number, and −0.0 joins
    0.0 under its first row's key, on the card's sort as on the CPU's."""
    k = np.array([0.0, -0.0, np.nan, 1.0, np.nan, 0.0, -0.0] * 50)
    data = {"k": k, "v": np.arange(len(k), dtype=np.float64)}
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device)
        outs.append(compute.groupby(pt.Table.from_columns(ctx, data), ["k"],
                                    [("v", "sum"), ("v", "count")]))
    cpu, gpu = outs
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)
    assert not bool(torch.signbit(gpu.column("k").data[0]))
    assert gpu.num_rows == 2 + 100


@pytest.mark.gpu
def test_dist_select_and_aggregate_on_card_matches_cpu(card):
    data = _groupby_data(np.random.default_rng(47))
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
        sel = dist_select(t, lambda env: env["w"] > 0)
        agg = dist_aggregate(dist_select(t, lambda env: env["w"] > 0,
                                         compact=False),
                             [("v", "sum"), ("w", "count"), ("f", "max")])
        outs.append((sel, agg))
    (csel, cagg), (gsel, gagg) = outs
    assert gsel.cap == csel.cap
    assert port_rows(gsel, ordered=True) == port_rows(csel, ordered=True)
    assert_rows_close(port_rows(gagg), port_rows(cagg), [1e-12, 0.0, 0.0])


@pytest.mark.gpu
def test_semi_mask_on_card_matches_cpu(card):
    """The sorted presence kernel on padded blocks with nulls and
    composite keys: the same bits on the card."""
    rng = np.random.default_rng(48)
    n_l, n_r = 50_001, 30_007
    lk = (torch.from_numpy(rng.integers(0, 9_000, n_l)),
          torch.from_numpy(rng.integers(0, 3, n_l).astype(np.int32)))
    rk = (torch.from_numpy(rng.integers(0, 9_000, n_r)),
          torch.from_numpy(rng.integers(0, 3, n_r).astype(np.int32)))
    lv = (torch.from_numpy(rng.random(n_l) < 0.95), None)
    rv = (torch.from_numpy(rng.random(n_r) < 0.95), None)
    on = lambda xs: tuple(None if x is None else x.to(card) for x in xs)  # noqa: E731
    kw = {"l_count": 45_000, "r_count": 29_000}
    cpu = tjoin.semi_mask(lk, lv, rk, rv, **kw)
    gpu = tjoin.semi_mask(on(lk), on(lv), on(rk), on(rv), **kw)
    assert torch.equal(gpu.cpu(), cpu)


def _semi_sides(rng, n_l=40_000, n_r=9_000):
    k = rng.integers(0, 20_000, n_l)
    data_l = {"k": k, "v": rng.random(n_l)}
    data_r = {"k": rng.integers(0, 20_000, n_r)}
    return data_l, data_r


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [None, (0, 19_999)])
@pytest.mark.parametrize("op", [dist_semi_join, dist_anti_join])
def test_semi_anti_on_card_matches_cpu(card, dense, op):
    """World 4, shuffled (the kernel partitions the sorted path; the dense
    path routes by key residue): the same rows on the same shards."""
    data_l, data_r = _semi_sides(np.random.default_rng(49))
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
        rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
        before = hash_cuda.launches
        outs.append(op(lt, rt, "k", "k", dense_key_range=dense,
                       broadcast_threshold=0))
        want = 2 if device == "cuda" and dense is None else 0
        assert hash_cuda.launches - before == want
    cpu, gpu = outs
    assert list(gpu.counts_host()) == list(cpu.counts_host())
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
@pytest.mark.parametrize("thr", [10_000_000, 0])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_fk_join_on_card_is_deterministic_and_matches_cpu(card, thr, how):
    """The dense FK join (broadcast build side, or modulo routing): two
    runs on the card give identical bits, equal to the CPU's result."""
    rng = np.random.default_rng(50)
    n_r = 50_000
    data_r = {"pk": rng.permutation(n_r).astype(np.int32) + 1,
              "b": rng.random(n_r)}
    data_l = {"fk": rng.integers(1, n_r + 100, 200_000).astype(np.int32),
              "a": rng.random(200_000).astype(np.float32)}
    cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm.SORT, "fk", "pk",
                        broadcast_threshold=thr)
    outs = []
    for device in ("cpu", "cuda", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
        rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
        outs.append(dist_join(lt, rt, cfg, dense_key_range=(1, n_r)))
    cpu, gpu1, gpu2 = outs
    for a, b in zip(gpu1.columns, gpu2.columns):
        assert torch.equal(a.data, b.data)
        assert (a.validity is None) == (b.validity is None)
        if a.validity is not None:
            assert torch.equal(a.validity, b.validity)
    assert port_rows(gpu1, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
def test_fk_join_duplicate_build_key_raises_on_card(card):
    """Which of two duplicate writes wins the map's scatter is unspecified
    on the card; the violation count does not depend on it."""
    data_r = {"pk": np.array([1, 2, 3, 3, 5], np.int32), "b": np.ones(5)}
    data_l = {"fk": np.arange(1, 6, dtype=np.int32)}
    ctx = pt.CylonContext(device="cuda", world=4)
    lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_l))
    rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, data_r))
    cfg = pt.JoinConfig.InnerJoin("fk", "pk")
    with pytest.raises(pt.CylonError, match="duplicate"):
        dist_join(lt, rt, cfg, dense_key_range=(1, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 4])
def test_tpch_generate_device_on_card_equals_mirror(card, world):
    """SF 0.01 generated on the card: bit for bit the numpy mirror (floats
    compared as bits)."""
    ctx = pt.CylonContext(device="cuda", world=world)
    dev = datagen_device.generate_device(ctx, 0.01, seed=3)
    mirror, dicts = datagen_device.generate_mirror(0.01, seed=3)
    for name, dt in dev.items():
        tb = dt.to_table()
        for c in tb.columns:
            got = c.data.cpu().numpy()
            want = mirror[name][c.name]
            assert got.dtype == want.dtype, (name, c.name)
            if got.dtype == np.float32:
                got, want = got.view(np.int32), want.view(np.int32)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name}.{c.name}")


# -- all_reduce, sketches, fused / sketch groupby, streaming ----------------

@pytest.mark.gpu
def test_all_reduce_on_card(card):
    comm = pt.CylonContext(device="cuda", world=4).comm
    x = torch.arange(4 * 5 * 3, dtype=torch.int64, device=card).view(4, 5, 3)
    got = comm.all_reduce(x)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), x.cpu().sum(0))


def _sketch_inputs(rng, n, out_cap):
    slot = np.sort(rng.integers(0, out_cap, n))
    slot[-1000:] = out_cap
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    vals[:3] = [np.nan, -0.0, np.inf]
    return {"slot": torch.from_numpy(slot),
            "bits": torch.from_numpy(rng.integers(0, 2**32, n)),
            "ints": torch.from_numpy(rng.integers(-2**62, 2**62, n)),
            "gidx": torch.from_numpy(np.arange(n, dtype=np.int64) + 12345),
            "vmask": torch.from_numpy(rng.random(n) < 0.9),
            "vals": torch.from_numpy(vals),
            "vals64": torch.from_numpy(vals.astype(np.float64) / 3)}


def _sketch_pipeline(x, out_cap):
    """Every ops/sketch.py function on one set of inputs."""
    from cylon_tpu_torch.ops import sketch as sk
    out = {"mix": sk.mix32(x["bits"]), "rank": sk._hll_rank(x["bits"])}
    for dt in (torch.int8, torch.int32, torch.int64):
        out[f"bits_{dt}"] = sk.value_bits32(x["ints"].to(dt))
    # floats are made on the host: a conversion on the card may rewrite
    # a NaN's payload
    out["bits_f32"] = sk.value_bits32(x["vals"])
    out["bits_f64"] = sk.value_bits32(x["vals64"])
    regs = sk.hll_build(x["slot"], out_cap, x["bits"], x["vmask"])
    half = torch.arange(out_cap, device=regs.device) // 2
    merged = sk.hll_merge_rows(half, out_cap // 2 + 1, regs,
                               torch.ones(out_cap, dtype=torch.bool,
                                          device=regs.device))
    v, p = sk.bottomk_build(x["slot"], out_cap, x["vals"], x["bits"],
                            x["gidx"], x["vmask"])
    mv, mp = sk.bottomk_merge_rows(half, out_cap // 2 + 1, v, p,
                                   torch.ones(out_cap, dtype=torch.bool,
                                              device=v.device))
    q, nonempty = sk.bottomk_quantile(mv, mp, 0.9)
    out.update(regs=regs, merged=merged, est=sk.hll_estimate(merged),
               v=v.view(torch.int32), p=p.view(torch.int32),
               mv=mv.view(torch.int32), mp=mp.view(torch.int32),
               q=q.view(torch.int32), nonempty=nonempty)
    return out


@pytest.mark.gpu
def test_sketch_ops_on_card_match_cpu_bit_for_bit(card):
    """1M rows through every ops/sketch.py function: the card's registers,
    lanes, estimates and quantiles equal the CPU's bit for bit."""
    out_cap = 1000
    x = _sketch_inputs(np.random.default_rng(47), 1 << 20, out_cap)
    cpu = _sketch_pipeline(x, out_cap)
    gpu = _sketch_pipeline({k: v.to(card) for k, v in x.items()}, out_cap)
    for k in cpu:
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


def _psum_data(rng, n):
    return {"s": np.array([f"s{v}" for v in rng.integers(0, 6, n)],
                          dtype=object),
            "t": np.array([f"t{v}" for v in rng.integers(0, 4, n)],
                          dtype=object),
            "v": rng.normal(size=n) * 1e3,
            "w": rng.integers(-9, 9, n).astype(np.int32),
            "f": rng.random(n).astype(np.float32)}


@pytest.mark.gpu
def test_psum_fused_groupby_on_card_is_stable(card):
    """Two runs of the psum mode on the card: the same keys and counts,
    sums within 1e-12 (the float64 scatter-add uses atomics), the CPU's
    answer within 1e-12, and no partition-kernel launch."""
    from cylon_tpu_torch.parallel import dist_groupby_fused, dist_ops
    data = _psum_data(np.random.default_rng(48), 1 << 20)
    aggs = [("v", "sum"), ("v", "mean"), ("w", "sum"), ("w", "count"),
            ("f", "sum")]
    outs = []
    for device in ("cpu", "cuda", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
        dist_ops.decisions.clear()
        before = hash_cuda.launches
        outs.append(dist_groupby_fused(t, ["s", "t"], aggs, mode="psum"))
        assert hash_cuda.launches == before
        assert dict(dist_ops.decisions) == {"groupby.psum": 1}
    cpu, a, b = outs
    for other in (b, cpu):
        assert list(a.counts_host()) == list(other.counts_host())
        assert_rows_close(port_rows(a, ordered=True),
                          port_rows(other, ordered=True),
                          float_rtols(a, f32=1e-6))


@pytest.mark.gpu
def test_trailing_dim_leaf_through_shuffle_on_card(card):
    """An [n, 256] int32 leaf and an [n, 256] uint32 leaf ride the exchange
    by row, on the card as on the CPU."""
    from cylon_tpu_torch.parallel.shuffle import shuffle_leaves
    rng = np.random.default_rng(49)
    n = 4 * 4096
    pid = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))  # 4: drop
    m = torch.from_numpy(rng.integers(0, 26, (n, 256)).astype(np.int32))
    u = torch.from_numpy(rng.integers(0, 2**32, (n, 256))).to(torch.uint32)
    k = torch.arange(n, dtype=torch.int64)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        leaves, counts, cap = shuffle_leaves(
            ctx, pid.to(device), [k.to(device), m.to(device), u.to(device)])
        outs.append(([lf.cpu() for lf in leaves], counts.cpu(), cap))
    (lc, cc, capc), (lg, cg, capg) = outs
    assert capc == capg and torch.equal(cc, cg)
    for a, b in zip(lc, lg):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b)
    rows = torch.cat([torch.arange(c) + s * capc
                      for s, c in enumerate(cc.tolist())])
    assert torch.equal(lg[1][rows], m[lg[0][rows]])


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 4])
def test_dist_groupby_sketch_on_card_matches_cpu(card, world):
    """Keys, estimates and quantiles of the sketch groupby: the card's
    equal the CPU's exactly, with one kernel launch per shuffle."""
    from cylon_tpu_torch.parallel import dist_groupby_sketch
    rng = np.random.default_rng(50)
    n = 1 << 18
    data = {"g": rng.integers(0, 500, n), "ids": rng.integers(0, 5000, n),
            "x": rng.standard_normal(n)}
    aggs = [("ids", "approx_distinct"), ("x", "approx_quantile:0.5"),
            ("x", "approx_quantile:0.95")]
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=world)
        t = DTable.from_table(ctx, pt.Table.from_columns(ctx, data))
        before = hash_cuda.launches
        outs.append(dist_groupby_sketch(t, ["g"], aggs))
        assert hash_cuda.launches - before == \
            (1 if device == "cuda" and world > 1 else 0)
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("alg", ["hash", "sort"])
def test_dist_join_streaming_on_card_matches_cpu(card, how, alg):
    from cylon_tpu_torch.parallel import dist_join_streaming
    rng = np.random.default_rng(51)
    sides = [{"k": rng.integers(0, 50_000, n).astype(np.int64),
              "v": rng.random(n).astype(np.float32)}
             for n in (200_000, 60_000)]
    cfg = pt.JoinConfig(pt.JoinType(how), pt.JoinAlgorithm(alg), "k", "k",
                        broadcast_threshold=0)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = pt.CylonContext(device=device, world=4)
        l, r = (DTable.from_table(ctx, pt.Table.from_columns(ctx, s))
                for s in sides)
        outs.append(dist_join_streaming(l, r, cfg, chunks=4))
    cpu, gpu = outs
    assert gpu.cap == cpu.cap
    assert list(gpu.counts_host()) == list(cpu.counts_host())
    assert port_rows(gpu, ordered=True) == port_rows(cpu, ordered=True)


# -- the planner ----------------------------------------------------------------

@pytest.fixture(scope="module")
def card_tpch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx = pt.CylonContext(device="cuda", world=4)
    return ctx, datagen_device.generate_device(ctx, 0.01, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("q", sorted(tpch_queries.QUERIES))
def test_planned_tpch_on_card_matches_eager(card_tpch, q):
    """A query through ``ctx.optimize`` on the card: the eager rows in
    order (floats within 1e-9 / 1e-6), then a second run that hits the
    plan cache for every materialization and returns the same rows."""
    from tpch_torch_parity import PLANNED_F32
    ctx, tables = card_tpch
    op = lambda t: tpch_queries.QUERIES[q](ctx, t)  # noqa: E731
    tplan.clear_plan_cache()
    trace.enable_counters()
    try:
        trace.reset()
        eager = op(tables)
        got = ctx.optimize(op, tables)
        first = trace.counters()
        trace.reset()
        again = ctx.optimize(op, tables)
        second = trace.counters()
    finally:
        trace.disable_counters()
        trace.reset()
        tplan.clear_plan_cache()
    assert got.column(0).data.device.type == "cuda"
    rtols = float_rtols(got, f64=1e-9)
    for j, c in enumerate(got.columns):
        if c.name in PLANNED_F32.get(q, ()):
            rtols[j] = 1e-6
    rows = port_rows(got, ordered=True)
    assert_rows_close(rows, port_rows(eager, ordered=True), rtols)
    assert_rows_close(port_rows(again, ordered=True), rows, rtols)
    assert first.get("plan.cache_miss", 0) >= 1
    assert second.get("plan.cache_miss", 0) == 0
    assert second.get("plan.cache_hit", 0) >= 1


# ---------------------------------------------------------------------------
# observability on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_devmem_reads_the_allocator_on_card(card):
    """``devmem.snapshot`` on CUDA reads the caching allocator (source
    ``memory_stats``): its peak is ``max_memory_allocated`` and it never
    resets the peak itself."""
    from cylon_tpu_torch.observe import devmem
    torch.cuda.reset_peak_memory_stats(card)
    big = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    del big
    s = devmem.snapshot(card)
    assert s.source == "memory_stats"
    assert s.live_bytes == torch.cuda.memory_allocated(card)
    assert s.peak_bytes == torch.cuda.max_memory_allocated(card)
    assert s.peak_bytes >= 64 << 20
    again = devmem.snapshot(card)
    assert again.peak_bytes == s.peak_bytes  # the peak was not reset


def _sort_on_card(card):
    rng = np.random.default_rng(41)
    ctx = pt.CylonContext(device=card, world=4)
    t = pt.Table.from_columns(ctx, {"k": rng.integers(0, 1000, 50_000),
                                    "v": rng.random(50_000)})
    return DTable.from_table(ctx, t)


@pytest.mark.gpu
def test_spans_synchronize_only_while_tracing_on_card(card, monkeypatch):
    """Tracing off (counters on): a HASH join and a sort call
    ``torch.cuda.synchronize`` never and count ``trace.sync`` 0; tracing
    on: every barrier is one synchronize, one ``trace.sync`` and one
    nested ``sync`` span."""
    dt = _sort_on_card(card)
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (calls.append(d), real(d)))
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, "k", "k",
                        broadcast_threshold=0)
    trace.reset()
    trace.enable_counters()
    try:
        dist_join(dt, dt, cfg)
        dist_sort(dt, "k")
        assert calls == []
        assert trace.counters().get("trace.sync", 0) == 0
        assert trace.get_span_records(all_threads=True) == []
        trace.reset()
        trace.enable()
        dist_join(dt, dt, cfg)
        dist_sort(dt, "k")
        syncs = trace.counters()["trace.sync"]
        spans = [n for n, _, _ in trace.get_spans()]
    finally:
        trace.disable()
        trace.disable_counters()
        trace.reset()
    assert syncs == len(calls) == spans.count("sync") > 0
    assert "shuffle.exchange" in spans and "sort.local" in spans


@pytest.mark.gpu
def test_analyze_join_on_card(card):
    """EXPLAIN ANALYZE of a HASH join at world 4 on the card: the eager
    rows, the partition kernel launched inside the run, node bytes =
    totals = the exchange counters."""
    dt = _sort_on_card(card)
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, "k", "k",
                        broadcast_threshold=0)
    eager = dist_join(dt, dt, cfg)
    hash_cuda.launches = 0
    rep = dt.ctx.analyze(lambda t: dist_join(t, t, cfg), dt)
    assert rep.ok and hash_cuda.launches > 0
    assert port_rows(rep.output) == port_rows(eager)
    c = rep.totals["counters"]
    assert sum(n.runtime["bytes_moved"] for n in rep.nodes
               if n.runtime["depth"] == 1) == rep.totals["bytes_moved"] \
        == c["shuffle.bytes_sent"] + c.get("broadcast.bytes_sent", 0) > 0
    assert rep.nodes[0].runtime["decision"] == "shuffle"


def _lowering_rows(dt):
    """Rows per shard as sorted lists of (k, v) pairs, from the card."""
    counts = dt.counts_host()
    k = dt.column("k").data.cpu()
    v = dt.column("v").data.cpu()
    return [sorted(zip(k[s * dt.cap:s * dt.cap + int(c)].tolist(),
                       v[s * dt.cap:s * dt.cap + int(c)].tolist()))
            for s, c in enumerate(counts)]


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,shape", [
    ("chunked", None), ("ring", None), ("allgather", None),
    ("hierarchical", (2, 2)), ("staged-spill", None)])
def test_exchange_lowering_on_card(card, strategy, shape):
    """At 1,048,576 rows and world 4 on the card, each forced lowering
    gives every shard the rows single-shot gives it, with the partition
    kernel launched once; the fold-combine (chunked and
    hierarchical-combine) gives the fused groupby's groups."""
    from cylon_tpu_torch.parallel import dist_groupby_fused, shuffle_table
    rng = np.random.default_rng(61)
    n = 1 << 20
    ctx = pt.CylonContext(device=card, world=4)
    t = pt.Table.from_columns(ctx, {
        "k": rng.integers(0, 1 << 18, n).astype(np.int32),
        "v": rng.random(n)})
    dt = DTable.from_table(ctx, t)
    want = _lowering_rows(shuffle_table(dt, ["k"]))
    aggs = [("v", "sum"), ("v", "count"), ("v", "max")]
    gwant = port_rows(dist_groupby_fused(dt, ["k"], aggs,
                                         mode="pre-aggregate"))
    tconfig.set_exchange_strategy(strategy)
    tconfig.set_mesh_shape(shape)
    trace.enable_counters()
    trace.reset()
    try:
        hash_cuda.launches = 0
        got = shuffle_table(dt, ["k"])
        assert hash_cuda.launches == 1
        assert _lowering_rows(got) == want
        c = trace.counters()
        assert c[f"shuffle.strategy.{strategy.replace('-', '_')}"] == 1
        if strategy in ("chunked", "hierarchical", "staged-spill"):
            if strategy == "hierarchical":
                tconfig.set_exchange_strategy("hierarchical-combine")
            trace.reset()
            gg = dist_groupby_fused(dt, ["k"], aggs, mode="pre-aggregate")
            assert trace.counters()["shuffle.fold_combined"] >= 1
            assert_rows_close(port_rows(gg), gwant, float_rtols(gg))
    finally:
        tconfig.set_exchange_strategy(None)
        tconfig.set_mesh_shape(None)
        trace.disable_counters()
        trace.reset()


@pytest.mark.gpu
def test_watchdog_dispatch_runs_on_the_callers_stream(card):
    """Under ``CYLON_EXCHANGE_TIMEOUT_MS`` the dispatch runs on a helper
    thread but on the caller's CUDA stream, and its result is complete
    when the caller gets it; a whole shuffle under the watchdog gives
    the rows it gives without, with no timeout counted."""
    import threading
    from cylon_tpu_torch.parallel import shuffle as tshuffle
    from cylon_tpu_torch.parallel import shuffle_table
    side = torch.cuda.Stream(card)
    seen = {}

    def thunk():
        seen["thread"] = threading.current_thread().name
        seen["stream"] = torch.cuda.current_stream(card)
        x = torch.ones(1 << 22, device=card)
        return (x * 2).sum()

    prev = tconfig.set_exchange_timeout_ms(60_000)
    trace.enable_counters()
    trace.reset()
    try:
        with torch.cuda.stream(side):
            out = tshuffle._watchdog_dispatch("shuffle.exchange", thunk,
                                              card)
        assert seen["thread"] == "cylon-exchange-watchdog"
        assert seen["stream"] == side
        assert float(out) == 2.0 * (1 << 22)
        dt = _sort_on_card(card)
        tconfig.set_exchange_timeout_ms(None)
        want = _lowering_rows(shuffle_table(dt, ["k"]))
        tconfig.set_exchange_timeout_ms(60_000)
        assert _lowering_rows(shuffle_table(dt, ["k"])) == want
        assert trace.counters().get("shuffle.watchdog_timeouts", 0) == 0
    finally:
        tconfig.set_exchange_timeout_ms(prev)
        trace.disable_counters()
        trace.reset()


def _spill_table_on_card(card, n=1 << 20, world=4, seed=71):
    """The join cell's column shape: an int32 key, three float32
    payloads."""
    rng = np.random.default_rng(seed)
    ctx = pt.CylonContext(device=card, world=world)
    data = {"k": rng.integers(0, n, n).astype(np.int32)}
    for j in range(3):
        data[f"v{j}"] = rng.random(n).astype(np.float32)
    return DTable.from_table(ctx, pt.Table.from_columns(ctx, data)), data


@pytest.mark.gpu
def test_spill_frees_card_memory_into_pinned_blocks(card):
    """``spill()`` on the card: the host blocks are pinned, the card's
    allocated bytes drop by at least the leaves' bytes, the fault-in
    gives the leaves back bit for bit, and a re-spill is a hit with no
    device read."""
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.spill import pool as tpool
    tpool.clear_pool()
    broadcast.clear_replica_cache()
    dt, _ = _spill_table_on_card(card)
    before = [c.data.clone() for c in dt.columns]
    leaf_bytes = sum(c.data.numel() * c.data.element_size()
                     for c in dt.columns)
    trace.enable_counters()
    trace.reset()
    try:
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(card)
        dt.spill()
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated(card)
        assert m0 - m1 >= leaf_bytes
        entry = dt._spill_entry
        assert all(d.is_pinned() for d, _ in entry.leaves)
        assert tpool.get_pool().pinned_bytes() >= leaf_bytes
        dt.ensure_device()
        for c, b in zip(dt.columns, before):
            assert c.data.device.type == "cuda"
            assert torch.equal(c.data.view(torch.int32), b.view(torch.int32))
        outs = trace.counters()["spill.stage_outs"]
        dt.spill()
        c = trace.counters()
        assert c["spill.respill_hits"] == 1
        assert c["spill.stage_outs"] == outs
    finally:
        trace.disable_counters()
        trace.reset()
        tpool.clear_pool()


@pytest.mark.gpu
def test_stage_in_waits_on_the_copy_event(card):
    """A deferred stage-in runs on the copy stream and hands the consumer
    an event; after ``ready()`` the consumer's stream reads the staged
    data, which equals the pinned source."""
    from cylon_tpu_torch.spill import pool as tpool
    ctx = pt.CylonContext(device=card, world=4)
    src = tpool.pinned_empty((1 << 22,), torch.float32, card)
    src.copy_(torch.arange(1 << 22, dtype=torch.float32))
    assert src.is_pinned()
    staged = tpool.stage_in_arrays(ctx, [[src[:1 << 21], src[1 << 21:]]],
                                   defer=True)
    assert isinstance(staged.event, torch.cuda.Event)
    assert tpool._copy_stream(card) != torch.cuda.current_stream(card)
    staged.ready()
    assert staged.event is None
    assert torch.equal(staged[0].cpu(), src)
    hosts = tpool.stage_out_arrays([staged[0]])
    assert hosts[0].is_pinned() and torch.equal(hosts[0], src)


@pytest.mark.gpu
def test_morsel_join_and_groupby_on_card_match_cpu(card):
    """The morsel join (HASH, world 4) and the morsel groupby of a
    spilled table on the card give the CPU's rows, launching the
    partition kernel on every morsel's join and on the groupby's final
    exchange."""
    from cylon_tpu_torch.spill import morsel as tmorsel
    from cylon_tpu_torch.spill import pool as tpool
    outs = {}
    launches = {}
    for dev in (card, torch.device("cpu")):
        tpool.clear_pool()
        lt, data = _spill_table_on_card(dev, n=1 << 18)
        rt, _ = _spill_table_on_card(dev, n=1 << 18, seed=72)
        cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, 0, 0,
                            broadcast_threshold=0)
        lt.spill()
        hash_cuda.launches = 0
        j = tmorsel.morsel_join(lt, rt, cfg, morsels=4)
        launches[dev.type, "join"] = hash_cuda.launches
        hash_cuda.launches = 0
        g = tmorsel.morsel_groupby(lt, ["k"], [("v0", "sum"),
                                               ("v1", "count")], morsels=4)
        launches[dev.type, "groupby"] = hash_cuda.launches
        assert lt.is_spilled
        outs[dev.type] = (sorted(port_rows(j.to_table())),
                          port_rows(g))
    assert outs["cuda"][0] == outs["cpu"][0]
    assert_rows_close(outs["cuda"][1], outs["cpu"][1], [0, 1e-6, 0])
    assert launches["cuda", "join"] >= 4 and launches["cuda", "groupby"] == 1
    tpool.clear_pool()


@pytest.mark.gpu
def test_two_thread_fault_in_on_card(card):
    """Two threads touching one spilled table on the card: one stage-in,
    both results equal."""
    import threading
    from cylon_tpu_torch.spill import pool as tpool
    tpool.clear_pool()
    dt, _ = _spill_table_on_card(card, n=1 << 18)
    want = port_rows(dist_groupby(dt, ["k"], [("v0", "count")]))
    dt.spill()
    trace.enable_counters()
    trace.reset()
    res, errs = [], []

    def use():
        try:
            res.append(port_rows(dist_groupby(dt, ["k"], [("v0", "count")])))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    try:
        ts = [threading.Thread(target=use) for _ in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        assert not errs, errs
        assert trace.counters()["spill.faultins"] == 1
        assert res == [want, want]
    finally:
        trace.disable_counters()
        trace.reset()
        tpool.clear_pool()


@pytest.mark.gpu
@pytest.mark.parametrize("nparts", [3, 7])
def test_kernel_matches_plain_at_survivor_worlds(card, nparts):
    """The survivor worlds of a re-mesh (4 → 3, 8 → 7): the kernel's
    ``% nparts`` equals the plain version's at the join cell's layout
    ([P*cap] int32 keys of a world-``nparts`` table, padding included),
    and every part receives rows."""
    from cylon_tpu_torch.ops.compact import next_bucket
    n = (1 << 20) + 5
    cap = next_bucket(-(-n // nparts), minimum=8)
    rng = np.random.default_rng(nparts)
    k = torch.from_numpy(rng.integers(0, n, nparts * cap)
                         .astype(np.int32)).to(card)
    want = plain_hash.partition_ids(plain_hash.row_hash((k,), (None,)),
                                    nparts)
    before = dict(hash_cuda.launches_by_nparts)
    got = hash_cuda.partition_ids_fused((k,), (None,), nparts)
    torch.cuda.synchronize()
    assert hash_cuda.launches_by_nparts.get(nparts, 0) == \
        before.get(nparts, 0) + 1
    assert torch.equal(got, want)
    assert torch.equal(torch.unique(got).cpu(),
                       torch.arange(nparts, dtype=torch.int32))


@pytest.mark.gpu
def test_remesh_stream_order_under_queued_kernel(card):
    """The re-mesh goes through the spill pool's staging boundaries: with
    a long kernel queued on the compute stream and a write to a column
    queued behind it, the evacuation still reads the written values (the
    copy stream waits on the compute stream), and the restaged shards —
    read by a kernel right after the re-mesh returns — equal a host
    re-block of the pre-loss rows bit for bit."""
    from cylon_tpu_torch import topology
    from cylon_tpu_torch.parallel import remesh
    n = 1 << 20
    dt, data = _spill_table_on_card(card, n=n, world=4, seed=73)
    counts = dt.counts_host().astype(np.int64)
    torch.cuda.synchronize()
    try:
        torch.cuda._sleep(200_000_000)      # ~0.1 s of queued device work
        dt.columns[1].data.add_(1.0)        # queued behind it
        survivor = topology.mark_lost(dt.ctx, 1)
        remesh.remesh_table(dt, survivor)
        # a kernel of the new world reads the restaged blocks at once
        snaps = [c.data.clone() for c in dt.columns]
        torch.cuda.synchronize()
    finally:
        topology.reset()
    assert dt.nparts == 3 and dt.ctx is survivor
    # the pre-loss rows, shard-major, with the queued write applied
    want = {"k": data["k"], "v0": data["v0"] + np.float32(1.0),
            "v1": data["v1"], "v2": data["v2"]}
    sizes = dt.counts_host()
    assert int(sizes.sum()) == int(counts.sum()) == n
    assert list(sizes) == [n // 3 + (1 if i < n % 3 else 0)
                           for i in range(3)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for c in dt.columns:
        host = c.data.cpu().numpy()
        for s in range(3):
            np.testing.assert_array_equal(
                host[s * dt.cap:s * dt.cap + sizes[s]],
                want[c.name][offs[s]:offs[s + 1]])
            assert not host[s * dt.cap + sizes[s]:(s + 1) * dt.cap].any()
    for c, snap in zip(dt.columns, snaps):
        assert torch.equal(snap, c.data)


@pytest.mark.gpu
def test_topology_rung_leaves_no_old_world_scan_copy(card):
    """After a TOPOLOGY rung on the card (a two-stage plan losing a slot,
    4 → 3), the card's allocated bytes hold the scan tables once, in
    their survivor layout: the old-world copies, the dropped memo, the
    failed attempt's intermediates and the old checkpoints are freed."""
    from cylon_tpu_torch import faults, topology
    from cylon_tpu_torch.parallel import broadcast, dist_join

    def leaf_bytes(t):
        return sum(c.data.numel() * c.data.element_size()
                   + (0 if c.validity is None else c.validity.numel())
                   for c in t.columns) + t.counts.numel() * 4

    lt, _ = _spill_table_on_card(card, n=1 << 20, seed=74)
    rt, _ = _spill_table_on_card(card, n=1 << 20, seed=75)
    ctx = lt.ctx
    rt = DTable(ctx, rt.columns, rt.cap, rt.counts)   # one context
    tables = {"l": lt, "r": rt}

    def op(t):
        j = dist_join(t["l"], t["r"], pt.JoinConfig.InnerJoin(0, 0))
        return dist_groupby(j, ["lt-k"], [("rt-v0", "sum")])

    prev = tconfig.set_broadcast_join_threshold(1)
    broadcast.clear_replica_cache()
    try:
        want = port_rows(ctx.optimize(op, tables), ordered=False)
        torch.cuda.synchronize()
        old = sum(leaf_bytes(t) for t in tables.values())
        m0 = torch.cuda.memory_allocated(card)
        fp = faults.FaultPlan(seed=0, rules=[faults.FaultRule(
            "mesh.device_lost", kind="topology", nth=2, lost=1)])
        with faults.active(fp):
            out = ctx.optimize(op, tables)
        got = sorted(r for shard in port_rows(out) for r in shard)
        del out
        torch.cuda.synchronize()
        torch.empty(1, device=card)        # lets the allocator settle
        m1 = torch.cuda.memory_allocated(card)
        new = sum(leaf_bytes(t) for t in tables.values())
        assert lt.nparts == rt.nparts == 3
    finally:
        tconfig.set_broadcast_join_threshold(prev)
        topology.reset()
        broadcast.clear_replica_cache()
    assert m1 - m0 <= new - old + (1 << 20), (m0, m1, old, new)
    flat = sorted(r for shard in want for r in shard)
    assert [r[0] for r in got] == [r[0] for r in flat]
    assert_rows_close(got, flat, [0, 1e-6])


# ---------------------------------------------------------------------------
# the serving layer on the card
# ---------------------------------------------------------------------------

def _serve_fact(card, n=1 << 20, seed=81):
    import pandas as pd
    rng = np.random.default_rng(seed)
    ctx = pt.CylonContext(device=card, world=4)
    df = pd.DataFrame({"k": rng.integers(0, 1000, n).astype(np.int64),
                       "v": rng.standard_normal(n)})
    return ctx, DTable.from_pandas(ctx, df)


def _serve_q(t):
    from cylon_tpu_torch.parallel import shuffle_table
    return dist_groupby(shuffle_table(t["fact"], ["k"]), ["k"],
                        [("v", "sum"), ("v", "count")])


def _sorted_rows(table):
    return sorted(port_rows(table), key=repr)


@pytest.mark.gpu
def test_served_query_exported_on_worker_matches_direct_on_card(card):
    """A query submitted from a client thread runs on the dispatcher and
    is exported on a pipeline worker (which made the card current): the
    rows equal the same query run directly."""
    import threading

    from cylon_tpu_torch.serve import ServeSession
    ctx, dt = _serve_fact(card)
    want = _sorted_rows(_serve_q({"fact": dt}).to_table())
    seen = {}

    def export(r):
        seen["device"] = torch.cuda.current_device()
        seen["thread"] = threading.current_thread().name
        return r.to_table()

    box = []
    with ServeSession(ctx, tables={"fact": dt}, batch_window_ms=2.0,
                      views=False) as s:
        th = threading.Thread(target=lambda: box.append(
            s.submit(_serve_q, export=export, label="client")))
        th.start()
        th.join()
        got = _sorted_rows(box[0].result(timeout=300))
        st = s.stats()
    assert seen["device"] == ctx.device.index
    assert seen["thread"].startswith("serve-export")
    assert st["exports_async"] == 1 and st["completed"] == 1
    assert_rows_close(got, want, [0, 1e-12, 0])


@pytest.mark.gpu
def test_pinned_view_hit_waits_on_the_copy_event_on_card(card):
    """A clean view hit pinned on the dispatcher is staged in on a
    pipeline worker while 0.1 s of work is queued on the dispatcher's
    stream and on the copy stream ahead of the stage-in: the exported
    rows equal the recompute (the export waits on the copy's event), and
    the pool entry dropped while the copy is in flight does not corrupt
    it."""
    import time

    from cylon_tpu_torch.serve import ServeSession
    from cylon_tpu_torch.spill import pool as tpool
    ctx, dt = _serve_fact(card, seed=82)
    want = _sorted_rows(_serve_q({"fact": dt}).to_table())
    tpool.clear_pool()
    try:
        with ServeSession(ctx, tables={"fact": dt}, batch_window_ms=2.0,
                          pipelined=True) as s:
            s.submit(_serve_q, label="warm").result(timeout=300)
            assert s.holds_view(_serve_q)
            torch.cuda.synchronize(card)
            torch.cuda._sleep(200_000_000)   # ~0.1 s on the dispatcher's
            with torch.cuda.stream(tpool._copy_stream(card)):
                torch.cuda._sleep(200_000_000)   # ...and the copy stream
            h = s.submit(_serve_q, export=lambda r: r.to_table(),
                         label="hit")
            # once the worker took the pinned entry (its copies queue
            # behind the copy stream's sleep), evict the view's blocks
            # and reuse page-locked memory of their size
            deadline = time.time() + 60
            while (h.status != "running" or s._views._pinned) \
                    and not h.done() and time.time() < deadline:
                time.sleep(0.0005)
            nbytes = 0
            for sig in list(tpool.get_pool()._entries):
                e = tpool.get_pool()._entries[sig]
                nbytes = max(nbytes, e.nbytes)
                tpool.get_pool().drop_entry(sig)
            junk = [torch.full((max(nbytes // 8, 1),), 7.0,
                               dtype=torch.float64, pin_memory=True)
                    for _ in range(4)]
            got = _sorted_rows(h.result(timeout=300))
            del junk
            st = s.stats()
        assert h.view == "hit" and st["view_hits"] == 1
        assert_rows_close(got, want, [0, 1e-12, 0])
    finally:
        tpool.clear_pool()


@pytest.mark.gpu
def test_scrape_returns_while_device_work_in_flight_on_card(card):
    """An OpenMetrics scrape reads host counters only: it returns while
    0.1 s of device work is still queued, and adds no device sync."""
    import time
    import urllib.request

    from cylon_tpu_torch.observe import exporter
    trace.enable_counters()
    try:
        trace.count("serve.completed", 2)
        port = exporter.start(0)
        torch.cuda.synchronize(card)
        done = torch.cuda.Event()
        torch.cuda._sleep(400_000_000)       # ~0.2 s of queued device work
        done.record()
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode("utf-8")
        scrape_s = time.perf_counter() - t0
        in_flight = not done.query()
        torch.cuda.synchronize(card)
    finally:
        exporter.stop()
        trace.disable_counters()
        trace.reset()
    assert "cylon_serve_completed_total 2" in body
    assert in_flight, f"the device work finished first ({scrape_s:.3f} s)"


# -- the abstract plan check and the deferred pipeline -------------------------

@pytest.mark.gpu
def test_kernel_meta_arm_launches_nothing_on_card(card):
    """Meta key columns (an abstract plan run) get the kernel's checks and
    a meta int32 result, launch nothing and allocate nothing on the card;
    the same columns on the card still launch the kernel."""
    n = 1 << 20
    cols = [torch.empty(n, dtype=torch.int64, device="meta")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = hash_cuda.launches
    out = hash_cuda.partition_ids_fused(cols, [None], 4)
    assert out.device.type == "meta" and out.dtype == torch.int32
    assert hash_cuda.launches == before
    assert torch.cuda.max_memory_allocated() == base
    real = torch.arange(n, device=card)
    got = hash_cuda.partition_ids_fused([real], [None], 4)
    assert hash_cuda.launches == before + 1
    want = plain_hash.partition_ids(plain_hash.row_hash((real.cpu(),),
                                                        (None,)), 4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_plan_check_and_pipeline_on_card(card_tpch):
    """Q5 and Q21 on the card: the abstract check launches nothing, reads
    nothing and allocates nothing; under run_pipeline (warm hints) each
    equals its eager run in order with fewer host reads, and the
    partition kernel's launches equal the eager run's."""
    from cylon_tpu_torch.analysis import plan_check
    from cylon_tpu_torch.parallel import run_pipeline
    ctx, tables = card_tpch
    trace.enable_counters()
    try:
        for q in ("q5", "q21"):
            op = lambda t, q=q: tpch_queries.QUERIES[q](ctx, t)  # noqa: E731
            eager = op(tables)  # warms the hints and the dimension probes
            trace.reset()
            launches = hash_cuda.launches
            eager = op(tables)
            eager_reads = trace.counters().get("host.read", 0)
            eager_launches = hash_cuda.launches - launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            trace.reset()
            launches = hash_cuda.launches
            rep = plan_check.validate(op, tables,
                                      concrete=("nation", "region"))
            torch.cuda.synchronize()
            assert rep.ok and rep.nodes
            assert hash_cuda.launches == launches
            assert trace.counters().get("host.read", 0) == 0
            assert torch.cuda.max_memory_allocated() == base
            run_pipeline(lambda: op(tables))
            trace.reset()
            launches = hash_cuda.launches
            got = run_pipeline(lambda: op(tables))
            c = trace.counters()
            assert c.get("pipeline.replays", 0) == 0
            assert c.get("host.read", 0) < eager_reads
            assert hash_cuda.launches - launches == eager_launches
            assert_rows_close(port_rows(got, ordered=True),
                              port_rows(eager, ordered=True),
                              float_rtols(got, f64=1e-9))
    finally:
        trace.disable_counters()
        trace.reset()


def _nccl_context(tmp_path, world):
    return pt.CylonContext.InitMultiHost(f"file://{tmp_path}/store", 1, 0,
                                         world=world, device="cuda",
                                         backend="nccl", timeout=120)


@pytest.mark.gpu
def test_process_communicator_nccl_equals_local_on_card(card, tmp_path):
    """One process of 4 local ranks over NCCL: every collective of the
    process communicator (``all_to_all``, ``all_gather``, ``all_reduce``,
    ``ppermute``, and the group-local forms at the split ``(1, 4)``)
    equals ``LocalCommunicator``'s on the same CUDA tensor."""
    import torch_multiprocess_worker as W
    from cylon_tpu_torch.context import LocalCommunicator
    ctx = _nccl_context(tmp_path, 4)
    try:
        assert ctx.comm.backend == "nccl"
        x = W.global_block(4).to(card)
        got = W.collectives(ctx.comm, x, (1, 4))
        want = W.collectives(LocalCommunicator(4, card), x, (1, 4))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        ctx.finalize()


@pytest.mark.gpu
def test_process_communicator_operators_on_card(card, tmp_path):
    """The distributed operators over the NCCL context (1 process × 4
    local ranks) give the single-process world 4's shards on the card."""
    import torch_multiprocess_worker as W
    ctx = _nccl_context(tmp_path, 4)
    try:
        sim = pt.CylonContext(device="cuda", world=4)
        data = W.inputs(4)
        got_env = W.Env(pt, ctx, ctx, data)
        want_env = W.Env(pt, sim, sim, data)
        for name in ("shuffle", "join_hash_inner", "join_sort_full_outer",
                     "sort_desc", "union", "groupby_default",
                     "lowering_ring", "lowering_allgather", "export"):
            W.clear_hints(pt)
            got = W.SCENARIOS[name](got_env)
            W.clear_hints(pt)
            want = W.SCENARIOS[name](want_env)
            if name == "export":
                assert got == want
                continue
            assert port_rows(got, ordered=True) == \
                port_rows(want, ordered=True), name
            assert got.cap == want.cap, name
    finally:
        ctx.finalize()


def _nccl_tpch(tmp_path):
    """The NCCL context (1 process × 4 local ranks), the single-process
    world 4, and the TPC-H tables at SF 0.01 generated on each."""
    ctx = _nccl_context(tmp_path, 4)
    sim = pt.CylonContext(device="cuda", world=4)
    return (ctx, datagen_device.generate_device(ctx, 0.01, seed=3), sim,
            datagen_device.generate_device(sim, 0.01, seed=3))


@pytest.mark.gpu
def test_tpch_generator_nccl_equals_local_on_card(card, tmp_path):
    """``generate_device`` over the NCCL context builds the single-process
    world 4's tables on the card, shard for shard (counts and every
    column's bytes), with the same ``cap``."""
    import torch_multiprocess_worker as W
    ctx, tables, _, want = _nccl_tpch(tmp_path)
    try:
        for name, dt in tables.items():
            assert W.shard_digests(dt) == W.shard_digests(want[name]), name
            assert dt.cap == want[name].cap, name
    finally:
        ctx.finalize()


@pytest.mark.gpu
def test_tpch_operators_and_planner_nccl_on_card(card, tmp_path):
    """Over the NCCL context on the card: a streaming join (lineitem ⋈
    orders in 3 slices), the fused groupby (pre-aggregate by
    ``l_orderkey``) and Q5 through ``ctx.optimize`` equal the
    single-process world 4's, rows in order (the joins and groupby shard
    for shard, with the same ``cap``)."""
    from cylon_tpu_torch.parallel import dist_ops, dist_project
    from cylon_tpu_torch.parallel.streaming import dist_join_streaming
    import torch_multiprocess_worker as W
    ctx, tables, sim, want = _nccl_tpch(tmp_path)
    try:
        cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH,
                            "l_orderkey", "o_orderkey", broadcast_threshold=0)

        def ops(t):
            li = dist_project(t["lineitem"], ["l_orderkey", "l_suppkey",
                                              "l_extendedprice"])
            orders = dist_project(t["orders"], ["o_orderkey", "o_orderdate"])
            return [dist_join_streaming(li, orders, cfg, chunks=3),
                    dist_ops.dist_groupby_fused(t["lineitem"], ["l_orderkey"],
                                                W.FUSED_AGGS)]
        for got, ref in zip(ops(tables), ops(want)):
            assert port_rows(got, ordered=True) == port_rows(ref, ordered=True)
            assert got.cap == ref.cap
        tplan.clear_plan_cache()
        q5 = lambda c: (lambda t: tpch_queries.QUERIES["q5"](c, t))  # noqa
        got = ctx.optimize(q5(ctx), tables)
        ref = tpch_queries.QUERIES["q5"](sim, want)
        assert_rows_close(port_rows(got, ordered=True),
                          port_rows(ref, ordered=True),
                          float_rtols(got, f64=1e-9))
    finally:
        tplan.clear_plan_cache()
        ctx.finalize()


@pytest.mark.gpu
def test_plan_check_makes_no_nccl_call_on_card(card, tmp_path):
    """``plan_check.validate`` of Q5 and Q21 on the NCCL context's tables
    makes no call into the communicator (the meta view's communicator
    returns meta tensors), launches nothing and reads nothing."""
    from cylon_tpu_torch.analysis import plan_check
    ctx, tables, _, _ = _nccl_tpch(tmp_path)
    trace.enable_counters()
    try:
        for q in ("q5", "q21"):
            op = lambda t, q=q: tpch_queries.QUERIES[q](ctx, t)  # noqa: E731
            op(tables)  # the dimension probes' host columns
            trace.reset()
            calls, launches = ctx.comm.calls, hash_cuda.launches
            rep = plan_check.validate(op, tables,
                                      concrete=("nation", "region"))
            assert rep.ok and rep.nodes, q
            assert ctx.comm.calls == calls, q
            assert hash_cuda.launches == launches, q
            assert trace.counters().get("host.read", 0) == 0, q
    finally:
        trace.disable_counters()
        trace.reset()
        ctx.finalize()


@pytest.mark.gpu
def test_meshprobe_on_card(card, tmp_path):
    """The probe on ``cuda:0`` through ``LocalCommunicator`` and through
    NCCL (one process of 4 local ranks): every collective and host leg
    fitted with α >= 0 and β > 0, and two fingerprints for the two
    communicators of one card."""
    from cylon_tpu_torch.parallel import meshprobe
    meshprobe.clear_profiles()
    local = pt.CylonContext(device="cuda", world=4)
    nccl = _nccl_context(tmp_path, 4)
    try:
        profs = [meshprobe.probe(c, sizes=(1 << 16, 1 << 20, 1 << 22))
                 for c in (local, nccl)]
        assert profs[0].fingerprint != profs[1].fingerprint
        assert profs[1].fingerprint[0] == "nccl"
        for prof in profs:
            assert set(prof.bytes_per_s) == set(meshprobe.COLLECTIVES
                                                + meshprobe.TRANSFERS)
            for k in prof.bytes_per_s:
                assert prof.bytes_per_s[k] > 0 and prof.latency_s[k] >= 0
            assert torch.cuda.get_device_name(0) in prof.fingerprint[1]
    finally:
        nccl.finalize()
        meshprobe.clear_profiles()


@pytest.mark.gpu
def test_measured_join_equals_proxy_join_on_card(card):
    """The world-4 HASH join under the measured ranking (a probed
    profile, flat and then under a (2, 2) mesh shape with its per-axis
    fits) equals the proxy-ranked join on the card."""
    from cylon_tpu_torch.parallel import meshprobe
    rng = np.random.default_rng(61)
    n = 1 << 18
    ctx = pt.CylonContext(device="cuda", world=4)
    lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, {
        "k": rng.integers(0, n, n).astype(np.int32),
        "v": rng.random(n).astype(np.float32)}))
    rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, {
        "k": rng.integers(0, n, n).astype(np.int32),
        "w": rng.random(n).astype(np.float32)}))
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, 0, 0,
                        broadcast_threshold=0)
    meshprobe.clear_profiles()
    want = port_rows(dist_join(lt, rt, cfg))
    try:
        for shape in (None, (2, 2)):
            tconfig.set_mesh_shape(shape)
            prof = meshprobe.probe(ctx)
            assert (prof.axis_split is not None) == (shape is not None)
            tconfig.set_cost_measured(True)
            trace.enable_counters()
            trace.reset()
            got = port_rows(dist_join(lt, rt, cfg))
            assert any(k.startswith("shuffle.strategy.")
                       for k in trace.counters())
            tconfig.set_cost_measured(None)
            assert got == want
    finally:
        tconfig.set_cost_measured(None)
        tconfig.set_mesh_shape(None)
        trace.disable_counters()
        trace.reset()
        meshprobe.clear_profiles()


@pytest.mark.gpu
def test_sanitize_guard_bites_on_card(card):
    """Under ``config.sanitize()`` a ``.item()`` inside a span raises on
    the card (not without sanitize), the sanctioned reads pass, and the
    sync debug mode is back to its prior value after the scope."""
    from cylon_tpu_torch.ops.compact import read_host
    x = torch.arange(1024, device=card)
    prior = torch.cuda.get_sync_debug_mode()
    with trace.span("gpu.sanitize.plain"):
        assert x[3].item() == 3
    with tconfig.sanitize():
        with pytest.raises(RuntimeError, match="synchroniz"):
            with trace.span("gpu.sanitize.item"):
                x[3].item()
        assert torch.cuda.get_sync_debug_mode() == prior
        with trace.span_sync("gpu.sanitize.read") as sp:
            y = x * 2
            sp.sync(y)
            assert list(read_host(y[:3])) == [0, 2, 4]
    assert torch.cuda.get_sync_debug_mode() == prior


@pytest.mark.gpu
def test_sanitize_nan_trap_on_card(card):
    """The NaN trap names the producing op on the card; a NaN that a
    later op masks away inside the span does not trip it."""
    with tconfig.sanitize():
        with pytest.raises(FloatingPointError, match=r"aten\.log"):
            with trace.span("gpu.sanitize.nan"):
                y = torch.log(torch.full((16,), -1.0, device=card))
        a = torch.rand(1 << 16, device=card)
        b = torch.where(torch.arange(1 << 16, device=card) % 2 == 0, 0.0, a)
        with trace.span("gpu.sanitize.masked"):
            out = torch.where(b != 0, a / b, 0.0)
    assert not torch.isnan(out).any()
    del y


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["hash", "sort"])
def test_join_under_sanitize_equals_join_on_card(card, alg):
    """The world-4 join on the card under ``config.sanitize()`` (the
    guard and the NaN trap over every span body) equals the join without
    it, shard for shard."""
    rng = np.random.default_rng(71)
    n = 1 << 18
    ctx = pt.CylonContext(device="cuda", world=4)
    lt = DTable.from_table(ctx, pt.Table.from_columns(ctx, {
        "k": rng.integers(0, n, n).astype(np.int32),
        "v": rng.random(n).astype(np.float32)}))
    rt = DTable.from_table(ctx, pt.Table.from_columns(ctx, {
        "k": rng.integers(0, n, n).astype(np.int32),
        "w": rng.random(n).astype(np.float32)}))
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm(alg), 0, 0,
                        broadcast_threshold=0)
    want = port_rows(dist_join(lt, rt, cfg), ordered=True)
    with tconfig.sanitize():
        got = dist_join(lt, rt, cfg)
    assert port_rows(got, ordered=True) == want


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", [2, 20, 5000])
def test_bincount_forms_on_card(card, nbins):
    """``ops/compact.bincount`` on the card, one case per form it picks by
    the bin count (masked sums, float32 histc, scatter-add): equal to
    ``torch.bincount`` for int32 and int64 lanes, flat and per shard,
    and no host read (it runs inside a sanitized span)."""
    from cylon_tpu_torch.ops.compact import bincount
    gen = torch.Generator(device=card)
    gen.manual_seed(nbins)
    for dtype in (torch.int32, torch.int64):
        x = torch.randint(0, nbins + 1, (1 << 20,), generator=gen,
                          device=card, dtype=dtype)
        for lane in (x, x.view(8, -1)):
            with tconfig.sanitize():
                with trace.span("gpu.bincount"):
                    got = bincount(lane, nbins)
            want = torch.stack([torch.bincount(r.long(),
                                               minlength=nbins + 1)[:nbins]
                                for r in lane.reshape(-1, lane.shape[-1])])
            assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.gpu
def test_served_window_under_sanitize_on_card(card):
    """A served window under ``config.sanitize()``.  The guard is one
    setting of the process: while a span body on another thread is
    guarded, a ``.item()`` on the client's own thread raises too, and it
    passes once no body is guarded.  ``sanitize()`` warned once that
    worker threads run; the served rows equal the direct run's."""
    import threading

    from cylon_tpu_torch import logging as glog
    from cylon_tpu_torch.serve import ServeSession
    ctx, dt = _serve_fact(card)
    want = _sorted_rows(_serve_q({"fact": dt}).to_table())
    x = torch.arange(8, device=card)
    prior = torch.cuda.get_sync_debug_mode()
    key = ("config.sanitize", "worker threads")
    glog.reset_warn_once(key)
    inside, release = threading.Event(), threading.Event()

    def hold():
        with trace.span("gpu.sanitize.hold"):
            inside.set()
            release.wait(60)

    with ServeSession(ctx, tables={"fact": dt}, batch_window_ms=2.0,
                      views=False) as s:
        with tconfig.sanitize():
            assert not glog.warn_once(key, "already warned by sanitize()")
            got = s.submit(_serve_q, export=lambda r: r.to_table(),
                           label="client").result(timeout=300)
            th = threading.Thread(target=hold)
            th.start()
            assert inside.wait(60)
            try:
                with pytest.raises(RuntimeError, match="synchroniz"):
                    x[3].item()
            finally:
                release.set()
                th.join()
    glog.reset_warn_once(key)
    assert torch.cuda.get_sync_debug_mode() == prior
    assert x[3].item() == 3
    assert_rows_close(_sorted_rows(got), want, [0, 1e-12, 0])


# ---------------------------------------------------------------------------
# the one-command gate (analysis/ci.py, analysis/benchdiff.py) on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_ci_every_stage_on_card(card, capsys):
    """``ci.main`` on the card at its defaults (world 8, SF 0.002): it
    exits 0, stages 1-13 run and none of them skips; stage 14 skips for
    want of ``--baseline``."""
    from cylon_tpu_torch.analysis import ci
    seen = []
    assert ci.main(["--device", "cuda"],
                   on_stage=lambda *r: seen.append(r)) == 0
    assert [(n, rc) for n, _, rc, _ in seen] == \
        [(n, 0) for n in range(1, 14)]
    out = capsys.readouterr()
    skips = [ln for ln in out.out.splitlines() if "skipped" in ln]
    assert skips == ["== ci stage 14/14: benchdiff == "
                     "(no --baseline; skipped)"], out.out
    assert "ci: CLEAN" in out.out


@pytest.mark.gpu
def test_benchdiff_cli_on_card(card, tmp_path):
    """``python -m cylon_tpu_torch.analysis.benchdiff`` in a subprocess:
    0 on self against self, 1 naming the regressed key, 2 on usage."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    def art(name, ms):
        p = tmp_path / name
        p.write_text(json.dumps({"metric": "dist_join_rows_per_sec",
                                 "value": 5e7,
                                 "detail": {"tpch_q5_ms": ms}}) + "\n")
        return str(p)

    old, new = art("old.json", 100.0), art("new.json", 250.0)
    root = Path(__file__).resolve().parent.parent

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "cylon_tpu_torch.analysis.benchdiff",
             *argv], cwd=root, capture_output=True, text=True, timeout=120)

    assert run(old, old).returncode == 0
    bad = run("--baseline", old, new)
    assert bad.returncode == 1
    assert "tpch_q5_ms" in bad.stdout and "REGRESSED" in bad.stdout
    assert run(old).returncode == 2


@pytest.mark.gpu
def test_java_launcher_on_card(card, tmp_path):
    """The launcher spawned with the Java binding's exact argv
    (``-m pycylon.java_gateway mpi``) runs the port's gateway on the card
    at world 8: a distributed HASH join and union of two seeded CSVs equal
    pandas, and shutdown exits 0."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    import pandas as pd

    launcher = (Path(__file__).resolve().parent.parent / "cylon_tpu_torch"
                / "pycylon" / "java_launcher.py")
    rng = np.random.default_rng(5)
    dfs = [pd.DataFrame({"k": rng.integers(0, 500, 4000),
                         "v": np.round(rng.random(4000), 6)})
           for _ in range(2)]
    paths = []
    for i, df in enumerate(dfs):
        paths.append(str(tmp_path / f"t{i}.csv"))
        df.to_csv(paths[-1], index=False)
    # stderr to a file: an unread pipe fills with log lines and blocks
    # the gateway mid-reply
    err = (tmp_path / "gateway.err").open("w+")
    p = subprocess.Popen([str(launcher), "-m", "pycylon.java_gateway", "mpi"],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=err, text=True, cwd=tmp_path)

    def rpc(**req):
        p.stdin.write(json.dumps(req) + "\n")
        p.stdin.flush()
        line = p.stdout.readline()
        if not line:
            err.seek(0)
        assert line, err.read()[-2000:]
        return json.loads(line)

    try:
        a, b = (rpc(op="from_csv", path=x)["id"] for x in paths)
        j = rpc(op="join", left=a, right=b, join_type="inner",
                algorithm="hash", distributed=True)
        assert rpc(op="rows", id=j["id"])["value"] == \
            len(dfs[0].merge(dfs[1], on="k"))
        u = rpc(op="union", left=a, right=b, distributed=True)
        assert rpc(op="rows", id=u["id"])["value"] == \
            len(pd.concat(dfs).drop_duplicates())
        s = rpc(op="select_expr", id=a, expr="k > 250")
        assert rpc(op="rows", id=s["id"])["value"] == \
            int((dfs[0]["k"] > 250).sum())
        assert rpc(op="shutdown") == {"ok": True, "shutdown": True}
        assert p.wait(timeout=120) == 0
    finally:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
        err.close()
