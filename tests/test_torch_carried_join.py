"""``dist_join`` of single-column tables (one int32 key, no validity),
where the JAX package's selector (``_join_copartitioned``: each side
carries at most one array) rides the output through its carried plan,
against the port's plain plan at world 1 and 8.  The port does not carry
(on the H100 the carried plan was no faster), so these hold its plain
path to the JAX package's carried one.  Every shard holds the same rows
in the same order (so the row multisets and, for SORT, the key order are
equal).  A nullable key or a second column takes the plain plan in both
packages; a broadcast join of single-column sides takes the JAX
package's carried one.  Broadcast is pinned off in both packages except
in the broadcast case."""
import numpy as np
import pyarrow as pa
import pytest

import cylon_tpu as ct
from cylon_tpu.parallel import DTable as JDTable
from cylon_tpu.parallel import dist_join as jdist_join

import cylon_tpu_torch as pt
from cylon_tpu_torch.parallel import DTable as TDTable
from cylon_tpu_torch.parallel import dist_join as tdist_join

from test_torch_common import jax_rows, jax_trace_shim, port_rows, schema  # noqa: F401

HOWS = ["inner", "left", "right", "full_outer"]


def _tables(shape, seed=41):
    rng = np.random.default_rng(seed)
    n_l, n_r = 260, 190
    lt = {"k": pa.array(rng.integers(0, 50, n_l).astype(np.int32))}
    rt = {"k": pa.array(rng.integers(15, 70, n_r).astype(np.int32))}
    if shape == "nullable-key":
        lt["k"] = pa.array(rng.integers(0, 50, n_l).astype(np.int32),
                           mask=rng.random(n_l) < 0.1)
    if shape == "second-column":
        rt["w"] = pa.array(rng.random(n_r).astype(np.float32))
    return pa.table(lt), pa.table(rt)


def _both(ctx, dctx, world, at):
    jctx = dctx if world == 8 else ct.CylonContext(
        {"backend": "tpu", "devices": dctx.devices[:world]})
    jt = JDTable.from_table(jctx, ct.Table.from_arrow(ctx, at))
    tctx = pt.CylonContext(device="cpu", world=world)
    return jt, TDTable.from_table(tctx, pt.Table.from_arrow(tctx, at))


def _join(ctx, dctx, world, shape, how, alg, threshold=0):
    lt, rt = _tables(shape)
    jl, tl = _both(ctx, dctx, world, lt)
    jr, tr = _both(ctx, dctx, world, rt)
    want = jdist_join(jl, jr, ct.JoinConfig(
        ct.JoinType(how), ct.JoinAlgorithm(alg), 0, 0,
        broadcast_threshold=threshold))
    got = tdist_join(tl, tr, pt.JoinConfig(
        pt.JoinType(how), pt.JoinAlgorithm(alg), 0, 0,
        broadcast_threshold=threshold))
    return got, want


def _same(got, want):
    assert schema(got) == schema(want)
    np.testing.assert_array_equal(got.counts_host(), want.counts_host())
    assert port_rows(got) == jax_rows(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("alg", ["hash", "sort"])
def test_single_column_join(ctx, dctx, jax_trace_shim, alg, how, world):
    got, want = _join(ctx, dctx, world, "single", how, alg)
    _same(got, want)
    if alg == "sort" and how == "inner":
        # range partitioning: keys ascend across the shards
        flat = [r[0] for shard in port_rows(got, ordered=True)
                for r in shard]
        assert flat == sorted(flat) and flat


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("shape", ["nullable-key", "second-column"])
def test_wider_sides(ctx, dctx, jax_trace_shim, shape, world):
    got, want = _join(ctx, dctx, world, shape, "left", "sort")
    _same(got, want)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_broadcast_single_column_join(ctx, dctx, jax_trace_shim, how):
    """The right side (190 rows) is under the threshold: it is replicated
    and each shard joins its left rows with the replica."""
    got, want = _join(ctx, dctx, 8, "single", how, "hash", threshold=256)
    _same(got, want)
