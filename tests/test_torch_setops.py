"""Set-operation parity: the port's ``set_op_indices`` (ops/setops.py),
``compute.union`` / ``intersect`` / ``subtract`` / ``unique`` and
``dist_union`` / ``dist_intersect`` / ``dist_subtract`` against the JAX
package's, on the same numpy inputs.  Index arrays and counts must be
equal element for element; tables row for row, in order; distributed
results shard for shard, with the same ``cap`` and ``counts``."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import cylon_tpu as ct
from cylon_tpu import compute as jcompute
from cylon_tpu.ops import setops as jso
from cylon_tpu.parallel import dist_intersect as jdist_intersect
from cylon_tpu.parallel import dist_subtract as jdist_subtract
from cylon_tpu.parallel import dist_union as jdist_union

import cylon_tpu_torch as pt
from cylon_tpu_torch import compute as tcompute
from cylon_tpu_torch.ops import hash_cuda
from cylon_tpu_torch.ops import setops as tso
from cylon_tpu_torch.parallel import dist_intersect as tdist_intersect
from cylon_tpu_torch.parallel import dist_subtract as tdist_subtract
from cylon_tpu_torch.parallel import dist_union as tdist_union

from test_torch_common import jax_rows, jax_trace_shim, port_rows, schema  # noqa: F401
from test_torch_dist_join import _both_dtables, _same

OPS = ["union", "intersect", "subtract"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows_np(rng, n, nulls=0.2):
    """Two key-like columns with many repeated rows, NaN, ±0.0 and
    nulls (random bytes under the null slots of the int column)."""
    a = rng.integers(0, 4, n).astype(np.int64)
    f = rng.choice(np.array([np.nan, -0.0, 0.0, 1.0], np.float32), n)
    va = rng.random(n) >= nulls
    return [a, f], [va, None]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("padded", [False, True])
def test_set_op_indices_matches_jax(op, padded):
    rng = np.random.default_rng(60)
    n_a, n_b = 70, 50
    cols, vals = _rows_np(rng, n_a + n_b)
    valid = (np.concatenate([np.arange(n_a) < 55, np.arange(n_b) < 41])
             if padded else None)
    jgot = jso.set_op_indices(tuple(jnp.asarray(c) for c in cols),
                              tuple(None if v is None else jnp.asarray(v)
                                    for v in vals), n_a, op,
                              valid=None if valid is None else jnp.asarray(valid))
    tgot = tso.set_op_indices([torch.from_numpy(c) for c in cols],
                              [None if v is None else torch.from_numpy(v)
                               for v in vals], n_a, op,
                              valid=None if valid is None else torch.from_numpy(valid))
    for got, want in zip(tgot, jgot):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def _tables(rng, n_a, n_b, overlap=0.5):
    """A and B with shared rows, in-table duplicates, NaN payloads,
    nullable ints and dictionary strings."""
    def side(n, seed_rows):
        k = rng.integers(0, 6, n)
        s = [f"s{v % 3}" for v in rng.integers(0, 9, n)]
        f = rng.choice(np.array([np.nan, 0.5, -0.0, 0.0]), n)
        if seed_rows is not None:
            m = min(n, int(overlap * n))
            k[:m], f[:m] = seed_rows[0][:m], seed_rows[2][:m]
            s[:m] = seed_rows[1][:m]
        return (k, s, f)
    ra = side(n_a, None)
    rb = side(n_b, ra if n_a else None)

    def table(rows, n):
        k, s, f = rows
        return pa.table({"k": pa.array(k, pa.int64(), mask=rng.random(n) < 0.1),
                         "s": pa.array(s, pa.string()),
                         "f": pa.array(f, pa.float64())})
    return table(ra, n_a), table(rb, n_b)


def _port(at):
    return pt.Table.from_arrow(pt.CylonContext(device="cpu"), at)


@pytest.mark.parametrize("op", OPS + ["unique"])
@pytest.mark.parametrize("n_a,n_b", [(90, 70), (0, 40), (40, 0), (0, 0)])
def test_compute_set_ops_match_jax(ctx, op, n_a, n_b):
    at, bt = _tables(np.random.default_rng(61), n_a, n_b)
    ja, jb = ct.Table.from_arrow(ctx, at), ct.Table.from_arrow(ctx, bt)
    ta, tb = _port(at), _port(bt)
    if op == "unique":
        want, got = jcompute.unique(ja), tcompute.unique(ta)
    else:
        want = getattr(jcompute, op)(ja, jb)
        got = getattr(tcompute, op)(ta, tb)
    assert schema(got) == schema(want)
    assert port_rows(got, ordered=True) == jax_rows(want, ordered=True)


def test_compute_set_op_rejects_other_schema():
    a = _port(pa.table({"k": pa.array([1, 2], pa.int64())}))
    b = _port(pa.table({"k": pa.array([1.0, 2.0], pa.float64())}))
    with pytest.raises(pt.CylonError):
        tcompute.union(a, b)


_JDIST = {"union": jdist_union, "intersect": jdist_intersect,
          "subtract": jdist_subtract}
_TDIST = {"union": tdist_union, "intersect": tdist_intersect,
          "subtract": tdist_subtract}


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("op", OPS)
def test_dist_set_ops_match_jax(ctx, dctx, jax_trace_shim, world, op):
    at, bt = _tables(np.random.default_rng(62), 230, 180)
    ja, ta = _both_dtables(ctx, dctx, world, at)
    jb, tb = _both_dtables(ctx, dctx, world, bt)
    want = _JDIST[op](ja, jb)
    before = hash_cuda.launches
    got = _TDIST[op](ta, tb)
    assert hash_cuda.launches == before  # CPU tensors: the plain version
    _same(got, want)


@pytest.mark.parametrize("op", OPS)
def test_dist_set_ops_empty_side_match_jax(ctx, dctx, jax_trace_shim, op):
    at, bt = _tables(np.random.default_rng(63), 120, 0)
    ja, ta = _both_dtables(ctx, dctx, 8, at)
    jb, tb = _both_dtables(ctx, dctx, 8, bt)
    _same(_TDIST[op](ta, tb), _JDIST[op](ja, jb))
    _same(_TDIST[op](tb, ta), _JDIST[op](jb, ja))
