"""Scalar means of narrow columns (``dist_aggregate(..., "mean")`` over
int8, int16, uint8, bool and float16) against numpy, at world 1 and 8.

The JAX package divides by the row count cast to the column's own dtype,
so the count wraps past that dtype's range (an int8 mean over 300 rows
comes out −3.795 where numpy says −0.5567); that is listed as a
reference-side difference, and the port is held to numpy here, not to
the JAX package.  Integer and bool means sum exactly in int64 and divide
once in float64, so they equal numpy's ``sum / count`` exactly; a float16
mean sums per-shard partials in float16 and divides in float16 (stored as
float64, the mean's type), so it is held to numpy's exact mean within 4
float16 ulps (4 · 2^-11 relative)."""
import numpy as np
import pytest
import torch

import cylon_tpu_torch as pt
from cylon_tpu_torch.parallel import DTable, dist_aggregate

CASES = {  # dtype → (rows, values)
    "int8": (300, lambda r, n: r.integers(-128, 128, n).astype(np.int8)),
    "uint8": (300, lambda r, n: r.integers(0, 256, n).astype(np.uint8)),
    "bool": (300, lambda r, n: r.random(n) < 0.5),
    "int16": (40_000,
              lambda r, n: r.integers(-32768, 32768, n).astype(np.int16)),
    "float16": (5_000, lambda r, n: r.random(n).astype(np.float16)),
}


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("dtype", sorted(CASES))
def test_narrow_scalar_mean_matches_numpy(dtype, world):
    n, make = CASES[dtype]
    x = make(np.random.default_rng(17), n)
    ctx = pt.CylonContext(device="cpu", world=world)
    dt = DTable.from_table(ctx, pt.Table.from_columns(ctx, {"x": x}))
    got = dist_aggregate(dt, [("x", "mean"), ("x", "count")])
    assert int(got.column("count_x").data[0]) == n
    mean = got.column("mean_x").data[0]
    assert mean.dtype == torch.float64
    if dtype == "float16":
        exact = float(np.mean(x.astype(np.float64)))
        assert abs(float(mean) - exact) <= 4 * 2.0 ** -11 * abs(exact)
    else:
        want = np.float64(x.astype(np.int64).sum()) / np.float64(n)
        assert float(mean) == float(want)
