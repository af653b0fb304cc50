"""The host TPC-H generator: the port's ``tpch.generate(scale, seed)``
against the JAX package's ``cylon_tpu.tpch.generate``, frame for frame
and exactly: the same tables in the same order, the same columns in the
same order, dtypes, values, row counts, and for every ``Categorical``
column the same category list and codes."""
import functools

import numpy as np
import pandas as pd
import pytest

import cylon_tpu.tpch as jtpch

import cylon_tpu_torch.tpch as ttpch
from cylon_tpu_torch.tpch import datagen as tdatagen

PAIRS = [(0.002, 7), (0.002, 11), (0.002, 17), (0.01, 42)]
TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region",
          "part", "partsupp")


@functools.lru_cache(maxsize=None)
def _both(scale, seed):
    return ttpch.generate(scale, seed=seed), jtpch.generate(scale, seed=seed)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("scale,seed", PAIRS)
def test_frame_equals_jax(scale, seed, table):
    got, want = _both(scale, seed)
    assert list(got) == list(want) == list(TABLES)
    g, w = got[table], want[table]
    assert list(g.columns) == list(w.columns)
    assert list(g.dtypes) == list(w.dtypes)
    assert len(g) == len(w) > 0
    for c in g.columns:
        if isinstance(w[c].dtype, pd.CategoricalDtype):
            assert list(g[c].cat.categories) == list(w[c].cat.categories), c
            assert g[c].cat.ordered == w[c].cat.ordered, c
            np.testing.assert_array_equal(g[c].cat.codes.to_numpy(),
                                          w[c].cat.codes.to_numpy(), c)
        else:
            a, b = g[c].to_numpy(), w[c].to_numpy()
            assert a.dtype == b.dtype, c
            # bit for bit (a float compare would let -0.0 pass for 0.0)
            np.testing.assert_array_equal(a.view(f"u{a.itemsize}"),
                                          b.view(f"u{b.itemsize}"), c)
    pd.testing.assert_frame_equal(g, w, check_exact=True)


def test_exported_as_the_jax_package_exports_it():
    """``generate`` is a name of ``tpch`` (and of its ``__all__``), with
    the JAX package's signature and default seed; the comment pool
    equals the JAX package's."""
    import inspect

    from cylon_tpu.tpch import datagen as jdatagen

    assert "generate" in ttpch.__all__
    assert ttpch.generate is tdatagen.generate
    assert str(inspect.signature(ttpch.generate)) == \
        str(inspect.signature(jtpch.generate))
    assert tdatagen.COMMENT_POOL == jdatagen._COMMENT_POOL
