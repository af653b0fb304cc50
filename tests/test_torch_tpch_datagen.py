"""The port's TPC-H generator: ``generate_device`` (here on the CPU) must
equal its numpy ``generate_mirror`` bit for bit at world 1 and 8, the
port's mirror must equal the JAX package's mirror exactly, and the port's
device tables must equal the JAX package's ``generate_device`` within
that package's own tolerance (XLA contracts some float32 operations, so
one-ulp cent differences are allowed on money columns; integers exact).
Dictionaries are sorted."""
import numpy as np
import pandas as pd
import pytest

import cylon_tpu_torch as pt
from cylon_tpu_torch.tpch import datagen_device as dd
from cylon_tpu_torch.tpch.datagen import TABLE_NAMES

from test_torch_common import jax_trace_shim  # noqa: F401

SF = 0.002
SEED = 11


@pytest.fixture(scope="module")
def mirror():
    return dd.generate_mirror(SF, seed=SEED)


@pytest.fixture(scope="module", params=[1, 8])
def device(request):
    ctx = pt.CylonContext(device="cpu", world=request.param)
    return dd.generate_device(ctx, SF, seed=SEED)


def _host(dt):
    tb = dt.to_table()
    return {c.name: (c.data.numpy(), c.dictionary) for c in tb.columns}


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_device_equals_mirror(device, mirror, name):
    tables, dicts = mirror
    got = _host(device[name])
    assert list(got) == list(tables[name])
    for c, (data, dictionary) in got.items():
        want = tables[name][c]
        assert data.dtype == want.dtype, c
        np.testing.assert_array_equal(_bits(data), _bits(want), err_msg=c)
        if c in dicts:
            assert list(dictionary) == list(dicts[c])


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_mirror_equals_jax_mirror(mirror, name):
    from cylon_tpu.tpch import datagen_device as jdd
    jm = jdd.generate_mirror(SF, seed=SEED, tables=[name])[name]
    tables, dicts = mirror
    assert list(jm.columns) == list(tables[name])
    for c in jm.columns:
        v = jm[c]
        got = tables[name][c]
        if isinstance(v.dtype, pd.CategoricalDtype):
            np.testing.assert_array_equal(dicts[c][got].astype(str),
                                          v.astype(str).to_numpy())
        else:
            assert got.dtype == v.to_numpy().dtype, c
            np.testing.assert_array_equal(_bits(got), _bits(v.to_numpy()))


def test_device_matches_jax_device(dctx, jax_trace_shim):
    from cylon_tpu.tpch import datagen_device as jdd
    ctx = pt.CylonContext(device="cpu", world=8)
    ours = dd.generate_device(ctx, SF, seed=SEED)
    theirs = jdd.generate_device(dctx, SF, seed=SEED)
    for name in TABLE_NAMES:
        got = _host(ours[name])
        want = theirs[name]
        np.testing.assert_array_equal(ours[name].counts_host(),
                                      want.counts_host())
        assert ours[name].cap == want.cap
        wt = want.to_table()
        for c in wt.columns:
            a, b = got[c.name][0], np.asarray(c.data)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0.011,
                                           err_msg=f"{name}.{c.name}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c.name}")


def test_dictionaries_sorted(device):
    for name, dt in device.items():
        for c in dt.columns:
            if c.dictionary is not None:
                d = np.asarray(c.dictionary).astype(str)
                assert np.all(d[:-1] <= d[1:]), f"{name}.{c.name}"


def test_mirror_window(mirror):
    """``rows=(lo, hi)`` builds exactly those rows, clipped at the end."""
    tables, _ = mirror
    for name in TABLE_NAMES:
        n = len(next(iter(tables[name].values())))
        lo, hi = max(n - 37, 0), n + 5  # the tail, past the end clipped
        win, _ = dd.generate_mirror(SF, seed=SEED, tables=[name],
                                    rows=(lo, hi))
        for c, v in win[name].items():
            np.testing.assert_array_equal(_bits(v),
                                          _bits(tables[name][c][lo:n]))
