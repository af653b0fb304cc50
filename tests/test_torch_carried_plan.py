"""The carried sort-join plan (``ops/join.sort_join_plan_carried`` +
``plan_gather_carried``) against the JAX package's, and against the
port's plain plan (``sort_join_plan`` + ``plan_indices`` + ``take_many``)
on the same inputs, for every join type: duplicate keys with unmatched
rows on both sides, padded blocks (counts below the length) at a
capacity above the count, nullable keys and several output leaves with
validity.  A statically empty side takes the index path; there the JAX
package's carried functions are not defined for every join type (they
assume callers route it), so the reference is its index path.  Outputs
compare on the rows below the count: validity exactly, data where
valid; rows past the count are unspecified."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import gather as jgather
from cylon_tpu.ops import join as jjoin

from cylon_tpu_torch.ops import gather as tgather
from cylon_tpu_torch.ops import join as tjoin

HOWS = ["inner", "left", "right", "full_outer"]
FILL = {"inner": (False, False), "left": (False, True),
        "right": (True, False), "full_outer": (True, True)}


def _inputs(case, seed=0):
    """(left keys, left validity, right keys, right validity, left leaves,
    right leaves, l_count, r_count) as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_l, n_r = {"empty-left": (0, 120), "empty-right": (150, 0),
                "empty-both": (0, 0)}.get(case, (300, 200))
    lk = rng.integers(0, 60, n_l).astype(np.int32)
    rk = rng.integers(20, 90, n_r).astype(np.int32)
    lv = rv = None
    ll, rl = [(lk, None)], [(rk, None)]
    lc = rc = None
    if case == "padded":
        lc, rc = 250, 150
    if case == "nullable":
        lv, rv = rng.random(n_l) > 0.15, rng.random(n_r) > 0.15
        ll = [(lk, lv), (rng.random(n_l).astype(np.float32), None),
              (rng.integers(-9, 9, n_l).astype(np.int64),
               rng.random(n_l) > 0.3)]
        rl = [(rk, rv), (rng.integers(0, 99, n_r).astype(np.int16),
                         rng.random(n_r) > 0.5)]
    return lk, lv, rk, rv, ll, rl, lc, rc


def _host(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(ll, conv):
    return [(conv(d), None if v is None else conv(v)) for d, v in ll]


def _jax_carried(inp, how, cap):
    lk, lv, rk, rv, ll, rl, lc, rc = inp
    J = jnp.asarray
    plan = jjoin.sort_join_plan_carried(
        (J(lk),), (None if lv is None else J(lv),), (J(rk),),
        (None if rv is None else J(rv),), how, lc, rc,
        _leaves(ll, J), _leaves(rl, J))
    return jjoin.plan_gather_carried(*plan, how, cap, lc, rc)


def _jax_indexed(inp, how, cap):
    lk, lv, rk, rv, ll, rl, lc, rc = inp
    J = jnp.asarray
    plan = jjoin.sort_join_plan(
        (J(lk),), (None if lv is None else J(lv),), (J(rk),),
        (None if rv is None else J(rv),), how, lc, rc)
    li, ri, n = jjoin.plan_indices(plan, how, cap, lc, rc)
    fl, fr = FILL[how]
    return (jgather.take_many(_leaves(ll, J), li, fill_null=fl),
            jgather.take_many(_leaves(rl, J), ri, fill_null=fr), n)


def _port(inp, how, cap, carried):
    lk, lv, rk, rv, ll, rl, lc, rc = inp
    T = torch.from_numpy
    keys = ((T(lk),), (None if lv is None else T(lv),), (T(rk),),
            (None if rv is None else T(rv),))
    if carried:
        plan = tjoin.sort_join_plan_carried(
            *keys, how, lc, rc, _leaves(ll, T), _leaves(rl, T))
        return tjoin.plan_gather_carried(*plan, how, cap, lc, rc)
    plan = tjoin.sort_join_plan(*keys, how, lc, rc)
    li, ri, n = tjoin.plan_indices(plan, how, cap, lc, rc)
    fl, fr = FILL[how]
    return (tgather.take_many(_leaves(ll, T), li, fill_null=fl),
            tgather.take_many(_leaves(rl, T), ri, fill_null=fr), n)


def _same(got, want, what):
    n = int(want[2])
    assert int(got[2]) == n, what
    for side in (0, 1):
        assert len(got[side]) == len(want[side]), what
        for j, ((gd, gv), (wd, wv)) in enumerate(zip(got[side], want[side])):
            gd, gv, wd, wv = (_host(gd)[:n], _host(gv), _host(wd)[:n],
                              _host(wv))
            assert gd.dtype == wd.dtype, (what, side, j)
            assert (gv is None) == (wv is None), (what, side, j)
            if wv is None:
                np.testing.assert_array_equal(gd, wd, str((what, side, j)))
            else:
                gv, wv = gv[:n], wv[:n]
                np.testing.assert_array_equal(gv, wv, str((what, side, j)))
                np.testing.assert_array_equal(gd[wv], wd[wv],
                                              str((what, side, j)))
    return n


@pytest.mark.parametrize("case", ["duplicates", "padded", "nullable",
                                  "empty-left", "empty-right",
                                  "empty-both"])
@pytest.mark.parametrize("how", HOWS)
def test_carried_plan_equals_jax_and_plain(how, case):
    inp = _inputs(case)
    cap = 4096  # above every case's count
    got = _port(inp, how, cap, carried=True)
    if case.startswith("empty"):
        n = _same(got, _jax_indexed(inp, how, cap), "jax index path")
    else:
        n = _same(got, _jax_carried(inp, how, cap), "jax carried")
        # the inputs leave unmatched rows on both sides
        assert 0 < int(_port(inp, "inner", cap, True)[2]) < n or \
            how == "inner"
    assert n < cap
    assert _same(got, _port(inp, how, cap, carried=False), "port plain") \
        == n


@pytest.mark.parametrize("how", HOWS)
def test_carried_plan_layout(how):
    """The plan is in probe orientation (``right`` swaps), the probe
    leaves are in merged-sort order ``[n]`` and the build leaves in build
    order ``[n_build]``, as the JAX package lays them out."""
    lk, lv, rk, rv, ll, rl, lc, rc = _inputs("nullable", seed=4)
    T, J = torch.from_numpy, jnp.asarray
    plan, probe, build = tjoin.sort_join_plan_carried(
        (T(lk),), (T(lv),), (T(rk),), (T(rv),), how, lc, rc,
        _leaves(ll, T), _leaves(rl, T))
    jplan, jprobe, jbuild = jjoin.sort_join_plan_carried(
        (J(lk),), (J(lv),), (J(rk),), (J(rv),), how, lc, rc,
        _leaves(ll, J), _leaves(rl, J))
    n_probe, n_build = (len(rk), len(lk)) if how == "right" else \
        (len(lk), len(rk))
    assert len(plan) == len(jplan) == (6 if how == "full_outer" else 5)
    assert plan[0].shape[0] == n_probe + n_build
    assert plan[4].shape[0] == n_build
    for a, b in zip(plan, jplan):
        np.testing.assert_array_equal(_host(a), _host(b))
    for mine, ref, n in ((probe, jprobe, n_probe + n_build),
                         (build, jbuild, n_build)):
        assert len(mine) == len(ref)
        for (d, v), (jd, jv) in zip(mine, ref):
            assert d.shape[0] == n
            np.testing.assert_array_equal(_host(d), _host(jd))
            assert (v is None) == (jv is None)
            if v is not None:
                np.testing.assert_array_equal(_host(v), _host(jv))
