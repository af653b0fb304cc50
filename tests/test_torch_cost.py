"""The port's exchange cost model (``cylon_tpu_torch/parallel/cost.py``)
against the JAX package's (``cylon_tpu/parallel/cost.py``): every
``price_*``, ``chunk_plan``, ``hier_plan``, ``enumerate_strategies`` and
``choose`` equal on count matrices drawn by hypothesis (derandomized, so
every run draws the same cases), and the exact budget-boundary flips of
the JAX package's own tests.  Both modules are numpy only."""
import dataclasses

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cylon_tpu.parallel import cost as jcost
from cylon_tpu.parallel import shuffle as jshuffle

from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import shuffle as tshuffle

SETTINGS = settings(derandomize=True, max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _t(price):
    """A StrategyPrice as a plain tuple (the two packages' classes
    differ): the port's fields, host-staged bytes included."""
    return tuple(getattr(price, f.name)
                 for f in dataclasses.fields(tcost.StrategyPrice))


@st.composite
def exchanges(draw):
    """(P, cap, counts [P, P], rbytes, budget, split): skewed or
    uniform count matrices, a split that tiles P when it can."""
    P = draw(st.sampled_from([1, 2, 4, 8]))
    shape = draw(st.sampled_from(["uniform", "hot", "sparse", "diag"]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    hi = draw(st.sampled_from([1, 9, 300, 5000]))
    c = rng.integers(0, hi + 1, (P, P)).astype(np.int64)
    if shape == "hot":
        c[:, rng.integers(0, P)] += rng.integers(hi, 4 * hi + 2)
    elif shape == "sparse":
        c *= rng.random((P, P)) < 0.3
    elif shape == "diag":
        c = np.diag(np.diag(c))
    cap = int(max(c.sum(axis=1).max(initial=0), 1)
              + draw(st.integers(0, 64)))
    rbytes = draw(st.sampled_from([1, 4, 9, 12, 40]))
    ss = jcost.single_shot_bytes(P, jcost.exchange_sizes(c)[:2], rbytes)
    budget = max(int(ss * draw(st.sampled_from(
        [0.001, 0.1, 0.3, 0.5, 0.9, 0.999, 1.0, 2.0]))), 1)
    splits = [(s, P // s) for s in (2, 4) if P % s == 0 and P // s > 1]
    split = draw(st.sampled_from([None] + splits))
    return P, cap, c, rbytes, budget, split


@SETTINGS
@given(exchanges())
def test_prices_equal_jax(ex):
    P, cap, c, rbytes, budget, split = ex
    jb, jo, jr = jcost.exchange_sizes(c)
    tb, to, tr = tcost.exchange_sizes(c)
    assert (tb, to) == (jb, jo) and np.array_equal(tr, jr)
    assert tcost.single_shot_bytes(P, (jb, jo), rbytes) == \
        jcost.single_shot_bytes(P, (jb, jo), rbytes)
    pairs = [
        (tcost.price_single_shot(P, jb, jo, rbytes),
         jcost.price_single_shot(P, jb, jo, rbytes)),
        (tcost.price_ring(P, jb, jo, rbytes),
         jcost.price_ring(P, jb, jo, rbytes)),
        (tcost.price_allgather(P, cap, jo, rbytes),
         jcost.price_allgather(P, cap, jo, rbytes)),
        (tcost.price_replicate(P, cap, jo, rbytes),
         jcost.price_replicate(P, cap, jo, rbytes)),
        (tcost.price_chunked(P, c, rbytes, budget),
         jcost.price_chunked(P, c, rbytes, budget)),
    ]
    if split is not None:
        pairs += [
            (tcost.price_hierarchical(P, split, c, rbytes),
             jcost.price_hierarchical(P, split, c, rbytes)),
            (tcost.price_hier_combine(P, split, c, rbytes),
             jcost.price_hier_combine(P, split, c, rbytes))]
        tb1, to1, tb2, tc2 = tcost.hier_plan(P, split, c)
        jb1, jo1, jb2, jc2 = jcost.hier_plan(P, split, c)
        assert (tb1, to1, tb2) == (jb1, jo1, jb2)
        assert np.array_equal(tc2, jc2)
    for got, want in pairs:
        assert _t(got) == _t(want)
        assert _t(tcost.slow_share(got, P, split)) == \
            _t(jcost.slow_share(want, P, split))
        assert got.describe() == want.describe()
    assert tcost.chunk_plan(P, c, rbytes, budget) == \
        jcost.chunk_plan(P, c, rbytes, budget)


@SETTINGS
@given(exchanges(), st.booleans(), st.sampled_from(
    [None, "single-shot", "chunked", "ring", "allgather", "hierarchical",
     "hierarchical-combine"]))
def test_enumerate_and_choose_equal_jax(ex, staged_ok, forced):
    P, cap, c, rbytes, budget, split = ex
    tc = tcost.enumerate_strategies(P, cap, c, rbytes, budget,
                                    staged_ok=staged_ok, split=split)
    jc = jcost.enumerate_strategies(P, cap, c, rbytes, budget,
                                    staged_ok=staged_ok, split=split)
    assert [_t(x) for x in tc] == [_t(x) for x in jc]
    tp, tr, tf = tcost.choose(tc, budget, forced)
    jp, jr, jf = jcost.choose(jc, budget, forced)
    assert (_t(tp), tr, tf) == (_t(jp), jr, jf)
    assert tcost.strategy_counter(tc[-1].strategy) == \
        jcost.strategy_counter(jc[-1].strategy)


@SETTINGS
@given(exchanges(), st.booleans())
def test_shuffle_chooser_equal_jax(ex, combine):
    """The shuffles' ``_choose`` (fast path included) on the same count
    matrix and budget: the same price, reason and feasibility."""
    P, cap, c, rbytes, budget, _ = ex
    spec = object() if combine else None
    got = tshuffle._choose(P, cap, c, rbytes, budget, spec)
    want = jshuffle._choose(P, cap, c, rbytes, budget, spec)
    assert (_t(got[0]),) + got[1:] == (_t(want[0]),) + want[1:]


def test_catalogue_and_constants_equal_jax():
    assert tcost.STRATEGIES == jcost.STRATEGIES
    for name in ("SINGLE_SHOT", "CHUNKED", "RING", "ALLGATHER",
                 "REPLICATE", "STAGED_SPILL", "HIERARCHICAL",
                 "HIER_COMBINE", "_RING_ROUTING_BYTES", "_PID_BYTES"):
        assert getattr(tcost, name) == getattr(jcost, name)


def _counts(P, maxcell, hot_col=0):
    c = np.zeros((P, P), np.int64)
    c[:, hot_col] = maxcell
    return c


@pytest.mark.parametrize("cost", [tcost, jcost], ids=["port", "jax"])
def test_budget_boundary_flips_choice_at_the_priced_byte(cost):
    """Price exactly AT the budget is feasible; one byte under flips
    the choice off the single-shot fast path (both packages)."""
    P, counts, rbytes = 8, _counts(8, 1024), 8
    block, outcap, _ = cost.exchange_sizes(counts)
    ss = cost.single_shot_bytes(P, (block, outcap), rbytes)

    def pick(budget):
        return cost.choose(
            cost.enumerate_strategies(P, 1024, counts, rbytes, budget),
            budget)

    at, _, feas_at = pick(ss)
    under, _, feas_under = pick(ss - 1)
    assert at.strategy == cost.SINGLE_SHOT and feas_at
    assert under.strategy != cost.SINGLE_SHOT and feas_under


@pytest.mark.parametrize("cost", [tcost, jcost], ids=["port", "jax"])
def test_choice_order_rounds_then_wire_then_catalogue(cost):
    """The one-hot-target band: allgather (1 round) beats ring beats
    chunked as the budget tightens; below every floor, best-effort
    chunked (both packages)."""
    P, counts, rbytes = 8, _counts(8, 1024), 8

    def pick(budget):
        return cost.choose(
            cost.enumerate_strategies(P, 1024, counts, rbytes, budget),
            budget)

    by_name = {c.strategy: c for c in cost.enumerate_strategies(
        P, 1024, counts, rbytes, 20_000)}
    ss, ag = by_name[cost.SINGLE_SHOT], by_name[cost.ALLGATHER]
    ring = by_name[cost.RING]
    assert ring.peak_bytes < ag.peak_bytes < ss.peak_bytes
    choice, reason, feasible = pick(ss.peak_bytes - 1)
    assert choice.strategy == cost.ALLGATHER and feasible
    assert "over the" in reason
    choice, _, feasible = pick(30_000)
    assert choice.strategy == cost.RING and feasible
    assert choice.rounds == P - 1
    choice, reason, feasible = pick(10)
    assert choice.strategy == cost.CHUNKED and not feasible
    assert "best-effort" in reason


def test_combine_spec_restricts_to_foldable_strategies():
    """A combine-spec payload can only run lowerings that fold by key:
    the same answer as the JAX chooser."""
    got, _, _ = tshuffle._choose(8, 1024, _counts(8, 1024), 8,
                                 budget=20_000, combine=object())
    want, _, _ = jshuffle._choose(8, 1024, _counts(8, 1024), 8,
                                  budget=20_000, combine=object())
    assert got.strategy == want.strategy
    assert got.strategy in (tcost.SINGLE_SHOT, tcost.CHUNKED)


def test_forced_strategy_knob_validation(monkeypatch):
    from cylon_tpu import config as jconfig
    from cylon_tpu_torch.status import CylonError
    monkeypatch.delenv("CYLON_EXCHANGE_STRATEGY", raising=False)
    for bad in ("nope", 1, True):
        with pytest.raises(CylonError):
            tconfig.set_exchange_strategy(bad)
    # the host-tier lowering is in the port: accepted like the others
    prev = tconfig.set_exchange_strategy("staged-spill")
    try:
        assert tconfig.exchange_strategy() == "staged-spill"
    finally:
        tconfig.set_exchange_strategy(prev)
    assert tconfig.exchange_strategy() is None
    for name in ("ring", "allgather", "hierarchical", "staged-spill"):
        monkeypatch.setenv("CYLON_EXCHANGE_STRATEGY", name)
        assert tconfig.exchange_strategy() == jconfig.exchange_strategy()
    monkeypatch.setenv("CYLON_EXCHANGE_STRATEGY", "bogus")
    with pytest.raises(CylonError):
        tconfig.exchange_strategy()
    monkeypatch.delenv("CYLON_EXCHANGE_STRATEGY")
    prev = tconfig.set_exchange_strategy("ring")
    try:
        assert tconfig.exchange_strategy() == "ring"
    finally:
        tconfig.set_exchange_strategy(prev)
    assert tconfig.exchange_strategy() is None


def test_mesh_shape_and_timeout_knobs_equal_jax(monkeypatch):
    from cylon_tpu import config as jconfig
    from cylon_tpu_torch.status import CylonError
    for env in ("2x4", "4X2", "1,8"):
        monkeypatch.setenv("CYLON_MESH_SHAPE", env)
        assert tconfig.mesh_shape() == jconfig.mesh_shape()
    monkeypatch.setenv("CYLON_MESH_SHAPE", "2by4")
    with pytest.raises(CylonError):
        tconfig.mesh_shape()
    monkeypatch.delenv("CYLON_MESH_SHAPE")
    for bad in ((2,), (0, 4), (2, 4.0), True):
        with pytest.raises(CylonError):
            tconfig.set_mesh_shape(bad)
    assert tconfig.set_mesh_shape([2, 2]) is None
    assert tconfig.set_mesh_shape(None) == (2, 2)
    monkeypatch.setenv("CYLON_EXCHANGE_TIMEOUT_MS", "250")
    assert tconfig.exchange_timeout_ms() == jconfig.exchange_timeout_ms()
    for bad in ("0", "x"):
        monkeypatch.setenv("CYLON_EXCHANGE_TIMEOUT_MS", bad)
        with pytest.raises(CylonError):
            tconfig.exchange_timeout_ms()
    monkeypatch.delenv("CYLON_EXCHANGE_TIMEOUT_MS")
    for bad in (0, -1, 1.5, True):
        with pytest.raises(CylonError):
            tconfig.set_exchange_timeout_ms(bad)


@SETTINGS
@given(exchanges(), st.booleans(), st.sampled_from(
    [None, "single-shot", "chunked", "staged-spill"]))
def test_staged_spill_price_and_choice_equal_jax(ex, staged_ok, forced):
    """``price_staged_spill``, ``enumerate_strategies(spill_ok=True)`` and
    ``choose`` over it: the same prices (host-staged bytes included),
    candidates, choice, reason and feasibility as the JAX package's."""
    P, cap, c, rbytes, budget, split = ex
    assert _t(tcost.price_staged_spill(P, c, rbytes, budget)) == \
        _t(jcost.price_staged_spill(P, c, rbytes, budget))
    assert tcost.price_staged_spill(P, c, rbytes, budget).describe() == \
        jcost.price_staged_spill(P, c, rbytes, budget).describe()
    tc = tcost.enumerate_strategies(P, cap, c, rbytes, budget,
                                    staged_ok=staged_ok, spill_ok=True,
                                    split=split)
    jc = jcost.enumerate_strategies(P, cap, c, rbytes, budget,
                                    staged_ok=staged_ok, spill_ok=True,
                                    split=split)
    assert [_t(x) for x in tc] == [_t(x) for x in jc]
    assert (tcost.STAGED_SPILL in [x.strategy for x in tc]) == (P > 1)
    # every budget band of this matrix, the spill tier's included
    for b in sorted({budget} | {x.peak_bytes for x in tc}
                    | {x.peak_bytes - 1 for x in tc}):
        b = max(b, 1)
        tp, tr, tf = tcost.choose(tc, b, forced)
        jp, jr, jf = jcost.choose(jc, b, forced)
        assert (_t(tp), tr, tf) == (_t(jp), jr, jf)
