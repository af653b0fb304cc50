"""TPC-H Q1-Q11 on both packages at world 8, on ``generate(0.002,
seed=7)``, under a tight explicit memory budget (16 KiB per shard, below
most exchanges' single-shot price): the same results, the same
operators with equal decisions, bytes and rows under EXPLAIN ANALYZE, and
the same ``exchange=`` / ``degraded=`` annotations on every node (the
costed chooser degrades the same exchanges to the same lowerings)."""
import pytest

from tpch_torch_parity import analyzed_param, check_budget, run_budget

NAMES = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10",
         "q11")


@pytest.fixture(scope="module")
def results():
    return run_budget(NAMES)


@analyzed_param(NAMES)
def test_query_under_tight_budget_matches_jax(results, q, world):
    check_budget(results, q, world)


def test_some_exchange_degrades(results):
    downgrades = sum(r["got"].totals["counters"].get(
        "shuffle.strategy.downgrades", 0) for r in results.values())
    assert downgrades > 0
