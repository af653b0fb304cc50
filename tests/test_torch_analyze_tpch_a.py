"""EXPLAIN ANALYZE of TPC-H Q1-Q12 on both packages at world 8, on
``generate(0.002, seed=7)`` with the broadcast threshold at 256
(``tpch_torch_parity`` sets them up): the same results, the same
operators in order with equal depth, decision, bytes moved and rows, and
every counter of the run in the catalogue."""
import pytest

from tpch_torch_parity import analyzed_param, check_analyzed, run_analyzed

NAMES = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10",
         "q11", "q12")


@pytest.fixture(scope="module")
def results():
    return run_analyzed(NAMES)


@analyzed_param(NAMES)
def test_analyzed_query_matches_jax(results, q, world):
    check_analyzed(results, q, world)
