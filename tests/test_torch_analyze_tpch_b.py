"""EXPLAIN ANALYZE of TPC-H Q13-Q22 on both packages at world 8 (as
``test_torch_analyze_tpch_a.py``), and of Q3 and Q9 through both
planners (``explain(..., analyze=True, optimize=True)``): the same rule
fires, row bytes and plan-cache miss as the JAX package, then a rerun
that hits the port's plan cache."""
import pytest

from tpch_torch_parity import (analyzed_param, check_analyzed,
                               check_analyzed_optimized, run_analyzed)

NAMES = ("q13", "q14", "q15", "q16", "q17", "q18", "q19", "q20", "q21",
         "q22")
OPTIMIZED = ("q3", "q9")


@pytest.fixture(scope="module")
def results():
    return run_analyzed(NAMES)


@pytest.fixture(scope="module")
def optimized():
    return run_analyzed(OPTIMIZED, optimize=True)


@analyzed_param(NAMES)
def test_analyzed_query_matches_jax(results, q, world):
    check_analyzed(results, q, world)


@analyzed_param(OPTIMIZED)
def test_analyzed_optimized_query_matches_jax(optimized, q, world):
    check_analyzed_optimized(optimized, q, world)
