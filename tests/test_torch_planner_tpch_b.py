"""TPC-H Q9-Q15, and Q9 with ``streaming_chunks=3``, through the port's
planner (``ctx.optimize``) against the JAX package's planner, at world 1
and 8, on ``generate(0.002, seed=7)`` (``tpch_torch_parity`` holds the
rules)."""
import pytest

from tpch_torch_parity import check_planned, queries_param, run_planned

NAMES = ("q9", "q9_streaming", "q10", "q11", "q12", "q13", "q14", "q15")


@pytest.fixture(scope="module")
def results():
    return run_planned(NAMES)


@queries_param(NAMES)
def test_planned_query_matches_jax(results, q, world):
    check_planned(results, q, world)
