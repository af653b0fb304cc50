"""TPC-H Q16-Q22 through the port's planner (``ctx.optimize``) against the
JAX package's planner, at world 1 and 8, on ``generate(0.002, seed=7)``
(``tpch_torch_parity`` holds the rules)."""
import pytest

from tpch_torch_parity import check_planned, queries_param, run_planned

NAMES = ("q16", "q17", "q18", "q19", "q20", "q21", "q22")


@pytest.fixture(scope="module")
def results():
    return run_planned(NAMES)


@queries_param(NAMES)
def test_planned_query_matches_jax(results, q, world):
    check_planned(results, q, world)
