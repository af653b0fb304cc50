"""TPC-H Q16-Q22 on the port against the JAX package's, at world 1 and 8,
on ``generate(0.002, seed=7)`` (``tpch_torch_parity`` holds the rules)."""
import pytest

from tpch_torch_parity import check_query, queries_param, run_both

NAMES = ("q16", "q17", "q18", "q19", "q20", "q21", "q22")


@pytest.fixture(scope="module")
def results():
    return run_both(NAMES)


@queries_param(NAMES)
def test_query_matches_jax(results, q, world):
    check_query(results, q, world)
