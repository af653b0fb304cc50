"""TPC-H on the host generator's tables, part b: each query on the
port's ``DTable.from_pandas(generate(0.002, seed=7))`` at world 8 equals
the JAX package's on its own ``generate(0.002, seed=7)`` frames
(``tpch_torch_parity.run_host``; the rules of ``check_query``)."""
import pytest

from tpch_torch_parity import check_query, run_host

NAMES = ("q9", "q10", "q11", "q12", "q13", "q14", "q15")


@pytest.fixture(scope="module")
def results():
    return run_host(NAMES)


@pytest.mark.parametrize("q", NAMES)
def test_query_on_host_tables_matches_jax(results, q):
    check_query(results, q, 8)
