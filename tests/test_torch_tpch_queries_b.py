"""TPC-H Q9-Q15, and Q9 with ``streaming_chunks=3``, on the port against
the JAX package's, at world 1 and 8, on ``generate(0.002, seed=7)``
(``tpch_torch_parity`` holds the rules)."""
import numpy as np
import pytest
import torch

from cylon_tpu_torch.tpch import queries as tqueries
from cylon_tpu_torch.tpch.datagen import days_to_year

from test_torch_common import port_rows
from tpch_torch_parity import check_query, queries_param, run_both

NAMES = ("q9", "q9_streaming", "q10", "q11", "q12", "q13", "q14", "q15")


@pytest.fixture(scope="module")
def results():
    return run_both(NAMES)


@queries_param(NAMES)
def test_query_matches_jax(results, q, world):
    check_query(results, q, world)


def test_q9_amount_is_separately_rounded():
    """Q9's per-row amount is four separately rounded float32 operations,
    bit for bit numpy's (the JAX package's XLA contracts one of them into
    a fused multiply-add)."""
    rng = np.random.default_rng(9)
    n = 4096
    cols = {"l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
            "l_discount": rng.integers(0, 11, n) / 100,
            "ps_supplycost": np.round(rng.uniform(1, 1000, n), 2),
            "l_quantity": rng.integers(1, 51, n)}
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    got = tqueries._q9_amount({k: torch.from_numpy(v)
                               for k, v in cols.items()}).numpy()
    want = (cols["l_extendedprice"] * (np.float32(1) - cols["l_discount"])
            - cols["ps_supplycost"] * cols["l_quantity"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_q9_streaming_is_not_ported(results):
    """The streaming branch once raised NotImplemented; it now runs the
    streaming join and returns the one-shot query's rows, in order, at
    both worlds."""
    for world in (1, 8):
        one, _, _ = results[("q9", world)]
        streamed, _, _ = results[("q9_streaming", world)]
        assert port_rows(streamed, ordered=True) == port_rows(one,
                                                              ordered=True)


def test_year_column_matches_days_to_year():
    """The queries' on-device year (``torch.searchsorted`` over the year
    bounds) equals the host conversion on every generated date."""
    days = np.arange(0, 2557, dtype=np.int32)
    got = tqueries._year_col({"o_orderdate": torch.from_numpy(days)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), days_to_year(days))
