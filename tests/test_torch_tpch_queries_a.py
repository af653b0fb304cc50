"""TPC-H Q1-Q8 on the port against the JAX package's, at world 1 and 8,
on ``generate(0.002, seed=7)`` (``tpch_torch_parity`` holds the rules),
and the paths the port took: broadcast joins, dense FK joins routed by
key residue, broadcast dense FK joins and shuffled dense semi-joins."""
import pytest

from tpch_torch_parity import (check_query, decisions, queries_param,
                               run_both)

NAMES = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8")


@pytest.fixture(scope="module")
def results():
    return run_both(NAMES)


@queries_param(NAMES)
def test_query_matches_jax(results, q, world):
    check_query(results, q, world)


@pytest.mark.parametrize("q,taken", [
    ("q3", {"join.fk-dense+broadcast", "join.fk-dense+shuffle"}),
    ("q4", {"semi.shuffle.dense"}),
    ("q5", {"join.broadcast", "join.fk-dense+broadcast",
            "join.fk-dense+shuffle"}),
    ("q8", {"semi.broadcast.dense", "join.fk-dense+shuffle"}),
])
def test_world8_paths(results, q, taken):
    """At world 8 the threshold of 256 rows broadcasts nation, region and
    supplier (and small filtered sides) and shuffles the rest."""
    assert taken <= set(decisions(results, q, 8))


def test_world1_paths_are_local(results):
    for q in NAMES:
        assert all(k.startswith(("join.local", "join.fk-dense",
                                 "semi.local"))
                   and "+" not in k for k in decisions(results, q, 1)), q
