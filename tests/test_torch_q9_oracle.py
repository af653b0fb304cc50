"""Q9's ``sum_profit`` against the numpy oracle at other seeds and scales
than the shared parity harness's (``tpch_torch_parity``: SF 0.002, seed
7): the port's one-shot and streaming Q9 equal the oracle's exact sums of
the IEEE float32 amounts, and the JAX package's group sums are within one
float32 ulp of each row's larger product, summed over the group's rows,
of the port's (``tpch_torch_parity.check_q9_profit``).  SF 0.005 with
seed 3 at world 4 holds a group (ARGENTINA 1993) whose amounts cancel to
355.248046875, where the JAX package's fused multiply-add gives
355.2485046386719: 1.3e-6 apart relative, over the 1e-6 a relative
tolerance allowed."""
import pytest

from test_torch_common import jax_trace_shim  # noqa: F401
from tpch_torch_parity import check_q9_profit, q9_oracle, run_both


@pytest.mark.parametrize("scale,seed,world", [(0.005, 3, 4), (0.003, 11, 8)])
def test_q9_profit_matches_oracle(jax_trace_shim, scale, seed, world):
    results = run_both(("q9", "q9_streaming"), scale, seed, (world,))
    oracle = q9_oracle(scale, seed)
    for q in ("q9", "q9_streaming"):
        got, want, _ = results[(q, world)]
        check_q9_profit(got, want, oracle)
