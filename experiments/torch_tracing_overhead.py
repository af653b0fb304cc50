"""What the port's observability costs when it is off, and EXPLAIN ANALYZE
when it is on: TPC-H at SF 10, world 4, on one CUDA card.

    python3 experiments/torch_tracing_overhead.py TREE [--analyze]

``TREE`` is the root of a checkout whose ``cylon_tpu_torch`` is measured
(``.`` for this one; a parent commit unpacked with ``git archive`` into a
directory ``.gitignore`` lists, e.g. ``build/parent``).  The tables are
generated on the card (``--seed 0``), then three rounds run the 22
queries eagerly and through ``ctx.optimize`` (a plan-cache hit after the
first round), counters on and tracing off, each query from an empty
replica cache; it prints each round's totals and the last round's
seconds per query.  ``--analyze`` then runs ``DTable.explain(...,
analyze=True, optimize=True)`` of Q3, Q2 and Q6 twice each and prints the
second report and its span totals beside the same query's planned time.

To compare two trees, run them in one call on one card, in turns:
parent, change, change, parent.
"""
import json
import sys
import time

import torch

sys.path.insert(0, sys.argv[1])

import cylon_tpu_torch as pt  # noqa: E402
from cylon_tpu_torch import trace  # noqa: E402
from cylon_tpu_torch.parallel import broadcast  # noqa: E402
from cylon_tpu_torch.tpch import QUERIES, generate_device  # noqa: E402

ROUNDS = 3


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print("tree", sys.argv[1], pt.__file__, torch.cuda.get_device_name(0),
          flush=True)
    ctx = pt.CylonContext(device="cuda", world=4)
    tables = generate_device(ctx, 10.0, seed=0)
    trace.enable_counters()
    runs = {"eager": [], "hit": []}
    for _ in range(ROUNDS):
        for mode in runs:
            secs = {}
            for q in QUERIES:
                broadcast.clear_replica_cache()
                trace.reset()

                def op(t, q=q):
                    return QUERIES[q](ctx, t)

                _, secs[q] = wall(lambda: ctx.optimize(op, tables)
                                  if mode == "hit" else op(tables))
            runs[mode].append(secs)
    for mode, rounds in runs.items():
        print(mode, "totals", [round(sum(r.values()), 6) for r in rounds],
              flush=True)
        print(mode, "last", json.dumps({q: round(v, 6)
                                        for q, v in rounds[-1].items()}),
              flush=True)
    if "--analyze" in sys.argv[2:]:
        anchor = tables["lineitem"]
        for q in ("q3", "q2", "q6"):
            for _ in range(2):
                broadcast.clear_replica_cache()
                rep, secs = wall(lambda: anchor.explain(
                    lambda t: QUERIES[q](ctx, t), tables=tables,
                    analyze=True, optimize=True))
            print(q, "analyzed", round(secs, 6), "hit",
                  round(runs["hit"][-1][q], 6), flush=True)
            print(str(rep)[:3000], flush=True)
            print(q, "phase_ms", json.dumps(
                {k: round(v, 3) for k, v in rep.totals["phase_ms"].items()}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
