"""The multi-process communicator: real processes over gloo on the CPU.

``tests/torch_multiprocess_worker.py`` is launched once per module for two
layouts, 2 processes × 4 local ranks (world 8, the JAX multi-host
worker's shape) and 2 × 1 (world 2, one rank a process, the MPI shape).
Each process joins through ``CylonContext.InitMultiHost``, runs every
scenario on the same seeded inputs and pickles the rows of its own
shards.  Here the processes' shards, side by side, must equal shard for
shard the port's single-process world of the same P (rows in order,
capacities, the exchange's strategy choices; the shuffle volume summed
over the processes) and, at world 8, the JAX package's 8-device run
(rows in order: keys and counts exactly, floats within
``float_rtols``).  A global result does not depend on how many
controllers drive the world.

Every worker wait has its own timeout; a timeout or a failing worker
kills every worker of the module.  A peer's loss is its own 2-process
run (C5).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import cylon_tpu_torch as pt
from cylon_tpu_torch import resilience
from cylon_tpu_torch.context import LocalCommunicator

import torch_multiprocess_worker as W
from test_torch_common import (assert_rows_close, float_rtols, jax_rows,  # noqa: F401
                               jax_trace_shim, port_rows)

WORKER = W.__file__
LAYOUTS = {"2x4": (2, 4), "2x1": (2, 1)}
WAIT_S = 180

GROUPS = {
    "ingest": ["from_table", "from_pandas", "from_partitions"],
    "shuffle": ["shuffle"],
    "join": [f"join_{alg}_{how}" for alg in ("hash", "sort")
             for how in ("inner", "left", "right", "full_outer")],
    "sort": ["sort_asc", "sort_desc"],
    "setops": ["union", "intersect", "subtract"],
    "groupby": ["groupby_default", "groupby_shuffle"],
    "lowerings": [f"lowering_{s}" for s in W.STRATEGIES],
    "other": ["groupby_chunked_combine", "undersized_hint", "broadcast_join",
              "fk_join", "semi_join", "anti_join", "select"],
}


def _env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("XLA_", "JAX_", "CYLON_"))}


def _launch(mode: str, nproc: int, local: int, out_dir: str,
            init: str = None):
    os.makedirs(out_dir, exist_ok=True)
    init = init or "file://" + os.path.join(out_dir, "store")
    return [subprocess.Popen(
        [sys.executable, WORKER, mode, str(p), str(nproc), str(local), init,
         out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_env(), cwd=os.path.dirname(os.path.dirname(WORKER)))
        for p in range(nproc)]


def _wait_all(procs, timeout: float):
    """Wait for every worker (each wait bounded by what is left of
    ``timeout``); on a timeout or a non-zero exit kill them all and
    fail with their output."""
    deadline = time.monotonic() + timeout
    failed = None
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            failed = "timed out"
            break
        if p.returncode != 0:
            failed = f"exited {p.returncode}"
            break
    if failed:
        for q in procs:
            q.kill()
        logs = b"".join(q.communicate()[0] or b"" for q in procs)
        pytest.fail(f"worker {failed}:\n{logs.decode(errors='replace')[-4000:]}")
    for q in procs:
        q.communicate()


def _load(out_dir: str, nproc: int):
    out = []
    for p in range(nproc):
        with open(os.path.join(out_dir, f"proc{p}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both layouts' workers, started together; ``{layout: [process
    results]}``."""
    base = tmp_path_factory.mktemp("multiprocess")
    started = {name: (_launch("scenarios", n, L, str(base / name)), n)
               for name, (n, L) in LAYOUTS.items()}
    for name, (procs, n) in started.items():
        _wait_all(procs, WAIT_S)
    return {name: _load(str(base / name), n)
            for name, (_, n) in started.items()}


# ---------------------------------------------------------------------------
# the single-process references
# ---------------------------------------------------------------------------

_SIM = {}


def _simulated(P: int):
    """Every scenario on the port's single-process world of ``P`` ranks
    (counters on, hints cleared before each, as the workers run)."""
    if P not in _SIM:
        from cylon_tpu_torch import trace
        ctx = pt.CylonContext(device="cpu", world=P)
        env = W.Env(pt, ctx, ctx, W.inputs(P))
        out = {}
        trace.enable_counters()
        try:
            for name, fn in W.SCENARIOS.items():
                W.clear_hints(pt)
                trace.reset()
                res = fn(env)
                out[name] = (res, W.exchange_counters(trace.counters()))
        finally:
            W.clear_hints(pt)
            trace.disable_counters()
            trace.reset()
        _SIM[P] = out
    return _SIM[P]


def _clear_jax(ct):
    from cylon_tpu.parallel import broadcast, dist_ops, shuffle
    shuffle._block_hints.clear()
    shuffle.clear_chunk_state()
    dist_ops._capacity_hints.clear()
    dist_ops._group_cap_hints.clear()
    dist_ops._select_cap_hints.clear()
    dist_ops._select_cache.clear()
    broadcast.clear_replica_cache()


def _shards(results, name):
    return [s for r in results for s in r[name]["shards"]]


# ---------------------------------------------------------------------------
# the controller API and the communicator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_controller_api(runs, layout):
    """``get_rank`` / ``local_ranks`` / ``get_neighbours`` /
    ``is_distributed`` / ``barrier`` / ``get_next_sequence`` and the
    process split, as ``tests/multihost_worker.py`` checks them for the
    JAX package."""
    nproc, L = LAYOUTS[layout]
    P = nproc * L
    for p, res in enumerate(runs[layout]):
        c = res["controller"]
        mine = list(range(p * L, p * L + L))
        assert c["rank"] == p * L and c["world"] == P
        assert c["local_ranks"] == mine
        assert c["neighbours"] == [r for r in range(P) if r not in mine]
        assert c["neighbours_all"] == list(range(P))
        assert c["distributed"] and c["processes"] == nproc
        assert c["sequence"] == [0, 1, 2]
        assert tuple(c["axis_split"]) == (nproc, L)
        assert c["slots"] == mine


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_equal_local_communicator(runs, layout):
    """Every collective of the process communicator (flat, and group-
    local under the process split) equals ``LocalCommunicator``'s on the
    whole world's tensor, restricted to each process's ranks; another
    split is refused, typed."""
    nproc, L = LAYOUTS[layout]
    P = nproc * L
    split = (nproc, L) if L > 1 else None
    local = LocalCommunicator(P, torch.device("cpu"))
    want = W.collectives(local, W.global_block(P), split)
    for p, res in enumerate(runs[layout]):
        got = res["collectives"]["values"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            # replicated results (all_gather, all_reduce) are whole;
            # per-rank ones are this process's rows
            rep = k in ("all_gather", "all_gather_bool", "all_reduce")
            np.testing.assert_array_equal(
                got[k], w if rep else w[p * L:(p + 1) * L], err_msg=k)
        assert res["collectives"]["other_split"] == (
            "NotImplemented" if L % 2 == 0 else None)


# ---------------------------------------------------------------------------
# shard for shard: the single-process world of the same P
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_equals_single_process_world(runs, layout, group):
    """Rows in order, shard placement and capacity of every scenario of
    ``group`` equal the port's single-process world of the same P; the
    exchange's strategy choices are the same in every process, and the
    rows and bytes each process counts as sent sum to the single
    process's."""
    nproc, L = LAYOUTS[layout]
    sim = _simulated(nproc * L)
    for name in GROUPS[group]:
        want, wc = sim[name]
        results = runs[layout]
        assert _shards(results, name) == port_rows(want, ordered=True), name
        for r in results:
            assert r[name]["cap"] == want.cap, name
            got_c = r[name]["counters"]
            assert {k: v for k, v in got_c.items()
                    if k.startswith("shuffle.strategy.")} == \
                {k: v for k, v in wc.items()
                 if k.startswith("shuffle.strategy.")}, name
        for k in ("shuffle.rows_sent", "shuffle.bytes_sent"):
            assert sum(r[name]["counters"].get(k, 0) for r in results) == \
                wc.get(k, 0), (name, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_exports_equal_in_every_process(runs, layout):
    """``num_rows`` / ``to_table`` / ``head`` give every process the
    global rows, equal to the single-process world's."""
    nproc, L = LAYOUTS[layout]
    want = W.local_result(_simulated(nproc * L)["export"][0])["value"]
    for r in runs[layout]:
        assert r["export"]["value"] == want


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unported_calls_refuse(runs, layout):
    """The calls not ported across processes — the host tier
    (``DTable.spill``), the morsel scans, ``remesh_table``,
    ``with_world``, ``first_slot``, ``ServeSession`` and ``FleetRouter``
    — raise a typed NotImplemented at once (well within 10 s).  The
    planner, ``run_pipeline``, the plan check, EXPLAIN ANALYZE, the TPC-H
    generator and queries and the planner-lowered operators run across
    processes (``tests/test_torch_multiprocess_tpch.py``)."""
    for r in runs[layout]:
        for name, (code, seconds) in r["refusals"].items():
            assert code == "NotImplemented", name
            assert seconds < 10.0, name


# ---------------------------------------------------------------------------
# world 8: the JAX package's 8-device run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [g for g in GROUPS if g != "other"])
def test_world8_equals_jax(runs, ctx, dctx, jax_trace_shim, group):
    """The 2 × 4 processes' shards equal the JAX package's single-process
    world 8 on the same inputs, rows in order: keys and counts exactly,
    floats within ``float_rtols``."""
    import cylon_tpu as ct
    env = W.Env(ct, dctx, ctx, W.inputs(8))
    sim = _simulated(8)
    for name in GROUPS[group]:
        assert name in W.JAX_SCENARIOS
        _clear_jax(ct)
        want = jax_rows(W.SCENARIOS[name](env), ordered=True)
        assert_rows_close(_shards(runs["2x4"], name), want,
                          float_rtols(sim[name][0]))


# ---------------------------------------------------------------------------
# C5: a peer's loss is a TOPOLOGY failure
# ---------------------------------------------------------------------------

def test_peer_loss_classifies_topology(tmp_path):
    """Process 1 exits before a collective; process 0's error, raised
    within its group's 8 s timeout, classifies as ``topology``."""
    procs = _launch("peerloss", 2, 1, str(tmp_path))
    _wait_all(procs, 90)
    got = _load(str(tmp_path), 1)[0]   # process 1 leaves no result
    assert got["error"] is not None, got
    assert got["class"] == resilience.TOPOLOGY, got
    assert got["seconds"] < 8.0 + 5.0, got


@pytest.mark.parametrize("exc, want", [
    (RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection closed by "
                  "peer [127.0.0.1]:4242"), "topology"),
    (RuntimeError("NCCL communicator was aborted on rank 1"), "topology"),
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout"),
     "topology"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "permanent"),
])
def test_classify_process_group_messages(exc, want):
    """The peer-loss arm matches a process group's lost / closed /
    aborted / timed-out peer, and nothing else."""
    assert resilience.classify(exc) == want


def test_classify_dist_backend_error():
    """``torch.distributed.DistBackendError`` (a backend that lost its
    peers) is TOPOLOGY; an out-of-memory error stays RESOURCE."""
    import torch.distributed as dist
    assert resilience.classify(dist.DistBackendError("x")) == "topology"
    assert resilience.classify(torch.OutOfMemoryError("x")) == "resource"
