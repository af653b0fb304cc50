"""Drive the PyTorch/CUDA engine (cylon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--seed S] [--profile]
                          [--tpch-sf SF] [--tpch-check-sf SF]

Run from the root of a checkout: it builds the partition-hash CUDA kernel
from the checkout's sources, holds it against its plain PyTorch version,
and runs the distributed HASH equi-join end to end (ingest from numpy →
DTable → dist_join → to_table) at world 1 and world 4 on the card, with
16,777,216 rows per side by default in the join benchmark's column shape
(``k`` int32 uniform in [0, 0.99·n), ``v0..v2`` float32).  On the same data
it then runs the SORT join (the default ``JoinConfig``) at world 4,
``dist_sort`` / ``dist_sort_multi`` / ``dist_head``, and the distributed
union / intersect / subtract, each against an oracle that does not use
the engine.  The compat route follows on the same data: the port's
pycylon (``cylon_tpu_torch.pycylon``, ``CylonContext("mpi", world=4)``,
both sides through ``Table.from_arrow``) runs ``distributed_join(ctx,
right, "inner", "hash", 0, 0)`` against the HASH join's oracle (2
partition-kernel launches) and ``distributed_union`` / ``_intersect`` /
``_subtract`` against the set-op phase (rows and v0 bit checksums, 2
launches each), a ``Communication`` round trip at world 4 checks every
received buffer, the launcher the Java binding spawns
(``cylon_tpu_torch/pycylon/java_launcher.py -m pycylon.java_gateway
mpi``) answers every gateway op on a seeded CSV pair exactly as the same
gateway in this process does, and the example programs of
``cylon_tpu_torch/examples`` run on the card, each exiting 0.  Then, on a
table in the shape of TPC-H ``lineitem`` (as many rows, ``orderkey``
uniform in [0, n/4), 10% null prices), it runs ``dist_groupby`` by
``orderkey`` three ways (pre-aggregated with the shuffle combine, the
raw-row shuffle, the dense-key path), the Q1 shape
(``dist_with_column`` + a six-group ``dist_groupby`` with ``where``, the
broadcast combine) and the Q6 shape (``dist_aggregate`` with ``where``,
``dist_select`` compacting and deferred, then ``dist_groupby``), each
against a numpy oracle on the host.  Last, TPC-H: the eight tables are
generated on the card at ``--tpch-sf`` (default 10) and world 4 (the
first and last 65,536 rows of each held against the numpy mirror), all
22 queries run through ``tpch.QUERIES`` (one line each: seconds, result
rows, peak memory, partition-kernel launches, join decisions; then the
geometric mean), Q1, Q3, Q4, Q6, Q14, Q18 and Q22 are recomputed in
numpy from host copies of the tables, and every query's result at
``--tpch-check-sf`` (default 1) is the same at world 1 and world 4.
Right after the eager pass the 22 queries run through the logical
planner (``ctx.optimize``) twice, a plan-cache miss then a hit for every
query, each result equal to the eager one in order (one line each:
seconds, peak, launches, cache hits and misses, rule fires, planned row
bytes, wire bytes planned and eager; then a summary).  On
the same SF-10 tables it then drives the operators the planner lowers to:
``dist_groupby_fused`` in its three modes (psum over Q1's keys against
numpy, pre-aggregate and shuffle by ``l_orderkey`` against
``dist_groupby``), ``dist_groupby_sketch`` by ``l_suppkey`` (every
supplier present, one in 8 within the sketches' error bounds of numpy's
exact answers), the
aggregation state of a base and a delta merged and finalized (= the whole
table's groupbys), Q9 with ``streaming_chunks=4`` against the one-shot
Q9, and a Q5-shaped ``dist_multiway_join`` against the binary
``dist_join`` cascade; ``dist_join_streaming`` against ``dist_join`` on
the join cell; and at ``--tpch-check-sf`` the captured sketch lanes
against a numpy recomputation, bit for bit.  Every export of those
phases goes through one ``HostPipeline``.  The analyze phase: right
after the world-4 HASH join, ``ctx.analyze`` of the same join (the eager
rows and checksums, node bytes = totals = the exchange counters, the
span breakdown beside the analyzed and eager times), then the join with
tracing disabled and counters on (no barrier: ``trace.sync`` 0); after
the TPC-H oracles, ``DTable.explain(..., analyze=True, optimize=True)``
of every query on the SF-10 tables (each equal to its eager result, its
counters in the catalogue, the ``devmem`` peak equal to
``torch.cuda.max_memory_allocated()``; one line each), then the Chrome
trace of the last one written under ``build/`` and parsed back, and a
flight-recorder bundle that ``doctor`` renders.  The redistribution
phase: after the SORT join, ``shuffle_table`` by ``k`` and the world-4
HASH join on the join cell under every exchange lowering forced
(single-shot, chunked, ring, allgather, and hierarchical under a (2, 2)
mesh shape: each shard's sorted row hashes equal single-shot's, the join
equal to the oracle, 2 kernel launches), then under a budget inside each
band the cost model finds for that count matrix (the lowering that runs
is ``cost.choose``'s), then under a transient ``compact.read_counts``
fault, a shrunk ``resilience.budget`` and the exchange watchdog; one line
each with seconds, rounds, the priced peak per shard and the observed
card peak.  After the trace export, on the SF-10 tables: the fused
partial exchange by ``l_orderkey`` at the default budget and at half its
priced peak (the chunked fold-combine, groups equal; the exchange's own
observed peak from EXPLAIN ANALYZE), then the 22 queries eager under a
256 MiB per-shard budget, each equal to its default-budget result, the
budget halving until some exchange degrades.  The out-of-core phases:
after the redistribution phase, on the join cell, a spill round trip of
the left side (the card's allocated bytes fall by the leaves' bytes,
pinned host blocks, the fault-in bit for bit, a re-spill hit; the host
link's D2H and H2D GB/s beside the nominal 64 GB/s), the HASH join with
the left side spilled, streamed in 4 morsels (= the oracle), and
``shuffle_table`` and the HASH join under a forced ``staged-spill``
(single-shot's rows in the chunked plan's order; the join = the oracle);
at SF 10, the JAX bench's out-of-core stage (Q1, Q18 and Q11 through
``ctx.optimize`` under ``max(192 KiB, lineitem's price // 48)``, each
equal to its ample-budget run; Q1 again with the tier switched off), and
after the sketch phase the fused ``l_orderkey`` and sketch ``l_suppkey``
groupbys of spilled lineitem projections in 4 morsels, each equal to its
resident result.  The recovery phases: after the out-of-core phases, on
the join cell, the JAX ``two_stage`` plan (a HASH join, then a groupby by
the key, broadcast threshold 1) through ``ctx.optimize`` at world 4,
fault-free (= a float64 oracle on the card), then under a transient and a
resource ``exec.stage`` fault (the strategies before and after the
replan), a ``recover.checkpoint_restore`` fault, a lost slot (4 → 3:
evacuated bytes, ``recover.remesh_us``, the card's allocated bytes before
the loss, after the evacuation and after the run; the card holds each
scan table once), its rejoin in the next plan (3 → 4), 4 → 3 → 4 within
one plan, and with recovery switched off (the fault propagates), each
equal to the fault-free run and the oracle; at SF 10 after the multiway
phase Q5 and Q21 losing a slot, each equal to its fault-free planned run
(the tables then move back to world 4).  The ingest phases, after the
recovery join: the join cell ingested from pyarrow tables with
``DTable.from_arrow`` (layout, padding and counts against the numpy
source; the HASH join = the oracle; the ingest GB/s beside the host
link's H2D rate), per-rank CSV files (4 per side, 1,048,576 rows each,
under ``build/``) read by ``io.read_csv_many`` into
``DTable.from_partitions`` (the HASH join = a numpy oracle, ``write_csv``
of a partition read back equal), an ``append`` of 1,048,576 rows to the
join cell's right side (the same handle, content epoch 1, the delta
kept, the HASH join = the oracle of the grown side; the same append of a
spilled copy drops its pool entry and is bit for bit the resident one),
the JAX bench's strkey stage (1,200,000 distinct string keys joined
through the dictionary encoding and through the hash64 lanes, both =
pandas' merge, the resolved rows equal) and its ingest stage (lineitem
at SF 0.17 through ``DTable.from_pandas``, the staging arena on and off,
read back equal), then the partition kernel's chained entry at 17, 24
and 40 key columns against its plain version and ``dist_union`` /
``dist_intersect`` / ``dist_subtract`` of two 24-column tables of
4,194,304 rows against a numpy distinct-row oracle.  The serving
phases, right after the TPC-H oracles at SF 10: the JAX bench's serve
stage through ``serve.ServeSession`` (8 client threads, one per query
of ``SERVE_MIX``, 2 submissions each into 8 ms windows, every result
exported with ``to_pandas()`` on the async lane and equal to the eager
result; the OpenMetrics endpoint started from ``config.metrics_port``
0 and scraped once), with the view store on and then off; the bench's
mixed read/write stage (a 16,777,216-row fact table, one writer
appending 128-row deltas every 50 ms through ``session.ingest`` while 8
readers repeat a shuffle + groupby for 10 s; the last read, a fold
after one more append and a recompute with the views off each equal to
a numpy oracle); and two replicas at world 2 over disjoint slot ranges
of the card behind a ``FleetRouter`` (affinity, then failover after a
drain; each result equal to numpy).  The pipeline phases (the JAX
bench's TPC-H form), right after the TPC-H oracles at SF 10:
``plan_check.validate`` of every query with nation and region concrete,
eager and planned (``plan.run``), each launching no kernel, reading
nothing on the host, allocating nothing on the card and leaving the size
hints and the replica cache unchanged (one line each: nodes, seconds,
result schema); then every query under ``run_pipeline`` after a warm-up,
beside an eager run on the same warm hints (seconds, ``host.read``,
replays, launches; each result equal to the TPC-H phase's eager result
in order, fewer host reads wherever the eager run reads more than
twice), Q5 and Q21 with their first hints quartered at the
``compact.hint`` fault point (the region replays; results unchanged),
and one static ``DTable.explain`` report (Q5); and after the morsel join
the join cell's world-4 HASH join under ``run_pipeline`` (= the oracle,
fewer host reads than eager, 2 launches) and again with the budget one
byte under the hinted single-shot exchange (the flush invalidates, the
replay runs the degraded lowering, = the oracle).  The multi-process
TPC-H phase, after the static EXPLAIN report: the same SF-10 tables
generated through ``CylonContext.InitMultiHost`` (one process of 4
local ranks over NCCL) equal the TPC-H phase's shard for shard; the 22
queries eager (each = its eager result in order, the same partition-
kernel launches, its seconds beside the single-process seconds) and
through ``ctx.optimize`` (miss, then hit), ``plan_check.validate`` of
each (0 launches, host reads, card bytes and calls into the
communicator), each under ``run_pipeline``, and ``ctx.analyze`` of Q5
(node rows = the single-process report's); then Q1, Q5, Q9 streaming,
Q21 and Q5 planned at SF 0.05 in two processes of 2 local ranks on the
card over gloo (``--mp-tpch-child``), each = the single-process world
4's.  The measured cost model, after the redistribution phase: the mesh
probe (``parallel.meshprobe.probe``) of ``CylonContext(world=4)`` and of
one NCCL process of 4 local ranks, at the default sizes and at 1-64 MiB
per shard (α in µs and β in GB/s per collective and host leg; the two
fingerprints differ), then the join cell's HASH join under the measured
ranking (``config.set_cost_measured(True)``; each exchange's candidates
with their ``cost.predicted_ms`` and the pick; = the oracle), flat and
under a (2, 2) mesh shape after a per-axis probe; after the trace
export, EXPLAIN ANALYZE of that join and of Q5 at ``--tpch-sf`` twice
(every exchange carries ``exchange_ms`` and ``peak``; the stats stores
saved under ``build/``), ``analysis.calibrate`` of the first store (exit
0 or 1; each strategy's median error) and ``analysis.queryprof`` of the
pair.  The out-of-core TPC-H phase also holds each spilled query's row
set to the ample run's through ``analysis.parity``.  Sanitizer mode
(``config.sanitize()``: the sync guard and NaN trap of every span body,
the host-cache content check at export): after the recovery phases the
22 queries at ``--tpch-sf`` run plain and sanitized (equal, in order;
seconds both ways); then the reference's last public names:
``tpch.generate(1.0, seed=42)`` on the host (pandas), each frame through
``DTable.from_pandas`` at world 4, the 22 queries (one ``[tpch-host qN
...]`` line each; Q1, Q3, Q4, Q6, Q14, Q18 and Q22 against the numpy
oracles, every other query's row count against world 1 on the same
frames); ``bench_join_cols(torch, ...)`` at ``bench.py``'s
one-accelerator shape (4,000,000 rows a side, seeds 3 and 7922), bit
for bit its numpy form, and the world-4 HASH join of the two sides
against pandas' merge row count (2 launches); the carried sort-join
plan on 4,194,304-row single-column sides, at the ops level bit for bit
the plain plan for every join type (both timed), and at world 4 the
SORT and HASH ``dist_join`` of the same sides (the shape the JAX
package carries; the port joins it by the plain plan) against a host
oracle of the row count and key multiset (SORT globally key-ordered);
near the end the one-command gate,
``analysis.ci.main(["--device", "cuda", "--world", "8"])`` in this
process at its default SF 0.002 (one ``[ci stage N ...]`` line each:
exit code, seconds, partition-kernel launches; every stage exits 0 and
none of stages 1-13 skips), then its stage 14, ``benchdiff``, on two
artifacts in ``bench.py``'s line format under ``build/`` filled with
this run's TPC-H seconds, wire bytes and host reads (self against self
exits 0; with the slowest query's ``tpch_<q>_ms`` doubled it exits 1
and names that key); then ``analysis.graftlint`` and
``analysis.lockcheck`` lint the package and this script (both exit 0),
the guard is held on ``cuda:0`` (``.item()`` in a span raises, the debug
mode is restored, ``log(-1)`` trips the NaN trap and a masked quotient
does not, and one line says which of a list of calls the guard stops),
and the join cell's HASH and SORT joins, the HASH join under every
forced lowering and the fused groupby's chunked fold-combine run plain
and sanitized (equal shard for shard, the oracle held, 2 launches per
HASH join).  Every check that
fails raises, so the script exits non-zero; without a
CUDA device it exits non-zero before doing anything.  The last line is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches on the main path (and
on the compat, groupby, TPC-H, redistribution, spill, recovery, ingest,
append, strkey, wide-key, serving, pipeline, multi-process,
measured-ranking, CI-gate, host TPC-H, bench-side and carried-join
paths), its time, its plain version's time and its
bound, and the kernel at nparts 3 on the survivor layout; a second
entry holds the chained launches past 16 key columns with their times
and bounds at 17, 24 and 40 columns.
``--profile`` adds torch.profiler tables of device time by
kernel (and by input shape) for the world-4 HASH and SORT joins, one
``dist_sort``, one ``dist_union``, the default ``orderkey`` groupby, the
Q1 shape, the two slowest TPC-H queries, the psum and pre-aggregate
fused groupbys, the sketch groupby and Q9 streaming against one-shot.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
KEY_FRAC = 0.99             # keys uniform in [0, 0.99 n): ~1% duplicates
REL_TOL = 1e-9              # float64 checksum sums, reordered on the card
DEVICE = "cuda"             # every table and context of the run
WORLD = 4                   # shards of the distributed phases
RESIDENT = {}  # (phase, sf) -> a resident result the spilled phases match


T0 = time.perf_counter()  # ``at=`` on every line: seconds into the run


def say(phase: str, **kv) -> None:
    kv["at"] = f"{time.perf_counter() - T0:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall(fn):
    """(result, host seconds) of ``fn()`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------

def phase_device():
    from cylon_tpu_torch.ops import hash_cuda

    name = torch.cuda.get_device_name(0)
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    hash_cuda.load()
    say("build", kernel=hash_cuda.SOURCE.name,
        seconds=f"{time.perf_counter() - t0:.2f}")
    for line in hash_cuda.build_log.splitlines():
        if "ptxas" in line:
            print("  " + line.strip(), flush=True)
    return name, smi_line


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def hash_bound_ms(cols, validities, n: int) -> float:
    """Least time for the pass: every key (and validity) byte read once,
    4 bytes of id written per row, at the card's memory rate."""
    nbytes = sum(c.element_size() * n for c in cols)
    nbytes += sum(n for v in validities if v is not None) + 4 * n
    return nbytes / H100_BYTES_PER_S * 1e3


def phase_kernel_parity(rows: int, seed: int):
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.ops import hash_cuda

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = torch.device(DEVICE)
    r = lambda dt: torch.randint(-2**31, 2**31 - 1, (rows,), generator=g,  # noqa: E731
                                 device=dev, dtype=torch.int64).to(dt)
    i32, i64 = r(torch.int32), torch.randint(
        -2**62, 2**62, (rows,), generator=g, device=dev, dtype=torch.int64)
    f32 = torch.randn(rows, generator=g, device=dev)
    f64 = torch.randn(rows, generator=g, device=dev, dtype=torch.float64)
    valid = torch.rand(rows, generator=g, device=dev) < 0.9
    special = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                            float("-inf"), 1e-40], device=dev)
    f32[:6], f64[:6] = special, special.double()  # NaN, ±0, ±inf, subnormal
    cases = {"int32": ((i32,), (None,)), "int64": ((i64,), (None,)),
             "float32": ((f32,), (None,)), "float64": ((f64,), (None,)),
             "int32+float32(nullable)": ((i32, f32), (None, valid))}
    small = 1 << 20  # every other dtype the kernel reads, at a smaller size
    for dt in (torch.int8, torch.uint8, torch.int16, torch.uint16,
               torch.uint32, torch.uint64, torch.bool, torch.float16):
        x = i64[:small].to(dt) if dt != torch.float16 else \
            (f32[:small] * 1e3).half()  # incl. NaN, ±inf, subnormals
        cases[str(dt).replace("torch.", "")] = ((x,), (valid[:small],))
    max_err = 0
    for label, (cols, vals) in cases.items():
        n = cols[0].shape[0]
        for nparts in (1, 4, 16):
            want = plain_hash.partition_ids(plain_hash.row_hash(cols, vals),
                                            nparts)
            got = hash_cuda.partition_ids_fused(cols, vals, nparts)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0 and got.dtype == torch.int32,
                  f"kernel == plain for {label} nparts={nparts}")
        if n == rows:
            k_ms = cuda_ms(lambda: hash_cuda.partition_ids_fused(cols, vals, 4), 20)
            p_ms = cuda_ms(lambda: plain_hash.partition_ids(
                plain_hash.row_hash(cols, vals), 4), 3, warmup=1)
            b_ms = hash_bound_ms(cols, vals, n)
            say("kernel", case=label, rows=n, exact="yes", ms=f"{k_ms:.4f}",
                plain_ms=f"{p_ms:.3f}", bound_ms=f"{b_ms:.4f}",
                share_of_bound=f"{b_ms / k_ms:.3f}")
        else:
            say("kernel", case=label, rows=n, exact="yes")
    say("kernel", library_ms="none: no single PyTorch call computes the "
        "murmur3 partition id")
    return max_err


# ---------------------------------------------------------------------------
# phases 3-5: dist_join against an independent oracle
# ---------------------------------------------------------------------------

def make_side(rng, n: int, nulls: int = 0):
    """One side in the benchmark's column shape; ``nulls`` rows (chosen at
    random) get a null key.  Returns (numpy columns, null mask or None)."""
    data = {"k": rng.integers(0, int(KEY_FRAC * n), n, dtype=np.int32)}
    for j in range(3):
        data[f"v{j}"] = rng.random(n, dtype=np.float32)
    null = None
    if nulls:
        null = np.zeros(n, bool)
        null[rng.choice(n, nulls, replace=False)] = True
    return data, null


def to_table(ctx, data, null):
    from cylon_tpu_torch import Table

    t = Table.from_columns(ctx, data)
    if null is not None:  # numpy carries no nulls: attach the key's validity
        t.columns[0].validity = torch.from_numpy(~null).to(ctx.device)
    return t


def oracle(kl, kr, vl, vr, nl, nr, krange: int):
    """Output rows and payload checksums of the join, from per-key counts
    and sums (bincount / index_add_ on the card), independent of the engine.
    Null keys form one group of their own (null == null, as the engine's
    keying does); ``nl`` / ``nr`` are the null masks or None."""
    dev = kl.device

    def per_key(k, v, null):
        valid = torch.ones_like(k, dtype=torch.bool) if null is None else ~null
        kk = torch.where(valid, k.long(), krange)  # bin krange = the null group
        cnt = torch.bincount(kk, minlength=krange + 1)
        s64 = torch.zeros(krange + 1, dtype=torch.float64, device=dev)
        s64.index_add_(0, kk, v.double())
        bits = torch.zeros(krange + 1, dtype=torch.int64, device=dev)
        bits.index_add_(0, kk, v.view(torch.int32).long())
        return cnt, s64, bits

    cl, sl, bl = per_key(kl, vl, nl)
    cr, sr, br = per_key(kr, vr, nr)
    inner = int((cl * cr).sum())
    return {"inner": inner,
            "left": inner + int(cl[cr == 0].sum()),
            "right": inner + int(cr[cl == 0].sum()),
            "full_outer": inner + int(cl[cr == 0].sum()) + int(cr[cl == 0].sum()),
            "sum_lt_v0": float((sl * cr).sum()), "sum_rt_v0": float((sr * cl).sum()),
            "bits_lt_v0": int((bl * cr).sum()), "bits_rt_v0": int((br * cl).sum())}


def checksums(out):
    """Σ and Σ of the bit patterns of lt-v0 / rt-v0 over the valid rows."""
    res = {}
    for side in ("lt", "rt"):
        c = out.column(f"{side}-v0")
        res[f"sum_{side}_v0"] = float(c.data.double().sum())  # graftlint: ok[implicit-host-sync]
        res[f"bits_{side}_v0"] = int(c.data.view(torch.int32).long().sum())  # graftlint: ok[implicit-host-sync]
    return res


def close(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * max(abs(a), abs(b), 1.0)


def run_join(world: int, ldata, rdata, how: str, lnull=None, rnull=None,
             alg: str = "hash"):
    """The user's path: tables from numpy → DTables → dist_join → Table.
    ``alg="sort"`` joins with the default configuration
    (``JoinConfig.InnerJoin`` etc.: the SORT algorithm)."""
    from cylon_tpu_torch import CylonContext, JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import DTable, dist_join

    ctx = CylonContext(device=DEVICE, world=world)
    (lt, rt), t_ingest = wall(lambda: (
        DTable.from_table(ctx, to_table(ctx, ldata, lnull)),
        DTable.from_table(ctx, to_table(ctx, rdata, rnull))))
    if alg == "sort":
        cfg = {"inner": JoinConfig.InnerJoin, "left": JoinConfig.LeftJoin,
               "right": JoinConfig.RightJoin,
               "full_outer": JoinConfig.FullOuterJoin}[how](0, 0)
        check(cfg.algorithm == JoinAlgorithm.SORT, "SORT is the default")
    else:
        cfg = JoinConfig(JoinType(how), JoinAlgorithm.HASH, 0, 0)
    joined, t_join = wall(lambda: dist_join(lt, rt, cfg))
    local, t_export = wall(joined.to_table)
    return joined, local, {"ingest_s": t_ingest, "join_s": t_join,
                           "export_s": t_export}


def check_join(label: str, local, want) -> None:
    """Output rows and payload checksums of an inner join == the oracle."""
    got = checksums(local)
    check(local.num_rows == want["inner"], f"{label}: output rows == oracle")
    for key in ("sum_lt_v0", "sum_rt_v0"):
        check(close(got[key], want[key]),
              f"{label}: {key} {got[key]!r} vs oracle {want[key]!r}")
    for key in ("bits_lt_v0", "bits_rt_v0"):
        check(got[key] == want[key], f"{label}: {key} exact")
    check(torch.equal(local.column("lt-k").data, local.column("rt-k").data),
          f"{label}: inner join keys equal on every row")


def phase_inner(world: int, ldata, rdata, want, profile: bool):
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.ops import hash_cuda

    torch.cuda.reset_peak_memory_stats()
    hash_cuda.launches = 0
    joined, local, times = run_join(world, ldata, rdata, "inner")
    launches = hash_cuda.launches
    say(f"dist_join inner world={world}", rows_out=local.num_rows,
        oracle_rows=want["inner"],
        **{k: f"{v:.6f}" for k, v in times.items()},
        rows_per_s=f"{(len(ldata['k']) + len(rdata['k'])) / times['join_s']:.0f}",
        kernel_launches=launches,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    check_join(f"world {world}", local, want)
    if world > 1:
        check(launches == 2, f"world {world}: kernel launched once per side "
              f"(got {launches})")
        counts = joined.counts_host()
        keys = joined.column("lt-k").data.view(world, joined.cap)
        for s in range(world):
            k = keys[s, :int(counts[s])]
            pid = plain_hash.partition_ids(plain_hash.row_hash((k,), (None,)),
                                           world)
            check(bool((pid == s).all()), f"shard {s} holds only its keys")
        say(f"dist_join inner world={world}", placement="every row on its "
            "plain-pid shard", shard_rows=list(map(int, counts)))
    if profile:
        profile_join(world, ldata, rdata, "hash")
    return launches, times


def check_shards_ordered(label: str, dt, key: str, descending=False) -> None:
    """Within every shard the valid keys are in order with NaN last, and
    each shard's last non-NaN key ≤ the next non-empty shard's first (≥
    when ``descending``).  Where NaN goes across shards, the placement
    check against the JAX rule says."""
    counts = dt.counts_host()
    c = dt.column(key)
    keys = c.data.view(dt.nparts, dt.cap)
    valid = None if c.validity is None else c.validity.view(dt.nparts, dt.cap)
    prev = None
    for s in range(dt.nparts):
        k = keys[s, :int(counts[s])]
        if valid is not None:
            k = k[valid[s, :int(counts[s])]]
        nan = torch.isnan(k) if k.dtype.is_floating_point else \
            torch.zeros_like(k, dtype=torch.bool)
        check(bool((nan[1:] >= nan[:-1]).all()), f"{label}: shard {s} NaN last")
        k = k[~nan]
        if descending:
            k = -k
        check(bool((k[1:] >= k[:-1]).all()), f"{label}: shard {s} in order")
        if k.numel():
            if prev is not None:
                check(bool(prev <= k[0]), f"{label}: shard {s - 1} ≤ shard {s}")
            prev = k[-1]


def phase_sort_join(ldata, rdata, want, profile: bool):
    """The SORT join (the default JoinConfig) at world 4: range
    partitioning, so no kernel launch; the output is key-ordered."""
    from cylon_tpu_torch.ops import hash_cuda

    torch.cuda.reset_peak_memory_stats()
    hash_cuda.launches = 0
    joined, local, times = run_join(WORLD, ldata, rdata, "inner", alg="sort")
    launches = hash_cuda.launches
    label = f"dist_join SORT inner world={WORLD}"
    say(label, rows_out=local.num_rows, oracle_rows=want["inner"],
        **{k: f"{v:.6f}" for k, v in times.items()},
        rows_per_s=f"{(len(ldata['k']) + len(rdata['k'])) / times['join_s']:.0f}",
        kernel_launches=launches,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        shard_rows=list(map(int, joined.counts_host())))
    check_join(label, local, want)
    check(launches == 0, f"{label}: no partition-kernel launch (got {launches})")
    check_shards_ordered(label, joined, "lt-k")
    if profile:
        profile_join(WORLD, ldata, rdata, "sort")
    return times


def profile_call(label: str, fn) -> None:
    """Print torch.profiler tables of ``fn()``'s device time by kernel,
    and of the eight costliest operators by input shape."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    say(f"profile {label}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25),
          flush=True)
    print(prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_cuda_time_total", row_limit=8), flush=True)


def profile_join(world: int, ldata, rdata, alg: str):
    profile_call(f"{alg.upper()} inner world={world}",
                 lambda: run_join(world, ldata, rdata, "inner", alg=alg))


def phase_outer(seed: int):
    """LEFT / RIGHT / FULL_OUTER with null keys, by HASH; LEFT and
    FULL_OUTER once more by SORT (null keys go to the last shard).  The
    engine's keying puts every null key in one group that matches null
    keys of the other side (the JAX package's semantics), so nulls on both
    sides multiply: the left side gets 10% null keys, the right side 16."""
    n = 1 << 20
    rng = np.random.default_rng(seed + 1)
    (ld, lnull), (rd, rnull) = make_side(rng, n, n // 10), make_side(rng, n, 16)
    t = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    want = oracle(t(ld["k"]), t(rd["k"]), t(ld["v0"]), t(rd["v0"]),
                  t(lnull), t(rnull), int(KEY_FRAC * n))
    for alg, hows in (("hash", ("left", "right", "full_outer")),
                      ("sort", ("left", "full_outer"))):
        for how in hows:
            _, local, times = run_join(WORLD, ld, rd, how, lnull, rnull, alg)
            say(f"dist_join {alg.upper()} {how} world={WORLD}", rows=n,
                null_keys=f"{int(lnull.sum())}+{int(rnull.sum())}",
                rows_out=local.num_rows, oracle_rows=want[how],
                join_s=f"{times['join_s']:.6f}")
            check(local.num_rows == want[how],
                  f"{alg} {how}: output rows == oracle")


# ---------------------------------------------------------------------------
# phase: dist_sort / dist_sort_multi / dist_head
# ---------------------------------------------------------------------------

def bits_sum(x: torch.Tensor) -> int:
    """Σ of the 32-bit patterns of a float32 column (order-free, exact)."""
    return int(x.view(torch.int32).long().sum())


def host_splitters(shards, nparts: int, ascending: bool) -> np.ndarray:
    """The JAX package's sample-sort splitters, recomputed in numpy from
    each input shard's non-null keys (np.sort and np.searchsorted order NaN
    above every number and −0.0 with 0.0, as lax.sort does): 64 samples per
    shard at ``arange(64)·max(nn, 1) // 64`` of which the first ``nn`` count,
    pooled, sorted, picked at ``(arange(1, P)·m) // P``."""
    def ordered(x):
        return np.sort(x) if ascending else -np.sort(-x)
    pool = []
    for x in shards:
        nn = len(x)
        q = np.arange(64) * max(nn, 1) // 64
        pool.append(ordered(x)[q[:min(nn, 64)]])
    pool = ordered(np.concatenate(pool))
    m = len(pool)
    if m == 0:
        return np.full(nparts - 1, np.inf if ascending else -np.inf)
    return pool[(np.arange(1, nparts) * m) // nparts]


def host_range_pids(k: np.ndarray, null: np.ndarray, nparts: int,
                    ascending: bool):
    """Target shard of every row of a table ingested by DTable.from_table,
    by the JAX package's rule (nulls to the last shard; descending counts
    the splitters above the value, so NaN goes to shard 0)."""
    base, rem = divmod(len(k), nparts)
    sizes = [base + (1 if i < rem else 0) for i in range(nparts)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    shards = [k[offs[i]:offs[i + 1]][~null[offs[i]:offs[i + 1]]]
              for i in range(nparts)]
    sp = host_splitters(shards, nparts, ascending)
    if ascending:
        pid = np.searchsorted(sp, k, side="right")
    else:
        pid = np.zeros(len(k), np.int64)
        for s in sp:
            pid += s > k
    return np.where(null, nparts - 1, pid), sp


def phase_dist_sort(ldata, seed: int, profile: bool):
    """dist_sort of one main-path side (10% null keys) ascending and
    descending, dist_sort_multi(["k", "v0"], [True, False]) and dist_head
    against a host lexsort, then a float64 key with 40% NaN against a host
    recomputation of the splitters and the placement."""
    from cylon_tpu_torch import CylonContext, Table
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import (DTable, dist_head, dist_sort,
                                          dist_sort_multi)

    n = len(ldata["k"])
    rng = np.random.default_rng(seed + 2)
    null = rng.random(n) < 0.1
    ctx = CylonContext(device=DEVICE, world=WORLD)
    dt = DTable.from_table(ctx, to_table(ctx, ldata, null))
    k_valid = np.sort(ldata["k"][~null])
    want_bits = bits_sum(torch.from_numpy(ldata["v0"]))
    times = {}
    for ascending in (True, False):
        hash_cuda.launches = 0
        out, secs = wall(lambda: dist_sort(dt, "k", ascending))
        launches = hash_cuda.launches
        local = out.to_table()
        kc = local.column("k")
        nv = int(kc.validity.sum())  # graftlint: ok[implicit-host-sync]
        label = f"dist_sort {'asc' if ascending else 'desc'} world={WORLD}"
        times[label] = secs
        say(label, rows=local.num_rows, seconds=f"{secs:.6f}",
            rows_per_s=f"{n / secs:.0f}", kernel_launches=launches,
            shard_rows=list(map(int, out.counts_host())))
        check(local.num_rows == n, f"{label}: every row kept")
        check(launches == 0, f"{label}: no partition-kernel launch")
        check(bits_sum(local.column("v0").data) == want_bits,
              f"{label}: v0 bit checksum exact")
        check(bool(kc.validity[:nv].all()) and nv == len(k_valid),  # graftlint: ok[implicit-host-sync]
              f"{label}: nulls last")
        want_k = k_valid if ascending else k_valid[::-1].copy()
        check(np.array_equal(kc.data[:nv].cpu().numpy(), want_k),  # graftlint: ok[implicit-host-sync]
              f"{label}: keys == host sort")
    if profile:
        profile_call(f"dist_sort asc world={WORLD}",
                     lambda: dist_sort(dt, "k", True))

    order = np.lexsort((-ldata["v0"], ldata["k"], null))
    hash_cuda.launches = 0
    out, secs = wall(lambda: dist_sort_multi(dt, ["k", "v0"], [True, False]))
    launches = hash_cuda.launches
    local = out.to_table()
    times["dist_sort_multi"] = secs
    say(f"dist_sort_multi k asc, v0 desc world={WORLD}", rows=local.num_rows,
        seconds=f"{secs:.6f}", kernel_launches=launches)
    check(launches == 0, "dist_sort_multi: no partition-kernel launch")
    kc = local.column("k")
    got_valid = kc.validity.cpu().numpy()  # graftlint: ok[implicit-host-sync]
    check(np.array_equal(got_valid, ~null[order]), "dist_sort_multi: nulls")
    check(np.array_equal(np.where(got_valid, kc.data.cpu().numpy(), 0),  # graftlint: ok[implicit-host-sync]
                         np.where(null, 0, ldata["k"])[order]),
          "dist_sort_multi: k == host lexsort")
    check(np.array_equal(local.column("v0").data.cpu().numpy(),  # graftlint: ok[implicit-host-sync]
                         ldata["v0"][order]),
          "dist_sort_multi: v0 == host lexsort")
    head, secs = wall(lambda: dist_head(out, 10))
    times["dist_head"] = secs
    check(head.num_rows == 10 and np.array_equal(
        head.column("v0").data.cpu().numpy(), ldata["v0"][order[:10]]),  # graftlint: ok[implicit-host-sync]
        "dist_head(10) == host lexsort's first 10 rows")
    say("dist_head n=10", seconds=f"{secs:.6f}")

    # float64 key, 40% NaN: the pooled samples reach the NaN tail, so
    # the splitters hold NaN; placement must follow the JAX rule
    m = 1 << 20
    k = rng.standard_normal(m)
    k[rng.random(m) < 0.4] = np.nan
    knull = rng.random(m) < 0.05
    data = {"k": k, "id": np.arange(m, dtype=np.int32)}
    dt = DTable.from_table(ctx, to_table(ctx, data, knull))
    for ascending in (True, False):
        want_pid, sp = host_range_pids(k, knull, WORLD, ascending)
        out, secs = wall(lambda: dist_sort(dt, "k", ascending))
        label = f"dist_sort float64 40% NaN {'asc' if ascending else 'desc'}"
        say(label, rows=m, seconds=f"{secs:.6f}",
            splitters=[float(x) for x in sp],
            shard_rows=list(map(int, out.counts_host())))
        if ascending:
            check(bool(np.isnan(sp).any()), f"{label}: NaN among splitters")
        counts = out.counts_host()
        ids = out.column("id").data.view(WORLD, out.cap)
        for s in range(WORLD):
            got = np.sort(ids[s, :int(counts[s])].cpu().numpy())  # graftlint: ok[implicit-host-sync]
            check(np.array_equal(got, np.flatnonzero(want_pid == s)),
                  f"{label}: shard {s} holds the rows of the JAX rule")
        check_shards_ordered(label, out, "k", descending=not ascending)
    return times


# ---------------------------------------------------------------------------
# phase: distributed union / intersect / subtract
# ---------------------------------------------------------------------------

def row_words(data) -> torch.Tensor:
    """Each row of (k, v0, v1, v2) as two int64 words, on the card."""
    w = [torch.from_numpy(data[c]).to(DEVICE).view(torch.int32).long()
         & 0xFFFFFFFF for c in ("k", "v0", "v1", "v2")]
    return torch.stack([(w[0] << 32) | w[1], (w[2] << 32) | w[3]], 1)


def distinct_rows(words: torch.Tensor) -> int:
    """Number of distinct rows, by a lexsort of the two words."""
    perm = torch.sort(words[:, 1], stable=True).indices
    perm = perm[torch.sort(words[perm, 0], stable=True).indices]
    w = words[perm]
    return int(1 + (w[1:] != w[:-1]).any(1).sum())


def set_op_inputs(ldata, seed: int):
    """B = A's first n/2 rows then n/2 fresh rows, and each set op's
    (rows, v0 bit checksum) for A op B, with every row distinct (checked
    on the card, independently of the engine)."""
    n = len(ldata["k"])
    half = n // 2
    fresh, _ = make_side(np.random.default_rng(seed + 3), n - half)
    bdata = {c: np.concatenate([ldata[c][:half], fresh[c]]) for c in ldata}
    check(distinct_rows(torch.cat([row_words(ldata), row_words(fresh)]))
          == n + len(fresh["k"]), "set-op inputs: every row distinct")
    v0 = torch.from_numpy(ldata["v0"])
    want = {"union": (n + len(fresh["k"]),
                      bits_sum(v0) + bits_sum(torch.from_numpy(fresh["v0"]))),
            "intersect": (half, bits_sum(v0[:half])),
            "subtract": (n - half, bits_sum(v0[half:]))}
    return bdata, want


def phase_set_ops(ldata, seed: int, profile: bool):
    """A = one main-path side; B = A's first n/2 rows then n/2 fresh rows.
    With every row distinct (checked on the card, independently of the
    engine): union = 1.5n rows, intersect = n/2, subtract = n/2, and the
    v0 bit checksums follow.  Each set op hashes all four columns of both
    tables: two kernel launches."""
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import (DTable, dist_intersect,
                                          dist_subtract, dist_union)

    n = len(ldata["k"])
    bdata, want = set_op_inputs(ldata, seed)
    ctx = CylonContext(device=DEVICE, world=WORLD)
    a = DTable.from_table(ctx, to_table(ctx, ldata, None))
    b = DTable.from_table(ctx, to_table(ctx, bdata, None))
    launches, times, rows_out = {}, {}, {}
    for name, op in (("union", dist_union), ("intersect", dist_intersect),
                     ("subtract", dist_subtract)):
        hash_cuda.launches = 0
        out, secs = wall(lambda: op(a, b))
        launches[name] = hash_cuda.launches
        times[name] = secs
        rows, bits = want[name]
        local = out.to_table()
        rows_out[name] = local.num_rows
        say(f"dist_{name} world={WORLD}", rows_a=n, rows_b=len(bdata["k"]),
            rows_out=local.num_rows, oracle_rows=rows, seconds=f"{secs:.6f}",
            kernel_launches=launches[name],
            shard_rows=list(map(int, out.counts_host())))
        check(local.num_rows == rows, f"dist_{name}: rows == oracle")
        check(bits_sum(local.column("v0").data) == bits,
              f"dist_{name}: v0 bit checksum exact")
        check(launches[name] == 2, f"dist_{name}: two kernel launches "
              f"(got {launches[name]})")
        counts = out.counts_host()
        for s in range(WORLD):
            cols = tuple(c.data.view(WORLD, out.cap)[s, :int(counts[s])]
                         for c in out.columns)
            pid = plain_hash.partition_ids(
                plain_hash.row_hash(cols, (None,) * len(cols)), WORLD)
            check(bool((pid == s).all()),
                  f"dist_{name}: shard {s} holds only its rows")
    if profile:
        profile_call(f"dist_union world={WORLD}", lambda: dist_union(a, b))
    return launches, times, rows_out


# ---------------------------------------------------------------------------
# phase: the compat route (pycylon, its raw AllToAll, the Java gateway
# through its launcher, the example programs)
# ---------------------------------------------------------------------------

# the example programs and their inputs: A and B are two generated CSVs
# of the examples' own shape, H is A's first half (so every set op has
# rows to keep and to drop)
COMPAT_EXAMPLES = (("join_example.py", "A", "B"),
                   ("set_op_examples.py", "union", "A", "H"),
                   ("set_op_examples.py", "intersect", "A", "H"),
                   ("set_op_examples.py", "subtract", "A", "H"),
                   ("select_project_example.py", "A", "B"),
                   ("groupby_sort_example.py", "A", "B"),
                   ("tpch_example.py",),
                   ("cylon_simple_dataloader.py",),
                   ("cylon_mnist_example.py",),
                   ("strings_hash64_example.py",))


def example_inputs(out_dir, seed: int):
    """The examples' CSVs A, B, H (5,000 rows: an int key with ~1%
    duplicates and three value columns, as ``example_utils.generate_csv``
    writes them) and the row counts the examples must log, from pandas."""
    import pandas as pd

    rng = np.random.default_rng(seed + 8)
    frames = {}
    for name in ("A", "B"):
        frames[name] = pd.DataFrame(
            {"0": rng.integers(0, 4950, 5000),
             **{str(c): np.round(rng.random(5000), 6) for c in (1, 2, 3)}})
    frames["H"] = frames["A"].iloc[:2500]
    paths = {}
    for name, df in frames.items():
        paths[name] = str(out_dir / f"example_{name}.csv")
        df.to_csv(paths[name], index=False)
    a, b, h = (pd.read_csv(paths[n], float_precision="round_trip")
               for n in ("A", "B", "H"))
    da, dh = (set(df.itertuples(index=False, name=None)) for df in (a, h))
    want = {("join_example.py",): (r"Joined has: (\d+) rows",
                                   [len(a.merge(b, on="0"))]),
            ("select_project_example.py",): (
                r"Select kept (\d+) of (\d+) rows",
                [int((a["0"] % 2 == 0).sum()), len(a)]),
            ("groupby_sort_example.py",): (
                r"groupby: (\d+) rows -> (\d+) groups",
                [len(a), a["0"].nunique()])}
    for op, rows in (("union", da | dh), ("intersect", da & dh),
                     ("subtract", da - dh)):
        want[("set_op_examples.py", op)] = (
            rf"{op} of (\d+) and (\d+) rows -> (\d+) rows",
            [len(a), len(h), len(rows)])
    return paths, want


def compat_tables(ctx, ldata, rdata):
    """Both sides through the port's pycylon: numpy → pyarrow →
    ``Table.from_arrow(…, ctx)``."""
    import pyarrow as pa

    from cylon_tpu_torch.pycylon import Table
    return tuple(Table.from_arrow(pa.table(d), ctx) for d in (ldata, rdata))


def comm_round_trip(ctx, seed: int):
    """One ``Communication`` per worker of ``ctx``'s world, each inserting
    seeded buffers (five dtypes, 0-64 KiB, headers of 0-6 ints) for every
    target; every rank's ``received`` list must be what was sent to it,
    in order.  Returns (exchanges, bytes sent, seconds)."""
    from cylon_tpu_torch.pycylon.net import Communication

    P = ctx.get_world_size()
    rng = np.random.default_rng(seed + 6)
    dtypes = (np.float64, np.float32, np.int64, np.int32, np.uint8)
    nbytes, t0 = 0, time.perf_counter()
    for worker in range(P):
        comm = Communication(worker, range(P), range(P), worker, ctx=ctx)
        sent = {t: [] for t in range(P)}
        for i in range(3 * P):
            dt, target = dtypes[i % len(dtypes)], i % P
            buf = (rng.random(int(rng.integers(0, 65536 // 8)))
                   * 1e6).astype(dt)
            hdr = rng.integers(-99, 99, int(rng.integers(0, 7))).astype(
                np.int32)
            check(comm.insert(buf, len(buf), target, hdr, len(hdr)),
                  f"compat comm: insert {i} of worker {worker}")
            sent[target].append((buf, hdr))
            nbytes += buf.nbytes + hdr.nbytes
        comm.wait()
        comm.finish()
        for target in range(P):
            got = comm.received(target)
            check(len(got) == len(sent[target]),
                  f"compat comm: worker {worker} → {target} buffer count")
            for (src, buf, hdr), (want_buf, want_hdr) in zip(
                    got, sent[target]):
                check(src == worker and buf.dtype == want_buf.dtype
                      and np.array_equal(buf, want_buf)
                      and np.array_equal(hdr if hdr is not None else
                                         np.empty(0, np.int32), want_hdr),
                      f"compat comm: worker {worker} → {target} bytes")
    return P, nbytes, time.perf_counter() - t0


class LineGateway:
    """The launcher as Java runs it: ``<launcher> -m pycylon.java_gateway
    mpi``, one JSON request a line on its stdin, one reply a line back."""

    def __init__(self, launcher, cwd):
        self.proc = subprocess.Popen(
            [str(launcher), "-m", "pycylon.java_gateway", "mpi"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=cwd)

    def __call__(self, req):
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        check(bool(line), f"compat gateway: a reply to {req.get('op')}")
        return json.loads(line)

    def close(self) -> int:
        if self.proc.poll() is None:
            self.proc.kill()
        return self.proc.wait(timeout=60)


def in_process_gateway():
    """The same gateway in this process (``serve``'s error wrapping)."""
    from cylon_tpu_torch.pycylon.java_gateway import Gateway

    gw = Gateway("mpi")

    def call(req):
        try:
            return json.loads(json.dumps(gw.handle(req)))
        except Exception as e:  # graftlint: ok[broad-except]
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return call


def gateway_transcript(call, paths, out_csv: str):
    """Every op of the gateway protocol on the CSV pair: the replies with
    table ids masked, and each table a reply names read back through
    ``column_json`` (rows sorted)."""
    steps, ids = [], {}

    def rows(tid):
        n = call({"op": "columns", "id": tid})["value"]
        cols = [call({"op": "column_json", "id": tid, "column": c})["value"]
                for c in range(n)]
        return sorted(zip(*cols), key=repr)

    def run(name, req):
        req = {k: ids.get(v, v) if k in ("id", "left", "right") else
               [ids.get(i, i) for i in v] if k == "ids" else v
               for k, v in req.items()}
        reply = call(req)
        masked = dict(reply)
        if "id" in reply:
            ids[name] = reply["id"]
            masked["id"] = "<id>"
            masked["rows"] = rows(reply["id"])
        if "ids" in reply:
            for i, tid in enumerate(reply["ids"]):
                ids[f"{name}.{i}"] = tid
            masked["ids"] = [rows(t) for t in reply["ids"]]
        if "error" in reply:
            for tid in ids.values():
                masked["error"] = masked["error"].replace(tid, "<id>")
        steps.append((name, req["op"], masked))
        return reply

    run("ping", {"op": "ping"})
    run("l", {"op": "from_csv", "path": paths[0]})
    run("r", {"op": "from_csv", "path": paths[1]})
    for op in ("rows", "columns", "column_names", "show"):
        run(op, {"op": op, "id": "l"})
    for dist in (False, True):
        tag = "dist " if dist else ""
        run(f"{tag}join", {"op": "join", "left": "l", "right": "r",
                           "join_type": "inner", "algorithm": "hash",
                           "distributed": dist})
        for op in ("union", "intersect", "subtract"):
            run(f"{tag}{op}", {"op": op, "left": "l", "right": "r",
                               "distributed": dist})
    run("sort", {"op": "sort", "id": "l", "column": 0})
    run("to_csv", {"op": "to_csv", "id": "sort", "path": out_csv})
    vals = run("k", {"op": "column_json", "id": "l", "column": 0})["value"]
    run("mask", {"op": "select_mask", "id": "l",
                 "mask": [v % 3 == 0 for v in vals]})
    run("expr", {"op": "select_expr", "id": "l", "expr": "k > 500"})
    run("jnp", {"op": "select_expr", "id": "l", "expr": "jnp.abs(k) > 5"})
    run("replaced", {"op": "replace_column", "id": "l", "column": 0,
                     "values": [v * 2 for v in vals], "name": "k2"})
    run("cols", {"op": "table_from_columns",
                 "columns": [{"name": "a", "values": [1, 2, 3]},
                             {"name": "b", "values": [0.5, 1.5, 2.5]}]})
    run("hp", {"op": "hash_partition", "id": "l", "columns": [0], "n": 4})
    run("rr", {"op": "round_robin_partition", "id": "l", "n": 3})
    run("merged", {"op": "merge", "ids": ["hp.0", "hp.1", "hp.2", "hp.3"]})
    run("free", {"op": "free", "id": "cols"})
    run("freed", {"op": "rows", "id": "cols"})
    run("bogus", {"op": "bogus"})
    return steps


def gateway_csvs(out_dir, seed: int):
    """The gateway's seeded CSV pair: l (4,000 rows of an int key ``k``
    and a float ``v``) and r (l's first 1,500 rows and 1,500 new ones),
    and both read back by pandas."""
    import pandas as pd

    rng = np.random.default_rng(seed + 7)

    def frame(n):
        return pd.DataFrame({"k": rng.integers(0, 1000, n),
                             "v": np.round(rng.random(n), 6)})
    left = frame(4000)
    right = pd.concat([left.iloc[:1500], frame(1500)], ignore_index=True)
    paths = [str(out_dir / f"gateway_{i}.csv") for i in (0, 1)]
    for df, path in zip((left, right), paths):
        df.to_csv(path, index=False)
    return paths, [pd.read_csv(p, float_precision="round_trip")
                   for p in paths]


def _tuples(df):
    """A frame's rows as host tuples, in ``gateway_transcript``'s order."""
    return sorted(zip(*(df[c].tolist() for c in df.columns)), key=repr)


def check_gateway(steps, ldf, rdf, out_csv: str) -> None:
    """Each reply of ``gateway_transcript`` against pandas on the same
    CSVs: every step answers ok but the three that must not (an
    expression naming ``jnp``, a freed id, an unknown op), and every
    table a step returns holds the rows pandas computes."""
    import pandas as pd

    must_fail = ("jnp", "freed", "bogus")
    for name, op, r in steps:
        check(r.get("ok") is (name not in must_fail),
              f"compat gateway {name} ({op}): ok={r.get('ok')} "
              f"{r.get('error', '')}")
    got = {name: r for name, _, r in steps}
    lrows = _tuples(ldf)
    m = ldf.merge(rdf, on="k")
    want = {"l": lrows, "r": _tuples(rdf), "sort": lrows, "merged": lrows,
            "join": _tuples(pd.DataFrame({"a": m.k, "b": m.v_x,
                                          "c": m.k, "d": m.v_y})),
            "mask": _tuples(ldf[ldf.k % 3 == 0]),
            "expr": _tuples(ldf[ldf.k > 500]),
            "replaced": _tuples(ldf.assign(k=ldf.k * 2)),
            "cols": [(1, 0.5), (2, 1.5), (3, 2.5)]}
    want["dist join"] = want["join"]
    dl, dr = set(lrows), set(_tuples(rdf))
    for op, rows in (("union", dl | dr), ("intersect", dl & dr),
                     ("subtract", dl - dr)):
        want[op] = want[f"dist {op}"] = sorted(rows, key=repr)
    check(all(want[n] for n in ("intersect", "subtract", "mask", "expr")),
          "compat gateway: every selection and set op has rows to keep")
    for name, rows in want.items():
        check(got[name]["rows"] == rows,
              f"compat gateway {name}: {len(got[name]['rows'])} rows == "
              f"pandas' {len(rows)}, the same values")
    check(got["rows"]["value"] == len(ldf) and got["columns"]["value"] == 2
          and got["column_names"]["value"] == ["k", "v"]
          and got["k"]["value"] == ldf.k.tolist()
          and isinstance(got["show"]["value"], str),
          "compat gateway: rows, columns, column_names, column_json, show")
    hp, rr = got["hp"]["ids"], got["rr"]["ids"]
    keys = [{row[0] for row in part} for part in hp]
    check(len(hp) == 4 and sorted(sum(hp, []), key=repr) == lrows
          and sum(map(len, keys)) == len(set().union(*keys)),
          "compat gateway: hash_partition = l in 4 parts, each key in one")
    check(len(rr) == 3 and sorted(sum(rr, []), key=repr) == lrows
          and max(map(len, rr)) - min(map(len, rr)) <= 1,
          "compat gateway: round_robin_partition = l in 3 even parts")
    written = pd.read_csv(out_csv, float_precision="round_trip")
    check(written["k"].is_monotonic_increasing
          and _tuples(written) == lrows,
          "compat gateway: to_csv wrote l sorted on k")


def phase_compat(ldata, rdata, want, setop_rows, seed: int, smi_line: str):
    """The compat route on the card.  The join cell through the port's
    pycylon (``Table.from_arrow`` with ``CylonContext("mpi", world=4)``):
    ``distributed_join(ctx, right, "inner", "hash", 0, 0)`` against the
    oracle of the HASH join phase (2 partition-kernel launches), then
    ``distributed_union`` / ``_intersect`` / ``_subtract`` of the set-op
    phase's inputs (rows and v0 bit checksums = that phase's oracle and
    its rows, 2 launches each); a ``Communication`` round trip at world 4
    (every received buffer checked); the launcher spawned with the Java
    binding's exact argv driving every gateway op on a small seeded CSV
    pair, each reply ok (but the three that must fail) and its tables
    equal to pandas on the same CSVs, then equal to the same request's
    in-process reply; the example programs on the card in parallel, each
    exiting 0 and the join, set-op, select and groupby ones logging the
    row counts pandas computes."""
    from pathlib import Path

    import pandas as pd

    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.pycylon import CylonContext

    root = Path(__file__).resolve().parent
    launches = {}
    ctx = CylonContext("mpi", world=WORLD)
    check(ctx.get_world_size() == WORLD
          and ctx.device.type == torch.device(DEVICE).type,
          "compat: CylonContext('mpi', world=4) on the card")
    (left, right), secs = wall(lambda: compat_tables(ctx, ldata, rdata))
    say(f"compat ingest world={WORLD}", rows=left.rows + right.rows,
        seconds=f"{secs:.6f}")
    reset_launches()
    joined, secs = wall(lambda: left.distributed_join(ctx, right, "inner",
                                                      "hash", 0, 0))
    launches["distributed_join"] = hash_cuda.launches
    say(f"compat distributed_join inner hash world={WORLD}",
        rows_out=joined.rows, oracle_rows=want["inner"],
        seconds=f"{secs:.6f}",
        rows_per_s=f"{(left.rows + right.rows) / secs:.0f}",
        kernel_launches=launches["distributed_join"])
    check_join("compat distributed_join", joined.backing, want)
    check(launches["distributed_join"] == 2,
          f"compat distributed_join: 2 kernel launches (got "
          f"{launches['distributed_join']})")
    del joined, left, right

    bdata, setop_want = set_op_inputs(ldata, seed)
    a, b = compat_tables(ctx, ldata, bdata)
    for name in ("union", "intersect", "subtract"):
        reset_launches()
        out, secs = wall(lambda: getattr(a, f"distributed_{name}")(ctx, b))
        launches[f"distributed_{name}"] = hash_cuda.launches
        rows, bits = setop_want[name]
        say(f"compat distributed_{name} world={WORLD}", rows_out=out.rows,
            oracle_rows=rows, set_op_phase_rows=setop_rows[name],
            seconds=f"{secs:.6f}",
            kernel_launches=launches[f"distributed_{name}"])
        check(out.rows == rows == setop_rows[name],
              f"compat distributed_{name}: rows == the set-op phase's")
        check(bits_sum(out.backing.column("v0").data) == bits,
              f"compat distributed_{name}: v0 bit checksum exact")
        check(launches[f"distributed_{name}"] == 2,
              f"compat distributed_{name}: 2 kernel launches")
        del out
    del a, b

    P, nbytes, secs = comm_round_trip(ctx, seed)
    say(f"compat Communication world={P}", exchanges=P, bytes=nbytes,
        seconds=f"{secs:.6f}", checked="every received buffer")

    torch.cuda.empty_cache()
    out_dir = root / "build" / "compat"
    out_dir.mkdir(parents=True, exist_ok=True)
    # the example programs, all at once, each in its own process
    ex_paths, ex_want = example_inputs(out_dir, seed)
    env = dict(os.environ, CYLON_MINLOGLEVEL="0")
    t_ex = time.perf_counter()
    examples = [(args, subprocess.Popen(
        [sys.executable, str(root / "cylon_tpu_torch" / "examples" / args[0]),
         *(ex_paths.get(a, a) for a in args[1:])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=out_dir, env=env))
        for args in COMPAT_EXAMPLES]

    # the gateway: a seeded CSV pair, the launcher with Java's argv, each
    # reply held against pandas, then against the same gateway in this
    # process
    paths, (ldf, rdf) = gateway_csvs(out_dir, seed)
    launcher = root / "cylon_tpu_torch" / "pycylon" / "java_launcher.py"
    t0 = time.perf_counter()
    remote = LineGateway(launcher, out_dir)
    try:
        got = gateway_transcript(remote, paths, str(out_dir / "sub.csv"))
        bye = remote({"op": "shutdown"})
        rc = remote.proc.wait(timeout=120)
    finally:
        remote.close()
    gw_secs = time.perf_counter() - t0
    check(bye == {"ok": True, "shutdown": True} and rc == 0,
          f"compat gateway: shutdown exits 0 (got {bye}, {rc})")
    check_gateway(got, ldf, rdf, str(out_dir / "sub.csv"))
    reset_launches()
    local = in_process_gateway()
    t0 = time.perf_counter()
    mine = gateway_transcript(local, paths, str(out_dir / "in.csv"))
    in_secs = time.perf_counter() - t0
    launches["gateway_in_process"] = hash_cuda.launches
    check([s[:2] for s in got] == [s[:2] for s in mine],
          "compat gateway: the same ops")
    for (name, op, g), (_, _, m) in zip(got, mine):
        check(g == m, f"compat gateway {name} ({op}): the launcher's reply "
              f"== the in-process reply")
    check(pd.read_csv(out_dir / "sub.csv").equals(
          pd.read_csv(out_dir / "in.csv")),
          "compat gateway: to_csv wrote the same rows in both")
    say("compat gateway", launcher=launcher.name, argv="-m "
        "pycylon.java_gateway mpi", ops=len(got), replies_ok_and_oracle=
        len(got), replies_equal=len(got), seconds=f"{gw_secs:.6f}",
        in_process_seconds=f"{in_secs:.6f}",
        in_process_kernel_launches=launches["gateway_in_process"])
    check(launches["gateway_in_process"] > 0,
          "compat gateway: the partition kernel ran (world 8)")

    failed = []
    for args, proc in examples:
        out, _ = proc.communicate(timeout=600)
        pattern, want_counts = ex_want.get(
            tuple(a for a in args if a not in ex_paths), (None, None))
        found = re.search(pattern, out) if pattern else None
        logged = [int(g) for g in found.groups()] if found else None
        say(f"compat example {' '.join(args)}", exit_code=proc.returncode,
            logged=logged, pandas=want_counts)
        if proc.returncode != 0 or logged != want_counts:
            failed.append((args, out[-3000:]))
    ex_secs = time.perf_counter() - t_ex
    for args, out in failed:
        print(out, flush=True)
    check(not failed, f"compat examples: every one exits 0 and logs the "
          f"counts pandas computes (failed: {[a for a, _ in failed]})")
    say("compat examples", runs=len(COMPAT_EXAMPLES), seconds=f"{ex_secs:.3f}",
        card=repr(smi_line))
    return launches


# ---------------------------------------------------------------------------
# phases: groupby / select / aggregate on a TPC-H lineitem-shaped table
# ---------------------------------------------------------------------------

SHIP_DAYS = 2526          # l_shipdate spans 1992-01-02 .. 1998-12-01
Q1_CUTOFF = SHIP_DAYS - 90  # Q1: shipdate <= 1998-12-01 - 90 days
Q6_FROM, Q6_TO = 731, 1096  # Q6: shipdate in [1994-01-01, 1995-01-01)
HC_AGGS = [("quantity", "sum"), ("price", "sum"), ("price", "mean"),
           ("price", "count"), ("discount", "min"), ("shipdate", "max")]
Q1_AGGS = [("quantity", "sum"), ("price", "sum"), ("disc_price", "sum"),
           ("quantity", "mean"), ("discount", "mean"), ("quantity", "count")]


def make_lineitem(rng, n: int):
    """``lineitem``'s shape (TPC-H §1.4, §4.2.3): about 4 lines per
    order, int32 flag/status codes, quantity in [1, 50], discount in
    {0.00, …, 0.10}, a day-number ship date; 10% of prices null (0 under
    the null, as ingest stores it).  Returns (numpy columns, price null
    mask)."""
    data = {
        "orderkey": rng.integers(0, n // 4, n, dtype=np.int64),
        "returnflag": rng.integers(0, 3, n, dtype=np.int32),
        "linestatus": rng.integers(0, 2, n, dtype=np.int32),
        "quantity": rng.integers(1, 51, n, dtype=np.int32),
        "price": rng.uniform(900.0, 105000.0, n),
        "discount": rng.integers(0, 11, n) / 100.0,
        "shipdate": rng.integers(0, SHIP_DAYS, n, dtype=np.int32),
    }
    null = rng.random(n) < 0.1
    data["price"][null] = 0.0
    return data, null


def lineitem_dtable(data, null):
    from cylon_tpu_torch import CylonContext, Table
    from cylon_tpu_torch.parallel import DTable

    ctx = CylonContext(device=DEVICE, world=WORLD)
    t = Table.from_columns(ctx, data)
    t.column("price").validity = torch.from_numpy(~null).to(ctx.device)
    return DTable.from_table(ctx, t)


def rel_close(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all(np.abs(a - b) <= REL_TOL * np.maximum(
        np.maximum(np.abs(a), np.abs(b)), 1.0)))


def engine_result(out, keys):
    """A groupby's result on the host, its rows sorted by the keys:
    {column: numpy data}, plus {column: numpy validity} of nullable ones."""
    local = out.to_table()
    order = torch.arange(local.num_rows, device=DEVICE)
    for k in reversed(keys):
        col = local.column(k).data[order]
        order = order[torch.sort(col, stable=True).indices]
    data = {c.name: c.data[order].cpu().numpy() for c in local.columns}  # graftlint: ok[implicit-host-sync]
    valid = {c.name: c.validity[order].cpu().numpy() for c in local.columns  # graftlint: ok[implicit-host-sync]
             if c.validity is not None}
    return data, valid


def host_orderkey_groups(d, null):
    """The orderkey groupby in numpy: one argsort of (orderkey, input
    shard), then reduceat.  Also the partial groups each world-4 input
    shard holds (the distinct keys of its contiguous block), which decide
    the combine."""
    n = len(d["orderkey"])
    base, rem = divmod(n, WORLD)
    offs = np.cumsum([0] + [base + (1 if i < rem else 0) for i in range(WORLD)])
    shard = np.repeat(np.arange(WORLD), np.diff(offs))
    order = np.argsort(d["orderkey"] * WORLD + shard)
    ks = d["orderkey"][order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    sh = shard[order]
    new_pair = np.r_[True, (ks[1:] != ks[:-1]) | (sh[1:] != sh[:-1])]
    partial = np.bincount(sh[new_pair], minlength=WORLD)
    valid = ~null[order]
    cnt = np.add.reduceat(valid.astype(np.int64), starts)
    sp = np.add.reduceat(np.where(valid, d["price"][order], 0.0), starts)
    return {"orderkey": ks[starts],
            "sum_quantity": np.add.reduceat(
                d["quantity"][order].astype(np.int64), starts),
            "sum_price": sp, "count_price": cnt,
            "mean_price": sp / np.maximum(cnt, 1), "mean_valid": cnt > 0,
            "min_discount": np.minimum.reduceat(d["discount"][order], starts),
            "max_shipdate": np.maximum.reduceat(d["shipdate"][order], starts),
            "partial_groups": partial}


def check_orderkey_groups(label: str, got, valid, want) -> None:
    check(len(got["orderkey"]) == len(want["orderkey"]),
          f"{label}: {len(got['orderkey'])} groups == oracle's "
          f"{len(want['orderkey'])}")
    for c in ("orderkey", "sum_quantity", "count_price", "min_discount",
              "max_shipdate"):
        check(np.array_equal(got[c], want[c]), f"{label}: {c} exact")
    check(rel_close(got["sum_price"], want["sum_price"]),
          f"{label}: sum_price within {REL_TOL} relative")
    check(np.array_equal(valid["mean_price"], want["mean_valid"]),
          f"{label}: mean_price nulls")
    m = want["mean_valid"]
    check(rel_close(got["mean_price"][m], want["mean_price"][m]),
          f"{label}: mean_price within {REL_TOL} relative")


def check_group_placement(label: str, out, rule: str) -> None:
    """Every group sits on the shard its key routes to: the plain hash
    partition id after a hash shuffle (``rule="hash"``), ``key mod P`` on
    the dense path (``"mod"``), shard 0 after the broadcast combine."""
    from cylon_tpu_torch.ops import hash as plain_hash

    counts = out.counts_host()
    keys = out.column("orderkey").data.view(WORLD, out.cap)
    for s in range(WORLD):
        k = keys[s, :int(counts[s])]
        if rule == "mod":
            pid = k % WORLD
        elif rule == "hash":
            pid = plain_hash.partition_ids(plain_hash.row_hash((k,), (None,)),
                                           WORLD)
        else:
            pid = torch.zeros_like(k)
        check(bool((pid == s).all()), f"{label}: shard {s} holds only its keys")


def phase_groupby_orderkey(dt, data, null, profile: bool):
    """GROUP BY orderkey (about 4.2M groups) three ways: pre-aggregate +
    shuffle combine (the default), the raw-row shuffle, the dense path."""
    from cylon_tpu_torch.config import broadcast_join_threshold
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.ops.compact import next_bucket
    from cylon_tpu_torch.parallel import dist_groupby

    n = len(data["orderkey"])
    t0 = time.perf_counter()
    want = host_orderkey_groups(data, null)
    partial = want.pop("partial_groups")
    # the combine's rule: an all_gather when the partial table's capacity
    # bound (P × the bucketed largest shard) is within the threshold
    bound = WORLD * next_bucket(int(partial.max()), minimum=8)
    combine = "broadcast" if bound <= broadcast_join_threshold() else "shuffle"
    say("groupby orderkey oracle", groups=len(want["orderkey"]),
        partial_groups=list(map(int, partial)), combine=combine,
        host_seconds=f"{time.perf_counter() - t0:.3f}")
    variants = (("default", {}, "hash" if combine == "shuffle" else "shard0"),
                ("pre_aggregate=False", {"pre_aggregate": False}, "hash"),
                ("dense_key_range", {"dense_key_range": (0, n // 4 - 1)},
                 "mod" if combine == "shuffle" else "shard0"))
    launches, times, results = {}, {}, []
    for label, kw, rule in variants:
        torch.cuda.reset_peak_memory_stats()
        hash_cuda.launches = 0
        out, secs = wall(lambda: dist_groupby(dt, ["orderkey"], HC_AGGS, **kw))
        launches[label] = hash_cuda.launches
        times[label] = secs
        got, valid = engine_result(out, ["orderkey"])
        name = f"dist_groupby orderkey {label} world={WORLD}"
        say(name, rows=n, seconds=f"{secs:.6f}", rows_per_s=f"{n / secs:.0f}",
            groups=len(got["orderkey"]), kernel_launches=launches[label],
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            shard_groups=list(map(int, out.counts_host())), cap=out.cap)
        check_orderkey_groups(name, got, valid, want)
        check_group_placement(name, out, rule)
        results.append(got)
    check(launches["default"] == (1 if combine == "shuffle" else 0),
          f"default ({combine} combine): {launches['default']} launches")
    check(launches["pre_aggregate=False"] == 1, "raw shuffle: 1 launch")
    check(launches["dense_key_range"] == 0, "dense path: no launch")
    for got in results[1:]:
        for c in results[0]:
            same = (rel_close(got[c], results[0][c])
                    if got[c].dtype.kind == "f" else
                    np.array_equal(got[c], results[0][c]))
            check(same, f"the three orderkey variants agree on {c}")
    if profile:
        profile_call(f"dist_groupby orderkey default world={WORLD}",
                     lambda: dist_groupby(dt, ["orderkey"], HC_AGGS))
    return launches, times


def phase_q1(dt, data, null, profile: bool):
    """The TPC-H Q1 shape: a derived column, then six groups under a
    ``where`` — the broadcast combine, no kernel launch."""
    from cylon_tpu_torch import Type
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import dist_groupby, dist_with_column

    n = len(data["orderkey"])
    where = lambda env: env["shipdate"] <= Q1_CUTOFF  # noqa: E731

    def q1():
        d = dist_with_column(dt, "disc_price",
                             lambda env: env["price"] * (1 - env["discount"]),
                             Type.DOUBLE, validity_from=["price"])
        return dist_groupby(d, ["returnflag", "linestatus"], Q1_AGGS,
                            where=where)

    torch.cuda.reset_peak_memory_stats()
    hash_cuda.launches = 0
    out, secs = wall(q1)
    launches = hash_cuda.launches
    got, valid = engine_result(out, ["returnflag", "linestatus"])
    label = f"dist_groupby Q1 shape world={WORLD}"
    say(label, rows=n, seconds=f"{secs:.6f}", rows_per_s=f"{n / secs:.0f}",
        groups=len(got["returnflag"]), kernel_launches=launches,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        shard_groups=list(map(int, out.counts_host())))
    check(launches == 0, f"{label}: broadcast combine, no launch")
    check(list(out.counts_host()) == [6] + [0] * (WORLD - 1),
          f"{label}: the 6 groups on shard 0")
    on0 = out.partition(0)
    keys = list(zip(on0.column("returnflag").data.tolist(),  # graftlint: ok[implicit-host-sync]
                    on0.column("linestatus").data.tolist()))  # graftlint: ok[implicit-host-sync]
    check(keys == [(f, s) for f in range(3) for s in range(2)],
          f"{label}: shard 0 in key order")
    m = data["shipdate"] <= Q1_CUTOFF
    mv = m & ~null
    gid = data["returnflag"] * 2 + data["linestatus"]
    bc = lambda mask, w=None: np.bincount(gid[mask], minlength=6,  # noqa: E731
                                          weights=None if w is None else w[mask])
    disc_price = data["price"] * (1 - data["discount"])
    cnt = bc(m)
    want = {"sum_quantity": bc(m, data["quantity"]).astype(np.int64),
            "count_quantity": cnt,
            "sum_price": bc(mv, data["price"]),
            "sum_disc_price": bc(mv, disc_price),
            "mean_quantity": bc(m, data["quantity"]) / cnt,
            "mean_discount": bc(m, data["discount"]) / cnt}
    for c in ("sum_quantity", "count_quantity"):
        check(np.array_equal(got[c], want[c]), f"{label}: {c} exact")
    for c in ("sum_price", "sum_disc_price", "mean_quantity", "mean_discount"):
        check(rel_close(got[c], want[c]),
              f"{label}: {c} within {REL_TOL} relative")
    if profile:
        profile_call(f"dist_groupby Q1 shape world={WORLD}", q1)
    return launches, secs


def phase_q6(dt, data, null):
    """The TPC-H Q6 shape: a scalar ``dist_aggregate`` under a ``where``,
    then ``dist_select`` compacting and deferred, each into a
    ``dist_groupby``; survivor counts and revenue against numpy."""
    from cylon_tpu_torch import Type
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import (dist_aggregate, dist_groupby,
                                          dist_select, dist_with_column)

    n = len(data["orderkey"])

    def q6(env):
        return ((env["shipdate"] >= Q6_FROM) & (env["shipdate"] < Q6_TO)
                & (env["discount"] >= 0.05) & (env["discount"] <= 0.07)
                & (env["quantity"] < 24))

    m = ((data["shipdate"] >= Q6_FROM) & (data["shipdate"] < Q6_TO)
         & (data["discount"] >= 0.05) & (data["discount"] <= 0.07)
         & (data["quantity"] < 24))
    rev = data["price"] * data["discount"]
    mv = m & ~null
    want_rev = float(rev[mv].sum())
    want_ls = np.bincount(data["linestatus"][mv], weights=rev[mv], minlength=2)
    want_cnt = np.bincount(data["linestatus"][m], minlength=2)
    torch.cuda.reset_peak_memory_stats()
    hash_cuda.launches = 0
    dtr = dist_with_column(dt, "rev",
                           lambda env: env["price"] * env["discount"],
                           Type.DOUBLE, validity_from=["price"])
    agg, secs = wall(lambda: dist_aggregate(
        dtr, [("rev", "sum"), ("quantity", "count")], where=q6))
    got_rev = float(agg.column("sum_rev").data[0])  # graftlint: ok[implicit-host-sync]
    got_cnt = int(agg.column("count_quantity").data[0])  # graftlint: ok[implicit-host-sync]
    label = f"dist_aggregate Q6 shape world={WORLD}"
    say(label, rows=n, seconds=f"{secs:.6f}", rows_per_s=f"{n / secs:.0f}",
        survivors=got_cnt, oracle_survivors=int(m.sum()), revenue=got_rev,
        oracle_revenue=want_rev)
    check(got_cnt == int(m.sum()), f"{label}: survivors == oracle")
    check(rel_close(np.array([got_rev]), np.array([want_rev])),
          f"{label}: revenue within {REL_TOL} relative")
    times = {"aggregate": secs}
    for compact in (True, False):
        def run():
            sel = dist_select(dtr, q6, compact=compact)
            return dist_groupby(sel, ["linestatus"], [("rev", "sum"),
                                                      ("quantity", "count")])
        out, secs = wall(run)
        got, _ = engine_result(out, ["linestatus"])
        name = f"dist_select(compact={compact}) + dist_groupby Q6 world={WORLD}"
        times[f"select compact={compact}"] = secs
        say(name, rows=n, seconds=f"{secs:.6f}", rows_per_s=f"{n / secs:.0f}",
            groups=len(got["linestatus"]),
            survivors=int(got["count_quantity"].sum()))
        check(np.array_equal(got["count_quantity"], want_cnt),
              f"{name}: survivors per linestatus == oracle")
        check(rel_close(got["sum_rev"], want_ls),
              f"{name}: revenue per linestatus within {REL_TOL} relative")
    launches = hash_cuda.launches
    say(f"Q6 shape world={WORLD}", kernel_launches=launches,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    check(launches == 0, "Q6 shape: no partition-kernel launch")
    return launches, times


# ---------------------------------------------------------------------------
# phases: TPC-H (generate on the card, the 22 queries, numpy oracles, and
# world 1 against world 4)
# ---------------------------------------------------------------------------

TPCH_WINDOW = 65_536  # rows checked against the host mirror at each end


def tpch_generate(sf: float, world: int, seed: int):
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.tpch import generate_device

    ctx = CylonContext(device=DEVICE, world=world)
    tables, secs = wall(lambda: generate_device(ctx, sf, seed=seed))
    return ctx, tables, secs


def host_columns(dt, names):
    """Columns of a DTable on the host (one device → host copy each)."""
    from cylon_tpu_torch.parallel import dist_project

    t = dist_project(dt, names).to_table()
    return {c.name: c.data.cpu().numpy() for c in t.columns}  # graftlint: ok[implicit-host-sync]


def phase_tpch_generate(sf: float, seed: int):
    """The eight tables at ``sf`` on the card at world 4; the first and
    last 65,536 rows of each equal ``generate_mirror``'s, bit for bit."""
    from cylon_tpu_torch.tpch import generate_mirror

    torch.cuda.reset_peak_memory_stats()
    ctx, tables, secs = tpch_generate(sf, WORLD, seed)
    rows = {n: dt.num_rows for n, dt in tables.items()}
    nbytes = sum(c.data.numel() * c.data.element_size()
                 for dt in tables.values() for c in dt.columns)
    say(f"tpch generate sf={sf} world={WORLD}", seconds=f"{secs:.6f}",
        rows=rows, gib=f"{nbytes / 2**30:.2f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    t0 = time.perf_counter()
    for name, dt in tables.items():
        n = rows[name]
        local = dt.to_table()
        for lo in sorted({0, max(n - TPCH_WINDOW, 0)}):
            hi = min(lo + TPCH_WINDOW, n)
            want, _ = generate_mirror(sf, seed=seed, tables=[name],
                                      rows=(lo, hi))
            for c in local.columns:
                got = c.data[lo:hi].cpu().numpy()  # graftlint: ok[implicit-host-sync]
                w = want[name][c.name]
                check(got.dtype == w.dtype and np.array_equal(
                    got.view(np.int32) if got.dtype == np.float32 else got,
                    w.view(np.int32) if w.dtype == np.float32 else w),
                    f"tpch {name}.{c.name} rows [{lo}, {hi}) == mirror")
        del local
    say("tpch generate vs mirror", rows_per_end=TPCH_WINDOW,
        exact="yes", host_seconds=f"{time.perf_counter() - t0:.3f}")
    return ctx, tables, secs


def run_query(q: str, ctx, tables, planned: bool = False):
    """One query through its entry point (``ctx.optimize`` when
    ``planned``), from an empty replica cache: (result, seconds, peak GiB,
    kernel launches, join decisions, trace counters)."""
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import broadcast, dist_ops
    from cylon_tpu_torch.tpch import QUERIES

    def op(t):
        return QUERIES[q](ctx, t)

    broadcast.clear_replica_cache()
    torch.cuda.reset_peak_memory_stats()
    dist_ops.decisions.clear()
    trace.reset()
    hash_cuda.launches = 0
    out, secs = wall(lambda: ctx.optimize(op, tables) if planned
                     else op(tables))
    return (out, secs, torch.cuda.max_memory_allocated() / 2**30,
            hash_cuda.launches, dict(dist_ops.decisions), trace.counters())


def wire_bytes(counters) -> int:
    """Bytes the exchanges moved between shards."""
    return (counters.get("shuffle.bytes_sent", 0)
            + counters.get("broadcast.bytes_sent", 0))


def phase_tpch_queries(ctx, tables, sf: float, profile: bool):
    """All 22 queries at world 4, one line each, then the geometric
    mean; ``--profile`` adds device-time tables of the two slowest."""
    from cylon_tpu_torch.tpch import QUERIES

    results, times, launches, wire, reads = {}, {}, {}, {}, {}
    for q in QUERIES:
        out, secs, peak, n_launch, taken, cnt = run_query(q, ctx, tables)
        results[q], times[q], launches[q] = out, secs, n_launch
        wire[q] = wire_bytes(cnt)
        reads[q] = cnt.get("host.read", 0)
        say(f"tpch {q} sf={sf} world={WORLD}", seconds=f"{secs:.6f}",
            rows=out.num_rows, peak_gib=f"{peak:.2f}",
            kernel_launches=n_launch, wire_bytes=wire[q],
            host_reads=reads[q],
            decisions=",".join(f"{k}:{v}" for k, v in sorted(taken.items()))
            or "none")
        if sf >= 1:  # below SF 1 Q11's HAVING fraction can select none
            check(out.num_rows > 0, f"tpch {q}: a non-empty result")
    geo = float(np.exp(np.mean(np.log(list(times.values())))))
    say(f"tpch sf={sf} world={WORLD}", queries=len(times),
        total_seconds=f"{sum(times.values()):.6f}",
        geomean_seconds=f"{geo:.6f}",
        kernel_launches=sum(launches.values()))
    if profile:
        for q in sorted(times, key=times.get)[-2:]:
            profile_call(f"tpch {q} sf={sf} world={WORLD}",
                         lambda: QUERIES[q](ctx, tables))
    return results, times, launches, wire, reads


def same_ordered(label: str, a, b) -> None:
    """Result ``a`` against result ``b``: the same columns, types, rows and
    order; keys and integers exact, floats within ``_rtol``."""
    check([(c.name, c.data.dtype) for c in a.columns]
          == [(c.name, c.data.dtype) for c in b.columns]
          and a.num_rows == b.num_rows,
          f"{label}: the same columns, types and row count")
    ca, cb = _cols(a), _cols(b)
    for c in ca:
        x, y = ca[c], cb[c]
        ok = (_close(x, y, _rtol(c, x)) if x.dtype.kind == "f"
              else np.array_equal(x, y))
        check(ok, f"{label}: column {c} equal, in order")


def phase_tpch_planner(ctx, tables, sf: float, eager, eager_times,
                       eager_wire):
    """All 22 queries through ``ctx.optimize`` twice: the first pass
    misses the plan cache, the second hits it for every query; each
    planned result equals the eager one of this run.  One line per query,
    then a summary."""
    from cylon_tpu_torch import plan
    from cylon_tpu_torch.tpch import QUERIES

    plan.clear_plan_cache()
    runs = {}
    for p in ("miss", "hit"):
        runs[p] = {q: run_query(q, ctx, tables, planned=True)
                   for q in QUERIES}
    launches, fewer = {}, []
    for q in QUERIES:
        miss, hit = runs["miss"][q], runs["hit"][q]
        cm, ch = miss[5], hit[5]
        check(cm.get("plan.cache_miss", 0) >= 1,
              f"tpch planner {q}: the first pass plans")
        check(ch.get("plan.cache_miss", 0) == 0
              and ch.get("plan.cache_hit", 0) >= 1,
              f"tpch planner {q}: the second pass hits the plan cache")
        same_ordered(f"tpch planner {q} (miss) == eager", miss[0], eager[q])
        same_ordered(f"tpch planner {q} (hit) == eager", hit[0], eager[q])
        launches[q] = hit[3]
        wb = wire_bytes(ch)
        if wb < eager_wire[q]:
            fewer.append(q)
        say(f"tpch planner {q} sf={sf} world={WORLD}",
            miss_seconds=f"{miss[1]:.6f}", hit_seconds=f"{hit[1]:.6f}",
            eager_seconds=f"{eager_times[q]:.6f}",
            peak_gib=f"{hit[2]:.2f}", kernel_launches=hit[3],
            cache_hit=ch.get("plan.cache_hit", 0),
            cache_miss=cm.get("plan.cache_miss", 0),
            rule_fires=ch.get("optimizer.rule_fires", 0),
            row_bytes_pre=ch.get("optimizer.row_bytes_pre", 0),
            row_bytes_post=ch.get("optimizer.row_bytes_post", 0),
            plan_build_us=cm.get("compile.plan_build_us", 0),
            wire_bytes=wb, eager_wire_bytes=eager_wire[q],
            decisions=",".join(f"{k}:{v}" for k, v in sorted(hit[4].items()))
            or "none")
    geo = {p: float(np.exp(np.mean(np.log([runs[p][q][1] for q in QUERIES]))))
           for p in runs}
    say(f"tpch planner sf={sf} world={WORLD}", queries=len(QUERIES),
        fewer_wire_bytes=len(fewer), which=",".join(fewer) or "none",
        total_miss_seconds=f"{sum(r[1] for r in runs['miss'].values()):.6f}",
        total_hit_seconds=f"{sum(r[1] for r in runs['hit'].values()):.6f}",
        total_eager_seconds=f"{sum(eager_times.values()):.6f}",
        geomean_miss_seconds=f"{geo['miss']:.6f}",
        geomean_hit_seconds=f"{geo['hit']:.6f}",
        kernel_launches=sum(launches.values()))
    return launches


def _cols(t):
    """A result Table's columns on the host, strings decoded."""
    out = {}
    for c in t.columns:
        v = c.data.cpu().numpy()  # graftlint: ok[implicit-host-sync]
        out[c.name] = (np.asarray(c.dictionary, dtype=object)[v]
                       if c.dictionary is not None else v)
    return out


def _close(a, b, rtol: float) -> bool:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return a.shape == b.shape and bool(np.all(
        np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1e-300)))


F32_RTOL = 1e-6  # a float32 result (its float64 sum rounded once)
# float64 means of float32 columns: at world > 1 their per-shard partial
# sums are float32 (a float32 column's sum keeps its type), so they carry
# float32 precision
F32_MEANS = {"mean_l_quantity", "mean_l_extendedprice", "mean_l_discount"}


def _rtol(name: str, x: np.ndarray) -> float:
    return F32_RTOL if x.dtype == np.float32 or name in F32_MEANS \
        else REL_TOL


def phase_tpch_oracles(tables, results, sf: float):
    """Q1, Q3, Q4, Q6, Q14, Q18 and Q22 recomputed in numpy from host
    copies of the generated tables; the dense keys make every FK join an
    array index.  Float32 products are formed as the engine forms them and
    summed in float64: floats within ``_rtol`` relative, keys and counts
    exact."""
    from cylon_tpu_torch.tpch.datagen import PRIORITIES, date_to_days
    from cylon_tpu_torch.tpch.datagen_device import SEGMENTS, TYPE_POOL

    f32 = np.float32
    t0 = time.perf_counter()
    li = host_columns(tables["lineitem"], [
        "l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_returnflag", "l_linestatus", "l_shipdate",
        "l_commitdate", "l_receiptdate"])
    od = host_columns(tables["orders"], [
        "o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
        "o_shippriority", "o_totalprice"])
    cu = host_columns(tables["customer"], ["c_custkey", "c_mktsegment",
                                           "c_acctbal", "c_phone_cc"])
    pa_ = host_columns(tables["part"], ["p_partkey", "p_type"])
    n_ord, n_cust = len(od["o_orderkey"]), len(cu["c_custkey"])
    check(np.array_equal(od["o_orderkey"], np.arange(1, n_ord + 1)) and
          np.array_equal(cu["c_custkey"], np.arange(1, n_cust + 1)) and
          np.array_equal(pa_["p_partkey"],
                         np.arange(1, len(pa_["p_partkey"]) + 1)),
          "tpch oracles: primary keys are 1..N in row order")
    ext, disc = li["l_extendedprice"], li["l_discount"]
    rev = ext * (f32(1.0) - disc)                    # the engine's float32
    copy_s = time.perf_counter() - t0

    # Q1
    g = _cols(results["q1"])
    m = li["l_shipdate"] <= date_to_days("1998-12-01") - 90
    gid = li["l_returnflag"][m] * 2 + li["l_linestatus"][m]
    bc = lambda w=None: np.bincount(gid, weights=w, minlength=6)  # noqa: E731
    cnt = bc()
    want = {"sum_l_quantity": bc(li["l_quantity"][m]),
            "sum_l_extendedprice": bc(ext[m]),
            "sum_disc_price": bc(rev[m]),
            "sum_charge": bc(rev[m] * (f32(1.0) + li["l_tax"][m])),
            "count_l_orderkey": cnt}
    want["mean_l_quantity"] = want["sum_l_quantity"] / cnt
    want["mean_l_extendedprice"] = want["sum_l_extendedprice"] / cnt
    want["mean_l_discount"] = bc(disc[m]) / cnt
    flags, status = ["A", "N", "R"], ["F", "O"]
    order = [flags.index(a) * 2 + status.index(b)
             for a, b in zip(g["l_returnflag"], g["l_linestatus"])]
    check(order == [i for i in range(6) if cnt[i]], "q1: the groups, in order")
    for c, w in want.items():
        ok = np.array_equal(g[c], w[order]) if c.startswith("count") else \
            _close(g[c], w[order], _rtol(c, g[c]))
        check(ok, f"q1: {c} == numpy")

    # Q3 (BUILDING, 1995-03-15, top 10 by revenue)
    day = date_to_days("1995-03-15")
    cust_ok = np.zeros(n_cust + 1, bool)
    cust_ok[cu["c_custkey"][cu["c_mktsegment"]
                            == SEGMENTS.index("BUILDING")]] = True
    order_ok = np.zeros(n_ord + 1, bool)
    order_ok[1:] = (od["o_orderdate"] < day) & cust_ok[od["o_custkey"]]
    m = (li["l_shipdate"] > day) & order_ok[li["l_orderkey"]]
    vol = np.bincount(li["l_orderkey"][m], weights=rev[m],
                      minlength=n_ord + 1)
    g = _cols(results["q3"])
    keys = g["l_orderkey"]
    check(len(keys) == min(10, int((vol > 0).sum())), "q3: 10 rows")
    top = np.argsort(-vol, kind="stable")[:len(keys)]
    check(set(keys.tolist()) == set(top.tolist()), "q3: the top orders")
    check(_close(g["sum_volume"], vol[keys], REL_TOL), "q3: revenue")
    check(bool(np.all(np.diff(g["sum_volume"]) <= 0)), "q3: revenue order")
    check(np.array_equal(g["o_orderdate"], od["o_orderdate"][keys - 1]) and
          np.array_equal(g["o_shippriority"], od["o_shippriority"][keys - 1]),
          "q3: order date and ship priority")

    # Q4 (1993-07-01 + 3 months)
    d0 = date_to_days("1993-07-01")
    late = np.zeros(n_ord + 1, bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    m = (od["o_orderdate"] >= d0) & (od["o_orderdate"] < d0 + 92) & late[1:]
    want = np.bincount(od["o_orderpriority"][m], minlength=5)
    g = _cols(results["q4"])
    check(list(g["o_orderpriority"]) == [p for i, p in enumerate(PRIORITIES)
                                         if want[i]] and
          np.array_equal(g["order_count"], want[want > 0]), "q4: counts")

    # Q6 (1994, discount 0.06 ± 0.01, quantity < 24)
    d0 = date_to_days("1994-01-01")
    m = ((li["l_shipdate"] >= d0) & (li["l_shipdate"] < d0 + 365)
         & (disc >= f32(0.049)) & (disc <= f32(0.071))
         & (li["l_quantity"] < f32(24.0)))
    check(_close(_cols(results["q6"])["sum_rev"],
                 [(ext[m] * disc[m]).astype(np.float64).sum()], REL_TOL),
          "q6: revenue")

    # Q14 (1995-09)
    d0, d1 = date_to_days("1995-09-01"), date_to_days("1995-10-01")
    promo = np.array([t.startswith("PROMO") for t in TYPE_POOL])
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    is_p = promo[pa_["p_type"][li["l_partkey"][m] - 1]]
    val = 100.0 * rev[m][is_p].astype(np.float64).sum() / \
        rev[m].astype(np.float64).sum()
    check(_close(_cols(results["q14"])["promo_revenue"], [val], F32_RTOL),
          "q14: promo revenue")

    # Q18 (quantity > 300, top 100 by price desc, date asc)
    qty = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                      minlength=n_ord + 1)
    big = np.flatnonzero(qty > 300.0)
    g = _cols(results["q18"])
    rows = sorted(zip(-od["o_totalprice"][big - 1].astype(np.float64),
                      od["o_orderdate"][big - 1], big))[:100]
    want_keys = np.array([r[2] for r in rows], np.int64)
    check(len(g["o_orderkey"]) == len(want_keys) and set(
        g["o_orderkey"].tolist()) == set(want_keys.tolist()),
        "q18: the orders")
    ok = g["o_orderkey"]
    check(np.array_equal(g["c_custkey"], od["o_custkey"][ok - 1]) and
          np.array_equal(g["sum_l_quantity"], qty[ok].astype(np.float32)) and
          np.array_equal(g["o_totalprice"], od["o_totalprice"][ok - 1]),
          "q18: customer, quantity and price")

    # Q22 (country codes, balance above the cohort's positive mean, no
    # orders); a balance within 0.05 of the mean may go either way: the
    # engine's mean is a float32 sum over ~10^5 balances per shard
    codes = np.array([13, 31, 23, 29, 30, 18, 17])
    cohort = np.isin(cu["c_phone_cc"], codes)
    bal = cu["c_acctbal"]
    pos = cohort & (bal > f32(0.0))
    avg = bal[pos].astype(np.float64).sum() / pos.sum()
    has = np.zeros(n_cust + 1, bool)
    has[od["o_custkey"]] = True
    base = cohort & ~has[1:]
    sure = base & (bal.astype(np.float64) > avg + 0.05)
    edge = base & (np.abs(bal.astype(np.float64) - avg) <= 0.05)
    g = _cols(results["q22"])
    for cc, n, s in zip(g["cntrycode"], g["numcust"], g["totacctbal"]):
        lo = int((sure & (cu["c_phone_cc"] == cc)).sum())
        hi = lo + int((edge & (cu["c_phone_cc"] == cc)).sum())
        check(lo <= n <= hi, f"q22: customers of code {cc}")
        if n == lo:
            check(_close([s], [bal[sure & (cu["c_phone_cc"] == cc)]
                               .astype(np.float64).sum()], F32_RTOL),
                  f"q22: balance of code {cc}")
    check(set(g["cntrycode"].tolist()) ==
          set(np.unique(cu["c_phone_cc"][sure]).tolist()), "q22: codes")
    say(f"tpch oracles sf={sf}", queries="q1,q3,q4,q6,q14,q18,q22",
        agree="yes", copy_seconds=f"{copy_s:.3f}",
        host_seconds=f"{time.perf_counter() - t0:.3f}",
        q22_edge_customers=int(edge.sum()))


def same_result(q: str, a, b, what: str = "world 1 and world 4") -> str:
    """Result ``a`` against result ``b`` (by default world 1's against world
    4's): the same columns and rows; keys and integers exact, floats
    within ``_rtol``.  Rows compare in order; if only the order differs,
    the rows (identified by their non-float columns) must match and the
    answer says so."""
    return same_columns(q, _cols(a), _cols(b), a.num_rows, b.num_rows, what)


def same_columns(q: str, ca, cb, na: int, nb: int, what: str) -> str:
    """``same_result`` on host columns (name → numpy array) of ``na`` and
    ``nb`` rows."""
    check(list(ca) == list(cb) and na == nb,
          f"{q}: {what} give the same columns and row count")

    def equal(pa_, pb_):
        for c in ca:
            x, y = ca[c][pa_], cb[c][pb_]
            if x.dtype.kind == "f":
                if not _close(x, y, _rtol(c, x)):
                    return False
            elif not np.array_equal(x, y):
                return False
        return True

    n = na
    if equal(np.arange(n), np.arange(n)):
        return "ordered"
    keys = [c for c in ca if ca[c].dtype.kind != "f"]
    ka = sorted(range(n), key=lambda i: tuple(str(ca[c][i]) for c in keys))
    kb = sorted(range(n), key=lambda i: tuple(str(cb[c][i]) for c in keys))
    check(equal(np.array(ka), np.array(kb)),
          f"{q}: {what} give the same rows")
    return "same rows, order differs among float ties"


def phase_tpch_worlds(sf: float, seed: int):
    """Every query at ``sf`` on world 1 and on world 4 of its own tables:
    the results agree."""
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.tpch import QUERIES

    broadcast.clear_replica_cache()
    runs = {}
    for world in (1, WORLD):
        ctx, tables, _ = tpch_generate(sf, world, seed)
        runs[world] = {q: QUERIES[q](ctx, tables) for q in QUERIES}
        del tables
        broadcast.clear_replica_cache()
    verdicts = {q: same_result(q, runs[1][q], runs[WORLD][q])
                for q in QUERIES}
    say(f"tpch sf={sf} world 1 == world {WORLD}", queries=len(verdicts),
        ordered=sum(v == "ordered" for v in verdicts.values()),
        **{q: v for q, v in verdicts.items() if v != "ordered"})


# ---------------------------------------------------------------------------
# phases: the operators the planner lowers to — the fused and sketch
# groupbys, the aggregation-state capture, the streaming and multiway
# joins — with every export through one HostPipeline
# ---------------------------------------------------------------------------

F32_TOL = 1e-6  # a float32 column's sum, rounded to float32 at other points


class Exports:
    """Every export of the planner-operator phases goes through ONE
    ``HostPipeline(workers=1)``; each task records its submission number
    when it runs, so FIFO order can be checked at the end."""

    def __init__(self):
        from cylon_tpu_torch.parallel import HostPipeline

        self.pipe = HostPipeline(workers=1, depth=4)
        self.ran = []
        self.n = 0

    def submit(self, fn):
        i = self.n
        self.n += 1

        def run():
            out = fn()
            self.ran.append(i)
            return out
        return self.pipe.submit(run)

    def finish(self):
        """FIFO order, and a raised error reaching ``wait()``."""
        self.pipe.drain()
        check(self.ran == list(range(self.n)),
              f"host pipeline ran {self.n} exports in submission order")

        def boom():
            raise ValueError("export failed on purpose")
        task = self.submit(boom)
        try:
            task.wait(60)
        except ValueError as e:
            err = str(e)
        else:
            err = None
        check(err == "export failed on purpose",
              "host pipeline: a raised error reaches wait()")
        self.pipe.close()
        say("host pipeline", exports=self.n - 1, fifo="yes",
            error_delivered="yes")


def measured(fn):
    """(result, seconds, peak GiB, partition-kernel launches) of ``fn()``."""
    from cylon_tpu_torch.ops import hash_cuda

    torch.cuda.reset_peak_memory_stats()
    hash_cuda.launches = 0
    out, secs = wall(fn)
    return (out, secs, torch.cuda.max_memory_allocated() / 2**30,
            hash_cuda.launches)


def check_groups(label, got, want, exact, f64=(), f32=()) -> None:
    """Two host-side groupby results (``engine_result`` form): the same
    groups; ``exact`` columns equal, ``f64`` within REL_TOL relative,
    ``f32`` within F32_TOL."""
    check(len(got[exact[0]]) == len(want[exact[0]]),
          f"{label}: {len(got[exact[0]])} groups == {len(want[exact[0]])}")
    for c in exact:
        check(np.array_equal(got[c], want[c]), f"{label}: {c} exact")
    for c in f64:
        check(rel_close(got[c], want[c]),
              f"{label}: {c} within {REL_TOL} relative")
    for c in f32:
        a, b = got[c].astype(np.float64), want[c].astype(np.float64)
        check(bool(np.all(np.abs(a - b) <= F32_TOL * np.maximum(
            np.maximum(np.abs(a), np.abs(b)), 1.0))),
              f"{label}: {c} within {F32_TOL} relative")


def _disc_price(env):
    return env["l_extendedprice"].double() * (1.0 - env["l_discount"].double())


# the fused groupby by l_orderkey (its aggregations and the columns that
# compare exactly)
FUSED_OK_AGGS = [("disc_price", "sum"), ("disc_price", "mean"),
                 ("l_quantity", "count"), ("l_discount", "min"),
                 ("l_shipdate", "max")]
FUSED_OK_EXACT = ["l_orderkey", "count_l_quantity", "min_l_discount",
                  "max_l_shipdate"]


def phase_fused_groupby(tables, sf: float, exports, profile: bool):
    """``dist_groupby_fused`` at SF 10, world 4: ``psum`` over Q1's
    dictionary keys under Q1's shipdate filter (against numpy and the
    eager groupby), then ``pre-aggregate`` and ``shuffle`` by
    ``l_orderkey`` (against the eager groupby)."""
    from cylon_tpu_torch import Type
    from cylon_tpu_torch.parallel import (dist_groupby, dist_groupby_fused,
                                          dist_ops, dist_project,
                                          dist_with_column)
    from cylon_tpu_torch.tpch.datagen import date_to_days

    li = dist_with_column(dist_project(tables["lineitem"], [
        "l_orderkey", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_shipdate"]), "disc_price",
        _disc_price, Type.DOUBLE)
    n = li.num_rows
    launches = {}
    cutoff = date_to_days("1998-12-01") - 90
    where = lambda env: env["l_shipdate"] <= cutoff  # noqa: E731
    keys = ["l_returnflag", "l_linestatus"]
    aggs = [("disc_price", "sum"), ("disc_price", "mean"),
            ("l_quantity", "sum"), ("l_quantity", "count")]
    dist_ops.decisions.clear()
    out, secs, peak, nl = measured(lambda: dist_groupby_fused(
        li, keys, aggs, where=where, mode="psum"))
    label = f"dist_groupby_fused psum Q1 keys sf={sf} world={WORLD}"
    check(dict(dist_ops.decisions) == {"groupby.psum": 1},
          f"{label}: ran the psum mode ({dict(dist_ops.decisions)})")
    launches["psum"] = nl
    check(nl == 0, f"{label}: no partition-kernel launch")
    eager, esecs = wall(lambda: dist_groupby(li, keys, aggs, where=where))
    t_got = exports.submit(lambda: engine_result(out, keys))
    t_eager = exports.submit(lambda: engine_result(eager, keys))
    h = host_columns(tables["lineitem"], ["l_returnflag", "l_linestatus",
                                          "l_quantity", "l_extendedprice",
                                          "l_discount", "l_shipdate"])
    m = h["l_shipdate"] <= cutoff
    gid = (h["l_returnflag"].astype(np.int64) * 2 + h["l_linestatus"])[m]
    dp = (h["l_extendedprice"].astype(np.float64)
          * (1.0 - h["l_discount"].astype(np.float64)))[m]
    cnt = np.bincount(gid, minlength=6)
    sdp = np.bincount(gid, weights=dp, minlength=6)
    sq = np.bincount(gid, weights=h["l_quantity"][m].astype(np.float64),
                     minlength=6)
    present = cnt > 0
    want = {"l_returnflag": (np.arange(6) // 2)[present],
            "l_linestatus": (np.arange(6) % 2)[present],
            "sum_disc_price": sdp[present],
            "mean_disc_price": (sdp / np.maximum(cnt, 1))[present],
            "sum_l_quantity": sq[present], "count_l_quantity": cnt[present]}
    got, _ = t_got.wait()
    ewant, _ = t_eager.wait()
    exact = keys + ["count_l_quantity"]
    f64 = ["sum_disc_price", "mean_disc_price"]
    check_groups(f"{label} vs numpy", got, want, exact, f64, ["sum_l_quantity"])
    check_groups(f"{label} vs eager", got, ewant, exact, f64,
                 ["sum_l_quantity"])
    say(label, rows=n, seconds=f"{secs:.6f}", eager_seconds=f"{esecs:.6f}",
        groups=len(got["l_returnflag"]), peak_gib=f"{peak:.2f}",
        kernel_launches=nl, shard_groups=list(map(int, out.counts_host())))
    del h, gid, dp, m
    if profile:
        profile_call(f"dist_groupby_fused psum Q1 keys sf={sf}",
                     lambda: dist_groupby_fused(li, keys, aggs, where=where,
                                                mode="psum"))
    # pre-aggregate and shuffle by l_orderkey (about 15M groups)
    keys = ["l_orderkey"]
    aggs = FUSED_OK_AGGS
    eager, esecs, epeak, enl = measured(lambda: dist_groupby(li, keys, aggs))
    ewant, _ = exports.submit(lambda: engine_result(eager, keys)).wait()
    del eager
    say(f"dist_groupby l_orderkey (eager) sf={sf} world={WORLD}", rows=n,
        seconds=f"{esecs:.6f}", groups=len(ewant["l_orderkey"]),
        peak_gib=f"{epeak:.2f}", kernel_launches=enl)
    exact = FUSED_OK_EXACT
    RESIDENT[("fused", sf)] = ewant
    for mode in ("pre-aggregate", "shuffle"):
        dist_ops.decisions.clear()
        out, secs, peak, nl = measured(lambda: dist_groupby_fused(
            li, keys, aggs, mode=mode))
        label = f"dist_groupby_fused {mode} l_orderkey sf={sf} world={WORLD}"
        check(dict(dist_ops.decisions) == {f"groupby.{mode}": 1},
              f"{label}: ran the {mode} mode")
        launches[mode] = nl
        check(nl == 1, f"{label}: one partition-kernel launch (got {nl})")
        got, _ = exports.submit(lambda: engine_result(out, keys)).wait()
        check_groups(f"{label} vs eager", got, ewant, exact,
                     ["sum_disc_price", "mean_disc_price"])
        say(label, rows=n, seconds=f"{secs:.6f}", rows_per_s=f"{n / secs:.0f}",
            groups=len(got["l_orderkey"]), peak_gib=f"{peak:.2f}",
            kernel_launches=nl)
        del out, got
    if profile:
        profile_call(f"dist_groupby_fused pre-aggregate l_orderkey sf={sf}",
                     lambda: dist_groupby_fused(li, keys, aggs))
    return launches


SKETCH_AGGS = [("l_partkey", "approx_distinct"),
               ("l_extendedprice", "approx_quantile:0.5"),
               ("l_extendedprice", "approx_quantile:0.95")]


SKETCH_CHECK_STRIDE = 8  # suppliers with key % 8 == 0 get exact checks


def phase_sketch(tables, sf: float, exports, profile: bool):
    """``dist_groupby_sketch`` by ``l_suppkey`` at SF 10 (100,000 groups):
    every supplier present; for one supplier in ``SKETCH_CHECK_STRIDE``
    every distinct estimate within HLL_ERROR_BOUND of numpy's exact count,
    every quantile within QUANTILE_RANK_ERROR_BOUND in rank of numpy's
    sorted values.  The partial blocks are sized by the per-shard group
    count, not by the input capacity."""
    from cylon_tpu_torch.ops import sketch as ops_sketch
    from cylon_tpu_torch.parallel import dist_groupby_sketch, dist_ops

    li = tables["lineitem"]
    n = li.num_rows
    out, secs, peak, nl = measured(lambda: dist_groupby_sketch(
        li, ["l_suppkey"], SKETCH_AGGS))
    label = f"dist_groupby_sketch l_suppkey sf={sf} world={WORLD}"
    check(nl == 1, f"{label}: one partition-kernel launch (got {nl})")
    t_got = exports.submit(lambda: engine_result(out, ["l_suppkey"]))
    part = dist_ops._sketch_partial_table(
        li, [li.column_index("l_suppkey")],
        [li.column_index(c) for c, _ in SKETCH_AGGS],
        ("distinct", "quantile", "quantile"), None, 0, li.cap)
    part_cap = part.cap
    del part
    t0 = time.perf_counter()
    h = host_columns(li, ["l_suppkey", "l_partkey", "l_extendedprice"])
    all_groups = np.flatnonzero(np.bincount(h["l_suppkey"]))
    # the exact answers (two sorts of the rows) for one supplier in
    # SKETCH_CHECK_STRIDE: the host's sorts over all 60M rows took 20 s
    rows = h["l_suppkey"] % SKETCH_CHECK_STRIDE == 0
    sk = h["l_suppkey"][rows].astype(np.int64)
    uniq = np.unique((sk << 22) | h["l_partkey"][rows].astype(np.int64))
    exact = np.bincount(uniq >> 22)
    groups = np.flatnonzero(exact)
    comb = np.sort((sk << 32) | h["l_extendedprice"][rows].view(np.uint32)
                   .astype(np.int64))
    starts = np.searchsorted(comb, groups << 32)
    sizes = np.bincount(sk)[groups]
    got, _ = t_got.wait()
    RESIDENT[("sketch", sf)] = got
    host_s = time.perf_counter() - t0
    check(np.array_equal(got["l_suppkey"], all_groups),
          f"{label}: the {len(all_groups)} suppliers of numpy")
    checked = got["l_suppkey"] % SKETCH_CHECK_STRIDE == 0
    check(np.array_equal(got["l_suppkey"][checked], groups),
          f"{label}: the checked suppliers")
    got = {k: v[checked] for k, v in got.items()}
    est = got["approx_distinct_l_partkey"].astype(np.float64)
    rel = np.abs(est - exact[groups]) / exact[groups]
    check(float(rel.max()) <= ops_sketch.HLL_ERROR_BOUND,
          f"{label}: every distinct estimate within "
          f"{ops_sketch.HLL_ERROR_BOUND:.4f} (max {rel.max():.4f})")
    rank_err = {}
    for q in (0.5, 0.95):
        e = got[f"p{int(round(q * 100))}_l_extendedprice"]
        pos = np.searchsorted(comb, (groups << 32)
                              | e.view(np.uint32).astype(np.int64)) - starts
        err = np.abs(pos / sizes - q)
        rank_err[q] = err
        check(float(err.max()) <= ops_sketch.QUANTILE_RANK_ERROR_BOUND,
              f"{label}: p{int(q * 100)} within rank "
              f"{ops_sketch.QUANTILE_RANK_ERROR_BOUND:.4f} "
              f"(max {err.max():.4f})")
    say(label, rows=n, seconds=f"{secs:.6f}", rows_per_s=f"{n / secs:.0f}",
        groups=len(all_groups), checked_groups=len(groups),
        peak_gib=f"{peak:.2f}", kernel_launches=nl,
        input_cap=li.cap, partial_cap=part_cap,
        hll_rel_err_max=f"{rel.max():.6f}", hll_rel_err_mean=f"{rel.mean():.6f}",
        p50_rank_err_max=f"{rank_err[0.5].max():.6f}",
        p50_rank_err_mean=f"{rank_err[0.5].mean():.6f}",
        p95_rank_err_max=f"{rank_err[0.95].max():.6f}",
        p95_rank_err_mean=f"{rank_err[0.95].mean():.6f}",
        host_seconds=f"{host_s:.3f}")
    if profile:
        profile_call(f"dist_groupby_sketch l_suppkey sf={sf}",
                     lambda: dist_groupby_sketch(li, ["l_suppkey"],
                                                 SKETCH_AGGS))
    return nl


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def phase_sketch_lanes(sf: float, seed: int):
    """At SF ``--tpch-check-sf``, world 4: the captured sketch state of the
    ``l_suppkey`` sketch groupby (HLL registers of ``l_partkey``, bottom-k
    values and priorities of ``l_extendedprice``) equals a numpy
    recomputation from host copies of the shards, bit for bit.  The
    registers do not depend on placement; a row's priority seeds from its
    global id ``shard·cap + row``, and ties order by it."""
    from cylon_tpu_torch.ops import sketch as ops_sketch
    from cylon_tpu_torch.ops.gather import signed_view
    from cylon_tpu_torch.parallel import dist_groupby_sketch
    from cylon_tpu_torch.parallel.dist_ops import collect_agg_state

    _, tables, _ = tpch_generate(sf, WORLD, seed)
    li = tables["lineitem"]
    aggs = SKETCH_AGGS[:2]
    with collect_agg_state() as sink:
        dist_groupby_sketch(li, ["l_suppkey"], aggs)
    check(len(sink) == 1 and sink[0].kind == "sketch",
          "sketch lanes: one sketch state captured")
    st = sink[0].state
    cnt = st.counts_host()
    rows = torch.cat([torch.arange(int(c), device=DEVICE) + s * st.cap
                      for s, c in enumerate(cnt)])
    eng = {c.name: signed_view(c.data)[rows].cpu().numpy()  # graftlint: ok[implicit-host-sync]
           for c in st.columns}
    order = np.argsort(eng["l_suppkey"], kind="stable")
    eng = {k: v[order] for k, v in eng.items()}
    t0 = time.perf_counter()
    P, cap = li.nparts, li.cap
    counts = li.counts_host()
    blk = {c: li.column(c).data.view(P, cap).cpu().numpy()  # graftlint: ok[implicit-host-sync]
           for c in ("l_suppkey", "l_partkey", "l_extendedprice")}
    sel = np.concatenate([np.arange(int(c)) + s * cap
                          for s, c in enumerate(counts)])
    sk = np.concatenate([blk["l_suppkey"][s, :int(c)]
                         for s, c in enumerate(counts)]).astype(np.int64)
    pk = np.concatenate([blk["l_partkey"][s, :int(c)]
                         for s, c in enumerate(counts)]).astype(np.uint64)
    price = np.concatenate([blk["l_extendedprice"][s, :int(c)]
                            for s, c in enumerate(counts)])
    gidx = sel.astype(np.uint32)           # shard·cap + row
    groups, gid = np.unique(sk, return_inverse=True)
    G, M, K = len(groups), ops_sketch.HLL_M, ops_sketch.QUANTILE_K
    # HLL registers of l_partkey
    h = _mix32_np((pk ^ (pk >> np.uint64(32))).astype(np.uint32))
    w = (h >> np.uint32(ops_sketch.HLL_P)).astype(np.float64)
    bitlen = np.where(w > 0, np.frexp(w)[1], 0)
    rank = np.clip(32 - bitlen - ops_sketch.HLL_P + 1, 1,
                   32 - ops_sketch.HLL_P + 1).astype(np.int32)
    regs = np.zeros((G, M), np.int32)
    np.maximum.at(regs, (gid, (h & np.uint32(M - 1)).astype(np.int64)), rank)
    # bottom-k of l_extendedprice: the K smallest (priority, global id)
    bits = price.view(np.uint32)
    prio = np.minimum(_mix32_np(bits ^ _mix32_np(gidx)),
                      np.uint32(ops_sketch.PRIO_MAX - 1))
    o = np.lexsort((gidx, prio, gid))
    g_o = gid[o]
    first = np.r_[0, np.flatnonzero(g_o[1:] != g_o[:-1]) + 1]
    r = np.arange(len(o)) - np.repeat(first, np.diff(np.r_[first, len(o)]))
    keep = r < K
    vals = np.zeros((G, K), np.float32)
    prios = np.full((G, K), ops_sketch.PRIO_MAX, np.uint32)
    vals[g_o[keep], r[keep]] = price[o][keep]
    prios[g_o[keep], r[keep]] = prio[o][keep]
    host_s = time.perf_counter() - t0
    label = f"sketch state lanes sf={sf} world={WORLD}"
    check(np.array_equal(eng["l_suppkey"], groups), f"{label}: the groups")
    check(np.array_equal(eng["__hll0"], regs), f"{label}: HLL registers "
          "bit for bit")
    check(np.array_equal(eng["__bkv1"].view(np.int32), vals.view(np.int32)),
          f"{label}: sample values bit for bit")
    check(np.array_equal(eng["__bkp1"], prios.view(np.int32)),
          f"{label}: sample priorities bit for bit")
    say(label, rows=len(sk), groups=G, registers=G * M, sample_slots=G * K,
        exact="yes", host_seconds=f"{host_s:.3f}")
    del tables


def phase_agg_state(tables, sf: float, exports):
    """Split lineitem by ``l_orderkey`` into a base (80% of the orders)
    and a delta; capture the plain state of a ``l_suppkey`` groupby and
    the sketch state of ``approx_distinct(l_partkey)`` on each, merge and
    finalize: equal to the groupbys over the whole table (plain: exact
    ints, floats within REL_TOL; sketch: the same estimates)."""
    from cylon_tpu_torch.parallel import (dist_groupby, dist_groupby_sketch,
                                          dist_project, dist_select)
    from cylon_tpu_torch.parallel.dist_ops import (collect_agg_state,
                                                   finalize_agg_state,
                                                   merge_agg_state)

    li = dist_project(tables["lineitem"], ["l_orderkey", "l_suppkey",
                                           "l_quantity", "l_partkey"])
    cut = int(0.8 * tables["orders"].num_rows)
    plain = [("l_quantity", "sum"), ("l_quantity", "count"),
             ("l_quantity", "mean")]
    sketch = [("l_partkey", "approx_distinct")]

    def capture(pred):
        part = dist_select(li, pred)
        with collect_agg_state() as sink:
            dist_groupby(part, ["l_suppkey"], plain)
            dist_groupby_sketch(part, ["l_suppkey"], sketch)
        check([st.kind for st in sink] == ["plain", "sketch"],
              "agg state: one plain and one sketch state captured")
        return sink, int(part.num_rows)

    def run():
        (b, nb), (d, nd) = (capture(lambda env: env["l_orderkey"] <= cut),
                            capture(lambda env: env["l_orderkey"] > cut))
        return ([finalize_agg_state(merge_agg_state(b[i], d[i]))
                 for i in range(2)], nb, nd)

    ((fin_plain, fin_sketch), nb, nd), secs, peak, nl = measured(run)
    t_p = exports.submit(lambda: engine_result(fin_plain, ["l_suppkey"]))
    t_s = exports.submit(lambda: engine_result(fin_sketch, ["l_suppkey"]))
    whole_p = dist_groupby(li, ["l_suppkey"], plain)
    whole_s = dist_groupby_sketch(li, ["l_suppkey"], sketch)
    w_p = exports.submit(lambda: engine_result(whole_p, ["l_suppkey"]))
    w_s = exports.submit(lambda: engine_result(whole_s, ["l_suppkey"]))
    label = f"agg state merge(base, delta) sf={sf} world={WORLD}"
    check_groups(f"{label} plain", t_p.wait()[0], w_p.wait()[0],
                 ["l_suppkey", "count_l_quantity"],
                 ["sum_l_quantity", "mean_l_quantity"])
    check_groups(f"{label} sketch", t_s.wait()[0], w_s.wait()[0],
                 ["l_suppkey", "approx_distinct_l_partkey"])
    say(label, base_rows=nb, delta_rows=nd,
        seconds=f"{secs:.6f}", peak_gib=f"{peak:.2f}", kernel_launches=nl)
    return nl


def phase_streaming_join(ldata, rdata, want, exports):
    """``dist_join_streaming`` (chunks 4) against the one-shot ``dist_join``
    at world 4 on the join cell, INNER and LEFT, HASH and SORT: the same
    rows and payload checksums (INNER: the oracle's too)."""
    from cylon_tpu_torch import CylonContext, JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import DTable, dist_join, dist_join_streaming

    ctx = CylonContext(device=DEVICE, world=WORLD)
    lt = DTable.from_table(ctx, to_table(ctx, ldata, None))
    rt = DTable.from_table(ctx, to_table(ctx, rdata, None))
    launches = {}
    for alg in ("hash", "sort"):
        for how in ("inner", "left"):
            cfg = JoinConfig(JoinType(how), JoinAlgorithm(alg), 0, 0)
            one, s1, p1, l1 = measured(lambda: dist_join(lt, rt, cfg))
            lo = exports.submit(one.to_table)
            st, s2, p2, l2 = measured(lambda: dist_join_streaming(
                lt, rt, cfg, chunks=4))
            ls = exports.submit(st.to_table)
            label = f"dist_join_streaming {alg.upper()} {how} world={WORLD}"
            local_one, local_st = lo.wait(), ls.wait()
            check(local_st.num_rows == local_one.num_rows,
                  f"{label}: rows == one-shot")
            a, b = checksums(local_st), checksums(local_one)
            for k in a:
                check(a[k] == b[k] if k.startswith("bits") else close(a[k], b[k]),
                      f"{label}: {k} == one-shot")
            if how == "inner":
                check_join(label, local_st, want)
            launches[f"{alg}_{how}"] = l2
            say(label, rows_out=local_st.num_rows, chunks=4,
                seconds=f"{s2:.6f}", oneshot_seconds=f"{s1:.6f}",
                peak_gib=f"{p2:.2f}", oneshot_peak_gib=f"{p1:.2f}",
                kernel_launches=l2, oneshot_kernel_launches=l1)
            del one, st, local_one, local_st
    check(launches["hash_inner"] == 5 and launches["sort_inner"] == 0,
          f"streaming: HASH 1 + 4 chunk launches, SORT none ({launches})")
    return launches


def phase_q9_streaming(ctx, tables, sf: float, profile: bool):
    """Q9 with ``streaming_chunks=4`` equals the one-shot Q9: rows in
    order, ``sum_profit`` within REL_TOL."""
    from cylon_tpu_torch.tpch import QUERIES

    one, s1, p1, l1 = measured(lambda: QUERIES["q9"](ctx, tables))
    st, s2, p2, l2 = measured(lambda: QUERIES["q9"](ctx, tables,
                                                    streaming_chunks=4))
    a, b = _cols(st), _cols(one)
    label = f"tpch q9 streaming_chunks=4 sf={sf} world={WORLD}"
    check(list(a) == list(b) and st.num_rows == one.num_rows,
          f"{label}: the one-shot columns and rows")
    for c in a:
        if c == "sum_profit":
            check(rel_close(a[c], b[c]), f"{label}: {c} within {REL_TOL}")
        else:
            check(np.array_equal(a[c], b[c]), f"{label}: {c} in order")
    say(label, rows=st.num_rows, seconds=f"{s2:.6f}",
        oneshot_seconds=f"{s1:.6f}", peak_gib=f"{p2:.2f}",
        oneshot_peak_gib=f"{p1:.2f}", kernel_launches=l2,
        oneshot_kernel_launches=l1)
    if profile:
        profile_call(f"tpch q9 streaming_chunks=4 sf={sf}",
                     lambda: QUERIES["q9"](ctx, tables, streaming_chunks=4))
        profile_call(f"tpch q9 one-shot sf={sf}",
                     lambda: QUERIES["q9"](ctx, tables))
    return l2


def column_sum(x: torch.Tensor) -> int:
    """An exact, order-free checksum: Σ of the values of an integer
    column, of the 32-bit patterns of a float32 one."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return int(x.long().sum())


def _strip(names):
    return [n[3:] if n.startswith(("lt-", "rt-")) else n for n in names]


def phase_multiway(tables, sf: float, exports):
    """The Q5-shaped star through ``dist_multiway_join``: lineitem against
    orders (dense FK), supplier (broadcast) and part (dense FK), against
    the binary ``dist_join`` cascade with the same edges: the same rows and
    checksums."""
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import (dist_join, dist_multiway_join,
                                          dist_ops, dist_project)

    fact = dist_project(tables["lineitem"], ["l_orderkey", "l_partkey",
                                             "l_suppkey", "l_extendedprice"])
    dims = [dist_project(tables["orders"], ["o_orderkey", "o_orderdate"]),
            dist_project(tables["supplier"], ["s_suppkey", "s_nationkey"]),
            dist_project(tables["part"], ["p_partkey", "p_size"])]
    specs = [("l_orderkey", "o_orderkey", (1, tables["orders"].num_rows)),
             ("l_suppkey", "s_suppkey", None),
             ("l_partkey", "p_partkey", (1, tables["part"].num_rows))]
    names, edges = list(fact.column_names), []
    for j, (dim, (fk, pk, dkr)) in enumerate(zip(dims, specs)):
        out = ["lt-" + n for n in names] + ["rt-" + n for n in dim.column_names]
        ren = () if j == len(specs) - 1 else tuple(zip(out, _strip(out)))
        names = _strip(out)
        edges.append(("inner", "sort", (fk,), (pk,), dkr, None, ren))

    def cascade():
        cur = fact
        for dim, (how, alg, fon, don, dkr, _, ren) in zip(dims, edges):
            cfg = JoinConfig(JoinType(how), JoinAlgorithm(alg), fon[0], don[0])
            cur = dist_join(cur, dim, cfg, dkr)
            if ren:
                cur = cur.rename([dict(ren).get(n, n) for n in cur.column_names])
        return cur

    dist_ops.decisions.clear()
    mw, s1, p1, l1 = measured(lambda: dist_multiway_join(fact, dims, edges))
    taken_mw = dict(dist_ops.decisions)
    t_mw = exports.submit(mw.to_table)
    dist_ops.decisions.clear()
    cc, s2, p2, l2 = measured(cascade)
    taken_cc = dict(dist_ops.decisions)
    t_cc = exports.submit(cc.to_table)
    a, b = t_mw.wait(), t_cc.wait()
    label = f"dist_multiway_join Q5 star sf={sf} world={WORLD}"
    check(a.num_rows == b.num_rows == fact.num_rows,
          f"{label}: {a.num_rows} rows == cascade's {b.num_rows}")
    for c in ("lt-l_extendedprice", "lt-l_orderkey", "lt-o_orderdate",
              "lt-s_nationkey", "rt-p_size"):
        check(column_sum(a.column(c).data) == column_sum(b.column(c).data),
              f"{label}: checksum of {c} == cascade's")
    fmt = lambda d: ",".join(f"{k}:{v}" for k, v in sorted(d.items()))  # noqa: E731
    say(label, rows=a.num_rows, seconds=f"{s1:.6f}",
        cascade_seconds=f"{s2:.6f}", peak_gib=f"{p1:.2f}",
        cascade_peak_gib=f"{p2:.2f}", kernel_launches=l1,
        cascade_kernel_launches=l2, decisions=fmt(taken_mw),
        cascade_decisions=fmt(taken_cc))
    return l1


# ---------------------------------------------------------------------------
# phase 6: compute.hash_partition
# ---------------------------------------------------------------------------

def phase_hash_partition(ldata):
    from cylon_tpu_torch import CylonContext, compute
    from cylon_tpu_torch.ops import hash as plain_hash

    ctx = CylonContext(device=DEVICE)
    t = to_table(ctx, ldata, None)
    parts, secs = wall(lambda: compute.hash_partition(t, ["k"], 4))
    sizes = [p.num_rows for p in parts]
    check(sum(sizes) == t.num_rows, "hash_partition keeps every row")
    for i, p in enumerate(parts):
        k = p.column("k").data
        pid = plain_hash.partition_ids(plain_hash.row_hash((k,), (None,)), 4)
        check(bool((pid == i).all()), f"part {i} holds only its keys")
    say("hash_partition", parts=sizes, seconds=f"{secs:.6f}")


# ---------------------------------------------------------------------------
# the analyze phase: EXPLAIN ANALYZE of the join cell and of the 22 TPC-H
# queries, tracing disabled on the same join, the Chrome export and the
# flight recorder
# ---------------------------------------------------------------------------

JOIN_SPANS = ("join.partition", "join.shuffle", "shuffle.counts",
              "shuffle.exchange", "join.count", "join.gather", "sync")


def phase_analyze_join(ldata, rdata, want, eager_join_s: float):
    """``ctx.analyze`` of the world-4 HASH join on the join cell's data:
    the eager rows and checksums, a runtime on every node, node bytes =
    totals = the exchange counters, the partition kernel launched inside
    the run; the span breakdown beside the analyzed and eager times.
    Then the same join with tracing disabled and counters on: no barrier
    (``trace.sync`` 0).  Returns the kernel launches of the analyzed
    run."""
    from cylon_tpu_torch import CylonContext, JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import DTable, dist_join

    ctx = CylonContext(device=DEVICE, world=WORLD)
    lt = DTable.from_table(ctx, to_table(ctx, ldata, None))
    rt = DTable.from_table(ctx, to_table(ctx, rdata, None))
    cfg = JoinConfig(JoinType.INNER, JoinAlgorithm.HASH, 0, 0)
    label = f"analyze dist_join inner world={WORLD}"
    hash_cuda.launches = 0
    rep, secs = wall(lambda: ctx.analyze(
        lambda t: dist_join(t["l"], t["r"], cfg), {"l": lt, "r": rt}))
    launches = hash_cuda.launches
    phase_ms = dict(rep.totals["phase_ms"])
    check(rep.ok, f"{label}: the run succeeded ({rep.error})")
    check(launches > 0, f"{label}: the partition kernel ran inside it")
    check_join(label, rep.output.to_table(), want)
    check(all(n.runtime is not None for n in rep.nodes),
          f"{label}: every node carries runtime")
    c = rep.totals["counters"]
    top = sum(n.runtime["bytes_moved"] for n in rep.nodes
              if n.runtime["depth"] == 1)
    check(top == rep.totals["bytes_moved"] == wire_bytes(c) > 0,
          f"{label}: node bytes {top} = totals {rep.totals['bytes_moved']} "
          f"= counters {wire_bytes(c)}")
    check(c.get("trace.sync", 0) > 0, f"{label}: the spans synchronized")
    del rep
    say(label, nodes="dist_join", analyzed_seconds=f"{secs:.6f}",
        eager_seconds=f"{eager_join_s:.6f}",
        bytes_moved=top, trace_sync=c.get("trace.sync", 0),
        host_read=c.get("host.read", 0), kernel_launches=launches,
        **{f"span_{k.replace('.', '_')}_ms": f"{phase_ms.get(k, 0.0):.3f}"
           for k in JOIN_SPANS})
    # the device time of the same phases: each enabled span is a
    # torch.profiler range, so the kernels it launched add up under it
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctx.analyze(lambda t: dist_join(t["l"], t["r"], cfg),
                    {"l": lt, "r": rt})
        torch.cuda.synchronize()
    dev = {}
    for e in prof.key_averages():
        if e.key in JOIN_SPANS:
            us = getattr(e, "device_time_total", None)
            dev[e.key] = (e.cuda_time_total if us is None else us) / 1e3
    say(f"{label} device time by span (torch.profiler)",
        **{f"span_{k.replace('.', '_')}_device_ms": f"{dev.get(k, 0.0):.3f}"
           for k in JOIN_SPANS if k != "sync"})
    # tracing disabled, counters on: the spans are one flag read each
    trace.disable()
    trace.reset()
    trace.enable_counters()
    try:
        out, secs_off = wall(lambda: dist_join(lt, rt, cfg))
        cnt = trace.counters()
        spans = trace.get_span_records(all_threads=True)
    finally:
        trace.disable_counters()
        trace.reset()
    check(cnt.get("trace.sync", 0) == 0 and spans == [],
          "tracing disabled: no span and no barrier")
    check(wire_bytes(cnt) == top, "tracing disabled: the same wire bytes")
    check_join("tracing disabled", out.to_table(), want)
    say(f"dist_join inner world={WORLD} tracing=off counters=on",
        seconds=f"{secs_off:.6f}", eager_seconds=f"{eager_join_s:.6f}",
        trace_sync=cnt.get("trace.sync", 0), host_read=cnt.get("host.read", 0),
        wire_bytes=wire_bytes(cnt))
    return launches


def phase_tpch_analyze(ctx, tables, sf: float, eager, eager_times):
    """``DTable.explain(q, tables=..., analyze=True, optimize=True)`` of
    the 22 queries on the generated tables: each output equals the eager
    result in order, every counter of the run is in the catalogue, and
    the ``devmem`` peak equals ``torch.cuda.max_memory_allocated()`` read
    at the same point.  One line per query.  Returns the partition-kernel
    launches per query."""
    from cylon_tpu_torch.observe import METRICS, devmem
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.tpch import QUERIES

    anchor = tables["lineitem"]
    launches, ratios = {}, []
    for q in QUERIES:
        broadcast.clear_replica_cache()
        torch.cuda.reset_peak_memory_stats()
        hash_cuda.launches = 0
        rep, secs = wall(lambda: anchor.explain(
            lambda t: QUERIES[q](ctx, t), tables=tables, analyze=True,
            optimize=True))
        launches[q] = hash_cuda.launches
        mem = devmem.snapshot(ctx.device)
        peak = torch.cuda.max_memory_allocated(ctx.device)
        label = f"tpch analyze {q} sf={sf} world={WORLD}"
        check(rep.ok, f"{label}: the run succeeded ({rep.error})")
        check(mem.source == "memory_stats" and mem.peak_bytes == peak,
              f"{label}: devmem peak {mem.peak_bytes} == "
              f"max_memory_allocated {peak}")
        same_ordered(f"{label} == eager", rep.output, eager[q])
        c = rep.totals["counters"]
        stray = sorted(set(c) - set(METRICS))
        check(not stray, f"{label}: counters outside the catalogue {stray}")
        check(all(n.runtime is not None for n in rep.nodes),
              f"{label}: every node carries runtime")
        ratios.append(secs / eager_times[q])
        say(label, analyzed_seconds=f"{secs:.6f}",
            eager_seconds=f"{eager_times[q]:.6f}",
            overhead=f"{secs / eager_times[q]:.3f}", nodes=len(rep.nodes),
            bytes_moved=rep.totals["bytes_moved"],
            trace_sync=c.get("trace.sync", 0),
            host_read=c.get("host.read", 0),
            devmem_peak_gib=f"{mem.peak_bytes / 2**30:.2f}",
            kernel_launches=launches[q],
            plan_cache_hits=rep.totals.get("optimizer", {}).get(
                "cache_hits", 0))
        del rep
    say(f"tpch analyze sf={sf} world={WORLD}", queries=len(QUERIES),
        geomean_overhead=f"{float(np.exp(np.mean(np.log(ratios)))):.3f}",
        kernel_launches=sum(launches.values()))
    return launches


def phase_trace_export():
    """The last analyzed run's spans as a Chrome trace under ``build/``,
    parsed back; then a flight-recorder bundle rendered by ``doctor``."""
    import contextlib
    import io
    import os

    from cylon_tpu_torch import trace
    from cylon_tpu_torch.observe import doctor, flightrec

    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_trace.json")
    trace.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sum(1 for e in events if e.get("ph") == "X")
    check(spans > 0, "chrome trace: the analyzed run's spans are in it")
    bundle = flightrec.dump(os.path.join("build", "chip_smoke_flightrec.json"),
                            reason="chip_smoke")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = doctor.main([bundle])
    check(rc == 0, f"doctor exits 0 on the bundle (got {rc})")
    say("trace export", path=path, events=len(events), spans=spans,
        bundle=bundle, doctor_rc=rc,
        doctor_lines=len(out.getvalue().splitlines()))


# ---------------------------------------------------------------------------
# phase: redistribution — every exchange lowering, the chooser, faults
# ---------------------------------------------------------------------------

LOWERINGS = (("single-shot", None), ("chunked", None), ("ring", None),
             ("allgather", None), ("hierarchical", (2, 2)))
MIX = -7046029254386353131  # 0x9E3779B97F4A7C15 as a signed int64


def shard_row_hashes(dt, ordered: bool = False):
    """Per shard, the sorted 64-bit hashes of its rows (every column's
    4-byte words mixed), on the card: a lowering's per-shard row
    multiset, independent of the order within the shard (``ordered``: in
    the shard's row order instead)."""
    counts = dt.counts_host()
    h = torch.zeros(dt.nparts * dt.cap, dtype=torch.int64, device=DEVICE)
    for c in dt.columns:
        w = c.data.view(torch.int32).long() & 0xFFFFFFFF
        h = (h ^ w) * MIX
        h = h ^ ((h >> 29) & 0x7FFFFFFFF)
    rows = [h[s * dt.cap:s * dt.cap + int(n)] for s, n in enumerate(counts)]
    return rows if ordered else [torch.sort(r).values for r in rows]


def lowering_rounds(strategy: str, shape, counters) -> int:
    if strategy == "chunked":
        return counters["shuffle.chunked_rounds"]
    return {"ring": WORLD - 1, "hierarchical": (shape or (1,))[0]}.get(
        strategy, 1)


def run_lowering(label, fn, strategy):
    """(result, seconds, priced peak per shard, observed card peak,
    observed transient, counters) of ``fn()`` with counters reset."""
    from cylon_tpu_torch import trace
    trace.reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, secs = wall(fn)
    peak = torch.cuda.max_memory_allocated()
    c = trace.counters()
    if strategy is not None:
        check(c.get(f"shuffle.strategy.{strategy.replace('-', '_')}", 0)
              >= 1, f"{label}: ran the {strategy} lowering ({c})")
    return out, secs, c.get("shuffle.exchange_bytes_peak", 0), peak, \
        peak - base, c


def join_sides(ldata, rdata):
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.parallel import DTable

    ctx = CylonContext(device=DEVICE, world=WORLD)
    return (DTable.from_table(ctx, to_table(ctx, ldata, None)),
            DTable.from_table(ctx, to_table(ctx, rdata, None)))


def hash_join(lt, rt):
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import dist_join

    # broadcast pinned off: the small warm-up sides must shuffle too
    return dist_join(lt, rt, JoinConfig(JoinType.INNER, JoinAlgorithm.HASH,
                                        0, 0, broadcast_threshold=0)
                     ).to_table()


def phase_redistribution(ldata, rdata, want, warm: bool = False):
    """(a) ``shuffle_table`` by ``k`` and the world-4 HASH ``dist_join`` on
    the join cell under every lowering, forced: the shuffle's per-shard
    row multisets equal single-shot's, the join equals the oracle, the
    partition kernel launches twice per join; one line each (seconds,
    rounds, priced peak per shard, observed card peak).  (b) The natural
    choice: from the same count matrix, a budget one byte under the
    single-shot price and one inside each other strategy's band; the
    lowering that runs is ``cost.choose``'s, results unchanged.  (e)
    Faults: the join under a transient ``compact.read_counts`` rule and
    under a ``resilience.budget`` rule, then under the exchange
    watchdog.  Returns the partition-kernel launches per join."""
    import os

    from cylon_tpu_torch import config, faults, resilience, trace
    from cylon_tpu_torch.observe import row_bytes
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import cost, dist_ops, shuffle, shuffle_table

    trace.enable_counters()
    lt, rt = join_sides(ldata, rdata)
    n = len(ldata["k"])
    tag = "warm-up " if warm else ""
    launches = {}
    base_rows = None
    P = WORLD
    # (a) every lowering, forced
    for strategy, shape in LOWERINGS:
        config.set_exchange_strategy(strategy)
        config.set_mesh_shape(shape)
        try:
            label = f"{tag}redistribution {strategy} rows={n} world={P}"
            sh, secs, priced, peak, transient, c = run_lowering(
                label, lambda: shuffle_table(lt, ["k"]), strategy)
            rows = shard_row_hashes(sh)
            if base_rows is None:
                base_rows = rows
            check(all(torch.equal(a, b) for a, b in zip(rows, base_rows)),
                  f"{label}: every shard holds single-shot's rows")
            del sh
            hash_cuda.launches = 0
            local, jsecs, jpriced, jpeak, jtransient, jc = run_lowering(
                label, lambda: hash_join(lt, rt), strategy)
            launches[strategy] = hash_cuda.launches
            check(hash_cuda.launches == 2, f"{label}: the partition kernel "
                  f"launched 2 times in the join (got {hash_cuda.launches})")
            check_join(label, local, want)
            del local
        finally:
            config.set_exchange_strategy(None)
            config.set_mesh_shape(None)
        say(label, shuffle_seconds=f"{secs:.6f}",
            rounds=lowering_rounds(strategy, shape, c),
            priced_peak_bytes=priced, observed_peak_gib=f"{peak / 2**30:.3f}",
            observed_transient_bytes=transient,
            transient_over_p_priced=f"{transient / max(P * priced, 1):.3f}",
            join_seconds=f"{jsecs:.6f}", join_priced_peak_bytes=jpriced,
            join_observed_peak_gib=f"{jpeak / 2**30:.3f}",
            kernel_launches=launches[strategy])
    # (b) the natural choice under a budget in each strategy's band
    pid = dist_ops._hash_pids(lt, [0])
    counts = shuffle._counts(lt.ctx.comm, pid).cpu().numpy().astype(np.int64)  # graftlint: ok[implicit-host-sync]
    del pid
    leaves = [lf for c in lt.columns for lf in (c.data, c.validity)
              if lf is not None]
    rbytes = row_bytes(leaves)
    ss = cost.price_single_shot(P, *cost.exchange_sizes(counts)[:2],
                                rbytes).peak_bytes
    bands = {}
    b = ss - 1
    while b > ss // 1000:  # the largest budget of each band, scanning down
        pick, _, feasible = cost.choose(cost.enumerate_strategies(
            P, lt.cap, counts, rbytes, b), b)
        if feasible:
            bands.setdefault(pick.strategy, b)
        b = int(b * 0.93)
    say(f"{tag}redistribution bands", single_shot_price=ss,
        **{s.replace("-", "_"): bands.get(s, "none")
           for s in ("chunked", "ring", "allgather")})
    check("chunked" in bands, "a budget one byte under single-shot "
          "degrades to a cheaper lowering")
    for strategy, budget in sorted(bands.items(), key=lambda x: -x[1]):
        prev = config.set_device_memory_budget(budget)
        try:
            label = (f"{tag}redistribution natural budget={budget} "
                     f"rows={n} world={P}")
            sh, secs, priced, peak, transient, c = run_lowering(
                label, lambda: shuffle_table(lt, ["k"]), strategy)
            check(c.get("shuffle.strategy.downgrades", 0) >= 1,
                  f"{label}: counted as a downgrade")
            rows = shard_row_hashes(sh)
            check(all(torch.equal(a, b) for a, b in zip(rows, base_rows)),
                  f"{label}: every shard holds single-shot's rows")
            del sh
            hash_cuda.launches = 0
            local, jsecs, _, jpeak, _, jc = run_lowering(
                label, lambda: hash_join(lt, rt), None)
            check(hash_cuda.launches == 2, f"{label}: 2 kernel launches")
            check(jc.get("shuffle.strategy.downgrades", 0) >= 1,
                  f"{label}: the join's exchanges degraded")
            check_join(label, local, want)
            del local
        finally:
            config.set_device_memory_budget(prev)
        say(label, chosen=strategy, shuffle_seconds=f"{secs:.6f}",
            rounds=lowering_rounds(strategy, None, c),
            priced_peak_bytes=priced, observed_peak_gib=f"{peak / 2**30:.3f}",
            observed_transient_bytes=transient, join_seconds=f"{jsecs:.6f}",
            join_observed_peak_gib=f"{jpeak / 2**30:.3f}",
            join_strategies=",".join(
                f"{k.split('.')[-1]}:{v}" for k, v in sorted(jc.items())
                if k.startswith("shuffle.strategy.")))
    # (e) faults: a transient count-read failure, a shrunk budget, and
    # the watchdog
    label = f"{tag}redistribution faults world={P}"
    plan = faults.FaultPlan(0, [faults.FaultRule(
        "compact.read_counts", kind="transient", nth=2)])
    with faults.active(plan):
        local, secs, _, _, _, c = run_lowering(label, lambda: hash_join(
            lt, rt), None)
    check_join(f"{label} (transient count read)", local, want)
    check(c.get("retry.attempts", 0) == 1 and c.get("fault.injected", 0) == 1,
          f"{label}: one retry, one injected fault ({c})")
    say(label, rule="compact.read_counts transient nth=2",
        seconds=f"{secs:.6f}", retry_attempts=c["retry.attempts"],
        fault_injected=c["fault.injected"])
    shrink = max(ss // 4, 1)
    plan = faults.FaultPlan(0, [faults.FaultRule(
        "resilience.budget", kind="value", mutate=lambda b: shrink)])
    with faults.active(plan):
        local, secs, _, _, _, c = run_lowering(label, lambda: hash_join(
            lt, rt), None)
    check_join(f"{label} (shrunk budget)", local, want)
    check(c.get("shuffle.strategy.downgrades", 0) >= 1
          and c.get("fault.injected", 0) >= 1,
          f"{label}: the shrunk budget degraded the exchanges ({c})")
    say(label, rule=f"resilience.budget value -> {shrink}",
        seconds=f"{secs:.6f}", downgrades=c["shuffle.strategy.downgrades"],
        fault_injected=c["fault.injected"],
        strategies=",".join(f"{k.split('.')[-1]}:{v}" for k, v in
                            sorted(c.items())
                            if k.startswith("shuffle.strategy.")))
    check(resilience.exchange_budget(lt.ctx.device)
          == config.device_memory_budget(lt.ctx.device),
          "no fault plan left installed")
    os.environ["CYLON_EXCHANGE_TIMEOUT_MS"] = "600000"
    try:
        local, secs, _, _, _, c = run_lowering(label, lambda: hash_join(
            lt, rt), None)
    finally:
        del os.environ["CYLON_EXCHANGE_TIMEOUT_MS"]
    check_join(f"{label} (watchdog)", local, want)
    check(c.get("shuffle.watchdog_timeouts", 0) == 0,
          f"{label}: no watchdog timeout")
    say(label, watchdog_ms=600000, seconds=f"{secs:.6f}",
        watchdog_timeouts=c.get("shuffle.watchdog_timeouts", 0))
    return launches


def phase_redistribution_tpch(tables, sf: float, eager, exports):
    """On the SF-10 tables at world 4: (c) the fused partial exchange by
    ``l_orderkey`` at the default budget and at half its priced
    single-shot peak (the chunked fold-combine, groups equal); (d) the 22
    queries eager under ``CYLON_MEMORY_BUDGET`` = 256 MiB per shard, each
    equal to its default-budget result, at least one exchange degraded
    (the budget halves until one does).  Returns the partition-kernel
    launches of (c)'s two runs and of (d)."""
    import os

    from cylon_tpu_torch import trace
    from cylon_tpu_torch import config
    from cylon_tpu_torch.parallel import (broadcast, dist_groupby,
                                          dist_groupby_fused, dist_ops,
                                          dist_project, dist_with_column)
    from cylon_tpu_torch.tpch import QUERIES
    from cylon_tpu_torch import Type

    trace.enable_counters()
    launches = {}
    # (c) the fused partial exchange by l_orderkey
    li = dist_with_column(dist_project(tables["lineitem"], [
        "l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
        "l_shipdate"]), "disc_price", _disc_price, Type.DOUBLE)
    keys = ["l_orderkey"]
    aggs = [("disc_price", "sum"), ("disc_price", "mean"),
            ("l_quantity", "count"), ("l_discount", "min"),
            ("l_shipdate", "max")]
    exact = ["l_orderkey", "count_l_quantity", "min_l_discount",
             "max_l_shipdate"]
    label = f"redistribution fused l_orderkey sf={sf} world={WORLD}"
    fused = lambda: dist_groupby_fused(li, keys, aggs,  # noqa: E731
                                       mode="pre-aggregate")
    from cylon_tpu_torch.ops import hash_cuda
    hash_cuda.launches = 0
    out, secs, priced, peak, transient, c = run_lowering(
        label, fused, "single-shot")
    launches["fused_default"] = hash_cuda.launches
    base, _ = exports.submit(lambda: engine_result(out, keys)).wait()
    del out
    say(label, budget="default", seconds=f"{secs:.6f}",
        priced_peak_bytes=priced, observed_peak_gib=f"{peak / 2**30:.3f}",
        observed_transient_bytes=transient,
        transient_over_p_priced=f"{transient / max(WORLD * priced, 1):.3f}",
        groups=len(base["l_orderkey"]), kernel_launches=hash_cuda.launches)
    half = priced // 2
    prev = config.set_device_memory_budget(half)
    try:
        hash_cuda.launches = 0
        out, secs, hpriced, hpeak, htransient, c = run_lowering(
            label, fused, "chunked")
        launches["fused_half"] = hash_cuda.launches
    finally:
        config.set_device_memory_budget(prev)
    check(c.get("shuffle.fold_combined", 0) >= 1,
          f"{label}: the chunked rounds folded by key")
    got, _ = exports.submit(lambda: engine_result(out, keys)).wait()
    del out
    check_groups(f"{label} half budget vs default", got, base, exact,
                 ["sum_disc_price", "mean_disc_price"])
    say(label, budget=half, chosen="chunked", seconds=f"{secs:.6f}",
        rounds=c["shuffle.chunked_rounds"],
        fold_combined=c["shuffle.fold_combined"],
        priced_peak_bytes=hpriced, observed_peak_gib=f"{hpeak / 2**30:.3f}",
        observed_transient_bytes=htransient,
        default_observed_peak_gib=f"{peak / 2**30:.3f}",
        groups=len(got["l_orderkey"]), kernel_launches=hash_cuda.launches)
    # the exchange's own transient: EXPLAIN ANALYZE samples the device
    # memory around each exchange (``peak=<strategy>: predicted P /
    # observed O bytes``)
    observed = {}
    for name, b in (("default", None), ("half", half)):
        prev = config.set_device_memory_budget(b)
        try:
            rep = li.ctx.analyze(lambda t: dist_groupby_fused(
                t, keys, aggs, mode="pre-aggregate"), li)
        finally:
            config.set_device_memory_budget(prev)
        check(rep.ok, f"{label}: analyzed at the {name} budget ({rep.error})")
        peaks = [n.info["peak"] for n in rep.nodes if "peak" in n.info]
        check(len(peaks) == 1, f"{label}: one exchange peak annotated")
        observed[name] = int(re.search(r"observed (\d+) bytes",
                                       peaks[0]).group(1))
        say(label, budget=name, analyzed="yes",
            exchange_peak=repr(peaks[0]))
    # the fold-combine's transient at half its priced peak against the
    # single-shot exchange's at the default budget: the analyzed windows
    # above (a live delta when the groupby's own peak came first), then
    # the partial table's exchange alone, the card's peak reset right
    # before it
    say(f"{label} fold-combine transient",
        half_budget_chunked_bytes=observed["half"],
        default_single_shot_bytes=observed["default"],
        below_single_shot="yes" if observed["half"] < observed["default"]
        else "no")
    partial, _ = dist_ops._decompose_aggs(li, aggs)
    part = dist_groupby(li, keys, partial, pre_aggregate=False,
                        _local_only=True)
    spec = dist_ops._combine_leaf_spec(part, 1, [op for _, op in partial])
    alone = {}
    for name, b in (("default", None), ("half", half)):
        prev = config.set_device_memory_budget(b)
        try:
            trace.reset()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sh, secs = wall(lambda: dist_ops._shuffle_by_keys(
                part, 1, combine=spec))
            alone[name] = (torch.cuda.max_memory_allocated() - base,
                           torch.cuda.memory_allocated() - base, secs,
                           ",".join(k.split(".")[-1] for k in
                                    trace.counters()
                                    if k.startswith("shuffle.strategy.")))
            del sh
        finally:
            config.set_device_memory_budget(prev)
    say(f"{label} partial exchange alone",
        partial_rows=int(part.counts_host().sum()),
        default_strategy=alone["default"][3],
        default_transient_bytes=alone["default"][0],
        default_result_bytes=alone["default"][1],
        default_seconds=f"{alone['default'][2]:.6f}",
        half_budget=half, half_strategy=alone["half"][3],
        half_transient_bytes=alone["half"][0],
        half_result_bytes=alone["half"][1],
        half_seconds=f"{alone['half'][2]:.6f}",
        below_single_shot="yes" if alone["half"][0] < alone["default"][0]
        else "no")
    del part
    del li, got, base
    # (d) the 22 queries under a 256 MiB per-shard budget
    ctx = tables["lineitem"].ctx
    budget = 268_435_456
    while True:
        os.environ["CYLON_MEMORY_BUDGET"] = str(budget)
        degraded, secs_all, n_launch = 0, 0.0, 0
        try:
            for q in QUERIES:
                broadcast.clear_replica_cache()
                trace.reset()
                hash_cuda.launches = 0
                out, secs = wall(lambda: QUERIES[q](ctx, tables))
                c = trace.counters()
                n_launch += hash_cuda.launches
                order = same_result(q, eager[q], out)
                degraded += c.get("shuffle.strategy.downgrades", 0)
                secs_all += secs
                say(f"redistribution tpch {q} sf={sf} world={WORLD}",
                    budget=budget, seconds=f"{secs:.6f}", rows=out.num_rows,
                    equal_to_default=order, kernel_launches=hash_cuda.launches,
                    strategies=",".join(
                        f"{k.split('.')[-1]}:{v}" for k, v in sorted(c.items())
                        if k.startswith("shuffle.strategy.")) or "none")
        finally:
            del os.environ["CYLON_MEMORY_BUDGET"]
        say(f"redistribution tpch sf={sf} world={WORLD}", budget=budget,
            degraded_exchanges=degraded, total_seconds=f"{secs_all:.6f}",
            kernel_launches=n_launch)
        if degraded:
            break
        check(budget > 1 << 20, "some exchange degrades above 1 MiB")
        budget //= 2
    launches["tpch_tight"] = n_launch
    broadcast.clear_replica_cache()
    return launches


# ---------------------------------------------------------------------------
# phases: the out-of-core tier — the spill pool on pinned host memory, the
# morsel join, the forced staged-spill exchange, the JAX bench's
# out-of-core stage at SF 10, the spilled operators and the switch
# ---------------------------------------------------------------------------

HOST_LINK_BYTES_PER_S = 64e9  # PCIe Gen5 x16, nominal, per direction


def host_link_gbps(leaves):
    """(D2H, H2D) GB/s of ``leaves`` through pinned host blocks on the
    spill pool's copy stream, timed by CUDA events (best of 3; the blocks
    are allocated before timing)."""
    from cylon_tpu_torch.spill import pool as tpool

    dev = leaves[0].device
    hosts = [tpool.pinned_empty(tuple(x.shape), x.dtype, dev) for x in leaves]
    backs = [torch.empty_like(x) for x in leaves]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    copy = tpool._copy_stream(dev)
    rates = []
    for pairs in (list(zip(hosts, leaves)), list(zip(backs, hosts))):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(copy):
                start.record()
                for dst, src in pairs:
                    dst.copy_(src, non_blocking=True)
                end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        rates.append(nbytes / (best / 1e3) / 1e9)
    check(all(torch.equal(b, x) for b, x in zip(backs, leaves)),
          "host link: the round trip through pinned blocks is exact")
    return rates[0], rates[1]


def phase_spill_roundtrip(ldata):
    """(1) The join cell's left side at world 4 spilled to pinned host
    blocks: the card's allocated bytes drop by at least the leaves'
    bytes, the fault-in gives them back bit for bit, a re-spill is a hit
    with no device read; the host link's D2H and H2D rates beside the
    nominal 64 GB/s per direction."""
    from cylon_tpu_torch import CylonContext, config, trace
    from cylon_tpu_torch.parallel import DTable, broadcast
    from cylon_tpu_torch.spill import pool as tpool

    trace.enable_counters()
    ctx = CylonContext(device=DEVICE, world=WORLD)
    dt = DTable.from_table(ctx, to_table(ctx, ldata, None))
    n = dt.num_rows
    label = f"spill round trip rows={n} world={WORLD}"
    orig = [c.data.cpu() for c in dt.columns]  # graftlint: ok[implicit-host-sync]
    leaf_bytes = sum(c.data.numel() * c.data.element_size()
                     for c in dt.columns)
    d2h, h2d = host_link_gbps([c.data for c in dt.columns])
    broadcast.clear_replica_cache()
    tpool.clear_pool()
    trace.reset()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    _, spill_s = wall(dt.spill)
    m1 = torch.cuda.memory_allocated()
    check(dt.is_spilled and m0 - m1 >= leaf_bytes,
          f"{label}: spill() freed {m0 - m1} B of the card, at least the "
          f"leaves' {leaf_bytes} B")
    check(all(d.is_pinned() for d, _ in dt._spill_entry.leaves),
          f"{label}: the host blocks are pinned")
    pinned = tpool.get_pool().pinned_bytes()
    _, fault_s = wall(dt.ensure_device)
    check(all(torch.equal(c.data.view(torch.int32).cpu(),  # graftlint: ok[implicit-host-sync]
                          o.view(torch.int32))
              for c, o in zip(dt.columns, orig)),
          f"{label}: the faulted-in leaves equal the originals bit for bit")
    c1 = trace.counters()
    _, respill_s = wall(dt.spill)
    c2 = trace.counters()
    check(c2.get("spill.respill_hits", 0) == 1
          and c2["spill.stage_outs"] == c1["spill.stage_outs"],
          f"{label}: the re-spill is a hit with no device read")
    m2 = torch.cuda.memory_allocated()
    check(m0 - m2 >= leaf_bytes, f"{label}: the re-spill freed the card")
    say(label, leaf_bytes=leaf_bytes, host_budget=config.host_memory_budget(),
        pinned_bytes=pinned, allocated_before=m0, allocated_spilled=m1,
        freed_bytes=m0 - m1, spill_seconds=f"{spill_s:.6f}",
        fault_in_seconds=f"{fault_s:.6f}", respill_seconds=f"{respill_s:.6f}",
        spill_gbps=f"{leaf_bytes / spill_s / 1e9:.3f}",
        fault_in_gbps=f"{leaf_bytes / fault_s / 1e9:.3f}",
        d2h_gbps=f"{d2h:.3f}", h2d_gbps=f"{h2d:.3f}",
        bound_gbps_per_direction=f"{HOST_LINK_BYTES_PER_S / 1e9:.0f}",
        d2h_share_of_bound=f"{d2h * 1e9 / HOST_LINK_BYTES_PER_S:.3f}",
        h2d_share_of_bound=f"{h2d * 1e9 / HOST_LINK_BYTES_PER_S:.3f}")
    del dt, orig
    tpool.clear_pool()
    return {"d2h_gbps": d2h, "h2d_gbps": h2d}


def phase_morsel_join(ldata, rdata, want, tag=""):
    """(2) The world-4 HASH join of the join cell with the left side
    spilled, under a budget that plans 4 morsels: the oracle's rows; the
    seconds beside the resident join, the peak above the resident right
    side, the partition-kernel launches (2 per morsel: each morsel's
    join co-partitions both sides)."""
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType, config, trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import dist_join
    from cylon_tpu_torch.spill import morsel as tmorsel
    from cylon_tpu_torch.spill import pool as tpool

    trace.enable_counters()
    lt, rt = join_sides(ldata, rdata)
    n = lt.num_rows
    label = f"{tag}spill morsel join HASH rows={n} world={WORLD}"
    cfg = JoinConfig(JoinType.INNER, JoinAlgorithm.HASH, 0, 0,
                     broadcast_threshold=0)
    joined, res_s = wall(lambda: dist_join(lt, rt, cfg))
    del joined
    rbytes = tmorsel._spilled_rbytes(lt)
    budget = tmorsel.table_priced_bytes(WORLD, -(-lt.cap // 4), rbytes)
    k, w, per = tmorsel.plan_morsels(WORLD, lt.cap, rbytes, budget)
    check(k >= 4, f"{label}: the budget plans {k} >= 4 morsels")
    tpool.clear_pool()
    lt.spill()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    hash_cuda.launches = 0
    prev = config.set_device_memory_budget(budget)
    try:
        out, secs = wall(lambda: dist_join(lt, rt, cfg))
    finally:
        config.set_device_memory_budget(prev)
    launches = hash_cuda.launches
    peak = torch.cuda.max_memory_allocated() - base
    c = trace.counters()
    check(c.get("spill.morsel_joins", 0) == 1
          and c.get("spill.morsels", 0) == k,
          f"{label}: one morsel join of {k} morsels ({c})")
    check(lt.is_spilled and c.get("spill.faultins", 0) == 0,
          f"{label}: the left side stayed spilled")
    check(launches == 2 * k, f"{label}: the partition kernel launched 2 "
          f"times per morsel (got {launches})")
    local = out.to_table()
    check_join(label, local, want)
    say(label, budget=budget, morsels=k, rows_per_morsel_per_shard=w,
        per_morsel_priced_bytes=per, rows_out=local.num_rows,
        seconds=f"{secs:.6f}", resident_seconds=f"{res_s:.6f}",
        peak_above_resident_right_bytes=peak,
        stage_in_bytes=c.get("spill.stage_in_bytes", 0),
        kernel_launches=launches)
    del out, local, lt, rt
    tpool.clear_pool()
    return launches


def phase_staged_spill(ldata, rdata, want, tag=""):
    """(3) The join cell's ``shuffle_table`` by ``k`` and its HASH join
    under ``set_exchange_strategy("staged-spill")``: every shard holds
    single-shot's rows, in the forced chunked plan's order, with its
    capacity and counts; the join equals the oracle; the rounds,
    ``spill.morsels``, staged bytes and seconds."""
    from cylon_tpu_torch import config, trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import shuffle_table
    from cylon_tpu_torch.spill import pool as tpool

    trace.enable_counters()
    lt, rt = join_sides(ldata, rdata)
    n = lt.num_rows
    label = f"{tag}spill staged-spill rows={n} world={WORLD}"
    sh, ss_s = wall(lambda: shuffle_table(lt, ["k"]))
    base_rows = shard_row_hashes(sh)
    del sh
    config.set_exchange_strategy("chunked")
    try:
        ch, ch_s = wall(lambda: shuffle_table(lt, ["k"]))
    finally:
        config.set_exchange_strategy(None)
    chunk_rows = shard_row_hashes(ch, ordered=True)
    chunk_cap, chunk_counts = ch.cap, ch.counts_host().copy()
    del ch
    tpool.clear_pool()
    trace.reset()
    hash_cuda.launches = 0
    config.set_exchange_strategy("staged-spill")
    try:
        sp, secs = wall(lambda: shuffle_table(lt, ["k"]))
        launches = hash_cuda.launches
        c = trace.counters()
        hash_cuda.launches = 0
        local, jsecs = wall(lambda: hash_join(lt, rt))
        jlaunches = hash_cuda.launches
        jc = trace.counters()
    finally:
        config.set_exchange_strategy(None)
    check(c.get("shuffle.strategy.staged_spill", 0) == 1
          and c.get("spill.exchanges", 0) == 1,
          f"{label}: ran the staged-spill lowering ({c})")
    rows = shard_row_hashes(sp)
    check(all(torch.equal(a, b) for a, b in zip(rows, base_rows)),
          f"{label}: every shard holds single-shot's rows")
    check(all(torch.equal(a, b) for a, b in
              zip(shard_row_hashes(sp, ordered=True), chunk_rows)),
          f"{label}: in the chunked plan's order")
    check(sp.cap == chunk_cap and np.array_equal(sp.counts_host(),
                                                 chunk_counts),
          f"{label}: the chunked plan's capacity and counts")
    check(launches == 1, f"{label}: one partition-kernel launch for the "
          f"exchange's ids (got {launches})")
    check(jlaunches == 2, f"{label}: 2 launches in the join (got "
          f"{jlaunches})")
    check_join(f"{label} join", local, want)
    staged = c.get("spill.stage_out_bytes", 0) + c.get("spill.stage_in_bytes",
                                                       0)
    say(label, rounds=c.get("spill.morsels", 0),
        spill_morsels=c.get("spill.morsels", 0), staged_bytes=staged,
        stage_out_bytes=c.get("spill.stage_out_bytes", 0),
        stage_in_bytes=c.get("spill.stage_in_bytes", 0),
        seconds=f"{secs:.6f}", single_shot_seconds=f"{ss_s:.6f}",
        chunked_seconds=f"{ch_s:.6f}", cap=sp.cap,
        priced_peak_bytes=c.get("shuffle.exchange_bytes_peak", 0),
        join_seconds=f"{jsecs:.6f}",
        join_spill_morsels=jc.get("spill.morsels", 0) - c.get(
            "spill.morsels", 0),
        kernel_launches=launches, join_kernel_launches=jlaunches)
    del sp, local, lt, rt
    tpool.clear_pool()
    return {"shuffle": launches, "join": jlaunches}


def planned_run(ctx, op, tables):
    """``op(tables)`` through the planner as ``ctx.optimize`` runs it,
    with the builder's rule fires: (result, fires)."""
    from cylon_tpu_torch.plan import Builder, ir

    b = Builder(ctx)
    with ir.capture(b):
        out = b.finish(op(b.wrap_tables(tables)))
    return out, list(b.stats["fires"])


OOC_QUERIES = ("q1", "q18", "q11")


def phase_ooc_tpch(ctx, tables, sf: float):
    """(4) The JAX bench's out-of-core stage: Q1, Q18 and Q11 through
    ``ctx.optimize`` under a device budget of ``max(192 KiB, priced //
    48)`` (``priced``: lineitem's morsel price), each from a cleared plan
    cache and pool, against the ample-budget planned run of the same
    query (columns, types, rows and order; floats within the oracle
    phase's tolerances; and the row set through
    ``analysis.parity.frames_rowset_equal``, the bench's gate).  (6) The
    switch: under
    ``set_spill_enabled(False)`` the Q1 plan fires no morsel scan and
    gives the same rows.  Returns the partition-kernel launches per
    query."""
    from cylon_tpu_torch import config, plan, trace
    from cylon_tpu_torch.analysis import parity
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.spill import morsel as tmorsel
    from cylon_tpu_torch.spill import pool as tpool
    from cylon_tpu_torch.tpch import QUERIES

    trace.enable_counters()
    li = tables["lineitem"]
    priced = tmorsel.table_priced_bytes(WORLD, li.cap,
                                        tmorsel._spilled_rbytes(li))
    budget = max(192 << 10, priced // 48)
    say(f"tpch ooc sf={sf} world={WORLD}", lineitem_rows=li.num_rows,
        lineitem_priced_bytes=priced, budget=budget,
        host_budget=config.host_memory_budget())
    launches, morsels, ample_rows = {}, {}, {}

    def fresh():
        plan.clear_plan_cache()
        tpool.clear_pool()
        broadcast.clear_replica_cache()

    for q in OOC_QUERIES:
        op = lambda t, q=q: QUERIES[q](ctx, t)  # noqa: E731
        fresh()
        ample, ample_s = wall(lambda: ctx.optimize(op, tables))
        ample_rows[q] = ample
        fresh()
        trace.reset()
        hash_cuda.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prev = config.set_device_memory_budget(budget)
        try:
            (out, fires), secs = wall(lambda: planned_run(ctx, op, tables))
        finally:
            config.set_device_memory_budget(prev)
        peak = torch.cuda.max_memory_allocated() - base
        c = trace.counters()
        launches[q] = hash_cuda.launches
        morsels[q] = c.get("spill.morsels", 0)
        pinned = tpool.get_pool().pinned_bytes()
        fresh()
        for dt in tables.values():   # a spilled scan comes back for the
            dt.ensure_device()        # later phases
        same_ordered(f"tpch ooc {q} == ample", out, ample)
        check(parity.frames_rowset_equal(out.to_pandas(), ample.to_pandas()),
              f"tpch ooc {q}: the row set == ample (analysis.parity)")
        check(not morsels[q] or any("morsel-scan" in f for f in fires),
              f"tpch ooc {q}: morsels stream only where the plan has a "
              "morsel scan")
        say(f"tpch ooc {q} sf={sf} world={WORLD}", budget=budget,
            seconds=f"{secs:.6f}", ample_seconds=f"{ample_s:.6f}",
            rows=out.num_rows,
            spill_bytes=c.get("spill.stage_out_bytes", 0)
            + c.get("spill.stage_in_bytes", 0),
            stage_out_bytes=c.get("spill.stage_out_bytes", 0),
            stage_in_bytes=c.get("spill.stage_in_bytes", 0),
            spills=c.get("spill.spills", 0), morsels=morsels[q],
            faultins=c.get("spill.faultins", 0),
            morsel_groupbys=c.get("spill.morsel_groupbys", 0),
            morsel_joins=c.get("spill.morsel_joins", 0),
            exchange_bytes_peak=c.get("shuffle.exchange_bytes_peak", 0),
            pinned_bytes=pinned,
            peak_above_resident_bytes=peak,
            kernel_launches=launches[q],
            strategies=",".join(f"{k.split('.')[-1]}:{v}" for k, v in
                                sorted(c.items())
                                if k.startswith("shuffle.strategy."))
            or "none",
            morsel_fires=sum("morsel-scan" in f for f in fires))
        del out
    check(any(morsels.values()), "tpch ooc: some query streamed morsels")
    # (6) the switch
    op = lambda t: QUERIES["q1"](ctx, t)  # noqa: E731
    fresh()
    trace.reset()
    prev_b = config.set_device_memory_budget(budget)
    prev_s = config.set_spill_enabled(False)
    try:
        (out, fires), secs = wall(lambda: planned_run(ctx, op, tables))
    finally:
        config.set_spill_enabled(prev_s)
        config.set_device_memory_budget(prev_b)
        fresh()
    c = trace.counters()
    check(not any("morsel-scan" in f for f in fires)
          and c.get("spill.spills", 0) == 0 and c.get("spill.morsels", 0) == 0,
          "tpch ooc q1 spill off: no morsel scan, nothing spilled")
    same_ordered("tpch ooc q1 spill off == ample", out, ample_rows["q1"])
    check(parity.frames_rowset_equal(out.to_pandas(),
                                     ample_rows["q1"].to_pandas()),
          "tpch ooc q1 spill off: the row set == ample (analysis.parity)")
    say(f"tpch ooc q1 spill=off sf={sf} world={WORLD}", budget=budget,
        seconds=f"{secs:.6f}", rows=out.num_rows, morsel_fires=0,
        spills=0, strategies=",".join(
            f"{k.split('.')[-1]}:{v}" for k, v in sorted(c.items())
            if k.startswith("shuffle.strategy.")) or "none")
    return launches


def phase_spilled_operators(tables, sf: float, exports):
    """(5) Spilled inputs at SF 10: the fused groupby by ``l_orderkey``
    (pre-aggregate) of the fused phase's lineitem projection, and the
    sketch groupby by ``l_suppkey`` of a lineitem projection, each spilled
    and run under a budget that plans 4 morsels: each equals its resident
    result from ``phase_fused_groupby`` / ``phase_sketch``; the partition
    kernel launches once, on the final exchange."""
    from cylon_tpu_torch import Type, config, trace
    from cylon_tpu_torch.parallel import (dist_groupby_fused,
                                          dist_groupby_sketch, dist_project,
                                          dist_with_column)
    from cylon_tpu_torch.spill import morsel as tmorsel
    from cylon_tpu_torch.spill import pool as tpool

    trace.enable_counters()
    launches = {}
    li = dist_with_column(dist_project(tables["lineitem"], [
        "l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
        "l_shipdate"]), "disc_price", _disc_price, Type.DOUBLE)
    sk = dist_project(tables["lineitem"], ["l_suppkey", "l_partkey",
                                           "l_extendedprice"])
    runs = (("fused", li, ["l_orderkey"], lambda t: dist_groupby_fused(
                t, ["l_orderkey"], FUSED_OK_AGGS, mode="pre-aggregate")),
            ("sketch", sk, ["l_suppkey"], lambda t: dist_groupby_sketch(
                t, ["l_suppkey"], SKETCH_AGGS)))
    for name, dt, keys, fn in runs:
        label = f"spilled {name} groupby sf={sf} world={WORLD}"
        rbytes = tmorsel._spilled_rbytes(dt)
        budget = tmorsel.table_priced_bytes(WORLD, -(-dt.cap // 4), rbytes)
        tpool.clear_pool()
        trace.reset()
        dt.spill()
        prev = config.set_device_memory_budget(budget)
        try:
            out, secs, peak, nl = measured(lambda: fn(dt))
        finally:
            config.set_device_memory_budget(prev)
        c = trace.counters()
        launches[name] = nl
        check(dt.is_spilled and c.get("spill.morsels", 0) >= 4
              and c.get("spill.faultins", 0) == 0,
              f"{label}: streamed >= 4 morsels, no fault-in ({c})")
        check(nl == 1, f"{label}: one partition-kernel launch, on the final "
              f"exchange (got {nl})")
        got, _ = exports.submit(lambda: engine_result(out, keys)).wait()
        want = RESIDENT[(name, sf)]
        if name == "fused":
            check_groups(f"{label} vs resident", got, want, FUSED_OK_EXACT,
                         ["sum_disc_price", "mean_disc_price"])
        else:
            check(all(np.array_equal(got[k], want[k]) for k in want),
                  f"{label}: every column equals the resident sketch's")
        say(label, budget=budget, seconds=f"{secs:.6f}",
            morsels=c.get("spill.morsels", 0),
            groups=len(got[keys[0]]), peak_gib=f"{peak:.2f}",
            stage_out_bytes=c.get("spill.stage_out_bytes", 0),
            stage_in_bytes=c.get("spill.stage_in_bytes", 0),
            strategies=",".join(f"{k.split('.')[-1]}:{v}" for k, v in
                                sorted(c.items())
                                if k.startswith("shuffle.strategy."))
            or "none",
            kernel_launches=nl)
        del out, got
    del li, sk
    tpool.clear_pool()
    return launches


# ---------------------------------------------------------------------------
# recovery: the planner's recovery driver and the elastic re-mesh
# ---------------------------------------------------------------------------

RECOVERY_RTOL = 1e-5   # float32 group sums against the float64 oracle
RERUN_RTOL = 1e-6      # ... against another run (another summation order)
HOST_SLACK = 8 << 20   # allocator slack of the no-old-copy check (bytes)


def two_stage(t):
    """The JAX ``two_stage`` fixture's plan: a HASH join, then a groupby
    by the key (two exchange-boundary stages)."""
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import dist_groupby, dist_join

    j = dist_join(t["l"], t["r"], JoinConfig(JoinType.INNER,
                                             JoinAlgorithm.HASH, 0, 0))
    return dist_groupby(j, ["lt-k"], [("rt-v0", "sum")])


def two_stage_oracle(ldata, rdata):
    """(keys, sums) of ``two_stage`` without the engine: per key, the left
    count times the right ``v0`` sum, in float64 on the card."""
    kl = torch.from_numpy(ldata["k"]).to(DEVICE).long()
    kr = torch.from_numpy(rdata["k"]).to(DEVICE).long()
    n_k = int(max(kl.max(), kr.max())) + 1
    cl = torch.bincount(kl, minlength=n_k)
    cr = torch.bincount(kr, minlength=n_k)
    sr = torch.zeros(n_k, dtype=torch.float64, device=DEVICE).index_add_(
        0, kr, torch.from_numpy(rdata["v0"]).to(DEVICE).double())
    keys = torch.nonzero((cl > 0) & (cr > 0)).squeeze(1)
    return keys, cl[keys].double() * sr[keys]


def sorted_groups(out):
    """(keys, sums) of a ``two_stage`` result, by key."""
    t = out.to_table()
    k, v = t.columns[0].data.long(), t.columns[1].data.double()
    order = torch.argsort(k)
    return k[order], v[order]


def check_groups_close(label: str, got, want, rtol: float) -> None:
    (gk, gv), (wk, wv) = got, want
    check(gk.shape == wk.shape and torch.equal(gk, wk),
          f"{label}: the same group keys")
    err = float(((gv - wv).abs() / wv.abs().clamp_min(1e-30)).max())
    check(err <= rtol, f"{label}: sums within {rtol} (max rel err {err:.3e})")


def recover_counts(c) -> str:
    return ",".join(f"{k.split('.', 1)[1]}:{v}" for k, v in sorted(c.items())
                    if k.startswith("recover.") and k != "recover.remesh_us"
                    ) or "none"


def scan_bytes(tables) -> int:
    """Device bytes of the tables' leaves and counts."""
    return sum(sum(c.data.numel() * c.data.element_size()
                   + (0 if c.validity is None else c.validity.numel())
                   for c in t.columns) + t.counts.numel() * 4
               for t in tables.values())


def settled_allocated() -> int:
    """``memory_allocated`` once the queued work is done and the caching
    allocator has seen a malloc (so blocks freed under a recorded copy
    stream are returned)."""
    torch.cuda.synchronize()
    torch.empty(1, device=DEVICE)
    return torch.cuda.memory_allocated()


def recovery_attempts():
    """The ladder's attempt log of the last recovered plan."""
    from cylon_tpu_torch.observe import flightrec

    done = [e for e in flightrec.events() if e.get("kind") == "recover"
            and e.get("action") == "recovered"]
    return [a["action"] for a in done[-1]["attempts"]] if done else []


class StrategySpy:
    """Records the chooser's picks per recovery attempt (the driver opens
    one ``collect_strategy_choices`` window per attempt)."""

    def __enter__(self):
        import contextlib

        from cylon_tpu_torch import resilience

        self.mod, self.real = resilience, resilience.collect_strategy_choices
        self.attempts = []

        @contextlib.contextmanager
        def spy():
            with self.real() as sink:
                self.attempts.append(sink)
                yield sink
        resilience.collect_strategy_choices = spy
        return self

    def __exit__(self, *exc):
        self.mod.collect_strategy_choices = self.real


class EvacuationSpy:
    """Reads the card's allocated bytes right after each re-mesh
    evacuation of the recovery driver."""

    def __enter__(self):
        from cylon_tpu_torch.plan import executor

        self.mod, self.real = executor, executor._evacuate
        self.after = []

        def spy(*args, **kwargs):
            evac = self.real(*args, **kwargs)
            self.after.append(settled_allocated())
            return evac
        executor._evacuate = spy
        return self

    def __exit__(self, *exc):
        self.mod._evacuate = self.real


def recovery_plan(label, tables, rules, ref, oracle):
    """One ``ctx.optimize`` of ``two_stage`` under ``FaultPlan(0, rules)``
    with the counts at 0: its groups are checked against the fault-free
    run and the oracle.  Returns (counters, launches, launches by nparts,
    seconds)."""
    from cylon_tpu_torch import faults, trace
    from cylon_tpu_torch.observe import flightrec
    from cylon_tpu_torch.ops import hash_cuda

    ctx = tables["ctx"]
    tabs = {"l": tables["l"], "r": tables["r"]}
    trace.reset()
    flightrec.clear()
    hash_cuda.launches = 0
    hash_cuda.launches_by_nparts.clear()
    with faults.active(faults.FaultPlan(0, rules)):
        out, secs = wall(lambda: ctx.optimize(two_stage, tabs))
    launches = hash_cuda.launches
    by_np = dict(hash_cuda.launches_by_nparts)
    c = trace.counters()
    got = sorted_groups(out)
    del out
    check_groups_close(f"{label} == fault-free", got, ref, RERUN_RTOL)
    check_groups_close(f"{label} == oracle", got, oracle, RECOVERY_RTOL)
    check(launches > 0, f"{label}: the partition kernel ran")
    return c, launches, by_np, secs


def phase_recovery_join(ldata, rdata, tag=""):
    """The recovery driver on the join cell: the two-stage plan at world
    4 with the broadcast threshold at 1, fault-free (= the oracle), then
    under a transient ``exec.stage`` (stage retry from the memo), a
    resource ``exec.stage`` (replan: the failed attempt's strategies
    never come back, chunked apart), a ``recover.checkpoint_restore``
    fault (replay), a lost slot 4 → 3 (the TOPOLOGY rung: the card's
    allocated bytes before the loss, after the evacuation and after the
    run; no old-world copy of a scan table left), its rejoin 3 → 4 in
    the next plan (the scale-up arm), 4 → 3 → 4 within one plan, and
    with recovery switched off (the first fault propagates).  Every run
    equals the fault-free run and the oracle.  Returns the
    partition-kernel launches per run and those at nparts 3."""
    from cylon_tpu_torch import config, faults, topology, trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import broadcast

    t_start = time.perf_counter()
    trace.enable_counters()
    lt, rt = join_sides(ldata, rdata)
    ctx = lt.ctx
    tables = {"l": lt, "r": rt, "ctx": ctx}
    tabs = {"l": lt, "r": rt}
    n = lt.num_rows
    label = f"{tag}recovery rows={n} world={WORLD}"
    oracle = two_stage_oracle(ldata, rdata)
    prev_thr = config.set_broadcast_join_threshold(1)
    broadcast.clear_replica_cache()
    launches, at3 = {}, {}
    try:
        hash_cuda.launches = 0
        ref, secs = wall(lambda: sorted_groups(ctx.optimize(two_stage, tabs)))
        launches["fault_free"] = hash_cuda.launches
        check_groups_close(f"{label} fault-free == oracle", ref, oracle,
                           RECOVERY_RTOL)
        say(f"{label} fault-free", seconds=f"{secs:.6f}",
            groups=int(ref[0].numel()), kernel_launches=hash_cuda.launches)

        c, launches["transient"], _, secs = recovery_plan(
            f"{label} transient", tables, [faults.FaultRule(
                "exec.stage", kind="transient", nth=2)], ref, oracle)
        check(c.get("recover.stage_retries", 0) == 1
              and c.get("recover.recovered", 0) == 1
              and c.get("recover.checkpoints", 0) >= 1
              and c.get("recover.stages_replayed", 0) == 0,
              f"{label} transient: one stage retry resumed from the memo "
              f"({recover_counts(c)})")
        say(f"{label} transient exec.stage", seconds=f"{secs:.6f}",
            attempts=",".join(recovery_attempts()),
            recover=recover_counts(c),
            kernel_launches=launches["transient"])

        with StrategySpy() as spy:
            c, launches["resource"], _, secs = recovery_plan(
                f"{label} resource", tables, [faults.FaultRule(
                    "exec.stage", kind="resource", nth=2)], ref, oracle)
        failed, replanned = spy.attempts[0], spy.attempts[-1]
        check(len(spy.attempts) == 2 and c.get("recover.replans", 0) == 1
              and c.get("recover.recovered", 0) == 1
              and c.get("recover.checkpoint_hits", 0) >= 1,
              f"{label} resource: one replan resumed from the checkpoint "
              f"({recover_counts(c)})")
        check(not (replanned - {"chunked"}) & failed,
              f"{label} resource: no strategy of the failed attempt "
              f"({sorted(failed)}) came back ({sorted(replanned)})")
        say(f"{label} resource exec.stage", seconds=f"{secs:.6f}",
            attempts=",".join(recovery_attempts()),
            strategies_before=",".join(sorted(failed)) or "none",
            strategies_after=",".join(sorted(replanned)) or "none",
            recover=recover_counts(c), kernel_launches=launches["resource"])

        c, launches["checkpoint_restore"], _, secs = recovery_plan(
            f"{label} restore fault", tables, [
                faults.FaultRule("exec.stage", kind="resource", nth=2),
                faults.FaultRule("recover.checkpoint_restore",
                                 kind="transient", probability=1.0)],
            ref, oracle)
        check(c.get("recover.restore_failed", 0) >= 1
              and c.get("recover.stages_replayed", 0) >= 1
              and c.get("recover.recovered", 0) == 1,
              f"{label} restore fault: the stage replayed "
              f"({recover_counts(c)})")
        say(f"{label} recover.checkpoint_restore", seconds=f"{secs:.6f}",
            attempts=",".join(recovery_attempts()),
            recover=recover_counts(c),
            kernel_launches=launches["checkpoint_restore"])

        # a lost slot, 4 -> 3, then its rejoin in the next plan, 3 -> 4
        try:
            old = scan_bytes(tabs)
            m_before = settled_allocated()
            with EvacuationSpy() as ev:
                c, launches["lost_4_to_3"], by_np, secs = recovery_plan(
                    f"{label} lost", tables, [faults.FaultRule(
                        "mesh.device_lost", kind="topology", nth=2,
                        lost=1)], ref, oracle)
            m_after = settled_allocated()
            new = scan_bytes(tabs)
            at3["lost_4_to_3"] = by_np.get(3, 0)
            check(c.get("recover.remesh", 0) == 1
                  and c.get("recover.recovered", 0) == 1
                  and lt.nparts == rt.nparts == 3
                  and lt.ctx is topology.effective(ctx),
                  f"{label} lost: re-meshed onto 3 survivors "
                  f"({recover_counts(c)})")
            check(at3["lost_4_to_3"] > 0,
                  f"{label} lost: the partition kernel ran at nparts 3 "
                  f"({by_np})")
            check(m_after - m_before <= new - old + HOST_SLACK,
                  f"{label} lost: the card holds the scan tables once "
                  f"(allocated {m_before} -> {m_after} B, tables {old} -> "
                  f"{new} B)")
            say(f"{label} mesh.device_lost 4->3", seconds=f"{secs:.6f}",
                attempts=",".join(recovery_attempts()),
                evacuated_bytes=c.get("recover.evacuated_bytes", 0),
                remesh_us=c.get("recover.remesh_us", 0),
                allocated_before_loss=m_before,
                allocated_after_evacuation=ev.after[0],
                allocated_after_run=m_after, scan_bytes_before=old,
                scan_bytes_after=new, recover=recover_counts(c),
                kernel_launches=launches["lost_4_to_3"],
                kernel_launches_nparts3=at3["lost_4_to_3"])
            c, launches["joined_3_to_4"], by_np, secs = recovery_plan(
                f"{label} joined", tables, [faults.FaultRule(
                    "mesh.device_joined", kind="topology", nth=1, lost=1)],
                ref, oracle)
            check(c.get("recover.scaleups", 0) == 1
                  and lt.ctx is ctx and rt.ctx is ctx
                  and not topology.degraded(ctx),
                  f"{label} joined: the plan grew back onto world 4 "
                  f"({recover_counts(c)})")
            say(f"{label} mesh.device_joined 3->4", seconds=f"{secs:.6f}",
                evacuated_bytes=c.get("recover.evacuated_bytes", 0),
                remesh_us=c.get("recover.remesh_us", 0),
                recover=recover_counts(c),
                kernel_launches=launches["joined_3_to_4"],
                kernel_launches_by_nparts=by_np)
        finally:
            topology.reset()

        # 4 -> 3 -> 4 within one plan
        try:
            m_before = settled_allocated()
            with EvacuationSpy() as ev:
                c, launches["lost_joined_one_plan"], by_np, secs = \
                    recovery_plan(f"{label} lost+joined", tables, [
                        faults.FaultRule("mesh.device_lost", kind="topology",
                                         nth=2, lost=1),
                        faults.FaultRule("mesh.device_joined",
                                         kind="topology", probability=1.0,
                                         limit=1, lost=1,
                                         after="mesh.device_lost")],
                        ref, oracle)
            m_after = settled_allocated()
            check(c.get("recover.remesh", 0) == 1
                  and c.get("recover.scaleups", 0) == 1
                  and lt.ctx is ctx and rt.ctx is ctx,
                  f"{label} lost+joined: 4 -> 3 -> 4 in one plan "
                  f"({recover_counts(c)})")
            check(m_after - m_before <= HOST_SLACK,
                  f"{label} lost+joined: back on world 4, the card holds "
                  f"what it held ({m_before} -> {m_after} B)")
            say(f"{label} 4->3->4 in one plan", seconds=f"{secs:.6f}",
                evacuated_bytes=c.get("recover.evacuated_bytes", 0),
                remesh_us=c.get("recover.remesh_us", 0),
                allocated_before_loss=m_before,
                allocated_after_evacuations=",".join(map(str, ev.after)),
                allocated_after_run=m_after, recover=recover_counts(c),
                kernel_launches=launches["lost_joined_one_plan"],
                kernel_launches_by_nparts=by_np)
        finally:
            topology.reset()

        # recovery off: the first fault propagates
        prev = config.set_recovery_enabled(False)
        trace.reset()
        hash_cuda.launches = 0
        try:
            with faults.active(faults.FaultPlan(0, [faults.FaultRule(
                    "exec.stage", kind="transient", nth=2)])):
                ctx.optimize(two_stage, tabs)
            raise AssertionError(f"check failed: {label} recovery off: "
                                 "the fault did not propagate")
        except faults.TransientFault as e:
            check(not hasattr(e, "ladder"), f"{label} recovery off: the "
                  "error carries no attempt log")
        finally:
            config.set_recovery_enabled(prev)
        c = trace.counters()
        launches["recovery_off"] = hash_cuda.launches
        check(recover_counts(c) == "none",
              f"{label} recovery off: no ladder ran ({recover_counts(c)})")
        say(f"{label} recovery off", propagated="TransientFault",
            kernel_launches=launches["recovery_off"])
    finally:
        config.set_broadcast_join_threshold(prev_thr)
        topology.reset()
        broadcast.clear_replica_cache()
    say(f"{label} phases", wall_seconds=f"{time.perf_counter() - t_start:.3f}")
    return launches, at3


RECOVERY_QUERIES = ("q5", "q21")


def phase_recovery_tpch(ctx, tables, sf: float):
    """Q5 and Q21 (the queries with the most exchanges) through
    ``ctx.optimize`` at world 4, each losing a slot at its second exchange
    boundary: the plan resumes on 3 survivors and equals its fault-free
    planned run; the partition kernel runs at nparts 3; the card holds
    each scan table once afterwards.  The scan tables then move back onto
    world 4 (timed).  Returns the launches per query and those at
    nparts 3."""
    from cylon_tpu_torch import faults, topology, trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.parallel.remesh import remesh_table
    from cylon_tpu_torch.tpch import QUERIES

    t_start = time.perf_counter()
    trace.enable_counters()
    launches, at3 = {}, {}
    for q in RECOVERY_QUERIES:
        label = f"recovery tpch {q} sf={sf} world={WORLD}"
        op = lambda t, q=q: QUERIES[q](ctx, t)  # noqa: E731
        broadcast.clear_replica_cache()
        hash_cuda.launches = 0
        ref, ref_s = wall(lambda: ctx.optimize(op, tables))
        ref_launches = hash_cuda.launches
        broadcast.clear_replica_cache()
        old = scan_bytes(tables)
        m_before = settled_allocated()
        trace.reset()
        hash_cuda.launches = 0
        hash_cuda.launches_by_nparts.clear()
        try:
            with EvacuationSpy() as ev, \
                    faults.active(faults.FaultPlan(0, [faults.FaultRule(
                        "mesh.device_lost", kind="topology", nth=2,
                        lost=1)])):
                out, secs = wall(lambda: ctx.optimize(op, tables))
            launches[q] = hash_cuda.launches
            at3[q] = hash_cuda.launches_by_nparts.get(3, 0)
            c = trace.counters()
            order = same_result(q, ref, out, what="the fault-free run and "
                                "the run that lost a slot")
            del out
            broadcast.clear_replica_cache()
            m_after = settled_allocated()
            new = scan_bytes(tables)
            moved = [k for k, t in tables.items() if t.nparts == 3]
            check(c.get("recover.remesh", 0) == 1
                  and c.get("recover.recovered", 0) >= 1 and moved,
                  f"{label}: re-meshed onto 3 survivors "
                  f"({recover_counts(c)})")
            # a plan whose exchanges are all broadcasts or dense-key
            # shuffles hashes nothing (Q5 at SF 10; every query's small
            # tables)
            check(at3[q] > 0 or not ref_launches,
                  f"{label}: the partition kernel ran at nparts 3, as the "
                  f"fault-free run launched it ({ref_launches} times)")
            check(m_after - m_before <= new - old + HOST_SLACK,
                  f"{label}: the card holds the scan tables once "
                  f"(allocated {m_before} -> {m_after} B, tables {old} -> "
                  f"{new} B)")
        finally:
            topology.reset()
            t0 = time.perf_counter()
            back = sum(remesh_table(t, ctx) for t in tables.values()
                       if t.ctx is not ctx)
            torch.cuda.synchronize()
            back_s = time.perf_counter() - t0
        say(label, seconds=f"{secs:.6f}", fault_free_seconds=f"{ref_s:.6f}",
            rows=ref.num_rows, order=order.replace(" ", "_"),
            remeshed_tables=",".join(moved),
            evacuated_bytes=c.get("recover.evacuated_bytes", 0),
            remesh_us=c.get("recover.remesh_us", 0),
            allocated_before_loss=m_before,
            allocated_after_evacuation=ev.after[0] if ev.after else "none",
            allocated_after_run=m_after, scan_bytes_before=old,
            scan_bytes_after=new, recover=recover_counts(c),
            kernel_launches=launches[q], kernel_launches_nparts3=at3[q],
            fault_free_kernel_launches=ref_launches,
            back_to_world4_bytes=back, back_to_world4_seconds=f"{back_s:.3f}")
        del ref
    say(f"recovery tpch sf={sf}",
        wall_seconds=f"{time.perf_counter() - t_start:.3f}")
    return launches, at3


# ---------------------------------------------------------------------------
# phase: the multi-process communicator (torch.distributed behind the
# context's collectives)
# ---------------------------------------------------------------------------

MP_WARM_ROWS = 4096
MP_CHILD_ROWS = 1 << 20      # rows a side of the 2-process run on one card
MP_A2A_BYTES = 1 << 28       # payload of the all_to_all rate measurement
MP_CHILD_WAIT_S = 120        # each child's wait (then both are killed)
MP_BACKEND = "nccl"          # the one-process phase's backend


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mp_ops(strategy_shapes=LOWERINGS):
    """(label, op, forced strategy, mesh shape) of the phase: a HASH and a
    SORT ``dist_join`` and ``shuffle_table`` on the join cell, the
    ``orderkey`` groupby on the lineitem cell, then ``shuffle_table``
    under each lowering forced."""
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import dist_groupby, dist_join, shuffle_table

    ops = [("dist_join hash",
            lambda s: dist_join(s["l"], s["r"], JoinConfig(
                JoinType.INNER, JoinAlgorithm.HASH, 0, 0,
                broadcast_threshold=0)), None, None),
           ("dist_join sort",
            lambda s: dist_join(s["l"], s["r"], JoinConfig(
                JoinType.INNER, JoinAlgorithm.SORT, 0, 0,
                broadcast_threshold=0)), None, None),
           ("shuffle_table k", lambda s: shuffle_table(s["l"], ["k"]),
            None, None),
           ("dist_groupby orderkey",
            lambda s: dist_groupby(s["li"], ["orderkey"], HC_AGGS),
            None, None)]
    for strategy, shape in strategy_shapes:
        ops.append((f"shuffle_table k {strategy}",
                    lambda s: shuffle_table(s["l"], ["k"]), strategy, shape))
    return ops


def mp_sides(ctx, ldata, rdata, li, li_null):
    from cylon_tpu_torch import Table
    from cylon_tpu_torch.parallel import DTable

    t = Table.from_columns(ctx, li)
    t.column("price").validity = torch.from_numpy(~li_null).to(ctx.device)
    return {"l": DTable.from_table(ctx, to_table(ctx, ldata, None)),
            "r": DTable.from_table(ctx, to_table(ctx, rdata, None)),
            "li": DTable.from_table(ctx, t)}


def mp_row_hashes(dt):
    """Per local shard, its rows' 64-bit hashes in row order: every
    column's 4-byte words (and its validity) mixed, whatever the width."""
    n = dt.nlocal * dt.cap
    h = torch.zeros(n, dtype=torch.int64, device=DEVICE)
    for c in dt.columns:
        for x in (c.data, c.validity):
            if x is None:
                continue
            if x.element_size() < 4:
                x = x.to(torch.int32)
            words = x.contiguous().view(torch.int32).view(n, -1).long()
            for j in range(words.shape[1]):
                h = (h ^ (words[:, j] & 0xFFFFFFFF)) * MIX
                h = h ^ ((h >> 29) & 0x7FFFFFFFF)
    counts = [int(v) for v in dt.counts.cpu()]  # graftlint: ok[implicit-host-sync]
    return [h[s * dt.cap:s * dt.cap + k] for s, k in enumerate(counts)]


def mp_run(op, sides, strategy, shape):
    """``op(sides)`` from cleared size hints under the forced strategy
    and mesh shape: (result, seconds, kernel launches); a forced strategy
    must be the one that ran."""
    from cylon_tpu_torch import config, trace
    from cylon_tpu_torch.parallel import dist_ops

    dist_ops.clear_size_hints()
    config.set_exchange_strategy(strategy)
    config.set_mesh_shape(shape)
    counting = trace.counters_enabled()
    trace.enable_counters()
    trace.reset()
    try:
        reset_launches()
        out, secs = wall(lambda: op(sides))
        ran = trace.counters()
        if strategy is not None:
            check(ran.get(f"shuffle.strategy.{strategy.replace('-', '_')}",
                          0) >= 1, f"multiprocess: ran {strategy} ({ran})")
        return out, secs, read_launches()[0]
    finally:
        config.set_exchange_strategy(None)
        config.set_mesh_shape(None)
        if not counting:
            trace.disable_counters()


def a2a_gbps(comm, nbytes: int) -> tuple:
    """(ms, GB/s) of one ``all_to_all`` of an ``[L, P, …]`` int32 block
    of ``nbytes`` (every byte read once and written once by the
    exchange), CUDA events."""
    L, P = comm.local, comm.world
    x = torch.randint(0, 1 << 30, (L, P, nbytes // (4 * L * P)),
                      dtype=torch.int32, device=DEVICE)
    ms = cuda_ms(lambda: comm.all_to_all(x), 10)
    return ms, x.numel() * 4 / (ms * 1e-3) / 1e9


def phase_multiprocess(ldata, rdata, want, li, li_null):
    """One process driving 4 local ranks through ``CylonContext.
    InitMultiHost`` over NCCL: every op of ``mp_ops`` on the join and
    lineitem cells equals the single-process world 4 shard for shard
    (each shard's rows in order), the HASH join also equals the oracle
    and launches the partition kernel twice; one line each with the
    seconds beside the single-process world's.  Then the NCCL
    ``all_to_all`` rate beside ``LocalCommunicator``'s.  Returns the
    kernel launches per op."""
    from cylon_tpu_torch import CylonContext

    ctx = CylonContext.InitMultiHost(
        f"tcp://127.0.0.1:{free_port()}", 1, 0, world=WORLD, device=DEVICE,
        backend=MP_BACKEND, timeout=600)
    try:
        check(ctx.comm.backend == MP_BACKEND
              and ctx.get_world_size() == WORLD
              and ctx.local_ranks() == list(range(WORLD))
              and ctx.get_neighbours() == [] and ctx.is_distributed(),
              "multiprocess: the NCCL context's controller API")
        sim = CylonContext(device=DEVICE, world=WORLD)
        ops = mp_ops()
        rng = np.random.default_rng(1)
        wl, wr = make_side(rng, MP_WARM_ROWS)[0], make_side(rng, MP_WARM_ROWS)[0]
        wli, wnull = make_lineitem(rng, MP_WARM_ROWS)
        for c in (ctx, sim):  # first use of each library kernel
            s = mp_sides(c, wl, wr, wli, wnull)
            for _, op, strategy, shape in ops:
                mp_run(op, s, strategy, shape)
        got_sides = mp_sides(ctx, ldata, rdata, li, li_null)
        sim_sides = mp_sides(sim, ldata, rdata, li, li_null)
        launches = {}
        for label, op, strategy, shape in ops:
            got, secs, n = mp_run(op, got_sides, strategy, shape)
            ref, ref_secs, ref_n = mp_run(op, sim_sides, strategy, shape)
            same = got.cap == ref.cap and all(
                torch.equal(a, b) for a, b in zip(mp_row_hashes(got),
                                                  mp_row_hashes(ref)))
            check(same, f"multiprocess {label}: shards == the single-process "
                        "world's, in order")
            if label == "dist_join hash":
                check_join(f"multiprocess {label}", got.to_table(), want)
                check(n == 2, f"multiprocess {label}: 2 launches ({n})")
            launches[label] = n
            say(f"multiprocess {label}", backend=MP_BACKEND, processes=1,
                world=WORLD, rows=got.num_rows, seconds=f"{secs:.6f}",
                single_process_seconds=f"{ref_secs:.6f}", launches=n,
                single_process_launches=ref_n, cap=got.cap)
            del got, ref
        del got_sides, sim_sides
        ms, gbps = a2a_gbps(ctx.comm, MP_A2A_BYTES)
        lms, lgbps = a2a_gbps(sim.comm, MP_A2A_BYTES)
        say("multiprocess all_to_all", backend=MP_BACKEND, world=WORLD,
            bytes=MP_A2A_BYTES, ms=f"{ms:.4f}", gbps=f"{gbps:.1f}",
            local_communicator_ms=f"{lms:.4f}",
            local_communicator_gbps=f"{lgbps:.1f}")
    finally:
        ctx.finalize()
    return launches


def mp_child(argv) -> int:
    """One of two processes on the one card (``--mp-child PROC BACKEND
    INIT OUT``): 2 local ranks each, a world of 4; the HASH join and
    ``shuffle_table`` of a ``MP_CHILD_ROWS`` cell; per local shard the
    row count and an order-sensitive digest of its row hashes, as JSON in
    ``OUT``."""
    proc, backend, init, out = int(argv[0]), argv[1], argv[2], argv[3]
    from cylon_tpu_torch import CylonContext

    ctx = CylonContext.InitMultiHost(init, 2, proc, world=2, device=DEVICE,
                                     backend=backend, timeout=60)
    res = {}
    try:
        res = mp_digests(ctx)
    finally:
        ctx.finalize()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def shard_digests(dt):
    """Per local shard: [rows, Σ (low word of row hash i) · (i + 1),
    cap] of this process's blocks (``mp_row_hashes``)."""
    out = []
    for r in mp_row_hashes(dt):
        w = torch.arange(1, r.shape[0] + 1, device=DEVICE)
        out.append([r.shape[0], int(((r & 0xFFFFFFFF) * w).sum()), dt.cap])
    return out


def mp_digests(ctx):
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch.parallel import DTable, dist_join, shuffle_table

    rng = np.random.default_rng(7)
    ldata, rdata = make_side(rng, MP_CHILD_ROWS)[0], \
        make_side(rng, MP_CHILD_ROWS)[0]
    lt = DTable.from_table(ctx, to_table(ctx, ldata, None))
    rt = DTable.from_table(ctx, to_table(ctx, rdata, None))
    t0 = time.perf_counter()
    j = dist_join(lt, rt, JoinConfig(JoinType.INNER, JoinAlgorithm.HASH, 0,
                                     0, broadcast_threshold=0))
    sh = shuffle_table(lt, ["k"])
    torch.cuda.synchronize()
    return {"join": shard_digests(j), "shuffle": shard_digests(sh),
            "seconds": time.perf_counter() - t0}


def child_error(log: str) -> str:
    """The line of a failed child's output that says why."""
    lines = [ln.strip() for ln in (log or "").splitlines() if ln.strip()]
    for pat in ("Duplicate GPU", "invalid usage", "ncclInvalidUsage",
                "Error:", "error:"):
        hit = [ln for ln in lines if pat in ln and not
               ln.endswith("Last error:")]
        if hit:
            return hit[-1][:240]
    return lines[-1][:240] if lines else ""


def phase_multiprocess_two(tmp: str):
    """Two processes on the one card, 2 local ranks each, for each
    backend: NCCL (which refuses two ranks on one device in most
    versions; the error is recorded) and gloo on the CUDA tensors (an
    explicit backend choice: gloo stages them through host memory for
    the collectives it has).  Both pairs start together.  A backend that
    runs must equal the single-process world 4 shard for shard; one that
    does not is recorded.  Returns {backend: outcome}."""
    import os
    from cylon_tpu_torch import CylonContext

    sim = mp_digests(CylonContext(device=DEVICE, world=WORLD))
    os.makedirs(tmp, exist_ok=True)
    runs = {}
    t0 = time.perf_counter()
    for backend in ("nccl", "gloo"):
        init = f"tcp://127.0.0.1:{free_port()}"
        outs = [os.path.join(tmp, f"mp_{backend}_{p}.json") for p in range(2)]
        for o in outs:
            if os.path.exists(o):
                os.remove(o)
        runs[backend] = (outs, [subprocess.Popen(
            [sys.executable, __file__, "--mp-child", str(p), backend, init,
             outs[p]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for p in range(2)])
    outcome = {}
    try:
        for backend, (outs, procs) in runs.items():
            logs, rcs = [], []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=MP_CHILD_WAIT_S)[0])
                    rcs.append(p.returncode)
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0] + "\ntimed out")
                    rcs.append(None)
            secs = time.perf_counter() - t0
            if rcs == [0, 0]:
                got = [json.load(open(o)) for o in outs]
                for key in ("join", "shuffle"):
                    check(got[0][key] + got[1][key] == sim[key],
                          f"multiprocess 2 processes {backend} {key}: "
                          "shards == the single-process world 4's")
                outcome[backend] = "ran, equal to the single-process world"
                say("multiprocess 2 processes on one card", backend=backend,
                    result="ran", seconds=f"{secs:.1f}",
                    child_seconds="/".join(f"{g['seconds']:.3f}"
                                           for g in got),
                    single_process_seconds=f"{sim['seconds']:.3f}")
            else:
                err = next((e for e in map(child_error, logs) if e), "")
                outcome[backend] = f"refused: {err or rcs}"
                say("multiprocess 2 processes on one card", backend=backend,
                    result="refused", rcs=rcs, seconds=f"{secs:.1f}",
                    error=repr(err))
    finally:
        for _, procs in runs.values():   # stop every child we started
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return outcome


# ---------------------------------------------------------------------------
# phase: TPC-H and the planner across processes — the generator, the 22
# queries eager and planned, the plan check, run_pipeline and EXPLAIN
# ANALYZE through the process communicator over NCCL, then two processes
# of 2 local ranks each on the card over gloo
# ---------------------------------------------------------------------------

MP_TPCH_WARM_SF = 0.05       # the NCCL context's first use of each path
MP_TPCH_CHILD_SF = 0.05      # the two-process run (gloo stages every
                             # collective through host memory)
MP_TPCH_CHILD_QUERIES = (("q1", {}), ("q5", {}),
                         ("q9", {"streaming_chunks": 3}), ("q21", {}))
MP_TPCH_CHILD_WAIT_S = 300


def result_json(t):
    """A result Table's columns as ``{name: [numpy dtype, values]}``
    (strings decoded)."""
    return {c: [str(v.dtype), [str(x) for x in v] if v.dtype == object
                else v.tolist()] for c, v in _cols(t).items()}


def same_json(label: str, got: dict, want: dict) -> None:
    """Two ``result_json`` frames: the same columns, types and rows in
    order, keys and integers exact, floats within ``_rtol``."""
    check([(c, d) for c, (d, _) in got.items()]
          == [(c, d) for c, (d, _) in want.items()],
          f"{label}: the same columns and types")
    for c, (dtype, values) in want.items():
        y = np.asarray(values, dtype=None if dtype == "object" else dtype)
        x = np.asarray(got[c][1], dtype=y.dtype)
        ok = (_close(x, y, _rtol(c, y)) if y.dtype.kind == "f"
              else np.array_equal(x, y))
        check(ok, f"{label}: column {c} equal, in order")


def mp_tpch_results(ctx, seed: int):
    """The two-process run's queries at ``MP_TPCH_CHILD_SF`` on ``ctx``:
    Q1, Q5, Q9 with ``streaming_chunks=3`` and Q21 eager, and Q5 through
    ``ctx.optimize``; ``{name: result_json, "seconds": s}``."""
    from cylon_tpu_torch.tpch import QUERIES, generate_device

    tables = generate_device(ctx, MP_TPCH_CHILD_SF, seed=seed)
    out = {}
    t0 = time.perf_counter()
    for q, kw in MP_TPCH_CHILD_QUERIES:
        name = q + ("_streaming" if kw else "")
        out[name] = result_json(QUERIES[q](ctx, tables, **kw))
    out["q5_planned"] = result_json(ctx.optimize(
        lambda t: QUERIES["q5"](ctx, t), tables))
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def mp_tpch_child(argv) -> int:
    """One of two processes on the one card (``--mp-tpch-child PROC SEED
    INIT OUT``): 2 local ranks each over gloo, a world of 4;
    ``mp_tpch_results`` as JSON in ``OUT``."""
    proc, seed, init, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    from cylon_tpu_torch import CylonContext

    ctx = CylonContext.InitMultiHost(init, 2, proc, world=2, device=DEVICE,
                                     backend="gloo", timeout=120)
    try:
        res = mp_tpch_results(ctx, seed)
    finally:
        ctx.finalize()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def mp_tpch_two(tmp: str, seed: int):
    """Two processes of 2 local ranks each on the one card over gloo: Q1,
    Q5, Q9 streaming and Q21 eager and Q5 planned at
    ``MP_TPCH_CHILD_SF``, each equal to the single-process world 4's in
    every process.  Returns the children's seconds."""
    import os
    from cylon_tpu_torch import CylonContext

    sim = mp_tpch_results(CylonContext(device=DEVICE, world=WORLD), seed)
    os.makedirs(tmp, exist_ok=True)
    init = f"tcp://127.0.0.1:{free_port()}"
    outs = [os.path.join(tmp, f"mp_tpch_{p}.json") for p in range(2)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--mp-tpch-child", str(p), str(seed),
         init, outs[p]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(2)]
    try:
        logs, rcs = [], []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=MP_TPCH_CHILD_WAIT_S)[0])
                rcs.append(p.returncode)
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\ntimed out")
                rcs.append(None)
    finally:
        for p in procs:   # stop every child we started
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    check(rcs == [0, 0], "multiprocess tpch 2 processes gloo: both ran "
          f"({rcs}: {next((e for e in map(child_error, logs) if e), '')})")
    got = [json.load(open(o)) for o in outs]
    for proc, g in enumerate(got):
        for name in sim:
            if name != "seconds":
                same_json(f"multiprocess tpch 2 processes gloo {name} "
                          f"process {proc} == world 4", g[name], sim[name])
    say("multiprocess tpch 2 processes on one card", backend="gloo",
        sf=MP_TPCH_CHILD_SF, queries=",".join(n for n in sim
                                              if n != "seconds"),
        seconds=f"{secs:.1f}",
        child_seconds="/".join(f"{g['seconds']:.3f}" for g in got),
        single_process_seconds=f"{sim['seconds']:.3f}")
    return [g["seconds"] for g in got]


def analyze_rows(rep):
    return [(n.op, n.runtime["rows_in"], n.runtime["rows_out"])
            for n in rep.nodes]


def phase_multiprocess_tpch(sim_ctx, sim_tables, sf: float, seed: int,
                            eager, eager_times, launches_eager,
                            launches_planned):
    """TPC-H through ``CylonContext.InitMultiHost(world=4)``, one process
    of 4 local ranks over NCCL, against the single-process world 4 of
    the TPC-H phase (``sim_ctx`` / ``sim_tables``, its ``eager`` results
    and times, its partition-kernel launches eager and planned):

    * ``generate_device`` at ``sf``: every table shard for shard (counts,
      ``cap`` and the row hashes of every column, in order);
    * the 22 queries eager (each = the eager result in order, the same
      launches; seconds beside the single-process seconds), then through
      ``ctx.optimize`` twice (a plan-cache miss, then a hit; each = the
      eager result; the hit pass's launches = the single-process hit
      pass's);
    * ``plan_check.validate`` of every query: 0 launches, 0 host reads, 0
      card bytes and 0 calls into the communicator;
    * ``run_pipeline`` of every query twice (= eager; ``host.read`` and
      ``pipeline.replays``);
    * ``ctx.analyze`` of Q5: node rows = the single-process report's;

    then two processes of 2 local ranks on the card over gloo at
    ``MP_TPCH_CHILD_SF`` (``mp_tpch_two``).  The NCCL context's tables
    are freed at the end.  Returns the launches per form and query."""
    from cylon_tpu_torch import CylonContext, plan, trace
    from cylon_tpu_torch.analysis import plan_check
    from cylon_tpu_torch.ops import compact, hash_cuda
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.tpch import QUERIES, generate_device

    ctx = CylonContext.InitMultiHost(
        f"tcp://127.0.0.1:{free_port()}", 1, 0, world=WORLD, device=DEVICE,
        backend=MP_BACKEND, timeout=600)
    launches = {"eager": {}, "planned": {}, "pipeline": {}, "plan_check": 0}
    try:
        check(ctx.comm.backend == MP_BACKEND
              and ctx.get_process_count() == 1
              and ctx.get_local_world_size() == WORLD,
              "multiprocess tpch: one process of 4 local ranks over "
              f"{MP_BACKEND}")
        # the first use of every query's path on the NCCL context
        wt = generate_device(ctx, MP_TPCH_WARM_SF, seed=seed)
        for q in QUERIES:
            QUERIES[q](ctx, wt)
        del wt
        broadcast.clear_replica_cache()
        torch.cuda.reset_peak_memory_stats()
        tables, gsecs = wall(lambda: generate_device(ctx, sf, seed=seed))
        for name, dt in tables.items():
            ref = sim_tables[name]
            same = (dt.cap == ref.cap and list(dt.counts_host())
                    == list(ref.counts_host()) and all(
                        torch.equal(a, b) for a, b in
                        zip(mp_row_hashes(dt), mp_row_hashes(ref))))
            check(same, f"multiprocess tpch generate {name}: shards == the "
                        "single-process world 4's, in order")
        say(f"multiprocess tpch generate sf={sf}", backend=MP_BACKEND,
            processes=1, world=WORLD, seconds=f"{gsecs:.6f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            tables=len(tables))
        calls0 = ctx.comm.calls
        times = {}
        for q in QUERIES:
            c0 = ctx.comm.calls
            out, secs, peak, n, taken, _ = run_query(q, ctx, tables)
            same_ordered(f"multiprocess tpch {q} == world 4", out, eager[q])
            check(n == launches_eager[q], f"multiprocess tpch {q}: "
                  f"{launches_eager[q]} launches, as in one process ({n})")
            launches["eager"][q], times[q] = n, secs
            say(f"multiprocess tpch {q} sf={sf}", backend=MP_BACKEND,
                seconds=f"{secs:.6f}",
                single_process_seconds=f"{eager_times[q]:.6f}",
                ratio=f"{secs / eager_times[q]:.3f}", rows=out.num_rows,
                peak_gib=f"{peak:.2f}", kernel_launches=n,
                communicator_calls=ctx.comm.calls - c0,
                decisions=",".join(f"{k}:{v}" for k, v in
                                   sorted(taken.items())) or "none")
            del out
        check(ctx.comm.calls > calls0, "multiprocess tpch: the queries "
              "went through the process communicator")
        say(f"multiprocess tpch sf={sf}", backend=MP_BACKEND,
            total_seconds=f"{sum(times.values()):.6f}",
            single_process_total_seconds=f"{sum(eager_times.values()):.6f}",
            kernel_launches=sum(launches["eager"].values()),
            single_process_launches=sum(launches_eager.values()),
            communicator_calls=ctx.comm.calls - calls0)
        plan.clear_plan_cache()
        runs = {p: {q: run_query(q, ctx, tables, planned=True)
                    for q in QUERIES} for p in ("miss", "hit")}
        hits = 0
        for q in QUERIES:
            miss, hit = runs["miss"][q], runs["hit"][q]
            check(miss[5].get("plan.cache_miss", 0) >= 1
                  and hit[5].get("plan.cache_miss", 0) == 0
                  and hit[5].get("plan.cache_hit", 0) >= 1,
                  f"multiprocess tpch planner {q}: a miss, then a hit")
            same_ordered(f"multiprocess tpch planner {q} (miss) == eager",
                         miss[0], eager[q])
            same_ordered(f"multiprocess tpch planner {q} (hit) == eager",
                         hit[0], eager[q])
            check(hit[3] == launches_planned[q],
                  f"multiprocess tpch planner {q}: {launches_planned[q]} "
                  f"launches, as in one process ({hit[3]})")
            launches["planned"][q] = hit[3]
            hits += hit[5].get("plan.cache_hit", 0)
        say(f"multiprocess tpch planner sf={sf}", backend=MP_BACKEND,
            total_miss_seconds=f"{sum(r[1] for r in runs['miss'].values()):.6f}",
            total_hit_seconds=f"{sum(r[1] for r in runs['hit'].values()):.6f}",
            plan_cache_hits=hits,
            kernel_launches=sum(launches["planned"].values()),
            single_process_launches=sum(launches_planned.values()))
        del runs
        pc_secs, pc_calls = 0.0, 0
        for q in QUERIES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            hash_cuda.launches = 0
            trace.reset()
            c0 = ctx.comm.calls
            rep, secs = wall(lambda: plan_check.validate(
                lambda t: QUERIES[q](ctx, t), tables,
                concrete=("nation", "region")))
            calls = ctx.comm.calls - c0
            reads = trace.counters().get("host.read", 0)
            card = torch.cuda.max_memory_allocated() - base
            label = f"multiprocess plan check {q}"
            check(rep.ok and len(rep.nodes) > 0, f"{label}: VALID ({rep})")
            check((hash_cuda.launches, reads, card, calls) == (0, 0, 0, 0),
                  f"{label}: 0 launches, host reads, card bytes and "
                  f"communicator calls ({hash_cuda.launches}, {reads}, "
                  f"{card}, {calls})")
            pc_secs += secs
            pc_calls += calls
        say(f"multiprocess plan check sf={sf}", backend=MP_BACKEND,
            queries=len(QUERIES), seconds=f"{pc_secs:.6f}",
            kernel_launches=0, host_reads=0, card_bytes=0,
            communicator_calls=pc_calls)
        pipe = {"host.read": 0, "pipeline.replays": 0, "seconds": 0.0}
        for q in QUERIES:
            fn = lambda q=q: QUERIES[q](ctx, tables)  # noqa: E731
            compact.run_pipeline(fn)   # warm hints
            out, secs, cnt, n = pipeline_run(
                lambda: compact.run_pipeline(fn))
            same_ordered(f"multiprocess tpch pipeline {q} == eager", out,
                         eager[q])
            launches["pipeline"][q] = n
            for k in ("host.read", "pipeline.replays"):
                pipe[k] += cnt.get(k, 0)
            pipe["seconds"] += secs
            say(f"multiprocess tpch pipeline {q} sf={sf}",
                backend=MP_BACKEND, seconds=f"{secs:.6f}",
                host_read=cnt.get("host.read", 0),
                replays=cnt.get("pipeline.replays", 0), kernel_launches=n)
            del out
        say(f"multiprocess tpch pipeline sf={sf}", backend=MP_BACKEND,
            seconds=f"{pipe['seconds']:.6f}", host_read=pipe["host.read"],
            replays=pipe["pipeline.replays"],
            kernel_launches=sum(launches["pipeline"].values()))
        q5 = lambda c: (lambda t: QUERIES["q5"](c, t))  # noqa: E731
        rep = ctx.analyze(q5(ctx), tables)
        ref = sim_ctx.analyze(q5(sim_ctx), sim_tables)
        check(rep.ok and ref.ok, "multiprocess tpch analyze q5: both ran")
        check(analyze_rows(rep) == analyze_rows(ref),
              "multiprocess tpch analyze q5: node rows == the "
              "single-process report's")
        same_ordered("multiprocess tpch analyze q5 == eager", rep.output,
                     eager["q5"])
        say(f"multiprocess tpch analyze q5 sf={sf}", backend=MP_BACKEND,
            nodes=len(rep.nodes), ms=f"{rep.totals['ms']:.3f}",
            single_process_ms=f"{ref.totals['ms']:.3f}",
            bytes_moved=rep.totals["bytes_moved"],
            processes=rep.totals["processes"])
        del tables, rep, ref
        broadcast.clear_replica_cache()
    finally:
        ctx.finalize()
    launches["two_processes_gloo_seconds"] = mp_tpch_two("build", seed)
    return launches


# ---------------------------------------------------------------------------
# phases: ingest and the data-model surfaces — Arrow / pandas / per-rank CSV
# ingest through StagedIngest, hash64 string keys, append with content
# epochs, and the partition hash past 16 key columns
# ---------------------------------------------------------------------------

INGEST_SF = 0.17             # the JAX bench's ingest stage: ~1.02M rows
CSV_RANK_ROWS = 1 << 20      # rows per rank file (cut from the join cell)
STRKEY_DISTINCT, STRKEY_ROWS = 1_200_000, 2_000_000  # the bench's strkey
APPEND_ROWS = 1 << 20        # the delta appended to the join cell's side
WIDE_WIDTHS = (17, 24, 40)   # key columns of the chained kernel's checks
WIDE_SETOP_ROWS, WIDE_SETOP_WIDTH = 4_194_304, 24


def reset_launches() -> None:
    from cylon_tpu_torch.ops import hash_cuda
    hash_cuda.launches = 0
    hash_cuda.launches_chained = 0


def read_launches():
    from cylon_tpu_torch.ops import hash_cuda
    return hash_cuda.launches, hash_cuda.launches_chained


def hash_cfg(lkey=0, rkey=0):
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    return JoinConfig(JoinType.INNER, JoinAlgorithm.HASH, lkey, rkey)


def check_layout(label: str, dt, data, null=None) -> None:
    """A DTable ingested from ``data`` (numpy columns, block-distributed):
    its sizes, ``cap``, ``_counts_host`` and the counts tensor, every
    shard's rows equal to its slice of the source, zero padding, and the
    validity of ``null`` (a mask of the first column) where given."""
    from cylon_tpu_torch.ops.compact import next_bucket

    n = len(next(iter(data.values())))
    base, rem = divmod(n, WORLD)
    sizes = np.array([base + (1 if i < rem else 0) for i in range(WORLD)])
    offs = np.concatenate([[0], np.cumsum(sizes)])
    cap = next_bucket(max(int(sizes.max()), 1), minimum=8)
    check(dt.cap == cap, f"{label}: cap {dt.cap} == {cap}")
    check(list(dt._counts_host) == list(sizes)
          and dt.counts.cpu().tolist() == list(sizes),  # graftlint: ok[implicit-host-sync]
          f"{label}: counts == the block sizes {list(sizes)}")
    for c in dt.columns:
        blocks = c.data.view(WORLD, cap)
        src = torch.from_numpy(data[c.name]).to(blocks.device)
        for s in range(WORLD):
            check(torch.equal(blocks[s, :sizes[s]], src[offs[s]:offs[s + 1]]),
                  f"{label}: column {c.name} shard {s} == its source slice")
            check(not bool(blocks[s, sizes[s]:].view(torch.uint8).any()),
                  f"{label}: column {c.name} shard {s} padding is zero")
        if c.name == "k" and null is not None:
            want = torch.from_numpy(~null).to(blocks.device)
            v = c.validity.view(WORLD, cap)
            for s in range(WORLD):
                check(torch.equal(v[s, :sizes[s]], want[offs[s]:offs[s + 1]]),
                      f"{label}: validity shard {s} == the source's")


def phase_lineitem_ingest():
    """The JAX bench's ingest stage: lineitem from the mirror generator
    (SF 0.17, seed 5, string columns decoded to Python strings) through
    ``DTable.from_pandas`` at world 4, the staging arena on then off, best
    of 2 each, synchronized; MB/s over the 13 four-byte device columns;
    the table read back through Arrow equals its source column by
    column."""
    import pandas as pd

    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.parallel import DTable
    from cylon_tpu_torch.parallel import dtable as dtable_mod
    from cylon_tpu_torch.tpch import datagen_device

    t0 = time.perf_counter()
    mirror, dicts = datagen_device.generate_mirror(INGEST_SF, seed=5,
                                                   tables=("lineitem",))
    src = {c: (dicts[c][v] if c in dicts else v)
           for c, v in mirror["lineitem"].items()}
    df = pd.DataFrame(src)
    gen_s = time.perf_counter() - t0
    rows = len(df)
    mb = rows * 13 * 4 / 1e6
    ctx = CylonContext(device=DEVICE, world=WORLD)
    best = {}
    try:
        for arena_on in (True, False):
            dtable_mod.ARENA_ENABLED = arena_on
            for _ in range(2):
                dt, secs = wall(lambda: DTable.from_pandas(ctx, df))
                best[arena_on] = min(best.get(arena_on, secs), secs)
                del dt
    finally:
        dtable_mod.ARENA_ENABLED = True
    dt = DTable.from_pandas(ctx, df)
    at, export_s = wall(lambda: dt.to_table().to_arrow())
    for name, want in src.items():
        got = at.column(name).to_numpy(zero_copy_only=False)
        if want.dtype == object:
            ok = bool((got == want).all())
        else:
            ok = got.dtype == want.dtype and \
                got.tobytes() == np.ascontiguousarray(want).tobytes()
        check(ok, f"lineitem ingest: column {name} read back == source")
    say(f"ingest lineitem from_pandas world={WORLD}", rows=rows,
        mirror_seconds=f"{gen_s:.3f}", mb=f"{mb:.3f}",
        seconds_arena=f"{best[True]:.6f}",
        seconds_no_arena=f"{best[False]:.6f}",
        ingest_mb_per_sec=f"{mb / best[True]:.3f}",
        ingest_mb_per_sec_no_arena=f"{mb / best[False]:.3f}",
        export_seconds=f"{export_s:.6f}", columns=len(src),
        string_columns=",".join(sorted(dicts)))
    return {"ingest_mb_per_sec": mb / best[True],
            "ingest_mb_per_sec_no_arena": mb / best[False], "rows": rows}


def phase_join_cell_from_arrow(ldata, rdata, want, link):
    """The join cell ingested from pyarrow tables with ``DTable.from_arrow``
    at world 4 (the layout, padding and counts checked against the numpy
    source), then the HASH join: the oracle's rows and checksums, one
    kernel launch per side.  The ingest rate beside the host link's
    measured H2D rate."""
    import pyarrow as pa

    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.parallel import DTable, dist_join
    from cylon_tpu_torch.table import host_columns_from_arrow

    ctx = CylonContext(device=DEVICE, world=WORLD)
    at_l, at_r = pa.table(ldata), pa.table(rdata)
    DTable.from_arrow(ctx, pa.table({c: v[:4096] for c, v in ldata.items()}))
    nbytes = sum(v.nbytes for v in ldata.values()) + \
        sum(v.nbytes for v in rdata.values())
    (lt, rt), secs = wall(lambda: (DTable.from_arrow(ctx, at_l),
                                   DTable.from_arrow(ctx, at_r)))
    # where the ingest's host time goes: the Arrow decode alone
    _, decode_s = wall(lambda: (host_columns_from_arrow(at_l),
                                host_columns_from_arrow(at_r)))
    check_layout("join cell from_arrow left", lt, ldata)
    check_layout("join cell from_arrow right", rt, rdata)
    reset_launches()
    local, join_s = wall(lambda: dist_join(lt, rt, hash_cfg()).to_table())
    launches, chained = read_launches()
    check_join("join cell from_arrow", local, want)
    check(launches == 2 and chained == 0,
          f"join cell from_arrow: one kernel launch per side (got "
          f"{launches}, chained {chained})")
    gbps = nbytes / secs / 1e9
    say(f"ingest join cell from_arrow world={WORLD}",
        rows_per_side=len(ldata["k"]), bytes=nbytes,
        ingest_seconds=f"{secs:.6f}", decode_seconds=f"{decode_s:.6f}",
        ingest_gbps=f"{gbps:.3f}",
        host_link_h2d_gbps=f"{link['h2d_gbps']:.3f}",
        share_of_h2d=f"{gbps / link['h2d_gbps']:.3f}",
        join_seconds=f"{join_s:.6f}", rows_out=local.num_rows,
        oracle_rows=want["inner"], kernel_launches=launches)
    return launches, gbps


def np_oracle(kl, kr, vl, vr, krange: int):
    """``oracle``'s inner-join rows and checksums, in numpy on the host."""
    def per_key(k, v):
        cnt = np.bincount(k, minlength=krange)
        s64 = np.bincount(k, weights=v.astype(np.float64), minlength=krange)
        bits = np.zeros(krange, np.int64)
        np.add.at(bits, k, v.view(np.int32).astype(np.int64))
        return cnt.astype(np.int64), s64, bits

    cl, sl, bl = per_key(kl, vl)
    cr, sr, br = per_key(kr, vr)
    return {"inner": int((cl * cr).sum()),
            "sum_lt_v0": float((sl * cr).sum()),
            "sum_rt_v0": float((sr * cl).sum()),
            "bits_lt_v0": int((bl * cr).sum()),
            "bits_rt_v0": int((br * cl).sum())}


def phase_csv_partitions(seed: int):
    """Per-rank CSV → ``from_partitions`` (reference
    table_join_dist_test.cpp:87-91): each side written as 4 CSV files of
    1,048,576 rows (cut from the join cell's size to bound disk and time),
    read with ``read_csv_many`` (a thread per file), one partition per
    shard at world 4, then the HASH join = a numpy oracle; ``write_csv``
    of one partition reads back equal."""
    import shutil
    from pathlib import Path

    import pyarrow as pa
    import pyarrow.csv as pacsv

    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch import io as tio
    from cylon_tpu_torch.parallel import DTable, dist_join

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_csv"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        rng = np.random.default_rng(seed + 11)
        n = WORLD * CSV_RANK_ROWS
        krange = int(KEY_FRAC * n)
        sides, paths = {}, {}
        for side in ("l", "r"):
            data = {"k": rng.integers(0, krange, n, dtype=np.int32)}
            for j in range(3):
                data[f"v{j}"] = rng.random(n, dtype=np.float32)
            sides[side] = data
            paths[side] = []
            for r in range(WORLD):
                p = root / f"{side}_{r}.csv"
                sl = slice(r * CSV_RANK_ROWS, (r + 1) * CSV_RANK_ROWS)
                pacsv.write_csv(pa.table({c: v[sl] for c, v in data.items()}),
                                str(p))
                paths[side].append(str(p))
        file_bytes = sum(Path(p).stat().st_size
                         for ps in paths.values() for p in ps)
        opts = tio.CSVReadOptions().WithColumnTypes(
            {"k": pa.int32(), "v0": pa.float32(), "v1": pa.float32(),
             "v2": pa.float32()})
        ctx = CylonContext(device=DEVICE, world=WORLD)
        parts, read_s = wall(lambda: {
            s: tio.read_csv_many(ctx, paths[s], opts) for s in paths})
        (lt, rt), build_s = wall(lambda: (
            DTable.from_partitions(ctx, parts["l"]),
            DTable.from_partitions(ctx, parts["r"])))
        for side, dt in (("left", lt), ("right", rt)):
            check_layout(f"csv from_partitions {side}", dt,
                         sides[side[0]])
        want = np_oracle(sides["l"]["k"], sides["r"]["k"], sides["l"]["v0"],
                         sides["r"]["v0"], krange)
        reset_launches()
        local, join_s = wall(lambda: dist_join(lt, rt, hash_cfg()).to_table())
        launches, chained = read_launches()
        check_join("csv from_partitions", local, want)
        check(launches == 2, f"csv from_partitions join: one kernel launch "
              f"per side (got {launches})")
        out = root / "partition0.csv"
        tio.write_csv(lt.partition(0), str(out))
        back = tio.read_csv(ctx, str(out), opts).to_arrow()
        for c, v in sides["l"].items():
            check(back.column(c).to_numpy().tobytes()
                  == v[:CSV_RANK_ROWS].tobytes(),
                  f"write_csv of partition 0 round-trips column {c}")
        say(f"ingest csv from_partitions world={WORLD}", files=2 * WORLD,
            rows_per_file=CSV_RANK_ROWS, file_bytes=file_bytes,
            read_seconds=f"{read_s:.6f}",
            read_mb_per_sec=f"{file_bytes / read_s / 1e6:.3f}",
            from_partitions_seconds=f"{build_s:.6f}",
            join_seconds=f"{join_s:.6f}", rows_out=local.num_rows,
            oracle_rows=want["inner"], kernel_launches=launches)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_strkey():
    """The JAX bench's strkey stage at its size: 1,200,000 distinct keys,
    a 2,000,000-row left side drawn with ``default_rng(17)``, the
    1,200,000-row right side; the HASH join once through the dictionary
    encoding and once through the hash64 lanes ``(k#h0, k#h1)`` (ingest
    and join timed apart, the join's first call untimed): both row counts
    equal pandas' merge, and the hash64 result resolved back to strings
    equals the dictionary path's sorted ``(k, a, b)`` rows."""
    import pandas as pd

    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch import strings as tstr
    from cylon_tpu_torch.parallel import DTable, dist_join

    t0 = time.perf_counter()
    pool = np.array([f"user-{i:09x}-{(i * 2654435761) % 997:03d}"
                     for i in range(STRKEY_DISTINCT)], dtype=object)
    srng = np.random.default_rng(17)
    sldf = pd.DataFrame({"k": pool[srng.integers(0, STRKEY_DISTINCT,
                                                 STRKEY_ROWS)],
                         "a": srng.random(STRKEY_ROWS, dtype=np.float32)})
    srdf = pd.DataFrame({"k": pool,
                         "b": srng.random(STRKEY_DISTINCT, dtype=np.float32)})
    merge_rows = len(sldf.merge(srdf, on="k", how="inner"))
    data_s = time.perf_counter() - t0
    ctx = CylonContext(device=DEVICE, world=WORLD)
    res, launches = {}, {}

    def run(label, make, cfg):
        (lt, rt), ingest_s = wall(make)
        dist_join(lt, rt, cfg)   # first call: dictionary merge, CUDA libs
        reset_launches()
        out, join_s = wall(lambda: dist_join(lt, rt, cfg))
        launches[label] = read_launches()
        check(out.num_rows == merge_rows,
              f"strkey {label}: rows {out.num_rows} == pandas merge "
              f"{merge_rows}")
        res[label] = (out.to_table().to_pandas(), ingest_s, join_s)

    run("dict", lambda: (DTable.from_pandas(ctx, sldf),
                         DTable.from_pandas(ctx, srdf)), hash_cfg("k", "k"))
    store = tstr.StringStore()

    def make_hash64():
        lenc, _ = tstr.encode_frame(sldf, ["k"], store)
        renc, _ = tstr.encode_frame(srdf, ["k"], store)
        return DTable.from_pandas(ctx, lenc), DTable.from_pandas(ctx, renc)

    lanes = tstr.key_of("k")
    run("hash64", make_hash64, hash_cfg(lanes, lanes))
    check(launches["dict"] == (2, 0) and launches["hash64"] == (2, 0),
          f"strkey: one kernel launch per side on each path (got "
          f"{launches})")
    cols = ["lt-k", "lt-a", "rt-b"]
    d = res["dict"][0][cols].sort_values(cols).reset_index(drop=True)
    h = store.resolve_frame(res["hash64"][0])
    h = h[cols].sort_values(cols).reset_index(drop=True)
    check(d["lt-k"].astype(object).tolist() == h["lt-k"].tolist()
          and np.array_equal(d["lt-a"].to_numpy(), h["lt-a"].to_numpy())
          and np.array_equal(d["rt-b"].to_numpy(), h["rt-b"].to_numpy()),
          "strkey: the hash64 rows resolved to strings == the dictionary "
          "path's sorted (k, a, b) rows")
    say(f"strkey join world={WORLD}", distinct=STRKEY_DISTINCT,
        left_rows=STRKEY_ROWS, rows_out=merge_rows,
        data_seconds=f"{data_s:.3f}",
        strkey_ingest_dict_s=f"{res['dict'][1]:.6f}",
        strkey_join_dict_ms=f"{res['dict'][2] * 1e3:.3f}",
        strkey_ingest_hash64_s=f"{res['hash64'][1]:.6f}",
        strkey_join_hash64_ms=f"{res['hash64'][2] * 1e3:.3f}",
        kernel_launches_dict=launches["dict"][0],
        kernel_launches_hash64=launches["hash64"][0],
        key_columns_hash64=len(lanes))
    return {k: v[0] for k, v in launches.items()}, {
        "strkey_ingest_dict_s": res["dict"][1],
        "strkey_join_dict_ms": res["dict"][2] * 1e3,
        "strkey_ingest_hash64_s": res["hash64"][1],
        "strkey_join_hash64_ms": res["hash64"][2] * 1e3}


def phase_append(ldata, rdata, seed: int):
    """The join cell's right side grown in place by a 1,048,576-row delta
    (the same key range, ``seed + 1``): the same object, content epoch 1,
    ``delta_for(1)`` the delta, the HASH join = the oracle of the
    concatenated side; then the same append to a spilled copy (the pool
    keeps no entry for it, the result bit for bit the resident one's)."""
    import pyarrow as pa

    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.parallel import DTable, dist_join
    from cylon_tpu_torch.spill import pool as tpool

    n = len(rdata["k"])
    krange = int(KEY_FRAC * n)
    rng = np.random.default_rng(seed + 1)
    ddata = {"k": rng.integers(0, krange, APPEND_ROWS, dtype=np.int32)}
    for j in range(3):
        ddata[f"v{j}"] = rng.random(APPEND_ROWS, dtype=np.float32)
    ctx = CylonContext(device=DEVICE, world=WORLD)
    lt = DTable.from_arrow(ctx, pa.table(ldata))
    rt = DTable.from_arrow(ctx, pa.table(rdata))
    delta = DTable.from_arrow(ctx, pa.table(ddata))
    handle = rt
    _, append_s = wall(lambda: rt.append(delta))
    check(rt is handle and rt.content_epoch == 1
          and rt.delta_for(1) is delta and rt.delta_for(0) is None,
          "append: same object, content epoch 1, delta_for(1) is the delta")
    grown = {c: np.concatenate([rdata[c], ddata[c]]) for c in rdata}
    check_layout("append", rt, grown)
    t = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    want = oracle(t(ldata["k"]), t(grown["k"]), t(ldata["v0"]),
                  t(grown["v0"]), None, None, krange)
    reset_launches()
    local, join_s = wall(lambda: dist_join(lt, rt, hash_cfg()).to_table())
    launches, _ = read_launches()
    check_join("join after append", local, want)
    check(launches == 2, f"join after append: one launch per side (got "
          f"{launches})")
    del local
    spilled = DTable.from_arrow(ctx, pa.table(rdata))
    spilled.spill()
    sig = spilled._spill_sig
    check(sig in tpool.get_pool()._entries, "append: the copy is spilled")
    _, spilled_s = wall(lambda: spilled.append(DTable.from_arrow(
        ctx, pa.table(ddata))))
    check(not spilled.is_spilled and sig not in tpool.get_pool()._entries
          and spilled._spill_sig is None,
          "append to a spilled table: the pool keeps no entry for it")
    check(spilled.cap == rt.cap and list(spilled._counts_host)
          == list(rt._counts_host)
          and all(torch.equal(a.data, b.data)
                  for a, b in zip(spilled.columns, rt.columns)),
          "append to a spilled table == the resident append, bit for bit")
    say(f"append world={WORLD}", rows_before=n, delta_rows=APPEND_ROWS,
        rows_after=rt.num_rows, cap=rt.cap, epoch=rt.content_epoch,
        append_seconds=f"{append_s:.6f}",
        spilled_append_seconds=f"{spilled_s:.6f}",
        join_seconds=f"{join_s:.6f}", rows_out=want["inner"],
        kernel_launches=launches)
    tpool.clear_pool()
    return launches, append_s


def wide_columns(n: int, width: int, seed: int):
    """``width`` key columns on the card cycling int32 / float32 / int64,
    every other one nullable (10% nulls)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = torch.device(DEVICE)
    cols, vals = [], []
    for j in range(width):
        if j % 3 == 0:
            x = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                              device=dev, dtype=torch.int64).to(torch.int32)
        elif j % 3 == 1:
            x = torch.randn(n, generator=g, device=dev)
        else:
            x = torch.randint(-2**62, 2**62, (n,), generator=g, device=dev,
                              dtype=torch.int64)
        cols.append(x)
        vals.append(torch.rand(n, generator=g, device=dev) < 0.9
                    if j % 2 else None)
    return cols, vals


def phase_wide_kernel(rows: int, seed: int):
    """The chained kernel at 17, 24 and 40 key columns (int32 / float32 /
    int64, every other one with nulls) against its plain version, bit
    for bit at 3, 4 and 16 parts; its time at 4 parts beside its bound
    n·(Σ column bytes + validity bytes + 4) at the card's memory rate."""
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.ops import hash_cuda

    cols, vals = wide_columns(rows, max(WIDE_WIDTHS), seed + 40)
    out = {}
    for w in WIDE_WIDTHS:
        c, v = cols[:w], vals[:w]
        err = 0
        for nparts in (3, 4, 16):
            reset_launches()
            got = hash_cuda.partition_ids_fused(c, v, nparts)
            launches, chained = read_launches()
            want = plain_hash.partition_ids(plain_hash.row_hash(c, v), nparts)
            torch.cuda.synchronize()
            err = max(err, int((got.long() - want.long()).abs().max()))
            groups = -(-w // hash_cuda.MAX_KEY_COLS)
            check(err == 0 and launches == chained == groups,
                  f"chained kernel == plain at {w} columns nparts={nparts} "
                  f"({launches} launches, {groups} groups)")
            del got, want
        ms = cuda_ms(lambda: hash_cuda.partition_ids_fused(c, v, 4), 10)
        p_ms = cuda_ms(lambda: plain_hash.partition_ids(
            plain_hash.row_hash(c, v), 4), 2, warmup=1)
        b_ms = hash_bound_ms(c, v, rows)
        out[w] = {"rows": rows, "groups": groups, "max_abs_err": err,
                  "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms}
        say("chained kernel", columns=w, rows=rows, launches=groups,
            exact="yes", ms=f"{ms:.4f}", plain_ms=f"{p_ms:.3f}",
            bound_ms=f"{b_ms:.4f}", share_of_bound=f"{b_ms / ms:.3f}")
    del cols, vals
    return out


def wide_ids(n: int, seed: int):
    """Row ids of the two wide set-op tables of ``n`` rows each: A holds
    distinct ids and 5% repeats of them, B half of its rows from A's ids
    and half fresh ones.  ``i * odd mod 2^40`` keeps the ids distinct."""
    rng = np.random.default_rng(seed)
    rep, half = n // 20, n // 2
    base = (np.arange(2 * n, dtype=np.int64) * 0x9E3779B1) % (1 << 40)
    base = base[rng.permutation(len(base))]
    a_ids = np.concatenate([base[:n - rep], rng.choice(base[:n - rep], rep)])
    b_ids = np.concatenate([base[:half], base[n:n + n - half]])
    return rng.permutation(a_ids), rng.permutation(b_ids)


def wide_table(ids: np.ndarray, width: int):
    """``width`` columns as functions of the row id (``c2`` is the id
    itself, so distinct rows = distinct ids); every third column null
    where ``id·(j+1) % 11 == 0``."""
    import pyarrow as pa

    cols = {}
    for j in range(width):
        if j == 2:
            arr, mask = ids, None
        elif j % 3 == 0:
            arr = ((ids * (2 * j + 1)) % (1 << 31)).astype(np.int32)
            mask = (ids * (j + 1)) % 11 == 0
        elif j % 3 == 1:
            arr = ((ids * (j + 7)) % 10007).astype(np.float32) / 7
            mask = None
        else:
            arr, mask = (ids * (j + 3)) % (1 << 50), None
        cols[f"c{j}"] = pa.array(arr, mask=mask)
    return pa.table(cols)


def phase_wide_set_ops(seed: int):
    """``dist_union`` / ``dist_intersect`` / ``dist_subtract`` at world 4
    on two 24-column tables of 4,194,304 rows with half their rows shared
    (ingested with ``from_arrow``): each equal to a numpy distinct-row
    oracle (the sorted id column, the nulls of every nullable column),
    every shard holding only rows whose plain hash picks it, 2 chained
    launches per side."""
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.parallel import (DTable, dist_intersect,
                                          dist_subtract, dist_union)

    a_ids, b_ids = wide_ids(WIDE_SETOP_ROWS, seed + 41)
    ua, ub = np.unique(a_ids), np.unique(b_ids)
    want = {"union": np.union1d(ua, ub),
            "intersect": np.intersect1d(ua, ub, assume_unique=True),
            "subtract": np.setdiff1d(ua, ub, assume_unique=True)}
    ctx = CylonContext(device=DEVICE, world=WORLD)
    a = DTable.from_arrow(ctx, wide_table(a_ids, WIDE_SETOP_WIDTH))
    b = DTable.from_arrow(ctx, wide_table(b_ids, WIDE_SETOP_WIDTH))
    launches = {}
    for name, op in (("union", dist_union), ("intersect", dist_intersect),
                     ("subtract", dist_subtract)):
        reset_launches()
        out, secs = wall(lambda: op(a, b))
        launches[name] = read_launches()
        counts = out.counts_host()
        ids = []
        for s in range(WORLD):
            cols = tuple(c.data.view(WORLD, out.cap)[s, :int(counts[s])]
                         for c in out.columns)
            vs = tuple(None if c.validity is None else
                       c.validity.view(WORLD, out.cap)[s, :int(counts[s])]
                       for c in out.columns)
            pid = plain_hash.partition_ids(plain_hash.row_hash(cols, vs),
                                           WORLD)
            check(bool((pid == s).all()),
                  f"wide dist_{name}: shard {s} holds only its rows")
            sid = cols[2].cpu().numpy()  # graftlint: ok[implicit-host-sync]
            for j in range(0, WIDE_SETOP_WIDTH, 3):
                check(np.array_equal(vs[j].cpu().numpy(),  # graftlint: ok[implicit-host-sync]
                                     (sid * (j + 1)) % 11 != 0),
                      f"wide dist_{name}: nulls of c{j} on shard {s}")
            ids.append(sid)
        got = np.sort(np.concatenate(ids))
        check(np.array_equal(got, want[name]),
              f"wide dist_{name}: the rows == the distinct-row oracle "
              f"({len(got)} vs {len(want[name])})")
        check(launches[name] == (4, 4),
              f"wide dist_{name}: 2 chained launches per side (got "
              f"{launches[name]})")
        say(f"wide dist_{name} world={WORLD}", columns=WIDE_SETOP_WIDTH,
            rows_a=len(a_ids), rows_b=len(b_ids),
            rows_out=len(got), oracle_rows=len(want[name]),
            seconds=f"{secs:.6f}", kernel_launches=launches[name][0],
            chained_launches=launches[name][1],
            shard_rows=list(map(int, counts)))
        del out
    return {k: v[0] for k, v in launches.items()}


# ---------------------------------------------------------------------------
# the serving layer: the JAX bench's serve stage and mixed read/write stage,
# and a fleet of two replicas on one card
# ---------------------------------------------------------------------------

SERVE_MIX = ("q1", "q6", "q3", "q12", "q14", "q19", "q5", "q10")
SERVE_REPS = 2                # submissions per client
SERVE_WINDOW_MS = 8.0         # the bench's batch window
MIXED_ROWS = 1 << 24          # the mixed stage's base fact table
MIXED_KEYS = 64               # k uniform in [0, 64)
MIXED_SECONDS = 10.0
MIXED_READERS = 8
MIXED_DELTA_ROWS = 128        # rows of one appended batch
MIXED_WRITE_PERIOD_S = 0.05
MIXED_REL_TOL = 1e-9          # of a group's sum of |v|
FLEET_WORLD = 2               # shards of each replica


def frame_cols(df):
    """A served pandas frame's columns on the host, comparable with
    ``_cols`` of a Table (strings and booleans as objects)."""
    import pandas as pd
    return {c: (df[c].to_numpy() if pd.api.types.is_numeric_dtype(df[c])
                and not pd.api.types.is_bool_dtype(df[c])
                else df[c].astype(object).to_numpy()) for c in df.columns}


def window_priced_bytes(handles) -> int:
    """The largest admission price one batch window admitted (the handles
    admitted together share one ``admitted_at`` stamp)."""
    by = {}
    for h in handles:
        by[h.admitted_at] = by.get(h.admitted_at, 0) + (h.priced_bytes or 0)
    return max(by.values(), default=0)


def scrape(port: int) -> str:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        return resp.read().decode("utf-8")


def phase_serve_tpch(ctx, tables, results, sf: float):
    """The JAX bench's serve stage on the SF-10 tables at world 4: one
    client thread per query of ``SERVE_MIX``, ``SERVE_REPS`` submissions
    each into 8 ms batch windows, every result exported with
    ``to_pandas()`` on the async lane; once with the view store on and
    once with it off.  Every served frame equals the eager result of its
    query; the OpenMetrics endpoint (started by the session from
    ``config.metrics_port`` 0, an ephemeral loopback port) is scraped
    once during the stage and carries the ``serve_`` families.  Returns
    the partition-kernel launches of each run."""
    import threading

    from cylon_tpu_torch import config, trace
    from cylon_tpu_torch.observe import exporter
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.serve import ServeSession, price_query
    from cylon_tpu_torch.tpch import QUERIES

    prev_port = config.set_metrics_port(0)
    launches = {}
    try:
        for views in (True, False):
            label = "views_on" if views else "views_off"
            broadcast.clear_replica_cache()
            trace.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            handles, hlock = [], threading.Lock()
            with ServeSession(ctx, tables=tables,
                              batch_window_ms=SERVE_WINDOW_MS,
                              views=views) as srv:
                port = exporter.port()
                check(port is not None,
                      "serve: the session started the metrics endpoint")

                def client(q):
                    qfn = QUERIES[q]
                    for _ in range(SERVE_REPS):
                        h = srv.submit(lambda t, qfn=qfn: qfn(ctx, t),
                                       label=q,
                                       export=lambda r: r.to_pandas())
                        with hlock:
                            handles.append(h)

                t0 = time.perf_counter()
                threads = [threading.Thread(target=client, args=(q,))
                           for q in SERVE_MIX]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                body = scrape(port)
                frames = [(h.label, h.result(timeout=600)) for h in handles]
                wall_s = time.perf_counter() - t0
                st = srv.stats()
                budget = srv._budget()
            n_launch = read_launches()[0]
            launches[label] = n_launch
            peak = torch.cuda.max_memory_allocated()
            check(st["completed"] == len(SERVE_MIX) * SERVE_REPS
                  and st["failed"] == 0,
                  f"serve {label}: every query completed")
            orders = {}
            for q, df in frames:
                orders[q] = same_columns(
                    q, frame_cols(df), _cols(results[q]), len(df),
                    results[q].num_rows, f"serve {label}: served and eager")
            check("cylon_serve_batch_window_ms " in body
                  and "cylon_serve_queue_depth " in body,
                  f"serve {label}: the scrape carries the serve_ families")
            if not views:
                check(n_launch > 0, "serve views_off: the partition kernel "
                      "ran on the served path")
            priced = window_priced_bytes(handles)
            say(f"serve tpch sf={sf} world={WORLD} {label}",
                queries=len(handles), clients=len(SERVE_MIX),
                seconds=f"{wall_s:.6f}", qps=f"{len(handles) / wall_s:.3f}",
                p50_ms=f"{st['p50_ms']:.3f}", p99_ms=f"{st['p99_ms']:.3f}",
                subplan_shared=st["subplan_shared"],
                deferred=st["deferred"], batches=st["batches"],
                view_hits=st["view_hits"], view_folds=st["view_folds"],
                slo_violations=st["slo_violations"],
                window_priced_bytes=priced,
                query_price_max=max(price_query({n: t}) for n, t in
                                    tables.items()),
                admission_budget_per_shard=budget,
                max_memory_allocated=peak,
                peak_over_priced=f"{peak / max(priced, 1):.3f}",
                kernel_launches=n_launch,
                equal_to_eager=len(frames),
                unordered=sum(v != "ordered" for v in orders.values()),
                scrape_bytes=len(body))
    finally:
        exporter.stop()
        config.set_metrics_port(prev_port)
    return launches


def mixed_read(t):
    """The mixed stage's read: ``shuffle_table`` by ``k``, then sum and
    count of ``v`` per key (foldable: the view folds appends)."""
    from cylon_tpu_torch.parallel import dist_groupby, shuffle_table
    return dist_groupby(shuffle_table(t["fact"], ["k"]), ["k"],
                        [("v", "sum"), ("v", "count")])


def check_mixed(label: str, table, ks, vs) -> None:
    """A mixed-stage read against numpy over the base and every delta:
    keys and counts exact, each sum within ``MIXED_REL_TOL`` of its
    group's sum of |v|."""
    cols = _cols(table)
    order = np.argsort(cols["k"])
    k = cols["k"][order]
    want_n = np.zeros(MIXED_KEYS, np.int64)
    want_s = np.zeros(MIXED_KEYS)
    want_a = np.zeros(MIXED_KEYS)
    for kk, vv in zip(ks, vs):
        want_n += np.bincount(kk, minlength=MIXED_KEYS)
        want_s += np.bincount(kk, weights=vv, minlength=MIXED_KEYS)
        want_a += np.bincount(kk, weights=np.abs(vv), minlength=MIXED_KEYS)
    keys = np.nonzero(want_n)[0]
    check(np.array_equal(k, keys), f"{label}: the keys")
    check(np.array_equal(cols["count_v"][order], want_n[keys]),
          f"{label}: the counts, exactly")
    err = np.abs(cols["sum_v"][order] - want_s[keys])
    check(bool(np.all(err <= MIXED_REL_TOL * want_a[keys])),
          f"{label}: the sums within {MIXED_REL_TOL} of the sum of |v| "
          f"(max err {float(err.max()):.3e})")


def phase_serve_mixed(seed: int):
    """The JAX bench's mixed read/write stage at a real size: a base fact
    of ``MIXED_ROWS`` rows (``k`` int64 in [0, 64), ``v`` float64) at
    world 4; one writer appends ``MIXED_DELTA_ROWS``-row deltas every
    50 ms through ``session.ingest`` while ``MIXED_READERS`` readers
    repeat ``mixed_read`` (exported to the host) for ``MIXED_SECONDS``.
    After the writer stops, one more append and one more read, equal to
    the numpy oracle of base + every delta; then one more append, its
    fold's latency against a recompute's through a session with the
    views off (both equal the oracle).  Returns the partition-kernel launches of the stage."""
    import threading

    import pandas as pd

    from cylon_tpu_torch import CylonContext, trace
    from cylon_tpu_torch.parallel import DTable
    from cylon_tpu_torch.serve import ServeSession, percentile

    rng = np.random.default_rng(seed + 11)
    ks = [rng.integers(0, MIXED_KEYS, MIXED_ROWS, dtype=np.int64)]
    vs = [rng.standard_normal(MIXED_ROWS)]
    ctx = CylonContext(device=DEVICE, world=WORLD)
    fact, ingest_s = wall(lambda: DTable.from_pandas(
        ctx, pd.DataFrame({"k": ks[0], "v": vs[0]})))
    wrng = np.random.default_rng(seed + 12)

    def delta():
        k = wrng.integers(0, MIXED_KEYS, MIXED_DELTA_ROWS, dtype=np.int64)
        v = wrng.standard_normal(MIXED_DELTA_ROWS)
        ks.append(k)
        vs.append(v)
        return DTable.from_pandas(ctx, pd.DataFrame({"k": k, "v": v}))

    def export(r):
        return r.to_table()

    trace.reset()
    reset_launches()
    lat, views, stale, errors = [], [], [], []
    mlock = threading.Lock()
    with ServeSession(ctx, tables={"fact": fact},
                      batch_window_ms=4.0) as srv:
        stop_at = time.monotonic() + MIXED_SECONDS

        def reader(i):
            while time.monotonic() < stop_at:
                try:
                    h = srv.submit(mixed_read, label=f"mixed-r{i}",
                                   export=export)
                    h.result(timeout=600)
                except Exception as e:  # graftlint: ok[broad-except] — reported and checked below
                    with mlock:
                        errors.append(f"reader {i}: {type(e).__name__}: {e}")
                    return
                with mlock:
                    lat.append(h.latency_ms)
                    views.append(h.view)

        def writer():
            while time.monotonic() < stop_at:
                try:
                    h = srv.ingest("fact", delta())
                    h.result(timeout=600)
                except Exception as e:  # graftlint: ok[broad-except] — reported and checked below
                    with mlock:
                        errors.append(f"writer: {type(e).__name__}: {e}")
                    return
                with mlock:
                    stale.append(h.latency_ms)
                time.sleep(MIXED_WRITE_PERIOD_S)

        t0 = time.perf_counter()
        threads = ([threading.Thread(target=reader, args=(i,))
                    for i in range(MIXED_READERS)]
                   + [threading.Thread(target=writer)])
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall_s = time.perf_counter() - t0
        check(not errors, f"mixed: no client error ({errors[:2]})")
        # one more append first: the final read, alone in its window,
        # folds it or (after an invalidation) recomputes and retains a
        # foldable view, so the next append must fold
        srv.ingest("fact", delta()).result(timeout=600)
        final = srv.submit(mixed_read, label="mixed-final", export=export)
        check_mixed("mixed final read", final.result(timeout=600), ks, vs)
        st = srv.stats()
        srv.ingest("fact", delta()).result(timeout=600)
        fold = srv.submit(mixed_read, label="mixed-fold", export=export)
        check_mixed("mixed fold", fold.result(timeout=600), ks, vs)
    n_launch = read_launches()[0]
    with ServeSession(ctx, tables={"fact": fact}, batch_window_ms=0.0,
                      views=False) as cold:
        rec = cold.submit(mixed_read, label="mixed-recompute", export=export)
        check_mixed("mixed recompute", rec.result(timeout=600), ks, vs)
    check(fold.view == "fold", f"mixed: the read after an append folds "
          f"(got {fold.view})")
    served = sum(v in ("hit", "fold") for v in views)
    ratio = served / max(len(views), 1)
    check(ratio > 0, "mixed: reads served by a view hit or fold")
    check(n_launch > 0, "mixed: the partition kernel ran on the stage")
    lat_sorted, stale_sorted = sorted(lat), sorted(stale)
    say(f"serve mixed world={WORLD}", rows=MIXED_ROWS,
        ingest_seconds=f"{ingest_s:.6f}", seconds=f"{wall_s:.6f}",
        readers=MIXED_READERS, reads=len(lat), appends=len(stale),
        qps=f"{len(lat) / wall_s:.3f}", hit_fold_ratio=f"{ratio:.3f}",
        view_hits=st["view_hits"], view_folds=st["view_folds"],
        view_invalidations=st["view_invalidations"],
        p99_ms=f"{percentile(lat_sorted, 99):.3f}",
        staleness_p95_ms=f"{percentile(stale_sorted, 95):.3f}",
        fold_latency_ms=f"{fold.latency_ms:.3f}",
        fold_execute_ms=f"{fold.execute_ms:.3f}",
        recompute_latency_ms=f"{rec.latency_ms:.3f}",
        recompute_execute_ms=f"{rec.execute_ms:.3f}",
        kernel_launches=n_launch)
    return n_launch


def fleet_read(t):
    """The fleet's query: sum and count of ``v0`` per join-cell key."""
    from cylon_tpu_torch.parallel import dist_groupby
    return dist_groupby(t["side"], ["k"], [("v0", "sum"), ("v0", "count")])


def check_fleet(label: str, table, k, v) -> None:
    """A fleet result against numpy: keys and counts exact, float32 sums
    within ``F32_RTOL`` of the float64 sums."""
    cols = _cols(table)
    order = np.argsort(cols["k"])
    n = np.bincount(k)
    keys = np.nonzero(n)[0]
    check(np.array_equal(cols["k"][order], keys)
          and np.array_equal(cols["count_v0"][order], n[keys]),
          f"{label}: the keys and counts")
    want = np.bincount(k, weights=v.astype(np.float64))[keys]
    check(_close(cols["sum_v0"][order], want, F32_RTOL),
          f"{label}: the sums")


def phase_serve_fleet(ldata):
    """Two replicas on one card, each a session at world 2 over a disjoint
    slot range (``CylonContext(first_slot=...)``) holding the join cell's
    left side: the same groupby submitted twice through a
    ``FleetRouter`` (the second routed by affinity to the first's
    replica), then that replica drained and the query failing over to
    the other; every result equals numpy.  Returns the partition-kernel
    launches."""
    from cylon_tpu_torch import CylonContext, topology, trace
    from cylon_tpu_torch.parallel import DTable
    from cylon_tpu_torch.serve import FleetRouter, ServeSession

    ctxs = [CylonContext(device=DEVICE, world=FLEET_WORLD, first_slot=s)
            for s in (0, FLEET_WORLD)]
    check(not set(topology.slots(ctxs[0])) & set(topology.slots(ctxs[1])),
          "fleet: the replicas' slot ranges are disjoint")
    sessions = [ServeSession(c, tables={"side": DTable.from_table(
        c, to_table(c, ldata, None))}, batch_window_ms=0.0, name=n)
        for c, n in zip(ctxs, ("rep-a", "rep-b"))]
    trace.reset()
    reset_launches()
    placed, secs, views = [], [], []
    try:
        router = FleetRouter(sessions)
        for label in ("first", "affinity"):
            h = router.submit(fleet_read, label=label,
                              export=lambda r: r.to_table())
            check_fleet(f"fleet {label}", h.result(timeout=600),
                        ldata["k"], ldata["v0"])
            secs.append(h.latency_ms / 1e3)
            views.append(h.view)
            placed.append(router.replica_of(fleet_read))
        drained = router.drain(placed[0])
        h = router.submit(fleet_read, label="failover",
                          export=lambda r: r.to_table())
        check_fleet("fleet failover", h.result(timeout=600),
                    ldata["k"], ldata["v0"])
        secs.append(h.latency_ms / 1e3)
        views.append(h.view)
        placed.append(router.replica_of(fleet_read))
        c = trace.counters()
    finally:
        for s in sessions:
            s.close()
    n_launch = read_launches()[0]
    check(placed[0] == placed[1] and placed[2] != placed[0],
          f"fleet: affinity, then failover after the drain ({placed})")
    check(c.get("serve.router_affinity_hits", 0) >= 1
          and c.get("serve.router_failovers", 0) == 1
          and c.get("serve.router_routed", 0) == 3,
          "fleet: the router's counters")
    check(drained["completed"] >= 2 and drained["failed"] == 0,
          "fleet: the drained replica finished its work")
    check(n_launch > 0, "fleet: the partition kernel ran")
    say(f"serve fleet replicas=2 world={FLEET_WORLD}",
        rows=len(ldata["k"]), placements=",".join(placed),
        latency_seconds=",".join(f"{x:.6f}" for x in secs),
        views=",".join(str(v) for v in views),
        affinity_hits=c.get("serve.router_affinity_hits", 0),
        failovers=c.get("serve.router_failovers", 0),
        kernel_launches=n_launch, shared_card="yes")
    return n_launch


# ---------------------------------------------------------------------------
# the abstract plan check and the deferred pipeline (the bench's TPC-H form)
# ---------------------------------------------------------------------------

PIPELINE_UNDERSIZE_QUERIES = ("q5", "q21")  # the exchange-heavy ones
PIPELINE_UNDERSIZE_LIMIT = 4  # hints quartered per run (compact.hint)
PIPELINE_WARMUPS = 3  # pipeline warm-ups at most before the timed run


def runtime_state():
    """What a plan check must leave as it found it: the size hints, the
    degraded shuffle signatures and the replica cache (entries by key and
    identity; the plan cache may record plans, it holds no data)."""
    from cylon_tpu_torch.parallel import broadcast, dist_ops, shuffle
    return (dict(dist_ops._capacity_hints), dict(dist_ops._group_cap_hints),
            dict(dist_ops._select_cap_hints), dict(shuffle._block_hints),
            set(shuffle._chunked_keys),
            {k: id(v) for k, v in broadcast._replica_cache.items()})


def phase_plan_check(ctx, tables, sf: float):
    """(a) ``plan_check.validate(q, tables, concrete=("nation",
    "region"))`` of every query in its eager form and its planned form
    (``plan.run``), as the JAX bench pre-flights each query: the
    abstract run launches no kernel, makes no host read, allocates
    nothing on the card (``max_memory_allocated`` after a reset stays at
    the allocated bytes) and leaves the hints and the replica cache as
    they were.  One line each: nodes, seconds, the result schema.
    Returns the total plan-check seconds per form."""
    from cylon_tpu_torch import plan as planner
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.analysis import plan_check
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.tpch import QUERIES

    total = {"eager": 0.0, "planned": 0.0}
    for q in QUERIES:
        forms = {
            "eager": lambda t, q=q: QUERIES[q](ctx, t),
            "planned": lambda t, q=q: planner.run(
                ctx, lambda tt: QUERIES[q](ctx, tt), t)}
        for form, qform in forms.items():
            label = f"plan check {q} {form} sf={sf} world={WORLD}"
            before = runtime_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            hash_cuda.launches = 0
            trace.reset()
            t0 = time.perf_counter()
            rep = plan_check.validate(qform, tables,
                                      concrete=("nation", "region"))
            secs = time.perf_counter() - t0
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            reads = trace.counters().get("host.read", 0)
            total[form] += secs
            check(rep.ok and len(rep.nodes) > 0, f"{label}: VALID ({rep})")
            check(hash_cuda.launches == 0,
                  f"{label}: no kernel launch ({hash_cuda.launches})")
            check(reads == 0, f"{label}: no host read ({reads})")
            check(peak == base, f"{label}: nothing allocated on the card "
                  f"(peak {peak} B, allocated {base} B)")
            check(runtime_state() == before,
                  f"{label}: the hints and the replica cache unchanged")
            say(label, nodes=len(rep.nodes), seconds=f"{secs:.6f}",
                boundary=rep.boundary or "none", host_reads=reads,
                kernel_launches=hash_cuda.launches,
                card_bytes_allocated=peak - base,
                result=repr(rep.result))
    say(f"plan check sf={sf} world={WORLD}", queries=len(QUERIES),
        eager_seconds=f"{total['eager']:.6f}",
        planned_seconds=f"{total['planned']:.6f}")
    return total


def undersized_hints(fn, seen: list):
    """``fn()``, appending to ``seen`` every size hint that a count found
    too small (``key[:3]:hint->need``, the key's first fields naming the
    operator signature): what a replay or a redo was for."""
    from cylon_tpu_torch.ops import compact
    orig = compact.update_size_hint

    def spy(hints, key, need, shrink_after=3):
        cur = compact.hint_value(hints, key)
        if cur is not None and any(n > h for n, h in zip(need, cur)):
            seen.append(f"{key[:3]}:{cur}->{tuple(need)}".replace(" ", ""))
        orig(hints, key, need, shrink_after)

    compact.update_size_hint = spy
    try:
        return fn()
    finally:
        compact.update_size_hint = orig


def pipeline_run(fn):
    """(result, seconds, counters, kernel launches) of ``fn()`` with the
    counters and the launch count reset first."""
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.ops import hash_cuda
    trace.reset()
    hash_cuda.launches = 0
    out, secs = wall(fn)
    return out, secs, trace.counters(), hash_cuda.launches


def phase_tpch_pipeline(ctx, tables, sf: float, eager):
    """(b) Every query under ``run_pipeline`` as the JAX bench times it
    (warm-ups, at most ``PIPELINE_WARMUPS``, until one needs no replay,
    then the timed run), beside an eager run on warm hints: the result
    equals the eager result of the TPC-H phase, in order; one line each
    with seconds, ``host.read``, ``pipeline.replays`` and kernel launches
    of both (and, where the timed run still replayed, the hints that
    were found too small).  (c) Q5 and Q21 under a ``compact.hint`` rule
    that quarters the first hints (``faults.undersize_hint``): the region
    replays, results unchanged.  Returns the pipeline's kernel launches
    per query."""
    from cylon_tpu_torch import faults
    from cylon_tpu_torch.parallel import broadcast, run_pipeline
    from cylon_tpu_torch.tpch import QUERIES

    launches, fewer, multi = {}, [], []
    tot = {"eager_s": 0.0, "pipe_s": 0.0, "eager_reads": 0, "pipe_reads": 0}
    for q in QUERIES:
        run = lambda q=q: QUERIES[q](ctx, tables)  # noqa: E731
        label = f"tpch pipeline {q} sf={sf} world={WORLD}"
        broadcast.clear_replica_cache()
        e_out, e_s, e_c, e_n = pipeline_run(run)
        # warm-up until an attempt needs no replay: the hints also hold
        # what the planned forms of earlier phases observed under the
        # same signatures, and the first runs here may grow or shrink them
        warm = []
        for _ in range(PIPELINE_WARMUPS):
            warm.append(pipeline_run(lambda: run_pipeline(run))[2].get(
                "pipeline.replays", 0))
            if warm[-1] == 0:
                break
        causes = []
        p_out, p_s, p_c, p_n = pipeline_run(
            lambda: undersized_hints(lambda: run_pipeline(run), causes))
        same_ordered(f"{label} eager", e_out, eager[q])
        same_ordered(label, p_out, eager[q])
        e_r, p_r = e_c.get("host.read", 0), p_c.get("host.read", 0)
        replays = p_c.get("pipeline.replays", 0)
        check(p_r <= e_r * (1 + replays),
              f"{label}: host reads {p_r} <= eager {e_r} per attempt")
        if e_r > 2 and not replays:  # >1 optimistic site, no replay
            multi.append(q)
            check(p_r < e_r, f"{label}: fewer host reads ({p_r} vs {e_r})")
        if p_r < e_r:
            fewer.append(q)
        launches[q] = p_n
        tot["eager_s"] += e_s
        tot["pipe_s"] += p_s
        tot["eager_reads"] += e_r
        tot["pipe_reads"] += p_r
        say(label, seconds=f"{p_s:.6f}", eager_seconds=f"{e_s:.6f}",
            host_reads=p_r, eager_host_reads=e_r, replays=replays,
            warmup_replays=",".join(map(str, warm)),
            kernel_launches=p_n, eager_kernel_launches=e_n,
            **({"undersized": repr(";".join(causes))} if causes else {}))
    say(f"tpch pipeline sf={sf} world={WORLD}", queries=len(QUERIES),
        total_seconds=f"{tot['pipe_s']:.6f}",
        total_eager_seconds=f"{tot['eager_s']:.6f}",
        host_reads=tot["pipe_reads"], eager_host_reads=tot["eager_reads"],
        fewer_reads=len(fewer), multi_site=len(multi),
        kernel_launches=sum(launches.values()))
    # (c) forced undersize
    for q in PIPELINE_UNDERSIZE_QUERIES:
        run = lambda q=q: QUERIES[q](ctx, tables)  # noqa: E731
        label = f"tpch pipeline undersized {q} sf={sf} world={WORLD}"
        plan = faults.FaultPlan(0, [faults.FaultRule(
            "compact.hint", kind="value", probability=1.0,
            mutate=faults.undersize_hint, limit=PIPELINE_UNDERSIZE_LIMIT)])
        with faults.active(plan):
            out, secs, c, n = pipeline_run(lambda: run_pipeline(run))
        same_ordered(label, out, eager[q])
        check(plan.injected >= 1 and c.get("pipeline.replays", 0) >= 1,
              f"{label}: an undersized hint replayed ({plan.injected} "
              f"injected, {c.get('pipeline.replays', 0)} replays)")
        launches[f"{q}_undersized"] = n
        say(label, seconds=f"{secs:.6f}", hints_quartered=plan.injected,
            replays=c.get("pipeline.replays", 0),
            fallback_plain=c.get("pipeline.fallback_plain", 0),
            host_reads=c.get("host.read", 0), kernel_launches=n)
    return launches


def phase_join_pipeline(ldata, rdata, want):
    """(d) The join cell's world-4 HASH join under ``run_pipeline``
    against eager (seconds, ``host.read``, 2 launches, = the oracle);
    then with the per-shard budget one byte under the hinted single-shot
    exchange's price: the flush finds the correctly sized exchange over
    budget and invalidates, the replay takes the degraded lowering, and
    the join still equals the oracle.  Returns the launches."""
    from cylon_tpu_torch import config
    from cylon_tpu_torch.observe import row_bytes
    from cylon_tpu_torch.parallel import (cost, dist_ops, run_pipeline,
                                          shuffle)

    lt, rt = join_sides(ldata, rdata)
    n = len(ldata["k"])
    label = f"join pipeline rows={n} world={WORLD}"
    hash_join(lt, rt)  # seeds the hints
    local, e_s, e_c, e_n = pipeline_run(lambda: hash_join(lt, rt))
    check_join(f"{label} eager", local, want)
    run_pipeline(lambda: hash_join(lt, rt))
    local, p_s, p_c, p_n = pipeline_run(
        lambda: run_pipeline(lambda: hash_join(lt, rt)))
    check_join(label, local, want)
    check(p_n == 2, f"{label}: 2 kernel launches (got {p_n})")
    check(p_c.get("host.read", 0) < e_c.get("host.read", 0),
          f"{label}: fewer host reads than eager")
    say(label, seconds=f"{p_s:.6f}", eager_seconds=f"{e_s:.6f}",
        host_reads=p_c.get("host.read", 0),
        eager_host_reads=e_c.get("host.read", 0),
        replays=p_c.get("pipeline.replays", 0), kernel_launches=p_n,
        eager_kernel_launches=e_n)
    del local
    # over budget inside the flush: the hints are warm and single-shot
    pid = dist_ops._hash_pids(lt, [0])
    counts = shuffle._counts(lt.ctx.comm, pid).cpu().numpy().astype(np.int64)  # graftlint: ok[implicit-host-sync]
    del pid
    leaves = [lf for c in lt.columns for lf in (c.data, c.validity)
              if lf is not None]
    ss = cost.price_single_shot(WORLD, *cost.exchange_sizes(counts)[:2],
                                row_bytes(leaves)).peak_bytes
    label = f"join pipeline over budget={ss - 1} rows={n} world={WORLD}"
    prev = config.set_device_memory_budget(ss - 1)
    try:
        shuffle.clear_chunk_state()
        local, o_s, o_c, o_n = pipeline_run(
            lambda: run_pipeline(lambda: hash_join(lt, rt)))
        degraded = sorted(shuffle._chunked_keys)
    finally:
        config.set_device_memory_budget(prev)
        shuffle.clear_chunk_state()
    check_join(label, local, want)
    check(o_c.get("pipeline.replays", 0) >= 1,
          f"{label}: the flush invalidated and the region replayed")
    check(o_c.get("shuffle.strategy.downgrades", 0) >= 1 and degraded,
          f"{label}: the replay took the degraded lowering")
    check(o_n == 2 * (1 + o_c.get("pipeline.replays", 0)),
          f"{label}: 2 kernel launches per attempt (got {o_n})")
    say(label, seconds=f"{o_s:.6f}", replays=o_c["pipeline.replays"],
        downgrades=o_c["shuffle.strategy.downgrades"],
        strategies=",".join(f"{k.split('.')[-1]}:{v}" for k, v in
                            sorted(o_c.items())
                            if k.startswith("shuffle.strategy.")),
        host_reads=o_c.get("host.read", 0), kernel_launches=o_n)
    return {"join": p_n, "join_over_budget": o_n}


def phase_explain_report(ctx, tables):
    """(e) One static ``DTable.explain(plan)`` report (Q5, eager form)."""
    from cylon_tpu_torch.tpch import QUERIES
    rep = tables["lineitem"].explain(lambda t: QUERIES["q5"](ctx, t),
                                     tables=tables,
                                     concrete=("nation", "region"))
    check(rep.ok and not rep.analyzed, "explain(q5): a VALID static report")
    say("explain q5", nodes=len(rep.nodes))
    print(str(rep), flush=True)


# ---------------------------------------------------------------------------
# phase: the measured cost model — the mesh probe, the measured ranking,
# the exchange_ms audit and the calibrate / queryprof loop
# ---------------------------------------------------------------------------

MESHPROBE_SIZES = (1 << 20, 1 << 23, 1 << 26)  # bytes per shard: 1-64 MiB


def show_profile(label: str, prof) -> dict:
    """One line per fitted key of ``prof`` (α in µs, β in GB/s of wire
    bytes per shard, and each point's wire bytes and best seconds);
    every α >= 0 and every β > 0.  Returns ``{key: (α µs, β GB/s)}``."""
    out = {}
    for key in prof.latency_s:
        a, b = prof.latency_s[key], prof.bytes_per_s[key]
        check(a >= 0 and b > 0, f"meshprobe {label} {key}: alpha {a} >= 0 "
                                f"and beta {b} > 0")
        pts = sorted((w, t) for k, w, t in prof.samples if k == key)
        say(f"meshprobe {label}", key=key, alpha_us=f"{a * 1e6:.3f}",
            beta_gbps=f"{b / 1e9:.3f}",
            wire_bytes_seconds=",".join(f"{w}:{t:.6f}" for w, t in pts))
        out[key] = (a * 1e6, b / 1e9)
    return out


def probe_twice(label: str, ctx) -> tuple:
    """The probe at its default sizes, then forced at ``MESHPROBE_SIZES``
    (the defaults of 4-256 KiB per shard sit in the latency term on the
    card); both printed.  Returns (the large-size profile, its table)."""
    from cylon_tpu_torch.parallel import meshprobe

    small, secs = wall(lambda: meshprobe.probe(ctx))
    say(f"meshprobe {label} default sizes", seconds=f"{secs:.3f}",
        fingerprint=repr(small.fingerprint))
    show_profile(f"{label} default sizes", small)
    prof, secs = wall(lambda: meshprobe.probe(ctx, sizes=MESHPROBE_SIZES,
                                              force=True))
    check(prof is not small and meshprobe.get_profile(ctx) is prof,
          f"meshprobe {label}: force re-probes and caches")
    say(f"meshprobe {label}", seconds=f"{secs:.3f}",
        sizes=",".join(map(str, MESHPROBE_SIZES)))
    return prof, show_profile(label, prof)


def measured_join(label: str, lt, rt, want, proxy_s: float) -> int:
    """The world-4 HASH join under the measured ranking: every exchange
    ranked by ``cost.predicted_ms`` (each candidate's prediction and the
    pick printed), the result = the oracle.  Returns the partition
    kernel's launches."""
    from cylon_tpu_torch import config, trace
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import cost, dist_join

    seen = []
    real = cost.choose

    def spy(cands, budget, *args, **kw):
        out = real(cands, budget, *args, **kw)
        seen.append((cands, out, kw.get("profile"), kw.get("measured")))
        return out

    cost.choose = spy
    prev = config.set_cost_measured(True)
    trace.reset()
    hash_cuda.launches = 0
    try:
        joined, secs = wall(lambda: dist_join(lt, rt, hash_cfg()))
    finally:
        cost.choose = real
        config.set_cost_measured(prev)
    launches = hash_cuda.launches
    c = trace.counters()
    check_join(label, joined.to_table(), want)
    check(launches == 2, f"{label}: 2 partition launches ({launches})")
    check(seen and all(m and p is not None for *_, p, m in seen),
          f"{label}: every exchange ranked by the measurement")
    for i, (cands, (pick, reason, _), prof, _) in enumerate(seen):
        say(f"{label} exchange {i}", pick=pick.strategy,
            **{f"{x.strategy}_predicted_ms":
               (f"{cost.predicted_ms(x, prof):.4f}"
                if cost.predicted_ms(x, prof) is not None else "unmeasured")
               for x in cands},
            reason=repr(reason[:120]))
    say(label, world=WORLD, rows=joined.num_rows, seconds=f"{secs:.6f}",
        proxy_seconds=f"{proxy_s:.6f}", launches=launches,
        strategies=",".join(f"{k.split('.')[-1]}:{v}"
                            for k, v in sorted(c.items())
                            if k.startswith("shuffle.strategy.")))
    del joined
    return launches


def phase_meshprobe(ldata, rdata, want) -> tuple:
    """(a) The probe of ``CylonContext(world=4)`` (``LocalCommunicator``)
    at the default sizes and then at 1-64 MiB per shard: α / β per
    collective and host leg.  (b) The same through ``InitMultiHost`` (one
    process of 4 local ranks over NCCL), whose fingerprint must differ.
    (c) The join cell's world-4 HASH join under the measured ranking with
    (a)'s profile (= the oracle, seconds beside the proxy's run), then
    under a (2, 2) mesh shape after a per-axis probe.  A failing probe
    raises.  Returns (launches flat, launches (2, 2), (a)'s profile,
    the α / β tables)."""
    from cylon_tpu_torch import CylonContext, config, trace
    from cylon_tpu_torch.parallel import dist_join, meshprobe

    meshprobe.clear_profiles()
    was_on = trace.counters_enabled()
    trace.enable_counters()
    tables = {}
    try:
        # (a)
        ctx = CylonContext(device=DEVICE, world=WORLD)
        prof, tables["local"] = probe_twice("local", ctx)
        # (b)
        nctx = CylonContext.InitMultiHost(
            f"tcp://127.0.0.1:{free_port()}", 1, 0, world=WORLD,
            device=DEVICE, backend=MP_BACKEND, timeout=600)
        try:
            nprof, tables[MP_BACKEND] = probe_twice(MP_BACKEND, nctx)
        finally:
            nctx.finalize()
        check(nprof.fingerprint != prof.fingerprint
              and nprof.fingerprint[0] == MP_BACKEND,
              "meshprobe: the NCCL context's fingerprint differs from the "
              "local world's")
        for key in prof.bytes_per_s:
            say("meshprobe local vs " + MP_BACKEND, key=key,
                local_beta_gbps=f"{tables['local'][key][1]:.3f}",
                beta_gbps=f"{tables[MP_BACKEND][key][1]:.3f}",
                local_alpha_us=f"{tables['local'][key][0]:.3f}",
                alpha_us=f"{tables[MP_BACKEND][key][0]:.3f}")
        # (c)
        lt, rt = join_sides(ldata, rdata)
        check(meshprobe.get_profile(lt.ctx) is prof,
              "meshprobe: a rebuilt world-4 context reuses (a)'s profile")
        dist_join(lt, rt, hash_cfg())   # first use of the join's kernels
        _, proxy_s = wall(lambda: dist_join(lt, rt, hash_cfg()))
        flat = measured_join("measured join", lt, rt, want, proxy_s)
        prev = config.set_mesh_shape((2, 2))
        try:
            hprof, secs = wall(lambda: meshprobe.probe(
                lt.ctx, sizes=MESHPROBE_SIZES))
            check(hprof.axis_split == (2, 2) and all(
                f"{c}@{e}" in hprof.bytes_per_s
                for c in meshprobe.COLLECTIVES for e in ("fast", "slow")),
                "meshprobe: the (2, 2) probe fitted every per-axis key")
            say("meshprobe local (2, 2)", seconds=f"{secs:.3f}")
            tables["local_2x2"] = show_profile("local (2, 2)", hprof)
            hier = measured_join("measured join (2, 2)", lt, rt, want,
                                 proxy_s)
        finally:
            config.set_mesh_shape(prev)
        del lt, rt
    finally:
        if not was_on:
            trace.disable_counters()
    return flat, hier, prof, tables


def audit_pairs(label: str, rep) -> list:
    """Every exchange of an analyzed report carries both audit columns:
    one ``exchange_ms`` and one ``peak`` pair per ``exchange`` entry.
    Prints each predicted / observed pair; returns the ms pairs."""
    from cylon_tpu_torch.analysis import calibrate

    pairs = []
    for i, n in enumerate(rep.nodes):
        ex = n.info.get("exchange")
        if not ex:
            continue
        ms = calibrate.parse_annotation(n.info.get("exchange_ms"))
        peak = calibrate.parse_annotation(n.info.get("peak"))
        count = len(ex.split(" | "))
        check(len(ms) == len(peak) == count,
              f"{label} node {i} {n.op}: {count} exchange(s), {len(ms)} "
              f"exchange_ms and {len(peak)} peak pairs")
        for (strat, pred, obs, _), (_, ppred, pobs, _) in zip(ms, peak):
            say(f"{label} exchange", node=f"{i}:{n.op}", strategy=strat,
                predicted_ms=f"{pred:.2f}", observed_ms=f"{obs:.2f}",
                predicted_peak_bytes=int(ppred),
                observed_peak_bytes=int(pobs))
        pairs += ms
    return pairs


def phase_meshprobe_audit(tctx, tables, sf: float, ldata, rdata, want,
                          profile) -> None:
    """(d) EXPLAIN ANALYZE (planned) of the world-4 HASH join and of Q5 at
    ``sf`` with (a)'s profile: every exchange carries ``exchange_ms`` and
    ``peak``; the stats store saved under ``build/``; ``calibrate`` must
    read it (exit 0 or 1: drift is a finding, 2 fails), with each
    strategy's median error printed; a second analyzed pass, and
    ``queryprof`` of the two stores (exit 0 or 1)."""
    import contextlib
    import io
    import os

    from cylon_tpu_torch import observe, plan
    from cylon_tpu_torch.analysis import calibrate, queryprof
    from cylon_tpu_torch.observe.stats import StatsStore
    from cylon_tpu_torch.parallel import broadcast, dist_join, meshprobe
    from cylon_tpu_torch.tpch import QUERIES

    meshprobe.put_profile(profile)
    check(meshprobe.get_profile(tctx) is profile,
          "meshprobe audit: the TPC-H context has (a)'s fingerprint")
    lt, rt = join_sides(ldata, rdata)
    plans = {
        "join": (lt, lambda t: dist_join(t["l"], t["r"], hash_cfg()),
                 {"l": lt, "r": rt}),
        "q5": (tables["lineitem"], lambda t: QUERIES["q5"](tctx, t),
               tables)}
    os.makedirs("build", exist_ok=True)
    paths, pairs = [], 0
    try:
        for rnd in (1, 2):
            observe.STATS_STORE.clear()
            plan.clear_plan_cache()
            for name, (anchor, op, tbls) in plans.items():
                broadcast.clear_replica_cache()
                rep, secs = wall(lambda: anchor.explain(
                    op, tables=tbls, analyze=True, optimize=True))
                label = f"meshprobe audit {name} pass {rnd}"
                check(rep.ok and rep.stats_digests,
                      f"{label}: the run succeeded and was recorded "
                      f"({rep.error})")
                if name == "join":
                    check_join(label, rep.output.to_table(), want)
                got = audit_pairs(label, rep)
                pairs += len(got)
                say(label, sf=sf if name == "q5" else "-",
                    seconds=f"{secs:.6f}", exchanges=len(got),
                    nodes=len(rep.nodes))
                del rep
            paths.append(os.path.join("build",
                                      f"chip_smoke_stats_{rnd}.json"))
            observe.STATS_STORE.save(paths[-1])
    finally:
        observe.STATS_STORE.clear()
        plan.clear_plan_cache()
        del lt, rt
    check(pairs > 0, "meshprobe audit: some exchange was annotated")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main(["--stats", paths[0]])
    check(rc in (0, 1), f"calibrate reads the store (exit {rc})")
    report = calibrate.calibration_report(
        calibrate.collect_samples(StatsStore(path=paths[0])))
    for (strat, unit), row in sorted(report.items()):
        say("meshprobe calibrate", strategy=strat, unit=unit, n=row["n"],
            median_error=f"{row['p50']:.3f}", p90_error=f"{row['p90']:.3f}",
            max_error=f"{row['max']:.3f}",
            worst=f"{row['worst']['label']}:{row['worst']['op']}")
    say("meshprobe calibrate", stats=paths[0], exit_code=rc,
        groups=len(report))
    findings = queryprof.diff_snapshots(paths[0], paths[1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        qrc = queryprof.main(paths)
    check(qrc in (0, 1) and (qrc == 1) == bool(findings),
          f"queryprof reads both stores (exit {qrc})")
    say("meshprobe queryprof", old=paths[0], new=paths[1], exit_code=qrc,
        findings=len(findings),
        kinds=",".join(sorted({f["kind"] for f in findings})) or "none")


# ---------------------------------------------------------------------------
# the reference's last names: the host generator's TPC-H tables, the join
# microbench's sides and the carried sort-join plan
# ---------------------------------------------------------------------------

TPCH_HOST_SF = 1.0           # the spec's smallest full scale (~6M lineitems)
TPCH_HOST_SEED = 42          # the TPC-H example's seed
# the queries phase_tpch_oracles recomputes; the rest are held to world 1
ORACLE_QUERIES = ("q1", "q3", "q4", "q6", "q14", "q18", "q22")


def phase_tpch_host(sf: float, seed: int):
    """``tpch.generate(sf)`` on the host (pandas), each frame ingested with
    ``DTable.from_pandas`` at world 4 on the card, then the 22 queries:
    Q1, Q3, Q4, Q6, Q14, Q18 and Q22 against the numpy oracles, every
    other query's row count against the same query at world 1 on the
    same frames.  Returns the partition launches per query."""
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.parallel import DTable, broadcast
    from cylon_tpu_torch.tpch import QUERIES, generate
    from cylon_tpu_torch.tpch.datagen_device import TYPE_POOL

    data, gen_s = wall(lambda: generate(sf, seed=seed))
    ctx = CylonContext(device=DEVICE, world=WORLD)
    torch.cuda.reset_peak_memory_stats()
    tables, ingest_s = wall(lambda: {
        n: DTable.from_pandas(ctx, df) for n, df in data.items()})
    rows = {n: len(df) for n, df in data.items()}
    check({n: dt.num_rows for n, dt in tables.items()} == rows,
          "tpch-host: every table ingested whole")
    # the oracles read dictionary codes: each Categorical lands on the
    # sorted values it holds
    for n, df in data.items():
        for c in df.columns:
            if df[c].dtype.name == "category":
                check(list(tables[n].column(c).dictionary) ==
                      sorted(df[c].unique().astype(str)),
                      f"tpch-host {n}.{c}: the sorted values")
    check(list(tables["part"].column("p_type").dictionary) == TYPE_POOL,
          "tpch-host: p_type's dictionary is the sorted type pool")
    say(f"tpch-host generate sf={sf}", seed=seed, rows=rows,
        generate_seconds=f"{gen_s:.6f}", ingest_seconds=f"{ingest_s:.6f}",
        world=WORLD,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    results, times, launches = {}, {}, {}
    for q in QUERIES:
        out, secs, peak, n_launch, taken, _ = run_query(q, ctx, tables)
        results[q], times[q], launches[q] = out, secs, n_launch
        say(f"tpch-host {q} sf={sf} world={WORLD}", seconds=f"{secs:.6f}",
            rows=out.num_rows, peak_gib=f"{peak:.2f}",
            kernel_launches=n_launch,
            decisions=",".join(f"{k}:{v}" for k, v in sorted(taken.items()))
            or "none")
        check(out.num_rows > 0, f"tpch-host {q}: a non-empty result")
    phase_tpch_oracles(tables, results, sf)
    del tables
    broadcast.clear_replica_cache()
    ctx1 = CylonContext(device=DEVICE, world=1)
    t1 = {n: DTable.from_pandas(ctx1, df) for n, df in data.items()}
    for q in QUERIES:
        if q not in ORACLE_QUERIES:
            check(QUERIES[q](ctx1, t1).num_rows == results[q].num_rows,
                  f"tpch-host {q}: world 1 and world {WORLD} row counts")
    del t1
    broadcast.clear_replica_cache()
    check(sum(launches.values()) > 0,
          "tpch-host: the partition kernel ran in at least one query")
    geo = float(np.exp(np.mean(np.log(list(times.values())))))
    say(f"tpch-host sf={sf}", queries=len(times),
        total_seconds=f"{sum(times.values()):.6f}",
        geomean_seconds=f"{geo:.6f}",
        kernel_launches=sum(launches.values()),
        hashing=",".join(q for q, v in launches.items() if v) or "none",
        world1_row_counts="equal")
    return launches


BENCH_ROWS = 4_000_000       # bench.py's rows on one accelerator
BENCH_SEEDS = (3, 3 + 7919)  # its two sides' seeds
BENCH_KRANGE = int(BENCH_ROWS * 0.99)


def bench_side(ctx, seed: int):
    """One side of the join microbench as a DTable at ``ctx``'s world: the
    columns computed on the card from each row's global index in the
    block layout (``bench.py``'s on-device side)."""
    from cylon_tpu_torch.dtypes import DataType, Type
    from cylon_tpu_torch.parallel import DColumn, DTable
    from cylon_tpu_torch.tpch.datagen_device import (_block_index,
                                                     bench_join_cols)

    g, valid, sizes, cap = _block_index(BENCH_ROWS, ctx)
    cols = bench_join_cols(torch, seed, g, BENCH_KRANGE)
    dcols = [DColumn(c, DataType(Type.INT32 if c == "k" else Type.FLOAT),
                     torch.where(valid, x, 0).to(x.dtype))
             for c, x in cols.items()]
    return DTable(ctx, dcols, cap, torch.from_numpy(sizes.copy()).to(DEVICE))


def phase_bench_cols():
    """``bench_join_cols`` on the card at the bench's one-accelerator shape
    equals its numpy form bit for bit; the HASH ``dist_join`` of the two
    sides at world 4 gives pandas' merge row count with 2 launches."""
    import pandas as pd

    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.parallel import dist_join
    from cylon_tpu_torch.tpch.datagen_device import bench_join_cols

    idx = np.arange(BENCH_ROWS, dtype=np.int32)
    idx_t = torch.from_numpy(idx).to(DEVICE)
    host, gen_ms = [], []
    for seed in BENCH_SEEDS:
        want = bench_join_cols(np, seed, idx, BENCH_KRANGE)
        got = bench_join_cols(torch, seed, idx_t, BENCH_KRANGE)
        for c, w in want.items():
            g = got[c].cpu().numpy()  # graftlint: ok[implicit-host-sync]
            check(g.dtype == w.dtype and np.array_equal(
                g.view(np.int32), w.view(np.int32)),
                f"bench-cols seed={seed} {c}: torch == numpy bit for bit")
        gen_ms.append(cuda_ms(lambda: bench_join_cols(
            torch, seed, idx_t, BENCH_KRANGE), 5))
        host.append(want)
    ctx = CylonContext(device=DEVICE, world=WORLD)
    (lt, rt), side_s = wall(lambda: tuple(bench_side(ctx, s)
                                          for s in BENCH_SEEDS))
    # the sides' valid rows are the contiguous columns, in order
    for dt, want in zip((lt, rt), host):
        k = dt.to_table().column("k").data.cpu().numpy()  # graftlint: ok[implicit-host-sync]
        check(np.array_equal(k, want["k"]),
              "bench-cols: the world-4 side holds the columns in order")
    want_rows = len(pd.DataFrame(host[0]).merge(pd.DataFrame(host[1]),
                                                on="k", how="inner"))
    dist_join(lt, rt, hash_cfg())  # first use of this shape
    reset_launches()
    out, join_s = wall(lambda: dist_join(lt, rt, hash_cfg()))
    launches, _ = read_launches()
    check(out.num_rows == want_rows,
          f"bench-cols: join rows {out.num_rows} == pandas {want_rows}")
    check(launches == 2, "bench-cols: 2 partition launches")
    say("bench-cols", rows_per_side=BENCH_ROWS, seeds=BENCH_SEEDS,
        krange=BENCH_KRANGE, exact="yes",
        generate_ms=",".join(f"{x:.4f}" for x in gen_ms),
        sides_seconds=f"{side_s:.6f}", join_seconds=f"{join_s:.6f}",
        join_rows=out.num_rows, pandas_rows=want_rows,
        kernel_launches=launches, world=WORLD)
    return launches


CARRIED_ROWS = 4_194_304


def carried_outputs(kl, kr, how: str, cap: int, carried: bool):
    """One shard's join of single-column sides through the carried plan
    or through ``sort_join_plan`` + ``plan_indices`` + ``take_many``."""
    from cylon_tpu_torch.ops import join as ops_join
    from cylon_tpu_torch.ops.gather import take_many

    keys = ((kl,), (None,), (kr,), (None,))
    if carried:
        state = ops_join.sort_join_plan_carried(
            *keys, how, l_leaves=[(kl, None)], r_leaves=[(kr, None)])
        return ops_join.plan_gather_carried(*state, how, cap)
    li, ri, cnt = ops_join.plan_indices(
        ops_join.sort_join_plan(*keys, how), how, cap)
    return (take_many([(kl, None)], li, fill_null=how in ("right",
                                                            "full_outer")),
            take_many([(kr, None)], ri, fill_null=how in ("left",
                                                          "full_outer")),
            cnt)


def same_outputs(label: str, a, b) -> None:
    n = int(a[2])
    check(n == int(b[2]), f"{label}: counts")
    for side in (0, 1):
        for (da, va), (db, vb) in zip(a[side], b[side]):
            check((va is None) == (vb is None), f"{label}: validity kept")
            check(torch.equal(da[:n].view(torch.int32),
                              db[:n].view(torch.int32)), f"{label}: data")
            if va is not None:
                check(torch.equal(va[:n], vb[:n]), f"{label}: validity")


def phase_carried(seed: int):
    """The carried sort-join plan on 4,194,304-row single-column sides: at
    the ops level on one shard, the carried plan + ``plan_gather_carried``
    equals ``sort_join_plan`` + ``plan_indices`` + ``take_many`` bit for
    bit for every join type (each timed with CUDA events); at world 4,
    ``dist_join`` SORT and HASH of the same single-column sides (the shape
    the JAX package carries; the port's plain plan) equal a host oracle of
    the row count and key multiset, SORT in global key order."""
    from cylon_tpu_torch import CylonContext, JoinConfig, Table
    from cylon_tpu_torch.ops import join as ops_join
    from cylon_tpu_torch.ops.compact import next_bucket
    from cylon_tpu_torch.parallel import DTable, dist_join

    n = CARRIED_ROWS
    krange = int(KEY_FRAC * n)
    rng = np.random.default_rng(seed + 22)
    kl_np = rng.integers(0, krange, n, dtype=np.int32)
    kr_np = rng.integers(0, krange, n, dtype=np.int32)
    kl, kr = (torch.from_numpy(x).to(DEVICE) for x in (kl_np, kr_np))
    ops = {}
    for how in ("inner", "left", "right", "full_outer"):
        keys = ((kl,), (None,), (kr,), (None,))
        total = int(ops_join.plan_total(ops_join.sort_join_plan(*keys, how),
                                        how))
        cap = next_bucket(total, minimum=8)
        a = carried_outputs(kl, kr, how, cap, True)
        b = carried_outputs(kl, kr, how, cap, False)
        same_outputs(f"carried {how}", a, b)
        del a, b
        c_ms = cuda_ms(lambda: carried_outputs(kl, kr, how, cap, True), 5,
                       warmup=1)
        p_ms = cuda_ms(lambda: carried_outputs(kl, kr, how, cap, False), 5,
                       warmup=1)
        ops[how] = {"rows": total, "carried_ms": c_ms, "plain_ms": p_ms}
        say(f"carried ops {how}", rows_per_side=n, out_rows=total,
            exact="yes", carried_ms=f"{c_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            carried_over_plain=f"{c_ms / p_ms:.3f}")

    # the host oracle: per-key counts of both sides
    cl = np.bincount(kl_np, minlength=krange).astype(np.int64)
    cr = np.bincount(kr_np, minlength=krange).astype(np.int64)
    want_keys = torch.from_numpy(cl * cr).to(DEVICE)
    ctx = CylonContext(device=DEVICE, world=WORLD)
    lt = DTable.from_table(ctx, Table.from_columns(ctx, {"k": kl_np}))
    rt = DTable.from_table(ctx, Table.from_columns(ctx, {"k": kr_np}))
    configs = {"sort": JoinConfig.InnerJoin(0, 0), "hash": hash_cfg()}
    joins = {}
    for alg, cfg in configs.items():
        dist_join(lt, rt, cfg)  # first use of this shape
        reset_launches()
        out, secs = wall(lambda: dist_join(lt, rt, cfg))
        launches, _ = read_launches()
        k = out.to_table().column("lt-k").data
        check(k.shape[0] == int(want_keys.sum()) and torch.equal(
            torch.bincount(k.long(), minlength=krange), want_keys),
            f"carried {alg}: rows and key multiset == oracle")
        if alg == "sort":
            check(bool((k[1:] >= k[:-1]).all()),
                  "carried sort: global key order")
        check(launches == (2 if alg == "hash" else 0),
              f"carried {alg}: launches")
        joins[alg] = {"seconds": secs, "launches": launches}
        say(f"carried dist_join {alg} world={WORLD}", rows_per_side=n,
            out_rows=k.shape[0], seconds=f"{secs:.6f}",
            kernel_launches=launches)
        del out, k
    return joins, ops


# ---------------------------------------------------------------------------
# the one-command gate: analysis/ci.py and analysis/benchdiff.py
# ---------------------------------------------------------------------------

class _Tee:
    """A text stream that writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def bench_line(times, wire, reads, join_rows_per_s: float) -> dict:
    """``bench.py``'s artifact line, filled with this run's numbers: the
    HASH join cell's rows per second as the headline, and per TPC-H query
    its eager seconds (as ms), wire bytes and host reads."""
    detail = {}
    for q in times:
        detail[f"tpch_{q}_ms"] = times[q] * 1e3
        detail[f"tpch_{q}_bytes_moved"] = wire[q]
        detail[f"tpch_{q}_host_reads"] = reads[q]
    return {"metric": "dist_join_rows_per_sec", "value": join_rows_per_s,
            "unit": "rows/s", "detail": detail}


def phase_ci(times, wire, reads, join_rows_per_s: float, smi_line: str):
    """``analysis.ci.main`` in this process at the tool's own defaults
    (world 8, SF 0.002) on the card: one line per stage (exit code,
    seconds, partition-kernel launches); every stage exits 0 and none of
    stages 1-13 skips.  Then stage 14 on two artifacts in ``bench.py``'s
    line format under ``build/``, filled with this run's TPC-H seconds,
    wire bytes and host reads: self against self gives 0, and with one
    query's ``tpch_<q>_ms`` doubled gives 1, naming that key."""
    import contextlib
    from pathlib import Path

    from cylon_tpu_torch.analysis import ci

    stages, per_stage = [], {}
    tee = _Tee(sys.stdout)
    mark = [0, (0, 0)]   # text offset and launches at the last stage end

    def on_stage(number, name, rc, secs):
        text = tee.text()
        launched = read_launches()
        stages.append((number, name, rc, secs, text[mark[0]:],
                       launched[0] - mark[1][0], launched[1] - mark[1][1]))
        mark[0], mark[1] = len(text), launched

    t0 = time.perf_counter()
    reset_launches()
    with contextlib.redirect_stdout(tee):
        rc = ci.main(["--device", "cuda", "--world", "8"], on_stage=on_stage)
    secs = time.perf_counter() - t0
    for number, name, src, ssecs, text, n, n_chained in stages:
        say(f"ci stage {number}", name=repr(name), exit_code=src,
            seconds=f"{ssecs:.3f}", kernel_launches=n,
            chained_launches=n_chained,
            skipped="skipped" in text)
        per_stage[str(number)] = {"launches": n, "chained": n_chained}
    check([s[0] for s in stages] == list(range(1, 14)),
          f"ci: stages 1-13 ran ({[s[0] for s in stages]})")
    check(all(s[2] == 0 for s in stages),
          f"ci: every stage exits 0 ({[(s[0], s[2]) for s in stages]})")
    check(not any("skipped" in s[4] for s in stages),
          "ci: no stage of 1-13 skipped")
    check(rc == 0, f"ci: main exits 0 (got {rc})")
    check(sum(v["launches"] for v in per_stage.values()) > 0,
          "ci: the partition kernel ran in the gate's stages")
    say("ci", stages=len(stages), exit_code=rc, wall_seconds=f"{secs:.3f}",
        kernel_launches=sum(v["launches"] for v in per_stage.values()),
        card=repr(smi_line))

    # stage 14: the regression gate on this run's own numbers
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    line = bench_line(times, wire, reads, join_rows_per_s)
    slow_q = max(times, key=times.get)
    worse = json.loads(json.dumps(line))
    worse["detail"][f"tpch_{slow_q}_ms"] *= 2
    base_path, worse_path = (out / "chip_smoke_bench_base.json",
                             out / "chip_smoke_bench_worse.json")
    base_path.write_text(json.dumps(line) + "\n")
    worse_path.write_text(json.dumps(worse) + "\n")
    for label, cand, want in (("self", base_path, 0),
                              ("doubled", worse_path, 1)):
        gate = _Tee(sys.stdout)
        with contextlib.redirect_stdout(gate):
            got = ci._stage_benchdiff(str(base_path), str(cand), 0.15)
        flagged = [ln.split()[0] for ln in gate.text().splitlines()
                   if ln.rstrip().endswith("REGRESSED")]
        say(f"ci benchdiff {label}", exit_code=got, keys=len(line["detail"]),
            regressed=",".join(flagged) or "none")
        check(got == want, f"ci benchdiff {label}: exit {want} (got {got})")
        check(flagged == ([] if want == 0 else [f"tpch_{slow_q}_ms"]),
              f"ci benchdiff {label}: the regressed keys ({flagged})")
    return per_stage


# ---------------------------------------------------------------------------
# the static gates and sanitizer mode
# ---------------------------------------------------------------------------

LINT_TARGETS = ("cylon_tpu_torch", "chip_smoke.py")


def phase_lint():
    """graftlint and lockcheck over the port and this script, each as its
    CLI in a subprocess from the checkout's root: both exit 0 with no
    finding."""
    from pathlib import Path

    from cylon_tpu_torch.analysis import graftlint

    root = Path(__file__).resolve().parent
    files = graftlint.count_files([str(root / t) for t in LINT_TARGETS])
    for tool in ("graftlint", "lockcheck"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"cylon_tpu_torch.analysis.{tool}",
             *LINT_TARGETS], cwd=root, capture_output=True, text=True,
            timeout=300)
        secs = time.perf_counter() - t0
        findings = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        say(f"lint {tool}", files=files, findings=len(findings),
            exit_code=proc.returncode, seconds=f"{secs:.3f}")
        check(proc.returncode == 0 and not findings,
              f"lint {tool}: exit 0 with no finding "
              f"({proc.stdout[-2000:]}{proc.stderr[-2000:]})")


def guard_probes(dev):
    """Calls to try inside a sanitized span on the card, by name: which of
    them the sync guard stops is measured, not assumed."""
    from cylon_tpu_torch import trace
    from cylon_tpu_torch.ops.compact import read_host, to_device
    from cylon_tpu_torch.table import host_batch

    x = torch.arange(1 << 20, device=dev, dtype=torch.int32)
    m = x % 3 == 0
    host = np.arange(16, dtype=np.int64)
    pinned = torch.empty(x.shape[0], dtype=x.dtype, pin_memory=True)
    ev = torch.cuda.Event()
    ev.record()
    return {
        "item": lambda: x[5].item(),  # graftlint: ok[implicit-host-sync]
        "tolist": lambda: x[:4].tolist(),  # graftlint: ok[implicit-host-sync]
        "int_of_tensor": lambda: int(x[3]),  # graftlint: ok[implicit-host-sync]
        "bool_of_any": lambda: bool(m.any()),  # graftlint: ok[implicit-host-sync]
        "cpu_pageable": lambda: x.cpu(),  # graftlint: ok[implicit-host-sync]
        "to_cpu_non_blocking": lambda: x.to("cpu", non_blocking=True),  # graftlint: ok[implicit-host-sync]
        "copy_to_pinned_non_blocking": lambda: pinned.copy_(
            x, non_blocking=True),
        "nonzero": lambda: torch.nonzero(m),
        "nonzero_static": lambda: torch.nonzero_static(m, size=64),
        "bool_mask_index": lambda: x[m],
        "masked_select": lambda: torch.masked_select(x, m),
        "unique": lambda: torch.unique(x[:64]),
        "bincount": lambda: torch.bincount(x[:64]),
        "repeat_interleave_tensor": lambda: torch.repeat_interleave(
            x[:8].long()),
        "setitem_int_scalar": lambda: x.__setitem__(0, 0),
        "setitem_index_scalar": lambda: x.__setitem__(x[:8].long(), 0),
        "slice_fill": lambda: x[:1].fill_(0),
        "full_scalar": lambda: torch.full((), 7, device=dev),
        "tensor_from_list": lambda: torch.tensor([1, 2, 3], device=dev),
        "as_tensor_numpy": lambda: torch.as_tensor(host, device=dev),
        "from_numpy_non_blocking": lambda: torch.from_numpy(host).to(
            dev, non_blocking=True),
        "index_add": lambda: torch.zeros(8, dtype=torch.int32,
                                         device=dev).index_add_(
            0, x[:64] % 8, torch.ones(64, dtype=torch.int32, device=dev)),
        "equal": lambda: torch.equal(x, x),
        "torch_cuda_synchronize": lambda: torch.cuda.synchronize(),
        "stream_synchronize": lambda: torch.cuda.current_stream().synchronize(),
        "event_synchronize": lambda: ev.synchronize(),
        "read_host": lambda: read_host(x[:4]),
        "host_batch": lambda: host_batch([x[:4], m[:4]]),
        "hard_sync": lambda: trace.hard_sync(x),
        "to_device": lambda: to_device(host, dev),
    }


def phase_sanitize_guard():
    """Sanitizer mode on ``cuda:0``: a ``.item()`` inside a span raises
    under ``config.sanitize()`` and not without it, and the sync debug
    mode is back to its prior value after the scope; ``torch.log`` of −1
    inside a span raises ``FloatingPointError`` naming the op while a
    masked ``torch.where(valid, a / b, 0)`` does not; ``read_host`` runs
    inside a guarded span.  Then every call of ``guard_probes`` once
    inside a sanitized span: one line of which the guard stops."""
    from cylon_tpu_torch import config, trace
    from cylon_tpu_torch.ops.compact import read_host

    dev = torch.device(DEVICE)
    prior = torch.cuda.get_sync_debug_mode()
    x = torch.arange(1 << 20, device=dev, dtype=torch.int32)
    with trace.span("sanitize_guard.plain"):
        plain = x[5].item()  # graftlint: ok[implicit-host-sync]
    check(plain == 5, "sanitize guard: an unsanitized span reads .item()")
    raised = nan = None
    with config.sanitize():
        check(config.lockcheck_enabled(),
              "sanitize guard: sanitizing turns on lock-order enforcement")
        try:
            with trace.span("sanitize_guard.item"):
                x[5].item()  # graftlint: ok[implicit-host-sync]
        except RuntimeError as e:
            raised = str(e)
        check(raised is not None and "synchroniz" in raised,
              f"sanitize guard: .item() in a span raises ({raised!r})")
        check(torch.cuda.get_sync_debug_mode() == prior,
              "sanitize guard: the raising body restored the debug mode")
        with trace.span("sanitize_guard.read_host"):
            got = read_host(x[:4])
        check(list(got) == [0, 1, 2, 3],
              "sanitize guard: read_host runs inside a guarded span")
        try:
            with trace.span("sanitize_guard.nan"):
                y = torch.log(torch.full((8,), -1.0, device=dev))
        except FloatingPointError as e:
            nan = str(e)
        check(nan is not None and "aten.log" in nan,
              f"sanitize guard: log(-1) raises naming the op ({nan!r})")
        a = torch.rand(1 << 20, device=dev)
        b = torch.where(torch.arange(1 << 20, device=dev) % 3 == 0, 0.0, a)
        with trace.span("sanitize_guard.masked"):
            out = torch.where(b != 0, a / b, 0.0)
        rows = []
        for name, fn in guard_probes(dev).items():
            try:
                with trace.span(f"sanitize_guard.{name}"):
                    fn()
                rows.append((name, "ok"))
            except RuntimeError as e:
                check("synchroniz" in str(e),
                      f"sanitize guard: {name} failed otherwise ({e})")
                rows.append((name, "raises"))
            check(torch.cuda.get_sync_debug_mode() == prior,
                  f"sanitize guard: the mode is restored after {name}")
        torch.cuda.synchronize()
    check(not torch.isnan(out).any().item(),  # graftlint: ok[implicit-host-sync]
          "sanitize guard: the masked quotient holds no NaN")
    check(torch.cuda.get_sync_debug_mode() == prior and not
          config.sanitizing(), "sanitize guard: the scope restored the mode")
    trips = dict(rows)
    check(trips["item"] == "raises" and trips["read_host"] == "ok"
          and trips["host_batch"] == "ok" and trips["hard_sync"] == "ok"
          and trips["to_device"] == "ok",
          f"sanitize guard: the sanctioned transfers pass, .item() does "
          f"not ({trips})")
    say("sanitize_guard", item_in_span="raises", unsanitized="ok",
        mode_restored=True, nan_trap="raises", masked_nan="ok",
        read_host_in_span="ok", prior_mode=prior)
    say("sanitize_guard trips",
        raises=",".join(n for n, r in rows if r == "raises"),
        passes=",".join(n for n, r in rows if r == "ok"))


def same_shards(label: str, a, b) -> None:
    """The same rows on the same shards in the same order, bit for bit."""
    check(list(a.counts_host()) == list(b.counts_host()) and all(
        torch.equal(x, y) for x, y in zip(shard_row_hashes(a, ordered=True),
                                          shard_row_hashes(b, ordered=True))),
          f"{label}: sanitized = unsanitized, shard for shard")


def same_groups(label: str, a, b) -> None:
    """A groupby's shards: the same keys in the same order, float sums
    within 1e-6 relative (their summation order may differ on the
    card)."""
    check(list(a.counts_host()) == list(b.counts_host()),
          f"{label}: the same group counts per shard")
    (da, va), (db, vb) = (engine_result(t, []) for t in (a, b))
    check(va.keys() == vb.keys() and all(np.array_equal(va[c], vb[c])
                                         for c in va),
          f"{label}: the same validity, in order")
    for c in da:
        x, y = da[c], db[c]
        ok = (np.allclose(x, y, rtol=1e-6, atol=0) if x.dtype.kind == "f"
              else np.array_equal(x, y))
        check(ok, f"{label}: column {c} equal, in order")


def phase_sanitize_join(ldata, rdata, want):
    """The join cell (full width, world 4) under ``config.sanitize()``:
    the HASH join, the SORT join and the HASH join under every forced
    exchange lowering, and the fused groupby's chunked fold-combine (the
    rank-sliced morsels) — each equal to the oracle and to the same run
    without sanitize, shard for shard.  The partition kernel launches 2
    times in each sanitized HASH join and, inside a sanitized span,
    equals its plain version bit for bit.  Prints sanitized ÷ plain
    seconds.  Returns the sanitized launches by run."""
    from cylon_tpu_torch import JoinAlgorithm, JoinConfig, JoinType
    from cylon_tpu_torch import config, trace
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.parallel import dist_groupby_fused, dist_join

    n = len(ldata["k"])
    lt, rt = join_sides(ldata, rdata)
    hash_cfg = JoinConfig(JoinType.INNER, JoinAlgorithm.HASH, 0, 0,
                          broadcast_threshold=0)
    sort_cfg = JoinConfig.InnerJoin(0, 0)
    check(sort_cfg.algorithm == JoinAlgorithm.SORT, "SORT is the default")
    launches, chained = {}, [0]

    def run_pair(label, fn, join: bool):
        # one warm-up, then plain, sanitized, sanitized, plain: both sides
        # meet the same order effects, and each side's time is the mean
        # of its two runs; the launches are the first sanitized run's
        fn()
        p1 = wall(fn)[1]
        reset_launches()
        trace.reset()
        with config.sanitize():
            san, s1 = wall(fn)
        n_launch, n_chained = read_launches()
        chained[0] += n_chained
        counters = trace.counters()
        with config.sanitize():
            s2 = wall(fn)[1]
        plain, p2 = wall(fn)
        p_secs, s_secs = (p1 + p2) / 2, (s1 + s2) / 2
        if join:
            same_shards(label, san, plain)
            check_join(label, san.to_table(), want)
        else:
            same_groups(label, san, plain)
        del san, plain
        say(label, rows=n, world=WORLD, plain_seconds=f"{p_secs:.6f}",
            sanitized_seconds=f"{s_secs:.6f}",
            sanitized_over_plain=f"{s_secs / p_secs:.3f}",
            kernel_launches=n_launch)
        return n_launch, counters

    trace.enable_counters()
    launches["hash_join"], _ = run_pair(
        "sanitize_join hash", lambda: dist_join(lt, rt, hash_cfg), True)
    check(launches["hash_join"] == 2, "sanitize_join hash: the partition "
          f"kernel launched 2 times (got {launches['hash_join']})")
    launches["sort_join"], _ = run_pair(
        "sanitize_join sort", lambda: dist_join(lt, rt, sort_cfg), True)
    for strategy, shape in LOWERINGS:
        config.set_exchange_strategy(strategy)
        config.set_mesh_shape(shape)
        try:
            label = f"sanitize_join hash {strategy}"
            launches[strategy], c = run_pair(
                label, lambda: dist_join(lt, rt, hash_cfg), True)
            check(c.get(f"shuffle.strategy.{strategy.replace('-', '_')}",
                        0) >= 1, f"{label}: ran the {strategy} lowering")
            check(launches[strategy] == 2, f"{label}: the partition kernel "
                  f"launched 2 times (got {launches[strategy]})")
        finally:
            config.set_exchange_strategy(None)
            config.set_mesh_shape(None)
    # the chunked fold-combine: each round's rows cut by rank, on the card
    config.set_exchange_strategy("chunked")
    try:
        label = "sanitize_join fused chunked fold-combine"
        launches["fused_chunked"], c = run_pair(
            label, lambda: dist_groupby_fused(
                lt, ["k"], [("v0", "sum")], mode="pre-aggregate"), False)
        check(c.get("shuffle.fold_combined", 0) >= 1
              and c.get("shuffle.chunked", 0) >= 1,
              f"{label}: the rounds folded by key ({c})")
    finally:
        config.set_exchange_strategy(None)
    # the kernel under the guard, against its plain version
    k = lt.column("k").data
    with config.sanitize():
        with trace.span("sanitize_join.kernel"):
            got = hash_cuda.partition_ids_fused((k,), (None,), WORLD)
    check(torch.equal(got, plain_hash.partition_ids(
        plain_hash.row_hash((k,), (None,)), WORLD)),
        "sanitize_join: the kernel under the guard = its plain version")
    del got
    # the shuffle's count pass at the join cell's shape, with no host
    # read (ops/compact.bincount), against torch.bincount, which reads
    # the lane's min and max on the host first
    from cylon_tpu_torch.ops.compact import bincount
    from cylon_tpu_torch.parallel import dist_ops, shuffle
    pid = dist_ops._hash_pids(lt, [0])
    flat = pid.to(torch.int64) + shuffle._shard_offsets(
        WORLD, lt.cap, pid.device, WORLD + 1)
    nb = WORLD * (WORLD + 1)
    want_cnt = torch.bincount(flat, minlength=nb)
    check(torch.equal(bincount(pid.view(WORLD, -1), WORLD),
                      want_cnt.view(WORLD, WORLD + 1)[:, :WORLD]),
          "sanitize_join: the sync-free counts = torch.bincount")
    say("sanitize_join count pass", rows=flat.shape[0], bins=nb,
        compact_bincount_ms=f"{cuda_ms(lambda: bincount(pid.view(WORLD, -1), WORLD), 20):.4f}",
        torch_bincount_ms=f"{cuda_ms(lambda: torch.bincount(flat, minlength=nb), 20):.4f}")
    del pid, flat, want_cnt
    trace.disable_counters()
    return launches, chained[0]


def phase_sanitize_tpch(ctx, tables, sf: float):
    """The 22 queries at ``--tpch-sf``, world 4, eager, each run plain and
    under ``config.sanitize()`` in turns, the first sanitized run with its
    export (``to_arrow``, whose host-cache content compare runs under
    sanitize): the sanitized result equals the plain one in order (the
    oracle phase's tolerances).  One line each: seconds both ways and
    their ratio.  Returns the sanitized
    partition-kernel launches per query."""
    from cylon_tpu_torch import config
    from cylon_tpu_torch.tpch import QUERIES

    launches, plain_t, san_t = {}, {}, {}
    for q in QUERIES:
        # plain, sanitized, sanitized, plain (the queries ran warm in the
        # phases before): each side's time is the mean of its two runs
        p1 = run_query(q, ctx, tables)[1]
        with config.sanitize():
            san, s1, peak, launches[q], _, _ = run_query(q, ctx, tables)
            _, export_s = wall(san.to_arrow)
            s2 = run_query(q, ctx, tables)[1]
        plain, p2, _, _, _, _ = run_query(q, ctx, tables)
        plain_t[q], san_t[q] = (p1 + p2) / 2, (s1 + s2) / 2
        same_ordered(f"sanitize_tpch {q}", san, plain)
        say(f"sanitize_tpch {q} sf={sf} world={WORLD}",
            plain_seconds=f"{plain_t[q]:.6f}",
            sanitized_seconds=f"{san_t[q]:.6f}",
            sanitized_over_plain=f"{san_t[q] / plain_t[q]:.3f}",
            sanitized_export_seconds=f"{export_s:.6f}", rows=san.num_rows,
            peak_gib=f"{peak:.2f}", kernel_launches=launches[q])
        del plain, san
    total_p, total_s = sum(plain_t.values()), sum(san_t.values())
    say(f"sanitize_tpch sf={sf} world={WORLD}", queries=len(san_t),
        plain_seconds=f"{total_p:.6f}", sanitized_seconds=f"{total_s:.6f}",
        sanitized_over_plain=f"{total_s / total_p:.3f}",
        kernel_launches=sum(launches.values()))
    check(sum(launches.values()) > 0,
          "sanitize_tpch: the partition kernel ran under sanitize")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16_777_216)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tpch-sf", type=float, default=10.0)
    ap.add_argument("--tpch-check-sf", type=float, default=1.0)
    ap.add_argument("--mp-child", nargs=4,
                    metavar=("PROC", "BACKEND", "INIT", "OUT"),
                    help="one of the two processes of the multi-process "
                         "phase (started by the script itself)")
    ap.add_argument("--mp-tpch-child", nargs=4,
                    metavar=("PROC", "SEED", "INIT", "OUT"),
                    help="one of the two processes of the multi-process "
                         "TPC-H phase (started by the script itself)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if args.mp_child:
        return mp_child(args.mp_child)
    if args.mp_tpch_child:
        return mp_tpch_child(args.mp_tpch_child)
    # fails outside a checkout of the repository
    from cylon_tpu_torch.ops import hash as plain_hash
    from cylon_tpu_torch.ops import hash_cuda
    from cylon_tpu_torch.ops.compact import next_bucket, pad_to

    name, smi_line = phase_device()
    max_err = phase_kernel_parity(args.rows, args.seed)

    rng = np.random.default_rng(args.seed)
    (ldata, _), (rdata, _) = make_side(rng, args.rows), make_side(rng, args.rows)
    t = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    want = oracle(t(ldata["k"]), t(rdata["k"]), t(ldata["v0"]), t(rdata["v0"]),
                  None, None, int(KEY_FRAC * args.rows))
    # one small join per world and algorithm first, so the timed runs below
    # do not pay the first use of each CUDA library kernel
    wl, wr = make_side(rng, 4096)[0], make_side(rng, 4096)[0]
    for world, alg in ((1, "hash"), (WORLD, "hash"), (WORLD, "sort")):
        run_join(world, wl, wr, "inner", alg=alg)
    phase_inner(1, ldata, rdata, want, False)
    launches, inner_times = phase_inner(WORLD, ldata, rdata, want,
                                        args.profile)
    launches_analyze = phase_analyze_join(ldata, rdata, want,
                                          inner_times["join_s"])
    phase_sort_join(ldata, rdata, want, args.profile)
    wwant = oracle(t(wl["k"]), t(wr["k"]), t(wl["v0"]), t(wr["v0"]),
                   None, None, int(KEY_FRAC * 4096))
    phase_redistribution(wl, wr, wwant, warm=True)
    launches_redist = phase_redistribution(ldata, rdata, want)
    # the measured cost model: the probe of the local and NCCL worlds and
    # the join cell under the measured ranking
    launches_measured, launches_measured_hier, probed, _ = \
        phase_meshprobe(ldata, rdata, want)
    # the out-of-core tier on the join cell (small warm-ups first)
    phase_morsel_join(wl, wr, wwant, tag="warm-up ")
    phase_staged_spill(wl, wr, wwant, tag="warm-up ")
    link = phase_spill_roundtrip(ldata)
    launches_spill = {"morsel_join": phase_morsel_join(ldata, rdata, want)}
    launches_join_pipeline = phase_join_pipeline(ldata, rdata, want)
    staged = phase_staged_spill(ldata, rdata, want)
    launches_spill["staged_spill_shuffle"] = staged["shuffle"]
    launches_spill["staged_spill_join"] = staged["join"]
    # the recovery driver and the elastic re-mesh on the join cell
    phase_recovery_join(wl, wr, tag="warm-up ")
    launches_recovery, launches_nparts3 = phase_recovery_join(ldata, rdata)
    # ingest and the data-model surfaces: Arrow and per-rank CSV ingest
    # into the join, append, hash64 string keys, the bench's ingest stage,
    # and the partition hash past 16 key columns
    launches_ingest = {}
    launches_ingest["join_cell_from_arrow"], ingest_gbps = \
        phase_join_cell_from_arrow(ldata, rdata, want, link)
    launches_ingest["csv_from_partitions"] = phase_csv_partitions(args.seed)
    launches_append, _ = phase_append(ldata, rdata, args.seed)
    launches_strkey, _ = phase_strkey()
    phase_lineitem_ingest()
    wide = phase_wide_kernel(args.rows, args.seed)
    launches_wide = phase_wide_set_ops(args.seed)
    check(all(v > 0 for v in launches_ingest.values())
          and launches_append > 0 and all(launches_strkey.values())
          and all(launches_wide.values()),
          "the partition kernel ran on the ingest, append, strkey and "
          "wide-key paths")
    phase_outer(args.seed)
    phase_hash_partition(ldata)
    phase_dist_sort(ldata, args.seed, args.profile)
    launches_setop, _, setop_rows = phase_set_ops(ldata, args.seed,
                                                  args.profile)
    # the compat route: pycylon's API, its raw AllToAll, the Java gateway
    # through the launcher Java spawns, and the example programs
    launches_compat = phase_compat(ldata, rdata, want, setop_rows, args.seed,
                                   smi_line)
    exports = Exports()
    launches_stream = phase_streaming_join(ldata, rdata, want, exports)

    li, li_null = make_lineitem(np.random.default_rng(args.seed + 4), args.rows)
    # one small run of each groupby path first, so the timed runs below do
    # not pay the first use of each CUDA library kernel
    wli, wnull = make_lineitem(np.random.default_rng(args.seed + 5), 1 << 16)
    wdt = lineitem_dtable(wli, wnull)
    from cylon_tpu_torch.parallel import dist_groupby
    for kw in ({}, {"pre_aggregate": False},
               {"dense_key_range": (0, (1 << 14) - 1)}):
        dist_groupby(wdt, ["orderkey"], HC_AGGS, **kw)
    torch.cuda.reset_peak_memory_stats()
    dt, secs = wall(lambda: lineitem_dtable(li, li_null))
    say(f"lineitem ingest world={WORLD}", rows=args.rows, seconds=f"{secs:.6f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    launches_gb, _ = phase_groupby_orderkey(dt, li, li_null, args.profile)
    launches_q1, _ = phase_q1(dt, li, li_null, args.profile)
    launches_q6, _ = phase_q6(dt, li, li_null)
    del wdt
    # the multi-process communicator: one process of 4 local ranks over
    # NCCL on the join and lineitem cells, then two processes on the card
    launches_mp = phase_multiprocess(ldata, rdata, want, li, li_null)
    mp_two = phase_multiprocess_two("build")

    # TPC-H: one run of every query at a small scale first (the first use
    # of each CUDA library kernel), then the timed run at --tpch-sf
    from cylon_tpu_torch.parallel import broadcast
    from cylon_tpu_torch.tpch import QUERIES
    from cylon_tpu_torch import plan, trace
    trace.enable_counters()
    wctx, wtables, _ = tpch_generate(0.05, WORLD, args.seed)
    for q in QUERIES:
        QUERIES[q](wctx, wtables)
        wctx.optimize(lambda t, q=q: QUERIES[q](wctx, t), wtables)
    plan.clear_plan_cache()
    # and the planner-operator phases, checks included, on the same small
    # tables
    wexports = Exports()
    phase_fused_groupby(wtables, 0.05, wexports, False)
    phase_sketch(wtables, 0.05, wexports, False)
    phase_agg_state(wtables, 0.05, wexports)
    phase_q9_streaming(wctx, wtables, 0.05, False)
    phase_multiway(wtables, 0.05, wexports)
    phase_ooc_tpch(wctx, wtables, 0.05)
    phase_spilled_operators(wtables, 0.05, wexports)
    wexports.finish()
    del wtables
    broadcast.clear_replica_cache()
    tctx, tables, _ = phase_tpch_generate(args.tpch_sf, args.seed)
    results, times, launches_tpch, wire, reads = phase_tpch_queries(
        tctx, tables, args.tpch_sf, args.profile)
    launches_planner = phase_tpch_planner(tctx, tables, args.tpch_sf,
                                          results, times, wire)
    check(sum(launches_planner.values()) > 0,
          "tpch planner: the partition kernel ran on the planned path")
    phase_tpch_oracles(tables, results, args.tpch_sf)
    check(sum(launches_tpch.values()) > 0,
          "tpch: the partition kernel ran in at least one query")
    # the JAX bench's TPC-H form: the abstract plan check of every query
    # (eager and planned), then each query under run_pipeline
    plan_check_s = phase_plan_check(tctx, tables, args.tpch_sf)
    launches_pipeline = phase_tpch_pipeline(tctx, tables, args.tpch_sf,
                                            results)
    phase_explain_report(tctx, tables)
    # TPC-H and the planner across processes: the same queries through
    # one process of 4 local ranks over NCCL, then two processes on the
    # card over gloo
    launches_mp_tpch = phase_multiprocess_tpch(
        tctx, tables, args.tpch_sf, args.seed, results, times,
        launches_tpch, launches_planner)
    # the serving layer: the bench's serve stage on these tables (views on
    # and off), its mixed read/write stage, and a two-replica fleet
    # (the kernel at the groupby shape timed on each side of them: the
    # serving threads are joined, so the times must agree)
    gb_key = dt.column("orderkey").data
    gb_around = [cuda_ms(lambda: hash_cuda.partition_ids_fused(
        (gb_key,), (None,), 4), 20)]
    launches_serve = phase_serve_tpch(tctx, tables, results, args.tpch_sf)
    launches_serve["mixed"] = phase_serve_mixed(args.seed)
    launches_serve["fleet"] = phase_serve_fleet(ldata)
    gb_around.append(cuda_ms(lambda: hash_cuda.partition_ids_fused(
        (gb_key,), (None,), 4), 20))
    say("kernel at the groupby shape around the serving phases",
        before_ms=f"{gb_around[0]:.4f}", after_ms=f"{gb_around[1]:.4f}")
    del gb_key
    launches_analyze_tpch = phase_tpch_analyze(tctx, tables, args.tpch_sf,
                                               results, times)
    phase_trace_export()
    # the exchange_ms audit and the calibrate / queryprof loop
    phase_meshprobe_audit(tctx, tables, args.tpch_sf, ldata, rdata, want,
                          probed)
    launches_redist.update(phase_redistribution_tpch(tables, args.tpch_sf,
                                                     results, exports))
    launches_spill["ooc_tpch"] = phase_ooc_tpch(tctx, tables, args.tpch_sf)
    del results
    launches_fused = phase_fused_groupby(tables, args.tpch_sf, exports,
                                         args.profile)
    launches_sketch = phase_sketch(tables, args.tpch_sf, exports, args.profile)
    spilled = phase_spilled_operators(tables, args.tpch_sf, exports)
    launches_spill["spilled_fused_final_exchange"] = spilled["fused"]
    launches_spill["spilled_sketch_final_exchange"] = spilled["sketch"]
    launches_state = phase_agg_state(tables, args.tpch_sf, exports)
    launches_stream["q9"] = phase_q9_streaming(tctx, tables, args.tpch_sf,
                                               args.profile)
    launches_multiway = phase_multiway(tables, args.tpch_sf, exports)
    rec_tpch, rec_tpch3 = phase_recovery_tpch(tctx, tables, args.tpch_sf)
    launches_recovery.update({f"tpch_{q}_lost": v for q, v in rec_tpch.items()})
    launches_nparts3.update({f"tpch_{q}_lost": v for q, v in rec_tpch3.items()})
    # sanitizer mode on the 22 queries (before the tables go)
    launches_sanitized_tpch = phase_sanitize_tpch(tctx, tables, args.tpch_sf)
    del tables
    broadcast.clear_replica_cache()
    phase_tpch_worlds(args.tpch_check_sf, args.seed)
    phase_sketch_lanes(args.tpch_check_sf, args.seed)
    exports.finish()
    check(launches_fused["pre-aggregate"] > 0 and launches_fused["shuffle"] > 0
          and launches_sketch > 0,
          "the partition kernel ran on the fused partial exchange, the "
          "fused shuffle and the sketch combine")
    check(launches_spill["staged_spill_shuffle"] > 0
          and launches_spill["morsel_join"] > 0
          and launches_spill["spilled_fused_final_exchange"] > 0,
          "the partition kernel ran on the staged-spill exchange, the "
          "morsel join and the morsel groupby's final exchange")
    check(all(v > 0 for k, v in launches_recovery.items()
              if k not in ("recovery_off", "tpch_q5_lost"))
          and launches_nparts3["lost_4_to_3"] > 0
          and launches_nparts3["tpch_q21_lost"] > 0,
          "the partition kernel ran on every recovery path that hashes, at "
          "nparts 3 after the join cell's and Q21's losses")
    # the host generator's TPC-H tables at SF 1, the join microbench's
    # sides and the carried sort-join plan
    launches_tpch_host = phase_tpch_host(TPCH_HOST_SF, TPCH_HOST_SEED)
    launches_bench_cols = phase_bench_cols()
    carried_joins, carried_ops = phase_carried(args.seed)
    # the one-command gate: all 14 stages of analysis/ci.py on the card
    launches_ci = phase_ci(times, wire, reads,
                           2 * args.rows / inner_times["join_s"], smi_line)
    # the static gates and sanitizer mode: the two linters, the guard and
    # the NaN trap on cuda:0, then the join cell under sanitize
    phase_lint()
    phase_sanitize_guard()
    launches_sanitized, chained_sanitized = phase_sanitize_join(
        ldata, rdata, want)

    # the kernel at the main path's shape: the world-4 partition of one side
    # ([P*cap] rows of one int32 key, no validity, 4 parts)
    cap = next_bucket(-(-args.rows // WORLD), minimum=8)
    k = pad_to(t(ldata["k"]), WORLD * cap)
    k_ms = cuda_ms(lambda: hash_cuda.partition_ids_fused((k,), (None,), 4), 20)
    p_ms = cuda_ms(lambda: plain_hash.partition_ids(
        plain_hash.row_hash((k,), (None,)), 4), 3, warmup=1)
    # and at the raw-shuffle groupby's shape: the int64 orderkey over
    # [P*cap] rows (the shuffle combine hashes the same column of the
    # smaller partial table)
    ok = dt.column("orderkey").data
    gb_ms = cuda_ms(lambda: hash_cuda.partition_ids_fused((ok,), (None,), 4), 20)
    gb_plain = plain_hash.partition_ids(plain_hash.row_hash((ok,), (None,)), 4)
    check(torch.equal(hash_cuda.partition_ids_fused((ok,), (None,), 4), gb_plain),
          "kernel == plain at the groupby shape")
    gb_plain_ms = cuda_ms(lambda: plain_hash.partition_ids(
        plain_hash.row_hash((ok,), (None,)), 4), 3, warmup=1)
    gb_bound = hash_bound_ms((ok,), (None,), ok.shape[0])
    say("kernel at the groupby shape", rows=ok.shape[0], key="int64",
        ms=f"{gb_ms:.4f}", plain_ms=f"{gb_plain_ms:.3f}",
        bound_ms=f"{gb_bound:.4f}", share_of_bound=f"{gb_bound / gb_ms:.3f}")
    # and at the survivor world's shape: the same side re-blocked over 3
    # shards ([3*cap3] rows), nparts 3
    cap3 = next_bucket(-(-args.rows // 3), minimum=8)
    k3 = pad_to(t(ldata["k"]), 3 * cap3)
    got3 = hash_cuda.partition_ids_fused((k3,), (None,), 3)
    plain3 = plain_hash.partition_ids(plain_hash.row_hash((k3,), (None,)), 3)
    err3 = int((got3.long() - plain3.long()).abs().max())
    check(err3 == 0, "kernel == plain at nparts 3")
    del got3, plain3
    n3 = {"rows": int(k3.shape[0]), "nparts": 3, "max_abs_err": err3,
          "ms": cuda_ms(lambda: hash_cuda.partition_ids_fused(
              (k3,), (None,), 3), 20),
          "plain_ms": cuda_ms(lambda: plain_hash.partition_ids(
              plain_hash.row_hash((k3,), (None,)), 3), 3, warmup=1),
          "bound_ms": hash_bound_ms((k3,), (None,), k3.shape[0])}
    say("kernel at the survivor world's shape", rows=n3["rows"], nparts=3,
        ms=f"{n3['ms']:.4f}", plain_ms=f"{n3['plain_ms']:.3f}",
        bound_ms=f"{n3['bound_ms']:.4f}",
        share_of_bound=f"{n3['bound_ms'] / n3['ms']:.3f}")
    kernels = [{
        "name": "partition_hash", "route": "cuda",
        "source": "cylon_tpu_torch/csrc/partition_hash.cu",
        "replaces": "cylon_tpu/ops/hash_pallas.py:64",
        "launches": launches, "launches_analyze": launches_analyze,
        "launches_analyze_tpch": launches_analyze_tpch,
        "launches_setop": launches_setop["union"],
        "launches_compat": launches_compat,
        "launches_groupby": {
            "orderkey_default": launches_gb["default"],
            "orderkey_raw_shuffle": launches_gb["pre_aggregate=False"],
            "orderkey_dense": launches_gb["dense_key_range"],
            "q1": launches_q1, "q6": launches_q6},
        "launches_tpch": launches_tpch,
        "launches_tpch_planner": launches_planner,
        "launches_fused": launches_fused, "launches_sketch": launches_sketch,
        "launches_agg_state": launches_state,
        "launches_streaming": launches_stream,
        "launches_multiway": launches_multiway,
        "launches_redistribution": launches_redist,
        "launches_spill": launches_spill,
        "launches_recovery": launches_recovery,
        "launches_recovery_nparts3": launches_nparts3,
        "launches_multiprocess": launches_mp,
        "launches_multiprocess_tpch": launches_mp_tpch,
        "launches_measured": launches_measured,
        "launches_measured_hier": launches_measured_hier,
        "launches_sanitized": dict(launches_sanitized,
                                   tpch=launches_sanitized_tpch),
        "launches_ci": {k: v["launches"] for k, v in launches_ci.items()},
        "launches_tpch_host": launches_tpch_host,
        "launches_bench_cols": launches_bench_cols,
        "launches_carried": {alg: v["launches"]
                             for alg, v in carried_joins.items()},
        "carried_ops_ms": carried_ops,
        "multiprocess_two_processes_one_card": mp_two,
        "nparts3_shape": n3,
        "groupby_shape": {"rows": int(ok.shape[0]), "ms": gb_ms,
                          "plain_ms": gb_plain_ms, "bound_ms": gb_bound,
                          "ms_around_serving": gb_around},
        "launches_ingest": launches_ingest,
        "launches_append": launches_append,
        "launches_strkey": launches_strkey,
        "launches_wide_setop": launches_wide,
        "launches_serve": launches_serve,
        "launches_pipeline": dict(launches_pipeline,
                                  **launches_join_pipeline),
        "plan_check_launches": 0,
        "plan_check_seconds": plan_check_s,
        "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": hash_bound_ms((k,), (None,), k.shape[0]),
        "bound_by": "bytes", "library_ms": None}, {
        # the kernel's chained entry: more than 16 key columns in groups
        "name": "partition_hash_chained", "route": "cuda",
        "source": "cylon_tpu_torch/csrc/partition_hash.cu",
        "replaces": "cylon_tpu/ops/hash_pallas.py:64",
        "launches": sum(launches_wide.values()),
        "launches_wide_setop": launches_wide,
        "launches_sanitized": chained_sanitized,
        "launches_ci": {k: v["chained"] for k, v in launches_ci.items()},
        "widths": {str(w): v for w, v in wide.items()},
        "max_abs_err": max(v["max_abs_err"] for v in wide.values()),
        "ms": wide[WIDE_SETOP_WIDTH]["ms"],
        "plain_ms": wide[WIDE_SETOP_WIDTH]["plain_ms"],
        "bound_ms": wide[WIDE_SETOP_WIDTH]["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]
    say("host link", d2h_gbps=f"{link['d2h_gbps']:.3f}",
        h2d_gbps=f"{link['h2d_gbps']:.3f}",
        join_cell_ingest_gbps=f"{ingest_gbps:.3f}",
        bound_gbps_per_direction=f"{HOST_LINK_BYTES_PER_S / 1e9:.0f}")
    say("chip_smoke", wall_seconds=f"{time.perf_counter() - T0:.1f}")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
