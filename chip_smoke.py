"""Drive the PyTorch/CUDA engine (cylon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--seed S] [--profile]

Run from the root of a checkout: it builds the partition-hash CUDA kernel
from the checkout's sources, holds it against its plain PyTorch version,
and runs the distributed HASH equi-join end to end (ingest from numpy →
DTable → dist_join → to_table) at world 1 and world 4 on the card, with
16,777,216 rows per side by default in the join benchmark's column shape
(``k`` int32 uniform in [0, 0.99·n), ``v0..v2`` float32).  On the same data
it then runs the SORT join (the default ``JoinConfig``) at world 4,
``dist_sort`` / ``dist_sort_multi`` / ``dist_head``, and the distributed
union / intersect / subtract, each against an oracle that does not use
the engine.  Then, on a table in the shape of TPC-H ``lineitem`` (as many
rows, ``orderkey`` uniform in [0, n/4), 10% null prices), it runs
``dist_groupby`` by ``orderkey`` three ways (pre-aggregated with the
shuffle combine, the raw-row shuffle, the dense-key path), the Q1 shape
(``dist_with_column`` + a six-group ``dist_groupby`` with ``where``, the
broadcast combine) and the Q6 shape (``dist_aggregate`` with ``where``,
``dist_select`` compacting and deferred, then ``dist_groupby``), each
against a numpy oracle on the host.  Every check that fails raises, so
the script exits non-zero; without a CUDA device it exits non-zero before
doing anything.  The last line is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launches on the main path (and
on the groupby paths), its time, its plain version's time and its bound.
``--profile`` adds torch.profiler tables of device time by kernel for the
world-4 HASH and SORT joins, one ``dist_sort``, one ``dist_union``, the
default ``orderkey`` groupby and the Q1 shape.
"""
from __future__ import annotations

import argparse
import json
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


def say(phase: str, **kv) -> None:
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
        res[f"sum_{side}_v0"] = float(c.data.double().sum())
        res[f"bits_{side}_v0"] = int(c.data.view(torch.int32).long().sum())
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
    """Print a torch.profiler table of ``fn()``'s device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    say(f"profile {label}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25),
          flush=True)


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
        nv = int(kc.validity.sum())
        label = f"dist_sort {'asc' if ascending else 'desc'} world={WORLD}"
        times[label] = secs
        say(label, rows=local.num_rows, seconds=f"{secs:.6f}",
            rows_per_s=f"{n / secs:.0f}", kernel_launches=launches,
            shard_rows=list(map(int, out.counts_host())))
        check(local.num_rows == n, f"{label}: every row kept")
        check(launches == 0, f"{label}: no partition-kernel launch")
        check(bits_sum(local.column("v0").data) == want_bits,
              f"{label}: v0 bit checksum exact")
        check(bool(kc.validity[:nv].all()) and nv == len(k_valid),
              f"{label}: nulls last")
        want_k = k_valid if ascending else k_valid[::-1].copy()
        check(np.array_equal(kc.data[:nv].cpu().numpy(), want_k),
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
    got_valid = kc.validity.cpu().numpy()
    check(np.array_equal(got_valid, ~null[order]), "dist_sort_multi: nulls")
    check(np.array_equal(np.where(got_valid, kc.data.cpu().numpy(), 0),
                         np.where(null, 0, ldata["k"])[order]),
          "dist_sort_multi: k == host lexsort")
    check(np.array_equal(local.column("v0").data.cpu().numpy(),
                         ldata["v0"][order]),
          "dist_sort_multi: v0 == host lexsort")
    head, secs = wall(lambda: dist_head(out, 10))
    times["dist_head"] = secs
    check(head.num_rows == 10 and np.array_equal(
        head.column("v0").data.cpu().numpy(), ldata["v0"][order[:10]]),
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
            got = np.sort(ids[s, :int(counts[s])].cpu().numpy())
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
    ctx = CylonContext(device=DEVICE, world=WORLD)
    a = DTable.from_table(ctx, to_table(ctx, ldata, None))
    b = DTable.from_table(ctx, to_table(ctx, bdata, None))
    launches, times = {}, {}
    for name, op in (("union", dist_union), ("intersect", dist_intersect),
                     ("subtract", dist_subtract)):
        hash_cuda.launches = 0
        out, secs = wall(lambda: op(a, b))
        launches[name] = hash_cuda.launches
        times[name] = secs
        rows, bits = want[name]
        local = out.to_table()
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
    return launches, times


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
    data = {c.name: c.data[order].cpu().numpy() for c in local.columns}
    valid = {c.name: c.validity[order].cpu().numpy() for c in local.columns
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
    keys = list(zip(on0.column("returnflag").data.tolist(),
                    on0.column("linestatus").data.tolist()))
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
    got_rev = float(agg.column("sum_rev").data[0])
    got_cnt = int(agg.column("count_quantity").data[0])
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16_777_216)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
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
    launches, _ = phase_inner(WORLD, ldata, rdata, want, args.profile)
    phase_sort_join(ldata, rdata, want, args.profile)
    phase_outer(args.seed)
    phase_hash_partition(ldata)
    phase_dist_sort(ldata, args.seed, args.profile)
    launches_setop, _ = phase_set_ops(ldata, args.seed, args.profile)

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
    kernels = [{
        "name": "partition_hash", "route": "cuda",
        "source": "cylon_tpu_torch/csrc/partition_hash.cu",
        "replaces": "cylon_tpu/ops/hash_pallas.py:64",
        "launches": launches, "launches_setop": launches_setop["union"],
        "launches_groupby": {
            "orderkey_default": launches_gb["default"],
            "orderkey_raw_shuffle": launches_gb["pre_aggregate=False"],
            "orderkey_dense": launches_gb["dense_key_range"],
            "q1": launches_q1, "q6": launches_q6},
        "groupby_shape": {"rows": int(ok.shape[0]), "ms": gb_ms,
                          "plain_ms": gb_plain_ms, "bound_ms": gb_bound},
        "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": hash_bound_ms((k,), (None,), k.shape[0]),
        "bound_by": "bytes", "library_ms": None}]
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
