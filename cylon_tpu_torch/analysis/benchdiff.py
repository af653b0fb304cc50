"""benchdiff — the BENCH-artifact regression gate.

The port of ``cylon_tpu/analysis/benchdiff.py``, with the same gates,
floors, parsing and exit codes: the port's bench emits the JAX bench's
key names, so one artifact reads alike through either gate.

Diffs two bench artifacts (``bench.py``'s incremental JSON lines, or the
bench runner's ``{"tail": ...}`` wrapper around them) and exits non-zero when
a gated metric regressed past the threshold: the bench folds per-query
wall-clock, bytes-moved and planner-decision fields into its artifact,
and this gate is what makes a silent performance regression loud in CI.

Gated metrics (relative threshold, default 15%):

  * ``tpch_<q>_ms``            per-query wall-clock    (higher = worse)
  * ``tpch_<q>_bytes_moved``   per-query exchange bytes (higher = worse)
  * ``tpch_<q>_host_reads``    per-query host round trips (higher = worse)
  * ``tpch_geomean_vs_pandas`` speedup geomean          (lower = worse)
  * ``tpch_<q>_vs_pandas``     per-query speedup        (lower = worse)
  * ``dist_join_rows_per_sec`` headline throughput      (lower = worse)
  * ``tpch_<q>_optimizer_bytes_saved``  bytes the logical planner's
    rewrites keep off the wire vs the eager plan (lower = worse — a
    rewrite rule silently losing its byte savings fails here even when
    total ``bytes_moved`` drifted for other reasons;
    docs/query_planner.md)
  * ``tpch_<q>_exchange_count``  whole exchanges run (shuffle
    dispatches + replica gathers; higher = worse — a planner regression
    that re-splits a fused multiway join back into a binary cascade
    adds whole exchanges and fails here)
  * ``tpch_<q>_exchange_bytes_peak``  largest per-device transient
    priced for one exchange dispatch (higher = worse — a chunked-path
    peak-memory regression, e.g. the fused groupby's fold-by-key
    reverting to concatenation, previously passed CI silently)
  * ``tpch_<q>_groupby_bytes_saved``  groupby-owned exchange bytes the
    fused aggregation exchange keeps off the wire vs the eager tail
    (lower = worse; docs/query_planner.md "groupby pushdown")
  * ``tpch_<q>_strategy_downgrades``  exchanges the costed
    redistribution chooser moved off the single-shot fast path
    (higher = worse — a cost-model regression degrading exchanges that
    used to run single-shot; docs/tpu_perf_notes.md "Choosing the
    collective")
  * ``serve_qps``               mixed-workload serving throughput
    (lower = worse) and ``serve_p99_ms`` tail latency (higher = worse)
    — the serving layer's benchdiff family (docs/serving.md); p50 is
    reported but not gated (the tail is where admission/sharing
    regressions surface first)
  * ``serve_sustain_qps`` (whole-run completed/wall) and
    ``serve_sustain_steady_qps`` (the sampler's warm-up-excluded
    steady-state roll-up) — both lower = worse — plus
    ``serve_sustain_p99_ms`` / ``serve_sustain_p999_ms`` tail latency
    (higher = worse), from the sustained-load stage
    (CYLON_BENCH_SUSTAIN; docs/observability.md "the time-series
    sampler" and "Live telemetry plane")
  * ``serve_mixed_qps`` read throughput of the mixed read/write stage
    (CYLON_BENCH_MIXED; lower = worse),
    ``serve_mixed_view_hit_ratio`` — queries answered by a
    materialized-view hit or delta fold over all reads (lower = worse:
    the ingest path started invalidating views it used to fold) — and
    ``serve_mixed_p99_ms`` read tail latency (higher = worse); the
    measured ``serve_mixed_staleness_ms`` visibility lag is reported
    ungated (docs/serving.md "Materialized subplans")
  * ``tpch_<q>_recompiles``  jit builds inside the TIMED (warm) rep
    (higher = worse — a compile-cache-key regression re-tracing per
    call; the warm-up ``tpch_<q>_compile_ms`` column is reported but
    NOT gated — cold build cost varies with the build caches)
  * ``serve_slo_violations``  deadline misses + sampler anomaly alerts
    of the serving stage (higher = worse; docs/serving.md "deadlines")
  * ``serve_chaos_recovered_ratio``  completed / attempted queries of
    the chaos-under-sustained-load stage (CYLON_BENCH_CHAOS; lower =
    worse — the self-healing ladder stopped healing) and
    ``serve_chaos_p99_ms`` tail latency under chaos (higher = worse);
    the shed count is reported ungated (docs/robustness.md
    "self-healing execution")
  * ``serve_meshchaos_recovered_ratio``  completed / attempted queries
    of the mesh-loss chaos stage (CYLON_BENCH_MESHCHAOS; lower = worse
    — queries stopped surviving the evacuation + re-mesh) and
    ``serve_meshchaos_p99_ms`` tail latency across the degrade (higher
    = worse); the remesh wall-clock ``serve_meshchaos_remesh_ms`` is
    reported ungated (docs/robustness.md "Elasticity")
  * ``tpch_<q>_spill_bytes``  host-tier staging bytes of the timed rep
    (higher = worse — the main stage runs at AMPLE budget, so spilling
    there means the out-of-core machinery engaged when the resident
    path fit; docs/out_of_core.md) and ``tpch_ooc_ok_ratio`` — the
    pinned-budget OOC stage's row-identical fraction of ATTEMPTED
    queries (lower = worse: the spill path stopped answering
    correctly; the ratio form keeps deadline-truncated runs from
    reading as regressions — the absolute ``tpch_ooc_queries_ok``
    count is reported ungated)

A gated metric present in OLD but absent from NEW fails the gate
outright (``MISSING``): a query that crashed or was skipped emits no ms
field, and "went from measured to crashing" must not read as clean.

Everything else numeric is reported in the delta table but never gates
(oracle timings, spreads, env details).  Each gated family also has an
ABSOLUTE floor (``--min-abs-ms`` / ``--min-abs-bytes`` /
``--min-abs-reads``): at the sync floor a 15% swing on a 6 ms query is
scheduler noise, and a relative gate alone would turn ``host_reads``
0→1 into +inf% — sub-floor deltas never fail CI.

CLI::

    python -m cylon_tpu_torch.analysis.benchdiff OLD.json NEW.json
    python -m cylon_tpu_torch.analysis.benchdiff --baseline OLD.json NEW.json \
        --threshold 0.15 --min-abs-ms 2.0

exits 0 when clean, 1 on a regression past threshold, 2 on usage/parse
errors (the graftlint exit contract).

Artifact parsing is tolerant by design: a full JSON artifact line is
preferred, but a runner wrapper whose ``tail`` truncated the line mid-
object still yields every ``"key": number`` pair the text retains (a
timed-out bench run loses the line's HEAD, not its scoring fields —
regex recovery keeps the gate usable on exactly the runs that most need
watching).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_artifact", "diff", "main"]

_NUM_PAIR_RE = re.compile(
    r'"([A-Za-z0-9_.]+)"\s*:\s*(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)')

# gated key patterns → direction ("up" = an increase is the regression)
_GATES: Tuple[Tuple[str, str], ...] = (
    (r"tpch_q\d+_ms$", "up"),
    (r"tpch_q\d+_bytes_moved$", "up"),
    (r"tpch_q\d+_host_reads$", "up"),
    (r"tpch_q\d+_vs_pandas$", "down"),
    (r"tpch_geomean_vs_pandas$", "down"),
    (r"dist_join_rows_per_sec$", "down"),
    (r"tpch_q\d+_optimizer_bytes_saved$", "down"),
    # whole exchanges per query (shuffle dispatches + replica gathers):
    # deterministic small integers, so any increase — e.g. a planner
    # regression re-splitting a fused multiway join back into a binary
    # cascade — clears the relative threshold and fails the gate
    (r"tpch_q\d+_exchange_count$", "up"),
    # peak exchange transient: the chooser's memory bound, gated UP as
    # a first-class family (a regression here previously passed CI
    # silently — only wall-clock and total bytes were gated); covers
    # every lowering since all strategies watermark the same counter
    (r"tpch_q\d+_exchange_bytes_peak$", "up"),
    # exchanges the costed chooser moved off the single-shot fast path
    # (docs/tpu_perf_notes.md "Choosing the collective"): deterministic
    # small integers under a fixed budget, so any increase — a pricing
    # regression degrading exchanges that used to run single-shot —
    # clears the relative threshold and fails the gate
    (r"tpch_q\d+_strategy_downgrades$", "up"),
    # groupby-owned bytes the fused aggregation exchange saves
    (r"tpch_q\d+_groupby_bytes_saved$", "down"),
    # serving family (docs/serving.md): mixed-workload throughput gated
    # DOWN, tail latency gated UP — a regression in admission, sharing
    # or the export overlap shows up in one of these two even when the
    # per-query tpch numbers are unchanged
    (r"serve_qps$", "down"),
    (r"serve_p99_ms$", "up"),
    # sustained-load family (docs/observability.md "the time-series
    # sampler"): minutes-scale traffic, not one batch window — the
    # whole-run throughput AND the sampler's warm-up-excluded steady
    # state both gate DOWN (a steady-state-only leak partially masked
    # by a warm-up improvement fails on the second), sustained tail
    # p99 gates UP (with the ms absolute floor).  A regression that
    # only shows after windows of traffic (cache churn, queue growth,
    # counter-merge contention) fails here even when the short serve
    # stage is clean.
    (r"serve_sustain_qps$", "down"),
    (r"serve_sustain_steady_qps$", "down"),
    (r"serve_sustain_p99_ms$", "up"),
    # extreme-tail latency from the session's mergeable latency
    # histogram (docs/observability.md "Live telemetry plane") — the
    # p999 regresses before the p99 when a small fraction of queries
    # fall off the fast path (breaker probes, recovery ladders)
    (r"serve_sustain_p999_ms$", "up"),
    # mixed read/write family (docs/serving.md "Materialized
    # subplans", CYLON_BENCH_MIXED): one writer appending deltas while
    # 8 readers repeat a foldable aggregation.  Read throughput gates
    # DOWN and the view-served ratio (hits + folds over reads) gates
    # DOWN with the ratio floor — a drop means the ingest path started
    # invalidating views it used to fold, paying full recomputes under
    # churn — while read tail latency gates UP (ms floor).  The
    # measured staleness (p95 ingest submit→applied) is reported
    # UNGATED: it tracks batch-window sizing, not code quality, and
    # the staleness MODEL is what tests pin down.
    (r"serve_mixed_qps$", "down"),
    (r"serve_mixed_view_hit_ratio$", "down"),
    (r"serve_mixed_p99_ms$", "up"),
    # compile tracking (docs/observability.md "compile tracking"):
    # steady-state recompiles per query gate UP — a timed rep is warm,
    # so any recompile there is a cache-key regression (a thrashing
    # size class, an identity-keyed callable rebuilt per call).  The
    # warm-up tpch_<q>_compile_ms column is reported UNGATED: build
    # cost on a cold process varies with the build caches.
    (r"tpch_q\d+_recompiles$", "up"),
    # SLO accounting (docs/serving.md "deadlines"): deadline misses +
    # sampler anomaly alerts of the serving stages — any increase is a
    # tail-latency regression surfacing as violated promises
    (r"serve_slo_violations$", "up"),
    # chaos-under-sustained-load family (docs/robustness.md
    # "self-healing execution", CYLON_BENCH_CHAOS): the recovered-query
    # ratio gates DOWN — fewer queries healing under the same seeded
    # fault plan means the escalation ladder or checkpoint layer
    # regressed — and tail latency UNDER CHAOS gates UP (with the ms
    # floor): recovery that works but stalls the batch pipeline is a
    # regression too.  The shed count is reported ungated (shedding
    # MORE under pressure can be the correct response).
    (r"serve_chaos_recovered_ratio$", "down"),
    (r"serve_chaos_p99_ms$", "up"),
    # mesh-loss chaos family (docs/robustness.md "Elasticity",
    # CYLON_BENCH_MESHCHAOS): a deterministic mid-run device loss under
    # sustained serving — the recovered ratio gates DOWN (queries must
    # keep completing across the evacuation + re-mesh and afterwards
    # on the survivor mesh) and p99 UNDER DEGRADE gates UP (with the
    # ms floor): elasticity that works but stalls the pipeline is a
    # regression too.  The remesh wall-clock is reported ungated (it
    # scales with data volume, not code quality).
    (r"serve_meshchaos_recovered_ratio$", "down"),
    (r"serve_meshchaos_p99_ms$", "up"),
    # the scale-UP half of the same profile: after the mid-run rejoin
    # the restored steady QPS over the pre-loss steady QPS gates DOWN
    # (with the ratio floor — a couple of queries' jitter on a ~1.0
    # baseline is noise): a fleet that "recovers" into a permanently
    # slower steady state regressed its elasticity even when every
    # query completed.  The scale-up wall-clock itself is reported
    # ungated (it scales with resident data volume, not code quality).
    (r"serve_meshchaos_restored_qps_ratio$", "down"),
    # out-of-core family (docs/out_of_core.md): the main TPC-H stage
    # runs at AMPLE budget, so per-query spill bytes must stay 0 —
    # spilling when memory is ample means the morsel pricing or the
    # chooser's host tier fired when the resident path fit, paying
    # PCIe round trips for nothing (gated UP; the byte floor keeps a
    # trivial staging blip from failing CI).  The OOC stage's
    # queries-ok count gates DOWN: a pinned-budget query that stops
    # completing row-identically through the spill path is the
    # out-of-core capability regressing outright.
    (r"tpch_q\d+_spill_bytes$", "up"),
    # the RATIO form (ok / attempted) gates, not the absolute count: a
    # deadline-truncated run attempts fewer queries and must not read
    # as a regression, while a query that ran and diverged still drags
    # the ratio down (the absolute count is reported ungated)
    (r"tpch_ooc_ok_ratio$", "down"),
    # scaling-curve family (docs/tpu_perf_notes.md "Hierarchical
    # collectives", CYLON_BENCH_SCALING): the fitted weak-scaling
    # efficiency slope gates DOWN — a steeper per-device-throughput
    # decay as the world grows means the exchange layer (chooser,
    # hierarchical lowerings, per-edge pricing) lost parallel
    # efficiency even when the single-world numbers look fine
    (r"^scaling_efficiency_slope$", "down"),
    # per-world-size slow-axis wire bytes gate UP (with the byte
    # floor): deterministic priced bytes under a fixed seed, so an
    # increase means a lowering regression started shipping more
    # payload across the expensive edge at that world size
    (r"scaling_.*_wire_bytes_slow(_w\d+)?$", "up"),
)


def _gate_direction(key: str) -> Optional[str]:
    for pat, direction in _GATES:
        if re.search(pat, key):
            return direction
    return None


def _flatten(obj: dict) -> Dict[str, float]:
    """One bench artifact object → flat {key: number} (headline value
    keyed under its metric name; detail fields keyed as-is)."""
    out: Dict[str, float] = {}
    metric = obj.get("metric")
    if isinstance(metric, str) and isinstance(obj.get("value"),
                                              (int, float)):
        out[metric] = float(obj["value"])
    detail = obj.get("detail", obj)
    if isinstance(detail, dict):
        for k, v in detail.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = float(v)
    return out


def _scrape(text: str) -> Dict[str, float]:
    """Last-resort recovery: every ``"key": number`` pair in the text
    (later occurrences win — the bench re-emits refined lines)."""
    out: Dict[str, float] = {}
    for k, v in _NUM_PAIR_RE.findall(text):
        try:
            out[k] = float(v)
        except ValueError:
            continue
    return out


def load_artifact(path: str) -> Dict[str, float]:
    """Read one BENCH artifact file into a flat numeric dict.

    Accepts (a) bench.py stdout — one or more incremental JSON lines,
    the LAST parseable one wins; (b) one artifact object; (c) the
    runner wrapper ``{"cmd", "rc", "tail", "parsed"}`` — ``parsed``
    when present, else the tail's last full line, else regex-scraped
    pairs from whatever survived truncation.  Raises ValueError when
    nothing numeric is recoverable."""
    with open(path) as f:
        text = f.read()
    best: Optional[Dict[str, float]] = None
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if isinstance(obj, dict):
        if "tail" in obj or "parsed" in obj:  # runner wrapper
            parsed = obj.get("parsed")
            if isinstance(parsed, dict):
                best = _flatten(parsed)
            else:
                text = str(obj.get("tail", ""))
        else:
            best = _flatten(obj)
    if best is None:
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                cand = json.loads(line)
            except ValueError:
                continue
            if isinstance(cand, dict) and ("metric" in cand
                                           or "detail" in cand):
                best = _flatten(cand)
    if not best:
        best = _scrape(text)
    if not best:
        raise ValueError(f"{path}: no bench artifact fields found")
    return best


def diff(old: Dict[str, float], new: Dict[str, float],
         threshold: float = 0.15, min_abs_ms: float = 1.0,
         min_abs_bytes: float = 65536.0, min_abs_reads: float = 2.0
         ) -> Tuple[List[dict], List[dict]]:
    """Compare two flat artifacts.  Returns ``(rows, regressions)``:
    ``rows`` is every changed shared key (sorted worst regression
    first), ``regressions`` the gated subset past ``threshold``.

    Each gated family carries an ABSOLUTE floor besides the relative
    threshold — a relative gate alone is unusable at small baselines
    (``host_reads`` 0→1 is +inf%, a few bytes on an empty-exchange query
    likewise): ``min_abs_ms`` for wall-clock, ``min_abs_bytes`` for
    exchange volume, ``min_abs_reads`` for host round trips."""
    rows: List[dict] = []
    # a gated metric that DISAPPEARED is the worst regression there is —
    # the query went from measured to crashed/skipped (bench.py emits
    # tpch_<q>_error and omits the ms field).  Shared-key diffing alone
    # would wave exactly that through as "clean".
    for key in sorted(set(old) - set(new)):
        if _gate_direction(key) is not None:
            rows.append({"key": key, "old": old[key], "new": None,
                         "rel": float("inf"), "worse": float("inf"),
                         "gated": True})
    for key in sorted(set(old) & set(new)):
        o, n = old[key], new[key]
        if o == n:
            continue
        rel = (n - o) / abs(o) if o else float("inf")
        direction = _gate_direction(key)
        # signed severity: positive = worse (direction-aware)
        worse = rel if direction == "up" else (-rel if direction == "down"
                                               else 0.0)
        gated = direction is not None
        if gated:  # sub-floor deltas are noise, not signal
            floor = (min_abs_ms if key.endswith("_ms")
                     else min_abs_bytes if (key.endswith(("_bytes_moved",
                                                          "_bytes_saved",
                                                          "_bytes_peak",
                                                          "_spill_bytes"))
                                            # scaling family: the
                                            # per-world slow-axis wire
                                            # bytes carry the byte floor
                                            or "_wire_bytes_slow"
                                            in key)
                     else min_abs_reads if key.endswith("_host_reads")
                     # ratio family (recovered ratio): a couple of
                     # queries' worth of jitter on a near-1.0 baseline
                     # must not fail CI
                     else 0.02 if key.endswith("_ratio")
                     # efficiency slope: an absolute quantity near 0 —
                     # the relative gate alone would flag noise
                     else 0.02 if key.endswith("_slope")
                     else 0.0)
            if abs(n - o) < floor:
                gated = False
        rows.append({"key": key, "old": o, "new": n, "rel": rel,
                     "worse": worse, "gated": gated})
    rows.sort(key=lambda r: -r["worse"])
    regressions = [r for r in rows if r["gated"] and r["worse"] > threshold]
    return rows, regressions


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.3f}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.analysis.benchdiff",
        description="diff two BENCH artifacts; exit 1 past the "
                    "regression threshold")
    ap.add_argument("artifacts", nargs="*",
                    help="OLD.json NEW.json (or just NEW.json with "
                         "--baseline)")
    ap.add_argument("--baseline", help="baseline artifact (the OLD side)")
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="relative regression threshold (default 0.15)")
    ap.add_argument("--min-abs-ms", type=float, default=1.0,
                    help="ignore ms deltas smaller than this (default 1.0)")
    ap.add_argument("--min-abs-bytes", type=float, default=65536.0,
                    help="ignore bytes_moved deltas smaller than this "
                         "(default 65536)")
    ap.add_argument("--min-abs-reads", type=float, default=2.0,
                    help="ignore host_reads deltas smaller than this "
                         "(default 2)")
    args = ap.parse_args(argv)
    paths = ([args.baseline] if args.baseline else []) + args.artifacts
    if len(paths) != 2:
        print("benchdiff: need exactly OLD and NEW artifacts",
              file=sys.stderr)
        return 2
    try:
        old = load_artifact(paths[0])
        new = load_artifact(paths[1])
    except (OSError, ValueError) as e:
        print(f"benchdiff: {e}", file=sys.stderr)
        return 2
    rows, regressions = diff(old, new, args.threshold, args.min_abs_ms,
                             args.min_abs_bytes, args.min_abs_reads)
    if not rows:
        print(f"benchdiff: no changed metrics "
              f"({len(set(old) & set(new))} shared keys identical)")
        return 0
    w = max(len(r["key"]) for r in rows)
    print(f"{'metric':<{w}}  {'old':>14}  {'new':>14}  {'delta':>8}  gate")
    for r in rows:
        flag = ""
        if r["gated"]:
            flag = ("MISSING" if r["new"] is None else
                    "REGRESSED" if r in regressions else
                    "ok" if r["worse"] <= 0 else "within-threshold")
        new_s = "—" if r["new"] is None else _fmt(r["new"])
        print(f"{r['key']:<{w}}  {_fmt(r['old']):>14}  "
              f"{new_s:>14}  {r['rel']:>+7.1%}  {flag}")
    if regressions:
        print(f"\nbenchdiff: {len(regressions)} metric(s) regressed past "
              f"{args.threshold:.0%}", file=sys.stderr)
        return 1
    print(f"\nbenchdiff: clean ({len(rows)} changed, none past "
          f"{args.threshold:.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
