"""ci — the one-command static-analysis + smoke gate of the port.

The port of ``cylon_tpu/analysis/ci.py``: the same 14 stages in the same
order and numbering, the same ``--no-<stage>`` flags and the same exit
contract, over the port's own entry points::

    python -m cylon_tpu_torch.analysis.ci                  # on the card
    python -m cylon_tpu_torch.analysis.ci --device cpu     # on the CPU
    python -m cylon_tpu_torch.analysis.ci --baseline OLD.json NEW.json
    python -m cylon_tpu_torch.analysis.ci --no-plan-check --no-serve-smoke

Every stage builds ``CylonContext(device=--device, world=--world)``: the
card by default (no fallback to the CPU), world 8 by default — the
counterpart of the reference's 8-device mesh and of the hierarchy
stage's (2, 4) mesh.  The stages that need a mesh skip only when
``--world`` is below their bound (2 for the mesh-loss and mesh-grow
stages, 8 for the hierarchy stage).

Stages:

  1. **graftlint** over ``cylon_tpu_torch/`` and ``chip_smoke.py``
     (resolved from the package location, so the command works from any
     cwd);
  2. **plan_check pre-flight**: every TPC-H query checked on meta
     tensors through ``plan_check.validate`` against a small generated
     dataset — twice when the optimizer is enabled (the eager plan AND
     the optimized plan through ``plan.run``); a query that crashes
     outside the validator counts as a finding (``--tpch-sf`` scales
     the dataset; ``--no-plan-check`` skips);
  3. **serving smoke**: concurrent TPC-H queries through
     ``cylon_tpu_torch/serve`` must return results row-identical to
     serial execution AND share at least one cross-query subplan
     (``serve.subplan_shared >= 1``) beyond the scan / projection tier
     (``--no-serve-smoke`` skips);
  4. **telemetry smoke**: a short served mini-run with the time-series
     sampler, span tracing, the mesh probe and the run-stats store live
     — the sampler retains samples, every counter / gauge the run bumped
     is catalogued, the Chrome export is valid JSON with one track per
     query trace id, and the stats store holds per-node observations
     (``--no-telemetry-smoke`` skips);
  5. **doctor smoke**: a permanent fault in ONE served query fails onto
     its own handle, its batch peers stay row-identical with clean
     counter slices, a flight-recorder bundle is written and
     ``observe.doctor.main`` renders it (``--no-doctor-smoke`` skips);
  6. **chaos-recovery smoke**: a transient at the second exchange
     boundary of ONE served two-stage query — the victim recovers
     row-identical with ``recover.stage_retries`` in its own counter
     slice and fewer stages replayed than the plan has; peers stay
     clean; doctor renders the ladder's events (``--no-chaos-smoke``
     skips);
  7. **out-of-core smoke**: Q1 at a pinned 200 KiB device budget — the
     planner inserts a morsel scan (``spill.morsels >= 2``), the result
     is row-identical to the resident run and the priced exchange peak
     stays within the budget (``--no-ooc-smoke`` skips);
  8. **mesh-loss chaos smoke**: ``mesh.device_lost`` at the second
     boundary of ONE served two-stage query — the victim recovers
     row-identical on the survivor slots (``recover.remesh`` in its own
     slice), peers and a post-degrade query stay clean, the session
     flips degraded and doctor renders ``mesh_degraded``
     (``--no-mesh-smoke`` skips; skipped below world 2);
  9. **mesh-grow chaos smoke**: ``mesh.device_lost`` then
     ``mesh.device_joined`` — the next query takes the rejoin mid-plan
     (``recover.scaleups`` in its slice), the session un-degrades
     (``mesh_expanded``), a follow-up runs on the restored world and
     doctor renders the scale-up timeline (``--no-scaleup-smoke``
     skips; skipped below world 2);
 10. **hierarchy smoke**: world 8 under ``set_mesh_shape((2, 4))`` and
     the measured cost model with a synthetic per-edge profile — the
     chooser SELECTS the hierarchical lowering for a skewed
     cross-slow-axis shuffle, row-identical to single-shot with
     strictly fewer slow-axis wire bytes; the forced hierarchical leg
     and the forced hierarchical-combine leg of ``dist_groupby_fused``
     hold parity, the pre-combine moving one partial per group across
     the slow axis (``--no-hierarchy-smoke`` skips; skipped below
     world 8);
 11. **concurrency smoke**: lockcheck holds the tree at zero findings,
     an AB/BA lock-order inversion is caught as a typed
     ``LockOrderViolation`` under enforcement before any thread blocks,
     and an 8-client serving window runs green with enforcement on
     (``--no-lockcheck-smoke`` skips);
 12. **export smoke**: the OpenMetrics endpoint on an ephemeral loopback
     port, scraped over HTTP — every family maps to a catalogued metric
     of the matching kind, the latency histogram has its +Inf bucket,
     the config-fingerprint info metric is present; the JSON-lines
     event log holds a seeded deadline miss; tail sampling keeps the
     missed query's spans and drops a fast peer's
     (``--no-export-smoke`` skips);
 13. **matview smoke**: a repeated aggregation is served from the view
     with strictly fewer exchanges, an ``ingest`` append FOLDS into it
     with row parity against a cold recompute, and with the
     ``matview.fold`` fault armed the fold degrades to a full recompute,
     still row-identical (``--no-matview-smoke`` skips);
 14. **benchdiff** (only when ``--baseline`` and a candidate artifact
     are given): the bench regression gate (``analysis/benchdiff.py``).

A stage whose set-up raises exits 2; a finding exits 1.  The exit code
is the worst across stages: 0 clean, 1 findings / regressions / plan
errors, 2 usage or tooling errors.  Each stage restores in ``finally``
every process-wide setting it changes (config knobs,
``CYLON_FLIGHTREC_DIR``, the trace switches, the mesh-probe profiles,
the installed fault plan, the chunk state) and closes its session.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional

__all__ = ["main"]


def _repo_paths() -> List[str]:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg)
    paths = [pkg]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append(smoke)
    return paths


def _trace_switches() -> tuple:
    """The trace switches as set now: (span recording, counter-only
    mode), the latter apart from the former."""
    from .. import trace
    return trace.enabled(), trace._counters_enabled


def _restore_trace(saved: tuple) -> None:
    """Put the trace switches back as :func:`_trace_switches` read them
    (a stage that turned them on must not leave them on for the next
    stage or an embedding caller) and drop the stage's records."""
    from .. import trace
    spans, counters = saved
    (trace.enable if spans else trace.disable)()
    (trace.enable_counters if counters else trace.disable_counters)()
    trace.reset()


def _probe_profiles() -> dict:
    """The mesh-probe profiles cached now, by fingerprint."""
    from ..parallel import meshprobe
    with meshprobe._lock:
        return dict(meshprobe._profiles)


def _restore_profiles(saved: dict) -> None:
    """Forget the profiles a stage probed or installed and put back the
    ones cached before it."""
    from ..parallel import meshprobe
    meshprobe.clear_profiles()
    for prof in saved.values():
        meshprobe.put_profile(prof)


def _ingest(ctx, data) -> dict:
    """Each frame of ``data`` (table name → pandas frame) as a DTable of
    ``ctx``, through ``DTable.from_pandas``."""
    from ..parallel.dtable import DTable
    return {name: DTable.from_pandas(ctx, df) for name, df in data.items()}


def _stage_lint() -> int:
    from . import graftlint
    print("== ci stage 1/14: graftlint ==")
    rc = graftlint.main(_repo_paths())
    print(f"graftlint: exit {rc}")
    return rc


def _stage_plan_check(sf: float, device, world: int) -> int:
    print("== ci stage 2/14: plan_check pre-flight ==")
    t0 = time.perf_counter()
    try:
        from .. import plan as planner
        from ..config import optimizer_enabled
        from ..context import CylonContext
        from ..tpch import generate
        from ..tpch.queries import QUERIES
        from . import plan_check

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=7))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing (no card, broken install) is a TOOLING
        # error, not a plan finding: report it as exit 2, never crash CI
        print(f"plan_check pre-flight: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    run_optimized = optimizer_enabled()
    for name in sorted(QUERIES):
        qfn = QUERIES[name]
        forms = [("eager", lambda t, q=qfn: q(ctx, t))]
        if run_optimized:
            forms.append(("optimized",
                          lambda t, q=qfn: planner.run(
                              ctx, lambda tt: q(ctx, tt), t)))
        for label, op in forms:
            try:
                plan_check.validate(op, dts, concrete=("nation", "region"))
            except plan_check.PlanValidationError as e:
                print(f"plan_check: {name} [{label}] INVALID: "
                      f"{str(e)[:300]}", file=sys.stderr)
                bad += 1
            except Exception as e:  # graftlint: ok[broad-except] — a
                # query crashing OUTSIDE the validator (capture bug,
                # CylonError from a bad column ref) is still a finding:
                # count it and keep the 0/1/2 exit contract + the
                # aggregated summary line instead of dying with a
                # traceback and skipping the remaining stages
                print(f"plan_check: {name} [{label}] RAISED: "
                      f"{type(e).__name__}: {str(e)[:300]}",
                      file=sys.stderr)
                bad += 1
    n = len(QUERIES) * (2 if run_optimized else 1)
    print(f"plan_check: {n - bad}/{n} plans valid "
          f"({time.perf_counter() - t0:.1f}s, sf={sf}"
          f"{', optimizer on' if run_optimized else ''})")
    return 1 if bad else 0


def _stage_serve_smoke(sf: float, device, world: int) -> int:
    """A small mixed serving workload: 3 client threads × 2 TPC-H
    queries (q1 twice, q6 once) through one batch window — results must
    match serial execution row-for-row and at least ONE cross-query
    subplan must have been served from the shared memo."""
    print("== ci stage 3/14: serving smoke ==")
    t0 = time.perf_counter()
    try:
        import threading

        from .. import plan as planner
        from ..context import CylonContext
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=7))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the plan_check stage above
        print(f"serving smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    try:
        mix = [("q1", QUERIES["q1"]), ("q6", QUERIES["q6"]),
               ("q1", QUERIES["q1"])]   # the repeat is the share seed
        serial = {}
        for name, qfn in mix:
            if name not in serial:
                serial[name] = planner.run(
                    ctx, lambda t, q=qfn: q(ctx, t), dts).to_pandas()
        with ServeSession(ctx, tables=dts, batch_window_ms=50.0) as s:
            handles = []

            def client(qfn, label):
                handles.append(s.submit(
                    lambda t, q=qfn: q(ctx, t), label=label,
                    export=lambda r: r.to_pandas()))

            threads = [threading.Thread(target=client, args=(q, n))
                       for n, q in mix]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            results = [(h.label, h.result(timeout=600)) for h in handles]
            stats = s.stats()
        import numpy as np
        import pandas as pd

        def canon(df):
            out = df.copy()
            for c in out.columns:
                if isinstance(out[c].dtype, pd.CategoricalDtype):
                    out[c] = out[c].astype(str)
            return out.sort_values(list(out.columns)) \
                .reset_index(drop=True)

        for label, got in results:
            g, w = canon(got), canon(serial[label])
            same = list(g.columns) == list(w.columns) and len(g) == len(w)
            if same:
                for c in g.columns:
                    if pd.api.types.is_float_dtype(w[c]):
                        # the suite's rowset tolerance (an rtol-only
                        # compare flakes on near-zero aggregates)
                        same = bool(np.allclose(
                            g[c].to_numpy(np.float64),
                            w[c].to_numpy(np.float64),
                            rtol=1e-4, atol=1e-6))
                    else:
                        same = g[c].astype(str).tolist() \
                            == w[c].astype(str).tolist()
                    if not same:
                        break
            if not same:
                print(f"serving smoke: {label} result DIVERGED from "
                      "serial execution", file=sys.stderr)
                bad += 1
        if stats["subplan_shared"] < 1:
            print("serving smoke: no cross-query subplan was shared "
                  "(serve.subplan_shared floor is 1) — the sharing "
                  "machinery degraded to execute-everything",
                  file=sys.stderr)
            bad += 1
        # the floor must not be satisfiable by scan/metadata hits
        # alone: the repeated q1 shares its whole chain (lru_cached
        # predicate factories keep node identities stable), so demand
        # at least one shared OPERATOR beyond the free prefix tier
        shared_ops = {op for h in handles for op in h.shared_subplans}
        if not (shared_ops - {"scan", "dist_project", "rename"}):
            print("serving smoke: only scan/projection prefixes were "
                  f"shared ({sorted(shared_ops)}) — exchange-level "
                  "sharing degraded", file=sys.stderr)
            bad += 1
        if stats["failed"]:
            print(f"serving smoke: {stats['failed']} quer(ies) failed",
                  file=sys.stderr)
            bad += 1
        p50 = stats["p50_ms"]   # None when nothing completed
        print(f"serving smoke: {len(results)} queries, "
              f"{stats['subplan_shared']} shared subplans, "
              f"p50={'n/a' if p50 is None else f'{p50:.0f} ms'} "
              f"({time.perf_counter() - t0:.1f}s, sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"serving smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    return 1 if bad else 0


def _stage_telemetry_smoke(sf: float, device, world: int) -> int:
    """A short sustained mini-run with the full telemetry stack live
    (docs/observability.md): a few concurrent TPC-H queries through the
    serving layer under span tracing, the time-series sampler, the mesh
    bandwidth probe and the run-stats store — then assert the telemetry
    CONTRACTS rather than the numbers: sampler non-empty, catalogue
    compliance, export validity (one track per query trace id), stats
    store populated with per-node observations."""
    print("== ci stage 4/14: telemetry smoke ==")
    t0 = time.perf_counter()
    try:
        import json
        import threading

        from .. import observe, trace
        from ..context import CylonContext
        from ..parallel import meshprobe
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=7))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the stages above
        print(f"telemetry smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    saved_trace, saved_profiles = _trace_switches(), _probe_profiles()
    try:
        profile = meshprobe.probe(ctx, sizes=(1 << 11, 1 << 13), reps=1)
        # NOTE: the smoke must NOT clear the global stats store — with
        # CYLON_STATS_PATH set, a cleared store's next flush would
        # rewrite the user's persisted records away.  The assertions
        # below check the digests THIS run produced instead.
        # the ANALYZE rep runs FIRST (it resets trace state as part of
        # its measurement contract — running it after the serve window
        # would wipe the spans the export check below asserts on); it
        # feeds per-node observations into the stats store
        anchor = dts["lineitem"]
        rep = anchor.explain(lambda t, q=QUERIES["q1"]: q(ctx, t),
                             tables=dts, analyze=True, optimize=True)
        if not rep.ok or not rep.stats_digests:
            print("telemetry smoke: ANALYZE run failed or recorded no "
                  "plan fingerprint", file=sys.stderr)
            bad += 1
        trace.enable()
        trace.reset()
        mix = ["q1", "q6", "q1", "q6"]
        with ServeSession(ctx, tables=dts, batch_window_ms=40.0) as s:
            sampler = observe.TimeSeriesSampler(period_s=0.05,
                                                capacity=256, session=s)
            with sampler:
                handles = []
                lock = threading.Lock()

                def client(qname):
                    h = s.submit(lambda t, q=QUERIES[qname]: q(ctx, t),
                                 label=qname,
                                 export=lambda r: r.to_pandas())
                    with lock:
                        handles.append(h)

                threads = [threading.Thread(target=client, args=(q,))
                           for q in mix]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                for h in handles:
                    h.result(timeout=600)
        if not sampler.samples():
            print("telemetry smoke: sampler retained no samples",
                  file=sys.stderr)
            bad += 1
        snap = trace.snapshot()
        unknown = (set(snap["counters"]) | set(snap["gauges"])) \
            - set(observe.METRICS)
        if unknown:
            print(f"telemetry smoke: uncatalogued metrics "
                  f"{sorted(unknown)}", file=sys.stderr)
            bad += 1
        doc = trace.export_chrome_trace(None)
        json.loads(json.dumps(doc))  # valid JSON round trip
        tracks = {e["args"]["name"] for e in doc["traceEvents"]
                  if e.get("ph") == "M"}
        want = {f"query {h.trace_id}" for h in handles}
        if not want <= tracks:
            print(f"telemetry smoke: missing query tracks "
                  f"{sorted(want - tracks)}", file=sys.stderr)
            bad += 1
        fps = observe.STATS_STORE.fingerprints()
        with_nodes = [d for d in getattr(rep, "stats_digests", [])
                      if (observe.STATS_STORE.get(d) or {}).get("nodes")]
        if not with_nodes:
            print("telemetry smoke: stats store holds no per-node "
                  "observations for this run's fingerprints",
                  file=sys.stderr)
            bad += 1
        print(f"telemetry smoke: {len(handles)} queries, "
              f"{len(sampler.samples())} samples, "
              f"{len(fps)} stats fingerprint(s), "
              f"profile [{profile.describe()}] "
              f"({time.perf_counter() - t0:.1f}s, sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"telemetry smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        # span tracing was enabled for the export check — a crash
        # anywhere above must not leave it on for the benchdiff stage
        # (or an embedding caller) to accumulate spans unboundedly; the
        # probe's profile must not steer a measured ranking later
        _restore_trace(saved_trace)
        _restore_profiles(saved_profiles)
    return 1 if bad else 0


def _stage_doctor_smoke(sf: float, device, world: int) -> int:
    """Inject a permanent fault into one served query and assert the
    post-mortem machinery end to end: the victim fails onto its own
    handle, peers stay row-identical to serial execution, a
    flight-recorder bundle lands on disk, and doctor renders it."""
    print("== ci stage 5/14: doctor smoke ==")
    t0 = time.perf_counter()
    try:
        import tempfile

        from .. import faults, plan as planner
        from ..context import CylonContext
        from ..observe import doctor, flightrec
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=7))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the stages above
        print(f"doctor smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    prev_dir = os.environ.get("CYLON_FLIGHTREC_DIR")
    tmpdir = tempfile.mkdtemp(prefix="cylon-doctor-")
    os.environ["CYLON_FLIGHTREC_DIR"] = tmpdir
    try:
        from ..parallel import dist_groupby, shuffle_table

        def victim_op(t):
            # an explicit shuffle forces the two-phase count protocol —
            # the host read the permanent fault below is injected at
            # (a tiny TPC-H q1 can plan around every blocking read)
            return dist_groupby(
                shuffle_table(t["lineitem"], ["l_orderkey"]),
                ["l_orderkey"], [("l_quantity", "sum")])

        serial = planner.run(
            ctx, lambda t, q=QUERIES["q6"]: q(ctx, t), dts).to_pandas()
        plan = faults.FaultPlan(seed=0, rules=[
            faults.FaultRule("compact.read_counts", kind="permanent",
                             once=True)])
        # the auto-dump cap is per process: earlier failures in a long
        # process (a test run, an embedding caller) must not leave the
        # victim's bundle suppressed
        flightrec.clear()
        with faults.active(plan), \
                ServeSession(ctx, tables=dts, batch_window_ms=30.0) as s:
            # the victim submits FIRST and executes first (the
            # dispatcher runs a window in arrival order), so the
            # once-rule's permanent fault lands on it, not the peers
            victim = s.submit(victim_op, label="victim")
            peers = [s.submit(lambda t, q=QUERIES["q6"]: q(ctx, t),
                              label=f"peer{i}",
                              export=lambda r: r.to_pandas())
                     for i in range(2)]
            try:
                victim.result(timeout=600)
                print("doctor smoke: the injected permanent fault did "
                      "not surface on the victim", file=sys.stderr)
                bad += 1
            except faults.PermanentFault:
                pass
            peer_results = [h.result(timeout=600) for h in peers]
        for h, got in zip(peers, peer_results):
            if not got.sort_values(list(got.columns))\
                    .reset_index(drop=True).equals(
                        serial.sort_values(list(serial.columns))
                        .reset_index(drop=True)):
                print(f"doctor smoke: {h.label} diverged from serial "
                      "execution", file=sys.stderr)
                bad += 1
            if h.counters.get("fault.injected", 0):
                print(f"doctor smoke: {h.label}'s counter slice shows "
                      "the victim's fault — attribution leaked",
                      file=sys.stderr)
                bad += 1
        bundles = sorted(f for f in os.listdir(tmpdir)
                         if f.startswith("flightrec-"))
        if not bundles:
            print("doctor smoke: no flight-recorder bundle was written",
                  file=sys.stderr)
            bad += 1
        else:
            rc = doctor.main([os.path.join(tmpdir, bundles[-1])])
            if rc != 0:
                print(f"doctor smoke: doctor exited {rc} on the bundle",
                      file=sys.stderr)
                bad += 1
        print(f"doctor smoke: victim failed in isolation, "
              f"{len(peers)} peers clean, {len(bundles)} bundle(s) "
              f"({time.perf_counter() - t0:.1f}s, sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"doctor smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        if prev_dir is None:
            os.environ.pop("CYLON_FLIGHTREC_DIR", None)
        else:
            os.environ["CYLON_FLIGHTREC_DIR"] = prev_dir
    return 1 if bad else 0


def _stage_chaos_smoke(sf: float, device, world: int) -> int:
    """Inject a deterministic mid-query transient at an exchange
    boundary of one served query and assert the self-healing machinery
    end to end: the victim RECOVERS (row parity, its own counter slice
    shows the ladder's stage retry with fewer stages replayed than the
    plan has), peers complete untouched, and the flight-recorder
    bundle doctor renders shows the ladder's events."""
    print("== ci stage 6/14: chaos-recovery smoke ==")
    t0 = time.perf_counter()
    try:
        import tempfile

        from .. import faults, plan as planner
        from ..context import CylonContext
        from ..observe import doctor, flightrec
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=7))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the stages above
        print(f"chaos smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    saved_trace = _trace_switches()
    prev_dir = os.environ.get("CYLON_FLIGHTREC_DIR")
    tmpdir = tempfile.mkdtemp(prefix="cylon-chaos-")
    os.environ["CYLON_FLIGHTREC_DIR"] = tmpdir
    try:
        from ..config import JoinConfig
        from ..parallel import dist_groupby, dist_join

        li = dts["lineitem"].column_names.index("l_orderkey")
        oi = dts["orders"].column_names.index("o_orderkey")

        def victim_op(t):
            # two exchange stages the planner cannot fuse into one
            # (join, then groupby over the join output): the nth=2
            # transient below lands at the SECOND stage boundary, after
            # stage 1's result was checkpointed — which is what makes
            # "resume from checkpoint, replay < total stages"
            # assertable
            j = dist_join(t["lineitem"], t["orders"],
                          JoinConfig.InnerJoin(li, oi))
            return dist_groupby(j, ["lt-l_orderkey"],
                                [("lt-l_quantity", "sum")])

        serial = planner.run(ctx, victim_op, dts).to_table().to_pandas()
        q6 = QUERIES["q6"]
        serial_peer = planner.run(
            ctx, lambda t: q6(ctx, t), dts).to_pandas()
        plan = faults.FaultPlan(seed=0, rules=[
            faults.FaultRule("exec.stage", kind="transient", nth=2)])
        flightrec.clear()
        # counter-only mode: the per-query slices the assertions below
        # read (handle.counters) attribute through the registry, which
        # records nothing while counters are off
        from .. import trace as _trace
        _trace.enable_counters()
        _trace.reset()
        with faults.active(plan), \
                ServeSession(ctx, tables=dts, batch_window_ms=30.0) as s:
            # the victim submits FIRST and executes first (the window
            # runs in arrival order), so its second exchange stage is
            # the plan-wide second exec.stage consult — the nth=2
            # transient hits the victim mid-query, after stage 1
            # already checkpointed
            victim = s.submit(victim_op, label="victim")
            peers = [s.submit(lambda t, q=q6: q(ctx, t),
                              label=f"peer{i}",
                              export=lambda r: r.to_pandas())
                     for i in range(2)]
            got = victim.result(timeout=600).to_table().to_pandas()
            peer_results = [h.result(timeout=600) for h in peers]
        stages = 2
        if not got.sort_values(list(got.columns))\
                .reset_index(drop=True).equals(
                    serial.sort_values(list(serial.columns))
                    .reset_index(drop=True)):
            print("chaos smoke: the recovered victim DIVERGED from "
                  "serial execution", file=sys.stderr)
            bad += 1
        vc = victim.counters
        if not vc.get("recover.stage_retries", 0):
            print("chaos smoke: the victim's counter slice shows no "
                  "ladder stage retry — the fault did not exercise "
                  "recovery", file=sys.stderr)
            bad += 1
        if vc.get("recover.stages_replayed", 0) >= stages:
            print(f"chaos smoke: recovery replayed "
                  f"{vc.get('recover.stages_replayed')} stages of a "
                  f"{stages}-stage plan — the checkpoint resume did "
                  "not bound the replay", file=sys.stderr)
            bad += 1
        for h, gotp in zip(peers, peer_results):
            if not gotp.sort_values(list(gotp.columns))\
                    .reset_index(drop=True).equals(
                        serial_peer.sort_values(
                            list(serial_peer.columns))
                        .reset_index(drop=True)):
                print(f"chaos smoke: {h.label} diverged from serial "
                      "execution", file=sys.stderr)
                bad += 1
            if h.counters.get("fault.injected", 0) \
                    or h.counters.get("recover.stage_retries", 0):
                print(f"chaos smoke: {h.label}'s counter slice shows "
                      "the victim's fault/recovery — attribution "
                      "leaked", file=sys.stderr)
                bad += 1
        if not any(e.get("kind") == "recover"
                   for e in flightrec.events()):
            print("chaos smoke: no ladder event reached the flight "
                  "recorder", file=sys.stderr)
            bad += 1
        bundle_path = flightrec.dump(reason="ci chaos-recovery smoke")
        rc = doctor.main([bundle_path])
        if rc != 0:
            print(f"chaos smoke: doctor exited {rc} on the bundle",
                  file=sys.stderr)
            bad += 1
        print(f"chaos smoke: victim recovered "
              f"(retries={vc.get('recover.stage_retries', 0)}, "
              f"replayed={vc.get('recover.stages_replayed', 0)}/"
              f"{stages} stages), {len(peers)} peers clean, ladder in "
              f"doctor report ({time.perf_counter() - t0:.1f}s, "
              f"sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"chaos smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        try:
            _restore_trace(saved_trace)
        except Exception:  # graftlint: ok[broad-except] — best-effort
            pass           # teardown must not mask the stage verdict
        if prev_dir is None:
            os.environ.pop("CYLON_FLIGHTREC_DIR", None)
        else:
            os.environ["CYLON_FLIGHTREC_DIR"] = prev_dir
    return 1 if bad else 0


def _stage_ooc_smoke(sf: float, device, world: int) -> int:
    """Force one TPC-H query through the out-of-core spill path at a
    tiny pinned device budget (docs/out_of_core.md): the planner must
    insert a morsel scan (``spill.morsels >= 2`` — the scan genuinely
    streamed), the spilled run must be row-identical to the resident
    run, and the exchange transient must stay within the pinned
    budget.  On failure a flight-recorder bundle is dumped and doctor
    renders it, so the evidence ships with the red CI run."""
    print("== ci stage 7/14: out-of-core smoke ==")
    t0 = time.perf_counter()
    try:
        from .. import config as cfg, plan as planner, trace
        from ..context import CylonContext
        from ..spill import pool as spill_pool
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        ctx = CylonContext(device=device, world=world)
        data = generate(max(sf, 0.005), seed=7)
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the stages above
        print(f"ooc smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    saved_trace = _trace_switches()
    budget = 200 << 10
    try:
        from .parity import frames_rowset_equal

        q1 = QUERIES["q1"]

        resident = planner.run(
            ctx, lambda t: q1(ctx, t),
            _ingest(ctx, data)).to_pandas()
        trace.enable_counters()
        trace.reset()
        planner.clear_plan_cache()
        spill_pool.clear_pool()
        prev = cfg.set_device_memory_budget(budget)
        try:
            spilled = planner.run(
                ctx, lambda t: q1(ctx, t),
                _ingest(ctx, data)).to_pandas()
            c = dict(trace.counters())
        finally:
            cfg.set_device_memory_budget(prev)
            planner.clear_plan_cache()
            spill_pool.clear_pool()
        if not frames_rowset_equal(spilled, resident):
            print("ooc smoke: the spilled run DIVERGED from the "
                  "resident run", file=sys.stderr)
            bad += 1
        morsels = c.get("spill.morsels", 0)
        if morsels < 2:
            print(f"ooc smoke: spill.morsels = {morsels} < 2 — the "
                  "scan never streamed (morsel insertion or the "
                  "spilled-input routing regressed)", file=sys.stderr)
            bad += 1
        peak = c.get("shuffle.exchange_bytes_peak", 0)
        if peak > budget:
            print(f"ooc smoke: exchange transient {peak} B blew past "
                  f"the {budget} B pinned budget", file=sys.stderr)
            bad += 1
        if bad:
            try:
                import tempfile

                from ..observe import doctor, flightrec
                # under CYLON_FLIGHTREC_DIR, else a fresh temporary
                # directory — never the working directory
                base = (os.environ.get("CYLON_FLIGHTREC_DIR")
                        or tempfile.mkdtemp(prefix="cylon-ooc-"))
                bundle = flightrec.dump(
                    os.path.join(base, f"flightrec-ci-ooc-{os.getpid()}"
                                       ".json"),
                    reason="ci out-of-core smoke failure")
                print(f"ooc smoke: bundle {bundle}", file=sys.stderr)
                doctor.main([bundle])
            except Exception as e:  # graftlint: ok[broad-except] — the
                # bundle is evidence, not the verdict; a dump failure
                # must not mask the smoke failure above
                print(f"ooc smoke: bundle dump failed: {e}",
                      file=sys.stderr)
        else:
            print(f"ooc smoke: q1 spilled run row-identical, "
                  f"{morsels} morsels, peak {peak} B <= {budget} B "
                  f"({time.perf_counter() - t0:.1f}s, "
                  f"sf={max(sf, 0.005)})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"ooc smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        try:
            _restore_trace(saved_trace)
        except Exception:  # graftlint: ok[broad-except] — best-effort
            pass           # teardown must not mask the stage verdict
    return 1 if bad else 0


def _stage_mesh_smoke(sf: float, device, world: int) -> int:
    """Mesh-loss chaos smoke (docs/robustness.md "Elasticity"): a
    deterministic ``mesh.device_lost`` nth-rule is injected into ONE
    served 2-stage query — the victim must RECOVER row-identical on
    the shrunken survivor mesh (``recover.remesh`` in ITS counter
    slice), its batch peers must complete untouched with clean
    slices, the session must flip into degraded mode, and the
    flight-recorder bundle doctor renders must show the
    ``mesh_degraded`` event + evacuation timeline."""
    print("== ci stage 8/14: mesh-loss chaos smoke ==")
    t0 = time.perf_counter()
    try:
        import tempfile

        from .. import faults, plan as planner, topology
        from ..context import CylonContext
        from ..observe import doctor, flightrec
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        if world < 2:
            print(f"mesh-loss smoke: skipped — needs --world >= 2 (got "
                  f"{world})")
            return 0
        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=7))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the stages above
        print(f"mesh-loss smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    saved_trace = _trace_switches()
    world0 = ctx.get_world_size()
    prev_dir = os.environ.get("CYLON_FLIGHTREC_DIR")
    tmpdir = tempfile.mkdtemp(prefix="cylon-mesh-")
    os.environ["CYLON_FLIGHTREC_DIR"] = tmpdir
    try:
        from ..config import JoinConfig
        from ..parallel import dist_groupby, dist_join

        li = dts["lineitem"].column_names.index("l_orderkey")
        oi = dts["orders"].column_names.index("o_orderkey")

        def victim_op(t):
            # two exchange stages (join, then groupby over its output):
            # the nth=2 topology fault below lands at the SECOND stage
            # boundary, after stage 1 checkpointed — the victim loses a
            # device MID-query, not between queries
            j = dist_join(t["lineitem"], t["orders"],
                          JoinConfig.InnerJoin(li, oi))
            return dist_groupby(j, ["lt-l_orderkey"],
                                [("lt-l_quantity", "sum")])

        serial = planner.run(ctx, victim_op, dts).to_table().to_pandas()
        q6 = QUERIES["q6"]
        serial_peer = planner.run(
            ctx, lambda t: q6(ctx, t), dts).to_pandas()
        plan = faults.FaultPlan(seed=0, rules=[
            faults.FaultRule("mesh.device_lost", kind="topology",
                             nth=2, lost=1)])
        flightrec.clear()
        from .. import trace as _trace
        _trace.enable_counters()
        _trace.reset()
        with faults.active(plan), \
                ServeSession(ctx, tables=dts, batch_window_ms=30.0) as s:
            # the victim submits FIRST and executes first, so the
            # plan-wide second mesh.device_lost consult is its second
            # exchange boundary
            victim = s.submit(victim_op, label="victim")
            peers = [s.submit(lambda t, q=q6: q(ctx, t),
                              label=f"peer{i}",
                              export=lambda r: r.to_pandas())
                     for i in range(2)]
            got = victim.result(timeout=600).to_table().to_pandas()
            peer_results = [h.result(timeout=600) for h in peers]
            # one more post-degrade window proves the session keeps
            # serving on the survivor mesh
            tail = s.submit(lambda t, q=q6: q(ctx, t), label="tail",
                            export=lambda r: r.to_pandas())
            tail_got = tail.result(timeout=600)
            stats = s.stats()
        if not got.sort_values(list(got.columns))\
                .reset_index(drop=True).equals(
                    serial.sort_values(list(serial.columns))
                    .reset_index(drop=True)):
            print("mesh-loss smoke: the recovered victim DIVERGED from "
                  "the healthy run", file=sys.stderr)
            bad += 1
        vc = victim.counters
        if not vc.get("recover.remesh", 0):
            print("mesh-loss smoke: the victim's counter slice shows "
                  "no re-mesh — the topology rung never engaged",
                  file=sys.stderr)
            bad += 1
        eff = topology.effective(ctx)
        if eff.get_world_size() != world0 - 1:
            print(f"mesh-loss smoke: survivor world is "
                  f"{eff.get_world_size()}, expected {world0 - 1}",
                  file=sys.stderr)
            bad += 1
        if not stats.get("mesh_degraded", 0):
            print("mesh-loss smoke: the session never flipped into "
                  "degraded mode", file=sys.stderr)
            bad += 1
        for h, gotp in zip(peers, peer_results):
            if not gotp.sort_values(list(gotp.columns))\
                    .reset_index(drop=True).equals(
                        serial_peer.sort_values(
                            list(serial_peer.columns))
                        .reset_index(drop=True)):
                print(f"mesh-loss smoke: {h.label} diverged",
                      file=sys.stderr)
                bad += 1
            if h.counters.get("fault.injected", 0) \
                    or h.counters.get("recover.remesh", 0):
                print(f"mesh-loss smoke: {h.label}'s counter slice "
                      "shows the victim's fault/re-mesh — attribution "
                      "leaked", file=sys.stderr)
                bad += 1
        if not tail_got.sort_values(list(tail_got.columns))\
                .reset_index(drop=True).equals(
                    serial_peer.sort_values(list(serial_peer.columns))
                    .reset_index(drop=True)):
            print("mesh-loss smoke: the post-degrade query diverged on "
                  "the survivor mesh", file=sys.stderr)
            bad += 1
        if not any(e.get("kind") == "mesh_degraded"
                   for e in flightrec.events()):
            print("mesh-loss smoke: no mesh_degraded event reached the "
                  "flight recorder", file=sys.stderr)
            bad += 1
        bundle_path = flightrec.dump(reason="ci mesh-loss chaos smoke")
        rc = doctor.main([bundle_path])
        if rc != 0:
            print(f"mesh-loss smoke: doctor exited {rc} on the bundle",
                  file=sys.stderr)
            bad += 1
        print(f"mesh-loss smoke: victim recovered on "
              f"{eff.get_world_size()}/{world0} devices "
              f"(remesh={vc.get('recover.remesh', 0)}, evacuated "
              f"{vc.get('recover.evacuated_bytes', 0)} B), "
              f"{len(peers)} peers + 1 post-degrade query clean "
              f"({time.perf_counter() - t0:.1f}s, sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"mesh-loss smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        try:
            from .. import topology as _topology
            _restore_trace(saved_trace)
            _topology.reset()
        except Exception:  # graftlint: ok[broad-except] — best-effort
            pass           # teardown must not mask the stage verdict
        if prev_dir is None:
            os.environ.pop("CYLON_FLIGHTREC_DIR", None)
        else:
            os.environ["CYLON_FLIGHTREC_DIR"] = prev_dir
    return 1 if bad else 0


def _stage_scaleup_smoke(sf: float, device, world: int) -> int:
    """Mesh-grow chaos smoke (docs/robustness.md "Elasticity", the
    scale-UP half): deterministic ``mesh.device_lost`` THEN
    ``mesh.device_joined`` rules are injected into served multi-stage
    queries — the victim must recover on the survivor mesh and the
    session flip degraded; the next served query's executor must take
    the rejoin mid-plan (``recover.scaleups`` in ITS counter slice)
    and complete row-identical; the session must UN-degrade
    (``mesh_expanded`` tallied, degraded gauge cleared); a follow-up
    query must run on the restored full world; and the doctor must
    render the ``mesh_expanded`` scale-up timeline from the bundle."""
    print("== ci stage 9/14: mesh-grow chaos smoke ==")
    t0 = time.perf_counter()
    try:
        import tempfile

        from .. import faults, plan as planner, topology
        from ..context import CylonContext
        from ..observe import doctor, flightrec
        from ..serve import ServeSession
        from ..tpch import generate

        if world < 2:
            print(f"mesh-grow smoke: skipped — needs --world >= 2 (got "
                  f"{world})")
            return 0
        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=11))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the stages above
        print(f"mesh-grow smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    saved_trace = _trace_switches()
    world0 = ctx.get_world_size()
    prev_dir = os.environ.get("CYLON_FLIGHTREC_DIR")
    tmpdir = tempfile.mkdtemp(prefix="cylon-grow-")
    os.environ["CYLON_FLIGHTREC_DIR"] = tmpdir
    try:
        import json

        from ..config import JoinConfig
        from ..parallel import dist_groupby, dist_join

        li = dts["lineitem"].column_names.index("l_orderkey")
        oi = dts["orders"].column_names.index("o_orderkey")

        def two_stage_op(t):
            # two exchange stages: the victim loses a device at its
            # SECOND boundary (mid-query); the scale-up leg rejoins at
            # a boundary of the NEXT query the same way
            j = dist_join(t["lineitem"], t["orders"],
                          JoinConfig.InnerJoin(li, oi))
            return dist_groupby(j, ["lt-l_orderkey"],
                                [("lt-l_quantity", "sum")])

        def norm(df):
            return (df.sort_values(list(df.columns))
                    .reset_index(drop=True))

        serial = norm(planner.run(ctx, two_stage_op, dts)
                      .to_table().to_pandas())
        flightrec.clear()
        from .. import trace as _trace
        _trace.enable_counters()
        _trace.reset()

        def wait_stat(s, key, timeout=30.0):
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                if s.stats().get(key, 0) >= 1:
                    return True
                time.sleep(0.05)
            return s.stats().get(key, 0) >= 1

        with ServeSession(ctx, tables=dts, batch_window_ms=10.0) as s:
            # leg 1 — deterministic loss mid-query: the victim's ladder
            # shrinks the mesh, the session flips degraded
            lose = faults.FaultPlan(seed=0, rules=[
                faults.FaultRule("mesh.device_lost", kind="topology",
                                 nth=2, lost=1)])
            with faults.active(lose):
                victim = s.submit(two_stage_op, label="victim")
                got_v = norm(victim.result(timeout=600)
                             .to_table().to_pandas())
            if not got_v.equals(serial):
                print("mesh-grow smoke: the victim DIVERGED on the "
                      "survivor mesh", file=sys.stderr)
                bad += 1
            if not victim.counters.get("recover.remesh", 0):
                print("mesh-grow smoke: the victim's slice shows no "
                      "re-mesh — the loss never engaged",
                      file=sys.stderr)
                bad += 1
            if not wait_stat(s, "mesh_degraded"):
                print("mesh-grow smoke: the session never flipped "
                      "into degraded mode", file=sys.stderr)
                bad += 1
            # leg 2 — deterministic rejoin at the next query's first
            # boundary: the executor takes the expansion mid-plan
            grow = faults.FaultPlan(seed=0, rules=[
                faults.FaultRule("mesh.device_joined", kind="topology",
                                 nth=1, lost=1)])
            with faults.active(grow):
                riser = s.submit(two_stage_op, label="riser")
                got_r = norm(riser.result(timeout=600)
                             .to_table().to_pandas())
            if not got_r.equals(serial):
                print("mesh-grow smoke: the scale-up query DIVERGED",
                      file=sys.stderr)
                bad += 1
            if not riser.counters.get("recover.scaleups", 0):
                print("mesh-grow smoke: the scale-up query's slice "
                      "shows no recover.scaleups — the rejoin never "
                      "expanded the plan", file=sys.stderr)
                bad += 1
            if not wait_stat(s, "mesh_expanded"):
                print("mesh-grow smoke: the session never recorded "
                      "the expansion (mesh_expanded)", file=sys.stderr)
                bad += 1
            if "degraded_world" in s.stats():
                print("mesh-grow smoke: degraded_world survived the "
                      "full restore — the session did not un-degrade",
                      file=sys.stderr)
                bad += 1
            # leg 3 — the follow-up query runs on the restored world
            tail = s.submit(two_stage_op, label="tail")
            got_t = norm(tail.result(timeout=600)
                         .to_table().to_pandas())
            if not got_t.equals(serial):
                print("mesh-grow smoke: the post-expansion query "
                      "diverged", file=sys.stderr)
                bad += 1
        eff = topology.effective(ctx)
        if eff.get_world_size() != world0:
            print(f"mesh-grow smoke: world is {eff.get_world_size()} "
                  f"after the rejoin, expected {world0}",
                  file=sys.stderr)
            bad += 1
        if not any(e.get("kind") == "mesh_expanded"
                   for e in flightrec.events()):
            print("mesh-grow smoke: no mesh_expanded event reached "
                  "the flight recorder", file=sys.stderr)
            bad += 1
        bundle_path = flightrec.dump(reason="ci mesh-grow chaos smoke")
        rc = doctor.main([bundle_path])
        if rc != 0:
            print(f"mesh-grow smoke: doctor exited {rc} on the bundle",
                  file=sys.stderr)
            bad += 1
        with open(bundle_path) as f:
            rendered = doctor.render(json.load(f))
        if "MESH EXPANDED" not in rendered:
            print("mesh-grow smoke: doctor did not render the "
                  "scale-up timeline", file=sys.stderr)
            bad += 1
        print(f"mesh-grow smoke: victim recovered, rejoin expanded "
              f"back to {eff.get_world_size()}/{world0} devices "
              f"(scaleups={riser.counters.get('recover.scaleups', 0)}),"
              f" follow-up clean "
              f"({time.perf_counter() - t0:.1f}s, sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract and
        # let the remaining stages run instead of dying with a traceback
        print(f"mesh-grow smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        try:
            from .. import topology as _topology
            _restore_trace(saved_trace)
            _topology.reset()
        except Exception:  # graftlint: ok[broad-except] — best-effort
            pass           # teardown must not mask the stage verdict
        if prev_dir is None:
            os.environ.pop("CYLON_FLIGHTREC_DIR", None)
        else:
            os.environ["CYLON_FLIGHTREC_DIR"] = prev_dir
    return 1 if bad else 0


def _stage_hierarchy_smoke(device, world: int) -> int:
    """Hierarchical-collectives smoke (docs/tpu_perf_notes.md
    "Hierarchical collectives"): on an 8-device 2x4 mesh with a
    synthetic per-edge profile (fast edges 1 GB/s, slow edges 1 MB/s)
    the chooser must SELECT — not forced — the hierarchical lowering
    for a skewed cross-slow-axis shuffle, row-identical to the forced
    single-shot run, with strictly fewer slow-axis wire bytes than the
    flat single-shot slow-share price.  A forced hierarchical leg and
    a forced hierarchical-combine fused-groupby leg prove both
    lowerings independently."""
    print("== ci stage 10/14: hierarchy smoke ==")
    t0 = time.perf_counter()
    try:
        import dataclasses

        import numpy as np
        import pandas as pd
        import torch

        from .. import config, trace
        from ..context import CylonContext
        from ..parallel import meshprobe, shuffle
        from ..parallel.dist_ops import dist_groupby, dist_groupby_fused
        from ..parallel.dtable import DTable

        if world < 8:
            print(f"hierarchy smoke: skipped — needs --world >= 8 (got "
                  f"{world})")
            return 0
        # the (2, 4) split spans exactly 8 shards, as the reference
        # takes the first 8 devices of a larger mesh
        ctx = CylonContext(device=device, world=8)
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding
        print(f"hierarchy smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    saved_trace, saved_profiles = _trace_switches(), _probe_profiles()
    prev_shape = config.set_mesh_shape((2, 4))
    prev_meas = config.set_cost_measured(True)
    trace.enable_counters()
    try:
        # a synthetic per-edge profile with a 1000x bandwidth gap makes
        # the selection deterministic regardless of host jitter — the
        # smoke tests the CHOOSER, not the probe
        prof = meshprobe.probe(ctx)
        lat = dict(prof.latency_s)
        bw = dict(prof.bytes_per_s)
        for coll in ("all_to_all", "ppermute", "all_gather"):
            lat[coll + "@fast"] = 1e-6
            bw[coll + "@fast"] = 1e9
            lat[coll + "@slow"] = 1e-4
            bw[coll + "@slow"] = 1e6
        meshprobe.put_profile(dataclasses.replace(
            prof, latency_s=lat, bytes_per_s=bw))

        Pn = ctx.get_world_size()
        cap = 2048
        # every row on device d targets device (d+4)%8: all traffic
        # crosses the slow axis, concentrated on ONE peer per sender —
        # the flat all_to_all pads every [P, block] cell to the hot
        # cell, the hierarchy aggregates the rows into one cell
        pid_np = np.repeat((np.arange(Pn) + 4) % Pn, cap)
        vals = np.arange(Pn * cap).astype(np.int64)
        # the port's shard layout: flat [P*cap] tensors on the
        # context's device, shard d owning rows [d*cap, (d+1)*cap)
        pid = torch.from_numpy(pid_np.astype(np.int32)).to(ctx.device)
        leaves = [torch.from_numpy(vals).to(ctx.device)]

        def rowset(force):
            prev = config.set_exchange_strategy(force)
            shuffle.clear_chunk_state()
            trace.reset()
            try:
                outs, cnts, oc = shuffle.shuffle_leaves(ctx, pid, leaves)
            finally:
                config.set_exchange_strategy(prev)
            # smoke-only oracle export: the whole point is reading the
            # raw exchange result back to host for rowset comparison
            cn = cnts.cpu().numpy()  # graftlint: ok[implicit-host-sync]
            buf = outs[0].cpu().numpy()  # graftlint: ok[implicit-host-sync]
            rows = [sorted(buf[d * oc:d * oc + int(cn[d])].tolist())
                    for d in range(Pn)]
            return rows, dict(trace.counters())

        base_rows, base_c = rowset("single-shot")
        nat_rows, nat_c = rowset(None)
        if not nat_c.get("shuffle.strategy.hierarchical", 0):
            print("hierarchy smoke: the chooser did NOT select the "
                  "hierarchical lowering under the per-edge model",
                  file=sys.stderr)
            bad += 1
        if nat_rows != base_rows:
            print("hierarchy smoke: the naturally-selected hierarchical "
                  "shuffle diverged from single-shot", file=sys.stderr)
            bad += 1
        ns = nat_c.get("shuffle.bytes_sent_slow", 0)
        fs = base_c.get("shuffle.bytes_sent_slow", 0)
        if not (0 < ns < fs):
            print(f"hierarchy smoke: slow-axis wire bytes not strictly "
                  f"below the flat price (hier={ns}, flat={fs})",
                  file=sys.stderr)
            bad += 1
        forced_rows, forced_c = rowset("hierarchical")
        if forced_rows != base_rows:
            print("hierarchy smoke: the FORCED hierarchical shuffle "
                  "diverged from single-shot", file=sys.stderr)
            bad += 1
        if not forced_c.get("shuffle.strategy.hierarchical", 0):
            print("hierarchy smoke: the forced leg did not run the "
                  "hierarchical lowering", file=sys.stderr)
            bad += 1

        # forced hierarchical-combine over the fused-groupby exchange:
        # parity against the plain groupby and the pre-combine proof
        # that only per-group partials crossed the slow axis
        n = 6000
        nkeys = 37
        df = pd.DataFrame({
            "k": (np.arange(n) % nkeys).astype(np.int32),
            "v": (np.arange(n) * 0.5).astype(np.float32),
        })
        dt = DTable.from_pandas(ctx, df)
        aggs = [("v", "sum"), ("v", "count")]

        def canon(res):
            if not hasattr(res, "to_pandas"):
                res = res.to_table()
            return res.to_pandas().sort_values("k")\
                .reset_index(drop=True)

        want = canon(dist_groupby(dt, ["k"], aggs))
        prev = config.set_exchange_strategy("hierarchical-combine")
        shuffle.clear_chunk_state()
        trace.reset()
        try:
            got = canon(dist_groupby_fused(dt, ["k"], aggs,
                                           mode="pre-aggregate"))
            comb_c = dict(trace.counters())
        finally:
            config.set_exchange_strategy(prev)
        ok = list(got.columns) == list(want.columns)
        if ok:
            for col in want.columns:
                w = want[col].to_numpy(np.float64)
                g = got[col].to_numpy(np.float64)
                ok = ok and np.allclose(g, w, rtol=1e-9, atol=1e-9)
        if not ok:
            print("hierarchy smoke: the hierarchical-combine fused "
                  "groupby diverged from plain groupby",
                  file=sys.stderr)
            bad += 1
        if not comb_c.get("shuffle.strategy.hierarchical_combine", 0):
            print("hierarchy smoke: the forced combine leg did not run "
                  "the hierarchical-combine lowering", file=sys.stderr)
            bad += 1
        pre_rows = comb_c.get("groupby.axis_precombine_rows", 0)
        # striped keys put every group on every device: the pre-combine
        # must move EXACTLY one partial per group per non-resident slow
        # block — K*(S-1) rows, nothing proportional to n
        if pre_rows != nkeys * (2 - 1):
            print(f"hierarchy smoke: pre-combine moved {pre_rows} rows "
                  f"across the slow axis, expected exactly {nkeys}",
                  file=sys.stderr)
            bad += 1
        print(f"hierarchy smoke: natural selection OK "
              f"(slow bytes {ns} < flat {fs}), forced parity OK, "
              f"combine pre-aggregate crossed {pre_rows} partials "
              f"({time.perf_counter() - t0:.1f}s)")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract
        print(f"hierarchy smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        try:
            from .. import config as _config
            from ..parallel import shuffle as _shuffle
            _config.set_mesh_shape(prev_shape)
            _config.set_cost_measured(prev_meas)
            _restore_profiles(saved_profiles)
            _shuffle.clear_chunk_state()
            _restore_trace(saved_trace)
        except Exception:  # graftlint: ok[broad-except] — best-effort
            pass           # teardown must not mask the stage verdict
    return 1 if bad else 0


def _stage_lockcheck_smoke(device, world: int) -> int:
    """Concurrency-discipline smoke (docs/static_analysis.md): (a) the
    static half holds the tree at zero findings for both concurrency
    rules; (b) the runtime half catches a deterministic AB/BA
    inversion as a typed LockOrderViolation at ACQUIRE time — the
    detector reports the deadlock instead of experiencing it; (c) an
    8-client serving window runs green with CYLON_LOCKCHECK
    enforcement live across every OrderedLock in the engine."""
    print("== ci stage 11/14: concurrency smoke ==")
    t0 = time.perf_counter()
    try:
        import threading

        from .. import config
        from ..context import CylonContext
        from ..observe.locks import LockOrderViolation, OrderedLock
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES
        from . import lockcheck

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(0.002, seed=11))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding
        print(f"concurrency smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    prev_enforce = config.set_lockcheck(True)
    try:
        # (a) the static half: both rules at zero findings tree-wide
        rc = lockcheck.main(_repo_paths())
        if rc != 0:
            print(f"concurrency smoke: lockcheck exited {rc} — the "
                  "tree is not at zero concurrency findings",
                  file=sys.stderr)
            bad += 1
        # (b) the runtime half: a deterministic AB/BA inversion on two
        # throwaway locks must raise the typed violation on the SECOND
        # thread's acquire, before it can block
        lk_a = OrderedLock("ci.smoke_a")
        lk_b = OrderedLock("ci.smoke_b")
        with lk_a:
            with lk_b:
                pass
        caught: list = []

        def inverter():
            try:
                with lk_b:
                    with lk_a:
                        pass
            except LockOrderViolation as e:
                caught.append(e)

        th = threading.Thread(target=inverter, name="ci-ab-ba")
        th.start()
        th.join(30)
        if not caught:
            print("concurrency smoke: the AB/BA inversion was NOT "
                  "caught as a LockOrderViolation", file=sys.stderr)
            bad += 1
        elif ("ci.smoke_a" not in str(caught[0])
              or "ci.smoke_b" not in str(caught[0])):
            print("concurrency smoke: the violation message does not "
                  f"name both chains: {caught[0]}", file=sys.stderr)
            bad += 1
        # (c) an 8-client serve window with enforcement live: every
        # OrderedLock acquisition in the engine (queue, breaker,
        # session stats, spill pool, chunk state, replica cache,
        # warn_once) is order-checked while real queries flow
        with ServeSession(ctx, tables=dts, batch_window_ms=20.0) as s:
            handles = []
            errs: list = []

            def client(qfn, label):
                try:
                    handles.append(s.submit(
                        lambda t, q=qfn: q(ctx, t), label=label,
                        export=lambda r: r.to_pandas()))
                except Exception as e:  # graftlint: ok[broad-except]
                    errs.append(e)  # — the stage verdict needs it

            mix = [("q1", QUERIES["q1"]), ("q6", QUERIES["q6"])] * 4
            threads = [threading.Thread(target=client, args=(q, n))
                       for n, q in mix]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for h in handles:
                h.result(timeout=600)
            stats = s.stats()
        if errs:
            print(f"concurrency smoke: {len(errs)} submit(s) raised "
                  f"under enforcement: {errs[0]}", file=sys.stderr)
            bad += 1
        if stats["failed"]:
            print(f"concurrency smoke: {stats['failed']} quer(ies) "
                  "failed under enforcement", file=sys.stderr)
            bad += 1
        if not bad:
            print(f"concurrency smoke: lint clean, AB/BA caught, "
                  f"{stats['completed']} queries green under "
                  f"enforcement ({time.perf_counter() - t0:.1f}s)")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract
        print(f"concurrency smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        config.set_lockcheck(prev_enforce)
    return 1 if bad else 0


def _stage_export_smoke(sf: float, device, world: int) -> int:
    """Live-telemetry-plane smoke (docs/observability.md): (a) the
    OpenMetrics exporter binds an ephemeral loopback port and a real
    HTTP scrape parses — every exposed family must map back to a
    catalogued metric of the matching kind, histograms must carry
    cumulative buckets, and the config-fingerprint info metric must be
    present; (b) the JSON-lines event log captures a seeded SLO
    (deadline) miss as one valid-JSON line; (c) tail-based trace
    sampling retains the always-keep query's span waterfall and drops
    the fast peers', with ``trace.sampled_out`` accounting for the
    purge."""
    print("== ci stage 12/14: export smoke ==")
    t0 = time.perf_counter()
    try:
        import json
        import os
        import re as _re
        import tempfile
        import urllib.request

        from .. import trace
        from ..context import CylonContext
        from ..observe import exporter
        from ..observe.metrics import COUNTER, HISTOGRAM, METRICS
        from ..serve import ServeSession
        from ..tpch import generate
        from ..tpch.queries import QUERIES

        ctx = CylonContext(device=device, world=world)
        dts = _ingest(ctx, generate(sf, seed=17))
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding
        print(f"export smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0
    tmp = tempfile.mkdtemp(prefix="cylon-export-smoke-")
    evt_path = os.path.join(tmp, "events.jsonl")
    saved_trace = _trace_switches()
    trace.enable()
    trace.reset()
    # an endpoint the caller runs is scraped and left running
    was_running = exporter.running()
    try:
        port = exporter.start(0)
        exporter.start_event_log(evt_path)

        # (c)'s workload doubles as (a)+(b)'s event source: three q6
        # runs SEQUENTIALLY — the first pays the compile and lands in
        # the top-k heap; the cache-warm repeats are strictly faster,
        # so with tail_keep_k=1 they are the droppable fast peers —
        # plus one query carrying an impossible deadline, whose miss
        # is the seeded SLO event AND the always-keep retention case
        with ServeSession(ctx, tables=dts, batch_window_ms=20.0,
                          tail_keep_k=1) as s:
            fast = []
            for i in range(3):
                h = s.submit(lambda t, q=QUERIES["q6"]: q(ctx, t),
                             label=f"fast{i}",
                             export=lambda r: r.to_pandas())
                h.result(timeout=600)
                fast.append(h)
            miss = s.submit(lambda t, q=QUERIES["q1"]: q(ctx, t),
                            label="slo-miss", deadline_ms=0.001,
                            export=lambda r: r.to_pandas())
            miss.result(timeout=600)

        # (a) a real scrape over HTTP, then forward catalogue
        # compliance: every TYPE family must come from a catalogued
        # metric and agree on the OpenMetrics kind
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            body = resp.read().decode("utf-8")
        if not body.endswith("# EOF\n"):
            print("export smoke: scrape payload is not # EOF-terminated",
                  file=sys.stderr)
            bad += 1
        allowed = {}
        for name, spec in METRICS.items():
            fam = exporter.family_name(name)
            allowed[fam] = ("counter" if spec.kind == COUNTER else
                            "histogram" if spec.kind == HISTOGRAM
                            else "gauge")
        for m in _re.finditer(r"^# TYPE (\S+) (\S+)$", body, _re.M):
            fam, om_kind = m.group(1), m.group(2)
            if allowed.get(fam) != om_kind:
                print(f"export smoke: exposed family {fam} ({om_kind}) "
                      f"does not match the catalogue "
                      f"({allowed.get(fam)})", file=sys.stderr)
                bad += 1
        lat_fam = exporter.family_name("serve.latency_ms")
        if f'{lat_fam}_bucket{{le="+Inf"}}' not in body:
            print("export smoke: serve.latency_ms histogram has no "
                  "+Inf cumulative bucket", file=sys.stderr)
            bad += 1
        if "cylon_observe_config_info{" not in body:
            print("export smoke: config-fingerprint info metric "
                  "missing from the scrape", file=sys.stderr)
            bad += 1

        # (b) the event log: one JSON object per line, and the seeded
        # deadline miss must be among them
        exporter.stop_event_log()
        kinds = []
        with open(evt_path, "r", encoding="utf-8") as fh:
            for line in fh:
                kinds.append(json.loads(line)["kind"])
        if "deadline_miss" not in kinds:
            print(f"export smoke: seeded SLO miss not in the event log "
                  f"(kinds={sorted(set(kinds))})", file=sys.stderr)
            bad += 1

        # (c) tail retention: the miss's waterfall survives, at least
        # one fast peer's was purged and accounted for
        kept_ids = {r[5] for r in trace.get_span_records(True) if r[5]}
        if miss.trace_id not in kept_ids:
            print("export smoke: the always-keep (deadline-missed) "
                  "query's spans were dropped", file=sys.stderr)
            bad += 1
        dropped_ids = {h.trace_id for h in fast} - kept_ids
        sampled_out = trace.snapshot()["counters"].get(
            "trace.sampled_out", 0)
        if not dropped_ids or not sampled_out:
            print(f"export smoke: tail sampling dropped no fast peer "
                  f"(dropped={len(dropped_ids)}, "
                  f"sampled_out={sampled_out})", file=sys.stderr)
            bad += 1
        if not bad:
            print(f"export smoke: scrape ok on :{port}, "
                  f"{len(kinds)} event(s) logged, "
                  f"{len(dropped_ids)} trace(s) sampled out "
                  f"({time.perf_counter() - t0:.1f}s, sf={sf})")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract
        print(f"export smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        exporter.stop_event_log()
        if not was_running:
            exporter.stop()
        _restore_trace(saved_trace)
    return 1 if bad else 0


def _stage_matview_smoke(device, world: int) -> int:
    """Materialized-subplan smoke (docs/serving.md "Materialized
    subplans"): the same aggregation across two batch windows must be
    served from the view on window 2 — strictly fewer exchanges than
    window 1 and row-identical — an ``ingest`` append must FOLD through
    the view's captured aggregation state with row parity against a
    cold recompute, and with the ``matview.fold`` fault armed the fold
    must DEGRADE to invalidate + full recompute, still row-identical —
    never a stale or half-folded answer."""
    print("== ci stage 13/14: matview smoke ==")
    t0 = time.perf_counter()
    try:
        import numpy as np
        import pandas as pd

        from .. import faults, trace
        from ..context import CylonContext
        from ..observe import metrics as obmetrics
        from ..parallel.dist_ops import dist_groupby, shuffle_table
        from ..parallel.dtable import DTable
        from ..serve import ServeSession

        ctx = CylonContext(device=device, world=world)
        rng = np.random.default_rng(3)
        base = pd.DataFrame({
            "k": rng.integers(0, 16, 512).astype(np.int64),
            "v": rng.normal(size=512)})
        dt = DTable.from_pandas(ctx, base)
    except Exception as e:  # graftlint: ok[broad-except] — environment
        # setup failing is a TOOLING error (exit 2), not a finding —
        # the same contract as the plan_check stage
        print(f"matview smoke: setup failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = 0

    def _q(t):
        s = shuffle_table(t["fact"], ["k"])
        return dist_groupby(s, ["k"], [("v", "sum"), ("v", "count")])

    def _frame(dt_out):
        df = dt_out.to_table().to_pandas()
        return df.sort_values("k").reset_index(drop=True)

    def _cold(df):
        out = df.groupby("k", as_index=False).agg(
            sum_v=("v", "sum"), count_v=("v", "count"))
        return out.sort_values("k").reset_index(drop=True)

    def _parity(got, want, what):
        nonlocal bad
        if (len(got) != len(want)
                or not np.allclose(got["sum_v"].to_numpy(np.float64),
                                   want["sum_v"].to_numpy(np.float64),
                                   rtol=1e-4, atol=1e-4)
                or not np.array_equal(
                    got["count_v"].to_numpy(np.int64),
                    want["count_v"].to_numpy(np.int64))):
            print(f"matview smoke: {what} DIVERGED from the cold "
                  "recompute", file=sys.stderr)
            bad += 1

    saved_trace = _trace_switches()
    try:
        trace.enable_counters()
        trace.reset()
        with ServeSession(ctx, tables={"fact": dt},
                          batch_window_ms=0.0) as s:
            h1 = s.submit(_q, label="w1")
            r1 = _frame(h1.result(timeout=600))
            h2 = s.submit(_q, label="w2")
            r2 = _frame(h2.result(timeout=600))
            ex1 = obmetrics.exchange_count(h1.counters)
            ex2 = obmetrics.exchange_count(h2.counters)
            if h2.view != "hit" or ex2 >= ex1:
                print(f"matview smoke: window-2 repeat was not served "
                      f"from the view (view={h2.view!r}, exchanges "
                      f"{ex1} -> {ex2}; the repeat must dispatch "
                      "strictly fewer)", file=sys.stderr)
                bad += 1
            _parity(r2, _cold(base), "window-2 view hit")
            # the append must FOLD — O(delta) through the captured
            # aggregation state — and answer row-identical to a cold
            # recompute over base + delta
            ddf = pd.DataFrame({
                "k": rng.integers(0, 16, 64).astype(np.int64),
                "v": rng.normal(size=64)})
            s.ingest("fact", DTable.from_pandas(ctx, ddf)) \
                .result(timeout=600)
            h3 = s.submit(_q, label="w3")
            r3 = _frame(h3.result(timeout=600))
            if h3.view != "fold":
                print(f"matview smoke: post-append query did not fold "
                      f"(view={h3.view!r}) — the ingest path stopped "
                      "maintaining the view incrementally",
                      file=sys.stderr)
                bad += 1
            both = pd.concat([base, ddf], ignore_index=True)
            _parity(r3, _cold(both), "post-append fold")
            # chaos: a failure INSIDE the fold must degrade to
            # invalidate + full recompute — row-identical, never a
            # stale or half-folded answer
            ddf2 = pd.DataFrame({
                "k": rng.integers(0, 16, 64).astype(np.int64),
                "v": rng.normal(size=64)})
            s.ingest("fact", DTable.from_pandas(ctx, ddf2)) \
                .result(timeout=600)
            plan = faults.FaultPlan(seed=0, rules=[
                faults.FaultRule("matview.fold", kind="transient",
                                 once=True)])
            with faults.active(plan):
                h4 = s.submit(_q, label="w4-chaos")
                r4 = _frame(h4.result(timeout=600))
            if h4.view is not None:
                print(f"matview smoke: faulted fold was served from "
                      f"the view (view={h4.view!r}) — a failed fold "
                      "must degrade to a full recompute",
                      file=sys.stderr)
                bad += 1
            all3 = pd.concat([base, ddf, ddf2], ignore_index=True)
            _parity(r4, _cold(all3), "chaos-degraded recompute")
            failures = trace.counters().get("matview.fold_failures", 0)
            if not failures:
                print("matview smoke: the armed matview.fold fault "
                      "never fired (matview.fold_failures == 0)",
                      file=sys.stderr)
                bad += 1
            st = s.stats()
        if not bad:
            print(f"matview smoke: hit + fold + chaos degrade ok "
                  f"(view_hits={st['view_hits']}, "
                  f"view_folds={st['view_folds']}, exchanges "
                  f"{ex1} -> {ex2}; "
                  f"{time.perf_counter() - t0:.1f}s)")
    except Exception as e:  # graftlint: ok[broad-except] — a crash in
        # the workload is a finding: keep the 0/1/2 exit contract
        print(f"matview smoke: RAISED: {type(e).__name__}: "
              f"{str(e)[:300]}", file=sys.stderr)
        bad += 1
    finally:
        _restore_trace(saved_trace)
    return 1 if bad else 0


def _stage_benchdiff(baseline: str, candidate: str,
                     threshold: float) -> int:
    from . import benchdiff
    print("== ci stage 14/14: benchdiff ==")
    rc = benchdiff.main([baseline, candidate,
                         "--threshold", str(threshold)])
    print(f"benchdiff: exit {rc}")
    return rc


def _stages(args) -> List[tuple]:
    """``(number, name, skipped, run)`` for the 14 stages in order; the
    runners look the stage functions up when called."""
    sf, dev, w = args.tpch_sf, args.device, args.world
    return [
        (1, "graftlint", False, lambda: _stage_lint()),
        (2, "plan_check pre-flight", args.no_plan_check,
         lambda: _stage_plan_check(sf, dev, w)),
        (3, "serving smoke", args.no_serve_smoke,
         lambda: _stage_serve_smoke(sf, dev, w)),
        (4, "telemetry smoke", args.no_telemetry_smoke,
         lambda: _stage_telemetry_smoke(sf, dev, w)),
        (5, "doctor smoke", args.no_doctor_smoke,
         lambda: _stage_doctor_smoke(sf, dev, w)),
        (6, "chaos-recovery smoke", args.no_chaos_smoke,
         lambda: _stage_chaos_smoke(sf, dev, w)),
        (7, "out-of-core smoke", args.no_ooc_smoke,
         lambda: _stage_ooc_smoke(sf, dev, w)),
        (8, "mesh-loss chaos smoke", args.no_mesh_smoke,
         lambda: _stage_mesh_smoke(sf, dev, w)),
        (9, "mesh-grow chaos smoke", args.no_scaleup_smoke,
         lambda: _stage_scaleup_smoke(sf, dev, w)),
        (10, "hierarchy smoke", args.no_hierarchy_smoke,
         lambda: _stage_hierarchy_smoke(dev, w)),
        (11, "concurrency smoke", args.no_lockcheck_smoke,
         lambda: _stage_lockcheck_smoke(dev, w)),
        (12, "export smoke", args.no_export_smoke,
         lambda: _stage_export_smoke(sf, dev, w)),
        (13, "matview smoke", args.no_matview_smoke,
         lambda: _stage_matview_smoke(dev, w)),
        (14, "benchdiff", not args.baseline,
         lambda: _stage_benchdiff(args.baseline, args.candidate,
                                  args.threshold)),
    ]


def _world(text: str) -> int:
    n = int(text)
    if n < 1:
        raise argparse.ArgumentTypeError(f"world must be >= 1, got {n}")
    return n


def main(argv: Optional[List[str]] = None,
         on_stage: Optional[Callable[[int, str, int, float], None]] = None
         ) -> int:
    """Run the stages; the exit code is the worst stage's.  ``on_stage``
    (an embedding caller's hook) is called after each stage that ran
    with its number, name, exit code and wall seconds."""
    ap = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.analysis.ci",
        description="run graftlint + plan_check pre-flight + the smoke "
                    "stages (+ benchdiff) with aggregated exit codes")
    ap.add_argument("candidate", nargs="?",
                    help="NEW bench artifact (needs --baseline)")
    ap.add_argument("--baseline", help="OLD bench artifact for benchdiff")
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="benchdiff regression threshold (default 0.15)")
    ap.add_argument("--tpch-sf", type=float, default=0.002,
                    help="TPC-H scale factor for the plan-check "
                         "pre-flight dataset (default 0.002)")
    ap.add_argument("--device", default="cuda",
                    help="device of every stage's context (default cuda: "
                         "the card, with no fallback to the CPU)")
    ap.add_argument("--world", type=_world, default=8,
                    help="shards of every stage's context (default 8; "
                         "the mesh stages skip below 2, the hierarchy "
                         "stage below 8)")
    ap.add_argument("--no-plan-check", action="store_true",
                    help="skip the plan_check pre-flight stage")
    ap.add_argument("--no-serve-smoke", action="store_true",
                    help="skip the serving smoke stage")
    ap.add_argument("--no-telemetry-smoke", action="store_true",
                    help="skip the telemetry smoke stage")
    ap.add_argument("--no-doctor-smoke", action="store_true",
                    help="skip the doctor (flight recorder) smoke stage")
    ap.add_argument("--no-chaos-smoke", action="store_true",
                    help="skip the chaos-recovery smoke stage")
    ap.add_argument("--no-ooc-smoke", action="store_true",
                    help="skip the out-of-core (spill) smoke stage")
    ap.add_argument("--no-mesh-smoke", action="store_true",
                    help="skip the mesh-loss chaos smoke stage")
    ap.add_argument("--no-scaleup-smoke", action="store_true",
                    help="skip the mesh-grow chaos smoke stage")
    ap.add_argument("--no-hierarchy-smoke", action="store_true",
                    help="skip the hierarchical-collectives smoke stage")
    ap.add_argument("--no-lockcheck-smoke", action="store_true",
                    help="skip the concurrency (lockcheck) smoke stage")
    ap.add_argument("--no-export-smoke", action="store_true",
                    help="skip the telemetry-export (OpenMetrics + "
                         "event log + tail sampling) smoke stage")
    ap.add_argument("--no-matview-smoke", action="store_true",
                    help="skip the materialized-subplan (view cache + "
                         "delta fold + chaos degrade) smoke stage")
    args = ap.parse_args(argv)
    if bool(args.baseline) != bool(args.candidate):
        print("ci: benchdiff needs BOTH --baseline OLD.json and a "
              "candidate artifact", file=sys.stderr)
        return 2
    rcs = []
    for number, name, skipped, run in _stages(args):
        if skipped:
            why = "no --baseline; skipped" if number == 14 else "skipped"
            print(f"== ci stage {number}/14: {name} == ({why})")
            continue
        t0 = time.perf_counter()
        rc = run()
        rcs.append(rc)
        if on_stage is not None:
            on_stage(number, name, rc, time.perf_counter() - t0)
    worst = max(rcs)
    print(f"ci: {'CLEAN' if worst == 0 else 'FAILED'} "
          f"(stage exits {rcs} -> {worst})")
    return worst


if __name__ == "__main__":
    sys.exit(main())
