"""doctor — render a flight-recorder bundle as a human post-mortem.

The port of ``cylon_tpu/observe/doctor.py``, section for section.

::

    python -m cylon_tpu_torch.observe.doctor flightrec-1234-567.json

reads one bundle written by ``observe.flightrec.dump`` (JSON + embedded
Perfetto trace + config fingerprint + last-K query records) and prints
a structured report: what failed, under which config, what the engine
was doing in the seconds before (alerts, deadline misses, exchange
choices, query outcomes), which counters look anomalous, and where the
wall-clock went.  Exit codes follow the shared analysis contract: 0 on
a rendered report, 2 on a missing/unreadable bundle (there are no
"findings" — a post-mortem renderer has nothing to gate).
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional

__all__ = ["render", "main"]

# counters worth surfacing even when a reader doesn't know what to grep
_INTERESTING_PREFIXES = ("serve.", "compile.", "fault.", "retry.",
                         "recover.", "spill.", "flightrec.",
                         "shuffle.strategy.", "devmem.", "plan.cache",
                         "lock.", "matview.")


def _fmt_ts(t: Optional[float]) -> str:
    if not t:
        return "?"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))


def _section(title: str) -> str:
    return f"\n-- {title} " + "-" * max(1, 60 - len(title))


def _phase_totals(trace_doc: Dict[str, Any], top: int = 8
                  ) -> List[str]:
    totals: Dict[str, float] = {}
    for ev in trace_doc.get("traceEvents", []):
        if ev.get("ph") == "X":
            totals[ev["name"]] = (totals.get(ev["name"], 0.0)
                                  + float(ev.get("dur", 0)) / 1e3)
    ranked = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
    return [f"  {name:<28} {ms:9.2f} ms" for name, ms in ranked[:top]]


def render(doc: Dict[str, Any]) -> str:
    """The bundle → one multi-section text report."""
    lines: List[str] = []
    err = doc.get("error")
    lines.append(f"flight-recorder bundle (schema {doc.get('schema')}) "
                 f"— {doc.get('reason', '?')}")
    lines.append(f"created: {_fmt_ts(doc.get('created_s'))}")
    if err:
        lines.append(f"error: {err.get('type')}: {err.get('message')}")
    else:
        lines.append("error: none (on-demand dump)")

    lines.append(_section("config fingerprint"))
    for k, v in sorted((doc.get("config") or {}).items()):
        lines.append(f"  {k} = {v}")

    alerts = [e for e in doc.get("events", [])
              if e.get("kind") in ("alert", "deadline_miss")]
    lines.append(_section(f"SLO alerts + deadline misses "
                          f"({len(alerts)})"))
    for e in alerts[-12:]:
        if e["kind"] == "alert":
            lines.append(f"  [{_fmt_ts(e.get('t'))}] ALERT "
                         f"{e.get('rule')}: {e.get('detail')}")
        else:
            lines.append(f"  [{_fmt_ts(e.get('t'))}] DEADLINE MISS "
                         f"{e.get('query')}: {e.get('latency_ms')} ms vs "
                         f"{e.get('deadline_ms')} ms budget")

    queries = doc.get("queries", [])
    lines.append(_section(f"last {len(queries)} queries"))
    for q in queries:
        state = q.get("status", "?")
        tail = (f" [{q.get('error')}]" if q.get("error") else "")
        lines.append(f"  #{q.get('qid', '?'):>4} {q.get('label', '?'):<12} "
                     f"{state:<9} {q.get('latency_ms', '?'):>9} ms"
                     f"{tail}")

    # elasticity timeline (docs/robustness.md "Elasticity"): device
    # losses, the evacuations that answered them, and the scale-UP
    # half — damped/applied rejoins, SLO-driven capacity requests and
    # the expansions that fulfilled them — in ring order: the "what
    # happened to the fleet" view of a post-mortem
    mesh = [e for e in doc.get("events", [])
            if e.get("kind") in ("mesh_degraded", "mesh_expanded",
                                 "mesh_join_damped", "capacity_request")
            or (e.get("kind") == "recover"
                and e.get("action") in ("remesh", "scaleup"))]
    if mesh:
        lines.append(_section(f"elasticity timeline ({len(mesh)})"))
        for e in mesh[-12:]:
            kind = e.get("kind")
            sess = (f" (session {e.get('session')})"
                    if e.get("session") else "")
            if kind == "mesh_degraded":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] MESH DEGRADED: lost "
                    f"{e.get('lost', '?')} device(s) -> "
                    f"{e.get('survivor_world', '?')} survivors{sess}")
            elif kind == "mesh_expanded":
                world = e.get("new_world", e.get("world", "?"))
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] MESH EXPANDED: "
                    f"+{e.get('joined', '?')} device(s) -> "
                    f"{world} world{sess}")
            elif kind == "mesh_join_damped":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] JOIN DAMPED: "
                    f"{e.get('pending', '?')} rejoin(s) held "
                    f"(flap window {e.get('cooldown_ms', '?')} ms)")
            elif kind == "capacity_request":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] CAPACITY REQUEST "
                    f"[{e.get('rule', '?')}]{sess}: "
                    f"{e.get('detail', '')}")
            elif e.get("action") == "scaleup":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] SCALE-UP: evacuated "
                    f"{e.get('evacuated_bytes', '?')} B, resumed on "
                    f"{e.get('new_world', '?')} devices "
                    f"({e.get('note', '')})")
            else:
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] REMESH: evacuated "
                    f"{e.get('evacuated_bytes', '?')} B, resumed on "
                    f"{e.get('survivor_world', '?')} survivors "
                    f"[{e.get('error', '')}]")

    # concurrency discipline (docs/static_analysis.md): the lock-order
    # DAG as witnessed this run, any AB/BA inversions, and releases
    # that tripped the hold-time watchdog — rendered whenever the
    # bundle carries lock events, because a post-mortem of a hang IS
    # the case these sections exist for
    edges = [e for e in doc.get("events", [])
             if e.get("kind") == "lock_edge"]
    if edges:
        lines.append(_section(f"lock-order DAG ({len(edges)} edges)"))
        for e in edges[-16:]:
            lines.append(f"  {e.get('src')} -> {e.get('dst')} "
                         f"(first: thread {e.get('thread', '?')!r} "
                         f"at {e.get('site', '?')})")
    violations = [e for e in doc.get("events", [])
                  if e.get("kind") == "lock_violation"]
    if violations:
        lines.append(_section(f"lock-order violations "
                              f"({len(violations)})"))
        for e in violations[-8:]:
            lines.append(f"  [{_fmt_ts(e.get('t'))}] thread "
                         f"{e.get('thread', '?')!r}: "
                         f"{e.get('src')} -> {e.get('dst')} inverts the "
                         f"recorded order")
            lines.append(f"    held here:  {e.get('chain_held')}")
            lines.append(f"    recorded:   {e.get('chain_prior')}")
    holds = [e for e in doc.get("events", [])
             if e.get("kind") == "lock_hold"]
    if holds:
        lines.append(_section(f"lock hold-time watchdog ({len(holds)})"))
        for e in holds[-8:]:
            lines.append(f"  [{_fmt_ts(e.get('t'))}] {e.get('lock')} "
                         f"held {e.get('held_ms', '?')} ms "
                         f"(watchdog {e.get('watchdog_ms', '?')} ms) on "
                         f"thread {e.get('thread', '?')!r}")

    # materialized-view lifecycle (docs/serving.md "Materialized
    # subplans"): retains, hits, delta folds and invalidations in ring
    # order — a serving post-mortem's "was the cache helping or
    # thrashing" view
    views = [e for e in doc.get("events", [])
             if e.get("kind") == "matview"]
    if views:
        lines.append(_section(f"materialized views ({len(views)})"))
        for e in views[-12:]:
            act = e.get("action", "?")
            if act == "retain":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] RETAIN {e.get('label', '?')}: "
                    f"{e.get('bytes', '?')} B pooled, foldable="
                    f"{e.get('foldable', '?')}")
            elif act == "fold":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] FOLD {e.get('label', '?')}: "
                    f"{e.get('rows', '?')} delta row(s) merged")
            elif act == "invalidate":
                lines.append(
                    f"  [{_fmt_ts(e.get('t'))}] INVALIDATE "
                    f"{e.get('label', '?')}: {e.get('why', '?')}")
            else:
                lines.append(f"  [{_fmt_ts(e.get('t'))}] "
                             f"{act.upper()} {e.get('label', '?')}")

    choices = [e for e in doc.get("events", [])
               if e.get("kind") == "exchange_choice"]
    if choices:
        lines.append(_section(f"exchange choices ({len(choices)})"))
        for e in choices[-8:]:
            lines.append(f"  {e.get('strategy')}: {e.get('reason')}")

    counters = (doc.get("counters") or {}).get("counters", {})
    marks = (doc.get("counters") or {}).get("watermarks", {})
    lines.append(_section("counters of interest"))
    rows = [(k, v, "") for k, v in counters.items()
            if k.startswith(_INTERESTING_PREFIXES) and v]
    rows += [(k, v, " (max)") for k, v in marks.items()
             if k.startswith(_INTERESTING_PREFIXES) and v]
    for k, v, tag in sorted(rows):
        lines.append(f"  {k} = {v}{tag}")
    if not rows:
        lines.append("  (none recorded — tracing/counters were off)")

    phases = _phase_totals(doc.get("trace") or {})
    lines.append(_section("hottest phases (embedded trace)"))
    lines.extend(phases if phases else
                 ["  (no spans recorded — tracing was off)"])

    lines.append(_section("ring"))
    lines.append(f"  {len(doc.get('events', []))} events retained, "
                 f"{doc.get('events_dropped', 0)} dropped")

    suppressed = counters.get("flightrec.dumps_suppressed")
    if suppressed:
        lines.append(f"  NOTE: {suppressed} later auto-dump(s) were "
                     f"suppressed after the per-process cap — this "
                     f"bundle may not cover the most recent failure")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = [a for a in argv if not a.startswith("-")]
    if len(paths) != 1:
        print("usage: python -m cylon_tpu_torch.observe.doctor BUNDLE.json",
              file=sys.stderr)
        return 2
    try:
        with open(paths[0]) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"doctor: cannot read bundle {paths[0]}: {e}",
              file=sys.stderr)
        return 2
    if not isinstance(doc, dict) or "events" not in doc:
        print(f"doctor: {paths[0]} is not a flight-recorder bundle",
              file=sys.stderr)
        return 2
    print(render(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
