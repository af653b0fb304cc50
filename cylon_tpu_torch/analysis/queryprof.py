"""Per-fingerprint regression attribution over run-stats snapshots.

``observe.stats.StatsStore`` persists, per query fingerprint, the last
EXPLAIN ANALYZE node walk (op, ms, bytes_moved, exchange strategy,
predicted-vs-observed audit columns) plus the cheap per-run counter
slice and end-to-end latency.  Two snapshot files of that store — one
from a baseline run, one from the run under test — are enough to answer
the question an aggregate gate can't: *which query* regressed, and *which
plan node inside it*.

This module diffs two such snapshots and attributes every regression it
finds to a fingerprint digest (with its human label when recorded) and,
where node walks line up, to the individual plan node:

- end-to-end ``latency_ms`` regressions per fingerprint;
- per-node ``ms`` regressions (same-shaped plans only — node lists are
  paired positionally when the op sequences match exactly, else the
  node-level diff is skipped for that fingerprint);
- per-node ``bytes_moved`` growth;
- exchange strategy flips (the optimizer chose a different exchange
  for the same node between runs);
- predicted-vs-observed drift growth on the exchange audit columns
  (``exchange_ms`` / ``peak`` annotations), using the same annotation
  grammar as :mod:`cylon_tpu_torch.analysis.calibrate`.

Usage::

    python -m cylon_tpu_torch.analysis.queryprof OLD.json NEW.json
    python -m cylon_tpu_torch.analysis.queryprof --baseline OLD.json

(with ``NEW`` defaulting to the resolved ``CYLON_STATS_PATH``).

Exit codes follow the calibrate convention: 0 when the diff
is clean (including trivially — no overlapping fingerprints), 1 when at
least one regression finding is emitted, 2 on usage errors or an
unreadable snapshot.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

# Same annotation grammar calibrate.py parses out of EXPLAIN ANALYZE
# text: "<strategy>: predicted <x> / observed <y> <ms|bytes>".  Here the
# predicted/observed pair is already structured (exchange_ms / peak hold
# {"predicted": ..., "observed": ...}-shaped dicts or raw annotation
# strings depending on the report writer's vintage), so the regex is the
# fallback for the string form.
_ANN_RE = re.compile(
    r"([a-z-]+):\s*predicted\s+([0-9.eE+-]+)\s*/\s*observed\s+"
    r"([0-9.eE+-]+)\s*(ms|bytes)")

DEFAULT_THRESHOLD = 0.2        # 20% relative growth
DEFAULT_MIN_ABS_MS = 5.0       # ignore sub-5ms absolute deltas
DEFAULT_MIN_ABS_BYTES = 1 << 20  # ignore sub-1MiB byte deltas


def _load_snapshot(path: str) -> Dict[str, Any]:
    """Load a StatsStore JSON snapshot (digest -> record map)."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(f"snapshot {path!r}: expected a JSON object")
    return doc


def _drift_pair(value: Any) -> Optional[Tuple[float, float]]:
    """Extract (predicted, observed) from an audit column value.

    Accepts the structured dict form, a (predicted, observed) pair, or
    the calibrate annotation string; returns None when the column is
    absent or unparseable.
    """
    if value is None:
        return None
    if isinstance(value, dict):
        try:
            return (float(value["predicted"]), float(value["observed"]))
        except (KeyError, TypeError, ValueError):
            return None
    if isinstance(value, (list, tuple)) and len(value) == 2:
        try:
            return (float(value[0]), float(value[1]))
        except (TypeError, ValueError):
            return None
    if isinstance(value, str):
        m = _ANN_RE.search(value)
        if m:
            return (float(m.group(2)), float(m.group(3)))
    return None


def _drift_ratio(pair: Optional[Tuple[float, float]]) -> Optional[float]:
    """|observed - predicted| / max(predicted, tiny) — the calibrate
    drift measure; None when the pair is missing or predicted is 0."""
    if pair is None:
        return None
    predicted, observed = pair
    if predicted <= 0:
        return None
    return abs(observed - predicted) / predicted


def _fp_name(digest: str, rec: Dict[str, Any]) -> str:
    label = rec.get("label")
    short = digest[:12]
    return f"{short} ({label})" if label else short


def _regressed(old: Optional[float], new: Optional[float],
               threshold: float, min_abs: float) -> Optional[float]:
    """Return the delta when new regresses past both the relative and
    absolute floors, else None.  Metrics absent on either side never
    fire (a fingerprint newly gaining a node walk is not a regression).
    """
    if old is None or new is None:
        return None
    try:
        old_f, new_f = float(old), float(new)
    except (TypeError, ValueError):
        return None
    delta = new_f - old_f
    if delta <= min_abs:
        return None
    base = max(old_f, 1e-9)
    if delta / base <= threshold:
        return None
    return delta


def diff_snapshots(old_path: str, new_path: str,
                   threshold: float = DEFAULT_THRESHOLD,
                   min_abs_ms: float = DEFAULT_MIN_ABS_MS,
                   min_abs_bytes: float = DEFAULT_MIN_ABS_BYTES,
                   ) -> List[Dict[str, Any]]:
    """Diff two snapshot files; return the regression findings.

    Each finding is a dict with at least ``kind``, ``digest``,
    ``label``, ``old``, ``new``, ``delta``; node-level findings add
    ``node`` (index) and ``op``.  Raises OSError/ValueError/
    json.JSONDecodeError on unreadable input — callers map that to
    exit 2.
    """
    old_doc = _load_snapshot(old_path)
    new_doc = _load_snapshot(new_path)
    findings: List[Dict[str, Any]] = []

    for digest in sorted(set(old_doc) & set(new_doc)):
        old_rec, new_rec = old_doc[digest], new_doc[digest]
        if not (isinstance(old_rec, dict) and isinstance(new_rec, dict)):
            continue
        label = new_rec.get("label") or old_rec.get("label")

        def emit(kind: str, old: Any, new: Any, delta: float,
                 node: Optional[int] = None, op: Optional[str] = None,
                 detail: Optional[str] = None) -> None:
            f: Dict[str, Any] = {
                "kind": kind, "digest": digest, "label": label,
                "old": old, "new": new, "delta": delta,
            }
            if node is not None:
                f["node"], f["op"] = node, op
            if detail:
                f["detail"] = detail
            findings.append(f)

        # -- end-to-end latency per fingerprint -------------------------
        delta = _regressed(old_rec.get("latency_ms"),
                           new_rec.get("latency_ms"),
                           threshold, min_abs_ms)
        if delta is not None:
            emit("latency_ms", old_rec.get("latency_ms"),
                 new_rec.get("latency_ms"), delta)

        # -- per-node attribution (same-shaped plans only) --------------
        old_nodes = old_rec.get("nodes") or []
        new_nodes = new_rec.get("nodes") or []
        if not (old_nodes and new_nodes):
            continue
        old_ops = [n.get("op") for n in old_nodes]
        new_ops = [n.get("op") for n in new_nodes]
        if old_ops != new_ops:
            emit("plan_shape", " > ".join(map(str, old_ops)),
                 " > ".join(map(str, new_ops)), 0.0,
                 detail="plan shape changed; node diff skipped")
            continue

        for i, (o, n) in enumerate(zip(old_nodes, new_nodes)):
            op = n.get("op")
            d = _regressed(o.get("ms"), n.get("ms"),
                           threshold, min_abs_ms)
            if d is not None:
                emit("node_ms", o.get("ms"), n.get("ms"), d,
                     node=i, op=op)
            d = _regressed(o.get("bytes_moved"), n.get("bytes_moved"),
                           threshold, min_abs_bytes)
            if d is not None:
                emit("node_bytes", o.get("bytes_moved"),
                     n.get("bytes_moved"), d, node=i, op=op)
            for field, kind in (("exchange", "exchange_flip"),
                                ("decision", "decision_flip")):
                ov, nv = o.get(field), n.get(field)
                if ov is not None and nv is not None and ov != nv:
                    emit(kind, ov, nv, 0.0, node=i, op=op,
                         detail=f"{field} strategy changed")
            for col in ("exchange_ms", "peak"):
                odr = _drift_ratio(_drift_pair(o.get(col)))
                ndr = _drift_ratio(_drift_pair(n.get(col)))
                if odr is None or ndr is None:
                    continue
                if ndr - odr > threshold:
                    emit(f"drift_{col}", round(odr, 4), round(ndr, 4),
                         round(ndr - odr, 4), node=i, op=op,
                         detail="predicted-vs-observed drift grew")
    return findings


def render_findings(findings: List[Dict[str, Any]]) -> List[str]:
    """One human line per finding, fingerprint + plan node named."""
    lines: List[str] = []
    for f in findings:
        who = _fp_name(f["digest"], {"label": f.get("label")})
        where = ""
        if "node" in f:
            where = f" node[{f['node']}]={f.get('op')}"
        kind = f["kind"]
        if kind in ("exchange_flip", "plan_shape"):
            body = f"{f['old']} -> {f['new']}"
        elif kind.startswith("drift_"):
            body = (f"drift {f['old']} -> {f['new']} "
                    f"(+{f['delta']})")
        else:
            body = (f"{f['old']} -> {f['new']} "
                    f"(+{round(float(f['delta']), 3)})")
        detail = f" — {f['detail']}" if f.get("detail") else ""
        lines.append(f"{kind}: {who}{where}: {body}{detail}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.analysis.queryprof",
        description=("Diff two run-stats snapshots and attribute "
                     "regressions to fingerprints and plan nodes."))
    ap.add_argument("old", nargs="?", default=None,
                    help="baseline snapshot (or use --baseline)")
    ap.add_argument("new", nargs="?", default=None,
                    help="snapshot under test (default: "
                         "$CYLON_STATS_PATH)")
    ap.add_argument("--baseline", default=None,
                    help="baseline snapshot path (alias for OLD)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="relative growth floor (default 0.2 = 20%%)")
    ap.add_argument("--min-abs-ms", type=float, default=DEFAULT_MIN_ABS_MS,
                    help="absolute ms floor (default 5.0)")
    ap.add_argument("--min-abs-bytes", type=float,
                    default=DEFAULT_MIN_ABS_BYTES,
                    help="absolute bytes floor (default 1 MiB)")
    args = ap.parse_args(argv)

    old_path = args.baseline or args.old
    new_path = args.new if args.baseline is None else (args.new or args.old)
    if new_path is None:
        new_path = os.environ.get("CYLON_STATS_PATH") or None
    if old_path is None or new_path is None:
        ap.print_usage(sys.stderr)
        missing = ("a baseline snapshot is required" if old_path is None
                   else "no NEW snapshot and CYLON_STATS_PATH is unset")
        print(f"queryprof: {missing}", file=sys.stderr)
        return 2

    try:
        findings = diff_snapshots(
            old_path, new_path, threshold=args.threshold,
            min_abs_ms=args.min_abs_ms, min_abs_bytes=args.min_abs_bytes)
    except (OSError, ValueError) as e:  # json.JSONDecodeError is a ValueError
        print(f"queryprof: {e}", file=sys.stderr)
        return 2

    if not findings:
        print("queryprof: clean — no per-fingerprint regressions")
        return 0
    for line in render_findings(findings):
        print(line)
    print(f"queryprof: {len(findings)} finding(s)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
