"""calibrate — audit the cost model against what the hardware measured.

A priced lowering is only as good as its measured inputs
(arXiv:2112.01075): the exchange chooser ranks strategies on predicted
peak bytes and — under ``CYLON_COST_MEASURED`` — predicted collective
ms.  Before anything trusts those predictions, something must audit
them.  This CLI is the audit step:

::

    python -m cylon_tpu_torch.analysis.calibrate --stats STATS.json
    python -m cylon_tpu_torch.analysis.calibrate      # CYLON_STATS_PATH

It reads the run-stats store (``observe.stats``, populated by EXPLAIN
ANALYZE runs) plus, optionally, the meshprobe profile file
(``CYLON_MESHPROBE_PATH``; either package's, the layout is shared),
extracts every ``predicted X / observed Y`` annotation pair the
exchanges recorded — the meshprobe ms column and
the device-truth peak-bytes column (``observe.devmem``) — and reports
per-strategy prediction error percentiles and the worst-predicted
fingerprints.  Exit codes follow the shared analysis contract:

  * 0 — every gated error percentile within threshold (or no samples
    at all: an empty store is cold, not drifted);
  * 1 — the cost model drifted: a strategy's median relative error
    exceeded ``--max-ms-error`` / ``--max-bytes-error``;
  * 2 — usage / unreadable stats store.

Threshold semantics: the error of one sample is
``|observed - predicted| / predicted``; the gate compares each
(strategy, unit) group's ``--percentile``-th error against the unit's
threshold.  Defaults are deliberately loose (3.0 for ms — a fitted
α/β line on a noisy shared-CPU host is a trend, not a stopwatch; 1.0
for bytes — the CPU live-buffer observation is a documented lower
bound), tight enough to catch an order-of-magnitude drift, loose
enough not to flap in CI.
"""
from __future__ import annotations

import argparse
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["parse_annotation", "collect_samples", "calibration_report",
           "main"]

# "<strategy>: predicted 12.34 / observed 56.78 ms" — the annotation
# shape shuffle._note_exchange_ms appends (ms and bytes columns share
# it); multiple exchanges under one node join with " | "
_ANN_RE = re.compile(
    r"([a-z-]+):\s*predicted\s+([0-9.eE+-]+)\s*/\s*observed\s+"
    r"([0-9.eE+-]+)\s*(ms|bytes)")


def parse_annotation(text: Optional[str]) -> List[Tuple[str, float,
                                                        float, str]]:
    """Every ``(strategy, predicted, observed, unit)`` tuple in one
    node annotation string (empty for None/unparseable)."""
    if not text:
        return []
    out = []
    for m in _ANN_RE.finditer(text):
        try:
            out.append((m.group(1), float(m.group(2)),
                        float(m.group(3)), m.group(4)))
        except ValueError:
            continue
    return out


def collect_samples(store) -> List[Dict[str, Any]]:
    """Flatten the store into calibration samples: one dict per
    predicted/observed pair, carrying the fingerprint + label so the
    report can name the worst offenders."""
    samples: List[Dict[str, Any]] = []
    for digest in store.fingerprints():
        rec = store.get(digest) or {}
        label = rec.get("label") or digest[:8]
        for node in rec.get("nodes", []):
            for field in ("exchange_ms", "peak"):
                for strat, pred, obs, unit in \
                        parse_annotation(node.get(field)):
                    if pred <= 0:
                        continue
                    samples.append({
                        "digest": digest, "label": label,
                        "op": node.get("op"), "strategy": strat,
                        "unit": unit, "predicted": pred,
                        "observed": obs,
                        "error": abs(obs - pred) / pred,
                    })
    return samples


def _pct(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile (the serve/session definition, inlined:
    this module imports nothing heavy — it is a CI gate)."""
    rank = max(min(math.ceil(q / 100.0 * len(sorted_xs)),
                   len(sorted_xs)), 1)
    return sorted_xs[rank - 1]


def calibration_report(samples: List[Dict[str, Any]],
                       percentile: float = 50.0
                       ) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """(strategy, unit) → {n, p50, p90, worst, gate} error roll-up
    (``gate`` is the ``percentile``-th error, the number main()
    thresholds)."""
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for s in samples:
        groups.setdefault((s["strategy"], s["unit"]), []).append(s)
    out: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for key, grp in groups.items():
        errs = sorted(s["error"] for s in grp)
        worst = max(grp, key=lambda s: s["error"])
        out[key] = {
            "n": len(grp),
            "p50": _pct(errs, 50), "p90": _pct(errs, 90),
            "max": errs[-1],
            "gate": _pct(errs, percentile),
            "worst": worst,
        }
    return out


def _load_meshprobe(path: Optional[str]) -> Optional[dict]:
    path = path or os.environ.get("CYLON_MESHPROBE_PATH")
    if not path or not os.path.exists(path):
        return None
    try:
        import json
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.analysis.calibrate",
        description="audit cost-model predictions against the "
                    "run-stats store's observed numbers")
    ap.add_argument("--stats",
                    help="run-stats store JSON (default: "
                         "CYLON_STATS_PATH)")
    ap.add_argument("--meshprobe",
                    help="meshprobe profile JSON to print alongside "
                         "(default: CYLON_MESHPROBE_PATH)")
    ap.add_argument("--max-ms-error", type=float, default=3.0,
                    help="relative-error gate for the ms column "
                         "(default 3.0 = 300%%)")
    ap.add_argument("--max-bytes-error", type=float, default=1.0,
                    help="relative-error gate for the peak-bytes "
                         "column (default 1.0 = 100%%)")
    ap.add_argument("--percentile", type=float, default=50.0,
                    help="which error percentile the gates compare "
                         "(default 50 = median)")
    args = ap.parse_args(argv)

    path = args.stats or os.environ.get("CYLON_STATS_PATH")
    if not path:
        print("calibrate: no stats store — pass --stats or set "
              "CYLON_STATS_PATH", file=sys.stderr)
        return 2
    if not os.path.exists(path):
        print(f"calibrate: stats store {path} does not exist",
              file=sys.stderr)
        return 2
    from ..observe.stats import StatsStore
    store = StatsStore(path=path)
    fps = store.fingerprints()
    if not fps:
        print(f"calibrate: stats store {path} holds no records",
              file=sys.stderr)
        return 2

    probe = _load_meshprobe(args.meshprobe)
    if probe:
        print(f"meshprobe profile: {len(probe)} mesh fingerprint(s)")
        for rec in probe.values():
            lat = rec.get("latency_s", {})
            bw = rec.get("bytes_per_s", {})
            for coll in sorted(lat):
                print(f"  {coll}: {lat[coll] * 1e3:.3f} ms + "
                      f"{bw.get(coll, 0) / 1e9:.3f} GB/s")

    samples = collect_samples(store)
    print(f"calibrate: {len(fps)} fingerprint(s), "
          f"{len(samples)} predicted/observed sample(s)")
    if not samples:
        # a store without annotation pairs is COLD (no ANALYZE run with
        # a probed profile yet), not drifted — say so and stay green
        print("calibrate: no calibration samples — run EXPLAIN ANALYZE "
              "with a probed mesh (meshprobe.probe) to record "
              "predicted-vs-observed pairs")
        return 0

    report = calibration_report(samples, args.percentile)
    bad = 0
    print(f"{'strategy':<14} {'unit':<6} {'n':>4} {'p50':>8} "
          f"{'p90':>8} {'max':>8}  gate")
    for (strat, unit), row in sorted(report.items()):
        limit = (args.max_ms_error if unit == "ms"
                 else args.max_bytes_error)
        ok = row["gate"] <= limit
        flag = "ok" if ok else f"DRIFTED (> {limit:.2f})"
        if not ok:
            bad += 1
        print(f"{strat:<14} {unit:<6} {row['n']:>4} "
              f"{row['p50']:>8.3f} {row['p90']:>8.3f} "
              f"{row['max']:>8.3f}  {flag}")
        w = row["worst"]
        print(f"    worst: {w['label']} ({w['op']}) predicted "
              f"{w['predicted']:g} observed {w['observed']:g} "
              f"(err {w['error']:.2f})")
    if bad:
        print(f"\ncalibrate: {bad} (strategy, unit) group(s) drifted "
              f"past threshold — the cost model no longer matches the "
              f"hardware",
              file=sys.stderr)
        return 1
    print("\ncalibrate: cost model within threshold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
