"""The cost-model audits: the port's ``analysis/calibrate.py``,
``analysis/queryprof.py`` and ``analysis/parity.py`` against the JAX
package's (the cases of ``tests/test_diagnosis.py`` and
``tests/test_live_telemetry.py``), on the same inputs: the parsed
annotations, the exit codes, the calibration report of a stats store
the port's EXPLAIN ANALYZE wrote (read by both packages' calibrate), the
meshprobe table from either package's profile file, queryprof's findings
and exit codes, and the row-set gate's verdicts."""
import json
import math

import numpy as np
import pandas as pd
import pytest

from cylon_tpu.analysis import calibrate as jcal
from cylon_tpu.analysis import parity as jparity
from cylon_tpu.analysis import queryprof as jqp
from cylon_tpu.observe.stats import StatsStore as JStatsStore
from cylon_tpu.parallel import meshprobe as jmeshprobe

import cylon_tpu_torch as pt
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch.analysis import calibrate as tcal
from cylon_tpu_torch.analysis import parity as tparity
from cylon_tpu_torch.analysis import queryprof as tqp
from cylon_tpu_torch.observe import stats as tstats
from cylon_tpu_torch.parallel import DTable, dist_groupby, shuffle_table
from cylon_tpu_torch.parallel import meshprobe as tmeshprobe


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in ("CYLON_STATS_PATH", "CYLON_MESHPROBE_PATH"):
        monkeypatch.delenv(env, raising=False)
    tmeshprobe.clear_profiles()
    yield
    tmeshprobe.clear_profiles()
    jmeshprobe.clear_profiles()


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

ANNOTATIONS = [
    "single-shot: predicted 1.50 / observed 3.00 ms | "
    "ring: predicted 2048 / observed 1024 bytes",
    None,
    "no pairs here",
    "hierarchical: predicted 1e-3 / observed 2.5E+1 ms",
    "staged-spill: predicted 0 / observed 7 bytes (live-tensors)",
    "chunked: predicted 12.34 / observed 56.78 ms | "
    "allgather: predicted 3 / observed x ms",
]


@pytest.mark.parametrize("text", ANNOTATIONS)
def test_parse_annotation_equals_jax(text):
    assert tcal.parse_annotation(text) == jcal.parse_annotation(text)


def _write_stats(path, predicted, observed, unit="ms"):
    """The JAX suite's one-record store."""
    ann = (f"single-shot: predicted {predicted} / observed "
           f"{observed} {unit}")
    field = "exchange_ms" if unit == "ms" else "peak"
    with open(path, "w") as f:
        json.dump({"d1": {"runs": 1, "label": "q1",
                          "nodes": [{"op": "shuffle_table",
                                     field: ann}]}}, f)


def _store_case(tmp_path, case):
    path = str(tmp_path / f"{case}.json")
    if case == "ok":
        _write_stats(path, 1.0, 1.2)
    elif case == "drift":
        _write_stats(path, 1.0, 50.0)
    elif case == "bytes-drift":
        _write_stats(path, 1000, 64000, unit="bytes")
    elif case == "empty":
        with open(path, "w") as f:
            json.dump({}, f)
    elif case == "cold":
        with open(path, "w") as f:
            json.dump({"d2": {"runs": 1, "nodes": [{"op": "dist_join"}]}},
                      f)
    return path


CASES = {"ok": 0, "drift": 1, "bytes-drift": 1, "missing": 2, "empty": 2,
         "cold": 0, "no-path": 2}


@pytest.mark.parametrize("case", list(CASES))
def test_calibrate_exit_codes_equal_jax(case, tmp_path, capsys):
    argv = [] if case == "no-path" else ["--stats",
                                         _store_case(tmp_path, case)]
    got = tcal.main(list(argv))
    tout = capsys.readouterr()
    want = jcal.main(list(argv))
    jout = capsys.readouterr()
    assert got == want == CASES[case]
    assert tout.out == jout.out
    # the same message (the reference's names a document of its own)
    assert jout.err.lstrip().startswith(tout.err.strip()) and \
        bool(tout.err) == bool(jout.err)


def _analyzed_store(tmp_path, monkeypatch):
    """A stats store the port's EXPLAIN ANALYZE wrote with a probed
    profile: a shuffle + groupby plan and a HASH join, world 4."""
    path = str(tmp_path / "stats.json")
    monkeypatch.setenv("CYLON_STATS_PATH", path)
    ctx = pt.CylonContext(device="cpu", world=4)
    tmeshprobe.probe(ctx, sizes=(1 << 10, 1 << 12), reps=1)
    rng = np.random.default_rng(42)
    lt = DTable.from_table(ctx, pt.Table.from_columns(
        ctx, {"k": rng.integers(0, 40, 400), "a": rng.normal(size=400)}))
    rt = DTable.from_table(ctx, pt.Table.from_columns(
        ctx, {"k": np.arange(40), "b": rng.normal(size=40)}))
    tplan.clear_plan_cache()
    tstats.STORE.clear()
    try:
        for op in (lambda t: dist_groupby(shuffle_table(t["l"], ["k"]),
                                          ["k"], [("a", "sum")]),
                   lambda t: shuffle_table(t["r"], ["k"])):
            rep = lt.explain(op, tables={"l": lt, "r": rt}, analyze=True,
                             optimize=True)
            assert rep.ok and rep.stats_digests
        tstats.STORE.save(path)
    finally:
        tstats.STORE.clear()
        tplan.clear_plan_cache()
    return path


def test_calibration_report_equals_jax_on_a_port_store(tmp_path,
                                                       monkeypatch):
    """The port's analyze store holds both audit columns; both packages'
    calibrate read it to the same samples and the same report."""
    path = _analyzed_store(tmp_path, monkeypatch)
    tsamples = tcal.collect_samples(tstats.StatsStore(path=path))
    jsamples = jcal.collect_samples(JStatsStore(path=path))
    assert tsamples == jsamples
    assert {s["unit"] for s in tsamples} == {"ms", "bytes"}
    for pct in (50.0, 90.0):
        assert tcal.calibration_report(tsamples, pct) == \
            jcal.calibration_report(jsamples, pct)


def test_calibrate_loop_green_on_a_port_store(tmp_path, monkeypatch,
                                              capsys):
    """The acceptance loop: a probed, analyzed run's store passes the
    gate under generous thresholds in both packages, and the default
    gate gives both the same verdict."""
    path = _analyzed_store(tmp_path, monkeypatch)
    loose = ["--stats", path, "--max-ms-error", "1e9",
             "--max-bytes-error", "1e9"]
    assert tcal.main(loose) == 0 == jcal.main(loose)
    assert tcal.main(["--stats", path]) == jcal.main(["--stats", path])
    assert "cost model within threshold" in capsys.readouterr().out


def test_calibrate_prints_either_packages_meshprobe_file(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``--meshprobe`` reads the port's file and the JAX package's alike
    (one layout): both CLIs print the same coefficient table."""
    stats = _store_case(tmp_path, "ok")
    files = {}
    for pkg, mp in (("port", tmeshprobe), ("jax", jmeshprobe)):
        files[pkg] = str(tmp_path / f"{pkg}-meshprobe.json")
        monkeypatch.setenv("CYLON_MESHPROBE_PATH", files[pkg])
        mp.put_profile(mp.MeshProfile(
            (pkg, ("d0",)), {"all_to_all": 2.5e-5, "h2d": 1e-5},
            {"all_to_all": 1.2e12, "h2d": 5.4e10}, (("h2d", 4, 1e-5),)))
    monkeypatch.delenv("CYLON_MESHPROBE_PATH")
    outs = []
    for path in files.values():
        for cal in (tcal, jcal):
            assert cal.main(["--stats", stats, "--meshprobe", path]) == 0
            outs.append(capsys.readouterr().out)
    assert len(set(outs)) == 1
    assert "all_to_all: 0.025 ms + 1200.000 GB/s" in outs[0]


# ---------------------------------------------------------------------------
# queryprof
# ---------------------------------------------------------------------------

def _snap(tmp_path, name, latency, join_ms, exchange="ring",
          drift_obs=1.05, extra_node=False):
    """The JAX suite's snapshot of one fingerprint."""
    nodes = [
        {"op": "scan", "ms": 2.0, "bytes_moved": 100,
         "decision": "local", "exchange": None,
         "exchange_ms": None, "peak": None},
        {"op": "join", "ms": join_ms, "bytes_moved": 1 << 21,
         "decision": "shuffle", "exchange": exchange,
         "exchange_ms":
             f"{exchange}: predicted 1.0 / observed {drift_obs} ms",
         "peak": None}]
    if extra_node:
        nodes.append({"op": "sort", "ms": 1.0, "bytes_moved": 0,
                      "decision": None, "exchange": None,
                      "exchange_ms": None, "peak": None})
    doc = {"deadbeef0123456789": {"label": "q1", "runs": 2,
                                  "latency_ms": latency, "nodes": nodes}}
    p = str(tmp_path / name)
    with open(p, "w") as fh:
        json.dump(doc, fh)
    return p


PAIRS = {
    "latency": ({}, {"latency": 40.0}, {"latency_ms"}),
    "node-ms": ({}, {"join_ms": 30.0}, {"node_ms"}),
    "exchange-flip": ({}, {"exchange": "all-to-all"}, {"exchange_flip"}),
    "drift": ({}, {"drift_obs": 2.5}, {"drift_exchange_ms"}),
    "floors": ({}, {"latency": 12.0}, set()),
    "plan-shape": ({}, {"latency": 40.0, "extra_node": True},
                   {"latency_ms", "plan_shape"}),
}


def _pair(tmp_path, case):
    old_kw, new_kw, _ = PAIRS[case]
    base = {"latency": 10.0, "join_ms": 5.0}
    return (_snap(tmp_path, "old.json", **dict(base, **old_kw)),
            _snap(tmp_path, "new.json", **dict(base, **new_kw)))


@pytest.mark.parametrize("case", list(PAIRS))
def test_queryprof_findings_equal_jax(case, tmp_path):
    old, new = _pair(tmp_path, case)
    got = tqp.diff_snapshots(old, new)
    assert got == jqp.diff_snapshots(old, new)
    assert {f["kind"] for f in got} == PAIRS[case][2]
    assert tqp.render_findings(got) == jqp.render_findings(got)
    if case == "node-ms":
        (f,) = got
        assert (f["node"], f["op"]) == (1, "join")


@pytest.mark.parametrize("argv", ["findings", "clean", "missing", "none",
                                  "baseline"])
def test_queryprof_exit_codes_equal_jax(argv, tmp_path, capsys):
    old, new = _pair(tmp_path, "latency")
    args = {"findings": [old, new], "clean": [old, old],
            "missing": [old, str(tmp_path / "missing.json")], "none": [],
            "baseline": ["--baseline", old, new]}[argv]
    want = {"findings": 1, "clean": 0, "missing": 2, "none": 2,
            "baseline": 1}[argv]
    assert tqp.main(list(args)) == jqp.main(list(args)) == want
    out = capsys.readouterr().out
    if want == 1:
        assert "deadbeef01" in out


# ---------------------------------------------------------------------------
# parity (the row-set gate)
# ---------------------------------------------------------------------------

def _frames(case):
    rng = np.random.default_rng(9)
    base = pd.DataFrame({"k": np.arange(6, dtype=np.int64),
                         "s": ["a", "b", "c", "a", "b", "c"],
                         "x": rng.normal(size=6)})
    other = base.copy()
    if case == "categorical":
        other["s"] = pd.Categorical(other["s"])
    elif case == "nan":
        base.loc[2, "x"] = other.loc[2, "x"] = math.nan
    elif case == "near-zero":
        base["x"] = np.array([1e-9, -2e-9, 0.0, 3e-9, 1e-8, 0.0])
        other["x"] = base["x"] * 2.0
    elif case == "reordered":
        other = other.iloc[::-1]
    elif case == "renamed":
        other = other.rename(columns={"x": "y"})
    elif case == "shorter":
        other = other.iloc[:5]
    elif case == "off":
        other["x"] = other["x"] * (1 + 1e-2)
    return other, base


@pytest.mark.parametrize("case", ["categorical", "nan", "near-zero",
                                  "reordered", "renamed", "shorter", "off"])
def test_rowset_gate_equals_jax(case):
    got, want = _frames(case)
    verdict = tparity.frames_rowset_equal(got, want)
    assert verdict == jparity.frames_rowset_equal(got, want)
    assert verdict == (case in ("categorical", "near-zero", "reordered"))
    pd.testing.assert_frame_equal(tparity.canon_frame(got),
                                  jparity.canon_frame(got))
