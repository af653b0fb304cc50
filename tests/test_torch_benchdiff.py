"""The BENCH-artifact regression gate: the port's
``analysis/benchdiff.py`` against the JAX package's on the same
documents.  Every case of the JAX suite's benchdiff tests
(``tests/test_observe.py``, ``tests/test_elastic.py``) runs through both
gates: the same exit code, the same regressed / missing keys and the
same report, byte for byte; ``load_artifact``, ``diff`` and
``_gate_direction`` agree on every committed ``BENCH_r0*.json`` (read,
never written)."""
import json
import re
from pathlib import Path

import pytest

from cylon_tpu.analysis import benchdiff as jbd

from cylon_tpu_torch.analysis import benchdiff as tbd

ROOT = Path(__file__).resolve().parent.parent
BENCH_FILES = sorted(p.name for p in ROOT.glob("BENCH_r0*.json"))


def _artifact(tmp_path, name, overrides=None, drop=()):
    """The JAX suite's artifact line: the headline metric and a detail
    dict with ``overrides`` applied and ``drop`` removed."""
    detail = {"tpch_q1_ms": 100.0, "tpch_q9_ms": 400.0,
              "tpch_q9_bytes_moved": 1 << 20,
              "tpch_geomean_vs_pandas": 2.5,
              "tpch_q1_pandas_ms": 900.0, "bench_wall_s": 300.0}
    detail.update(overrides or {})
    for k in drop:
        detail.pop(k)
    line = json.dumps({"metric": "dist_join_rows_per_sec",
                       "value": 5e7, "unit": "rows/s",
                       "vs_baseline": 30.0, "detail": detail})
    p = tmp_path / name
    p.write_text(line + "\n")
    return str(p)


def _gate(mod, argv, capsys):
    """(exit code, keys flagged REGRESSED or MISSING, stdout, stderr)."""
    rc = mod.main(list(argv))
    out = capsys.readouterr()
    flagged = sorted(line.split()[0] for line in out.out.splitlines()
                     if re.search(r"\s(REGRESSED|MISSING)$", line))
    return rc, flagged, out.out, out.err


def both(argv, capsys, rc, flagged=None):
    """Both gates on ``argv``: equal outcomes, and the expected exit code
    (and flagged keys, when given)."""
    want = _gate(jbd, argv, capsys)
    got = _gate(tbd, argv, capsys)
    assert got == want
    assert got[0] == rc, got[2] + got[3]
    if flagged is not None:
        assert got[1] == sorted(flagged), got[2]
    return got


def _pair(tmp_path, tag, old, new, drop_new=()):
    return (_artifact(tmp_path, f"{tag}_old.json", old),
            _artifact(tmp_path, f"{tag}_new.json", new, drop_new))


# (name, [(old overrides, new overrides, extra argv, exit code, flagged)])
# — each row the JAX suite's assertion on the same documents
SCENARIOS = [
    ("self_vs_self", [({}, {}, [], 0, [])]),
    ("seeded_regression", [
        ({}, {"tpch_q9_ms": 700.0, "tpch_q9_bytes_moved": 4 << 20,
              "tpch_geomean_vs_pandas": 1.2}, [], 1,
         ["tpch_geomean_vs_pandas", "tpch_q9_bytes_moved", "tpch_q9_ms"])]),
    ("improvement_and_noise", [
        ({}, {"tpch_q9_ms": 300.0, "tpch_q1_ms": 100.5,
              "tpch_q1_pandas_ms": 2000.0}, [], 0, [])]),
    ("optimizer_savings", [
        ({"tpch_q3_optimizer_bytes_saved": float(1 << 20)},
         {"tpch_q3_optimizer_bytes_saved": 100.0}, [], 1,
         ["tpch_q3_optimizer_bytes_saved"]),
        ({"tpch_q3_optimizer_bytes_saved": 20000.0},
         {"tpch_q3_optimizer_bytes_saved": 0.0}, [], 0, [])]),
    ("strategy_downgrades", [
        ({"tpch_q13_strategy_downgrades": 0},
         {"tpch_q13_strategy_downgrades": 1}, [], 1,
         ["tpch_q13_strategy_downgrades"]),
        ({"tpch_q13_strategy_downgrades": 0},
         {"tpch_q13_strategy_downgrades": 0}, [], 0, [])]),
    ("exchange_bytes_peak", [
        ({"tpch_q13_exchange_bytes_peak": 1 << 20},
         {"tpch_q13_exchange_bytes_peak": 4 << 20}, [], 1,
         ["tpch_q13_exchange_bytes_peak"]),
        ({"tpch_q13_exchange_bytes_peak": 1 << 20},
         {"tpch_q13_exchange_bytes_peak": 1 << 18}, [], 0, []),
        ({"tpch_q13_exchange_bytes_peak": 1000.0},
         {"tpch_q13_exchange_bytes_peak": 9000.0}, [], 0, [])]),
    ("groupby_bytes_saved", [
        ({"tpch_q1_groupby_bytes_saved": 4 << 20},
         {"tpch_q1_groupby_bytes_saved": 1 << 20}, [], 1,
         ["tpch_q1_groupby_bytes_saved"]),
        ({"tpch_q1_groupby_bytes_saved": 4 << 20},
         {"tpch_q1_groupby_bytes_saved": 8 << 20}, [], 0, [])]),
    ("exchange_count", [
        ({"tpch_q5_exchange_count": 3.0, "tpch_q5_exchange_count_noopt": 7.0},
         {"tpch_q5_exchange_count": 7.0, "tpch_q5_exchange_count_noopt": 3.0},
         [], 1, ["tpch_q5_exchange_count"]),
        ({"tpch_q5_exchange_count": 3.0, "tpch_q5_exchange_count_noopt": 7.0},
         {"tpch_q5_exchange_count": 2.0, "tpch_q5_exchange_count_noopt": 7.0},
         [], 0, [])]),
    ("absolute_floors", [
        ({"tpch_q1_host_reads": 0, "tpch_q1_bytes_moved": 0},
         {"tpch_q1_host_reads": 1, "tpch_q1_bytes_moved": 1024}, [], 0, []),
        ({"tpch_q1_host_reads": 0, "tpch_q1_bytes_moved": 0},
         {"tpch_q1_host_reads": 50, "tpch_q1_bytes_moved": 1 << 22}, [], 1,
         ["tpch_q1_bytes_moved", "tpch_q1_host_reads"])]),
    ("threshold_knob", [
        ({}, {"tpch_q9_ms": 440.0}, [], 0, []),
        ({}, {"tpch_q9_ms": 440.0}, ["--threshold", "0.05"], 1,
         ["tpch_q9_ms"])]),
    ("serve_qps_down", [
        ({"serve_qps": 40.0}, {"serve_qps": 20.0}, [], 1, ["serve_qps"]),
        ({"serve_qps": 40.0}, {"serve_qps": 80.0}, [], 0, [])]),
    ("sustain_family", [
        ({"serve_sustain_qps": 30.0, "serve_sustain_p99_ms": 80.0,
          "serve_qps": 40.0, "serve_p99_ms": 60.0},
         {"serve_sustain_qps": 15.0, "serve_sustain_p99_ms": 200.0,
          "serve_qps": 40.0, "serve_p99_ms": 60.0}, [], 1,
         ["serve_sustain_p99_ms", "serve_sustain_qps"]),
        ({"serve_sustain_qps": 30.0, "serve_sustain_p99_ms": 80.0,
          "serve_qps": 40.0, "serve_p99_ms": 60.0},
         {"serve_sustain_qps": 60.0, "serve_sustain_p99_ms": 40.0,
          "serve_qps": 40.0, "serve_p99_ms": 60.0}, [], 0, []),
        ({"serve_sustain_qps": 30.0, "serve_sustain_steady_qps": 30.0},
         {"serve_sustain_qps": 31.0, "serve_sustain_steady_qps": 12.0},
         [], 1, ["serve_sustain_steady_qps"]),
        ({"serve_sustain_p99_ms": 2.0}, {"serve_sustain_p99_ms": 2.6},
         [], 0, [])]),
    ("mixed_family", [
        ({"serve_mixed_qps": 50.0, "serve_mixed_view_hit_ratio": 0.9,
          "serve_mixed_p99_ms": 40.0, "serve_mixed_staleness_ms": 10.0},
         {"serve_mixed_qps": 20.0, "serve_mixed_view_hit_ratio": 0.2,
          "serve_mixed_p99_ms": 160.0, "serve_mixed_staleness_ms": 10.0},
         [], 1, ["serve_mixed_p99_ms", "serve_mixed_qps",
                 "serve_mixed_view_hit_ratio"]),
        ({"serve_mixed_qps": 50.0, "serve_mixed_view_hit_ratio": 0.9,
          "serve_mixed_p99_ms": 40.0, "serve_mixed_staleness_ms": 10.0},
         {"serve_mixed_qps": 80.0, "serve_mixed_view_hit_ratio": 0.95,
          "serve_mixed_p99_ms": 25.0, "serve_mixed_staleness_ms": 5.0},
         [], 0, []),
        ({"serve_mixed_staleness_ms": 5.0},
         {"serve_mixed_staleness_ms": 500.0}, [], 0, []),
        ({"serve_mixed_view_hit_ratio": 0.99},
         {"serve_mixed_view_hit_ratio": 0.98}, [], 0, [])]),
    ("serve_p99_up", [
        ({"serve_p99_ms": 50.0, "serve_p50_ms": 20.0},
         {"serve_p99_ms": 120.0, "serve_p50_ms": 100.0}, [], 1,
         ["serve_p99_ms"]),
        ({"serve_p99_ms": 2.0}, {"serve_p99_ms": 2.6}, [], 0, [])]),
    ("scaling_slope_down", [
        ({"scaling_efficiency_slope": -0.10},
         {"scaling_efficiency_slope": -0.30}, [], 1,
         ["scaling_efficiency_slope"]),
        ({"scaling_efficiency_slope": -0.10},
         {"scaling_efficiency_slope": -0.02}, [], 0, []),
        ({"scaling_efficiency_slope": -0.100},
         {"scaling_efficiency_slope": -0.115}, [], 0, [])]),
    ("scaling_slow_wire_bytes_up", [
        ({"scaling_weak_join_wire_bytes_slow_w8": 1 << 20,
          "scaling_weak_join_wire_bytes_w8": 4 << 20},
         {"scaling_weak_join_wire_bytes_slow_w8": 4 << 20,
          "scaling_weak_join_wire_bytes_w8": 4 << 20}, [], 1,
         ["scaling_weak_join_wire_bytes_slow_w8"]),
        ({"scaling_strong_groupby_wire_bytes_slow_w4": 1000.0},
         {"scaling_strong_groupby_wire_bytes_slow_w4": 9000.0}, [], 0, [])]),
]


@pytest.mark.parametrize("name", [n for n, _ in SCENARIOS])
def test_scenario_equals_jax(tmp_path, capsys, name):
    rows = dict(SCENARIOS)[name]
    for i, (old, new, extra, rc, flagged) in enumerate(rows):
        o, n = _pair(tmp_path, f"{name}{i}", old, new)
        both([*extra, o, n], capsys, rc, flagged)
        # the library form the CLI wraps: rows and regressions alike
        assert tbd.diff(tbd.load_artifact(o), tbd.load_artifact(n)) == \
            jbd.diff(jbd.load_artifact(o), jbd.load_artifact(n))


def test_seeded_regression_sorted_worst_first(tmp_path, capsys):
    o, n = _pair(tmp_path, "worst", {},
                 {"tpch_q9_ms": 700.0, "tpch_q9_bytes_moved": 4 << 20,
                  "tpch_geomean_vs_pandas": 1.2})
    _, _, out, _ = both([o, n], capsys, 1)
    assert out.splitlines()[1].split()[0] == "tpch_q9_bytes_moved"


def test_missing_gated_metric_equals_jax(tmp_path, capsys):
    """A gated metric of OLD that NEW lacks (the query crashed) fails as
    MISSING; an ungated key that disappears stays non-fatal."""
    o = _artifact(tmp_path, "m_old.json", {"tpch_q5_ms": 120.0})
    n = _artifact(tmp_path, "m_new.json")
    both([o, n], capsys, 1, ["tpch_q5_ms"])
    o2 = _artifact(tmp_path, "m_old2.json", {"tpch_q5_pandas_ms": 999.0})
    n2 = _artifact(tmp_path, "m_new2.json", {"tpch_q5_pandas_ms": 1.0},
                   drop=("tpch_q5_pandas_ms",))
    both([o2, n2], capsys, 0, [])


def test_truncated_runner_wrapper_equals_jax(tmp_path, capsys):
    tail = ('q1_ms": 100.0, "tpch_q9_ms": 400.0, '
            '"tpch_geomean_vs_pandas": 2.5, "emitted_after": "final"}}\n'
            "[bench 03:28:40] emit after final (4189 B)\n")
    p = tmp_path / "wrapped.json"
    p.write_text(json.dumps({"n": 5, "cmd": "python bench.py", "rc": 0,
                             "tail": tail, "parsed": None}))
    vals = tbd.load_artifact(str(p))
    assert vals == jbd.load_artifact(str(p))
    assert vals["tpch_q9_ms"] == 400.0
    n = _artifact(tmp_path, "w_new.json", {"tpch_q9_ms": 900.0})
    both(["--baseline", str(p), n], capsys, 1, ["tpch_q9_ms"])


def test_parsed_wrapper_and_multi_line_output_equal_jax(tmp_path, capsys):
    """The wrapper's ``parsed`` object wins over its tail; in raw bench
    output the last full artifact line wins."""
    line = json.loads(Path(_artifact(tmp_path, "base.json")).read_text())
    p = tmp_path / "parsed.json"
    p.write_text(json.dumps({"rc": 0, "tail": '"tpch_q9_ms": 1.0',
                             "parsed": line}))
    raw = tmp_path / "raw.txt"
    later = dict(line, detail=dict(line["detail"], tpch_q9_ms=480.0))
    raw.write_text("[bench] warming up\n" + json.dumps(line) + "\n"
                   + "not json {\n" + json.dumps(later) + "\n")
    for path in (p, raw):
        assert tbd.load_artifact(str(path)) == jbd.load_artifact(str(path))
    both([str(p), str(raw)], capsys, 1, ["tpch_q9_ms"])


@pytest.mark.parametrize("case", ["no_args", "one_arg", "three_args",
                                  "unparsable", "missing_file"])
def test_usage_and_parse_errors_equal_jax(tmp_path, capsys, case):
    good = _artifact(tmp_path, "good.json")
    bad = tmp_path / "bad.json"
    bad.write_text("no numbers here\n")
    argv = {"no_args": [], "one_arg": [good],
            "three_args": [good, good, good],
            "unparsable": [str(bad), good],
            "missing_file": [str(tmp_path / "missing.json"), good]}[case]
    both(argv, capsys, 2, [])


def test_restored_qps_ratio_down_equals_jax():
    """``tests/test_elastic.py``'s scale-up family: a ratio drop past
    the threshold regresses, sub-floor jitter and improvements do not,
    the scale-up wall-clock is ungated."""
    key = "serve_meshchaos_restored_qps_ratio"
    for k in (key, "serve_meshchaos_scaleup_ms"):
        assert tbd._gate_direction(k) == jbd._gate_direction(k)
    assert tbd._gate_direction(key) == "down"
    assert tbd._gate_direction("serve_meshchaos_scaleup_ms") is None
    for old, new, regressed in ((1.0, 0.7, [key]), (1.0, 0.99, []),
                                (0.98, 1.1, [])):
        got = tbd.diff({key: old}, {key: new})
        assert got == jbd.diff({key: old}, {key: new})
        assert [r["key"] for r in got[1]] == regressed


def _gate_instances():
    """One key per gated pattern (and a few ungated neighbours)."""
    keys = ["tpch_q7_ms", "tpch_q7_bytes_moved", "tpch_q7_host_reads",
            "tpch_q7_vs_pandas", "tpch_geomean_vs_pandas",
            "dist_join_rows_per_sec", "tpch_q7_optimizer_bytes_saved",
            "tpch_q7_exchange_count", "tpch_q7_exchange_bytes_peak",
            "tpch_q7_strategy_downgrades", "tpch_q7_groupby_bytes_saved",
            "serve_qps", "serve_p99_ms", "serve_sustain_qps",
            "serve_sustain_steady_qps", "serve_sustain_p99_ms",
            "serve_sustain_p999_ms", "serve_mixed_qps",
            "serve_mixed_view_hit_ratio", "serve_mixed_p99_ms",
            "tpch_q7_recompiles", "serve_slo_violations",
            "serve_chaos_recovered_ratio", "serve_chaos_p99_ms",
            "serve_meshchaos_recovered_ratio", "serve_meshchaos_p99_ms",
            "serve_meshchaos_restored_qps_ratio", "tpch_q7_spill_bytes",
            "tpch_ooc_ok_ratio", "scaling_efficiency_slope",
            "scaling_weak_join_wire_bytes_slow",
            "scaling_x_wire_bytes_slow_w2"]
    ungated = ["tpch_q7_compile_ms_x", "serve_p50_ms_total", "serve_shed",
               "tpch_ooc_queries_ok", "serve_meshchaos_remesh_ms_x",
               "scaling_weak_join_wire_bytes_w8"]
    return keys, ungated


def test_every_gate_family_equals_jax(tmp_path, capsys):
    """Each gated family regresses in its own direction past the
    threshold and its floor, alone in the artifact, in both gates; the
    opposite move is clean."""
    keys, ungated = _gate_instances()
    assert tbd._GATES == jbd._GATES
    for pat, _ in jbd._GATES:     # every pattern has an instance
        assert any(re.search(pat, k) for k in keys), pat
    for k in keys + ungated:
        assert tbd._gate_direction(k) == jbd._gate_direction(k), k
    assert all(tbd._gate_direction(k) is None for k in ungated)
    for i, k in enumerate(keys):
        up = tbd._gate_direction(k) == "up"
        base = 1 << 22 if "bytes" in k else -0.5 if "slope" in k else 100.0
        worse = base * 4 if up else (base * 4 if "slope" in k
                                     else base / 4)
        better = base / 4 if up else (base / 4 if "slope" in k
                                      else base * 4)
        o, n = _pair(tmp_path, f"fam{i}", {k: base}, {k: worse})
        both([o, n], capsys, 1, [k])
        o, n = _pair(tmp_path, f"famok{i}", {k: base}, {k: better})
        both([o, n], capsys, 0, [])
    for i, k in enumerate(ungated):
        o, n = _pair(tmp_path, f"ung{i}", {k: 100.0}, {k: 1e6})
        both([o, n], capsys, 0, [])


@pytest.mark.parametrize("name", BENCH_FILES)
def test_committed_bench_artifact_equals_jax(capsys, name):
    """The JAX bench's committed artifacts (read only): the same parsed
    fields or the same refusal, the same gate direction for every key,
    and self against self clean in both gates."""
    path = str(ROOT / name)
    try:
        want = jbd.load_artifact(path)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tbd.load_artifact(path)
        both([path, path], capsys, 2, [])
        return
    got = tbd.load_artifact(path)
    assert got == want and got
    for k in got:
        assert tbd._gate_direction(k) == jbd._gate_direction(k), k
    both(["--baseline", path, path], capsys, 0, [])
