"""The one-command gate's findings: each stage of the port's
``analysis/ci.py`` that checks something is broken on purpose and must
exit 1 (a finding), a stage whose set-up raises exits 2, and the
seeded plan-check crash gives 1 in both packages
(``tests/test_graftlint.py``'s case).  CPU, ``--device cpu``, world 8,
SF 0.002."""
import json
import threading

import pytest

from cylon_tpu_torch import config as tconfig, plan as tplan
from cylon_tpu_torch import topology as ttopology, trace as ttrace
from cylon_tpu_torch.analysis import ci as tci
from cylon_tpu_torch.context import CylonContext
from cylon_tpu_torch.observe import exporter as texporter
from cylon_tpu_torch.observe import flightrec as tflightrec
from cylon_tpu_torch.observe import locks as tlocks
from cylon_tpu_torch.parallel import broadcast as tbroadcast
from cylon_tpu_torch.serve import session as tsession
from cylon_tpu_torch.status import Code, CylonError, Status
from cylon_tpu_torch.tpch import queries as tqueries

from test_torch_common import clear_port_hints, jax_trace_shim  # noqa: F401

DEVICE, WORLD, SF = "cpu", 8, 0.002


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        tplan.clear_plan_cache()
        clear_port_hints()
        tbroadcast.clear_replica_cache()
        ttopology.reset()
    reset()
    yield
    reset()
    # a finding must not leak a switch into the next test
    assert not ttrace.enabled() and not ttrace.counters_enabled()


def _finding(capsys, rc, what):
    out = capsys.readouterr()
    assert rc == 1, out.out[-3000:] + out.err[-3000:]
    assert what in out.err, out.err[-3000:]
    return out


def _qbad(ctx, t):
    raise CylonError(Status(Code.KeyError, "no column 'nope'"))


def test_plan_check_crash_equals_jax(monkeypatch, capsys,
                                    jax_trace_shim):  # noqa: F811
    """A query that raises a typed error is a finding in both packages'
    stage 2 (exit 1, not a traceback), eager and optimized, with the
    same report lines."""
    from cylon_tpu.analysis import ci as jci
    from cylon_tpu.status import (Code as JCode, CylonError as JError,
                                  Status as JStatus)
    from cylon_tpu.tpch import queries as jqueries

    def jbad(ctx, t):
        raise JError(JStatus(JCode.KeyError, "no column 'nope'"))

    monkeypatch.setattr(jqueries, "QUERIES", {"qbad": jbad})
    monkeypatch.setattr(tqueries, "QUERIES", {"qbad": _qbad})
    assert jci._stage_plan_check(SF) == 1
    want = capsys.readouterr().err
    assert tci._stage_plan_check(SF, DEVICE, WORLD) == 1
    got = capsys.readouterr().err
    assert got == want
    assert [ln.split(":")[1] for ln in got.splitlines()] == \
        [" qbad [eager] INVALID", " qbad [optimized] INVALID"]


def test_lint_finds_a_seeded_host_sync(monkeypatch, tmp_path, capsys):
    bad = tmp_path / "seeded.py"
    bad.write_text("import torch\n"
                   "def f(dt):\n"
                   "    return int(torch.sum(dt.counts))\n")
    monkeypatch.setattr(tci, "_repo_paths", lambda: [str(bad)])
    assert tci._stage_lint() == 1
    assert "implicit-host-sync" in capsys.readouterr().out


def test_serve_without_sharing_is_a_finding(monkeypatch, capsys):
    """The shared memo degraded to execute-everything: no cross-query
    subplan is shared."""
    monkeypatch.setattr(tsession._SharedExecMemo, "__contains__",
                        lambda self, key: dict.__contains__(self, key)
                        and False)
    monkeypatch.setattr(tsession._SharedExecMemo, "get",
                        lambda self, key, default=None: default)
    rc = tci._stage_serve_smoke(SF, DEVICE, WORLD)
    _finding(capsys, rc, "no cross-query subplan was shared")


def test_telemetry_catalogue_less_counter_is_a_finding(monkeypatch, capsys):
    submit = tsession.ServeSession.submit

    def rogue(self, *a, **k):
        ttrace.count("ci.uncatalogued_counter")
        return submit(self, *a, **k)

    monkeypatch.setattr(tsession.ServeSession, "submit", rogue)
    rc = tci._stage_telemetry_smoke(SF, DEVICE, WORLD)
    _finding(capsys, rc, "uncatalogued metrics ['ci.uncatalogued_counter']")


def test_doctor_without_a_bundle_is_a_finding(monkeypatch, capsys):
    monkeypatch.setattr(tflightrec, "maybe_dump_on_error",
                        lambda reason, error: None)
    rc = tci._stage_doctor_smoke(SF, DEVICE, WORLD)
    _finding(capsys, rc, "no flight-recorder bundle was written")


@pytest.mark.parametrize("stage,what", [
    ("_stage_chaos_smoke", "chaos smoke: RAISED: TransientFault"),
    ("_stage_mesh_smoke", "mesh-loss smoke: RAISED: TopologyFault"),
    ("_stage_scaleup_smoke", "mesh-grow smoke: RAISED: TopologyFault"),
])
def test_recovery_off_is_a_finding(stage, what, capsys):
    """With the recovery ladder off the injected fault reaches the
    victim: the stage reports it and keeps the exit contract."""
    prev = tconfig.set_recovery_enabled(False)
    try:
        rc = getattr(tci, stage)(SF, DEVICE, WORLD)
    finally:
        tconfig.set_recovery_enabled(prev)
    _finding(capsys, rc, what)
    # the stage put the roster back: the full world again
    ctx = CylonContext(device=DEVICE, world=WORLD)
    assert ttopology.effective(ctx).get_world_size() == WORLD


def test_ooc_with_the_host_tier_off_is_a_finding(capsys):
    prev = tconfig.set_spill_enabled(False)
    try:
        rc = tci._stage_ooc_smoke(SF, DEVICE, WORLD)
    finally:
        tconfig.set_spill_enabled(prev)
    out = capsys.readouterr()
    assert rc == 1, out.out[-3000:] + out.err[-3000:]
    assert "ooc smoke:" in out.err


def test_hierarchy_forced_strategy_misses_hierarchical(monkeypatch,
                                                       capsys):
    """A strategy forced from the environment: the natural leg never
    reaches the chooser, so the hierarchical lowering is not selected."""
    monkeypatch.setenv("CYLON_EXCHANGE_STRATEGY", "single-shot")
    rc = tci._stage_hierarchy_smoke(DEVICE, WORLD)
    _finding(capsys, rc, "the chooser did NOT select the hierarchical")
    assert tconfig.mesh_shape() is None
    assert not tconfig.cost_measured_enabled()


class _UncheckedLock:
    """A named lock without order checking."""

    def __init__(self, name, **kw):
        self._lock = threading.Lock()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()


def test_lockcheck_uncaught_inversion_is_a_finding(monkeypatch, capsys):
    monkeypatch.setattr(tlocks, "OrderedLock", _UncheckedLock)
    prev = tconfig.set_lockcheck(None)
    rc = tci._stage_lockcheck_smoke(DEVICE, WORLD)
    _finding(capsys, rc, "the AB/BA inversion was NOT caught")
    assert tconfig.set_lockcheck(prev) is None


def test_export_without_the_info_metric_is_a_finding(monkeypatch, capsys):
    render = texporter.render_openmetrics
    monkeypatch.setattr(
        texporter, "render_openmetrics",
        lambda: "".join(ln for ln in render().splitlines(True)
                        if "cylon_observe_config_info" not in ln))
    rc = tci._stage_export_smoke(SF, DEVICE, WORLD)
    _finding(capsys, rc, "config-fingerprint info metric missing")
    assert not texporter.running()


def test_matview_with_views_off_is_a_finding(monkeypatch, capsys):
    monkeypatch.setenv("CYLON_MATVIEW", "0")
    rc = tci._stage_matview_smoke(DEVICE, WORLD)
    _finding(capsys, rc, "window-2 repeat was not served from the view")


def test_benchdiff_regression_is_a_finding(tmp_path, capsys):
    def art(name, ms):
        p = tmp_path / name
        p.write_text(json.dumps({"metric": "dist_join_rows_per_sec",
                                 "value": 5e7,
                                 "detail": {"tpch_q5_ms": ms}}) + "\n")
        return str(p)

    rc = tci._stage_benchdiff(art("old.json", 100.0),
                              art("new.json", 200.0), 0.15)
    assert rc == 1
    out = capsys.readouterr().out
    assert "REGRESSED" in out and "tpch_q5_ms" in out


def test_setup_failure_exits_2(capsys):
    """A context that cannot be built is a tooling error (2) in every
    stage that builds one; graftlint still runs; the aggregate is 2."""
    seen = []
    assert tci.main(["--device", "no-such-device"],
                    on_stage=lambda *r: seen.append(r)) == 2
    assert [(n, rc) for n, _, rc, _ in seen] == \
        [(1, 0)] + [(n, 2) for n in range(2, 14)]
    assert capsys.readouterr().err.count("setup failed") == 12
