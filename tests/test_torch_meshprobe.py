"""The measured cost model: the port's ``parallel/meshprobe.py``,
``cost.predicted_ms`` and the measured ranking of ``cost.choose`` /
``shuffle._choose`` (``CYLON_COST_MEASURED``) against the JAX package's
(the cases of ``tests/test_telemetry.py``, ``tests/test_hierarchy.py``
and ``tests/test_diagnosis.py``).

The same ``MeshProfile`` coefficients installed in both packages give
the same predicted milliseconds and the same measured choice, reason
string included, on a seeded matrix of count matrices; end to end at
world 8 the measured chooser routes the same exchanges onto the same
lowerings with the same rows, shards and slow-axis bytes.  Port only:
the probe itself on the CPU world (keys, samples, caching, per-axis
fits, no spill tally, ``CYLON_MESHPROBE_PATH``, fingerprints), the
``exchange_ms`` / ``peak`` audit columns through EXPLAIN ANALYZE and the
stats store, the switch and the flight recorder's snapshot, and a plan
check that probes and moves nothing."""
import json
import re

import numpy as np
import pytest
import torch

from cylon_tpu import config as jconfig
from cylon_tpu import observe as jobserve
from cylon_tpu.parallel import cost as jcost
from cylon_tpu.parallel import meshprobe as jmeshprobe
from cylon_tpu.parallel import shuffle_table as jshuffle_table
from cylon_tpu.status import CylonError as JCylonError

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import observe as tobserve
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import trace as ttrace
from cylon_tpu_torch.analysis import plan_check as tplan_check
from cylon_tpu_torch.context import LocalCommunicator
from cylon_tpu_torch.observe import flightrec as tflightrec
from cylon_tpu_torch.observe import stats as tstats
from cylon_tpu_torch.parallel import DTable, dist_groupby
from cylon_tpu_torch.parallel import cost as tcost
from cylon_tpu_torch.parallel import meshprobe as tmeshprobe
from cylon_tpu_torch.parallel import shuffle_table as tshuffle_table

from test_torch_common import jax_trace_shim  # noqa: F401
from test_torch_dist_join import _both_dtables
from test_torch_hierarchy import SLOW, _jax_leaves, _port_leaves, _skewed
from test_torch_redistribution import (assert_same_run, mixed_key_table,
                                       run_both)

COLLS = ("all_to_all", "ppermute", "all_gather")
LEGS = ("h2d", "d2h")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("CYLON_COST_MEASURED", raising=False)
    monkeypatch.delenv("CYLON_MESHPROBE_PATH", raising=False)
    monkeypatch.delenv("CYLON_MESH_SHAPE", raising=False)
    tmeshprobe.clear_profiles()
    jmeshprobe.clear_profiles()
    yield
    tconfig.set_cost_measured(None)
    jconfig.set_cost_measured(None)
    tconfig.set_mesh_shape(None)
    tmeshprobe.clear_profiles()
    jmeshprobe.clear_profiles()
    ttrace.disable_counters()
    ttrace.reset()


def _coefficients(kind: str):
    """(latency_s, bytes_per_s) of a synthetic profile: ``flat`` (the
    collectives and the host legs), ``edge`` (plus every per-axis key)
    or ``partial`` (``edge`` without ``all_gather`` and
    ``ppermute@slow``: a collective left unmeasured)."""
    lat, bw = {}, {}
    for i, c in enumerate(COLLS + LEGS):
        lat[c] = 2e-5 * (i + 1)
        bw[c] = 1.5e9 * (i + 2)
    if kind != "flat":
        for i, c in enumerate(COLLS):
            lat[c + "@fast"], bw[c + "@fast"] = 1e-6 * (i + 1), 4e10 / (i + 1)
            lat[c + "@slow"], bw[c + "@slow"] = 3e-4 * (i + 1), 2e7 / (i + 1)
    if kind == "partial":
        for c in ("all_gather", "ppermute@slow"):
            del lat[c], bw[c]
    return lat, bw


def _profiles(kind: str, split=None):
    """The same coefficients as a profile of each package."""
    lat, bw = _coefficients(kind)
    return (tmeshprobe.MeshProfile(("t",), dict(lat), dict(bw), (),
                                   axis_split=split),
            jmeshprobe.MeshProfile(("j",), dict(lat), dict(bw), (),
                                   axis_split=split))


def _matrix():
    """(P, cap, counts, rbytes, budget, staged_ok): P 4 and 8, skewed
    and uniform counts, budgets from far under single-shot's price
    (chunked floors, staged-spill) to ample, plain and combine-spec."""
    rng = np.random.default_rng(16)
    out = []
    for P in (4, 8):
        for shape in ("skewed", "uniform"):
            for _ in range(2):
                if shape == "uniform":
                    c = rng.integers(50, 300, (P, P))
                else:
                    c = rng.integers(0, 20, (P, P))
                    c[np.arange(P), (np.arange(P) + P // 2) % P] += \
                        rng.integers(500, 5000, P)
                c = c.astype(np.int64)
                cap = int(c.sum(axis=1).max()) + int(rng.integers(0, 64))
                rbytes = int(rng.choice([4, 12, 40]))
                ss = jcost.single_shot_bytes(
                    P, jcost.exchange_sizes(c)[:2], rbytes)
                for frac in (0.02, 0.3, 0.9, 2.0):
                    for staged_ok in (True, False):
                        out.append((P, cap, c, rbytes,
                                    max(int(ss * frac), 1), staged_ok))
    return out


MATRIX = _matrix()
SPLITS = [None, (2, 4), (4, 2)]


def _both_candidates(case, split):
    P, cap, c, rbytes, budget, staged_ok = case
    kw = dict(staged_ok=staged_ok, spill_ok=True, split=split)
    return (tcost.enumerate_strategies(P, cap, c, rbytes, budget, **kw),
            jcost.enumerate_strategies(P, cap, c, rbytes, budget, **kw))


@pytest.mark.parametrize("split", SPLITS, ids=str)
@pytest.mark.parametrize("kind", ["flat", "edge", "partial"])
def test_predicted_ms_equals_jax(kind, split):
    tprof, jprof = _profiles(kind, split)
    nones = 0
    for case in MATRIX:
        tc, jc = _both_candidates(case, split)
        assert [c.strategy for c in tc] == [c.strategy for c in jc]
        for a, b in zip(tc, jc):
            pa_, pb = tcost.predicted_ms(a, tprof), jcost.predicted_ms(b, jprof)
            assert (pa_ is None) == (pb is None), (a.strategy, case[:2])
            if pa_ is None:
                nones += 1
            else:
                assert pa_ == pytest.approx(pb, rel=1e-12, abs=0)
        assert tcost.predicted_ms(tc[0], None) is None
    # the partial profile leaves the allgather unmeasured, the flat one
    # every per-axis key a hierarchical lowering needs
    assert (nones > 0) == (kind == "partial"
                           or (kind == "flat" and split is not None))


@pytest.mark.parametrize("split", SPLITS, ids=str)
@pytest.mark.parametrize("kind", ["flat", "edge", "partial"])
def test_measured_choose_equals_jax(kind, split):
    """The measured arm: the same strategy, reason string and
    feasibility as the JAX package's on every case; unmeasured
    collectives fall to the back."""
    tprof, jprof = _profiles(kind, split)
    for case in MATRIX:
        budget = case[4]
        tc, jc = _both_candidates(case, split)
        tp, tr, tf = tcost.choose(tc, budget, profile=tprof, measured=True)
        jp, jr, jf = jcost.choose(jc, budget, profile=jprof, measured=True)
        assert (tp.strategy, tr, tf) == (jp.strategy, jr, jf)
        if tf and tp.strategy != tcost.STAGED_SPILL:
            assert tr.startswith("measured ranking")
            assert (tcost.predicted_ms(tp, tprof) is None) == \
                ("unmeasured" in tr)


def test_forced_and_exclude_beat_measured_ranking():
    """``forced`` still short-circuits the measured ranking, and
    ``exclude`` still removes the demoted lowerings from it (the JAX
    package's results); with ``measured=False`` the profile is unread."""
    tprof, jprof = _profiles("edge", (2, 4))
    for case in MATRIX[::5]:
        budget = case[4]
        tc, jc = _both_candidates(case, (2, 4))
        for kw in ({"forced": tcost.RING}, {"exclude": ("single-shot",
                                                        "allgather")},
                   {"exclude": ("single-shot",), "measured": False}):
            kw.setdefault("measured", True)
            tp, tr, tf = tcost.choose(tc, budget, profile=tprof, **kw)
            jp, jr, jf = jcost.choose(jc, budget, profile=jprof, **kw)
            assert (tp.strategy, tr, tf) == (jp.strategy, jr, jf)
            if "forced" in kw and tcost.RING in [c.strategy for c in tc]:
                assert tp.strategy == tcost.RING
            if "exclude" in kw and len(tc) > 2:
                assert tp.strategy not in kw["exclude"]


# ---------------------------------------------------------------------------
# end to end at world 8
# ---------------------------------------------------------------------------

def _steep(pkg_meshprobe, fp):
    """The per-edge profile of the JAX suite's ``_install_steep_profile``:
    fast edges 1 GB/s / 1 us, slow edges 1 MB/s / 100 us."""
    lat = {c: 1e-5 for c in COLLS + LEGS}
    bw = {c: 1e10 for c in COLLS + LEGS}
    for c in COLLS:
        lat[c + "@fast"], bw[c + "@fast"] = 1e-6, 1e9
        lat[c + "@slow"], bw[c + "@slow"] = 1e-4, 1e6
    return pkg_meshprobe.MeshProfile(fp, lat, bw, (), axis_split=(2, 4))


def _install_steep(dctx, monkeypatch):
    monkeypatch.setenv("CYLON_MESH_SHAPE", "2x4")
    tfp = tmeshprobe.mesh_fingerprint(pt.CylonContext(device="cpu", world=8))
    assert tfp[1][-1] == "split=2x4"
    tmeshprobe.put_profile(_steep(tmeshprobe, tfp))
    jmeshprobe.put_profile(_steep(jmeshprobe,
                                  jmeshprobe.mesh_fingerprint(dctx)))
    tconfig.set_cost_measured(True)
    jconfig.set_cost_measured(True)


def test_measured_skewed_shuffle_picks_hierarchy_as_jax(dctx, jax_trace_shim,
                                                        monkeypatch):
    """The one-peer cross-slow pattern under the steep per-edge profile:
    the measured chooser itself picks the hierarchy in both packages,
    with the same rows per shard in order, ``outcap`` and slow-axis
    tallies, and fewer slow bytes than the flat exchange's slow share."""
    _install_steep(dctx, monkeypatch)
    pid, vals = _skewed()
    got = _port_leaves(None, pid, vals)
    want = _jax_leaves(dctx, None, pid, vals)
    assert got[0] == want[0] and got[1] == want[1]
    for k in SLOW + ("shuffle.strategy.hierarchical",
                     "shuffle.strategy.single_shot"):
        assert got[2].get(k, 0) == want[2].get(k, 0), k
    assert got[2]["shuffle.strategy.hierarchical"] == 1
    flat = _port_leaves("single-shot", pid, vals)
    assert [sorted(s) for s in got[0]] == [sorted(s) for s in flat[0]]
    assert 0 < got[2]["shuffle.bytes_sent_slow"] \
        < flat[2]["shuffle.bytes_sent_slow"]


def test_measured_uniform_traffic_keeps_single_shot_as_jax(
        dctx, jax_trace_shim, monkeypatch):
    """Uniform all-peers traffic: the hierarchy's extra hop does not pay
    even under the steep profile, in both packages."""
    _install_steep(dctx, monkeypatch)
    pid = (np.arange(8 * 2048) % 8).astype(np.int32)
    vals = np.arange(8 * 2048, dtype=np.int32)
    got = _port_leaves(None, pid, vals)
    want = _jax_leaves(dctx, None, pid, vals)
    assert got[0] == want[0] and got[1] == want[1]
    for k in SLOW + ("shuffle.strategy.single_shot",):
        assert got[2].get(k, 0) == want[2].get(k, 0), k
    assert got[2]["shuffle.strategy.single_shot"] == 1
    assert "shuffle.strategy.hierarchical" not in got[2]


def test_ring_flip_profile_routes_shuffle_table_as_jax(ctx, dctx,
                                                       jax_trace_shim):
    """A profile whose ppermute is measured far faster than its
    all_to_all steers a real ``shuffle_table`` onto the ring in both
    packages: the same rows, counters and ``exchange=`` reason."""
    jt, tt = _both_dtables(ctx, dctx, 8, mixed_key_table())
    lat = {"all_to_all": 1.0, "ppermute": 1e-7, "all_gather": 1.0}
    bw = {"all_to_all": 1e6, "ppermute": 1e12, "all_gather": 1e6}
    tmeshprobe.put_profile(tmeshprobe.MeshProfile(
        tmeshprobe.mesh_fingerprint(tt.ctx), dict(lat), dict(bw), ()))
    jmeshprobe.put_profile(jmeshprobe.MeshProfile(
        jmeshprobe.mesh_fingerprint(dctx), dict(lat), dict(bw), ()))
    tconfig.set_cost_measured(True)
    jconfig.set_cost_measured(True)
    got, want = run_both(jt, tt, lambda t: jshuffle_table(t, ["ki"]),
                         lambda t: tshuffle_table(t, ["ki"]))
    assert_same_run(got, want)
    assert got[1]["shuffle.strategy.ring"] == 1
    assert got[2][0][1].startswith("ring: measured ranking: ring")


# ---------------------------------------------------------------------------
# the probe on the CPU world
# ---------------------------------------------------------------------------

SMALL = (1 << 10, 1 << 12)


def test_probe_fits_and_caches_per_fingerprint():
    ctx = pt.CylonContext(device="cpu", world=8)
    assert tmeshprobe.get_profile(ctx) is None   # the read side never probes
    prof = tmeshprobe.probe(ctx, sizes=SMALL, reps=1)
    assert set(prof.latency_s) == set(tmeshprobe.COLLECTIVES
                                      + tmeshprobe.TRANSFERS)
    for c in prof.latency_s:
        assert prof.latency_s[c] >= 0 and prof.bytes_per_s[c] > 0
    assert prof.fingerprint == tmeshprobe.mesh_fingerprint(ctx)
    assert prof.axis_split is None
    assert len(prof.samples) == len(SMALL) * 5
    # the wire bytes of the JAX probe: (P-1)·m·4, n·4, (P-1)·n·4, and the
    # whole payload for each host leg
    n = SMALL[0] // 4
    assert [s[1] for s in prof.samples[:5]] == \
        [7 * (n // 8) * 4, n * 4, 7 * n * 4, 8 * n * 4, 8 * n * 4]
    assert tmeshprobe.probe(ctx) is prof                  # a cache hit
    assert tmeshprobe.get_profile(ctx) is prof
    again = tmeshprobe.probe(ctx, sizes=(1 << 10,), reps=1, force=True)
    assert again is not prof and len(again.samples) == 5
    assert prof.describe().startswith("all_to_all: ")


def test_probe_fits_per_axis_coefficients_under_split():
    tconfig.set_mesh_shape((2, 4))
    ttrace.enable_counters()
    ttrace.reset()
    prof = tmeshprobe.probe(pt.CylonContext(device="cpu", world=8),
                            sizes=SMALL, reps=1)
    c = ttrace.counters()
    assert prof.axis_split == (2, 4)
    for coll in COLLS:
        for edge in ("fast", "slow"):
            assert prof.bytes_per_s[f"{coll}@{edge}"] > 0
    assert len(prof.samples) == len(SMALL) * (5 + 6)
    assert c["meshprobe.probes"] == 1 and c["meshprobe.axis_probes"] == 1
    # per edge: (G-1)·m·4 for the group of G = 4 (fast) and 2 (slow)
    fast = [s for s in prof.samples if s[0] == "all_to_all@fast"]
    slow = [s for s in prof.samples if s[0] == "all_to_all@slow"]
    n = SMALL[0] // 4
    assert fast[0][1] == 3 * (n // 4) * 4 and slow[0][1] == (n // 2) * 4


def test_probe_books_no_spill_tally():
    """The host legs copy as the spill pool does without calling it: no
    ``spill.*`` counter, no ``spill.stage_*`` fault point."""
    from cylon_tpu_torch import faults
    ttrace.enable_counters()
    ttrace.reset()
    plan = faults.FaultPlan(0, [faults.FaultRule("spill.stage_in",
                                                 kind="transient"),
                                faults.FaultRule("spill.stage_out",
                                                 kind="transient")])
    with faults.active(plan):
        tmeshprobe.probe(pt.CylonContext(device="cpu", world=4),
                         sizes=SMALL, reps=1)
    c = ttrace.counters()
    assert not [k for k in c if k.startswith("spill.")], c
    assert c.get("fault.injected", 0) == 0


def test_meshprobe_path_round_trip(tmp_path, monkeypatch):
    """``CYLON_MESHPROBE_PATH``: a probe persists, a cleared cache
    reloads the same coefficients, and each record has the JAX package's
    layout (one calibrate reads either file)."""
    path = tmp_path / "meshprobe.json"
    monkeypatch.setenv("CYLON_MESHPROBE_PATH", str(path))
    ctx = pt.CylonContext(device="cpu", world=8)
    prof = tmeshprobe.probe(ctx, sizes=(1 << 10,), reps=1, force=True)
    tmeshprobe.clear_profiles()
    loaded = tmeshprobe.get_profile(ctx)
    assert loaded is not None and loaded is not prof
    assert loaded.latency_s == pytest.approx(prof.latency_s)
    assert loaded.bytes_per_s == pytest.approx(prof.bytes_per_s)
    assert loaded.samples == tuple(tuple(s) for s in prof.samples)
    jpath = tmp_path / "jax.json"
    monkeypatch.setenv("CYLON_MESHPROBE_PATH", str(jpath))
    lat, bw = _coefficients("edge")
    jmeshprobe.put_profile(jmeshprobe.MeshProfile(
        ("x", ("d0", "d1")), lat, bw, (("h2d", 4, 1e-5),),
        axis_split=(2, 1)))
    (trec,) = json.loads(path.read_text()).values()
    (jrec,) = json.loads(jpath.read_text()).values()
    assert sorted(trec) == sorted(jrec)
    assert {k: type(v) for k, v in trec.items() if k != "axis_split"} == \
        {k: type(v) for k, v in jrec.items() if k != "axis_split"}
    assert trec["axis"] == "local" and trec["fingerprint"][0] == "cpu"


def test_fingerprints_tell_communicators_apart(tmp_path):
    """Two contexts of world 4 on one device, one over
    ``LocalCommunicator`` and one over a gloo ``ProcessCommunicator`` of
    one process, get different fingerprints and profiles; the process
    context of one process probes normally."""
    local = pt.CylonContext(device="cpu", world=4)
    proc = pt.CylonContext.InitMultiHost(f"file://{tmp_path}/store", 1, 0,
                                         world=4, device="cpu",
                                         backend="gloo", timeout=60)
    try:
        fl, fp = (tmeshprobe.mesh_fingerprint(local),
                  tmeshprobe.mesh_fingerprint(proc))
        assert fl != fp and fl[1] == fp[1] and fp[0] == "gloo"
        prof = tmeshprobe.probe(proc, sizes=SMALL, reps=1)
        assert prof.fingerprint == fp
        assert set(prof.bytes_per_s) == set(COLLS + LEGS)
        assert tmeshprobe.get_profile(local) is None
        assert tmeshprobe.probe(local, sizes=SMALL, reps=1) is not prof
    finally:
        proc.finalize()


def test_rebuilt_context_reuses_the_profile():
    prof = tmeshprobe.probe(pt.CylonContext(device="cpu", world=8),
                            sizes=SMALL, reps=1)
    assert tmeshprobe.get_profile(pt.CylonContext(device="cpu",
                                                  world=8)) is prof
    assert tmeshprobe.get_profile(pt.CylonContext(device="cpu",
                                                  world=4)) is None
    tconfig.set_mesh_shape((2, 4))   # another axis split: another profile
    assert tmeshprobe.get_profile(pt.CylonContext(device="cpu",
                                                  world=8)) is None


def test_meta_context_has_no_profile(tmp_path, monkeypatch):
    """A meta context (the abstract plan check's view) gets None without
    reading the file, and cannot be probed."""
    monkeypatch.setenv("CYLON_MESHPROBE_PATH", str(tmp_path / "m.json"))
    ctx = pt.CylonContext(device="cpu", world=8)
    tmeshprobe.probe(ctx, sizes=(1 << 10,), reps=1)
    tmeshprobe.clear_profiles()
    reads = []
    real = tmeshprobe._load_persisted
    monkeypatch.setattr(tmeshprobe, "_load_persisted",
                        lambda fp: reads.append(fp) or real(fp))
    meta = ctx.with_device("meta")
    assert tmeshprobe.get_profile(meta) is None and reads == []
    with pytest.raises(pt.CylonError):
        tmeshprobe.probe(meta)
    assert tmeshprobe.get_profile(ctx) is not None and len(reads) == 1


# ---------------------------------------------------------------------------
# the audit columns
# ---------------------------------------------------------------------------

def _predicted(report):
    """(op, the exchange_ms annotation without its observed times)."""
    return [(n.op, re.sub(r"observed [0-9.]+", "observed ?",
                          n.info.get("exchange_ms") or ""))
            for n in report.nodes]


def test_analyze_exchange_ms_with_a_profile_and_none_without(
        ctx, dctx, jax_trace_shim):
    """With the same coefficients installed in both packages every
    exchange carries the same predicted ms; without a profile neither
    package annotates one."""
    jt, tt = _both_dtables(ctx, dctx, 8, mixed_key_table())
    lat, bw = _coefficients("flat")
    tmeshprobe.put_profile(tmeshprobe.MeshProfile(
        tmeshprobe.mesh_fingerprint(tt.ctx), dict(lat), dict(bw), ()))
    jmeshprobe.put_profile(jmeshprobe.MeshProfile(
        jmeshprobe.mesh_fingerprint(dctx), dict(lat), dict(bw), ()))
    op_t = lambda t: tshuffle_table(t, ["ki", "ks"])  # noqa: E731
    op_j = lambda t: jshuffle_table(t, ["ki", "ks"])  # noqa: E731
    got = _predicted(tobserve.analyze(op_t, tt))
    want = _predicted(jobserve.analyze(op_j, jt))
    assert got == want
    assert got[0][1].startswith("single-shot: predicted ")
    tmeshprobe.clear_profiles()
    jmeshprobe.clear_profiles()
    assert _predicted(tobserve.analyze(op_t, tt)) == \
        _predicted(jobserve.analyze(op_j, jt)) == [("shuffle_table", "")]


def test_exchange_ms_and_peak_on_one_node_through_the_stats_store(
        tmp_path, monkeypatch):
    """A probed context's analyzed, optimized run carries both audit
    columns on one exchange node, and the stats store keeps both, through
    ``CYLON_STATS_PATH``."""
    path = tmp_path / "stats.json"
    monkeypatch.setenv("CYLON_STATS_PATH", str(path))
    ctx = pt.CylonContext(device="cpu", world=4)
    tmeshprobe.probe(ctx, sizes=SMALL, reps=1)
    rng = np.random.default_rng(3)
    t = pt.Table.from_columns(ctx, {"k": rng.integers(0, 40, 400),
                                    "a": rng.normal(size=400)})
    dt = DTable.from_table(ctx, t)
    tplan.clear_plan_cache()
    tstats.STORE.clear()
    try:
        rep = dt.explain(lambda x: dist_groupby(
            tshuffle_table(x, ["k"]), ["k"], [("a", "sum")]),
            analyze=True, optimize=True)
        assert rep.ok and rep.stats_digests
        both = [n for n in rep.nodes
                if n.info.get("exchange_ms") and n.info.get("peak")]
        assert both
        rec = tstats.STORE.get(rep.stats_digests[0])
        kept = [n for n in rec["nodes"] if n["exchange_ms"] and n["peak"]]
        assert [n["exchange_ms"] for n in kept] == \
            [n.info["exchange_ms"] for n in both]
        tstats.STORE.save()
        on_disk = json.loads(path.read_text())[rep.stats_digests[0]]
        assert [n["exchange_ms"] for n in on_disk["nodes"]] == \
            [n["exchange_ms"] for n in rec["nodes"]]
    finally:
        tstats.STORE.clear()
        tplan.clear_plan_cache()


# ---------------------------------------------------------------------------
# the switch and the plan check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cost_measured_switch(pkg, monkeypatch):
    """Default off; ``CYLON_COST_MEASURED`` enables on any value but "0"
    or empty; an explicit setting wins and ``set_cost_measured`` returns
    the previous explicit setting; a non-bool raises — alike in both."""
    cfg, err = (tconfig, pt.CylonError) if pkg == "port" else \
        (jconfig, JCylonError)
    assert cfg.cost_measured_enabled() is False
    for env, on in (("1", True), ("yes", True), ("0", False), ("", False)):
        monkeypatch.setenv("CYLON_COST_MEASURED", env)
        assert cfg.cost_measured_enabled() is on, env
    monkeypatch.setenv("CYLON_COST_MEASURED", "1")
    assert cfg.set_cost_measured(False) is None
    assert cfg.cost_measured_enabled() is False
    assert cfg.set_cost_measured(None) is False
    assert cfg.cost_measured_enabled() is True
    with pytest.raises(err):
        cfg.set_cost_measured(1)


def test_flight_recorder_snapshot_shows_the_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("CYLON_MESHPROBE_PATH", str(tmp_path / "m.json"))
    tconfig.set_cost_measured(True)
    prev = tconfig.set_exchange_strategy("ring")
    try:
        snap = tflightrec.config_fingerprint()
    finally:
        tconfig.set_exchange_strategy(prev)
    assert snap["cost_measured"] is True
    assert snap["exchange_strategy"] == "ring"
    assert snap["CYLON_MESHPROBE_PATH"] == str(tmp_path / "m.json")
    tconfig.set_cost_measured(None)
    assert tflightrec.config_fingerprint()["cost_measured"] is False


def test_plan_check_with_a_profile_probes_and_moves_nothing(monkeypatch):
    """``plan_check.explain`` under the measured ranking with a profile
    installed: no probe, no collective on a real tensor, no exchange_ms
    (the meta view has no profile)."""
    ctx = pt.CylonContext(device="cpu", world=8)
    lat, bw = _coefficients("flat")
    tmeshprobe.put_profile(tmeshprobe.MeshProfile(
        tmeshprobe.mesh_fingerprint(ctx), lat, bw, ()))
    tconfig.set_cost_measured(True)
    rng = np.random.default_rng(5)
    dt = DTable.from_table(ctx, pt.Table.from_columns(
        ctx, {"k": rng.integers(0, 40, 400), "a": rng.normal(size=400)}))
    real_calls = []
    for name in ("all_to_all", "all_gather", "ppermute", "all_reduce"):
        real = getattr(LocalCommunicator, name)

        def spy(self, x, *a, _real=real, _name=name, **kw):
            if x.device.type != "meta":
                real_calls.append(_name)
            return _real(self, x, *a, **kw)
        monkeypatch.setattr(LocalCommunicator, name, spy)
    monkeypatch.setattr(tmeshprobe, "_best_of", lambda *a: 1 / 0)
    ttrace.enable_counters()
    ttrace.reset()
    rep = tplan_check.explain(lambda x: dist_groupby(
        tshuffle_table(x, ["k"]), ["k"], [("a", "sum")]), dt)
    assert rep.ok
    assert real_calls == []
    assert ttrace.counters().get("meshprobe.probes", 0) == 0
    assert not any(n.info.get("exchange_ms") for n in rep.nodes)
    assert [n.op for n in rep.nodes][0] == "shuffle_table"
