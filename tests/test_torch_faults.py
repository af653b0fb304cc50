"""The port's ``faults.py``, ``resilience.py`` and ``topology.py`` against
the JAX package's: the same ``FaultPlan`` seed and rules fire at the same
consultations over a few hundred calls, the retry schedules are equal,
failures fall in the same classes; and the port's own sites — the
shuffle's count read behind ``compact.read_counts`` and the budget read
behind ``resilience.budget`` — fire, retry and degrade as the JAX
package's do.  Every catalogued point is consulted at its site (the
recovery driver's and the spill pool's included)."""
import numpy as np
import pytest
import torch

from cylon_tpu import faults as jfaults
from cylon_tpu import resilience as jres
from cylon_tpu import topology as jtopo

import cylon_tpu_torch as pt
from cylon_tpu_torch import config as tconfig
from cylon_tpu_torch import faults as tfaults
from cylon_tpu_torch import resilience as tres
from cylon_tpu_torch import topology as ttopo
from cylon_tpu_torch import trace
from cylon_tpu_torch.parallel import DTable, run_pipeline, shuffle_table
from cylon_tpu_torch.parallel import dist_ops as tdops
from cylon_tpu_torch.status import Code, CylonError


@pytest.fixture(autouse=True)
def _clean():
    trace.enable_counters()
    trace.reset()
    yield
    trace.disable_counters()
    trace.reset()
    tfaults.uninstall()
    tconfig.set_device_memory_budget(None)


def _rules(f):
    """One rule set of every kind and trigger, in either package."""
    return [
        f.FaultRule("compact.read_counts", kind="transient",
                    probability=0.3),
        f.FaultRule("compact.*", kind="permanent", probability=0.05,
                    limit=3),
        f.FaultRule("io.csv.read", kind="transient", nth=7),
        f.FaultRule("exec.stage", kind="resource", probability=0.2,
                    once=True),
        f.FaultRule("mesh.device_lost", kind="topology", probability=0.1,
                    lost=2),
        f.FaultRule("mesh.device_joined", kind="topology",
                    probability=0.5, after="mesh.device_lost", window=20),
        f.FaultRule("resilience.budget", kind="value", probability=0.25,
                    mutate=lambda b: b // 8),
    ]


def _drive(f, seed: int, n: int = 300):
    """Consult every point of the JAX package's catalogue (the port's is
    the part it has sites for; a rule may name any point) in a fixed
    interleaving; returns what each consultation did, and the plan's
    tallies."""
    plan = f.FaultPlan(seed, _rules(f))
    points = sorted(jfaults.POINTS)
    log = []
    with f.active(plan):
        for i in range(n):
            point = points[(i * 7) % len(points)]
            if point == "resilience.budget":
                log.append((point, f.perturb(point, 1 << 20)))
                continue
            try:
                f.check(point)
                log.append((point, None))
            except f.FaultError as e:
                log.append((point, type(e).__name__,
                            getattr(e, "lost", None), str(e)))
    return log, plan.injected, plan.fired


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_fault_plan_fires_like_jax(seed):
    assert sorted(tfaults.POINTS) == [
        "compact.flush", "compact.hint", "compact.read_counts",
        "exec.stage", "io.csv.read",
        "matview.fold", "mesh.device_joined",
        "mesh.device_lost", "recover.checkpoint_restore", "recover.replan",
        "resilience.budget", "serve.breaker_probe", "spill.stage_in",
        "spill.stage_out"]
    assert all(tfaults.POINTS[k] == jfaults.POINTS[k]
               for k in tfaults.POINTS)
    got = _drive(tfaults, seed)
    want = _drive(jfaults, seed)
    assert got == want
    assert got[1] > 0


def test_default_plan_and_draws_equal_jax():
    """The keyed draws equal the JAX package's, at the port's points and
    at one it has no site for."""
    tp, jp = tfaults.FaultPlan(3), jfaults.FaultPlan(3)
    for point in ("compact.read_counts", "resilience.budget", "exec.stage",
                  "io.csv.read"):
        for n in range(1, 50):
            for rule in range(3):
                assert tp._draw(point, n, rule) == jp._draw(point, n, rule)


def test_fault_rule_validation():
    for kw in ({"kind": "nope"}, {"kind": "value"}, {"lost": 0},
               {"window": 3}, {"after": "x", "window": 0}):
        with pytest.raises(CylonError):
            tfaults.FaultRule("compact.read_counts", **kw)
    assert tfaults.plan() is None
    with tfaults.active(tfaults.FaultPlan(1)) as p:
        assert tfaults.plan() is p
    assert tfaults.plan() is None


def _sleeps(res, policy, n=12):
    out, prev = [], 0.0
    for attempt in range(1, n + 1):
        prev = res._next_sleep(policy, prev, attempt)
        out.append(prev)
    return out


@pytest.mark.parametrize("jitter", [False, True])
def test_retry_schedule_equals_jax(jitter):
    for kw in ({}, {"base_delay_s": 0.001, "multiplier": 3.0,
                    "max_delay_s": 0.05}):
        tres._jitter_rng.seed(11)
        jres._jitter_rng.seed(11)
        got = _sleeps(tres, tres.RetryPolicy(jitter=jitter, **kw))
        want = _sleeps(jres, jres.RetryPolicy(jitter=jitter, **kw))
        assert got == want


def _retry_run(res, f, failures: int, kind: str, attempts: int):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise {"transient": f.TransientFault,
                   "permanent": f.PermanentFault}[kind]("compact.read_counts")
        return len(calls)

    pol = res.RetryPolicy(max_attempts=attempts, base_delay_s=0.0,
                          max_delay_s=0.0, jitter=False)
    try:
        return ("ok", res.retry_call(fn, point="p", policy=pol))
    except f.FaultError as e:
        return (type(e).__name__, len(calls))


@pytest.mark.parametrize("failures,kind,attempts", [
    (0, "transient", 3), (2, "transient", 3), (3, "transient", 3),
    (1, "permanent", 5), (4, "transient", 5)])
def test_retry_call_equals_jax(failures, kind, attempts):
    from cylon_tpu import trace as jtrace
    jtrace.enable_counters()
    jtrace.reset()
    try:
        want = _retry_run(jres, jfaults, failures, kind, attempts)
        jc = jtrace.counters()
    finally:
        jtrace.disable_counters()
        jtrace.reset()
    got = _retry_run(tres, tfaults, failures, kind, attempts)
    tc = trace.counters()
    assert got == want
    for name in ("retry.attempts", "retry.exhausted"):
        assert tc.get(name, 0) == jc.get(name, 0)


def test_retry_policy_validation_and_decorator():
    """Policy validation, and ``retry_call`` under a swapped session
    policy (the ``retrying`` decorator comes with its first caller)."""
    for kw in ({"max_attempts": 0}, {"max_elapsed_s": 0},
               {"max_elapsed_s": True}):
        with pytest.raises(CylonError):
            tres.RetryPolicy(**kw)
    with pytest.raises(CylonError):
        tres.set_retry_policy("x")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("blip")
        return "done"

    prev = tres.set_retry_policy(tres.RetryPolicy(base_delay_s=0.0,
                                                  jitter=False))
    try:
        assert tres.retry_call(flaky) == "done" and len(calls) == 3
    finally:
        tres.set_retry_policy(prev)
    assert trace.counters()["retry.attempts"] == 2


def test_classify_and_ladder_equal_jax():
    """The failure classes equal the JAX package's (the ladder that acts
    on them comes with the recovery driver)."""
    oom = Code.OutOfMemory
    pairs = [
        (tfaults.TransientFault("x"), jfaults.TransientFault("x")),
        (tfaults.ResourceFault("x"), jfaults.ResourceFault("x")),
        (tfaults.PermanentFault("x"), jfaults.PermanentFault("x")),
        (tfaults.TopologyFault("x", 2), jfaults.TopologyFault("x", 2)),
        (tfaults.TransientFault("spill.stage_in"),
         jfaults.TransientFault("spill.stage_in")),
        (MemoryError(), MemoryError()),
        (TimeoutError(), TimeoutError()),
        (ValueError(), ValueError()),
        (CylonError(pt.Status(oom, "oom")),
         __import__("cylon_tpu").status.CylonError(
             __import__("cylon_tpu").status.Status(
                 __import__("cylon_tpu").status.Code.OutOfMemory, "oom"))),
    ]
    for t, j in pairs:
        assert tres.classify(t) == jres.classify(j)
    # the CUDA OOM is the resource class (XLA's RESOURCE_EXHAUSTED in JAX)
    assert tres.classify(torch.OutOfMemoryError("CUDA out of memory")) \
        == tres.RESOURCE
    assert tres.classify(torch.cuda.OutOfMemoryError("x")) == tres.RESOURCE


def test_exchange_budget_value_point():
    """The budget read goes through the ``resilience.budget`` point:
    a value rule shrinks it, as in the JAX package."""
    tconfig.set_device_memory_budget(1 << 20)
    cpu = torch.device("cpu")
    assert tres.exchange_budget(cpu) == 1 << 20
    rule = lambda f: f.FaultRule(  # noqa: E731
        "resilience.budget", kind="value", nth=2, mutate=lambda b: b // 4)
    with tfaults.active(tfaults.FaultPlan(0, [rule(tfaults)])) as p:
        got = [tres.exchange_budget(cpu) for _ in range(3)]
    assert got == [1 << 20, 1 << 18, 1 << 20] and p.injected == 1
    assert trace.counters()["fault.injected"] == 1


@pytest.mark.parametrize("shrunk", [0, -5, 3])
def test_exchange_budget_floor_equals_jax(shrunk):
    """A value rule that drives the budget to zero or below leaves a
    budget of 1 byte (never a non-positive one), in both packages."""
    from cylon_tpu import config as jconfig
    tconfig.set_device_memory_budget(1 << 20)
    jconfig.set_device_memory_budget(1 << 20)
    try:
        got, want = [], []
        for f, res, out in ((tfaults, tres, got), (jfaults, jres, want)):
            plan = f.FaultPlan(0, [f.FaultRule(
                "resilience.budget", kind="value",
                mutate=lambda b: shrunk)])
            with f.active(plan):
                out.append(res.exchange_budget())
    finally:
        jconfig.set_device_memory_budget(None)
    assert got == want == [max(shrunk, 1)]


def _table(world, n=4000, seed=5):
    ctx = pt.CylonContext(device="cpu", world=world)
    rng = np.random.default_rng(seed)
    t = pt.Table.from_columns(ctx, {
        "k": rng.integers(0, 97, n).astype(np.int32),
        "v": rng.random(n)})
    return DTable.from_table(ctx, t)


def _rows(dt):
    c = dt.counts_host()
    return [sorted(zip(*[col.data[s * dt.cap:s * dt.cap + c[s]].tolist()
                         for col in dt.columns])) for s in range(len(c))]


def test_shuffle_count_read_retries_a_transient_fault():
    """``compact.read_counts`` at the shuffle's count read: the second
    read fails once, the retry absorbs it, the rows are unchanged."""
    dt = _table(4)
    want = _rows(shuffle_table(dt, ["k"]))
    trace.reset()
    tres_prev = tres.set_retry_policy(tres.RetryPolicy(base_delay_s=0.0,
                                                       jitter=False))
    try:
        plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
            "compact.read_counts", kind="transient", nth=2)])
        with tfaults.active(plan):
            got = _rows(shuffle_table(shuffle_table(dt, ["k"]), ["v"]))
            assert _rows(shuffle_table(dt, ["k"])) == want
    finally:
        tres.set_retry_policy(tres_prev)
    c = trace.counters()
    assert c["retry.attempts"] == 1 and c["fault.injected"] == 1
    assert plan.fired == [("compact.read_counts", "transient")]
    assert sorted(r for s in got for r in s) == \
        sorted(r for s in want for r in s)


def test_fault_points_are_the_ports_sites(tmp_path):
    """Every point of the port's catalogue is consulted at its site, and
    no other point is: one shuffle consults the count read and the budget
    read; the same shuffle again under run_pipeline, its size hint now
    seeded, the hint lookup and the region's batched flush instead of the
    count read; a planned groupby adds the executor's stage-boundary points; a
    spill and its fault-in the two staging points; a resource fault at
    the second stage the replan trigger and the checkpoint restore; a CSV
    read its own point."""
    from cylon_tpu_torch import io as tio
    from cylon_tpu_torch.parallel import dist_groupby, dist_join
    seen = set()
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,2\n")
    plan = tfaults.FaultPlan(0, [])
    with tfaults.active(plan):
        tio.read_csv(pt.CylonContext(device="cpu"), str(path))
    assert set(plan._calls) == {"io.csv.read"}
    seen |= set(plan._calls)
    tdops.clear_size_hints()
    plan = tfaults.FaultPlan(0, [])
    with tfaults.active(plan):
        shuffle_table(_table(4), ["k"])
    assert set(plan._calls) == {"compact.read_counts", "resilience.budget"}
    seen |= set(plan._calls)
    plan = tfaults.FaultPlan(0, [])
    with tfaults.active(plan):
        run_pipeline(lambda: shuffle_table(_table(4), ["k"]).to_table())
    assert set(plan._calls) == {"compact.hint", "compact.flush",
                                "resilience.budget"}
    seen |= set(plan._calls)
    dt = _table(4)
    plan = tfaults.FaultPlan(0, [])
    with tfaults.active(plan):
        dt.ctx.optimize(lambda t: dist_groupby(t, ["k"], [("v", "sum")]), dt)
    assert {"exec.stage", "mesh.device_lost",
            "mesh.device_joined"} <= set(plan._calls)
    seen |= set(plan._calls)
    plan = tfaults.FaultPlan(0, [])
    with tfaults.active(plan):
        dt.spill()
        dt.ensure_device()
    assert set(plan._calls) == {"spill.stage_out", "spill.stage_in"}
    seen |= set(plan._calls)
    prev = tconfig.set_broadcast_join_threshold(1)
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
        "exec.stage", kind="resource", nth=2)])
    try:
        with tfaults.active(plan):
            dt.ctx.optimize(lambda t: dist_groupby(
                dist_join(t, t, pt.JoinConfig.InnerJoin(0, 0)),
                ["lt-k"], [("rt-v", "sum")]), dt)
    finally:
        tconfig.set_broadcast_join_threshold(prev)
    assert {"recover.replan",
            "recover.checkpoint_restore"} <= set(plan._calls)
    seen |= set(plan._calls)
    seen |= _serving_sites(dt)
    assert seen == set(tfaults.POINTS)


def _serving_sites(dt):
    """The serving layer's two points at their sites: a half-open
    breaker probe consults ``serve.breaker_probe``; a view folding an
    appended delta consults ``matview.fold``."""
    import time

    from cylon_tpu_torch.parallel import dist_groupby
    from cylon_tpu_torch.serve import ServeSession

    def poison(t):
        raise CylonError(pt.Status(Code.ExecutionError, "poison"))

    def agg(t):
        return dist_groupby(shuffle_table(t["fact"], ["k"]), ["k"],
                            [("v", "sum")])
    seen = set()
    with ServeSession(dt.ctx, tables={"fact": dt}, batch_window_ms=0.0,
                      breaker_threshold=1, breaker_cooldown_s=0.01) as s:
        with pytest.raises(CylonError):
            s.submit(poison).result(60)
        time.sleep(0.02)
        plan = tfaults.FaultPlan(0, [])
        with tfaults.active(plan):
            s.submit(poison)._event.wait(60)
        assert "serve.breaker_probe" in plan._calls
        seen |= set(plan._calls)
        s.submit(agg).result(60)
        s.ingest("fact", _table(4)).result(60)
        plan = tfaults.FaultPlan(0, [])
        with tfaults.active(plan):
            assert s.submit(agg).result(60) is not None
        assert "matview.fold" in plan._calls
        seen |= set(plan._calls)
    return seen


def test_shuffle_permanent_count_read_fault_propagates():
    dt = _table(4)
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
        "compact.read_counts", kind="permanent")])
    with tfaults.active(plan):
        with pytest.raises(tfaults.PermanentFault):
            shuffle_table(dt, ["k"])
    assert trace.counters().get("retry.attempts", 0) == 0


def test_shrunk_budget_degrades_the_exchange():
    """A ``resilience.budget`` value rule below the single-shot price:
    the exchange degrades, rows unchanged."""
    dt = _table(4)
    want = _rows(shuffle_table(dt, ["k"]))
    trace.reset()
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
        "resilience.budget", kind="value", mutate=lambda b: 4096)])
    with tfaults.active(plan):
        got = _rows(shuffle_table(dt, ["k"]))
    c = trace.counters()
    assert c["shuffle.strategy.downgrades"] == 1
    assert c.get("shuffle.strategy.single_shot", 0) == 0
    assert c["fault.injected"] >= 1
    assert [sorted(s) for s in got] == [sorted(s) for s in want]


def test_axis_split_equals_jax(dctx, monkeypatch):
    """``topology.axis_split``: knob, env and degraded-world fallbacks
    equal to the JAX package's at world 8 and on smaller worlds."""
    import cylon_tpu as ct
    from cylon_tpu import config as jconfig
    monkeypatch.delenv("CYLON_MESH_SHAPE", raising=False)
    try:
        for shape in (None, (2, 4), (4, 2), (8, 1), (3, 2), (2, 3)):
            tconfig.set_mesh_shape(shape)
            jconfig.set_mesh_shape(shape)
            for world in (8, 6, 4, 3, 1):
                jctx = dctx if world == 8 else ct.CylonContext(
                    {"backend": "tpu", "devices": dctx.devices[:world]})
                tctx = pt.CylonContext(device="cpu", world=world)
                assert ttopo.axis_split(tctx) == jtopo.axis_split(jctx)
        tconfig.set_mesh_shape(None)
        monkeypatch.setenv("CYLON_MESH_SHAPE", "2x4")
        assert ttopo.axis_split(pt.CylonContext(device="cpu", world=8)) \
            == (2, 4)
    finally:
        tconfig.set_mesh_shape(None)
        jconfig.set_mesh_shape(None)
