"""The one-command gate: the port's ``analysis/ci.py`` on the CPU
(``--device cpu``, world 8, the tool's default SF 0.002).  Its usage
contract and its aggregation (the worst stage's exit) equal the JAX
package's ``ci.main``; each of the 14 stages exits 0 and none of them
skips at world 8 (stage 14 given a baseline and a candidate); the mesh
stages skip only below their world bound.  The seeded failures are in
``tests/test_torch_ci_seeded.py``."""
import json

import pytest

from cylon_tpu.analysis import ci as jci

from cylon_tpu_torch import plan as tplan, topology as ttopology
from cylon_tpu_torch.analysis import ci as tci
from cylon_tpu_torch.parallel import broadcast as tbroadcast

from test_torch_common import clear_port_hints

DEVICE, WORLD, SF = "cpu", 8, 0.002

STAGE_FUNCS = ("_stage_lint", "_stage_plan_check", "_stage_serve_smoke",
               "_stage_telemetry_smoke", "_stage_doctor_smoke",
               "_stage_chaos_smoke", "_stage_ooc_smoke", "_stage_mesh_smoke",
               "_stage_scaleup_smoke", "_stage_hierarchy_smoke",
               "_stage_lockcheck_smoke", "_stage_export_smoke",
               "_stage_matview_smoke", "_stage_benchdiff")


@pytest.fixture(autouse=True)
def _clean():
    """Each stage starts from empty plan, hint and replica caches and the
    full roster, and leaves none of its own behind."""
    def reset():
        tplan.clear_plan_cache()
        clear_port_hints()
        tbroadcast.clear_replica_cache()
        ttopology.reset()
    reset()
    yield
    reset()


def _artifact(tmp_path, name, detail):
    p = tmp_path / name
    p.write_text(json.dumps({"metric": "dist_join_rows_per_sec",
                             "value": 5e7, "detail": detail}) + "\n")
    return str(p)


@pytest.mark.parametrize("argv", [["--baseline", "old.json"], ["new.json"]],
                         ids=["baseline-only", "candidate-only"])
def test_usage_contract_equals_jax(argv, capsys):
    """benchdiff needs both artifacts: 2 before any stage runs."""
    assert jci.main(list(argv)) == 2
    assert tci.main(list(argv)) == 2
    out = capsys.readouterr()
    assert "== ci stage" not in out.out


def _fixed(monkeypatch, mod, rcs):
    for name, rc in zip(STAGE_FUNCS, rcs):
        monkeypatch.setattr(mod, name, lambda *a, rc=rc, **k: rc)


@pytest.mark.parametrize("rcs,flags,worst", [
    ([0] * 14, [], 0),
    ([0] * 6 + [1] + [0] * 7, [], 1),
    ([0, 1, 0, 0, 2, 0, 0, 1, 0, 0, 0, 0, 0, 0], [], 2),
    ([0] * 9 + [2] + [0] * 4, ["--no-hierarchy-smoke"], 0),
], ids=["clean", "one-finding", "tooling-error", "flag-skips-the-stage"])
def test_aggregate_is_the_worst_stage_equals_jax(monkeypatch, tmp_path,
                                                 capsys, rcs, flags, worst):
    a = _artifact(tmp_path, "a.json", {"tpch_q1_ms": 1.0})
    argv = ["--baseline", a, a, *flags]
    _fixed(monkeypatch, jci, rcs)
    _fixed(monkeypatch, tci, rcs)
    assert jci.main(list(argv)) == worst
    seen = []
    assert tci.main(list(argv), on_stage=lambda *r: seen.append(r)) \
        == worst
    ran = [n for n, _, _, _ in seen]
    assert ran == [n for n in range(1, 15)
                   if not (flags and n == 10)]
    assert [rc for _, _, rc, _ in seen] == [rcs[n - 1] for n in ran]
    out = capsys.readouterr().out
    if flags:
        assert "== ci stage 10/14: hierarchy smoke == (skipped)" in out


def _run_stage(number, tmp_path):
    if number == 1:
        return tci._stage_lint()
    if number == 14:
        a = _artifact(tmp_path, "old.json", {"tpch_q1_ms": 100.0})
        b = _artifact(tmp_path, "new.json", {"tpch_q1_ms": 90.0})
        return tci._stage_benchdiff(a, b, 0.15)
    fn = getattr(tci, STAGE_FUNCS[number - 1])
    if number in (10, 11, 13):
        return fn(DEVICE, WORLD)
    return fn(SF, DEVICE, WORLD)


@pytest.mark.parametrize("number", range(1, 15))
def test_stage_passes_at_world_8(number, tmp_path, capsys):
    rc = _run_stage(number, tmp_path)
    out = capsys.readouterr()
    assert rc == 0, out.out[-3000:] + out.err[-3000:]
    assert "skipped" not in out.out and "skipped" not in out.err
    assert f"== ci stage {number}/14:" in out.out
    assert "RAISED" not in out.err and "setup failed" not in out.err


@pytest.mark.parametrize("number,bound", [(8, 2), (9, 2), (10, 8)])
def test_mesh_stages_skip_only_below_their_world_bound(number, bound,
                                                       capsys):
    fn = getattr(tci, STAGE_FUNCS[number - 1])
    args = (DEVICE, bound - 1) if number == 10 else (SF, DEVICE, bound - 1)
    assert fn(*args) == 0
    out = capsys.readouterr().out
    assert f"skipped — needs --world >= {bound} (got {bound - 1})" in out


def test_main_runs_every_stage_in_order(monkeypatch, tmp_path, capsys):
    """``main`` itself, with the smoke stages' flags set: graftlint and
    benchdiff run, every other stage prints its skip line in the JAX
    order and numbering, and the summary names the stage exits."""
    a = _artifact(tmp_path, "a.json", {"tpch_q1_ms": 1.0})
    flags = ["--no-plan-check", "--no-serve-smoke", "--no-telemetry-smoke",
             "--no-doctor-smoke", "--no-chaos-smoke", "--no-ooc-smoke",
             "--no-mesh-smoke", "--no-scaleup-smoke", "--no-hierarchy-smoke",
             "--no-lockcheck-smoke", "--no-export-smoke",
             "--no-matview-smoke"]
    seen = []
    assert tci.main(["--device", DEVICE, "--baseline", a, a, *flags],
                    on_stage=lambda *r: seen.append(r)) == 0
    assert [(n, rc) for n, _, rc, _ in seen] == [(1, 0), (14, 0)]
    out = capsys.readouterr().out
    heads = [ln for ln in out.splitlines() if ln.startswith("== ci stage")]
    assert [h.split()[3] for h in heads] == [f"{n}/14:" for n in
                                             range(1, 15)]
    assert sum(h.endswith("(skipped)") for h in heads) == 12
    assert "ci: CLEAN (stage exits [0, 0] -> 0)" in out


# the stages that generate TPC-H tables (the rest build their own data)
GENERATING = (2, 3, 4, 5, 6, 7, 8, 9, 11, 12)


class _Stop(Exception):
    """Ends a stage once its ingest has been seen."""


def _jax_generate_args(number, monkeypatch):
    """The ``(scale, seed)`` the JAX gate's stage hands ``generate``; its
    setup stops there (the stage reports the setup failure, exit 2)."""
    import cylon_tpu.tpch as jtpch
    seen = []

    def spy(scale, seed=42):
        seen.append((scale, seed))
        raise _Stop

    monkeypatch.setattr(jtpch, "generate", spy)
    fn = getattr(jci, STAGE_FUNCS[number - 1])
    assert (fn() if number == 11 else fn(SF)) == 2
    return seen


def _port_ingest(number, monkeypatch):
    """What the port's stage generates (``(scale, seed)`` and the frames)
    and what it hands ``DTable.from_pandas`` (frame, device, world),
    stopped after the eighth table."""
    import cylon_tpu_torch.tpch as ttpch
    from cylon_tpu_torch.parallel.dtable import DTable as TDTable
    real_generate, real_from_pandas = ttpch.generate, TDTable.from_pandas
    generated, ingested = [], []

    def generate(scale, seed=42):
        generated.append(((scale, seed), real_generate(scale, seed=seed)))
        return generated[-1][1]

    def from_pandas(ctx, df, cap=None):
        ingested.append((df, str(ctx.device), ctx.get_world_size()))
        if len(ingested) == 8:
            raise _Stop
        return real_from_pandas(ctx, df, cap)

    monkeypatch.setattr(ttpch, "generate", generate)
    monkeypatch.setattr(TDTable, "from_pandas", staticmethod(from_pandas))
    fn = getattr(tci, STAGE_FUNCS[number - 1])
    rc = fn(DEVICE, WORLD) if number == 11 else fn(SF, DEVICE, WORLD)
    assert rc != 0  # stopped mid-stage
    return generated, ingested


@pytest.mark.parametrize("number", GENERATING)
def test_stage_ingests_the_jax_gate_frames(number, monkeypatch, capsys):
    """Each TPC-H stage generates with the host generator at the JAX
    stage's scale and seed, and ingests exactly those frames (each with
    ``DTable.from_pandas`` at ``--device`` and ``--world``), which equal
    the JAX package's ``generate`` frames for that seed."""
    import pandas as pd

    from cylon_tpu.tpch import generate as jgenerate

    jargs = _jax_generate_args(number, monkeypatch)
    generated, ingested = _port_ingest(number, monkeypatch)
    capsys.readouterr()
    assert len(jargs) == 1 and [a for a, _ in generated] == jargs
    (scale, seed), frames = generated[0]
    assert seed in (7, 11, 17)
    assert len(ingested) == len(frames) == 8
    assert all(df is frames[n] for (df, _, _), n in zip(ingested, frames))
    assert {(dev, w) for _, dev, w in ingested} == {(DEVICE, WORLD)}
    want = jgenerate(scale, seed=seed)
    assert list(frames) == list(want)
    for name in want:
        pd.testing.assert_frame_equal(frames[name], want[name],
                                      check_exact=True)
