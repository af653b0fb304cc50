"""The port's example programs (``cylon_tpu_torch/examples``) run to
completion on the CPU: each in a subprocess with ``--device cpu`` and no
``XLA_FLAGS``, its logged row counts checked against pandas on the same
generated CSVs (the JAX package's examples run in
``tests/test_examples.py``).  Without ``--device`` an example runs on the
card, so with no card it fails."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from test_torch_common import jax_trace_shim  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "cylon_tpu_torch" / "examples"


def _load(path: Path):
    """A module from its file, without touching the import path."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


example_utils = _load(EXAMPLES / "example_utils.py")  # the CSV generator

ROWS = 5000  # input_csvs' default


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["CYLON_MINLOGLEVEL"] = "0"
    return env


def _run(script, *args, device=("--device", "cpu")):
    r = subprocess.run([sys.executable, str(EXAMPLES / script), *args,
                        *device], capture_output=True, text=True,
                       timeout=300, env=_env(), cwd=EXAMPLES)
    assert r.returncode == 0, f"{script} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout + r.stderr


def _logged(out, pattern):
    m = re.search(pattern, out)
    assert m, (pattern, out[-3000:])
    return [int(g) for g in m.groups()]


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """input_csvs' two generated inputs, written once for every case."""
    d = tmp_path_factory.mktemp("examples")
    paths = [example_utils.generate_csv(str(d / f"csv{i}_0.csv"), ROWS,
                                        seed=i) for i in (1, 2)]
    frames = [pd.read_csv(p, float_precision="round_trip") for p in paths]
    return paths, frames


def test_join_example(csvs):
    paths, (a, b) = csvs
    out = _run("join_example.py", *paths)
    assert _logged(out, r"First table had: (\d+) and Second table had: "
                        r"(\d+) rows") == [len(a), len(b)]
    assert _logged(out, r"Joined has: (\d+) rows") == \
        [len(a.merge(b, on="0"))]


def _distinct(df):
    return set(df.itertuples(index=False, name=None))


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_set_op_examples(csvs, op):
    paths, (a, b) = csvs
    # one input against itself with its first half: every op is non-empty
    half = str(Path(paths[0]).with_name("half.csv"))
    a.iloc[:ROWS // 2].to_csv(half, index=False)
    h = pd.read_csv(half, float_precision="round_trip")
    want = {"union": _distinct(a) | _distinct(h),
            "intersect": _distinct(a) & _distinct(h),
            "subtract": _distinct(a) - _distinct(h)}[op]
    out = _run("set_op_examples.py", op, paths[0], half)
    assert _logged(out, rf"{op} of (\d+) and (\d+) rows -> (\d+) rows") == \
        [len(a), len(h), len(want)]


def test_select_project_example(csvs):
    paths, (a, _) = csvs
    out = _run("select_project_example.py", *paths)
    assert _logged(out, r"Select kept (\d+) of (\d+) rows") == \
        [int((a["0"] % 2 == 0).sum()), len(a)]
    assert _logged(out, r"Projected to (\d+) columns") == [2]


def test_groupby_sort_example(csvs):
    paths, (a, _) = csvs
    out = _run("groupby_sort_example.py", *paths)
    assert _logged(out, r"groupby: (\d+) rows -> (\d+) groups") == \
        [len(a), a["0"].nunique()]
    top = a.groupby("0")["1"].sum().sort_values(ascending=False).head(5)
    for k in top.index:  # dist_head(dist_sort(...), 5): the five largest
        assert re.search(rf"^\s*{k}\s", out, re.M), (k, out[-2000:])


def test_tpch_example(jax_trace_shim):
    """The example's world-8 run on ``generate(sf, seed=42)`` (its
    tables, as the JAX package's example builds them): its lineitem count
    and each query's logged row count equal the JAX package's same query
    at world 8 on the same frames."""
    import jax

    import cylon_tpu as ct
    from cylon_tpu.parallel import DTable as JDTable
    from cylon_tpu.tpch import QUERIES as JQUERIES
    from cylon_tpu.tpch import generate as jgenerate

    sf = 0.002
    out = _run("tpch_example.py", str(sf))
    data = jgenerate(sf, seed=42)
    assert _logged(out, r"SF=0.002 \((\d+) lineitems\)") == \
        [len(data["lineitem"])]
    jctx = ct.CylonContext({"backend": "tpu", "devices": jax.devices("cpu")})
    assert jctx.get_world_size() == 8
    jt = {n: JDTable.from_pandas(jctx, df) for n, df in data.items()}
    for q, fn in JQUERIES.items():
        assert _logged(out, rf"\] {q}: (\d+) rows in") == \
            [fn(jctx, jt).num_rows], q


def test_simple_dataloader(csvs):
    paths, (a, _) = csvs
    # the example's own 512-row input: generated with the same seed
    small = example_utils.generate_csv(
        str(Path(paths[0]).with_name("small.csv")), 512, seed=1)
    out = _run("cylon_simple_dataloader.py", small, paths[1])
    assert _logged(out, r"loaded (\d+) rows x (\d+) cols") == [512, 4]
    assert _logged(out, r"minibatches: \((\d+), (\d+), (\d+)\)") == [8, 64, 4]
    assert _logged(out, r"forward pass over (\d+) batches ok") == [8]


def test_mnist_example():
    out = _run("cylon_mnist_example.py")
    assert _logged(out, r"train (\d+) x (\d+), test (\d+) x (\d+)") == \
        [512, 785, 128, 785]
    assert "OK mnist" in out


def test_strings_hash64_example():
    rng = np.random.default_rng(7)  # the example's own draw
    users = rng.integers(0, 50_000, 200_000)
    out = _run("strings_hash64_example.py")
    assert _logged(out, r"OK: (\d+) users, matches pandas") == \
        [len(np.unique(users))]


def test_example_without_a_card_fails(csvs):
    """No ``--device``: the example asks for the card; with none it exits
    non-zero with the context's CylonError (no CPU fallback)."""
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(EXAMPLES / "join_example.py"),
                        *csvs[0]], capture_output=True, text=True,
                       timeout=300, env=env, cwd=EXAMPLES)
    assert r.returncode != 0 and "CylonError" in r.stderr
    assert "Joined has" not in r.stderr
