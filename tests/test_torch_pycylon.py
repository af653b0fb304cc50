"""The port's pycylon (``cylon_tpu_torch.pycylon``) against the JAX
package's ``pycylon`` on the same seeded CSVs: the sequential and
distributed flows of ``tests/test_io_compat.py`` at world 1 and world 8
(the JAX package on its virtual CPU devices, the port with
``device="cpu"``), Arrow interop, the table registry, ``to_csv``'s
``Status``, the ``JoinConfig`` strings and the context's backends.  Row
multisets, column names and types are compared (sort results in order);
float64 cells within 1e-12 and float32 within 1e-6, the rest exactly."""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cylon_tpu_torch.pycylon as tpc
from cylon_tpu_torch.pycylon.data import table as ttable
from cylon_tpu_torch.status import Code as TCode
from cylon_tpu_torch.status import CylonError as TCylonError

from test_torch_common import (assert_rows_close, float_rtols, jax_rows,
                               jax_trace_shim, port_rows, schema)  # noqa: F401


@pytest.fixture
def csv_pair(tmp_path):
    rng = np.random.default_rng(20)
    n = 200
    df1 = pd.DataFrame({"k": rng.integers(0, 50, n),
                        "v": np.round(rng.random(n), 3)})
    df2 = pd.DataFrame({"k": rng.integers(0, 50, n),
                        "w": np.round(rng.random(n), 3)})
    p1, p2 = tmp_path / "a.csv", tmp_path / "b.csv"
    df1.to_csv(p1, index=False)
    df2.to_csv(p2, index=False)
    return str(p1), str(p2), df1, df2


def jax_ctx(world):
    """The JAX package's pycylon context: one local device, or the first
    ``world`` virtual CPU devices distributed."""
    from pycylon import CylonContext
    from tests.conftest import CPU_DEVICES

    if world is None:
        return CylonContext({"backend": "local", "devices": CPU_DEVICES[:1]})
    return CylonContext({"backend": "mpi", "devices": CPU_DEVICES[:world]})


def port_ctx(world):
    if world is None:
        return tpc.CylonContext(None, device="cpu")
    return tpc.CylonContext("mpi", device="cpu", world=world)


def same_table(got, want, ordered: bool = False) -> None:
    """A port pycylon Table equals a JAX one: names and types, then the
    rows (a multiset unless ``ordered``)."""
    g, w = got.backing, want.backing
    assert schema(g) == schema(w)
    assert got.rows == want.rows and got.columns == want.columns
    assert list(got.column_names) == list(want.column_names)
    assert_rows_close(port_rows(g, ordered), jax_rows(w, ordered),
                      float_rtols(g))


# ---------------------------------------------------------------------------
# the sequential flow (test_io_compat.py::test_sequential_flow)
# ---------------------------------------------------------------------------

LOCAL_OPS = {
    "join_inner_hash": lambda a, b, c: a.join(c, table=b, join_type="inner",
                                              algorithm="hash", left_col=0,
                                              right_col=0),
    "join_left_sort": lambda a, b, c: a.join(c, b, "left", "sort", 0, 0),
    "join_outer_hash": lambda a, b, c: a.join(c, b, "outer", "hash", 0, 0),
    "union": lambda a, b, c: a.union(c, a),
    "intersect": lambda a, b, c: a.intersect(c, a),
    "subtract": lambda a, b, c: a.subtract(c, a),
    "sort": lambda a, b, c: a.sort(c, "k"),
}


@pytest.mark.parametrize("op", list(LOCAL_OPS))
def test_sequential_flow_equals_jax(csv_pair, op):
    import pycylon.data.table as jtable

    p1, p2, df1, df2 = csv_pair
    jc, pc = jax_ctx(None), port_ctx(None)
    ja, jb = (jtable.csv_reader.read(jc, p, ",") for p in (p1, p2))
    pa_, pb = (tpc.csv_reader.read(pc, p, ",") for p in (p1, p2))
    assert pa_.rows == len(df1) and pa_.columns == 2
    same_table(pa_, ja)
    same_table(LOCAL_OPS[op](pa_, pb, pc), LOCAL_OPS[op](ja, jb, jc),
               ordered=op == "sort")


# ---------------------------------------------------------------------------
# the distributed flow (test_io_compat.py::test_distributed_flow)
# ---------------------------------------------------------------------------

DIST_OPS = {
    "join_inner_hash": lambda a, b, c: a.distributed_join(
        c, table=b, join_type="inner", algorithm="hash", left_col=0,
        right_col=0),
    "join_inner_sort": lambda a, b, c: a.distributed_join(c, b, "inner",
                                                          "sort", 0, 0),
    "join_fullouter_hash": lambda a, b, c: a.distributed_join(
        c, b, "fullouter", "hash", 0, 0),
    "union": lambda a, b, c: a.distributed_union(c, b),
    "intersect": lambda a, b, c: a.distributed_intersect(c, a),
    "subtract": lambda a, b, c: a.distributed_subtract(c, b),
    "sort": lambda a, b, c: a.distributed_sort(c, "k"),
}


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("op", list(DIST_OPS))
def test_distributed_flow_equals_jax(csv_pair, jax_trace_shim, op, world):
    import pycylon.data.table as jtable

    p1, p2, _, _ = csv_pair
    jc, pc = jax_ctx(world), port_ctx(world)
    assert pc.get_world_size() == jc.get_world_size() == world
    ja, jb = (jtable.csv_reader.read(jc, p, ",") for p in (p1, p2))
    pa_, pb = (tpc.csv_reader.read(pc, p, ",") for p in (p1, p2))
    same_table(DIST_OPS[op](pa_, pb, pc), DIST_OPS[op](ja, jb, jc),
               ordered=op == "sort")


# ---------------------------------------------------------------------------
# interop, registry, Status, JoinConfig, backends
# ---------------------------------------------------------------------------

def test_arrow_interop_carries_jax_tables(csv_pair):
    """A JAX pycylon Table crosses to the port through Arrow: its
    ``to_arrow`` → the port's ``from_arrow`` holds the same rows, and the
    port's ``to_arrow`` is the JAX one."""
    from pycylon.data.table import Table as JTable

    _, _, df1, _ = csv_pair
    jt = JTable.from_arrow(pa.Table.from_pandas(df1), jax_ctx(None))
    at = JTable.to_arrow(jt)
    pt_ = tpc.Table.from_arrow(at, port_ctx(None))
    same_table(pt_, jt)
    assert tpc.Table.to_arrow(pt_).equals(at)
    pd.testing.assert_frame_equal(pt_.to_pandas(), jt.to_pandas())
    pd.testing.assert_frame_equal(pt_.to_pandas(), df1, check_dtype=False)


def test_registry_and_id_ctor(csv_pair):
    from pycylon.data.table import Table as JTable

    _, _, df1, _ = csv_pair
    tb = tpc.Table.from_pandas(df1, port_ctx(None))
    again = tpc.Table(tb.id)
    assert again.rows == tb.rows and again.backing is tb.backing
    assert tpc.Table(tb.id.encode()).id == tb.id
    assert ttable.get_table(tb.id) is tb.backing
    jt = JTable.from_pandas(df1, jax_ctx(None))
    assert JTable(jt.id).rows == again.rows
    with pytest.raises(TCylonError) as e:
        tpc.Table("no-such-id")
    assert e.value.status.code == TCode.KeyError


def test_to_csv_status(csv_pair, tmp_path):
    from pycylon.data.table import Table as JTable

    _, _, df1, _ = csv_pair
    pt_ = tpc.Table.from_pandas(df1, port_ctx(None))
    jt = JTable.from_pandas(df1, jax_ctx(None))
    ps, js = pt_.to_csv(str(tmp_path / "p.csv")), jt.to_csv(
        str(tmp_path / "j.csv"))
    assert ps.is_ok() and js.is_ok() and isinstance(ps, tpc.Status)
    a, b = (pd.read_csv(tmp_path / f) for f in ("p.csv", "j.csv"))
    pd.testing.assert_frame_equal(
        a.sort_values(list(a.columns)).reset_index(drop=True),
        b.sort_values(list(b.columns)).reset_index(drop=True))
    bad = str(tmp_path / "no_such_dir" / "o.csv")
    ps2, js2 = pt_.to_csv(bad), jt.to_csv(bad)
    assert not ps2.is_ok() and not js2.is_ok()
    assert ps2.get_code() == js2.get_code() == int(TCode.IOError)
    st = tpc.Status(tpc.Code.Invalid, b"bytes message", 0)
    assert st.get_msg() == "bytes message" and not st.is_ok()


@pytest.mark.parametrize("args", [
    ("inner", "hash", 0, 1), ("left", "sort", 1, 0), ("right", None, 2, 2),
    ("outer", "sort", 1, 2), ("full_outer", None, 3, 1)])
def test_join_config_strings(args):
    from pycylon.common.join_config import JoinConfig as JJC

    got, want = tpc.JoinConfig(*args), JJC(*args)
    assert isinstance(got, tpc.JoinConfig)
    assert got.join_type.name == want.join_type.name
    assert got.algorithm.name == want.algorithm.name
    assert (got.left_column_idx, got.right_column_idx) == \
        (want.left_column_idx, want.right_column_idx) == (args[2], args[3])
    assert tpc.PJoinType.OUTER.value == "fullouter"
    assert [e.value for e in tpc.PJoinAlgorithm] == ["sort", "hash"]


def test_join_config_refusals():
    from pycylon.common.join_config import JoinConfig as JJC

    assert tpc.JoinConfig("fullouter", "hash", 0, 0).join_type.name == \
        "FULL_OUTER"
    for bad in (("cross", "hash", 0, 0), ("inner", "nested", 0, 0),
                ("inner", "hash", None, 0)):
        with pytest.raises(ValueError) as want:
            JJC(*bad)
        with pytest.raises(ValueError) as got:
            tpc.JoinConfig(*bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", [None, "local", "tpu", "mpi", "dist",
                                     "cpu"])
def test_context_backends_and_get_config(backend):
    """Each backend string of the JAX package: the same world (8 for a
    distributed one: the JAX package's virtual devices, the port's
    default), the same ``is_distributed`` and ``get_config()``."""
    from pycylon import CylonContext as JCC

    jc, pc = JCC(backend), tpc.CylonContext(backend, device="cpu")
    assert pc.get_world_size() == jc.get_world_size()
    assert pc.is_distributed() == jc.is_distributed()
    assert pc.get_config() == jc.get_config() == backend
    assert pc.device == torch.device("cpu")
    pc.add_config("k", "v")
    assert pc.get_config("k") == "v" and pc.get_config("x", "d") == "d"


def test_dict_config():
    """A dict config: its backend as the JAX package's, its other keys in
    the config map; a JAX ``devices`` list is refused (``world=``)."""
    from pycylon import CylonContext as JCC

    jc = JCC({"backend": "mpi"})
    pc = tpc.CylonContext({"backend": "mpi", "k": "v"}, device="cpu")
    assert pc.get_world_size() == jc.get_world_size() == 8
    assert pc.is_distributed() == jc.is_distributed()
    assert pc.get_config("k") == "v" and pc.get_config() is None
    with pytest.raises(TCylonError) as e:
        tpc.CylonContext({"backend": "mpi", "devices": [0]}, device="cpu")
    assert e.value.status.code.name == "Invalid"


def test_unknown_backend_raises():
    from cylon_tpu.status import CylonError as JCylonError
    from pycylon import CylonContext as JCC

    with pytest.raises(JCylonError) as want:
        JCC("nccl-world")
    with pytest.raises(TCylonError) as got:
        tpc.CylonContext("nccl-world", device="cpu")
    assert got.value.status.code.name == want.value.status.code.name \
        == "Invalid"
    with pytest.raises(TCylonError):
        tpc.CylonContext("local", device="cpu", world=4)


def test_card_default_raises_without_cuda(monkeypatch, csv_pair):
    """No CPU fallback: with no card, a context that does not name the CPU
    raises, and so does a table built on the default context."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ttable, "_default_ctx", None)
    for backend in (None, "mpi"):
        with pytest.raises(TCylonError) as e:
            tpc.CylonContext(backend)
        assert "CUDA" in str(e.value)
    with pytest.raises(TCylonError):
        tpc.Table.from_pandas(csv_pair[2])
    assert ttable._default_ctx is None
