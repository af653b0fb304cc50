"""Gateway process for the Java binding, over the port.

The reference's Java API is id-addressed: every native call passes table
ids into JNI and gets ids back (reference:
java/src/main/java/org/cylondata/cylon/Table.java — uuid per table,
nativeJoin(id, id, …) → new id; Table.cpp resolves ids through
table_api's registry).  This module is the same contract over a process
boundary, the protocol of the JAX package's ``pycylon.java_gateway``
answered by the PyTorch engine: the Java side spawns

    <python> -m pycylon.java_gateway <backend>

(``-Dcylon.gateway.python=<path of java_launcher.py>`` makes that the
port's gateway) or, directly,

    python -m cylon_tpu_torch.pycylon.java_gateway [backend] [--device D]
                                                   [--world N]

and speaks newline-delimited JSON on stdin/stdout.  Tables are exchanged
by CSV path (the reference Java surface is fromCSV/print/toCsv-shaped);
ops run on the resident engine and return new table ids.  The context is
``CylonContext(backend, device=D, world=N)``: the card and, for a
distributed backend, 8 ranks unless the flags say otherwise.

Protocol (one JSON object per line; every reply carries "ok"):
  {"op": "from_csv", "path": p}                    -> {"ok": true, "id": t}
  {"op": "join", "left": t, "right": u,
   "join_type": "inner", "algorithm": "hash",
   "left_col": 0, "right_col": 0, "distributed": false} -> {"id": v}
  {"op": "union"/"intersect"/"subtract", "left": t, "right": u,
   "distributed": false}                           -> {"id": v}
  {"op": "sort", "id": t, "column": 0}             -> {"id": v}
  {"op": "rows"/"columns", "id": t}                -> {"value": n}
  {"op": "column_names", "id": t}                  -> {"value": [...]}
  {"op": "to_csv", "id": t, "path": p}             -> {"ok": true}
  {"op": "show", "id": t}                          -> {"value": str}
  {"op": "column_json", "id": t, "column": i}      -> {"value": [...]}
  {"op": "select_mask", "id": t, "mask": [...]}    -> {"id": v}
  {"op": "select_expr", "id": t, "expr": e}        -> {"id": v}
  {"op": "replace_column", "id": t, "column": i,
   "values": [...], "name": s}                     -> {"id": v}
  {"op": "table_from_columns",
   "columns": [{"name": s, "values": [...]}, ...]} -> {"id": v}
  {"op": "hash_partition", "id": t, "columns": [...], "n": k}
                                                   -> {"ids": [...]}
  {"op": "round_robin_partition", "id": t, "n": k} -> {"ids": [...]}
  {"op": "merge", "ids": [...]}                    -> {"id": v}
  {"op": "free", "id": t}                          -> {"ok": true}
  {"op": "ping"}                                   -> {"ok": true}
  {"op": "shutdown"}                               -> {"ok": true} + exit

``select_expr`` evaluates its expression over the column-name
environment with ``torch`` in scope (the JAX gateway puts ``jnp`` there)
and empty ``__builtins__``: an expression over column names and
operators (``k > 4``) selects the same rows on both gateways; one that
names ``jnp`` is answered ``{"ok": false, "error": ...}``.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd
import torch

from .. import compute
from ..table import Table as _CT
from .ctx.context import CylonContext
from .data.table import Table, csv_reader


class Gateway:
    """One engine context + table registry; transport-independent core."""

    def __init__(self, backend: str = "mpi", device=None,
                 world: Optional[int] = None):
        self._ctx = CylonContext(backend, device=device, world=world)
        self._tables: Dict[str, Table] = {}

    def _get(self, tid: str) -> Table:
        try:
            return self._tables[tid]
        except KeyError:
            raise KeyError(f"unknown table id {tid!r}") from None

    def _put(self, table: Table) -> str:
        self._tables[table.id] = table
        return table.id

    def _new(self, backing) -> Dict[str, Any]:
        return {"ok": True, "id": self._put(Table(backing))}

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "from_csv":
            t = csv_reader.read(self._ctx, req["path"],
                                req.get("delimiter", ","))
            return {"ok": True, "id": self._put(t)}
        if op == "join":
            left, right = self._get(req["left"]), self._get(req["right"])
            method = ("distributed_join" if req.get("distributed")
                      else "join")
            out = getattr(left, method)(
                self._ctx, right,
                join_type=req.get("join_type", "inner"),
                algorithm=req.get("algorithm", "hash"),
                left_col=int(req.get("left_col", 0)),
                right_col=int(req.get("right_col", 0)))
            return {"ok": True, "id": self._put(out)}
        if op in ("union", "intersect", "subtract"):
            left, right = self._get(req["left"]), self._get(req["right"])
            method = f"distributed_{op}" if req.get("distributed") else op
            out = getattr(left, method)(self._ctx, right)
            return {"ok": True, "id": self._put(out)}
        if op == "sort":
            out = self._get(req["id"]).sort(self._ctx, req.get("column", 0))
            return {"ok": True, "id": self._put(out)}
        if op == "rows":
            return {"ok": True, "value": self._get(req["id"]).rows}
        if op == "columns":
            return {"ok": True, "value": self._get(req["id"]).columns}
        if op == "column_names":
            return {"ok": True,
                    "value": list(self._get(req["id"]).column_names)}
        if op == "to_csv":
            self._get(req["id"]).to_csv(req["path"])
            return {"ok": True}
        if op == "show":
            buf = io.StringIO()
            stdout, sys.stdout = sys.stdout, buf
            try:
                self._get(req["id"]).show()
            finally:
                sys.stdout = stdout
            return {"ok": True, "value": buf.getvalue()}
        if op == "column_json":
            s = self._get(req["id"]).to_pandas().iloc[:, int(req["column"])]
            # host values: numpy scalars of the exported frame
            vals = [None if pd.isna(v) else
                    (v.item() if hasattr(v, "item") else v)  # graftlint: ok[implicit-host-sync]
                    for v in s]
            return {"ok": True, "value": vals}
        if op == "select_mask":
            # Java-side Selector/Filter lambdas evaluate on the JVM and
            # ship a row mask back — source compat with the reference's
            # row-lambda surface (Table.java:204-226), at O(rows)
            # transfer; select_expr is the engine-side fast path
            t = self._get(req["id"])
            mask = torch.from_numpy(np.asarray(req["mask"], dtype=bool)) \
                .to(self._ctx.device)
            return self._new(compute.select(t.backing, lambda env: mask))
        if op == "select_expr":
            # expression fast path: a Python expression over the column-
            # name env (the gateway is a local subprocess of the caller's
            # own process tree — same trust domain as the lambda path)
            t = self._get(req["id"])
            expr = req["expr"]

            def pred(env, _expr=expr):
                return eval(_expr, {"torch": torch, "__builtins__": {}},
                            dict(env.items()))

            return self._new(compute.select(t.backing, pred))
        if op == "replace_column":
            # mapColumn's return trip: new values for one column
            df = self._get(req["id"]).to_pandas()
            df.isetitem(int(req["column"]), pd.Series(req["values"]))
            if req.get("name"):
                df = df.rename(columns={
                    df.columns[int(req["column"])]: req["name"]})
            return self._new(_CT.from_pandas(self._ctx, df))
        if op == "table_from_columns":
            cols = {c["name"]: c["values"] for c in req["columns"]}
            return self._new(_CT.from_pandas(self._ctx, pd.DataFrame(cols)))
        if op == "hash_partition":
            parts = compute.hash_partition(self._get(req["id"]).backing,
                                           [int(c) for c in req["columns"]],
                                           int(req["n"]))
            return {"ok": True, "ids": [self._put(Table(p)) for p in parts]}
        if op == "round_robin_partition":
            parts = compute.round_robin_partition(
                self._get(req["id"]).backing, int(req["n"]))
            return {"ok": True, "ids": [self._put(Table(p)) for p in parts]}
        if op == "merge":
            tabs = [self._get(i).backing for i in req["ids"]]
            return self._new(compute.merge(tabs))
        if op == "free":
            self._tables.pop(req["id"], None)
            return {"ok": True}
        if op == "ping":  # liveness / barrier round trip
            self._ctx.barrier()
            return {"ok": True}
        if op == "shutdown":
            return {"ok": True, "shutdown": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


def serve(stdin=None, stdout=None, backend: str = "mpi", device=None,
          world: Optional[int] = None) -> None:
    """Blocking line loop (the Java client's peer)."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    gw = Gateway(backend, device, world)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            reply = gw.handle(json.loads(line))
        # protocol errors must not kill the gateway: every failure is
        # answered {"ok": false, "error": ...} on the wire
        except Exception as e:  # graftlint: ok[broad-except]
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(reply), file=stdout, flush=True)
        if reply.get("shutdown"):
            break


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.pycylon.java_gateway",
        description="The Java binding's gateway over the port: JSON "
                    "requests on stdin, one reply a line on stdout.")
    ap.add_argument("backend", nargs="?", default="mpi",
                    help="context backend: local, or tpu / mpi / dist / "
                         "cpu for a distributed world (default mpi)")
    ap.add_argument("--device", default=None,
                    help="torch device of the context (default: the card)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of a distributed backend (default 8)")
    args = ap.parse_args(argv)
    serve(backend=args.backend, device=args.device, world=args.world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
