"""All 22 TPC-H queries composed from the distributed operator layer.

The port of ``cylon_tpu/tpch/queries.py``, query for query and operator
for operator, so every query takes the same path (FK, broadcast or
shuffle joins; dense or sorted semi-joins; the same groupby paths) as
the JAX package on the same tables.  Each query takes a CylonContext
plus ``{name: DTable}`` and returns a local result Table.  Queries use
only the public dist ops (select → with_column → join / semi/anti-join →
groupby → sort → head); predicates and derived columns are torch
expressions over the flat column tensors.

Deviations from the spec text, as in the JAX package: identity columns
functionally dependent on the group key (c_name, c_address, … in Q10)
are omitted, free-text columns are dictionary-encoded phrases, and dates
are int32 day offsets (``datagen.date_to_days``).  ``q9(streaming_chunks
> 0)`` takes the streaming join for its lineitem ⋈ partsupp step.
"""
from __future__ import annotations

import functools
import re
from typing import Callable, Dict

import numpy as np
import torch

from ..compute import sort_multi
from ..config import JoinAlgorithm, JoinConfig, JoinType
from ..dtypes import DataType, Type
from ..parallel import (DTable, dist_aggregate, dist_anti_join, dist_groupby,
                        dist_head, dist_join, dist_join_streaming,
                        dist_project, dist_select, dist_semi_join, dist_sort,
                        dist_sort_multi, dist_with_column)
from ..ops.compact import to_device
from ..table import Column, Table, host_batch
from .datagen import YEAR_BOUNDS, date_to_days

Tables = Dict[str, DTable]


def _cfg(lkey, rkey, how: JoinType = JoinType.INNER) -> JoinConfig:
    return JoinConfig(how, JoinAlgorithm.SORT, lkey, rkey)


def _strip_prefixes(dt: DTable) -> DTable:
    """Drop the join's lt-/rt- name prefixes (TPC-H column names are
    globally unique)."""
    names = []
    for n in dt.column_names:
        while n.startswith("lt-") or n.startswith("rt-"):
            n = n[3:]
        names.append(n)
    return dt.rename(names)


def _isin(x: torch.Tensor, codes) -> torch.Tensor:
    return torch.isin(x, to_device(codes, x.device, torch.int32))


def _promoted(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x`` in the promoted type of (x, v), as jnp compares an array with
    a 0-d array (torch would compare in ``x``'s type)."""
    return x.to(torch.promote_types(x.dtype, v.dtype))


# -- cached predicate / expression factories --------------------------------

@functools.lru_cache(maxsize=None)
def _pred_lt(col: str, v):
    return lambda env: env[col] < v


@functools.lru_cache(maxsize=None)
def _pred_le(col: str, v):
    return lambda env: env[col] <= v


@functools.lru_cache(maxsize=None)
def _pred_gt(col: str, v):
    return lambda env: env[col] > v


@functools.lru_cache(maxsize=None)
def _pred_eq(col: str, v):
    return lambda env: env[col] == v


@functools.lru_cache(maxsize=None)
def _pred_range(col: str, lo, hi):
    return lambda env: (env[col] >= lo) & (env[col] < hi)


@functools.lru_cache(maxsize=None)
def _pred_range_incl(col: str, lo, hi):
    return lambda env: (env[col] >= lo) & (env[col] <= hi)


@functools.lru_cache(maxsize=None)
def _pred_cols_eq(a: str, b: str):
    return lambda env: env[a] == env[b]


@functools.lru_cache(maxsize=None)
def _pred_cols_ne(a: str, b: str):
    return lambda env: env[a] != env[b]


@functools.lru_cache(maxsize=None)
def _pred_cols_lt(a: str, b: str):
    return lambda env: env[a] < env[b]


@functools.lru_cache(maxsize=None)
def _pred_cols_lt_scaled(a: str, scale: float, b: str):
    return lambda env: env[a] < scale * env[b]


@functools.lru_cache(maxsize=None)
def _pred_cols_gt_scaled(a: str, scale: float, b: str):
    return lambda env: env[a] > scale * env[b]


@functools.lru_cache(maxsize=None)
def _pred_isin(col: str, codes: tuple):
    return lambda env: _isin(env[col], codes)


@functools.lru_cache(maxsize=None)
def _pred_notin(col: str, codes: tuple):
    return lambda env: ~_isin(env[col], codes)


@functools.lru_cache(maxsize=None)
def _pred_eq_isin(eq_col: str, v, in_col: str, codes: tuple):
    return lambda env: (env[eq_col] == v) & _isin(env[in_col], codes)


@functools.lru_cache(maxsize=None)
def _pred_gt_param(col: str):
    """col > (a device scalar param): the correlated-threshold shape."""
    return lambda env, v: _promoted(env[col], v) > v


@functools.lru_cache(maxsize=None)
def _pred_ge_param(col: str):
    return lambda env, v: _promoted(env[col], v) >= v


@functools.lru_cache(maxsize=None)
def _pred_q4(d0: int, d1: int):
    return lambda env: ((env["o_orderdate"] >= d0)
                        & (env["o_orderdate"] < d1))


@functools.lru_cache(maxsize=None)
def _pred_q6(d0: int, d1: int, dlo: float, dhi: float, q: float):
    return lambda env: ((env["l_shipdate"] >= d0) & (env["l_shipdate"] < d1)
                        & (env["l_discount"] >= dlo)
                        & (env["l_discount"] <= dhi)
                        & (env["l_quantity"] < q))


@functools.lru_cache(maxsize=None)
def _pred_q12(modes: tuple, d0: int, d1: int):
    return lambda env: (_isin(env["l_shipmode"], modes)
                        & (env["l_receiptdate"] >= d0)
                        & (env["l_receiptdate"] < d1)
                        & (env["l_commitdate"] < env["l_receiptdate"])
                        & (env["l_shipdate"] < env["l_commitdate"]))


@functools.lru_cache(maxsize=None)
def _pred_q16(bad_brand: int, bad_types: tuple, sizes: tuple):
    return lambda env: ((env["p_brand"] != bad_brand)
                        & ~_isin(env["p_type"], bad_types)
                        & _isin(env["p_size"], sizes))


@functools.lru_cache(maxsize=None)
def _pred_q19(brands: tuple, containers: tuple, qlos: tuple, qhis: tuple,
              sizes: tuple):
    """The spec's 3-branch disjunction over (brand, container set,
    quantity window, size ceiling); l_shipinstruct is not generated."""

    def pred(env):
        acc = None
        for b, cs, qlo, qhi, smax in zip(brands, containers, qlos, qhis,
                                         sizes):
            branch = ((env["p_brand"] == b) & _isin(env["p_container"], cs)
                      & (env["l_quantity"] >= qlo)
                      & (env["l_quantity"] <= qhi)
                      & (env["p_size"] >= 1) & (env["p_size"] <= smax))
            acc = branch if acc is None else (acc | branch)
        return acc

    return pred


def _pred_q21_cand(env):
    # ≥ 2 distinct suppliers in the order, exactly one of them late
    return (env["count_l_suppkey"] >= 2) & (env["sum_max_late"] == 1)


def _revenue(env):
    return env["l_extendedprice"] * (1.0 - env["l_discount"])


def _charge(env):
    return (env["l_extendedprice"] * (1.0 - env["l_discount"])
            * (1.0 + env["l_tax"]))


def _disc_rev(env):
    return env["l_extendedprice"] * env["l_discount"]


def _q9_amount(env):
    return (env["l_extendedprice"] * (1.0 - env["l_discount"])
            - env["ps_supplycost"] * env["l_quantity"])


def _promo_rev(env):
    return (env["promo_ind"].to(torch.float32)
            * env["l_extendedprice"] * (1.0 - env["l_discount"]))


def _late_ind(env):
    return (env["l_receiptdate"] > env["l_commitdate"]).to(torch.int32)


def _ps_value(env):
    return (env["ps_supplycost"].to(torch.float32)
            * env["ps_availqty"].to(torch.float32))


@functools.lru_cache(maxsize=None)
def _indicator_isin(col: str, codes: tuple):
    return lambda env: _isin(env[col], codes).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _indicator_notin(col: str, codes: tuple):
    return lambda env: (~_isin(env[col], codes)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _indicator_eq_times(col: str, v, val_col: str):
    """CASE WHEN col = v THEN val ELSE 0 END (Q8's share numerator)."""
    return lambda env: torch.where(env[col] == v, env[val_col],
                                   torch.zeros((), dtype=env[val_col].dtype,
                                               device=env[val_col].device))


@functools.lru_cache(maxsize=None)
def _year_of(col: str):
    """Day-offset column → calendar year (``datagen.days_to_year``)."""

    def fn(env):
        x = env[col]
        bounds = to_device(YEAR_BOUNDS, x.device, x.dtype)
        return (1992 + torch.searchsorted(bounds, x, right=True)
                - 1).to(torch.int32)

    return fn


_year_col = _year_of("o_orderdate")


# -- host-side helpers --------------------------------------------------------

def _dict_code(dt: DTable, column: str, value: str) -> int:
    """The dictionary code of a string literal (−1 matches nothing)."""
    c = dt.column(column)
    pos = int(np.searchsorted(c.dictionary, value))
    if pos >= len(c.dictionary) or c.dictionary[pos] != value:
        return -1
    return pos


def _dict_codes(dt: DTable, column: str, values) -> tuple:
    """Codes for a literal IN-list (missing values match nothing)."""
    return tuple(c for c in (_dict_code(dt, column, v) for v in values)
                 if c >= 0) or (-1,)


def _dict_codes_where(dt: DTable, column: str, test) -> tuple:
    """Codes whose dictionary string satisfies ``test`` (LIKE pushdown: a
    host scan of the dictionary, never of the rows)."""
    d = dt.column(column).dictionary
    return tuple(int(i) for i, s in enumerate(d) if test(str(s))) or (-1,)


def _host_cols(t: Tables, name: str) -> Dict[str, np.ndarray]:
    """A small dimension table (nation, region) on the host as {column:
    numpy values}, strings decoded; cached on the DTable instance.

    Inside an abstract plan run (``analysis/plan_check``) a table kept
    ``concrete`` answers from its real rows — name → key lookups over
    25-row tables are plan-time constants — and an abstract one reaches
    the host-export boundary (``PlanExportReached``), as its export
    would."""
    from ..analysis import plan_check
    dt = plan_check.concrete_source(t[name])
    cols = getattr(dt, "_host_cols_cache", None)
    if cols is None:
        tb = dt.to_table()
        tb.require_host("Table.to_arrow")
        cols = {}
        for c, v in zip(tb.columns, host_batch([c.data for c in tb.columns])):
            cols[c.name] = (np.asarray(c.dictionary, dtype=object)[v]
                            if c.dictionary is not None else v)
        dt._host_cols_cache = cols
    return cols


def _nation_keys(t: Tables, names) -> tuple:
    n = _host_cols(t, "nation")
    m = {str(a): int(k) for k, a in zip(n["n_nationkey"], n["n_name"])}
    return tuple(m[x] for x in names)


def _nation_names(t: Tables, keys) -> np.ndarray:
    n = _host_cols(t, "nation")
    m = {int(k): str(a) for k, a in zip(n["n_nationkey"], n["n_name"])}
    return np.array([m[int(k)] for k in keys], dtype=object)


def _region_nation_keys(t: Tables, region: str) -> tuple:
    r, n = _host_cols(t, "region"), _host_cols(t, "nation")
    rk = int(r["r_regionkey"][list(map(str, r["r_name"])).index(region)])
    return tuple(int(k) for k, rr in zip(n["n_nationkey"], n["n_regionkey"])
                 if int(rr) == rk)


def _scalar_table(ctx, name: str, val: torch.Tensor) -> Table:
    """One-row FLOAT result table over a device value (the tail of the
    scalar-answer queries Q14 / Q17 / Q19)."""
    return Table(ctx, [Column(name, DataType(Type.FLOAT),
                              val.reshape(1).to(torch.float32))])


def _device_scalar(table: Table, col: str) -> torch.Tensor:
    """A one-row aggregate as a 0-d device tensor: a predicate param that
    needs no host read."""
    return table.column(col).data[0]


def _pk1(t: Tables, table: str):
    """``dense_key_range`` of a 1-based base-table primary key (c_custkey,
    o_orderkey, s_suppkey, p_partkey are 1..N by construction)."""
    return (1, t[table].num_rows)


def _pk0(t: Tables, table: str):
    """Like ``_pk1`` for the 0-based keys (n_nationkey, r_regionkey)."""
    return (0, t[table].num_rows - 1)


def _month_span(date: str, months: int) -> tuple:
    """[day(date), day(date + months)) as day offsets."""
    m = np.datetime64(date, "M")
    d0 = date_to_days(date)
    d1 = d0 + int(((m + months).astype("datetime64[D]")
                   - m.astype("datetime64[D]")).astype(int))
    return d0, d1


# -- Q1: pricing summary report ----------------------------------------------

def q1(ctx, t: Tables, delta_days: int = 90) -> Table:
    cutoff = date_to_days("1998-12-01") - delta_days
    li = dist_project(t["lineitem"], [
        "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_orderkey"])
    li = dist_with_column(li, "disc_price", _revenue, Type.DOUBLE)
    li = dist_with_column(li, "charge", _charge, Type.DOUBLE)
    g = dist_groupby(li, ["l_returnflag", "l_linestatus"], [
        ("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("disc_price", "sum"), ("charge", "sum"),
        ("l_quantity", "mean"), ("l_extendedprice", "mean"),
        ("l_discount", "mean"), ("l_orderkey", "count"),
    ], where=_pred_le("l_shipdate", cutoff))
    return sort_multi(g.to_table(), ["l_returnflag", "l_linestatus"])


# -- Q2: minimum cost supplier ------------------------------------------------

def q2(ctx, t: Tables, size: int = 15, type_suffix: str = "BRASS",
       region: str = "EUROPE", limit: int = 100) -> Table:
    """Correlated MIN subquery = groupby-min + equality rejoin on the
    composite (part, cost) key."""
    r_code = _dict_code(t["region"], "r_name", region)
    reg = dist_project(dist_select(t["region"], _pred_eq("r_name", r_code)),
                       ["r_regionkey"])
    nr = _strip_prefixes(dist_join(
        dist_project(t["nation"], ["n_nationkey", "n_regionkey", "n_name"]),
        reg, _cfg("n_regionkey", "r_regionkey")))
    sn = _strip_prefixes(dist_join(
        dist_project(t["supplier"], ["s_suppkey", "s_nationkey",
                                     "s_acctbal"]),
        nr, _cfg("s_nationkey", "n_nationkey"),
        dense_key_range=_pk0(t, "nation")))
    sn = dist_project(sn, ["s_suppkey", "s_acctbal", "n_name"])
    tcodes = _dict_codes_where(t["part"], "p_type",
                               lambda s: s.endswith(type_suffix))
    part = dist_project(
        dist_select(dist_project(t["part"], ["p_partkey", "p_mfgr",
                                             "p_size", "p_type"]),
                    _pred_eq_isin("p_size", size, "p_type", tcodes)),
        ["p_partkey", "p_mfgr"])
    ps = dist_project(t["partsupp"],
                      ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    ps = _strip_prefixes(dist_join(ps, part, _cfg("ps_partkey", "p_partkey"),
                                   dense_key_range=_pk1(t, "part")))
    full = _strip_prefixes(dist_join(ps, sn, _cfg("ps_suppkey", "s_suppkey"),
                                     dense_key_range=_pk1(t, "supplier")))
    mins = dist_groupby(full, ["ps_partkey"], [("ps_supplycost", "min")])
    mins = mins.rename(["mpk", "min_cost"])
    # MIN picks an existing value: the float equality below is exact
    best = _strip_prefixes(dist_join(
        full, mins, _cfg(("ps_partkey", "ps_supplycost"),
                         ("mpk", "min_cost"))))
    best = dist_project(best, ["s_acctbal", "n_name", "p_partkey", "p_mfgr",
                               "s_suppkey", "ps_supplycost"])
    s = dist_sort_multi(best, ["s_acctbal", "n_name", "p_partkey"],
                        ascending=[False, True, True])
    return dist_head(s, limit)


# -- Q3: shipping priority ------------------------------------------------------

def q3(ctx, t: Tables, segment: str = "BUILDING",
       date: str = "1995-03-15", limit: int = 10) -> Table:
    day = date_to_days(date)
    seg = _dict_code(t["customer"], "c_mktsegment", segment)
    cust = dist_select(dist_project(t["customer"],
                                    ["c_custkey", "c_mktsegment"]),
                       _pred_eq("c_mktsegment", seg))
    # deferred selects: the masks fold into the dense FK probes
    orders = dist_select(dist_project(t["orders"],
                                      ["o_orderkey", "o_custkey",
                                       "o_orderdate", "o_shippriority"]),
                         _pred_lt("o_orderdate", day), compact=False)
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_orderkey", "l_shipdate",
                                   "l_extendedprice", "l_discount"]),
                     _pred_gt("l_shipdate", day), compact=False)
    co = _strip_prefixes(dist_join(orders, cust,
                                   _cfg("o_custkey", "c_custkey"),
                                   dense_key_range=_pk1(t, "customer")))
    col = _strip_prefixes(dist_join(li, co, _cfg("l_orderkey", "o_orderkey"),
                                    dense_key_range=_pk1(t, "orders")))
    col = dist_with_column(col, "volume", _revenue, Type.DOUBLE)
    g = dist_groupby(col, ["l_orderkey", "o_orderdate", "o_shippriority"],
                     [("volume", "sum")])
    s = dist_sort(g, "sum_volume", ascending=False)
    return dist_head(s, limit)


# -- Q4: order priority checking (EXISTS semi-join) -------------------------

def q4(ctx, t: Tables, date: str = "1993-07-01") -> Table:
    d0 = date_to_days(date)
    orders = dist_select(dist_project(t["orders"],
                                      ["o_orderkey", "o_orderpriority",
                                       "o_orderdate"]),
                         _pred_q4(d0, d0 + 92))
    orders = dist_project(orders, ["o_orderkey", "o_orderpriority"])
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_orderkey", "l_commitdate",
                                   "l_receiptdate"]),
                     _pred_cols_lt("l_commitdate", "l_receiptdate"),
                     compact=False)
    li = dist_project(li, ["l_orderkey"])
    m = dist_semi_join(orders, li, "o_orderkey", "l_orderkey",
                       dense_key_range=(1, t["orders"].num_rows))
    g = dist_groupby(m, ["o_orderpriority"], [("o_orderkey", "count")])
    out = g.to_table()
    return sort_multi(out.rename_column("count_o_orderkey", "order_count"),
                      ["o_orderpriority"])


# -- Q5: local supplier volume --------------------------------------------------

def q5(ctx, t: Tables, region: str = "ASIA",
       date: str = "1994-01-01") -> Table:
    d0 = date_to_days(date)
    r_code = _dict_code(t["region"], "r_name", region)
    reg = dist_project(dist_select(t["region"], _pred_eq("r_name", r_code)),
                       ["r_regionkey"])
    nr = _strip_prefixes(dist_join(
        dist_project(t["nation"], ["n_nationkey", "n_regionkey", "n_name"]),
        reg, _cfg("n_regionkey", "r_regionkey")))
    sn = _strip_prefixes(dist_join(
        dist_project(t["supplier"], ["s_suppkey", "s_nationkey"]), nr,
        _cfg("s_nationkey", "n_nationkey"),
        dense_key_range=_pk0(t, "nation")))
    sn = dist_project(sn, ["s_suppkey", "s_nationkey", "n_name"])
    orders = dist_project(
        dist_select(dist_project(t["orders"],
                                 ["o_orderkey", "o_custkey", "o_orderdate"]),
                    _pred_range("o_orderdate", d0, d0 + 365)),
        ["o_orderkey", "o_custkey"])
    co = _strip_prefixes(dist_join(
        orders, dist_project(t["customer"], ["c_custkey", "c_nationkey"]),
        _cfg("o_custkey", "c_custkey", JoinType.LEFT),
        dense_key_range=_pk1(t, "customer")))
    li = dist_project(t["lineitem"], ["l_orderkey", "l_suppkey",
                                      "l_extendedprice", "l_discount"])
    col = _strip_prefixes(dist_join(li, co,
                                    _cfg("l_orderkey", "o_orderkey"),
                                    dense_key_range=_pk1(t, "orders")))
    # join on suppkey, then the spec's c_nationkey = s_nationkey
    full = _strip_prefixes(dist_join(col, sn, _cfg("l_suppkey", "s_suppkey"),
                                     dense_key_range=_pk1(t, "supplier")))
    full = dist_select(full, _pred_cols_eq("c_nationkey", "s_nationkey"),
                       compact=False)
    full = dist_with_column(full, "volume", _revenue, Type.DOUBLE)
    g = dist_groupby(full, ["n_name"], [("volume", "sum")])
    s = dist_sort(g, "sum_volume", ascending=False)
    return s.to_table()


# -- Q6: forecasting revenue change -------------------------------------------

def q6(ctx, t: Tables, date: str = "1994-01-01", discount: float = 0.06,
       quantity: float = 24.0) -> Table:
    d0 = date_to_days(date)
    li = dist_with_column(t["lineitem"], "rev", _disc_rev, Type.DOUBLE)
    return dist_aggregate(li, [("rev", "sum")],
                          where=_pred_q6(d0, d0 + 365, discount - 0.011,
                                         discount + 0.011, quantity))


# -- Q7: volume shipping ----------------------------------------------------------

def q7(ctx, t: Tables, nation1: str = "FRANCE",
       nation2: str = "GERMANY") -> Table:
    """Shipping volume between two nations by year; the nation dimension
    is resolved on the host to key filters and a name map of the result."""
    k1, k2 = _nation_keys(t, [nation1, nation2])
    d0, d1 = date_to_days("1995-01-01"), date_to_days("1996-12-31")
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_orderkey", "l_suppkey", "l_shipdate",
                                   "l_extendedprice", "l_discount"]),
                     _pred_range_incl("l_shipdate", d0, d1),
                     compact=False)
    supp = dist_select(dist_project(t["supplier"],
                                    ["s_suppkey", "s_nationkey"]),
                       _pred_isin("s_nationkey", (k1, k2)))
    cust = dist_select(dist_project(t["customer"],
                                    ["c_custkey", "c_nationkey"]),
                       _pred_isin("c_nationkey", (k1, k2)))
    ls = _strip_prefixes(dist_join(li, supp, _cfg("l_suppkey", "s_suppkey"),
                                   dense_key_range=_pk1(t, "supplier")))
    orders = dist_project(t["orders"], ["o_orderkey", "o_custkey"])
    lso = _strip_prefixes(dist_join(ls, orders,
                                    _cfg("l_orderkey", "o_orderkey",
                                         JoinType.LEFT),
                                    dense_key_range=_pk1(t, "orders")))
    full = _strip_prefixes(dist_join(lso, cust,
                                     _cfg("o_custkey", "c_custkey"),
                                     dense_key_range=_pk1(t, "customer")))
    # both nationkeys ∈ {k1, k2}: inequality ⇔ the spec's (n1,n2)|(n2,n1)
    full = dist_select(full, _pred_cols_ne("s_nationkey", "c_nationkey"),
                       compact=False)
    full = dist_with_column(full, "l_year", _year_of("l_shipdate"),
                            Type.INT32)
    full = dist_with_column(full, "volume", _revenue, Type.DOUBLE)
    g = dist_groupby(full, ["s_nationkey", "c_nationkey", "l_year"],
                     [("volume", "sum")]).to_table()
    g.require_host("Table.to_arrow")  # the host tail starts here
    sk, ck, year, rev = host_batch([g.column(n).data for n in (
        "s_nationkey", "c_nationkey", "l_year", "sum_volume")])
    supp_n = _nation_names(t, sk)
    cust_n = _nation_names(t, ck)
    year = year.astype(np.int32)
    order = np.lexsort((year, cust_n.astype(str), supp_n.astype(str)))
    return Table.from_columns(ctx, {
        "supp_nation": supp_n[order], "cust_nation": cust_n[order],
        "l_year": year[order], "revenue": rev[order]})


# -- Q8: national market share ----------------------------------------------------

def q8(ctx, t: Tables, nation: str = "BRAZIL", region: str = "AMERICA",
       ptype: str = "ECONOMY ANODIZED STEEL") -> Table:
    nk = _nation_keys(t, [nation])[0]
    rkeys = _region_nation_keys(t, region)
    d0, d1 = date_to_days("1995-01-01"), date_to_days("1996-12-31")
    tcode = _dict_code(t["part"], "p_type", ptype)
    part = dist_project(
        dist_select(dist_project(t["part"], ["p_partkey", "p_type"]),
                    _pred_eq("p_type", tcode)), ["p_partkey"])
    li = dist_project(t["lineitem"],
                      ["l_orderkey", "l_partkey", "l_suppkey",
                       "l_extendedprice", "l_discount"])
    lp = dist_semi_join(li, part, "l_partkey", "p_partkey",
                        dense_key_range=(1, t["part"].num_rows))
    orders = dist_select(dist_project(t["orders"],
                                      ["o_orderkey", "o_custkey",
                                       "o_orderdate"]),
                         _pred_range_incl("o_orderdate", d0, d1))
    lpo = _strip_prefixes(dist_join(lp, orders,
                                    _cfg("l_orderkey", "o_orderkey"),
                                    dense_key_range=_pk1(t, "orders")))
    cust = dist_select(dist_project(t["customer"],
                                    ["c_custkey", "c_nationkey"]),
                       _pred_isin("c_nationkey", rkeys))
    lpoc = _strip_prefixes(dist_join(lpo, cust,
                                     _cfg("o_custkey", "c_custkey"),
                                     dense_key_range=_pk1(t, "customer")))
    supp = dist_project(t["supplier"], ["s_suppkey", "s_nationkey"])
    full = _strip_prefixes(dist_join(lpoc, supp,
                                     _cfg("l_suppkey", "s_suppkey",
                                          JoinType.LEFT),
                                     dense_key_range=_pk1(t, "supplier")))
    full = dist_with_column(full, "o_year", _year_col, Type.INT32)
    full = dist_with_column(full, "volume", _revenue, Type.DOUBLE)
    full = dist_with_column(full, "nation_vol",
                            _indicator_eq_times("s_nationkey", nk, "volume"),
                            Type.DOUBLE)
    g = dist_groupby(full, ["o_year"], [("nation_vol", "sum"),
                                        ("volume", "sum")]).to_table()
    g.require_host("Table.to_arrow")  # the host tail starts here
    year, nvol, vol = host_batch([g.column(n).data for n in (
        "o_year", "sum_nation_vol", "sum_volume")])
    year = year.astype(np.int32)
    share = nvol.astype(np.float64) / vol.astype(np.float64)
    order = np.argsort(year, kind="stable")
    return Table.from_columns(ctx, {"o_year": year[order],
                              "mkt_share": share[order].astype(np.float32)})


# -- Q9: product type profit measure --------------------------------------------

def q9(ctx, t: Tables, color: str = "green",
       streaming_chunks: int = 0) -> Table:
    codes = _dict_codes_where(t["part"], "p_name", lambda s: color in s)
    part = dist_project(dist_select(dist_project(t["part"],
                                                 ["p_partkey", "p_name"]),
                                    _pred_isin("p_name", codes)),
                        ["p_partkey"])
    li = dist_project(t["lineitem"],
                      ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                       "l_extendedprice", "l_discount"])
    # p_partkey is unique and the only part column kept: the filter join
    # is a semi-join
    lp = dist_semi_join(li, part, "l_partkey", "p_partkey",
                        dense_key_range=(1, t["part"].num_rows))
    ps = dist_project(t["partsupp"],
                      ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    # the one lineitem-scale composite-key join the dense FK path cannot
    # take.  ``streaming_chunks > 0`` stages the probe side through
    # dist_join_streaming: partsupp co-partitions once and stays
    # resident, lineitem goes through in slices, so only one slice's
    # exchange buffers are live at a time
    cfg9 = _cfg(("l_partkey", "l_suppkey"), ("ps_partkey", "ps_suppkey"))
    if streaming_chunks > 0:
        lps = _strip_prefixes(dist_join_streaming(lp, ps, cfg9,
                                                  chunks=streaming_chunks))
    else:
        lps = _strip_prefixes(dist_join(lp, ps, cfg9))
    sn = _strip_prefixes(dist_join(
        dist_project(t["supplier"], ["s_suppkey", "s_nationkey"]),
        dist_project(t["nation"], ["n_nationkey", "n_name"]),
        _cfg("s_nationkey", "n_nationkey", JoinType.LEFT),
        dense_key_range=_pk0(t, "nation")))
    lsn = _strip_prefixes(dist_join(lps, sn,
                                    _cfg("l_suppkey", "s_suppkey",
                                         JoinType.LEFT),
                                    dense_key_range=_pk1(t, "supplier")))
    orders = dist_project(t["orders"], ["o_orderkey", "o_orderdate"])
    full = _strip_prefixes(dist_join(lsn, orders,
                                     _cfg("l_orderkey", "o_orderkey",
                                          JoinType.LEFT),
                                     dense_key_range=_pk1(t, "orders")))
    full = dist_with_column(full, "o_year", _year_col, Type.INT32)
    full = dist_with_column(full, "amount", _q9_amount, Type.DOUBLE)
    g = dist_groupby(full, ["n_name", "o_year"], [("amount", "sum")])
    return sort_multi(g.to_table().rename_column("sum_amount", "sum_profit"),
                      ["n_name", "o_year"], ascending=[True, False])


# -- Q10: returned item reporting -------------------------------------------------

def q10(ctx, t: Tables, date: str = "1993-10-01", limit: int = 20) -> Table:
    d0 = date_to_days(date)
    r_code = _dict_code(t["lineitem"], "l_returnflag", "R")
    orders = dist_project(
        dist_select(dist_project(t["orders"],
                                 ["o_orderkey", "o_custkey", "o_orderdate"]),
                    _pred_range("o_orderdate", d0, d0 + 92)),
        ["o_orderkey", "o_custkey"])
    li = dist_project(
        dist_select(dist_project(t["lineitem"],
                                 ["l_orderkey", "l_returnflag",
                                  "l_extendedprice", "l_discount"]),
                    _pred_eq("l_returnflag", r_code), compact=False),
        ["l_orderkey", "l_extendedprice", "l_discount"])
    cust = dist_project(t["customer"], ["c_custkey", "c_nationkey",
                                        "c_acctbal"])
    co = _strip_prefixes(dist_join(orders, cust,
                                   _cfg("o_custkey", "c_custkey",
                                        JoinType.LEFT),
                                   dense_key_range=_pk1(t, "customer")))
    col = _strip_prefixes(dist_join(li, co, _cfg("l_orderkey", "o_orderkey"),
                                    dense_key_range=_pk1(t, "orders")))
    nat = dist_project(t["nation"], ["n_nationkey", "n_name"])
    full = _strip_prefixes(dist_join(col, nat,
                                     _cfg("c_nationkey", "n_nationkey",
                                          JoinType.LEFT),
                                     dense_key_range=_pk0(t, "nation")))
    full = dist_with_column(full, "volume", _revenue, Type.DOUBLE)
    g = dist_groupby(full, ["c_custkey", "n_name", "c_acctbal"],
                     [("volume", "sum")])
    s = dist_sort(g, "sum_volume", ascending=False)
    return dist_head(s, limit)


# -- Q11: important stock identification ----------------------------------------

def q11(ctx, t: Tables, nation: str = "GERMANY",
        fraction_per_sf: float = 0.0001) -> Table:
    """HAVING sum > FRACTION · total, the total a device-scalar predicate
    param (no host read).  SF derives from the supplier cardinality."""
    gk = _nation_keys(t, [nation])[0]
    sf = max(t["supplier"].num_rows / 10_000.0, 1e-9)
    supp = dist_project(
        dist_select(dist_project(t["supplier"], ["s_suppkey",
                                                 "s_nationkey"]),
                    _pred_eq("s_nationkey", gk)), ["s_suppkey"])
    ps = dist_project(t["partsupp"],
                      ["ps_partkey", "ps_suppkey", "ps_supplycost",
                       "ps_availqty"])
    ps = _strip_prefixes(dist_join(ps, supp, _cfg("ps_suppkey", "s_suppkey"),
                                   dense_key_range=_pk1(t, "supplier")))
    ps = dist_with_column(ps, "value", _ps_value, Type.DOUBLE)
    tot = _device_scalar(dist_aggregate(ps, [("value", "sum")]),
                         "sum_value")
    g = dist_groupby(ps, ["ps_partkey"], [("value", "sum")])
    g = dist_select(g, _pred_gt_param("sum_value"),
                    params=(tot * (fraction_per_sf / sf),))
    s = dist_sort(g, "sum_value", ascending=False)
    return s.to_table()


# -- Q12: shipping modes and order priority -------------------------------------

def q12(ctx, t: Tables, modes=("MAIL", "SHIP"),
        date: str = "1994-01-01") -> Table:
    d0 = date_to_days(date)
    mcodes = _dict_codes(t["lineitem"], "l_shipmode", modes)
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_orderkey", "l_shipmode", "l_shipdate",
                                   "l_commitdate", "l_receiptdate"]),
                     _pred_q12(mcodes, d0, d0 + 365))
    li = dist_project(li, ["l_orderkey", "l_shipmode"])
    orders = dist_project(t["orders"], ["o_orderkey", "o_orderpriority"])
    m = _strip_prefixes(dist_join(li, orders,
                                  _cfg("l_orderkey", "o_orderkey",
                                       JoinType.LEFT),
                                  dense_key_range=_pk1(t, "orders")))
    hi = _dict_codes(t["orders"], "o_orderpriority", ("1-URGENT", "2-HIGH"))
    m = dist_with_column(m, "high_line",
                         _indicator_isin("o_orderpriority", hi), Type.INT32)
    m = dist_with_column(m, "low_line",
                         _indicator_notin("o_orderpriority", hi), Type.INT32)
    g = dist_groupby(m, ["l_shipmode"], [("high_line", "sum"),
                                         ("low_line", "sum")])
    out = g.to_table().rename_column("sum_high_line", "high_line_count")
    return sort_multi(out.rename_column("sum_low_line", "low_line_count"),
                      ["l_shipmode"])


# -- Q13: customer distribution ------------------------------------------------

def q13(ctx, t: Tables) -> Table:
    """Orders-per-customer histogram including zero-order customers: the
    dense groupby's ``emit_empty`` keeps every c_custkey in [1,
    |customer|] as a group."""
    bad = _dict_codes_where(t["orders"], "o_comment",
                            lambda s: re.search("special.*requests", s)
                            is not None)
    orders = dist_select(dist_project(t["orders"],
                                      ["o_custkey", "o_comment"]),
                         _pred_notin("o_comment", bad), compact=False)
    per_c = dist_groupby(orders, ["o_custkey"],
                         [("o_custkey", "count")],
                         dense_key_range=(1, t["customer"].num_rows),
                         emit_empty=True)
    g = dist_groupby(per_c, ["count_o_custkey"],
                     [("count_o_custkey", "count")])
    g = dist_sort_multi(g, ["count_count_o_custkey", "count_o_custkey"],
                        ascending=[False, False])
    return g.to_table().rename_column("count_o_custkey", "c_count") \
        .rename_column("count_count_o_custkey", "custdist")


# -- Q14: promotion effect ------------------------------------------------------

def q14(ctx, t: Tables, date: str = "1995-09-01") -> Table:
    d0, d1 = _month_span(date, 1)
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_partkey", "l_shipdate",
                                   "l_extendedprice", "l_discount"]),
                     _pred_range("l_shipdate", d0, d1))
    li = dist_project(li, ["l_partkey", "l_extendedprice", "l_discount"])
    promo = _dict_codes_where(t["part"], "p_type",
                              lambda s: s.startswith("PROMO"))
    part = dist_project(t["part"], ["p_partkey", "p_type"])
    m = _strip_prefixes(dist_join(li, part,
                                  _cfg("l_partkey", "p_partkey",
                                       JoinType.LEFT),
                                  dense_key_range=_pk1(t, "part")))
    m = dist_with_column(m, "rev", _revenue, Type.DOUBLE)
    m = dist_with_column(m, "promo_ind", _indicator_isin("p_type", promo),
                         Type.INT32)
    m = dist_with_column(m, "promo_rev", _promo_rev, Type.DOUBLE)
    # the ratio stays on the device
    agg = dist_aggregate(m, [("promo_rev", "sum"), ("rev", "sum")])
    pr = agg.column("sum_promo_rev").data
    rv = agg.column("sum_rev").data
    val = torch.where(rv != 0.0,
                      100.0 * pr / torch.where(rv != 0.0, rv,
                                               torch.ones_like(rv)),
                      torch.zeros_like(rv))
    return _scalar_table(ctx, "promo_revenue", val)


# -- Q15: top supplier ------------------------------------------------------------

def q15(ctx, t: Tables, date: str = "1996-01-01") -> Table:
    """The revenue view + MAX correlated filter: MAX picks an existing
    group sum of the same kernel, so the float comparison is exact."""
    d0, d1 = _month_span(date, 3)
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_suppkey", "l_shipdate",
                                   "l_extendedprice", "l_discount"]),
                     _pred_range("l_shipdate", d0, d1), compact=False)
    li = dist_with_column(li, "rev", _revenue, Type.DOUBLE)
    revs = dist_groupby(li, ["l_suppkey"], [("rev", "sum")])
    mx = _device_scalar(dist_aggregate(revs, [("sum_rev", "max")]),
                        "max_sum_rev")
    top = dist_select(revs, _pred_ge_param("sum_rev"), params=(mx,))
    out = top.to_table().rename_column("sum_rev", "total_revenue")
    return sort_multi(out, ["l_suppkey"])


# -- Q16: parts/supplier relationship ---------------------------------------------

def q16(ctx, t: Tables, bad_brand: str = "Brand#45",
        bad_type_prefix: str = "MEDIUM POLISHED",
        sizes: tuple = (49, 14, 23, 45, 19, 3, 36, 9)) -> Table:
    """COUNT(DISTINCT ps_suppkey) = a two-level groupby; NOT IN
    (complaints suppliers) = the anti-join."""
    bad_s = _dict_codes_where(t["supplier"], "s_comment",
                              lambda s: re.search("Customer.*Complaints", s)
                              is not None)
    badsup = dist_project(
        dist_select(dist_project(t["supplier"], ["s_suppkey", "s_comment"]),
                    _pred_isin("s_comment", bad_s)), ["s_suppkey"])
    b45 = _dict_code(t["part"], "p_brand", bad_brand)
    btypes = _dict_codes_where(t["part"], "p_type",
                               lambda s: s.startswith(bad_type_prefix))
    part = dist_select(dist_project(t["part"], ["p_partkey", "p_brand",
                                                "p_type", "p_size"]),
                       _pred_q16(b45, btypes, sizes))
    ps = dist_project(t["partsupp"], ["ps_partkey", "ps_suppkey"])
    ps = dist_anti_join(ps, badsup, "ps_suppkey", "s_suppkey",
                        dense_key_range=(1, t["supplier"].num_rows))
    m = _strip_prefixes(dist_join(ps, part, _cfg("ps_partkey", "p_partkey"),
                                  dense_key_range=_pk1(t, "part")))
    per = dist_groupby(m, ["p_brand", "p_type", "p_size", "ps_suppkey"],
                       [("ps_suppkey", "count")])
    g = dist_groupby(per, ["p_brand", "p_type", "p_size"],
                     [("ps_suppkey", "count")])
    g = dist_sort_multi(g, ["count_ps_suppkey", "p_brand", "p_type",
                            "p_size"], ascending=[False, True, True, True])
    return g.to_table().rename_column("count_ps_suppkey", "supplier_cnt")


# -- Q17: small-quantity-order revenue --------------------------------------------

def q17(ctx, t: Tables, brand: str = "Brand#23",
        container: str = "MED BOX") -> Table:
    """Correlated AVG subquery: the semi-join keeps every lineitem of the
    qualifying parts, so the per-part average is one groupby + rejoin."""
    b = _dict_code(t["part"], "p_brand", brand)
    c = _dict_code(t["part"], "p_container", container)
    part = dist_project(
        dist_select(dist_project(t["part"], ["p_partkey", "p_brand",
                                             "p_container"]),
                    _pred_eq_isin("p_brand", b, "p_container", (c,))),
        ["p_partkey"])
    li = dist_project(t["lineitem"],
                      ["l_partkey", "l_quantity", "l_extendedprice"])
    li = dist_semi_join(li, part, "l_partkey", "p_partkey",
                        dense_key_range=(1, t["part"].num_rows))
    avg = dist_groupby(li, ["l_partkey"], [("l_quantity", "mean")])
    avg = avg.rename(["apk", "avg_qty"])
    m = _strip_prefixes(dist_join(li, avg,
                                  _cfg("l_partkey", "apk", JoinType.LEFT),
                                  dense_key_range=_pk1(t, "part")))
    sel = dist_select(m, _pred_cols_lt_scaled("l_quantity", 0.2, "avg_qty"),
                      compact=False)
    agg = dist_aggregate(sel, [("l_extendedprice", "sum")])
    return _scalar_table(ctx, "avg_yearly",
                         agg.column("sum_l_extendedprice").data / 7.0)


# -- Q18: large volume customer ---------------------------------------------------

def q18(ctx, t: Tables, quantity: float = 300.0, limit: int = 100) -> Table:
    li = dist_project(t["lineitem"], ["l_orderkey", "l_quantity"])
    # l_orderkey covers [1, |orders|]: the per-order aggregate runs
    # direct-address
    per_order = dist_groupby(li, ["l_orderkey"], [("l_quantity", "sum")],
                             dense_key_range=(1, t["orders"].num_rows))
    big = dist_select(per_order, _pred_gt("sum_l_quantity", quantity))
    orders = dist_project(t["orders"], ["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_totalprice"])
    m = _strip_prefixes(dist_join(big, orders,
                                  _cfg("l_orderkey", "o_orderkey",
                                       JoinType.LEFT),
                                  dense_key_range=_pk1(t, "orders")))
    cust = dist_project(t["customer"], ["c_custkey"])
    m = _strip_prefixes(dist_join(m, cust,
                                  _cfg("o_custkey", "c_custkey",
                                       JoinType.LEFT),
                                  dense_key_range=_pk1(t, "customer")))
    m = dist_project(m, ["c_custkey", "o_orderkey", "o_orderdate",
                         "o_totalprice", "sum_l_quantity"])
    s = dist_sort_multi(m, ["o_totalprice", "o_orderdate"],
                        ascending=[False, True])
    return dist_head(s, limit)


# -- Q19: discounted revenue --------------------------------------------------------

def q19(ctx, t: Tables) -> Table:
    part = dist_project(t["part"], ["p_partkey", "p_brand", "p_container",
                                    "p_size"])
    brands = tuple(_dict_code(t["part"], "p_brand", b)
                   for b in ("Brand#12", "Brand#23", "Brand#34"))
    containers = (
        _dict_codes(t["part"], "p_container",
                    ("SM CASE", "SM BOX", "SM PACK", "SM PKG")),
        _dict_codes(t["part"], "p_container",
                    ("MED BAG", "MED BOX", "MED PKG", "MED PACK")),
        _dict_codes(t["part"], "p_container",
                    ("LG CASE", "LG BOX", "LG PACK", "LG PKG")),
    )
    part = dist_select(part, _pred_isin("p_brand", brands))
    modes = _dict_codes(t["lineitem"], "l_shipmode", ("AIR", "REG AIR"))
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_partkey", "l_quantity", "l_shipmode",
                                   "l_extendedprice", "l_discount"]),
                     _pred_isin("l_shipmode", modes), compact=False)
    m = _strip_prefixes(dist_join(li, part, _cfg("l_partkey", "p_partkey"),
                                  dense_key_range=_pk1(t, "part")))
    m = dist_select(m, _pred_q19(brands, containers,
                                 (1.0, 10.0, 20.0), (11.0, 20.0, 30.0),
                                 (5, 10, 15)),
                    compact=False)
    m = dist_with_column(m, "rev", _revenue, Type.DOUBLE)
    agg = dist_aggregate(m, [("rev", "sum")])
    return _scalar_table(ctx, "revenue", agg.column("sum_rev").data)


# -- Q20: potential part promotion ------------------------------------------------

def q20(ctx, t: Tables, color: str = "forest", date: str = "1994-01-01",
        nation: str = "CANADA") -> Table:
    codes = _dict_codes_where(t["part"], "p_name",
                              lambda s: s.startswith(color))
    part = dist_project(
        dist_select(dist_project(t["part"], ["p_partkey", "p_name"]),
                    _pred_isin("p_name", codes)), ["p_partkey"])
    d0 = date_to_days(date)
    li = dist_select(dist_project(t["lineitem"],
                                  ["l_partkey", "l_suppkey", "l_shipdate",
                                   "l_quantity"]),
                     _pred_range("l_shipdate", d0, d0 + 365),
                     compact=False)
    li = dist_semi_join(li, part, "l_partkey", "p_partkey",
                        dense_key_range=(1, t["part"].num_rows))
    qty = dist_groupby(li, ["l_partkey", "l_suppkey"],
                       [("l_quantity", "sum")])
    qty = qty.rename(["qpk", "qsk", "sum_qty"])
    ps = dist_project(t["partsupp"],
                      ["ps_partkey", "ps_suppkey", "ps_availqty"])
    ps = dist_semi_join(ps, part, "ps_partkey", "p_partkey",
                        dense_key_range=(1, t["part"].num_rows))
    # inner join: (part, supp) pairs with no shipped lines drop out, as
    # the spec's NULL-subquery comparison excludes them
    m = _strip_prefixes(dist_join(ps, qty, _cfg(("ps_partkey", "ps_suppkey"),
                                                ("qpk", "qsk"))))
    m = dist_select(m, _pred_cols_gt_scaled("ps_availqty", 0.5, "sum_qty"),
                    compact=False)
    sup_ids = dist_groupby(m, ["ps_suppkey"], [("ps_suppkey", "count")])
    ck = _nation_keys(t, [nation])[0]
    supp = dist_select(dist_project(t["supplier"],
                                    ["s_suppkey", "s_nationkey"]),
                       _pred_eq("s_nationkey", ck))
    out = dist_semi_join(supp, sup_ids, "s_suppkey", "ps_suppkey",
                         dense_key_range=(1, t["supplier"].num_rows))
    return sort_multi(dist_project(out, ["s_suppkey"]).to_table(),
                      ["s_suppkey"])


# -- Q21: suppliers who kept orders waiting -------------------------------------

def q21(ctx, t: Tables, nation: str = "SAUDI ARABIA",
        limit: int = 100) -> Table:
    """EXISTS(other supplier) / NOT EXISTS(other late supplier) as
    per-order statistics: over each F-status order's supplier groups,
    n_suppliers ≥ 2 and exactly one late supplier, which must be l1's."""
    sk = _nation_keys(t, [nation])[0]
    fcode = _dict_code(t["orders"], "o_orderstatus", "F")
    orders_f = dist_project(
        dist_select(dist_project(t["orders"], ["o_orderkey",
                                               "o_orderstatus"]),
                    _pred_eq("o_orderstatus", fcode), compact=False),
        ["o_orderkey"])
    li = dist_project(t["lineitem"],
                      ["l_orderkey", "l_suppkey", "l_commitdate",
                       "l_receiptdate"])
    li = dist_semi_join(li, orders_f, "l_orderkey", "o_orderkey",
                        dense_key_range=(1, t["orders"].num_rows))
    li = dist_with_column(li, "late", _late_ind, Type.INT32)
    per_os = dist_groupby(li, ["l_orderkey", "l_suppkey"],
                          [("late", "max")])
    per_o = dist_groupby(per_os, ["l_orderkey"],
                         [("l_suppkey", "count"), ("max_late", "sum")],
                         dense_key_range=(1, t["orders"].num_rows))
    cand = dist_select(per_o, _pred_q21_cand, compact=False)
    supp_sa = dist_project(
        dist_select(dist_project(t["supplier"], ["s_suppkey",
                                                 "s_nationkey"]),
                    _pred_eq("s_nationkey", sk)), ["s_suppkey"])
    l1 = dist_select(li, _pred_eq("late", 1), compact=False)
    l1 = dist_semi_join(l1, supp_sa, "l_suppkey", "s_suppkey",
                        dense_key_range=(1, t["supplier"].num_rows))
    l1 = dist_semi_join(l1, cand, "l_orderkey", "l_orderkey",
                        dense_key_range=(1, t["orders"].num_rows))
    g = dist_groupby(l1, ["l_suppkey"], [("l_suppkey", "count")])
    g = dist_sort_multi(g, ["count_l_suppkey", "l_suppkey"],
                        ascending=[False, True])
    return dist_head(g, limit).rename_column("count_l_suppkey", "numwait")


# -- Q22: global sales opportunity ------------------------------------------------

def q22(ctx, t: Tables,
        codes: tuple = (13, 31, 23, 29, 30, 18, 17)) -> Table:
    """Country-code cohort above the positive-balance average with no
    orders: a device-scalar mean + an anti-join on custkey."""
    cust = dist_select(dist_project(t["customer"],
                                    ["c_custkey", "c_acctbal",
                                     "c_phone_cc"]),
                       _pred_isin("c_phone_cc", codes))
    avg = _device_scalar(dist_aggregate(cust, [("c_acctbal", "mean")],
                                        where=_pred_gt("c_acctbal", 0.0)),
                         "mean_c_acctbal")
    rich = dist_select(cust, _pred_gt_param("c_acctbal"), params=(avg,),
                       compact=False)
    orders = dist_project(t["orders"], ["o_custkey"])
    noord = dist_anti_join(rich, orders, "c_custkey", "o_custkey",
                           dense_key_range=(1, t["customer"].num_rows))
    g = dist_groupby(noord, ["c_phone_cc"], [("c_acctbal", "count"),
                                             ("c_acctbal", "sum")])
    out = g.to_table().rename_column("c_phone_cc", "cntrycode") \
        .rename_column("count_c_acctbal", "numcust") \
        .rename_column("sum_c_acctbal", "totacctbal")
    return sort_multi(out, ["cntrycode"])


QUERIES: Dict[str, Callable] = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
    "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12, "q13": q13,
    "q14": q14, "q15": q15, "q16": q16, "q17": q17, "q18": q18, "q19": q19,
    "q20": q20, "q21": q21, "q22": q22}
