"""TPC-H generated on the device, with an exact numpy mirror.

Every generated value is a pure function of (seed, row index): a
counter-based PRNG (the murmur3 finalizer over 32-bit words) feeds the
column formulas of ``cylon_tpu/tpch/datagen_device.py``.  The formulas are
written once against a small array backend (``_NP`` for numpy, ``_Torch``
for torch tensors), so

  * ``generate_device(ctx, sf, seed)`` builds the six large tables as
    DTables on the context's device, in the JAX package's per-shard block
    layout (``_sizes_offs``), with nothing crossing the host link but the
    two small dimension tables;
  * ``generate_mirror(sf, seed, tables, rows)`` computes the same values
    in numpy on the host (a window of rows, or whole tables) for the
    oracles.

torch has no full uint32 arithmetic (shift, add and mod raise on the
CPU), so both backends carry each 32-bit value in an int64 array and mask
with ``& 0xFFFFFFFF`` after every add and multiply (int64 products wrap
modulo 2^64, which keeps the low 32 bits exact); ``% n`` of a non-negative
int64 is the unsigned remainder.  Floats are separate float32 operations
in the JAX package's order (scale, then offset; ×100, round half to even,
÷100), so the device tables equal the mirror bit for bit on the CPU and
on the card.  Dictionary pools are built sorted, so codes are drawn in
sorted-dictionary space (the encode invariant of ``table.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .datagen import (COMMENT_WORDS, DAYS_TOTAL, LINE_STATUS, NATIONS,
                      P_CONTAINER_1, P_CONTAINER_2, P_NAME_WORDS, P_TYPE_S1,
                      P_TYPE_S2, P_TYPE_S3, PRIORITIES, REGIONS,
                      RETURN_FLAGS, SEGMENTS, SHIP_MODES, SUPPLIERS_PER_PART,
                      date_to_days, part_supp_key)

_M32 = 0xFFFFFFFF
_M1, _M2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9

# bumped when any formula or pool changes: it keys persisted timings and
# oracles to the data they were measured on (the JAX package's value)
DATA_VERSION = 1


# ---------------------------------------------------------------------------
# array backends: the few operations the formulas need beyond operators
# ---------------------------------------------------------------------------

class _NP:
    i32 = staticmethod(lambda x: x.astype(np.int32))
    i64 = staticmethod(lambda x: x.astype(np.int64))
    f32 = staticmethod(lambda x: x.astype(np.float32))
    where = staticmethod(np.where)
    round = staticmethod(np.round)

    @staticmethod
    def c32(v: float, like):
        return np.float32(v)

    @staticmethod
    def zeros_i32(n: int, like):
        return np.zeros(n, np.int32)


class _Torch:
    i32 = staticmethod(lambda x: x.to(torch.int32))
    i64 = staticmethod(lambda x: x.to(torch.int64))
    f32 = staticmethod(lambda x: x.to(torch.float32))
    where = staticmethod(torch.where)
    round = staticmethod(torch.round)  # half to even, as numpy

    @staticmethod
    def c32(v: float, like):
        return torch.tensor(v, dtype=torch.float32, device=like.device)

    @staticmethod
    def zeros_i32(n: int, like):
        return torch.zeros(n, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# counter-based PRNG (32-bit values carried in int64)
# ---------------------------------------------------------------------------

def _mix(x):
    """murmur3 finalizer: a full-avalanche bijection of 32-bit values."""
    x = ((x ^ (x >> 16)) * _M1) & _M32
    x = ((x ^ (x >> 13)) * _M2) & _M32
    return x ^ (x >> 16)


def _salt(seed: int, tag: int) -> int:
    """Per-draw-site salt (host integers)."""
    h = (seed * _GOLD + tag) & _M32
    h ^= h >> 16
    h = (h * _M1) & _M32
    h ^= h >> 13
    h = (h * _M2) & _M32
    return h ^ (h >> 16)


def _u32(xp, salt: int, i):
    """The raw stream: hash of (salt, index); ``i`` a non-negative index
    array of any integer type."""
    return _mix((xp.i64(i) + salt) & _M32)


def _randint(xp, salt: int, i, n: int):
    """Uniform int32 in [0, n) (modulo bias ≤ n/2^32)."""
    return xp.i32(_u32(xp, salt, i) % n)


def _rand01(xp, salt: int, i):
    """Uniform float32 in [0, 1): the top 24 hash bits scaled."""
    u = _u32(xp, salt, i)
    return xp.f32(u >> 8) * xp.c32(1.0 / (1 << 24), u)


def _uniform(xp, salt: int, i, lo: float, hi: float):
    r = _rand01(xp, salt, i)
    return r * xp.c32(hi - lo, r) + xp.c32(lo, r)


def _round2(xp, x):
    """Two-decimal rounding: ×100, round half to even, ÷100 in float32."""
    return xp.round(x * xp.c32(100.0, x)) / xp.c32(100.0, x)


class _T:
    """Draw-site tags, one per random column or decision (the JAX
    package's, so both generate the same tables from one seed)."""
    LINES = 1
    ODATE = 2
    OCUST = 3
    OPRIO = 4
    OPRICE = 5
    OCA = 6
    OCB = 7
    OCC = 8
    OCHIT = 9
    LPART = 10
    LSUPI = 11
    LSHIP = 12
    LCOMMIT = 13
    LRECEIPT = 14
    LQTY = 15
    LPRICE = 16
    LDISC = 17
    LTAX = 18
    LRFLAG = 19
    LMODE = 20
    CNAT = 21
    CBAL = 22
    CSEG = 23
    SNAT = 24
    SBAL = 25
    SCA = 26
    SCB = 27
    SCC = 28
    SCHIT = 29
    PNAME = 30
    PTYPE = 31
    PBRAND = 32
    PCONT = 33
    PSIZE = 34
    PPRICE = 35
    PSCOST = 36
    PSQTY = 37
    BENCH_K = 60  # the join microbench's columns (bench_join_cols)
    BENCH_V = 61


# ---------------------------------------------------------------------------
# dictionary pools, built sorted
# ---------------------------------------------------------------------------

_WORDS = sorted(COMMENT_WORDS)
_W = len(_WORDS)
# "a b c" over a sorted word list, (a,b,c)-major, is lexically sorted: the
# separating space sorts below every word character
COMMENT_POOL = [f"{a} {b} {c}" for a in _WORDS for b in _WORDS
                for c in _WORDS]
NAME_POOL = sorted({f"{a} {b}" for a in P_NAME_WORDS for b in P_NAME_WORDS})
TYPE_POOL = [f"{a} {b} {c}" for a in sorted(P_TYPE_S1)
             for b in sorted(P_TYPE_S2) for c in sorted(P_TYPE_S3)]
CONTAINER_POOL = [f"{a} {b}" for a in sorted(P_CONTAINER_1)
                  for b in sorted(P_CONTAINER_2)]
BRAND_POOL = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
MFGR_POOL = [f"Manufacturer#{m}" for m in range(1, 6)]
STATUS_POOL = ["F", "O", "P"]
NATION_POOL = sorted(n for n, _ in NATIONS)

_LINESTATUS_CUTOFF = date_to_days("1995-06-17")


def _comment_code(xp, seed: int, tags, i):
    """Random 3-word comment codes, 2% planted with (word_a … word_c) in
    order: the LIKE-pattern cohort Q13 / Q16 scan for."""
    ta, tb, tc, thit, wa, wc = tags
    a = _randint(xp, _salt(seed, ta), i, _W)
    b = _randint(xp, _salt(seed, tb), i, _W)
    c = _randint(xp, _salt(seed, tc), i, _W)
    hit = _randint(xp, _salt(seed, thit), i, 50) == 0
    a = xp.where(hit, _WORDS.index(wa), a)
    c = xp.where(hit, _WORDS.index(wc), c)
    return xp.i32(a * (_W * _W) + b * _W + c)


def _scale_counts(scale: float):
    n_cust = max(int(150_000 * scale), 1)
    n_ord = max(int(1_500_000 * scale), 1)
    n_supp = max(int(10_000 * scale), SUPPLIERS_PER_PART)
    n_part = max(int(200_000 * scale), 1)
    return n_cust, n_ord, n_supp, n_part


def _lines_per(xp, seed: int, o_idx):
    """1–7 lines per order (E = 4, so lineitem ≈ 6M·SF)."""
    return 1 + _randint(xp, _salt(seed, _T.LINES), o_idx, 7)


# ---------------------------------------------------------------------------
# column formulas (xp ∈ {_NP, _Torch})
# ---------------------------------------------------------------------------

def _orders_cols(xp, seed: int, o_idx, starts, lines_per, n_cust: int):
    """All orders columns from the order index, plus the positions of each
    order's first line, so o_orderstatus folds its lines' statuses with a
    7-step loop (lines_per ≤ 7)."""
    n_valid_cust = max(n_cust - n_cust // 3, 1)
    ci = _randint(xp, _salt(seed, _T.OCUST), o_idx, n_valid_cust)
    odate = _randint(xp, _salt(seed, _T.ODATE), o_idx, DAYS_TOTAL)
    s_ship = _salt(seed, _T.LSHIP)
    n_o = xp.zeros_i32(o_idx.shape[0], o_idx)
    for j in range(7):
        ship = odate + 1 + _randint(xp, s_ship, starts + j, 121)
        is_o = (ship > _LINESTATUS_CUTOFF) & (lines_per > j)
        n_o = n_o + xp.i32(is_o)
    status = xp.where(n_o == 0, 0, xp.where(n_o == lines_per, 1, 2))
    return {
        "o_orderkey": xp.i32(o_idx + 1),
        # spec 4.2.3: o_custkey is never a multiple of 3
        "o_custkey": xp.i32(3 * (ci // 2) + 1 + ci % 2),
        "o_orderdate": odate,
        "o_orderpriority": _randint(xp, _salt(seed, _T.OPRIO), o_idx,
                                    len(PRIORITIES)),
        "o_shippriority": xp.zeros_i32(o_idx.shape[0], o_idx),
        "o_totalprice": _round2(xp, _uniform(xp, _salt(seed, _T.OPRICE),
                                             o_idx, 900.0, 500_000.0)),
        "o_comment": _comment_code(xp, seed,
                                   (_T.OCA, _T.OCB, _T.OCC, _T.OCHIT,
                                    "special", "requests"), o_idx),
        "o_orderstatus": xp.i32(status),
    }


def _lineitem_cols(xp, seed: int, li_idx, order_idx, n_part: int,
                   n_supp: int):
    """All lineitem columns from (line index, owning-order index)."""
    odate = _randint(xp, _salt(seed, _T.ODATE), order_idx, DAYS_TOTAL)
    ship = odate + 1 + _randint(xp, _salt(seed, _T.LSHIP), li_idx, 121)
    commit = odate + 30 + _randint(xp, _salt(seed, _T.LCOMMIT), li_idx, 61)
    receipt = ship + 1 + _randint(xp, _salt(seed, _T.LRECEIPT), li_idx, 30)
    partkey = 1 + _randint(xp, _salt(seed, _T.LPART), li_idx, n_part)
    suppkey = xp.i32(part_supp_key(
        partkey, _randint(xp, _salt(seed, _T.LSUPI), li_idx,
                          SUPPLIERS_PER_PART), n_supp))
    return {
        "l_orderkey": xp.i32(order_idx + 1),
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_quantity": xp.f32(1 + _randint(xp, _salt(seed, _T.LQTY), li_idx,
                                          50)),
        "l_extendedprice": _round2(xp, _uniform(
            xp, _salt(seed, _T.LPRICE), li_idx, 900.0, 105_000.0)),
        "l_discount": (xp.f32(_randint(xp, _salt(seed, _T.LDISC), li_idx, 11))
                       / xp.c32(100.0, li_idx)),
        "l_tax": (xp.f32(_randint(xp, _salt(seed, _T.LTAX), li_idx, 9))
                  / xp.c32(100.0, li_idx)),
        "l_returnflag": _randint(xp, _salt(seed, _T.LRFLAG), li_idx,
                                 len(RETURN_FLAGS)),
        "l_linestatus": xp.i32(ship > _LINESTATUS_CUTOFF),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipmode": _randint(xp, _salt(seed, _T.LMODE), li_idx,
                               len(SHIP_MODES)),
    }


def _customer_cols(xp, seed: int, c_idx):
    nat = _randint(xp, _salt(seed, _T.CNAT), c_idx, 25)
    return {
        "c_custkey": xp.i32(c_idx + 1),
        "c_nationkey": nat,
        "c_acctbal": _round2(xp, _uniform(xp, _salt(seed, _T.CBAL), c_idx,
                                          -999.99, 9999.99)),
        "c_mktsegment": _randint(xp, _salt(seed, _T.CSEG), c_idx,
                                 len(SEGMENTS)),
        # spec 4.2.2.9: the phone's country code is nationkey + 10
        "c_phone_cc": xp.i32(nat + 10),
    }


def _supplier_cols(xp, seed: int, s_idx):
    return {
        "s_suppkey": xp.i32(s_idx + 1),
        "s_nationkey": _randint(xp, _salt(seed, _T.SNAT), s_idx, 25),
        "s_acctbal": _round2(xp, _uniform(xp, _salt(seed, _T.SBAL), s_idx,
                                          -999.99, 9999.99)),
        "s_comment": _comment_code(xp, seed,
                                   (_T.SCA, _T.SCB, _T.SCC, _T.SCHIT,
                                    "Customer", "Complaints"), s_idx),
    }


def _part_cols(xp, seed: int, p_idx):
    brand = _randint(xp, _salt(seed, _T.PBRAND), p_idx, len(BRAND_POOL))
    return {
        "p_partkey": xp.i32(p_idx + 1),
        "p_name": _randint(xp, _salt(seed, _T.PNAME), p_idx,
                           len(NAME_POOL)),
        "p_mfgr": brand // 5,
        "p_type": _randint(xp, _salt(seed, _T.PTYPE), p_idx,
                           len(TYPE_POOL)),
        "p_brand": brand,
        "p_container": _randint(xp, _salt(seed, _T.PCONT), p_idx,
                                len(CONTAINER_POOL)),
        "p_size": 1 + _randint(xp, _salt(seed, _T.PSIZE), p_idx, 50),
        "p_retailprice": _round2(xp, _uniform(
            xp, _salt(seed, _T.PPRICE), p_idx, 900.0, 2000.0)),
    }


def _partsupp_cols(xp, seed: int, ps_idx, n_supp: int):
    partkey = xp.i32(ps_idx // SUPPLIERS_PER_PART + 1)
    i = xp.i32(ps_idx % SUPPLIERS_PER_PART)
    return {
        "ps_partkey": partkey,
        "ps_suppkey": xp.i32(part_supp_key(partkey, i, n_supp)),
        "ps_supplycost": _round2(xp, _uniform(
            xp, _salt(seed, _T.PSCOST), ps_idx, 1.0, 1000.0)),
        "ps_availqty": 1 + _randint(xp, _salt(seed, _T.PSQTY), ps_idx,
                                    9999),
    }


def _backend(xp):
    """The array backend for ``xp``: the ``numpy`` or ``torch`` module, or
    a backend (``_NP`` / ``_Torch``) itself."""
    if xp is np:
        return _NP
    if xp is torch:
        return _Torch
    return xp


def bench_join_cols(xp, seed: int, idx, krange: int):
    """The join microbench's side (``bench.py``): per global row index
    ``idx``, an int32 key uniform in ``[0, krange)`` (about 1% duplicates
    at ``krange`` = 0.99·rows) and three float32 payloads in [0, 1).
    ``xp`` is ``numpy`` or ``torch``; the two give the same bits."""
    xp = _backend(xp)
    out = {"k": _randint(xp, _salt(seed, _T.BENCH_K), idx, krange)}
    for j in range(3):
        out[f"v{j}"] = _rand01(xp, _salt(seed, _T.BENCH_V + j), idx)
    return out


_ELEMENTWISE = {"customer": _customer_cols, "supplier": _supplier_cols,
                "part": _part_cols}

# column order per table (the schema the JAX package's tables carry)
COLUMN_ORDER = {
    "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                 "l_linestatus", "l_shipdate", "l_commitdate",
                 "l_receiptdate", "l_shipmode"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
               "o_shippriority", "o_totalprice", "o_comment",
               "o_orderstatus"],
    "customer": ["c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment",
                 "c_phone_cc"],
    "supplier": ["s_suppkey", "s_nationkey", "s_acctbal", "s_comment"],
    "part": ["p_partkey", "p_name", "p_mfgr", "p_type", "p_brand",
             "p_container", "p_size", "p_retailprice"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost",
                 "ps_availqty"],
    "nation": ["n_nationkey", "n_name", "n_regionkey"],
    "region": ["r_regionkey", "r_name"],
}

# the dictionary of every string column (the rest are numeric)
DICTS = {
    "o_orderpriority": PRIORITIES, "o_comment": COMMENT_POOL,
    "o_orderstatus": STATUS_POOL,
    "l_returnflag": RETURN_FLAGS, "l_linestatus": LINE_STATUS,
    "l_shipmode": SHIP_MODES,
    "c_mktsegment": SEGMENTS,
    "s_comment": COMMENT_POOL,
    "p_name": NAME_POOL, "p_mfgr": MFGR_POOL, "p_type": TYPE_POOL,
    "p_brand": BRAND_POOL, "p_container": CONTAINER_POOL,
    "n_name": NATION_POOL, "r_name": REGIONS,
}
FLOAT_COLS = {"o_totalprice", "l_quantity", "l_extendedprice",
              "l_discount", "l_tax", "c_acctbal", "s_acctbal",
              "p_retailprice", "ps_supplycost"}


def _nation_region_cols() -> Dict[str, Dict[str, np.ndarray]]:
    names = [n for n, _ in NATIONS]
    return {
        "nation": {
            "n_nationkey": np.arange(25, dtype=np.int32),
            "n_name": np.searchsorted(NATION_POOL, names).astype(np.int32),
            "n_regionkey": np.array([r for _, r in NATIONS], np.int32)},
        "region": {"r_regionkey": np.arange(5, dtype=np.int32),
                   "r_name": np.arange(5, dtype=np.int32)},
    }


# ---------------------------------------------------------------------------
# host mirror (numpy)
# ---------------------------------------------------------------------------

def generate_mirror(scale: float, seed: int = 42,
                    tables: Optional[Sequence[str]] = None,
                    rows: Optional[Tuple[int, int]] = None):
    """The numpy twin of ``generate_device``: the same formulas, the same
    values.  Returns ``({table: {column: ndarray}}, {column: dictionary})``
    with string columns as codes into their sorted dictionary.

    ``tables`` restricts which tables to build; ``rows=(lo, hi)`` builds
    only the global rows [lo, hi) of each (clipped to its length), so a
    window of a large table costs its rows, not the table."""
    n_cust, n_ord, n_supp, n_part = _scale_counts(scale)
    want = set(tables) if tables is not None else set(COLUMN_ORDER)

    def window(n: int) -> np.ndarray:
        lo, hi = (0, n) if rows is None else (max(rows[0], 0),
                                              min(rows[1], n))
        return np.arange(lo, max(hi, lo), dtype=np.int64)

    out: Dict[str, Dict[str, np.ndarray]] = {}
    if want & {"orders", "lineitem"}:
        lp = _lines_per(_NP, seed, np.arange(n_ord, dtype=np.int64))
        ends = np.cumsum(lp, dtype=np.int64)
        starts = ends - lp
        if "orders" in want:
            o = window(n_ord)
            out["orders"] = _orders_cols(_NP, seed, o, starts[o], lp[o],
                                         n_cust)
        if "lineitem" in want:
            li = window(int(ends[-1]))
            order_idx = np.searchsorted(ends, li, side="right")
            out["lineitem"] = _lineitem_cols(_NP, seed, li, order_idx,
                                             n_part, n_supp)
    for name, n in (("customer", n_cust), ("supplier", n_supp),
                    ("part", n_part)):
        if name in want:
            out[name] = _ELEMENTWISE[name](_NP, seed, window(n))
    if "partsupp" in want:
        out["partsupp"] = _partsupp_cols(
            _NP, seed, window(n_part * SUPPLIERS_PER_PART), n_supp)
    for name, cols in _nation_region_cols().items():
        if name in want:
            idx = window(len(next(iter(cols.values()))))
            out[name] = {c: v[idx] for c, v in cols.items()}
    out = {name: {c: out[name][c] for c in COLUMN_ORDER[name]}
           for name in COLUMN_ORDER if name in out}
    dicts = {c: np.asarray(DICTS[c], dtype=object)
             for name in out for c in out[name] if c in DICTS}
    return out, dicts


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def _sizes_offs(n: int, world: int):
    """The per-shard block split (``DTable.from_table``'s layout)."""
    base, rem = divmod(n, world)
    sizes = np.array([base + (1 if i < rem else 0) for i in range(world)],
                     np.int32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return sizes, offs


def _block_index(n: int, ctx):
    """This process's padded-block positions → (global row id, valid flag,
    sizes of all P shards, cap): the blocks of its L local ranks, rank
    ``get_rank() + l`` holding the block layout's slice of that rank."""
    from ..ops.compact import next_bucket
    world, r0 = ctx.get_world_size(), ctx.get_rank()
    L, dev = ctx.get_local_world_size(), ctx.device
    sizes, offs = _sizes_offs(n, world)
    cap = next_bucket(max(int(sizes.max(initial=0)), 1), minimum=8)
    p = torch.arange(L * cap, dtype=torch.int64, device=dev)
    shard = torch.div(p, cap, rounding_mode="floor")
    local = p - shard * cap
    g = torch.from_numpy(offs[r0:r0 + L]).to(dev)[shard] + local
    valid = local < torch.from_numpy(
        sizes[r0:r0 + L].astype(np.int64)).to(dev)[shard]
    return g, valid, sizes, cap


def _dtable(ctx, name: str, cols: Dict[str, torch.Tensor], valid,
            sizes: np.ndarray, cap: int):
    from ..dtypes import DataType, Type
    from ..parallel.dtable import DColumn, DTable
    dcols = []
    for c in COLUMN_ORDER[name]:
        data = torch.where(valid, cols[c], 0).to(cols[c].dtype)
        if c in DICTS:
            dcols.append(DColumn(c, DataType(Type.STRING), data,
                                 dictionary=np.asarray(DICTS[c],
                                                       dtype=object)))
        elif c in FLOAT_COLS:
            dcols.append(DColumn(c, DataType(Type.FLOAT), data))
        else:
            dcols.append(DColumn(c, DataType(Type.INT32), data))
    r0 = ctx.get_rank()
    local = sizes[r0:r0 + ctx.get_local_world_size()]
    out = DTable(ctx, dcols, cap, torch.from_numpy(local.copy()).to(
        ctx.device))
    out._counts_host = sizes.copy()  # statically known layout, all P
    return out


def generate_device(ctx, scale: float, seed: int = 42):
    """All eight TPC-H tables as DTables on ``ctx``'s device.  The six
    large ones are computed there (row ids → formulas, in place in their
    padded blocks); nation and region (25 and 5 rows) are ingested from
    the host.

    Across processes each process builds the blocks of its own ranks
    only, from their global row ids (the same formulas, so the tables
    equal the single-process world's shard for shard); the order →
    line structure and the row counts are computed alike in every
    process, so no collective runs."""
    from ..parallel.dtable import DTable
    from ..table import Table
    dev = ctx.device
    n_cust, n_ord, n_supp, n_part = _scale_counts(scale)
    xp = _Torch
    out = {}

    # orders + lineitem share the line → order structure
    lp = _lines_per(xp, seed, torch.arange(n_ord, dtype=torch.int64,
                                           device=dev))
    ends = torch.cumsum(lp, 0)
    starts = ends - lp
    n_li = int(ends[-1])
    g, valid, sizes, cap = _block_index(n_ord, ctx)
    safe = torch.clamp(g, max=n_ord - 1)
    out["orders"] = _dtable(ctx, "orders", _orders_cols(
        xp, seed, g, starts[safe], lp[safe], n_cust), valid, sizes, cap)
    del starts
    g, valid, sizes, cap = _block_index(n_li, ctx)
    safe = torch.clamp(g, max=n_li - 1)
    order_idx = torch.searchsorted(ends, safe, right=True)
    del ends, lp
    out["lineitem"] = _dtable(ctx, "lineitem", _lineitem_cols(
        xp, seed, safe, order_idx, n_part, n_supp), valid, sizes, cap)
    del order_idx, safe, g, valid

    for name, n in (("customer", n_cust), ("supplier", n_supp),
                    ("part", n_part)):
        g, valid, sizes, cap = _block_index(n, ctx)
        out[name] = _dtable(ctx, name, _ELEMENTWISE[name](xp, seed, g),
                            valid, sizes, cap)
    g, valid, sizes, cap = _block_index(n_part * SUPPLIERS_PER_PART, ctx)
    out["partsupp"] = _dtable(ctx, "partsupp",
                              _partsupp_cols(xp, seed, g, n_supp), valid,
                              sizes, cap)
    for name, cols in _nation_region_cols().items():
        data = {c: (np.asarray(DICTS[c], dtype=object)[v] if c in DICTS
                    else v) for c, v in cols.items()}
        out[name] = DTable.from_table(ctx, Table.from_columns(ctx, data))
    return {name: out[name] for name in ("lineitem", "orders", "customer",
                                         "supplier", "nation", "region",
                                         "part", "partsupp")}
