"""The host TPC-H generator (numpy and pandas), its constants and date
helpers.

The port's copy of ``cylon_tpu/tpch/datagen.py``: the value pools, the
date window, the calendar-year bounds, the date conversions, the
supplier-of-part formula and :func:`generate`, the eight tables as pandas
frames drawn from ``np.random.default_rng(seed)`` in the JAX package's
order, so both packages build the same frames from one seed.
Cardinalities follow the TPC-H 2.x spec (lineitem ≈ 6M·SF via 1–7 lines
per order, orders = 1.5M·SF, customer = 150k·SF, part = 200k·SF,
partsupp = 4 suppliers per part, supplier = 10k·SF, 25 nations over 5
regions), typed for the device: DATE → int32 days since 1992-01-01,
money and quantity → float32, low-cardinality strings → ``Categorical``
columns that ingest as dictionary codes (``DTable.from_pandas``).  The
device generator (``datagen_device``) draws other values from a
counter-based stream with the same shapes.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

# day offsets from 1992-01-01 (the spec's STARTDATE).  o_orderdate spans
# [day 0, day 2405 = 1998-08-02], so l_receiptdate (orderdate + ≤121 ship
# + ≤30 receipt) never passes ENDDATE = 1998-12-31 (day 2556).
DAYS_TOTAL = 2406
_EPOCH = np.datetime64("1992-01-01")

# YEAR_BOUNDS[i] = first day of year 1992+i (1992 and 1996 are leap years)
YEAR_BOUNDS = np.array([0, 366, 731, 1096, 1461, 1827, 2192, 2557],
                       dtype=np.int32)

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
RETURN_FLAGS = ["A", "N", "R"]
LINE_STATUS = ["F", "O"]
SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
NATIONS = [  # (name, region): the spec's 25 nations over 5 regions
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cream",
    "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral",
    "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
    "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
]
P_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
P_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
P_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_CONTAINER_1 = ["SM", "MED", "LG", "JUMBO", "WRAP"]
P_CONTAINER_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

TABLE_NAMES = ("lineitem", "orders", "customer", "supplier", "nation",
               "region", "part", "partsupp")

# words of the dictionary-encoded 3-word comments standing in for dbgen's
# free text; the LIKE patterns of Q13 ('%special%requests%') and Q16
# ('%Customer%Complaints%') match a planted minority
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "regular", "final", "pending", "express", "special", "unusual",
    "requests", "deposits", "packages", "accounts", "instructions",
    "theodolites", "Customer", "Complaints", "platelets", "foxes",
]

# every "a b c" phrase of COMMENT_WORDS in (a, b, c) order: the host
# generator's comment categories
COMMENT_POOL = [f"{a} {b} {c}" for a in COMMENT_WORDS
                for b in COMMENT_WORDS for c in COMMENT_WORDS]

SUPPLIERS_PER_PART = 4


def date_to_days(iso: str) -> int:
    """'1995-03-15' → the int32 day offset every date column holds."""
    return int((np.datetime64(iso) - _EPOCH).astype(int))


def days_to_year(days: np.ndarray) -> np.ndarray:
    """Day offsets → calendar year (1992..1998)."""
    return (1992 + np.searchsorted(YEAR_BOUNDS, days, side="right")
            - 1).astype(np.int32)


def part_supp_key(partkey, i, n_supp: int):
    """The spec's supplier-of-part formula: the i-th (0..3) supplier of
    part p is ((p + i·(S/4)) mod S) + 1, so every (l_partkey, l_suppkey)
    pair drawn with it exists in partsupp.  Operators only, so numpy
    arrays and torch tensors both work; int32 in, int32 out."""
    step = max(n_supp // SUPPLIERS_PER_PART, 1)
    return ((partkey - 1) + i * step) % n_supp + 1


def _comment_codes(rng, n: int, pattern_words) -> np.ndarray:
    """Codes into ``COMMENT_POOL``: random 3-word comments, about 2% with
    ``pattern_words`` planted first and last (code = a·W² + b·W + c)."""
    W = len(COMMENT_WORDS)
    a = rng.integers(0, W, n)
    b = rng.integers(0, W, n)
    c = rng.integers(0, W, n)
    hit = rng.random(n) < 0.02
    a[hit] = COMMENT_WORDS.index(pattern_words[0])
    c[hit] = COMMENT_WORDS.index(pattern_words[1])
    return (a * W * W + b * W + c).astype(np.int32)


def generate(scale: float, seed: int = 42) -> Dict[str, pd.DataFrame]:
    """All eight tables as pandas DataFrames (``DTable.from_pandas`` types
    them for the device).  ``scale`` is the TPC-H SF; a fractional scale
    shrinks every table in proportion (at least one row) for tests."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n_cust = max(int(150_000 * scale), 1)
    n_ord = max(int(1_500_000 * scale), 1)
    n_supp = max(int(10_000 * scale), SUPPLIERS_PER_PART)
    n_part = max(int(200_000 * scale), 1)

    c_nationkey = rng.integers(0, 25, n_cust).astype(np.int32)
    customer = pd.DataFrame({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
        "c_nationkey": c_nationkey,
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2)
        .astype(np.float32),
        "c_mktsegment": pd.Categorical.from_codes(
            rng.integers(0, len(SEGMENTS), n_cust), SEGMENTS),
        # spec 4.2.2.9: the phone's country code is nationkey + 10, kept
        # as the int32 code itself (Q22's substring(c_phone, 1, 2))
        "c_phone_cc": (c_nationkey + 10).astype(np.int32),
    })

    o_orderdate = rng.integers(0, DAYS_TOTAL, n_ord).astype(np.int32)
    # spec 4.2.3: o_custkey is never a multiple of 3, so a third of the
    # customers place no order; valid key i ↦ 3·(i//2) + 1 + i%2
    n_valid_cust = n_cust - n_cust // 3
    ci = rng.integers(0, max(n_valid_cust, 1), n_ord)
    orders = pd.DataFrame({
        "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int32),
        "o_custkey": (3 * (ci // 2) + 1 + ci % 2).astype(np.int32),
        "o_orderdate": o_orderdate,
        "o_orderpriority": pd.Categorical.from_codes(
            rng.integers(0, len(PRIORITIES), n_ord), PRIORITIES),
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_totalprice": np.round(rng.uniform(900.0, 500_000.0, n_ord), 2)
        .astype(np.float32),
        "o_comment": pd.Categorical.from_codes(
            _comment_codes(rng, n_ord, ("special", "requests")),
            COMMENT_POOL),
    })

    # lineitem: 1–7 lines per order (spec 4.2.3), about 6M·SF rows
    lines_per = rng.integers(1, 8, n_ord)
    n_li = int(lines_per.sum())
    l_orderkey = np.repeat(orders["o_orderkey"].to_numpy(), lines_per)
    l_odate = np.repeat(o_orderdate, lines_per)
    l_partkey = rng.integers(1, n_part + 1, n_li).astype(np.int32)
    l_suppkey = part_supp_key(
        l_partkey, rng.integers(0, SUPPLIERS_PER_PART, n_li),
        n_supp).astype(np.int32)
    # ship / commit / receipt hang off the order date (+1..121, +30..90,
    # then +1..30 after shipping)
    l_shipdate = l_odate + rng.integers(1, 122, n_li).astype(np.int32)
    l_commitdate = l_odate + rng.integers(30, 91, n_li).astype(np.int32)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li).astype(np.int32)
    lineitem = pd.DataFrame({
        "l_orderkey": l_orderkey,
        "l_partkey": l_partkey,
        "l_suppkey": l_suppkey,
        "l_quantity": rng.integers(1, 51, n_li).astype(np.float32),
        "l_extendedprice": np.round(rng.uniform(900.0, 105_000.0, n_li), 2)
        .astype(np.float32),
        "l_discount": np.round(rng.integers(0, 11, n_li) * 0.01, 2)
        .astype(np.float32),
        "l_tax": np.round(rng.integers(0, 9, n_li) * 0.01, 2)
        .astype(np.float32),
        "l_returnflag": pd.Categorical.from_codes(
            rng.integers(0, len(RETURN_FLAGS), n_li), RETURN_FLAGS),
        "l_linestatus": pd.Categorical.from_codes(
            (l_shipdate > date_to_days("1995-06-17")).astype(np.int8),
            LINE_STATUS),
        "l_shipdate": l_shipdate,
        "l_commitdate": l_commitdate,
        "l_receiptdate": l_receiptdate,
        "l_shipmode": pd.Categorical.from_codes(
            rng.integers(0, len(SHIP_MODES), n_li), SHIP_MODES),
    })

    # spec 4.2.3: o_orderstatus is F if every line is F, O if every line
    # is O, else P (a reduceat over each order's run of lines)
    is_o = (l_shipdate > date_to_days("1995-06-17")).astype(np.int64)
    starts = np.cumsum(lines_per) - lines_per
    n_o = np.add.reduceat(is_o, starts)
    status = np.where(n_o == 0, 0, np.where(n_o == lines_per, 1, 2))
    orders["o_orderstatus"] = pd.Categorical.from_codes(
        status.astype(np.int8), ["F", "O", "P"])

    supplier = pd.DataFrame({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2)
        .astype(np.float32),
        "s_comment": pd.Categorical.from_codes(
            _comment_codes(rng, n_supp, ("Customer", "Complaints")),
            COMMENT_POOL),
    })

    # part: names are two colour words (Q9's '%green%'), types the spec's
    # three-syllable cross product (Q14's 'PROMO%', Q16, Q19)
    w1 = rng.integers(0, len(P_NAME_WORDS), n_part)
    w2 = rng.integers(0, len(P_NAME_WORDS), n_part)
    name_pool = sorted({f"{P_NAME_WORDS[a]} {P_NAME_WORDS[b]}"
                        for a in range(len(P_NAME_WORDS))
                        for b in range(len(P_NAME_WORDS))})
    name_code = {s: i for i, s in enumerate(name_pool)}
    # word pair → code through a [W, W] table (no string per part)
    lut = np.empty((len(P_NAME_WORDS), len(P_NAME_WORDS)), np.int32)
    for a, wa in enumerate(P_NAME_WORDS):
        for b, wb in enumerate(P_NAME_WORDS):
            lut[a, b] = name_code[f"{wa} {wb}"]
    types = [f"{a} {b} {c}" for a in P_TYPE_S1 for b in P_TYPE_S2
             for c in P_TYPE_S3]
    containers = [f"{a} {b}" for a in P_CONTAINER_1 for b in P_CONTAINER_2]
    brands = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
    # spec 4.2.2: p_brand = Brand#MN, M the manufacturer's digit
    brand_codes = rng.integers(0, len(brands), n_part)
    part = pd.DataFrame({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
        "p_name": pd.Categorical.from_codes(lut[w1, w2], name_pool),
        "p_mfgr": pd.Categorical.from_codes(
            (brand_codes // 5).astype(np.int8),
            [f"Manufacturer#{m}" for m in range(1, 6)]),
        "p_type": pd.Categorical.from_codes(
            rng.integers(0, len(types), n_part), types),
        "p_brand": pd.Categorical.from_codes(brand_codes, brands),
        "p_container": pd.Categorical.from_codes(
            rng.integers(0, len(containers), n_part), containers),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_retailprice": np.round(rng.uniform(900.0, 2000.0, n_part), 2)
        .astype(np.float32),
    })

    # partsupp: exactly the 4 suppliers the lineitem formula can draw
    ps_partkey = np.repeat(part["p_partkey"].to_numpy(),
                           SUPPLIERS_PER_PART)
    ps_i = np.tile(np.arange(SUPPLIERS_PER_PART), n_part)
    partsupp = pd.DataFrame({
        "ps_partkey": ps_partkey,
        "ps_suppkey": part_supp_key(ps_partkey, ps_i, n_supp)
        .astype(np.int32),
        "ps_supplycost": np.round(
            rng.uniform(1.0, 1000.0, n_part * SUPPLIERS_PER_PART), 2)
        .astype(np.float32),
        "ps_availqty": rng.integers(1, 10_000,
                                    n_part * SUPPLIERS_PER_PART)
        .astype(np.int32),
    })

    nation = pd.DataFrame({
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": pd.Categorical([n for n, _ in NATIONS]),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
    })

    region = pd.DataFrame({
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": pd.Categorical(REGIONS),
    })

    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "supplier": supplier, "nation": nation, "region": region,
            "part": part, "partsupp": partsupp}
