"""TPC-H constants and date helpers (numpy, no pandas).

The port's copy of what the queries and the generator need from
``cylon_tpu/tpch/datagen.py``: the value pools, the date window, the
calendar-year bounds, the date conversions and the supplier-of-part
formula.  Cardinalities follow the TPC-H 2.x spec (lineitem ≈ 6M·SF via
1–7 lines per order, orders = 1.5M·SF, customer = 150k·SF, part =
200k·SF, partsupp = 4 suppliers per part, supplier = 10k·SF, 25 nations
over 5 regions), typed for the device: DATE → int32 days since
1992-01-01, money and quantity → float32, low-cardinality strings →
dictionary codes.  The JAX package's pandas generator (``generate``) is
not ported: the port generates with ``datagen_device``.
"""
from __future__ import annotations

import numpy as np

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
