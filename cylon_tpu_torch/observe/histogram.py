"""Mergeable log2-bucketed histograms: the fixed-memory quantile type.

The port of ``cylon_tpu/observe/histogram.py``, bucket for bucket.  A
histogram with logarithmic buckets answers "what is p99 right now" in
O(#buckets) memory, and two histograms MERGE losslessly (bucket counts
add), which is what makes per-thread registry cells and windowed views
composable: any partition of the observations produces the same merged
histogram.

Bucket scheme: bucket ``e`` holds values ``2^(e-1) < v <= 2^e`` for
integer exponents clamped to [:data:`E_MIN`, :data:`E_MAX`];
zero/negative observations land in the E_MIN underflow bucket.  A
quantile answer is the UPPER BOUND of the bucket containing the
nearest-rank observation, so it is exact to one bucket: the true
nearest-rank value lies in the same bucket, within a factor of 2 below
the answer.  Windowed views come from :meth:`Histogram.minus` (counts
are monotone, so a window is a bucket-wise difference of two snapshots).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["Histogram", "E_MIN", "E_MAX", "bucket_exponent",
           "bucket_upper_bound"]

# Exponent clamp: 2^-30 ~ 1e-9 (any ms/bytes value below is noise) up
# to 2^60 ~ 1.15e18 (an exabyte; nothing the engine measures is
# bigger).  91 possible buckets — the O(1) in "O(1)-memory quantiles".
E_MIN = -30
E_MAX = 60


def bucket_exponent(value: float) -> int:
    """The bucket exponent ``e`` with ``2^(e-1) < value <= 2^e``
    (clamped; zero/negative/NaN collapse into the E_MIN underflow
    bucket).  Exact for exact powers of two: ``bucket_exponent(8) == 3``
    via ``math.frexp``, never a float-log rounding surprise."""
    if not value > 0.0 or value != value:
        return E_MIN
    m, ex = math.frexp(value)          # value = m * 2^ex, 0.5 <= m < 1
    e = ex - 1 if m == 0.5 else ex
    return min(max(e, E_MIN), E_MAX)


def bucket_upper_bound(e: int) -> float:
    """Inclusive upper bound of bucket ``e`` (the ``le`` label in the
    OpenMetrics exposition and the quantile answer)."""
    return float(2.0 ** e)


class Histogram:
    """One mergeable log2-bucket histogram: sparse ``{exponent: count}``
    plus exact count/sum/max side-channels (so means and true peaks
    never pay the bucket rounding)."""

    __slots__ = ("buckets", "count", "sum", "max")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def __repr__(self) -> str:
        return (f"Histogram(count={self.count}, sum={self.sum:.3f}, "
                f"max={self.max:.3f}, buckets={len(self.buckets)})")

    # -- writes -------------------------------------------------------------

    def observe(self, value: float) -> None:
        """Record one observation (O(1); no allocation past the first
        observation per bucket)."""
        v = float(value)
        e = bucket_exponent(v)
        self.buckets[e] = self.buckets.get(e, 0) + 1
        self.count += 1
        if v > 0.0 and v == v:
            self.sum += v
            if v > self.max:
                self.max = v

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (lossless: bucket counts add, sums
        add, maxes max).  Returns self for chaining."""
        for e, n in other.buckets.items():
            self.buckets[e] = self.buckets.get(e, 0) + n
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        return self

    # -- derived views ------------------------------------------------------

    def copy(self) -> "Histogram":
        return Histogram().merge(self)

    def minus(self, earlier: "Histogram") -> "Histogram":
        """The WINDOW between an earlier snapshot of this histogram and
        now (bucket-wise difference, clamped at zero so a concurrent
        reset degrades to "short window", never negative counts).  The
        sampler's per-window percentiles are quantiles of this."""
        out = Histogram()
        for e, n in self.buckets.items():
            d = n - earlier.buckets.get(e, 0)
            if d > 0:
                out.buckets[e] = d
        out.count = sum(out.buckets.values())
        out.sum = max(self.sum - earlier.sum, 0.0)
        out.max = self.max          # max is not windowable; keep peak
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile (``q`` in percent, like
        ``serve.session.percentile``): the upper bound of the bucket
        holding the rank-``ceil(q/100 * count)``-th observation — within
        one bucket (a factor of 2) of the exact nearest-rank value.
        ``None`` on an empty histogram."""
        if self.count <= 0:
            return None
        rank = math.ceil(q / 100.0 * self.count)
        rank = min(max(rank, 1), self.count)
        seen = 0
        for e in sorted(self.buckets):
            seen += self.buckets[e]
            if seen >= rank:
                # the max side-channel tightens the top bucket: the
                # largest observation IS the upper bound of everything
                return min(bucket_upper_bound(e), self.max) \
                    if self.max > 0.0 else bucket_upper_bound(e)
        return bucket_upper_bound(max(self.buckets))   # unreachable

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def cumulative(self) -> Iterator[Tuple[float, int]]:
        """``(le_upper_bound, cumulative_count)`` pairs in ascending
        bound order — the OpenMetrics ``_bucket{le=...}`` series (the
        ``+Inf`` terminal bucket is the exporter's job)."""
        seen = 0
        for e in sorted(self.buckets):
            seen += self.buckets[e]
            yield bucket_upper_bound(e), seen

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        """JSON-safe snapshot (bucket keys stringified; exponents, not
        bounds, so the round trip is exact)."""
        return {"buckets": {str(e): n
                            for e, n in sorted(self.buckets.items())},
                "count": self.count,
                "sum": round(self.sum, 6),
                "max": round(self.max, 6)}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Histogram":
        h = cls()
        for k, n in (d.get("buckets") or {}).items():
            h.buckets[int(k)] = int(n)
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.max = float(d.get("max", 0.0))
        return h
