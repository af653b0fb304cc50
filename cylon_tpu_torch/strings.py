"""Hash64 string keys: high-cardinality strings on the device data plane.

Mirror of ``cylon_tpu/strings.py``.

The default string strategy dictionary-encodes at ingest (table.py): the
device holds sorted-dictionary codes, and cross-table string ops re-encode
onto a merged dictionary (``dist_ops._unify_dtable_dicts``).  That is the
right call for TPC-H-style enums, but a HIGH-cardinality key (user ids,
URLs, dbgen's real comments) makes the dictionary row-count-sized: ingest
pays a host ``np.unique`` over every row and every string-keyed join pays
a host-side dictionary merge — O(n log n) host work on the hot path.

This module implements the alternative: **hash the string to 64 bits at
ingest, run the data plane on the hash, keep the payload on the host**.

  * ``encode_frame`` replaces each chosen string column with two int32
    device-side lanes ``{col}#h0`` / ``{col}#h1`` (murmur3_32 under two
    independent seeds — the composite (h0, h1) IS the 64-bit key) and
    records the payload in a ``StringStore``;
  * joins / shuffles / groupbys then use the lane pair as an ordinary
    composite int key — no dictionary exists, so nothing is unified,
    merged or uniqued anywhere on the path;
  * ``StringStore.resolve_frame`` maps lane pairs in an exported result
    back to the original strings (hash → payload lookup built at ingest).

**Collision policy** (documented contract): two distinct strings sharing
both 32-bit lanes are treated as EQUAL by the data plane.  Within each
ingested column this is *detected* at encode time (the store observes
every (hash, value) pair and raises on a conflict); across tables it is
probabilistic: P(any collision) ≈ n²/2⁶⁵ over n distinct keys — ~5·10⁻⁸
at one million keys, ~5·10⁻⁴ at one hundred million.  Above ~10⁸ distinct
keys prefer the dictionary path or add an application-level verify.
Equality is exact on match because resolution goes through the ingested
payload, never by inverting the hash.

reference: the capability this replaces is the C++ side's raw
variable-length buffer movement — binary split kernels
(arrow/arrow_kernels.cpp), binary gathers (util/copy_arrray.cpp:121-267)
and the byte-buffer streaming of arrow_all_to_all.cpp:80-130; here the
fixed-width hash lanes ride the exact same kernels as every int column
(the partition-hash kernel hashes the two lanes of a key as two int32
key columns).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from .native import runtime as _native
from .status import Code, CylonError, Status

H0, H1 = "#h0", "#h1"


def hash_lanes(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Object array of str/bytes/None → two int32 lane arrays (the device
    representation; int32 reinterpretation of the uint32 hashes)."""
    h0, h1 = _native.hash64_strings(np.asarray(values, dtype=object))
    return h0.view(np.int32), h1.view(np.int32)


def _u64_keys(h0: np.ndarray, h1: np.ndarray) -> np.ndarray:
    u0 = np.asarray(h0).view(np.uint32).astype(np.uint64)
    u1 = np.asarray(h1).view(np.uint32).astype(np.uint64)
    return (u0 << np.uint64(32)) | u1


def _lane_np(series) -> Tuple[np.ndarray, np.ndarray]:
    """A pandas lane column → (int32 lane array, null mask).

    Lanes round-trip through several dtypes: plain int32 (no nulls at
    encode), nullable Int32 (``None`` keys), or float64-with-NaN (an
    exported arrow int32-with-nulls column).  Nulls decode as lane 0 +
    mask — the caller substitutes ``None`` after payload lookup."""
    import pandas as pd
    nulls = np.asarray(pd.isna(series), bool)
    filled = series.fillna(0) if nulls.any() else series
    # float64 holds every int32 exactly, so the astype chain is lossless
    lanes = np.asarray(filled.to_numpy(), dtype=np.int64).astype(np.int32)
    return lanes, nulls


class StringStore:
    """Host-side payloads for hash64-encoded columns.

    One store instance accompanies a pipeline: ``encode_frame`` fills it
    at ingest; ``resolve_frame`` decodes exported results.  Per column the
    store keeps a SORTED unique 64-bit-hash array + aligned value array —
    registration and resolution are pure vectorized numpy (sort, unique,
    searchsorted); no per-row interpreter work rides the ingest path this
    module exists to keep off the host.  Registering two different
    strings under one hash raises (the within-column collision detection
    the policy above promises)."""

    def __init__(self):
        # column -> (sorted uint64 hash keys, object values, same length)
        self._maps: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def register(self, column: str, values: np.ndarray,
                 h0: np.ndarray, h1: np.ndarray) -> None:
        values = np.asarray(values, dtype=object)
        keys = _u64_keys(h0, h1)
        nonnull = np.asarray(values != None, bool)  # noqa: E711
        keys, values = keys[nonnull], values[nonnull]
        if len(keys) == 0:
            self._maps.setdefault(
                column, (np.empty(0, np.uint64), np.empty(0, object)))
            return
        uk, first, inv = np.unique(keys, return_index=True,
                                   return_inverse=True)
        uv = values[first]
        # intra-batch conflict: any row whose key maps to a different
        # representative value (vectorized object compare)
        rep = uv[inv.reshape(-1)]
        bad = np.nonzero(rep != values)[0]
        if len(bad):
            i = int(bad[0])
            raise CylonError(Status(Code.Invalid,
                f"hash64 collision in column {column!r}: "
                f"{rep[i]!r} and {values[i]!r} share a 64-bit hash — use "
                "the dictionary encoding for this column"))
        old = self._maps.get(column)
        if old is not None and len(old[0]):
            ok, ov = old[0], old[1]
            pos = np.searchsorted(ok, uk)
            pos_c = np.minimum(pos, len(ok) - 1)
            hit = ok[pos_c] == uk
            bad = np.nonzero(hit & (ov[pos_c] != uv))[0]
            if len(bad):
                i = int(bad[0])
                raise CylonError(Status(Code.Invalid,
                    f"hash64 collision in column {column!r}: "
                    f"{ov[pos_c][i]!r} and {uv[i]!r} share a 64-bit hash "
                    "— use the dictionary encoding for this column"))
            mk = np.concatenate([ok, uk[~hit]])
            mv = np.concatenate([ov, uv[~hit]])
            order = np.argsort(mk)
            self._maps[column] = (mk[order], mv[order])
        else:
            self._maps[column] = (uk, uv)

    def resolve(self, column: str, h0: np.ndarray, h1: np.ndarray
                ) -> np.ndarray:
        """Lane pair arrays → object array of strings (None where the
        pair is unknown, e.g. null-filled LEFT-join misses)."""
        m = self._maps.get(column)
        if m is None:
            raise CylonError(Status(Code.KeyError,
                f"no hash64 payload registered for column {column!r}"))
        mk, mv = m
        keys = _u64_keys(h0, h1)
        if len(mk) == 0:
            return np.full(len(keys), None, dtype=object)
        pos = np.minimum(np.searchsorted(mk, keys), len(mk) - 1)
        hit = mk[pos] == keys
        out = np.full(len(keys), None, dtype=object)
        out[hit] = mv[pos[hit]]
        return out

    def resolve_frame(self, df, columns: Optional[Iterable[str]] = None):
        """Pandas frame with ``{col}#h0/#h1`` lane pairs → same frame with
        the pairs replaced by the decoded string column.  ``lt-``/``rt-``
        join prefixes on the lane names are understood.  Null lanes (the
        nullable encoding of ``None`` keys, or null-filled LEFT-join
        misses) decode to ``None``."""
        import pandas as pd
        out = df.copy()
        want = set(columns) if columns is not None else None
        for name in list(out.columns):
            if not name.endswith(H0):
                continue
            base = name[:-len(H0)]
            other = base + H1
            if other not in out.columns:
                continue
            store_key = base
            while store_key[:3] in ("lt-", "rt-"):
                store_key = store_key[3:]
            if want is not None and store_key not in want:
                continue
            if store_key not in self._maps:
                continue
            h0, null0 = _lane_np(out[name])
            h1, null1 = _lane_np(out[other])
            vals = self.resolve(store_key, h0, h1)
            nulls = null0 | null1
            if nulls.any():
                vals = vals.copy()
                vals[nulls] = None
                # an object Series keeps None: a plain array assignment
                # lets pandas (3.x) infer its string dtype, whose missing
                # value is NaN
                vals = pd.Series(vals, index=out.index, dtype=object)
            out[base] = vals
            out = out.drop(columns=[name, other])
        return out


def encode_frame(df, columns: Optional[Iterable[str]] = None,
                 store: Optional[StringStore] = None):
    """Pandas frame → (frame with string columns replaced by int32 lane
    pairs, StringStore holding their payloads).

    ``columns`` defaults to every object/string-dtype column.  The result
    ingests through the ordinary numeric path (``DTable.from_pandas``) —
    no dictionary is built, so ingest cost is one murmur3 pass instead of
    a full-column ``np.unique`` sort.

    ``None`` entries emit NULLABLE lane columns (pandas Int32 with a
    mask), so DTable ingest marks those rows null and the data plane
    applies the engine's SQL-null key semantics — matching the
    dictionary-string path.  (Without the mask a ``None`` encoded as the
    valid lane pair (0, 0): null keys silently inner-joined/grouped with
    each other AND with any real string hashing to exactly (0, 0).)
    Columns without ``None`` keep plain int32 lanes — no validity
    ballast on the common path.
    """
    import pandas as pd
    store = store if store is not None else StringStore()
    if columns is None:
        columns = [c for c in df.columns
                   if df[c].dtype == object
                   or str(df[c].dtype) in ("string", "str")]
    else:
        columns = list(columns)  # an iterator must survive N membership tests
    out = {}
    for name in df.columns:
        if name not in columns:
            out[name] = df[name]
            continue
        vals = df[name].to_numpy(dtype=object, na_value=None)
        h0, h1 = hash_lanes(vals)
        store.register(name, vals, h0, h1)
        nulls = np.asarray(vals == None, bool)  # noqa: E711
        if nulls.any():
            out[name + H0] = pd.arrays.IntegerArray(
                np.asarray(h0, np.int32), mask=nulls.copy())
            out[name + H1] = pd.arrays.IntegerArray(
                np.asarray(h1, np.int32), mask=nulls.copy())
        else:
            out[name + H0] = h0
            out[name + H1] = h1
    return pd.DataFrame(out), store


def key_of(column: str) -> Tuple[str, str]:
    """The composite join key for a hash64-encoded column."""
    return (column + H0, column + H1)
