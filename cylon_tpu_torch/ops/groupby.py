"""Groupby-aggregate: one sort → segment reductions over the sorted runs.

Mirror of ``cylon_tpu/ops/groupby.py`` (the reference has no groupby;
BASELINE.json config 3 asks for a distributed sum/mean/count groupby with
hash repartition).  The distributed variant (parallel/dist_ops.py)
shuffles on the key hash first, or pre-aggregates per shard and combines,
then runs this kernel per shard.

Kernel shape (all O(n) after ONE sort):

  sort      ``group_structure``: a lexsort of (padding flag, then per key
            its is-null flag and its values) with the row index as the
            last key; value columns ride along (``carry``) and come back
            in sorted order.
  bounds    group starts by adjacent compare, compacted into the output
            capacity; a group ends where the next one starts.
  sums      integer sums and counts: an int64 cumsum per column and an
            end − start difference (exact).  Float sums:
            a SEGMENTED scan that restarts at every group start, read at
            the group's end, so the rounding scales with the group's own
            magnitude (never a difference of global prefix sums).  Every
            float sum accumulates in float64; a float column's sum is
            cast back to its own dtype, as ``compute._agg_output_type``
            declares.
  min/max   the same segmented scan with ``torch.minimum`` /
            ``torch.maximum`` (NaN propagates, as ``jnp.minimum``), on
            values masked with the dtype's extreme.

Every reduction here is deterministic: no float scatter-add (CUDA's
``index_add_`` on floats uses atomics, whose rounding order varies from
run to run).  The dense path (``dense_group_structure`` /
``dense_groupby_aggregate``) computes counts and integer sums by exact
int64 ``index_add_``, and its float sums and min/max by the segmented
scan over the rows stably sorted by slot.

**Translation notes.**  ``lax.sort`` with carried operands becomes
``join.lexsort`` plus one gather per carried column
(``join.sorted_key_structure``).  The blocked scan's "before the first
reset" test (``lax.cummax`` over int8 flags) becomes ``cumsum == 0``.
Unsigned and bool value columns take min/max through an order-preserving
signed view (torch implements few operators on uint16/32/64).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..dtypes import extreme_value
from .compact import compact_indices
from .join import _ordered, sorted_key_structure

SUM, COUNT, MEAN, MIN, MAX = "sum", "count", "mean", "min", "max"
AGG_OPS = (SUM, COUNT, MEAN, MIN, MAX)

_IDT = torch.int64    # count and integer-sum accumulator
_FDT = torch.float64  # float-sum accumulator
_I64_MIN = torch.iinfo(torch.int64).min


def group_structure(key_cols, key_validities, row_valid, carry=()):
    """One sort → ``(idxS, is_first, rvS, carried)``: the original row per
    sorted position, the group-start flags, the sorted row validity, and
    the ``carry`` arrays in sorted order.

    The sort operands are ``~row_valid`` (padding sorts last), then per key
    its ``~validity`` and its values.  The values under a null key are
    NOT zeroed (unlike the join's keying): ingest stores 0 there."""
    n = key_cols[0].shape[0]
    ops = []
    if row_valid is not None:
        ops.append(~row_valid)
    for c, v in zip(key_cols, key_validities):
        if v is not None:
            ops.append(~v)
        ops.append(_ordered(c))
    sortedK, idxS, is_first, carried = sorted_key_structure(ops, n, carry)
    rvS = (~sortedK[0] if row_valid is not None
           else torch.ones(n, dtype=torch.bool, device=idxS.device))
    return idxS, is_first, rvS, carried


def num_groups_of(structure) -> torch.Tensor:
    _, is_first, rvS = structure[:3]
    return torch.sum(is_first & rvS).to(torch.int32)


def carry_pack(value_cols, value_validities):
    """Value leaves as ``group_structure``'s carry tuple in the FIXED
    layout ``(data columns…, validity masks of the nullable ones…)``.
    Callers pass each distinct column once."""
    return (tuple(value_cols)
            + tuple(v for v in value_validities if v is not None))


def carry_unpack(carried, value_validities):
    """Positional inverse of ``carry_pack`` given which entries have a
    validity mask."""
    k = len(value_validities)
    cols_s = tuple(carried[:k])
    it = iter(carried[k:])
    valids_s = tuple(next(it) if v is not None else None
                     for v in value_validities)
    return cols_s, valids_s


# ---------------------------------------------------------------------------
# segmented scans
# ---------------------------------------------------------------------------

_SEG_BLOCK = 128  # within-block scan width (log2 = 7 shift passes)


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _shifted(x: torch.Tensor, d: int, dim: int, fill) -> torch.Tensor:
    """``x`` moved ``d`` places forward along ``dim``, ``fill`` shifted in."""
    shape = list(x.shape)
    shape[dim] = d
    head = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x.narrow(dim, 0, x.shape[dim] - d)], dim)


def _seg_scan_flat(vals: torch.Tensor, is_first: torch.Tensor, op):
    """Hillis-Steele segmented inclusive scan along axis 0: log2(n)
    shift passes of ``vals[i] = vals[i] if a group starts within the
    window else op(vals[i], vals[i - d])``."""
    n = vals.shape[0]
    if n == 0:
        return vals
    flags = is_first.clone()
    flags[0] = True  # the zero-filled lanes below are never read
    d = 1
    while d < n:
        sv = _shifted(vals, d, 0, 0)
        sf = _shifted(flags, d, 0, True)
        vals = torch.where(_lanes(flags, vals), vals, op(vals, sv))
        flags = flags | sf
        d *= 2
    return vals


def _seg_scan(vals: torch.Tensor, is_first: torch.Tensor, op):
    """Blocked segmented inclusive scan (the JAX package's ``_seg_scan``):
    a within-block scan of [B, 128] blocks with forced resets at block
    starts, then a flat segmented scan over the B block tails whose
    carries are applied to the positions whose group started before their
    block.  Accumulation stays per group."""
    n = vals.shape[0]
    M = _SEG_BLOCK
    if n <= 2 * M:
        return _seg_scan_flat(vals, is_first, op)
    dev = vals.device
    B = -(-n // M)
    pad = B * M - n
    rest = tuple(vals.shape[1:])
    if pad:
        # padding rows form their own groups of one; sliced away below
        vals = torch.cat([vals, torch.zeros((pad,) + rest, dtype=vals.dtype,
                                            device=dev)])
        is_first = torch.cat([is_first, torch.ones(pad, dtype=torch.bool,
                                                   device=dev)])
    W = vals.reshape((B, M) + rest)
    F0 = is_first.reshape(B, M)
    G = F0.clone()
    G[:, 0] = True                      # forced block resets
    d = 1
    while d < M:
        sv = _shifted(W, d, 1, 0)
        sf = _shifted(G, d, 1, True)
        W = torch.where(_lanes(G, W), W, op(W, sv))
        G = G | sf
        d *= 2
    # cross-block carries: a flat segmented scan over the block tails
    y = _seg_scan_flat(W[:, -1], F0.any(1), op)
    carry = _shifted(y, 1, 0, 0)        # carry INTO block b
    before_reset = torch.cumsum(F0, 1) == 0
    cond = before_reset & (torch.arange(B, device=dev) > 0)[:, None]
    W = torch.where(_lanes(cond, W), op(W, carry[:, None]), W)
    return W.reshape((B * M,) + rest)[:n]


def _from_ordered(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``join._ordered``."""
    if dtype == torch.uint64:
        return (y ^ _I64_MIN).view(torch.uint64)
    return y if y.dtype == dtype else y.to(dtype)


def _masked_extreme(col: torch.Tensor, vmask: torch.Tensor, agg: str):
    """``(masked, sentinel)``: ``col`` in its order-preserving view with
    masked rows set to the extreme that cannot win ``agg`` (the dtype's
    own extreme), and that extreme as a 0-d tensor of the same view."""
    sentinel = _ordered(torch.tensor(
        extreme_value(col.dtype, largest=(agg == MIN)), dtype=col.dtype,
        device=col.device))
    return torch.where(vmask, _ordered(col), sentinel), sentinel


def _combiner(agg: str):
    return torch.minimum if agg == MIN else torch.maximum


# ---------------------------------------------------------------------------
# sort path
# ---------------------------------------------------------------------------

def groupby_aggregate(key_cols: Sequence[torch.Tensor],
                      key_validities: Sequence[Optional[torch.Tensor]],
                      value_cols: Sequence[torch.Tensor],
                      value_validities: Sequence[Optional[torch.Tensor]],
                      aggs: Tuple[str, ...],
                      row_valid: Optional[torch.Tensor] = None,
                      structure=None, out_capacity: Optional[int] = None,
                      sorted_values=None):
    """Aggregate ``value_cols[i]`` with ``aggs[i]`` per distinct key row.

    ``structure`` (from ``group_structure``), ``sorted_values`` and
    ``out_capacity`` serve the two-phase distributed path: the value
    columns and validities already in sorted order (they rode the
    structure's sort), and outputs of ``out_capacity`` (a bucket of the
    group count, ≥ it) rows instead of n.  ``row_valid`` marks real rows
    of padded blocks (None = all real).

    Returns ``(key_row_indices[C] int32 padded −1, agg arrays, agg
    validities, count)`` with ``C = out_capacity or n``; entries past the
    group count are unspecified.  Nulls are skipped; a group with no valid
    value gives null min/max/mean and 0 sum/count.
    """
    n = key_cols[0].shape[0]
    for agg in aggs:
        if agg not in AGG_OPS:
            raise ValueError(f"unknown aggregation {agg!r}")
    if structure is None:
        # dedupe value leaves by identity, ride the distinct ones through
        # the sort, re-expand per aggregation
        uniq, pos = [], {}
        for a in carry_pack(value_cols, value_validities):
            if id(a) not in pos:
                pos[id(a)] = len(uniq)
                uniq.append(a)
        structure = group_structure(key_cols, key_validities, row_valid,
                                    carry=tuple(uniq))
        carried = structure[3]
        sorted_values = (
            tuple(carried[pos[id(a)]] for a in value_cols),
            tuple(carried[pos[id(v)]] if v is not None else None
                  for v in value_validities))
    idxS, is_first, rvS = structure[:3]
    cols_s, valids_s = sorted_values
    dev = idxS.device
    C = n if out_capacity is None else out_capacity
    keep_first = is_first & rvS  # padding groups start with an invalid row
    num_groups = torch.sum(keep_first).to(torch.int32)
    starts = compact_indices(keep_first, C, fill=-1)      # per group
    safe_starts = torch.clamp(starts, 0, n - 1).long()
    key_idx = torch.where(starts >= 0, idxS[safe_starts], -1).to(torch.int32)
    # group g ends where group g+1 starts; the last real group ends at the
    # last valid row (valid rows sort first)
    nvalid = torch.sum(rvS)
    nxt = torch.cat([starts[1:], torch.full((1,), -1, dtype=starts.dtype,
                                            device=dev)])
    ends = torch.where(nxt >= 0, nxt.long() - 1,
                       torch.clamp(nvalid - 1, min=0)).long()

    # plans: int columns (counts, integer sums), the float pack (float
    # sums), min/max entries; ``assembly`` records where each result lives
    fplan, iplan, mplan, assembly = [], [], [], []
    for slot, (col, validity, agg) in enumerate(zip(cols_s, valids_s, aggs)):
        vmask = rvS if validity is None else (rvS & validity)
        cnt_ref = f_ref = i_ref = None
        if agg in (COUNT, MEAN, MIN, MAX):
            cnt_ref = len(iplan)
            iplan.append(vmask.to(_IDT))
        if agg in (SUM, MEAN):
            z = torch.where(vmask, col, torch.zeros((), dtype=col.dtype,
                                                    device=dev))
            if col.dtype.is_floating_point:
                f_ref = len(fplan)
                fplan.append(z.to(_FDT))
            else:
                i_ref = len(iplan)
                iplan.append(z.to(_IDT))
        if agg in (MIN, MAX):
            mplan.append((slot, agg, col.dtype,
                          _masked_extreme(col, vmask, agg)[0], cnt_ref))
        assembly.append((slot, agg, f_ref, i_ref, cnt_ref, col.dtype))

    # one 1-D cumsum per int column: torch's CUDA scan of a 2-D pack runs
    # a column (outer axis) or a row (inner axis) per thread block, far
    # slower than the device-wide scan of a 1-D tensor
    isums = []
    for c in iplan:
        cum = torch.cumsum(c, 0)
        isums.append(cum[ends] - cum[safe_starts] + c[safe_starts])
    fsums = None
    if fplan:
        fsums = _seg_scan(torch.stack(fplan, dim=1), is_first, torch.add)[ends]

    outs: list = [None] * len(aggs)
    out_valids: list = [None] * len(aggs)
    for slot, agg, f_ref, i_ref, cnt_ref, col_dt in assembly:
        if agg in (MIN, MAX):
            continue
        cnt = isums[cnt_ref] if cnt_ref is not None else None
        if agg == COUNT:
            outs[slot] = cnt
            continue
        s = fsums[:, f_ref] if f_ref is not None else isums[i_ref]
        if agg == SUM:
            outs[slot] = s.to(col_dt) if col_dt.is_floating_point else s
        else:  # MEAN
            outs[slot] = s.to(_FDT) / torch.clamp(cnt, min=1).to(_FDT)
            out_valids[slot] = cnt > 0

    # min/max columns pack per (op, dtype): k same-op aggregations share
    # one segmented scan
    groups: dict = {}
    for slot, agg, col_dt, masked, cnt_ref in mplan:
        groups.setdefault((agg, col_dt), []).append((slot, masked, cnt_ref))
    for (agg, col_dt), entries in groups.items():
        pk = torch.stack([m for _, m, _ in entries], dim=1)
        res = _seg_scan(pk, is_first, _combiner(agg))[ends]
        for j, (slot, _, cnt_ref) in enumerate(entries):
            outs[slot] = _from_ordered(res[:, j], col_dt)
            out_valids[slot] = isums[cnt_ref] > 0

    return key_idx, tuple(outs), tuple(out_valids), num_groups


# ---------------------------------------------------------------------------
# dense path (one integer key with a known range)
# ---------------------------------------------------------------------------

def dense_group_structure(key: torch.Tensor, key_validity, row_valid,
                          lo: int, hi: int, stride: int = 1):
    """Direct-address grouping for one integer key known to lie in
    [lo, hi] — no sort.  A row's slot is ``(key − lo) // stride``.

    Slots: [0, R) real groups, R = the null-key rows (one group), R+1 =
    dropped (padding, filtered or out-of-range rows).  Returns ``(slot[n]
    int64, counts[R+1] int32, ngroups, overflow)``; ``overflow`` counts
    valid rows whose key lies outside [lo, hi], a contract violation the
    caller reports.  ``stride > 1``: rows were routed by
    ``(key − lo) % stride``, so each shard sees one residue class and its
    slot space shrinks to ceil(R / stride).

    Slots are computed in int64: an int64 key past 2^31 does not wrap,
    and in-range keys give the same slot as the JAX package's int32
    arithmetic.
    """
    R = -(-(hi - lo + 1) // stride)
    n = key.shape[0]
    dev = key.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if row_valid is None
             else row_valid)
    k = key.to(torch.int64)
    if key_validity is not None:
        nonnull = valid & key_validity
        null_rows = valid & ~key_validity
    else:
        nonnull, null_rows = valid, None
    in_range = (k >= lo) & (k <= hi)
    overflow = torch.sum(nonnull & ~in_range).to(torch.int32)
    base = k - lo
    slot = torch.where(nonnull & in_range,
                       base // stride if stride > 1 else base, R + 1)
    if null_rows is not None:
        slot = torch.where(null_rows, R, slot)
    counts = torch.bincount(slot, minlength=R + 2)[:R + 1].to(torch.int32)
    ngroups = torch.sum(counts > 0).to(torch.int32)
    return slot, counts, ngroups, overflow


def _slot_runs(slot: torch.Tensor):
    """Rows stably sorted by slot: ``(perm, run start flags, run end
    positions mask, slot of each sorted row)`` for the deterministic
    per-slot float and min/max reductions."""
    perm = torch.sort(slot.to(torch.int32), stable=True).indices
    s = slot[perm]
    one = torch.ones(1, dtype=torch.bool, device=slot.device)
    first = torch.cat([one, s[1:] != s[:-1]])
    last = torch.cat([s[1:] != s[:-1], one])
    return perm, first, last, s


def dense_groupby_aggregate(slot: torch.Tensor, counts: torch.Tensor,
                            value_cols, value_validities,
                            aggs: Tuple[str, ...], out_capacity: int,
                            lo: int, key_dtype: torch.dtype,
                            has_null_slot: bool, stride: int = 1, phase=0,
                            emit_empty: bool = False, hi: int = None):
    """Phase 2 of the dense path: per-slot reductions over the [R+1] slot
    space, then the non-empty slots compacted into ``out_capacity``.

    The group key is rebuilt from the slot (``lo + slot·stride + phase``;
    ``phase`` is this shard's residue class under the modulo routing, 0
    on one shard).  Returns ``(key_data[C], key_validity[C] or None, agg
    arrays, agg validities, ngroups)`` like the sort path.

    ``emit_empty=True`` emits EVERY in-range key, those with no rows
    included (count 0, sum 0, null min/max/mean); the null-key group still
    appears only when null keys exist.
    """
    R1 = counts.shape[0]
    nreal = R1 - 1          # slots [0, nreal) = real keys; nreal = nulls
    dev = slot.device
    if emit_empty:
        idx = torch.arange(out_capacity, dtype=torch.int64, device=dev)
        null_present = ((counts[nreal] > 0) if has_null_slot
                        else torch.zeros((), dtype=torch.bool, device=dev))
        key_of = lo + idx * stride + phase
        top = hi if hi is not None else lo + nreal * stride - 1
        real = (idx < nreal) & (key_of <= top)
        # ``real`` is a prefix of idx; on a shard one key short it ends at
        # m = nreal − 1, and the null group sits at m, the first free row
        m = torch.sum(real)
        starts = torch.where(real, idx,
                             torch.where((idx == m) & null_present, nreal, -1))
        ngroups = (m + null_present.to(torch.int64)).to(torch.int32)
    else:
        present = counts > 0
        starts = compact_indices(present, out_capacity, fill=-1).long()
        ngroups = torch.sum(present).to(torch.int32)
    safe = torch.clamp(starts, 0, R1 - 1)
    key_data = (lo + safe * stride + phase).to(key_dtype)
    key_valid = ((starts >= 0) & (safe != R1 - 1)) if has_null_slot else None

    def scatter_add(vals: torch.Tensor) -> torch.Tensor:
        # exact for int64; slot R+1 (dropped rows) lands in the extra bin
        out = torch.zeros(R1 + 1, dtype=vals.dtype, device=dev)
        return out.index_add_(0, slot, vals)[:R1]

    runs = None

    def run_reduce(vals: torch.Tensor, op, fill: torch.Tensor
                   ) -> torch.Tensor:
        # per-slot reduction over the rows sorted by slot (deterministic);
        # ``fill`` (0-d) stands in every slot without rows
        nonlocal runs
        if runs is None:
            runs = _slot_runs(slot)
        perm, first, last, s = runs
        scanned = _seg_scan(vals[perm], first, op)
        out = fill.reshape(1).repeat(R1 + 1)
        out[s[last]] = scanned[last]
        return out[:R1]

    outs, out_valids = [], []
    cnt_cache: dict = {}

    def slot_count(validity, vmask):
        if id(validity) not in cnt_cache:
            cnt_cache[id(validity)] = scatter_add(vmask.to(_IDT))[safe]
        return cnt_cache[id(validity)]

    for col, validity, agg in zip(value_cols, value_validities, aggs):
        vmask = (torch.ones(col.shape[0], dtype=torch.bool, device=dev)
                 if validity is None else validity)
        cnt = slot_count(validity, vmask) if agg != SUM else None
        if agg == COUNT:
            outs.append(cnt)
            out_valids.append(None)
            continue
        if agg in (SUM, MEAN):
            z = torch.where(vmask, col, torch.zeros((), dtype=col.dtype,
                                                    device=dev))
            if col.dtype.is_floating_point:
                tot = run_reduce(z.to(_FDT), torch.add,
                                 torch.zeros((), dtype=_FDT, device=dev))[safe]
            else:
                tot = scatter_add(z.to(_IDT))[safe]
            if agg == SUM:
                outs.append(tot.to(col.dtype) if col.dtype.is_floating_point
                            else tot)
                out_valids.append(None)
            else:
                outs.append(tot.to(_FDT) / torch.clamp(cnt, min=1).to(_FDT))
                out_valids.append(cnt > 0)
            continue
        masked, sentinel = _masked_extreme(col, vmask, agg)
        res = run_reduce(masked, _combiner(agg), sentinel)[safe]
        outs.append(_from_ordered(res, col.dtype))
        out_valids.append(cnt > 0)
    return key_data, key_valid, tuple(outs), tuple(out_valids), ngroups
