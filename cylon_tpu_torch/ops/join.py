"""Sort-based equi-join kernels (all four join types).

Mirror of ``cylon_tpu/ops/join.py`` (reference: the dual-cursor sort-merge
join, cpp/src/cylon/join/join.cpp:26-232).  Join outputs are
data-dependent, so every kernel is two-phase:

  1. count      — the exact number of output rows (``join_count`` /
                  ``plan_total``), read by the host;
  2. indices    — (left_idx, right_idx) materialized into a ``capacity``
                  the caller chose from the count; −1 = null-fill row.

Two keyings exist, as in the JAX package: ``dense_ranks`` + ``join_count``
/ ``join_indices`` (the local ``compute.join`` path), and the fused
single-sort plan ``sort_join_plan`` / ``plan_total`` / ``plan_indices``
(the distributed path's local kernel).  Both return the same index arrays
as their JAX counterparts, element for element.

**Padded blocks.**  Distributed shards are fixed-capacity blocks whose rows
[0, count) are valid; the kernels take optional ``l_count`` / ``r_count``
(ints or 0-d tensors) and treat the rest as padding.

**Translation notes.**  ``lax.sort`` over several operands becomes
``lexsort``: chained stable sorts from the least to the most significant
key, so the row index is the final tiebreak as in JAX.  torch sorts NaN
last and ranks −0.0 equal to 0.0, as ``lax.sort`` does, and group
boundaries come from ``!=`` in both.  ``.at[].set(mode="drop")`` becomes
``compact.scatter_drop``; reverse ``cummin`` is flip → cummin → flip.
Unsigned key columns are mapped to an order-preserving signed type first:
torch implements few operators on uint16/32/64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..dtypes import extreme_value
from .compact import compact_indices, scatter_drop
from .gather import signed_view, take_many

INNER, LEFT, RIGHT, FULL_OUTER = "inner", "left", "right", "full_outer"

_I32_MAX = 2**31 - 1
_IDT = torch.int64  # counts and totals (the JAX package's idt under x64)


# ---------------------------------------------------------------------------
# translation helpers
# ---------------------------------------------------------------------------

def _count(c, device) -> Optional[torch.Tensor]:
    """Valid-row count of a padded block as a 0-d int64 tensor (or None)."""
    if c is None:
        return None
    return torch.as_tensor(c, dtype=torch.int64, device=device)


def _ordered(c: torch.Tensor) -> torch.Tensor:
    """An order- and equality-preserving key in a type torch fully supports."""
    if c.dtype == torch.bool:
        return c.to(torch.uint8)
    if c.dtype == torch.uint16:
        return c.to(torch.int32)
    if c.dtype == torch.uint32:
        return c.to(torch.int64)
    if c.dtype == torch.uint64:
        return c.view(torch.int64) ^ torch.iinfo(torch.int64).min
    return c


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of ``keys`` (most significant first) as
    int64 positions; ties keep row order (the row index is the last key)."""
    perm = None
    for k in reversed(keys):
        k = _ordered(k)
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


# ---------------------------------------------------------------------------
# shared keying
# ---------------------------------------------------------------------------

def _concat_key_parts(l_cols, l_valids, r_cols, r_valids, l_count, r_count):
    """Pad masks and sort operands shared by every keying kernel: the pad
    flag (most significant), then per key column its isnull flag (when
    nullable) followed by the values with nulls collapsed to one group."""
    n_l, n_r = l_cols[0].shape[0], r_cols[0].shape[0]
    dev = l_cols[0].device
    pad_l = (torch.zeros(n_l, dtype=torch.bool, device=dev) if l_count is None
             else torch.arange(n_l, device=dev) >= l_count)
    pad_r = (torch.zeros(n_r, dtype=torch.bool, device=dev) if r_count is None
             else torch.arange(n_r, device=dev) >= r_count)
    pad = torch.cat([pad_l, pad_r])
    key_ops = [pad]
    for lc, lv, rc, rv in zip(l_cols, l_valids, r_cols, r_valids):
        c = torch.cat([_ordered(lc), _ordered(rc)])
        if lv is not None or rv is not None:
            nl = torch.zeros(n_l, dtype=torch.bool, device=dev) if lv is None else ~lv
            nr = torch.zeros(n_r, dtype=torch.bool, device=dev) if rv is None else ~rv
            isnull = torch.cat([nl, nr])
            # all nulls are ONE group regardless of the slot value under them
            c = torch.where(isnull, torch.zeros((), dtype=c.dtype, device=dev), c)
            key_ops.append(isnull)
        key_ops.append(c)
    return pad_l, pad_r, key_ops


def sorted_key_structure(key_operands, n: int, carry=()):
    """ONE lexicographic sort of ``key_operands`` (most significant first)
    with the row index as the final key.

    Returns ``(sorted_key_operands, idxS, is_first, carried)``: the
    operands in sorted order, the original row per sorted position
    (int32), the first position of each run of equal keys (adjacent
    compare), and the ``carry`` arrays permuted into sorted order (the
    JAX package rides them through its ``lax.sort``; here they are
    gathered by the sort's permutation).
    """
    perm = lexsort(key_operands)
    sorted_ops = [k[perm] for k in key_operands]
    one = torch.ones(1, dtype=torch.bool, device=perm.device)
    is_first = torch.cat([one, torch.zeros(n - 1, dtype=torch.bool,
                                           device=perm.device)])
    for ks in sorted_ops:
        is_first = is_first | torch.cat([one, ks[1:] != ks[:-1]])
    carried = tuple(signed_view(c)[perm].view(c.dtype) for c in carry)
    return sorted_ops, perm.to(torch.int32), is_first, carried


def dense_ranks(l_cols, l_valids, r_cols, r_valids, l_count=None, r_count=None):
    """Composite join keys → dense int32 ranks comparable across both sides.

    Rows are grouped by (isnull_0, value_0, isnull_1, value_1, …): equal
    composite keys — with null == null, and null distinct from every real
    value — share a rank.  Padding rows (index ≥ count) get INT32_MAX.
    """
    n_l, n_r = l_cols[0].shape[0], r_cols[0].shape[0]
    n = n_l + n_r
    dev = l_cols[0].device
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z
    l_count, r_count = _count(l_count, dev), _count(r_count, dev)
    pad_l, pad_r, key_ops = _concat_key_parts(
        l_cols, l_valids, r_cols, r_valids, l_count, r_count)
    _, idxS, is_first, _ = sorted_key_structure(key_ops, n)
    group_id = (torch.cumsum(is_first, 0) - 1).to(torch.int32)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[idxS.long()] = group_id
    l_rank = torch.where(pad_l, _I32_MAX, rank[:n_l])
    r_rank = torch.where(pad_r, _I32_MAX, rank[n_l:])
    return l_rank, r_rank


def semi_mask(l_cols, l_valids, r_cols, r_valids, l_count=None,
              r_count=None) -> torch.Tensor:
    """Per-left-row presence bits: ``mask[i]`` ⇔ left row *i* is valid and
    its composite key occurs among the valid right rows.

    The semi/anti-join primitive (EXISTS / NOT EXISTS without
    multiplicity): one merged sort of both sides' keys, a per-segment
    right-row count by the ``_seg_span`` scans of ``sort_join_plan``, and
    one scatter back to left row space.  Key semantics are the join
    kernels' (null == null, composite keys, padded blocks)."""
    n_l, n_r = l_cols[0].shape[0], r_cols[0].shape[0]
    dev = l_cols[0].device
    if n_l == 0 or n_r == 0:
        return torch.zeros(n_l, dtype=torch.bool, device=dev)
    l_count, r_count = _count(l_count, dev), _count(r_count, dev)
    m = _merged_plan(l_cols, l_valids, r_cols, r_valids, l_count, r_count)
    return scatter_drop(n_l, torch.where(m.left_s, m.idxS, n_l),
                        m.cnt_p > 0, fill=False)


# ---------------------------------------------------------------------------
# rank kernel: join_count / join_indices
# ---------------------------------------------------------------------------

def _masked(key: torch.Tensor, count) -> torch.Tensor:
    if count is None:
        return key
    n = key.shape[0]
    return torch.where(torch.arange(n, device=key.device) < count, key,
                       extreme_value(key.dtype, largest=True))


def _match_ranges(l_key, r_key, l_count, r_count):
    """Sort both sides; per sorted-left row, the [lo, hi) run of equal keys in
    sorted right, clamped to right's valid prefix; cnt zeroed for padding."""
    l_key = _masked(l_key, l_count)
    r_key = _masked(r_key, r_count)
    ls = torch.sort(l_key, stable=True).indices
    rs = torch.sort(r_key, stable=True).indices
    lk = l_key[ls]
    rk = r_key[rs]
    lo = torch.searchsorted(rk, lk, side="left")
    hi = torch.searchsorted(rk, lk, side="right")
    if r_count is not None:
        hi = torch.minimum(hi, r_count)
    cnt = torch.clamp(hi - lo, min=0)
    if l_count is not None:
        valid_l = ls < l_count
        cnt = torch.where(valid_l, cnt, 0)
    else:
        valid_l = torch.ones(ls.shape, dtype=torch.bool, device=ls.device)
    return ls, rs, lk, rk, lo, cnt, valid_l


def _right_matched(lk, rk, l_count) -> torch.Tensor:
    """Per sorted-right position: does its key occur among valid left rows?"""
    lo = torch.searchsorted(lk, rk, side="left")
    hi = torch.searchsorted(lk, rk, side="right")
    if l_count is not None:
        hi = torch.minimum(hi, l_count)
    return hi > lo


def _valid_prefix(n: int, count, device) -> torch.Tensor:
    if count is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return torch.arange(n, device=device) < count


def join_count(l_key: torch.Tensor, r_key: torch.Tensor, how: str = INNER,
               l_count=None, r_count=None) -> torch.Tensor:
    """Phase 1: exact number of output rows for this join (0-d int64)."""
    if how == RIGHT:
        return join_count(r_key, l_key, LEFT, r_count, l_count)
    dev = l_key.device
    l_count, r_count = _count(l_count, dev), _count(r_count, dev)
    n_l, n_r = l_key.shape[0], r_key.shape[0]
    if n_l == 0 or n_r == 0:
        _, _, total = _degenerate(l_key, r_key, how, 1, l_count, r_count)
        return total.to(_IDT)
    _, _, lk, rk, _, cnt, valid_l = _match_ranges(l_key, r_key, l_count, r_count)
    total = torch.sum(cnt)
    if how == INNER:
        return total
    left_total = total + torch.sum(valid_l & (cnt == 0))
    if how == LEFT:
        return left_total
    if how == FULL_OUTER:
        valid_r = _valid_prefix(n_r, r_count, dev)
        return left_total + torch.sum(valid_r & ~_right_matched(lk, rk, l_count))
    raise ValueError(f"unknown join type {how!r}")


def expand_pairs(emit, match_cnt, capacity: int, n_l: int, left_at, right_at,
                 inner: bool = False, extras=()):
    """Shared run-length pair expansion (phase 2 core).

    Per output slot ``j`` (the ``within``-th match of its left row at
    position ``pos``): ``left_at(pos)`` / ``right_at(pos, within,
    *extras_at_pos)`` map back to original row indices.  Returns
    (j, left_idx, right_idx, total_lpart); unmatched slots carry
    right_idx −1 (the outer null-fill convention).  Emitters have strictly
    increasing starts, so one drop-scatter + prefix-max decodes slot →
    position.
    """
    dev = emit.device
    offs_incl = torch.cumsum(emit, 0)
    total_lpart = offs_incl[-1]
    starts = offs_incl - emit
    j = torch.arange(capacity, dtype=_IDT, device=dev)
    tgt = torch.where(emit > 0, starts, capacity)
    scat = scatter_drop(capacity, tgt,
                        torch.arange(n_l, dtype=torch.int32, device=dev))
    li_pos_c = _cummax(scat)
    chg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                     li_pos_c[1:] != li_pos_c[:-1]])
    run_start = _cummax(torch.where(chg, j, 0))
    within = j - run_start
    cols = [] if inner else [match_cnt.to(torch.int32)]
    cols.extend(e.to(torch.int32) for e in extras)
    g = torch.stack(cols, dim=1)[li_pos_c.long()]
    ex_base = 0 if inner else 1
    ex = tuple(g[:, ex_base + k] for k in range(len(extras)))
    left_idx = left_at(li_pos_c)
    if inner:
        right_idx = right_at(li_pos_c, within, *ex)
    else:
        matched = within < g[:, 0].to(_IDT)
        right_idx = torch.where(matched, right_at(li_pos_c, within, *ex), -1)
    return j, left_idx, right_idx, total_lpart


def append_right_tail(j, total_lpart, unmatched_r, n_r: int,
                      left_idx, right_idx, right_orig):
    """FULL_OUTER: append unmatched right rows after the left partition.

    ``unmatched_r`` is a mask in ``right_orig``'s index space.
    """
    n_um = torch.sum(unmatched_r.to(_IDT))
    um_pos = compact_indices(unmatched_r, n_r, fill=0)
    k = torch.clamp(j - total_lpart, 0, max(n_r - 1, 0))
    in_rpart = j >= total_lpart
    r_only = right_orig(um_pos[k])
    left_idx = torch.where(in_rpart, -1, left_idx)
    right_idx = torch.where(in_rpart, r_only, right_idx)
    return left_idx, right_idx, total_lpart + n_um


def mask_past_total(j, total, left_idx, right_idx):
    """Final (−1, −1) padding beyond the valid output prefix."""
    valid = j < total
    return (torch.where(valid, left_idx, -1).to(torch.int32),
            torch.where(valid, right_idx, -1).to(torch.int32),
            total.to(torch.int32))


def join_indices(l_key: torch.Tensor, r_key: torch.Tensor, how: str,
                 capacity: int, l_count=None, r_count=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 2: (left_idx[cap], right_idx[cap], count). −1 ⇒ null row.

    Rows [0, count) are valid; the rest is padding (−1, −1).
    """
    if how == RIGHT:
        ri, li, n = join_indices(r_key, l_key, LEFT, capacity, r_count, l_count)
        return li, ri, n
    dev = l_key.device
    l_count, r_count = _count(l_count, dev), _count(r_count, dev)
    n_l, n_r = l_key.shape[0], r_key.shape[0]
    if n_l == 0 or n_r == 0:
        return _degenerate(l_key, r_key, how, capacity, l_count, r_count)

    ls, rs, lk, rk, lo, cnt, valid_l = _match_ranges(l_key, r_key, l_count, r_count)
    emit = cnt if how == INNER else torch.where(valid_l, torch.clamp(cnt, min=1), 0)
    j, left_idx, right_idx, total_lpart = expand_pairs(
        emit, cnt, capacity, n_l,
        left_at=lambda pos: ls[pos.long()].to(torch.int32),
        right_at=lambda pos, within, lo_c: rs[
            torch.clamp(lo_c + within, 0, n_r - 1)].to(torch.int32),
        inner=(how == INNER), extras=(lo,))

    if how == FULL_OUTER:
        valid_r = _valid_prefix(n_r, r_count, dev)
        unmatched_r = valid_r & ~_right_matched(lk, rk, l_count)
        left_idx, right_idx, total = append_right_tail(
            j, total_lpart, unmatched_r, n_r, left_idx, right_idx,
            right_orig=lambda pos: rs[pos.long()].to(torch.int32))
    else:
        total = total_lpart if how == LEFT else torch.sum(cnt)
    return mask_past_total(j, total, left_idx, right_idx)


# ---------------------------------------------------------------------------
# fused single-sort plan (the distributed path's local kernel)
# ---------------------------------------------------------------------------

def _seg_span(member, is_first, last):
    """Per sorted position: the members of its key segment (total), the
    exclusive member count before its segment, and the inclusive member
    count, via two scans."""
    m32 = member.to(torch.int32)
    cm = torch.cumsum(m32, 0, dtype=torch.int32)  # inclusive
    end = _rev_cummin(torch.where(last, cm, _I32_MAX))
    excl = _cummax(torch.where(is_first, cm - m32, 0))
    return end - excl, excl, cm


class _Merged(NamedTuple):
    """The merged sort both fused plans (and ``semi_mask``) share."""
    key_ops: list          # the sort operands, pad flag first
    idxS: torch.Tensor     # original row per sorted position (int32)
    lo_p: torch.Tensor     # first match in build order
    cnt_p: torch.Tensor    # build rows in the position's key segment
    cr: torch.Tensor       # inclusive count of build rows so far
    left_s: torch.Tensor   # valid probe row at this position
    right_s: torch.Tensor  # valid build row at this position
    is_first: torch.Tensor
    last: torch.Tensor
    carried: tuple         # ``carry`` in sorted order


def _merged_plan(l_cols, l_valids, r_cols, r_valids, l_count, r_count,
                 carry=()) -> _Merged:
    """One merged sort of both sides' keys and the per-position match
    counts, with ``carry`` permuted along."""
    n = l_cols[0].shape[0] + r_cols[0].shape[0]
    n_l = l_cols[0].shape[0]
    dev = l_cols[0].device
    _, _, key_ops = _concat_key_parts(
        l_cols, l_valids, r_cols, r_valids, l_count, r_count)
    sortedK, idxS, is_first, carried = sorted_key_structure(key_ops, n,
                                                            carry)
    valid = ~sortedK[0]  # the pad flag is the most significant operand
    left_s = (idxS < n_l) & valid
    right_s = (idxS >= n_l) & valid
    last = torch.cat([is_first[1:], torch.ones(1, dtype=torch.bool,
                                               device=dev)])
    cnt_p, lo_p, cr = _seg_span(right_s, is_first, last)
    return _Merged(key_ops, idxS, lo_p, cnt_p, cr, left_s, right_s,
                   is_first, last, carried)


def _unmatched_build(m: _Merged, n_r: int):
    """FULL_OUTER: each valid build row's slot in build order (``cr − 1``,
    its rank there) and the unmatched-build mask in that order."""
    rslot = torch.where(m.right_s, m.cr - 1, n_r)
    l_in_seg, _, _ = _seg_span(m.left_s, m.is_first, m.last)
    return rslot, scatter_drop(n_r, rslot, m.right_s & (l_in_seg == 0))


def _empty_plan(n: int, n_r: int, how: str, dev):
    z = lambda m, dt=torch.int32: torch.zeros(m, dtype=dt, device=dev)  # noqa: E731
    plan = (z(n), z(n), z(n), z(n, torch.bool), z(n_r))
    return plan + ((z(n_r, torch.bool),) if how == FULL_OUTER else ())


def sort_join_plan(l_cols, l_valids, r_cols, r_valids, how: str = INNER,
                   l_count=None, r_count=None):
    """Phase 1 of the fused sort join: one sort + scans -> match plan.

    Plan tuple (probe orientation; n = n_probe + n_build), as in JAX:

      idxS   [n]        original row index per sorted position (< n_probe
                        ⇒ probe row, else build row at idxS - n_probe);
      lo_p   [n]        position's first match in build order;
      cnt_p  [n]        position's match count (build rows in its segment);
      left_s [n]  bool  valid probe row at this position;
      rs     [n_build]  original build-row index per build-order slot;
      um     [n_build]  (FULL_OUTER only) unmatched-build mask in rs space.

    For ``how == 'right'`` the plan is built with sides swapped;
    ``plan_total``/``plan_indices`` undo the swap given the same ``how``.
    """
    if how == RIGHT:
        return sort_join_plan(r_cols, r_valids, l_cols, l_valids, LEFT,
                              r_count, l_count)
    n_l, n_r = l_cols[0].shape[0], r_cols[0].shape[0]
    dev = l_cols[0].device
    if n_l == 0 or n_r == 0:
        return _empty_plan(n_l + n_r, n_r, how, dev)
    l_count, r_count = _count(l_count, dev), _count(r_count, dev)
    m = _merged_plan(l_cols, l_valids, r_cols, r_valids, l_count, r_count)
    if how == FULL_OUTER:
        rslot, um = _unmatched_build(m, n_r)
        rs = scatter_drop(n_r, rslot, m.idxS - n_l)
        return (m.idxS, m.lo_p, m.cnt_p, m.left_s, rs, um)
    # build order by a right-side-only stable sort: same keys + same
    # tiebreak as the merged sort, so identical to its right subsequence
    rs = lexsort([op[n_l:] for op in m.key_ops]).to(torch.int32)
    return (m.idxS, m.lo_p, m.cnt_p, m.left_s, rs)


def _plan_sizes(plan):
    n, n_r = plan[0].shape[0], plan[4].shape[0]
    return n - n_r, n_r


def _plan_emit(plan, how):
    _, _, cnt_p, left_s, _ = plan[:5]
    if how == INNER:
        return torch.where(left_s, cnt_p, 0).to(_IDT)
    return torch.where(left_s, torch.clamp(cnt_p, min=1), 0).to(_IDT)


def plan_total(plan, how: str = INNER, l_count=None, r_count=None):
    """Output row count from a ``sort_join_plan`` (0-d int64)."""
    if how == RIGHT:
        return plan_total(plan, LEFT, r_count, l_count)
    n_l, n_r = _plan_sizes(plan)
    dev = plan[0].device
    if n_l == 0 or n_r == 0:
        _, _, total = _degenerate(
            torch.zeros(n_l, dtype=torch.int32, device=dev),
            torch.zeros(n_r, dtype=torch.int32, device=dev), how, 1,
            _count(l_count, dev), _count(r_count, dev))
        return total.to(_IDT)
    _, _, cnt_p, left_s, _ = plan[:5]
    total = torch.sum(torch.where(left_s, cnt_p, 0).to(_IDT))
    if how == INNER:
        return total
    left_total = total + torch.sum(left_s & (cnt_p == 0))
    if how == LEFT:
        return left_total
    if how == FULL_OUTER:
        return left_total + torch.sum(plan[5].to(_IDT))
    raise ValueError(f"unknown join type {how!r}")


def plan_indices(plan, how: str, capacity: int, l_count=None, r_count=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 2 of the fused sort join: run-length expansion of the plan.

    Same contract as ``join_indices``: (left_idx[cap], right_idx[cap],
    count), −1 ⇒ null-fill row.
    """
    if how == RIGHT:
        ri, li, cnt = plan_indices(plan, LEFT, capacity, r_count, l_count)
        return li, ri, cnt
    n_l, n_r = _plan_sizes(plan)
    dev = plan[0].device
    if n_l == 0 or n_r == 0:
        return _degenerate(torch.zeros(n_l, dtype=torch.int32, device=dev),
                           torch.zeros(n_r, dtype=torch.int32, device=dev),
                           how, capacity, _count(l_count, dev),
                           _count(r_count, dev))
    return _expand(plan, how, capacity, decode=True)


def _expand(plan, how: str, capacity: int, decode: bool):
    """Run-length expansion of a plan whose sides are both non-empty
    (``how`` ≠ right): per output slot its probe and build row, −1 ⇒
    null, and the count.  ``decode``: as original row numbers (through
    ``idxS`` and ``rs``); else as the positions the carried leaves are
    laid out in (merged-sort order, build order)."""
    idxS, lo_p, cnt_p, _, rs = plan[:5]
    n, n_r = idxS.shape[0], rs.shape[0]
    dev = idxS.device
    emit = _plan_emit(plan, how)
    offs_incl = torch.cumsum(emit, 0)
    total_lpart = offs_incl[-1]
    starts_p = offs_incl - emit
    tgt = torch.where(emit > 0, starts_p, capacity)
    scat = scatter_drop(capacity, tgt,
                        torch.arange(n, dtype=torch.int32, device=dev))
    pos_c = _cummax(scat)
    j = torch.arange(capacity, dtype=_IDT, device=dev)
    chg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                     pos_c[1:] != pos_c[:-1]])
    run_start = _cummax(torch.where(chg, j, 0))
    within = j - run_start
    cols = ([idxS] if decode else []) + [lo_p] + \
        ([] if how == INNER else [cnt_p])
    g = torch.stack(cols, dim=1)[pos_c.long()]  # ONE wide gather
    if decode:
        left_idx, g = g[:, 0], g[:, 1:]
        right_at = lambda pos: rs[pos.long()]  # noqa: E731
    else:
        left_idx, right_at = pos_c, lambda pos: pos  # noqa: E731
    r_pos = right_at(torch.clamp(g[:, 0] + within, 0, n_r - 1))
    if how == INNER:
        right_idx = r_pos
    else:
        right_idx = torch.where(within < g[:, 1], r_pos, -1)
    if how == FULL_OUTER:
        left_idx, right_idx, total = append_right_tail(
            j, total_lpart, plan[5], n_r, left_idx, right_idx,
            right_orig=right_at)
    else:
        total = total_lpart if how == LEFT else torch.sum(emit)
    return mask_past_total(j, total, left_idx, right_idx)


# ---------------------------------------------------------------------------
# carried plan: the output leaves ride the plan's sorts
# ---------------------------------------------------------------------------
#
# The JAX package rides the output leaves as extra ``lax.sort`` operands,
# so its phase 2 reads them where the expansion lands.  Here a carried
# leaf is one more gather by the sort's permutation, paid in phase 1,
# and phase 2 is ``plan_indices``' expansion with the leaves gathered at
# the sorted positions.  Measured on the H100 it is no faster than the
# plain plan (``chip_smoke.py``'s carried phase), so
# ``_join_copartitioned`` does not choose it; the functions keep the JAX
# package's contract.

def sort_join_plan_carried(l_cols, l_valids, r_cols, r_valids,
                           how: str = INNER, l_count=None, r_count=None,
                           l_leaves=(), r_leaves=()):
    """``sort_join_plan`` with output leaves riding its sorts.

    ``l_leaves`` / ``r_leaves``: sequences of ``(data, validity)`` output
    columns.  Returns ``(plan, probe_sorted, build_sorted)``: the plan in
    probe orientation (``how='right'`` swaps inside, as
    ``sort_join_plan`` does), the probe leaves in merged-sort order
    (``[n]``) and the build leaves in build order (``[n_build]``).  Pair
    with ``plan_gather_carried`` under the same ``how``.  A statically
    empty side keeps both sides' leaves in row order: phase 2 then takes
    the index path (``_degenerate``).
    """
    if how == RIGHT:
        return sort_join_plan_carried(r_cols, r_valids, l_cols, l_valids,
                                      LEFT, r_count, l_count,
                                      r_leaves, l_leaves)
    n_l, n_r = l_cols[0].shape[0], r_cols[0].shape[0]
    dev = l_cols[0].device
    if n_l == 0 or n_r == 0:
        return (_empty_plan(n_l + n_r, n_r, how, dev), tuple(l_leaves),
                tuple(r_leaves))
    l_count, r_count = _count(l_count, dev), _count(r_count, dev)
    carry = []
    for d, v in l_leaves:
        carry.append(torch.cat([d, d.new_zeros((n_r,) + d.shape[1:])]))
        if v is not None:
            carry.append(torch.cat([v, v.new_zeros(n_r)]))
    m = _merged_plan(l_cols, l_valids, r_cols, r_valids, l_count, r_count,
                     tuple(carry))
    it = iter(m.carried)
    probe_sorted = tuple((next(it), None if v is None else next(it))
                         for _, v in l_leaves)
    # build order by the right-side-only stable sort (identical to the
    # merged sort's right subsequence); the build leaves follow it
    rperm = lexsort([op[n_l:] for op in m.key_ops])
    build_sorted = tuple(
        (signed_view(d)[rperm].view(d.dtype),
         None if v is None else v[rperm]) for d, v in r_leaves)
    plan = (m.idxS, m.lo_p, m.cnt_p, m.left_s, rperm.to(torch.int32))
    if how == FULL_OUTER:
        plan += (_unmatched_build(m, n_r)[1],)
    return plan, probe_sorted, build_sorted


def plan_gather_carried(plan, probe_sorted, build_sorted, how: str,
                        capacity: int, l_count=None, r_count=None):
    """Phase 2 over a carried plan: ``plan_indices``' expansion, then one
    ``take_many`` per side over the sorted leaves.

    Returns ``(left_outs, right_outs, count)`` in the original table
    orientation (the ``how='right'`` swap is undone here), each out a
    ``(data, validity)`` pair of ``capacity`` rows.  The outer side's
    unmatched rows are null; rows past ``count`` are unspecified.
    """
    if how == RIGHT:
        p_outs, b_outs, cnt = _gather_carried(
            plan, probe_sorted, build_sorted, LEFT, capacity, r_count,
            l_count)
        return b_outs, p_outs, cnt
    return _gather_carried(plan, probe_sorted, build_sorted, how, capacity,
                           l_count, r_count)


def _gather_carried(plan, probe_sorted, build_sorted, how: str,
                    capacity: int, l_count, r_count):
    n_l, n_r = _plan_sizes(plan)
    dev = plan[0].device
    if n_l == 0 or n_r == 0:  # the index path, leaves in row order
        pi, bi, cnt = _degenerate(
            torch.zeros(n_l, dtype=torch.int32, device=dev),
            torch.zeros(n_r, dtype=torch.int32, device=dev), how, capacity,
            _count(l_count, dev), _count(r_count, dev))
    else:
        pi, bi, cnt = _expand(plan, how, capacity, decode=False)
    return (take_many(probe_sorted, pi, fill_null=how == FULL_OUTER),
            take_many(build_sorted, bi, fill_null=how != INNER), cnt)


def _degenerate(l_key, r_key, how, capacity, l_count=None, r_count=None):
    """One side statically empty: inner ⇒ ∅; outer ⇒ null-filled survivors."""
    n_l, n_r = l_key.shape[0], r_key.shape[0]
    dev = l_key.device
    lc = torch.as_tensor(n_l if l_count is None else l_count, dtype=_IDT, device=dev)
    rc = torch.as_tensor(n_r if r_count is None else r_count, dtype=_IDT, device=dev)
    j = torch.arange(capacity, dtype=_IDT, device=dev)
    neg = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if how == INNER or (how == LEFT and n_l == 0):
        return neg, neg, zero
    if how == LEFT:  # n_r == 0: every valid left row survives null-filled
        li = torch.where(j < lc, j, -1).to(torch.int32)
        return li, neg, lc.to(torch.int32)
    if n_l == 0 and n_r == 0:
        return neg, neg, zero
    if n_r == 0:
        li = torch.where(j < lc, j, -1).to(torch.int32)
        return li, neg, lc.to(torch.int32)
    ri = torch.where(j < rc, j, -1).to(torch.int32)
    return neg, ri, rc.to(torch.int32)
