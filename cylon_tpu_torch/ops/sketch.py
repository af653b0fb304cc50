"""Mergeable sketches: approximate distinct count and quantiles.

Mirror of ``cylon_tpu/ops/sketch.py`` (arXiv:2010.14596's mergeable
summaries): per-group state of FIXED size, so the sketches themselves are
the partials of the partial → exchange → combine path, and the combine
exchange moves constant bytes per group whatever the rows that fed it.

  **HLL distinct count** (``approx_distinct``): ``HLL_M`` = 256 int32
  registers per group; each row's mixed 32-bit hash contributes
  ``rank = leading-zeros(hash >> HLL_P) + 1`` to register
  ``hash & (M−1)`` by one scatter-max.  Merge = elementwise register max.
  Estimate: the bias-corrected harmonic mean with the small-range
  linear-counting correction.

  **Bottom-k quantile sample** (``approx_quantile:<q>``): each row draws
  the priority ``mix32(value_bits ^ mix32(global row id))``; a group's
  sketch is its ``QUANTILE_K`` rows of smallest priority (value and
  priority lanes).  Merge = the K smallest priorities of the union.  The
  estimate is the sample's empirical q-quantile.

Sketch state is ``[rows, M]`` / ``[rows, K]`` leaves (trailing-dimension
columns of a DTable); the exchange and the gathers move them by row.

**Translation notes.**  torch has no uint32 shift, add or compare, so
every 32-bit hash and priority is carried in int64 and masked with
``& 0xFFFFFFFF`` (the helpers of ``ops/hash.py``); priority lanes are
stored as uint32 like the JAX package's.  ``lax.clz`` becomes an exact
binary search for the bit length.  The scatter-max is ``scatter_reduce``
(amax) on a flattened (slot, register) index, which does not depend on
the order of the writes; the bottom-k lanes are scatter-sets whose kept
targets are unique.  ``hll_estimate`` sums the 256 powers of two and takes
the logarithm in float64, then rounds to float32 where the JAX package
computes in float32: the card and the CPU then agree bit for bit.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .hash import _M32, _fmix32, _half_to_float_bits

__all__ = [
    "HLL_M", "HLL_P", "QUANTILE_K", "PRIO_MAX", "HLL_ERROR_BOUND",
    "QUANTILE_RANK_ERROR_BOUND", "mix32", "value_bits32", "hll_build",
    "hll_merge_rows", "hll_estimate", "bottomk_build", "bottomk_merge_rows",
    "bottomk_quantile", "sorted_slots",
]

HLL_P = 8                 # register index bits
HLL_M = 1 << HLL_P        # registers per group (256 → σ ≈ 6.5%)
QUANTILE_K = 256          # sample slots per group
PRIO_MAX = 0xFFFFFFFF     # empty sample-slot sentinel (a uint32 value)

# 4× the sketches' standard errors: the bounds the sketch-vs-exact checks
# assert
HLL_ERROR_BOUND = 4 * 1.04 / math.sqrt(HLL_M)
QUANTILE_RANK_ERROR_BOUND = 4 * 0.5 / math.sqrt(QUANTILE_K)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer or bool tensor → its uint32 value (``astype(uint32)``,
    wrapping) in int64."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & _M32
    if x.dtype == torch.uint64:
        return x.view(torch.int64) & _M32
    return x.to(torch.int64) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer over uint32 values (int64 in and out)."""
    return _fmix32(_u32(x))


def value_bits32(col: torch.Tensor) -> torch.Tensor:
    """A 32-bit pattern per value (equal values → equal bits), int64:
    8-byte types fold their high half into the low (``u ^ (u >> 32)``),
    float32 (and float16, widened first) bitcast, narrower integers and
    bool take ``astype(uint32)``."""
    if col.dtype == torch.float16:
        return _half_to_float_bits(col)
    if col.dtype == torch.float32:
        return col.view(torch.int32).to(torch.int64) & _M32
    if col.element_size() == 8:
        # float64 / int64 / uint64 bits; the low 32 bits of an arithmetic
        # shift equal those of the logical one
        b = col.contiguous().view(torch.int64)
        return (b ^ (b >> 32)) & _M32
    return _u32(col)


def sorted_slots(is_first: torch.Tensor, rvS: torch.Tensor,
                 out_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sorted-row group slot: ``g`` for the rows of the g-th real
    group, ``out_cap`` (dropped) for padding rows.  Returns
    ``(slot int64, keep_first)``."""
    keep_first = is_first & rvS
    gid = torch.cumsum(keep_first, 0) - 1
    slot = torch.where(rvS, torch.clamp(gid, 0, out_cap), out_cap)
    return slot, keep_first


# ---------------------------------------------------------------------------
# HLL distinct count
# ---------------------------------------------------------------------------

def _bit_length(w: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative values below 2^32 (0 → 0)."""
    bl = torch.zeros_like(w)
    x = w
    for s in (16, 8, 4, 2, 1):
        hi = (x >> s) != 0
        bl = bl + torch.where(hi, s, 0)
        x = torch.where(hi, x >> s, x)
    return bl + (x != 0).to(w.dtype)


def _hll_rank(h: torch.Tensor) -> torch.Tensor:
    """rank = leading zeros of the (32−P)-bit suffix + 1; an all-zero
    suffix saturates at 32−P+1.  ``h``: uint32 values in int64."""
    w = h >> HLL_P
    clz_in_32 = 32 - _bit_length(w)
    rank = clz_in_32 - HLL_P + 1
    return torch.clamp(rank, 1, 32 - HLL_P + 1).to(torch.int32)


def hll_build(slot: torch.Tensor, out_cap: int, bits: torch.Tensor,
              vmask: torch.Tensor) -> torch.Tensor:
    """[n] rows → [out_cap, M] int32 registers: one scatter-max of each
    valid row's rank into (its group's slot, its hash's register)."""
    h = mix32(bits)
    reg = h & (HLL_M - 1)
    rank = torch.where(vmask, _hll_rank(h), 0)
    tgt = torch.where(vmask, slot.to(torch.int64), out_cap)
    tgt = torch.where((tgt >= 0) & (tgt < out_cap), tgt, out_cap)
    out = torch.zeros((out_cap + 1) * HLL_M, dtype=torch.int32,
                      device=bits.device)
    out.scatter_reduce_(0, tgt * HLL_M + reg, rank, reduce="amax")
    return out.view(out_cap + 1, HLL_M)[:out_cap]


def hll_merge_rows(slot: torch.Tensor, out_cap: int,
                   regs_rows: torch.Tensor, row_valid: torch.Tensor
                   ) -> torch.Tensor:
    """Merge per-row register arrays ([n, M], each row one partial sketch)
    into [out_cap, M] by group slot: elementwise scatter-max."""
    tgt = torch.where(row_valid, slot.to(torch.int64), out_cap)
    tgt = torch.where((tgt >= 0) & (tgt < out_cap), tgt, out_cap)
    out = torch.zeros((out_cap + 1, HLL_M), dtype=torch.int32,
                      device=regs_rows.device)
    out.scatter_reduce_(0, tgt[:, None].expand(-1, HLL_M),
                        regs_rows.to(torch.int32), reduce="amax")
    return out[:out_cap]


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """[C, M] registers → [C] estimated distinct counts (int32)."""
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    # 2^-r for r <= 25: the float64 sum is exact, so one rounding to
    # float32 gives the same z on every device
    z = torch.sum(torch.exp2(-regs.to(torch.float64)), 1).to(torch.float32)
    raw = torch.full((), alpha * m * m, dtype=torch.float32,
                     device=regs.device) / z
    v = torch.sum(regs == 0, 1).to(torch.float32)
    ratio = m / torch.clamp(v, min=1.0)
    small = m * torch.log(ratio.to(torch.float64)).to(torch.float32)
    est = torch.where((raw <= 2.5 * m) & (v > 0), small, raw)
    return torch.round(est).to(torch.int32)


# ---------------------------------------------------------------------------
# bottom-k quantile sample
# ---------------------------------------------------------------------------

def _rank_within_slot(slot_sorted: torch.Tensor) -> torch.Tensor:
    """Position of each sorted element within its (nondecreasing) slot
    run: i − start of its run.  The JAX package finds the start by a
    cumulative max over run starts; here a binary search for the first
    element of the same slot gives the same start (torch's CUDA
    ``cummax`` is a slow serial scan)."""
    i = torch.arange(slot_sorted.shape[0], dtype=torch.int64,
                     device=slot_sorted.device)
    return i - torch.searchsorted(slot_sorted, slot_sorted)


def _bottomk_scatter(slot: torch.Tensor, prio: torch.Tensor,
                     vals: torch.Tensor, valid: torch.Tensor, out_cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep each group's K smallest-priority elements: order by (slot,
    priority, position) with two stable sorts, rank within each slot run,
    scatter ranks < K into the [out_cap, K] lanes.  Returns (float32
    values, uint32 priorities)."""
    dev = vals.device
    prio = torch.where(valid, prio, PRIO_MAX)
    s = torch.where(valid, slot.to(torch.int64), out_cap)
    o1 = torch.sort(prio, stable=True).indices
    o2 = torch.sort(s[o1], stable=True).indices
    order = o1[o2]
    slot_sorted = s[order]
    rank = _rank_within_slot(slot_sorted)
    prio_sorted = prio[order]
    keep = (rank < QUANTILE_K) & (slot_sorted < out_cap) \
        & (prio_sorted < PRIO_MAX)
    flat = torch.where(keep, slot_sorted * QUANTILE_K
                       + torch.clamp(rank, 0, QUANTILE_K - 1),
                       out_cap * QUANTILE_K)
    size = (out_cap + 1) * QUANTILE_K
    out_v = torch.zeros(size, dtype=vals.dtype, device=dev)
    out_v.scatter_(0, flat, vals[order])
    out_p = torch.full((size,), PRIO_MAX, dtype=torch.int64, device=dev)
    out_p.scatter_(0, flat, torch.where(keep, prio_sorted, PRIO_MAX))
    return (out_v.view(out_cap + 1, QUANTILE_K)[:out_cap],
            out_p.view(out_cap + 1, QUANTILE_K)[:out_cap].to(torch.uint32))


def bottomk_build(slot: torch.Tensor, out_cap: int, vals: torch.Tensor,
                  bits: torch.Tensor, gidx: torch.Tensor,
                  vmask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n] rows → ([out_cap, K] float32 sample values, [out_cap, K] uint32
    priorities).  A row's priority mixes its value bits with its GLOBAL
    row id, so duplicates draw independent priorities and a re-delivered
    row merges idempotently."""
    prio = mix32(bits ^ mix32(gidx))
    # reserve the sentinel: a real PRIO_MAX would read as an empty slot
    prio = torch.clamp(prio, max=PRIO_MAX - 1)
    return _bottomk_scatter(slot, prio, vals.to(torch.float32), vmask,
                            out_cap)


def bottomk_merge_rows(slot: torch.Tensor, out_cap: int,
                       vals_rows: torch.Tensor, prio_rows: torch.Tensor,
                       row_valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-row [n, K] sample lanes by group slot: every (row, k)
    element re-enters the bottom-k selection over the union."""
    prio = _u32(prio_rows.reshape(-1))
    flat_slot = torch.repeat_interleave(slot.to(torch.int64), QUANTILE_K)
    flat_valid = (torch.repeat_interleave(row_valid, QUANTILE_K)
                  & (prio < PRIO_MAX))
    return _bottomk_scatter(flat_slot, prio, vals_rows.reshape(-1),
                            flat_valid, out_cap)


def bottomk_quantile(vals: torch.Tensor, prios: torch.Tensor, q: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, K] sample lanes → ([C] float32 q-quantile estimates, [C]
    non-empty mask): the sample's values sorted ascending (empty slots as
    +inf), index ``round(q·(s−1))`` of its ``s`` entries."""
    valid = _u32(prios) < PRIO_MAX
    s = torch.sum(valid, 1)
    v = torch.where(valid, vals.to(torch.float32), float("inf"))
    vsort = torch.sort(v, 1).values
    idx = torch.round(q * torch.clamp(s - 1, min=0).to(torch.float64))
    idx = torch.clamp(idx, 0, QUANTILE_K - 1).to(torch.int64)
    est = torch.gather(vsort, 1, idx[:, None])[:, 0]
    return torch.where(s > 0, est, 0.0), s > 0
