"""Set operations (union / intersect / subtract) over whole rows.

Mirror of ``cylon_tpu/ops/setops.py`` (reference:
cpp/src/cylon/table_api.cpp:530-902, a hash set of rows).  Rows of
concat(A, B) are lexsorted with the origin flag as the final tie-break,
adjacent compares mark distinct-row boundaries, a per-group maximum gives
each group's presence in A and in B, and the surviving representatives
are compacted.  Outputs are bounded by the inputs, so the result is
(indices into the concatenation, count) at a static capacity.

Set semantics match the reference: results are deduplicated, and null
equals null (validity takes part in the keys).  The boundaries compare
the data with ``!=``, so NaN rows never deduplicate and the bytes under
a null slot take part, exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .compact import compact_indices
from .join import _ordered, lexsort

UNION, INTERSECT, SUBTRACT = "union", "intersect", "subtract"


def _starts(x: torch.Tensor) -> torch.Tensor:
    """True where a sorted sequence differs from its predecessor (and at 0)."""
    one = torch.ones(1, dtype=torch.bool, device=x.device)
    return torch.cat([one, x[1:] != x[:-1]])


def _row_order_and_groups(cols: Sequence[torch.Tensor],
                          validities: Sequence[Optional[torch.Tensor]],
                          origin: torch.Tensor,
                          valid: Optional[torch.Tensor] = None):
    """Sort rows lexicographically (origin last), mark distinct-row starts.

    Significance, most first, as ``jnp.lexsort`` orders the JAX keys:
    the padding flag, then per column from the LAST to the first its
    is-null flag and its values, then the origin.  ``valid`` marks real
    rows of padded blocks: invalid rows sort after all valid rows and
    start their own groups.
    """
    cols = [_ordered(c) for c in cols]
    keys = [] if valid is None else [~valid]
    for c, v in zip(reversed(cols), reversed(list(validities))):
        if v is not None:
            keys.append(~v)
        keys.append(c)
    keys.append(origin)
    order = lexsort(keys)
    is_first = torch.zeros(origin.shape[0], dtype=torch.bool,
                           device=origin.device)
    is_first[:1].fill_(True)
    for c, v in zip(cols, validities):
        is_first |= _starts(c[order])
        if v is not None:
            is_first |= _starts(v[order])
    if valid is not None:
        is_first |= _starts(valid[order])
    return order, is_first


def _group_any(flag: torch.Tensor, group_id: torch.Tensor) -> torch.Tensor:
    """``segment_max(flag, group_id, num_segments=n) > 0``."""
    n = flag.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=flag.device)
    out.scatter_reduce_(0, group_id, flag.to(torch.int32), "amax")
    return out > 0


def set_op_indices(cols: Sequence[torch.Tensor],
                   validities: Sequence[Optional[torch.Tensor]],
                   n_a: int, op: str,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a set op over concatenated row columns.

    ``cols[i]`` holds table A's rows [0, n_a) followed by table B's rows.
    ``valid`` marks real rows in padded blocks (None = all rows real).
    Returns (int32 indices into the concatenated rows padded with −1,
    int32 count).  Capacity: n_a + n_b for union, n_a otherwise.
    """
    n = cols[0].shape[0]
    dev = cols[0].device
    if op == UNION:
        capacity = n
    elif op in (INTERSECT, SUBTRACT):
        capacity = n_a
    else:
        raise ValueError(f"unknown set op {op!r}")
    origin = torch.arange(n, device=dev) >= n_a  # False = A, True = B
    order, is_first = _row_order_and_groups(cols, validities, origin, valid)
    group_id = torch.cumsum(is_first, 0) - 1

    og = origin[order]
    vg = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
          else valid[order])
    has_a = _group_any(~og & vg, group_id)
    has_b = _group_any(og & vg, group_id)

    # a group's representative is its first sorted row: from A whenever
    # the group spans both tables (origin is the last key).  Padding-only
    # groups have neither flag and are dropped.
    if op == UNION:
        keep_group = has_a | has_b
    elif op == INTERSECT:
        keep_group = has_a & has_b
    else:
        keep_group = has_a & ~has_b

    keep_row = is_first & keep_group[group_id]
    pos = compact_indices(keep_row, capacity, fill=-1)
    count = torch.sum(keep_row).to(torch.int32)
    idx = torch.where(pos >= 0, order[pos.clamp(0, n - 1).long()].to(torch.int32),
                      -1)
    return idx, count
