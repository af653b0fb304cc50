"""Sort-indices kernels (argsort / lexsort).

Mirror of ``cylon_tpu/ops/sort.py`` (reference:
cpp/src/cylon/arrow/arrow_kernels.hpp:125-193, util/sort_indices.cpp).
Every sort is stable and returns int64 positions.  Nulls sort last in
either direction (an is-null key ahead of the value), and the padded-block
variants sort padding rows to the tail.

``jnp.lexsort`` becomes ``join.lexsort`` (chained stable sorts, most
significant key first here), which maps bool and unsigned keys to types
torch can sort.  torch sorts NaN last and ties −0.0 with 0.0, as
``lax.sort`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .join import _ordered, lexsort

_SIGNED_OF_UNSIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16,
                       torch.uint32: torch.int32, torch.uint64: torch.int64}


def _directions(ascending, n: int):
    return [ascending] * n if isinstance(ascending, bool) else list(ascending)


def sort_indices(col: torch.Tensor, validity: Optional[torch.Tensor] = None,
                 ascending: bool = True) -> torch.Tensor:
    """Stable argsort of one column (nulls last)."""
    key = col if ascending else _invert(col)
    if validity is None:
        return torch.sort(_ordered(key), stable=True).indices
    return lexsort([~validity, key])


def lexsort_indices(cols: Sequence[torch.Tensor],
                    validities: Optional[Sequence[Optional[torch.Tensor]]] = None,
                    ascending=True) -> torch.Tensor:
    """Stable lexicographic argsort; ``cols[0]`` is the primary key.
    ``ascending`` is one bool for all keys or one per column."""
    asc = _directions(ascending, len(cols))
    keys = []
    for i, c in enumerate(cols):
        v = validities[i] if validities is not None else None
        if v is not None:
            keys.append(~v)
        keys.append(c if asc[i] else _invert(c))
    return lexsort(keys)


def _pad_flag(n: int, count, device) -> torch.Tensor:
    return torch.arange(n, device=device) >= count


def sort_indices_masked(col: torch.Tensor, validity: Optional[torch.Tensor],
                        count, ascending: bool = True) -> torch.Tensor:
    """Stable argsort of a padded block: rows [0, count) ordered (nulls
    last), padding rows sorted to the tail."""
    n = col.shape[0]
    isnull = (torch.zeros(n, dtype=torch.bool, device=col.device)
              if validity is None else ~validity)
    return lexsort([_pad_flag(n, count, col.device), isnull,
                    col if ascending else _invert(col)])


def lexsort_indices_masked(cols: Sequence[torch.Tensor],
                           validities: Sequence[Optional[torch.Tensor]],
                           count, ascending=True) -> torch.Tensor:
    """Stable multi-key argsort of a padded block: rows [0, count) in
    lexicographic order (per-key ASC/DESC, nulls last per key), padding
    rows sorted to the tail."""
    asc = _directions(ascending, len(cols))
    keys = [_pad_flag(cols[0].shape[0], count, cols[0].device)]
    for c, v, a in zip(cols, validities, asc):
        if v is not None:
            keys.append(~v)
        keys.append(c if a else _invert(c))
    return lexsort(keys)


def _invert(col: torch.Tensor) -> torch.Tensor:
    """Total order-reversing transform for a descending sort, bit for bit
    the JAX package's: ``-x`` for floats, ``max - x`` for unsigned ints,
    ``~x`` for signed ints and bool.  ``max - x`` is the bitwise not of
    an unsigned value, taken on its signed view (torch has no unsigned
    subtraction on the CPU)."""
    if col.dtype.is_floating_point:
        return -col
    signed = _SIGNED_OF_UNSIGNED.get(col.dtype)
    if signed is not None:
        return (~col.view(signed)).view(col.dtype)
    return ~col
