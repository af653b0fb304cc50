"""Gather-by-indices with −1 → null semantics.

Mirror of ``cylon_tpu/ops/gather.py`` (reference:
cpp/src/cylon/util/copy_arrray.cpp:24-267): output columns are built from
an index vector where index −1 appends a null (the outer-join fill path,
copy_arrray.cpp:38-43).  Indices are clipped into range before the gather,
as ``jnp.take`` does: torch would wrap −1 to the last row, or raise.

torch implements few operators for uint16/32/64 tensors, so gathers and
masks run on a same-width signed view of them (``signed_view``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
_SIGNED_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def signed_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` reinterpreted as the same-width signed type where torch's
    operator coverage for its unsigned type is thin; else ``x``."""
    sd = _SIGNED.get(x.dtype)
    return x if sd is None else x.view(sd)


def _index(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(signed_view(data), 0, idx).view(data.dtype)


def _zero_where_not(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    return torch.where(m, signed_view(x), 0).view(x.dtype)


def take(data: torch.Tensor, validity: Optional[torch.Tensor],
         indices: torch.Tensor, fill_null: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gather rows; if ``fill_null``, index −1 produces a null row.

    Returns (data, validity).  ``fill_null=False`` (no −1 possible, e.g.
    inner join) keeps validity None when input had none.
    """
    n = data.shape[0]
    if n == 0:
        out = torch.zeros(indices.shape[:1] + data.shape[1:], dtype=data.dtype,
                          device=data.device)
        return out, (torch.zeros(indices.shape[:1], dtype=torch.bool,
                                 device=data.device) if fill_null else None)
    safe = indices.clamp(0, n - 1)
    out = _index(data, safe)
    if not fill_null:
        if validity is None:
            return out, None
        return out, torch.index_select(validity, 0, safe)
    valid = indices >= 0
    if validity is not None:
        valid = valid & torch.index_select(validity, 0, safe)
    return _zero_where_not(valid, out), valid


def take_many(leaves, indices: torch.Tensor, fill_null: bool = False):
    """Gather many same-length columns at once: ``take`` semantics per
    column, with data columns packed by byte width (``pack_columns``) so
    each width class is ONE wide gather, and validities one stacked gather.

    ``leaves``: sequence of ``(data, validity)``.  Returns a list of
    ``(data, validity)`` like per-column ``take``.
    """
    leaves = list(leaves)
    if not leaves:
        return []
    n = leaves[0][0].shape[0]
    if n == 0 or len(leaves) == 1:
        return [take(d, v, indices, fill_null=fill_null) for d, v in leaves]
    safe = indices.clamp(0, n - 1)
    valid = indices >= 0 if fill_null else None

    datas: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for wide, positions, dtypes in pack_columns([d for d, _ in leaves]):
        wide = torch.index_select(wide, 0, safe)
        if fill_null:
            wide = _zero_where_not(valid, wide)
        for col, pos in zip(unpack_columns(wide, dtypes), positions):
            datas[pos] = col

    vpos = [pos for pos, (_, v) in enumerate(leaves) if v is not None]
    gathered_v = {}
    if vpos:
        vwide = torch.index_select(
            torch.stack([leaves[p][1] for p in vpos], dim=1), 0, safe)
        for j, p in enumerate(vpos):
            gathered_v[p] = vwide[:, j]

    outs = []
    for pos in range(len(leaves)):
        gv = gathered_v.get(pos)
        if fill_null:
            vcol = valid if gv is None else (valid & gv)
            if gv is not None:
                # data is zeroed under the COMBINED validity, as take() does
                datas[pos] = _zero_where_not(vcol, datas[pos])
        else:
            vcol = gv
        outs.append((datas[pos], vcol))
    return outs


def pack_columns(cols):
    """Group same-length columns by byte-width class, reinterpret each as
    the class's signed integer type, and stack ``[n, C]``.

    bool → uint8; 8-byte columns stack per dtype as they are.  A column
    with trailing dimensions (``[n, M]`` sketch state) is a class of its
    own: its signed view flattened to ``[n, M]``, its dtype entry the pair
    ``(dtype, trailing shape)``.  Returns ``[(matrix, positions, dtypes)]``
    per class, invertible by ``unpack_columns``.
    """
    by_width = {}
    trailing = []
    for pos, d in enumerate(cols):
        if d.dim() > 1:
            flat = (d.to(torch.uint8) if d.dtype == torch.bool
                    else signed_view(d)).reshape(d.shape[0], -1)
            trailing.append((flat, [pos], [(d.dtype, tuple(d.shape[1:]))]))
            continue
        if d.dtype == torch.bool:
            key, cast = "b", d.to(torch.uint8)
        elif d.element_size() == 8:
            key, cast = d.dtype, signed_view(d)
        else:
            key = d.element_size()
            cast = d.view(_SIGNED_OF_WIDTH[key])
        by_width.setdefault(key, []).append((pos, cast, d.dtype))
    return [(torch.stack([c for _, c, _ in items], dim=1),
             [p for p, _, _ in items], [dt for _, _, dt in items])
            for items in by_width.values()] + trailing


def unpack_columns(wide: torch.Tensor, dtypes):
    """Columns of a packed matrix back to their original dtypes (the last
    axis indexes columns; leading axes pass through).  A trailing-dimension
    class (one ``(dtype, shape)`` entry) is the whole matrix, reshaped."""
    if len(dtypes) == 1 and isinstance(dtypes[0], tuple):
        dt, tail = dtypes[0]
        col = wide.reshape(tuple(wide.shape[:-1]) + tail)
        return [col.to(torch.bool) if dt == torch.bool
                else col.contiguous().view(dt)]
    out = []
    for j, dt in enumerate(dtypes):
        col = wide[..., j]
        if dt == torch.bool:
            out.append(col.to(torch.bool))
        else:
            out.append(col.contiguous().view(dt))
    return out
