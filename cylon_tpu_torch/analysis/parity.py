"""Row-set parity comparison shared by the acceptance harnesses.

The out-of-core gates compare a spilled / pinned-budget run against the
resident run (the chip smoke's out-of-core TPC-H phase does, beside its
ordered check).  One canonicalize-and-compare routine serves every
gate, so a tolerance or dtype-handling fix cannot silently diverge
between them.
"""
from __future__ import annotations

__all__ = ["canon_frame", "frames_rowset_equal"]


def canon_frame(df):
    """Order-independent canonical form: categoricals to strings, rows
    sorted by every column, index dropped."""
    import pandas as pd
    out = df.copy()
    for c in out.columns:
        if isinstance(out[c].dtype, pd.CategoricalDtype):
            out[c] = out[c].astype(str)
    return out.sort_values(list(out.columns)).reset_index(drop=True)


def frames_rowset_equal(got, want, rtol: float = 1e-4,
                        atol: float = 1e-6) -> bool:
    """Same columns, same row count, float columns allclose, everything
    else string-equal — the suite's rowset tolerance (an rtol-only
    compare flakes on near-zero aggregates)."""
    import numpy as np
    import pandas as pd
    g, w = canon_frame(got), canon_frame(want)
    if list(g.columns) != list(w.columns) or len(g) != len(w):
        return False
    for c in g.columns:
        if pd.api.types.is_float_dtype(w[c]):
            if not np.allclose(g[c].to_numpy(np.float64),
                               w[c].to_numpy(np.float64),
                               rtol=rtol, atol=atol):
                return False
        elif g[c].astype(str).tolist() != w[c].astype(str).tolist():
            return False
    return True
