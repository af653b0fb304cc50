#!/usr/bin/env python
"""High-cardinality string keys via the hash64 data plane, on the port.

The dictionary encoding (the default) is right for enum-like strings;
for keys with millions of distinct values it would build a
row-count-sized dictionary and merge dictionaries on every join.  This
example shows the hash64 alternative (`cylon_tpu_torch.strings`): encode
the key as two int32 murmur3 lanes, run joins/groupbys on the lane pair
as an ordinary composite int key, and resolve the payload strings
host-side at the end.  Collision policy: documented in
cylon_tpu_torch/strings.py (within-column collisions detected at ingest;
cross-table probability ≈ n²/2⁶⁵).  Usage:

    python strings_hash64_example.py [--device D]
"""
import sys

import numpy as np
import pandas as pd
from example_utils import device_arg

from cylon_tpu_torch import CylonContext, JoinConfig
from cylon_tpu_torch import strings as cstr
from cylon_tpu_torch.parallel import DTable, dist_groupby, dist_join

WORLD = 8  # the reference tests' ranks


def main():
    device, _ = device_arg(sys.argv)
    ctx = CylonContext(device=device, world=WORLD)
    rng = np.random.default_rng(7)

    n_users = 50_000
    users = np.array([f"user-{i:08x}" for i in range(n_users)], dtype=object)
    events = pd.DataFrame({
        "user": users[rng.integers(0, n_users, 200_000)],
        "amount": rng.random(200_000).astype(np.float32),
    })
    profile = pd.DataFrame({
        "user": users,
        "segment": rng.integers(0, 5, n_users).astype(np.int32),
    })

    # one store accompanies the pipeline; encode_frame swaps each string
    # column for its (user#h0, user#h1) int32 lane pair
    store = cstr.StringStore()
    ev_enc, _ = cstr.encode_frame(events, ["user"], store)
    pr_enc, _ = cstr.encode_frame(profile, ["user"], store)

    ev = DTable.from_pandas(ctx, ev_enc)
    pr = DTable.from_pandas(ctx, pr_enc)

    # join on the lane pair — no dictionary exists anywhere on this path
    key = cstr.key_of("user")
    joined = dist_join(ev, pr, JoinConfig.InnerJoin(key, key))

    # spend per user: group by the lane pair, resolve strings at the end
    # (resolve_frame understands the join's lt-/rt- name prefixes)
    per_user = dist_groupby(joined, ["lt-user#h0", "lt-user#h1"],
                            [("lt-amount", "sum")])
    out = store.resolve_frame(per_user.to_table().to_pandas())
    top = out.sort_values("sum_lt-amount", ascending=False).head(5)
    print(top.to_string(index=False))

    # oracle check
    exp = events.merge(profile, on="user").groupby("user")["amount"].sum()
    got = dict(zip(out["lt-user"], out["sum_lt-amount"]))
    for u, v in exp.items():
        assert abs(got[u] - v) < 1e-2, (u, got[u], v)
    print(f"OK: {len(out)} users, matches pandas")


if __name__ == "__main__":
    main()
