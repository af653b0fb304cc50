"""How the port counts small integer bins on the card with no host read,
and what the choice costs end to end.

    python3 experiments/torch_count_forms.py forms
    python3 experiments/torch_count_forms.py e2e TREE [TREE ...]

``forms`` times four sync-free ways to count the values of an integer
lane into ``nbins`` bins, the value ``nbins`` (the padding) dropped, as
the shuffle's per-shard target counts (``[L, n/L]`` → ``[L, T]``) and the
dense groupby's slot counts (``[n]`` → ``[R + 1]``) need it:

* ``masked``: one ``(x == b).sum(-1)`` per bin;
* ``histc32`` / ``histc64``: ``torch.histc`` of the values (shifted by
  ``row * (nbins + 1)`` for a 2-D lane) in float32 / float64, exact while
  ``value * bins`` is (float32 only up to 4,096 bins in all, the padding
  bin included);
* ``scatter``: ``index_add_`` of ones into the bins;

beside ``torch.bincount`` (which reads the lane's min and max on the
host first) and the port's own ``ops/compact.bincount``.  int64 and
int32 lanes of 4,194,304 and 16,777,216 rows, uniform over
``[0, nbins]``; device times by CUDA events, mean of 10 calls after 2
warm-up calls.

``e2e`` runs, for each ``TREE`` (a checkout root whose
``cylon_tpu_torch`` is measured: ``.``, or a parent commit unpacked with
``git archive`` into a directory ``.gitignore`` lists), one process
that times the paths whose counting changed: the dense groupby
(``dense_key_range``) and the default groupby of 16,777,216 lineitem-
shaped rows at world 4, and the HASH join of 16,777,216 rows a side at
world 8, single-shot and on the allgather lowering.  Each is the median
wall time of 3 runs after one warm-up.  To compare two trees, pass them
in turns: parent, change, change, parent.

Both write JSON under ``chiprun_out/`` and print one line per point.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = (4_194_304, 16_777_216)
DTYPES = (torch.int64, torch.int32)   # the groupby's slots; the shuffle's pids
BINS = (2, 3, 4, 5, 8, 9, 12, 16, 20, 24, 32, 48, 64, 128, 1024, 2048,
        4095, 8192, 16_384, 32_768, 65_536, 1_048_576)
LAYOUTS = (1, 4, 8)          # 1: a flat lane; L: L shards of n/L rows
MASKED_MAX = 32              # bins past which the masked form is not timed
OUT = "chiprun_out"


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _flat(x, nbins):
    if x.dim() == 1:
        return x, nbins + 1
    rows = x.shape[0]
    off = torch.arange(rows, device=x.device, dtype=x.dtype) * (nbins + 1)
    return (x + off[:, None]).reshape(-1), rows * (nbins + 1)


def _crop(c, x, nbins):
    return c[:nbins] if x.dim() == 1 else c.view(x.shape[0], -1)[:, :nbins]


def f_masked(x, nbins):
    return torch.stack([(x == b).sum(-1) for b in range(nbins)], -1)


def f_histc(dtype):
    def run(x, nbins):
        flat, tot = _flat(x, nbins)
        c = torch.histc(flat.to(dtype), bins=tot, min=0, max=tot)
        return _crop(c.to(torch.int64), x, nbins)
    return run


def f_scatter(x, nbins):
    flat, tot = _flat(x, nbins)
    ones = torch.ones((), dtype=torch.int32, device=x.device).expand(
        flat.shape)
    c = torch.zeros((tot,), dtype=torch.int32, device=x.device)
    return _crop(c.index_add_(0, flat, ones).to(torch.int64), x, nbins)


def f_torch(x, nbins):
    flat, tot = _flat(x, nbins)
    return _crop(torch.bincount(flat, minlength=tot), x, nbins)


def forms() -> int:
    from cylon_tpu_torch.ops.compact import bincount
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    points = []
    grid = [(d, n, b) for d in DTYPES for n in ROWS for b in BINS]
    for dtype, n, nbins in grid:
        base = torch.randint(0, nbins + 1, (n,), generator=gen, device=dev,
                             dtype=dtype)
        for L in LAYOUTS:
            if L > 1 and nbins > 64:
                continue      # per-shard counts are over targets
            x = base if L == 1 else base.view(L, -1)
            want = f_torch(x, nbins)
            tot = (nbins + 1) * L
            cands = {"histc64": f_histc(torch.float64),
                     "scatter": f_scatter,
                     "torch_bincount": f_torch,
                     "port": bincount}
            if nbins <= MASKED_MAX:
                cands["masked"] = f_masked
            if (tot - 1) * tot < 1 << 24:
                cands["histc32"] = f_histc(torch.float32)
            row = {"dtype": str(dtype)[6:], "rows": n, "shards": L,
                   "bins": nbins}
            for name, fn in cands.items():
                got = fn(x, nbins)
                if not torch.equal(got.to(torch.int64), want):
                    raise SystemExit(f"{name} disagrees at {row}")
                row[name] = round(cuda_ms(lambda: fn(x, nbins)), 4)
            points.append(row)
            print(json.dumps(row), flush=True)
        del base
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "count_forms.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "points": points}, f, indent=1)
    return 0


def _median_wall(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def e2e_child(tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import cylon_tpu_torch as pt
    from cylon_tpu_torch import config
    from cylon_tpu_torch.parallel import DTable, dist_groupby, dist_join
    assert pt.__file__.startswith(os.path.abspath(tree)), pt.__file__

    n = 16_777_216
    rng = np.random.default_rng(0)
    li = {"orderkey": rng.integers(0, n // 4, n, dtype=np.int64),
          "quantity": rng.integers(1, 51, n, dtype=np.int32),
          "price": rng.uniform(900.0, 105000.0, n),
          "shipdate": rng.integers(0, 2526, n, dtype=np.int32)}
    aggs = [("quantity", "sum"), ("price", "sum"), ("price", "mean"),
            ("price", "count"), ("shipdate", "max")]
    ctx4 = pt.CylonContext(device="cuda", world=4)
    dt = DTable.from_table(ctx4, pt.Table.from_columns(ctx4, li))
    res = {"tree": tree}
    res["groupby_dense_s"] = _median_wall(lambda: dist_groupby(
        dt, ["orderkey"], aggs, dense_key_range=(0, n // 4 - 1)))
    res["groupby_default_s"] = _median_wall(
        lambda: dist_groupby(dt, ["orderkey"], aggs))
    del dt
    ctx8 = pt.CylonContext(device="cuda", world=8)

    def side(name):
        return DTable.from_table(ctx8, pt.Table.from_columns(ctx8, {
            "k": rng.integers(0, n, n).astype(np.int32),
            name: rng.random(n).astype(np.float32)}))
    lt, rt = side("v"), side("w")
    cfg = pt.JoinConfig(pt.JoinType.INNER, pt.JoinAlgorithm.HASH, 0, 0,
                        broadcast_threshold=0)
    res["join_hash_w8_s"] = _median_wall(lambda: dist_join(lt, rt, cfg))
    config.set_exchange_strategy("allgather")
    try:
        res["join_hash_w8_allgather_s"] = _median_wall(
            lambda: dist_join(lt, rt, cfg))
    finally:
        config.set_exchange_strategy(None)
    print("E2E " + json.dumps(res), flush=True)
    return 0


def e2e(trees) -> int:
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "e2e-child", tree],
                             capture_output=True, text=True, check=False)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            return out.returncode
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("E2E ")][-1]
        runs.append(json.loads(line[4:]))
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "count_e2e.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "runs": runs},
                  f, indent=1)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    if cmd == "forms":
        sys.path.insert(0, os.getcwd())
        return forms()
    if cmd == "e2e" and len(sys.argv) > 2:
        return e2e(sys.argv[2:])
    if cmd == "e2e-child" and len(sys.argv) == 3:
        return e2e_child(sys.argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
