"""Both grouped-reduction formulations of ops/preagg_mxu.mxu_reduce, timed
on one 2^26-row chunk of three GROUP BY shapes:

  flagship   — int4 key (30 values), float4 x, int8 y, WHERE x > 0.25:
               sum(x), count(x), sum(y); dense-key strategy, G = 128
  agg_group  — models/testdb.py: GROUP BY cat: count(*), sum(x), avg(y)
               over float8 x, y; dense-key strategy, G = 128
  rollup     — models/testdb.py: the finest grouping set (cat, cid % 8):
               count(*), sum(x); generic limb-matrix strategy at G = 512
               (the warm executor's bucket count for 208 groups) and
               G = 1024 (its cold start, config.max_groups_device)

Each (shape, formulation) runs in its own child process, one after
another; this parent never imports JAX, so one process at a time uses the
card and a child that runs out of device memory does not affect the next.
Prints one JSON line per child: median and per-run milliseconds of the
compiled program (5 runs after compile), its XLA temp bytes and the
device's peak_bytes_in_use.  Needs a GPU (benchmarks/peaks.py).

Usage:
    python benchmarks/bench_reduce.py                  # every case
    python benchmarks/bench_reduce.py <shape> <route>  # one case, in-process
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 1 << 26
CASES = [("flagship", 128), ("agg_group", 128), ("rollup", 512),
         ("rollup", 1024)]
ROUTES = ("segment_sum", "onehot_dot")


def _program(shape: str, G: int, route: str):
    import jax
    from pg_strom_tpu import T
    from pg_strom_tpu.datastore import Column, column_from_numpy
    from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function
    from pg_strom_tpu.expr.lower_jax import schema_from_chunk_columns
    from pg_strom_tpu.ops.preagg import AggInstance, lookup_agg, \
        build_preagg_fn
    from pg_strom_tpu.models.testdb import _CATS

    rng = np.random.default_rng(0)

    def agg(name, arg):
        d, fam = lookup_agg(name, (arg.type,) if arg is not None else ())
        return AggInstance(aggname=name, family=fam, slots=d.slots,
                           args=(arg,) if arg is not None else ())

    if shape == "flagship":
        data = [(T.INT4, rng.integers(0, 30, N).astype(np.int32),
                 np.ones(N, np.bool_)),
                (T.FLOAT4, rng.random(N).astype(np.float32),
                 rng.random(N) > 0.05),
                (T.INT8, rng.integers(0, 1 << 40, N).astype(np.int64),
                 rng.random(N) > 0.05)]
        names = ["key", "x", "y"]
    else:
        data = [(T.TEXT, rng.integers(0, 26, N).astype(np.int32),
                 np.ones(N, np.bool_)),
                (T.INT4, rng.integers(1, 40_001, N).astype(np.int32),
                 np.ones(N, np.bool_)),
                (T.FLOAT8, rng.random(N) * 100.0, np.ones(N, np.bool_)),
                (T.FLOAT8, rng.random(N) * 100.0, np.ones(N, np.bool_))]
        names = ["cat", "cid", "x", "y"]
    cols = []
    for (t, d, v) in data:
        c = column_from_numpy(t, d[:8], v[:8]) if t is not T.TEXT else \
            Column(type=T.TEXT, data=d[:8], valid=v[:8],
                   dictionary=list(_CATS))
        cols.append(c)
    schema = schema_from_chunk_columns(names, cols)
    ref = {nm: ColumnRef(type=t, name=nm, index=i)
           for i, (nm, (t, _, _)) in enumerate(zip(names, data))}
    if shape == "flagship":
        groups = [ref["key"]]
        pred = resolve_function(">", (ref["x"],
                                      Const(type=T.FLOAT4, value=0.25)))
        aggs = [agg("sum", ref["x"]), agg("count", ref["x"]),
                agg("sum", ref["y"])]
        strategy = "mxu_dense"
    elif shape == "agg_group":
        groups, pred = [ref["cat"]], None
        aggs = [agg("count", None), agg("sum", ref["x"]),
                agg("avg", ref["y"])]
        strategy = "mxu_dense"
    else:
        groups = [ref["cat"], resolve_function(
            "%", (ref["cid"], Const(type=T.INT4, value=8)))]
        pred = None
        aggs = [agg("count", None), agg("sum", ref["x"])]
        strategy = "mxu"
    fn = jax.jit(build_preagg_fn(schema, groups, aggs, pred, G, strategy,
                                 reduce_route=route))
    planes = tuple((jax.device_put(d), jax.device_put(v))
                   for _, d, v in data)
    return fn, (planes, np.int32(N), np.uint64(0))


def run_one(shape: str, G: int, route: str) -> dict:
    import jax
    from benchmarks.peaks import require_gpu
    dev = require_gpu()
    fn, args = _program(shape, G, route)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return {"shape": shape, "G": G, "route": route, "rows": N,
            "median_ms": float(np.median(times)), "runs_ms": times,
            "compile_s": compile_s,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "peak_bytes_in_use": (dev.memory_stats() or {}).get(
                "peak_bytes_in_use"),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}}


def main() -> None:
    if len(sys.argv) == 4:
        print(json.dumps(run_one(sys.argv[1], int(sys.argv[2]),
                                 sys.argv[3])), flush=True)
        return
    for shape, G in CASES:
        for route in ROUTES:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                shape, str(G), route], cwd=ROOT,
                               capture_output=True, text=True, timeout=900)
            out = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
            if r.returncode != 0 or not out:
                tail = r.stderr.strip().splitlines()[-3:]
                print(json.dumps({"shape": shape, "G": G, "route": route,
                                  "error": " | ".join(tail)[-600:]}),
                      flush=True)
                continue
            print(out[-1], flush=True)


if __name__ == "__main__":
    main()
