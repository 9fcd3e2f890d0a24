"""Per-operator GPU benchmarks: filter / join / agg / sort, in rows/s.

Each operator runs in its own child process, one after another, and this
parent never imports JAX: a JAX process reserves most of the card's memory,
so one process at a time uses the card.  Needs a GPU (benchmarks/peaks.py).

Usage:
    python benchmarks/bench_ops.py            # run all ops, one line each
    python benchmarks/bench_ops.py <op>       # run one op in-process
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPS = ("filter", "join", "join_ident", "agg", "sort", "sort_wide")


def bench_call(call, nbuf, rounds=5, window=8):
    """(compile+first-run seconds, median seconds per call, per-window
    seconds).  A window of calls is dispatched and blocked on once — the
    executors pipeline device-resident chunks the same way."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(call(0))
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(rounds):
        t0 = time.perf_counter()
        outs = [call((i * window + j) % nbuf) for j in range(window)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / window)
    return compile_s, float(np.median(times)), times


def run_filter():
    """Scan-filter: predicate eval + compacted row index output (GpuScan)."""
    import jax
    import pg_strom_tpu  # noqa: F401
    from pg_strom_tpu import T
    from pg_strom_tpu.expr.ir import (ColumnRef, Const, BoolExpr,
        resolve_function)
    from pg_strom_tpu.expr.lower_jax import ColMeta
    from pg_strom_tpu.ops.filter import build_filter_mask_fn

    N = 1 << 26
    schema = [ColMeta("x", T.FLOAT4), ColMeta("y", T.INT4)]
    x = ColumnRef(type=T.FLOAT4, name="x", index=0)
    y = ColumnRef(type=T.INT4, name="y", index=1)
    pred = BoolExpr(type=T.BOOL, op="and", args=(
        resolve_function(">", (x, Const(type=T.FLOAT4, value=0.25))),
        resolve_function("<", (y, Const(type=T.INT4, value=900)))))
    fn = jax.jit(build_filter_mask_fn(pred, schema))
    rng = np.random.default_rng(0)
    colsets = []
    for s in range(3):
        colsets.append((
            (jax.device_put(rng.random(N).astype(np.float32)),
             jax.device_put(rng.random(N) > 0.02)),
            (jax.device_put(rng.integers(0, 1000, N).astype(np.int32)),
             jax.device_put(np.ones(N, np.bool_))),
        ))
    c, dt, ts = bench_call(lambda i: fn(colsets[i], np.int32(N)), 3)
    bpr = 4 + 1 + 4 + 1              # x, vx, y, vy in; 1-bit mask out
    return N, c, dt, ts, bpr


def run_join_ident():
    """Join probe, serial-PK identity build (the star-schema common case —
    reference testdb dims are serial PKs): probe is pure lane arithmetic
    (ht['dense_ident'], ops/hashjoin.py), no table access."""
    return _run_join_impl(identity=True)


def run_join():
    """Hash join probe, GENERAL dense build: 64k-row unique-key build
    (permuted — NOT a serial PK, so the direct-address gather runs),
    2^26-row probe."""
    return _run_join_impl(identity=False)


def _run_join_impl(identity: bool):
    import jax
    import pg_strom_tpu  # noqa: F401
    from pg_strom_tpu import T
    from pg_strom_tpu.expr.ir import ColumnRef
    from pg_strom_tpu.expr.lower_jax import ColMeta
    from pg_strom_tpu.ops.hashjoin import (
        build_hash_table, build_probe_dense_fn, dense_cap_for)

    NB, NP_ = 1 << 16, 1 << 26
    bschema = [ColMeta("k", T.INT4)]
    pschema = [ColMeta("k", T.INT4)]
    bk = ColumnRef(type=T.INT4, name="k", index=0)
    rng = np.random.default_rng(0)
    bkeys = np.arange(NB, dtype=np.int32)
    if not identity:
        bkeys = rng.permutation(bkeys)       # unique, same window, not a PK
    bcols = ((jax.device_put(bkeys),
              jax.device_put(np.ones(NB, np.bool_))),)
    btab = jax.jit(build_hash_table(bschema, [bk]))(bcols, np.int32(NB))
    assert bool(btab["dense_ok"])
    # same path selection as the executor: identity (serial-PK) fast path
    # first, else one gather from the direct-address table
    use_ident = bool(btab["dense_ident"])
    assert use_ident == identity
    probe = jax.jit(build_probe_dense_fn(pschema, [bk], dense_cap_for(NB),
                                         use_ident=use_ident))
    ht = btab
    pc = []
    for s in range(3):
        pc.append(((jax.device_put(rng.integers(0, NB, NP_).astype(np.int32)),
                    jax.device_put(np.ones(NP_, np.bool_))),))
    c, dt, ts = bench_call(lambda i: probe(ht, pc[i], np.int32(NP_)), 3)
    bpr = 4 + 1 + 4 + 1              # probe key+valid in, build_row+match out
    return NP_, c, dt, ts, bpr


def run_agg():
    """Fused filter + grouped aggregate at the flagship shape/chunk size
    (same program bench.py measures)."""
    import jax
    import pg_strom_tpu  # noqa: F401
    from pg_strom_tpu import T
    from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function
    from pg_strom_tpu.expr.lower_jax import schema_from_chunk_columns
    from pg_strom_tpu.datastore import column_from_numpy
    from pg_strom_tpu.ops.preagg import AggInstance, lookup_agg, \
        build_preagg_fn

    N = 1 << 26
    rng = np.random.default_rng(0)
    key_np = rng.integers(0, 30, N).astype(np.int32)
    x_np = rng.random(N).astype(np.float32)
    xv_np = rng.random(N) > 0.05
    y_np = rng.integers(0, 1 << 40, N).astype(np.int64)
    yv_np = rng.random(N) > 0.05
    cols_host = [column_from_numpy(T.INT4, key_np),
                 column_from_numpy(T.FLOAT4, x_np, xv_np),
                 column_from_numpy(T.INT8, y_np, yv_np)]
    schema = schema_from_chunk_columns(["key", "x", "y"], cols_host)
    key = ColumnRef(type=T.INT4, name="key", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    y = ColumnRef(type=T.INT8, name="y", index=2)
    pred = resolve_function(">", (x, Const(type=T.FLOAT4, value=0.25)))
    insts = []
    for aggname, arg in (("sum", x), ("count", x), ("sum", y)):
        d, fam = lookup_agg(aggname, (arg.type,))
        insts.append(AggInstance(aggname=aggname, family=fam,
                                 slots=d.slots, args=(arg,)))
    fn = jax.jit(build_preagg_fn(schema, [key], insts, pred, 128,
                                 strategy="mxu_dense"))
    cols = ((jax.device_put(key_np), jax.device_put(np.ones(N, np.bool_))),
            (jax.device_put(x_np), jax.device_put(xv_np)),
            (jax.device_put(y_np), jax.device_put(yv_np)))
    c, dt, ts = bench_call(lambda i: fn(cols, np.int32(N), np.uint64(0)), 1)
    bpr = 4 + 1 + 4 + 1 + 8 + 1
    return N, c, dt, ts, bpr


def run_sort():
    """ORDER BY permutation over 4M rows, two keys (int4 desc, f32 asc)."""
    import jax
    import pg_strom_tpu  # noqa: F401
    from pg_strom_tpu import T
    from pg_strom_tpu.expr.ir import ColumnRef
    from pg_strom_tpu.expr.lower_jax import ColMeta
    from pg_strom_tpu.ops.sort import build_sort_fn, SortSpec

    N = 1 << 24
    schema = [ColMeta("a", T.INT4), ColMeta("b", T.INT8)]
    a = ColumnRef(type=T.INT4, name="a", index=0)
    b = ColumnRef(type=T.INT8, name="b", index=1)
    specs = [SortSpec(a, descending=True), SortSpec(b)]
    fn = jax.jit(build_sort_fn(schema, specs))
    rng = np.random.default_rng(0)
    cs = []
    for s in range(3):
        cs.append((
            (jax.device_put(rng.integers(0, 10000, N).astype(np.int32)),
             jax.device_put(rng.random(N) > 0.02)),
            (jax.device_put(rng.integers(0, 10**6, N).astype(np.int64)),
             jax.device_put(np.ones(N, np.bool_))),
        ))
    # the adaptive single-pass must fit these runtime key ranges; a
    # non-fitting set redispatches the static-pass program (retry contract)
    _, _, fits = fn(cs[0], np.int32(N))
    if not bool(np.asarray(jax.device_get(fits))):
        fn = jax.jit(build_sort_fn(schema, specs, adaptive=False))
    c, dt, ts = bench_call(lambda i: fn(cs[i], np.int32(N)), 3)
    bpr = 4 + 1 + 8 + 1
    return N, c, dt, ts, bpr


def run_sort_wide():
    """Worst-case wide-key ORDER BY: three int8 keys spanning 2^32 each —
    too wide for one packed word, runs the TWO-word lexicographic tier
    (ops/sort._argsort_adaptive2; round-2 wide sorts fell to LSD passes +
    composition gathers at 31 Mrows/s)."""
    import jax
    import pg_strom_tpu  # noqa: F401
    from pg_strom_tpu import T
    from pg_strom_tpu.expr.ir import ColumnRef
    from pg_strom_tpu.expr.lower_jax import ColMeta
    from pg_strom_tpu.ops.sort import build_sort_fn, SortSpec

    N = 1 << 24
    schema = [ColMeta("a", T.INT8), ColMeta("b", T.INT8),
              ColMeta("c", T.INT8)]
    cols = [ColumnRef(type=T.INT8, name=nm, index=i)
            for i, nm in enumerate("abc")]
    specs = [SortSpec(cols[0], descending=True), SortSpec(cols[1]),
             SortSpec(cols[2])]
    rng = np.random.default_rng(0)
    cs = []
    for s in range(3):
        cs.append(tuple(
            (jax.device_put(rng.integers(0, 1 << 32, N).astype(np.int64)),
             jax.device_put(np.ones(N, np.bool_)))
            for _ in range(3)))
    fn1 = jax.jit(build_sort_fn(schema, specs))
    _, _, fits = fn1(cs[0], np.int32(N))
    assert not bool(np.asarray(jax.device_get(fits))), \
        "wide shape unexpectedly fit one word"
    fn = jax.jit(build_sort_fn(schema, specs, adaptive=2))
    _, _, fits2 = fn(cs[0], np.int32(N))
    assert bool(np.asarray(jax.device_get(fits2))), \
        "wide shape must fit the two-word tier"
    c, dt, ts = bench_call(lambda i: fn(cs[i], np.int32(N)), 3)
    bpr = 3 * (8 + 1)
    return N, c, dt, ts, bpr


def main():
    if len(sys.argv) > 1:
        import jax
        from benchmarks.peaks import device_peaks, require_gpu
        dev = require_gpu()
        hbm = device_peaks(dev)["hbm_bytes_per_s"]
        op = sys.argv[1]
        n, c, dt, ts, bpr = {"filter": run_filter, "join": run_join,
                             "join_ident": run_join_ident,
                             "agg": run_agg, "sort": run_sort,
                             "sort_wide": run_sort_wide}[op]()
        # vs_baseline = fraction of the HBM speed-of-light for the bytes
        # each row touches; bytes_per_row states the derivation
        print(json.dumps({
            "op": op, "rows_per_s": n / dt, "ms": dt * 1e3,
            "windows_ms": [t * 1e3 for t in ts],
            "compile_s": c, "bytes_per_row": bpr,
            "vs_baseline": (n / dt) / (hbm / bpr),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}}), flush=True)
        return
    here = os.path.dirname(os.path.abspath(__file__))
    for op in OPS:
        r = subprocess.run([sys.executable, __file__, op],
                           cwd=os.path.dirname(here), capture_output=True,
                           text=True, timeout=1800)
        out = [line for line in r.stdout.splitlines()
               if line.startswith("{")]
        if r.returncode != 0 or not out:
            sys.stderr.write(r.stderr[-2000:] + "\n")
            print(json.dumps({"op": op, "error": True}), flush=True)
            continue
        print(out[-1], flush=True)


if __name__ == "__main__":
    main()
