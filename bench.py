"""Benchmark: flagship operator throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rows/s", "vs_baseline": F,
   "device": {...}}

The headline metric is fused filter+grouped-aggregate rows/s on
device-resident columnar data (the GpuPreAgg hot path), measured through
the same program the executor dispatches for this query shape (the dense
single-key strategy of ops/preagg.py).  vs_baseline normalizes against the
HBM-bandwidth speed-of-light for the bytes each row reads (peaks in
benchmarks/peaks.py), so 1.0 = memory-bound perfection on this device.

Needs a GPU: on any other device it exits non-zero without a headline.
The first-result latency through the small-tier program (the devprog
fallback tier the executor uses while big programs build, see
utils/devprog.py) is reported on stderr separately from the big chunk.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main() -> None:
    sys.path.insert(0, ".")
    t_start = time.perf_counter()
    import pg_strom_tpu  # noqa: F401
    import jax
    from benchmarks.peaks import device_peaks, require_gpu

    dev = require_gpu()
    peaks = device_peaks(dev)

    from pg_strom_tpu import T
    from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function
    from pg_strom_tpu.expr.lower_jax import schema_from_chunk_columns
    from pg_strom_tpu.datastore import column_from_numpy
    from pg_strom_tpu.ops.preagg import AggInstance, lookup_agg, \
        build_preagg_fn

    # 2^26 matches the executor's large-chunk config (config.chunk_rows)
    N = 1 << 26
    N_SMALL = 1 << 24                           # devprog fallback tier

    # flagship: SELECT key, sum(x), count(x), sum(y) FROM t WHERE x > 0.25
    #           GROUP BY key     (int32 key, f32 x, i64 y)
    rng = np.random.default_rng(0)
    key_np = rng.integers(0, 30, N).astype(np.int32)
    x_np = rng.random(N).astype(np.float32)
    xv_np = rng.random(N) > 0.05
    y_np = rng.integers(0, 1 << 40, N).astype(np.int64)
    yv_np = rng.random(N) > 0.05
    cols_host = [column_from_numpy(T.INT4, key_np),
                 column_from_numpy(T.FLOAT4, x_np, xv_np),
                 column_from_numpy(T.INT8, y_np, yv_np)]
    names = ["key", "x", "y"]
    schema = schema_from_chunk_columns(names, cols_host)
    key = ColumnRef(type=T.INT4, name="key", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    y = ColumnRef(type=T.INT8, name="y", index=2)
    pred = resolve_function(">", (x, Const(type=T.FLOAT4, value=0.25)))
    insts = []
    for aggname, arg in (("sum", x), ("count", x), ("sum", y)):
        d, fam = lookup_agg(aggname, (arg.type,))
        insts.append(AggInstance(aggname=aggname, family=fam,
                                 slots=d.slots, args=(arg,)))

    # the executor's program for this shape: dense single-key strategy
    # at its bucket floor (preagg_exec: G >= 128 covers the 30 keys)
    G = 128
    fn = jax.jit(build_preagg_fn(schema, [key], insts, pred, G,
                                 strategy="mxu_dense"))

    def mk_args(n):
        return ((jax.device_put(key_np[:n]),
                 jax.device_put(np.ones(n, dtype=np.bool_))),
                (jax.device_put(x_np[:n]), jax.device_put(xv_np[:n])),
                (jax.device_put(y_np[:n]), jax.device_put(yv_np[:n])))

    # --- first result through the SMALL tier (the devprog fallback the
    # executor serves while the big program builds)
    cols_s = mk_args(N_SMALL)
    out = fn(cols_s, np.int32(N_SMALL), np.uint64(0))
    err = int(jax.device_get(out["err"]))
    t_first = time.perf_counter() - t_start
    print(f"# first result (small tier, {N_SMALL} rows, upload+compile+run):"
          f" {t_first:.1f}s err={err}", file=sys.stderr)

    # --- big-chunk program build + first execution
    t0 = time.perf_counter()
    cols_b = mk_args(N)
    t_up = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn(cols_b, np.int32(N), np.uint64(0))
    err = int(jax.device_get(out["err"]))
    t_big = time.perf_counter() - t0
    print(f"# big tier: upload {t_up:.1f}s, compile+first+fetch {t_big:.1f}s"
          f" err={err}", file=sys.stderr)

    # steady-state throughput: dispatch a window of chunks, block once —
    # the executor pipelines chunks exactly this way (min/max_async_chunks).
    # Median of 5 windows, with the spread on stderr.
    window = 8
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        outs = [fn(cols_b, np.int32(N), np.uint64(0)) for _ in range(window)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / window)
    dt = float(np.median(times))
    rows_per_s = N / dt

    # speed-of-light: bytes read per row (key data+valid, x data+valid,
    # y data+valid)
    bytes_per_row = 4 + 1 + 4 + 1 + 8 + 1
    sol_rows = peaks["hbm_bytes_per_s"] / bytes_per_row
    vs = rows_per_s / sol_rows
    print(f"# sol assumption: {peaks['hbm_bytes_per_s']/1e9:.0f} GB/s HBM "
          f"for device_kind={dev.device_kind!r}, {bytes_per_row} B/row",
          file=sys.stderr)
    print(f"# device={dev} N={N} median={dt*1e3:.3f}ms "
          f"windows_ms={[round(t * 1e3, 3) for t in times]}",
          file=sys.stderr)

    headline = {
        "metric": "preagg_filter_group_rows_per_s",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "vs_baseline": round(vs, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    # ONE short parseable line
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
