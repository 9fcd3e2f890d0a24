"""End-to-end SQL benchmarks on the testdb star schema (testdb.sql analog).

Measures the full pipeline — parse -> plan -> streamed device execution ->
exact host finalization — per BENCH_QUERIES entry, in fact-table rows/s:

  cold : first execution (includes host slicing, H2D upload into the device
         chunk cache, and jit compiles)
  warm : steady state with device-resident chunks (tcache hits)

Each query runs in its own child process, one after another, and this
parent never imports JAX: a JAX process reserves most of the card's memory,
so one process at a time uses the card.  Needs a GPU.

Usage:
    python benchmarks/bench_e2e.py            # all queries, one line each
    python benchmarks/bench_e2e.py <name>     # one query in-process (JSON)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUERIES = ("filter", "agg_nogrp", "agg_group", "join_agg", "star_group",
           "star4way", "sort", "window_rank", "rollup")


def run_one(name: str) -> dict:
    import jax
    import pg_strom_tpu  # noqa: F401
    from benchmarks.peaks import require_gpu
    from pg_strom_tpu.datastore import Database
    from pg_strom_tpu.models.testdb import build_testdb, BENCH_QUERIES
    from pg_strom_tpu.sql import execute

    dev = require_gpu()
    fact = 1 << 22

    db = Database()
    t0 = time.perf_counter()
    build_testdb(db, fact_rows=fact, dim_rows=40_000)
    build_s = time.perf_counter() - t0

    sql = BENCH_QUERIES[name]
    t0 = time.perf_counter()
    first = execute(sql, db).formatted(-3)
    cold_s = time.perf_counter() - t0

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = execute(sql, db).formatted(-3)
        times.append(time.perf_counter() - t0)
        if out != first:
            raise RuntimeError(f"warm result drifted for {name}")
    warm = sorted(times)[len(times) // 2]

    return {"query": name, "fact_rows": fact, "fixture_s": build_s,
            "cold_s": cold_s, "warm_s": warm, "warm_runs_s": times,
            "warm_rows_per_s": fact / warm, "rows_out": len(first),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}}


def main() -> None:
    if len(sys.argv) > 1:
        print(json.dumps(run_one(sys.argv[1])))
        return
    for q in QUERIES:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), q],
                           capture_output=True, text=True, timeout=1800)
        if p.returncode != 0:
            print(f"# {q}: FAILED\n{p.stderr[-2000:]}", file=sys.stderr)
            continue
        print(p.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
