#!/usr/bin/env python3
"""Smoke test of the SQL engine's main path on an NVIDIA GPU.

    python3 chip_smoke.py               # one card (the default)
    python3 chip_smoke.py --cards 4     # the distributed path on four cards

One card: loads the star-schema testdb (models/testdb.py) at 10^8 fact rows
through `Database`, runs every BENCH_QUERIES entry through `sql.execute`
cold and warm, and checks

  1. load      — the device bytes resident after the first query;
  2. queries   — warm output == cold output, every query ran a device
                 program (perfmon kernel counts), CPU_RECHECK replays;
  3. reference — every result against numpy over the generated arrays
                 (no engine code involved);
  4. parity    — a 2^18-row testdb through the device path and the
                 host-exact tier (pg_strom.enabled = off): PostgreSQL text
                 output identical at extra_float_digits = -3;
  5. kernels   — at 2^26 rows, both grouped-reduction formulations
                 (ops/preagg_mxu.mxu_reduce) and the dense-probe gather
                 against numpy, with their times.

Four cards (--cards 4): pg_strom.distributed over a flat 4-device mesh —
star_group, agg_group, sort, star4way and a join whose hottest key holds 90%
of the fact rows — against numpy, with the exchange time read from a
profiler trace (written under traces/ in the checkout).  Nothing else runs.

It needs a GPU: with none, it exits non-zero and prints no result.  Any
failed check exits non-zero.  The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
--rehearse-on-cpu runs the same phases on CPU devices at the given sizes
(for checking the script itself) and then exits 3 without a result line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIM_ROWS = 40_000            # the reference testdb's dimension size


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise SmokeFailure(f"nvidia-smi not runnable: {e}") from e
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# numpy reference: BENCH_QUERIES over the generated arrays
# ---------------------------------------------------------------------------

class ExactSums:
    """Correctly rounded float64 sums of one column over any rows and
    groups, whatever the order of the rows.

    Every double is M * 2^(e - 53) with |M| < 2^53 an integer (np.frexp).
    |M| is cut into three 18-bit limbs.  Per (group, exponent) a limb sum
    stays below 2^18 * rows, under 2^53 for fewer than 2^35 rows, so
    np.bincount's float64 accumulation adds the limbs without rounding.
    Python integers then put the limb sums together, and one int / int
    division (correctly rounded in Python) rounds the total once."""

    LIMB = 18

    def __init__(self, v: np.ndarray):
        check(len(v) < 1 << 35, "ExactSums: too many rows for exact limbs")
        m, e = np.frexp(np.asarray(v, np.float64))
        mant = (m * 2.0 ** 53).astype(np.int64)      # exact: |m| < 1
        self.emin = int(e.min()) if len(e) else 0
        self.ne = (int(e.max()) - self.emin + 1) if len(e) else 1
        self.eoff = (e - self.emin).astype(np.int64)
        sign = np.sign(mant).astype(np.float64)
        mag = np.abs(mant)
        mask = (1 << self.LIMB) - 1
        self.limbs = [((mag >> (self.LIMB * k)) & mask) * sign
                      for k in range(3)]

    def sums(self, rows=None, groups=None, G: int = 1) -> list[float]:
        """Per-group sums over the rows selected by the boolean `rows`;
        `groups` holds each row's group in [0, G) (None: one group)."""
        key = self.eoff if groups is None else \
            np.asarray(groups, np.int64) * self.ne + self.eoff
        limbs = self.limbs
        if rows is not None:
            key = key[rows]
            limbs = [lb[rows] for lb in limbs]
        parts = [np.bincount(key, weights=lb, minlength=G * self.ne)
                 .astype(np.int64).reshape(G, self.ne) for lb in limbs]
        out = []
        for g in range(G):
            tot = 0
            for j in range(self.ne):
                c = sum(int(p[g, j]) << (self.LIMB * k)
                        for k, p in enumerate(parts))
                tot += c << j
            s = self.emin - 53                       # total * 2^s
            out.append(tot / (1 << -s) if s < 0 else float(tot << s))
        return out


def sum_tolerance(n: int) -> float:
    """Relative error bound of the engine's float8 sums (and averages) of
    n terms of one sign, against the exactly rounded sum.

    - The integer-limb route (ops/preagg_mxu) splits each value into an
      f32 head and an f32 tail; the tail keeps 24 of its 29 bits, so each
      term carries up to 2^-47 of itself.  The limb sum of those terms is
      exact and rounded once.
    - The sort strategy and the distributed step add along a fixed tree:
      each term passes through at most ceil(log2 n) roundings of 2^-53.
    - Chunk and shard partials are then added on the host, one rounding
      each (at most 4 here), and an average divides once.
    The reference is exactly rounded, so the whole bound is the engine's.
    For terms of one sign these relative errors add up."""
    d = max(int(n), 2).bit_length() + 4 + 1
    return 2.0 ** -47 + d * 2.0 ** -53


# per output column: 'e' exact, 'f' float8 sum/average: exactly rounded in
# the reference, held to sum_tolerance() in the engine (every summed
# column of the testdb is >= 0)
def numpy_reference(db, names) -> dict:
    f = {nm: c.data for nm, c in db.tables["t0"].columns.items()}
    cats = list(db.tables["t0"].columns["cat"].dictionary)
    cat, x, y = f["cat"], f["x"], f["y"]
    n = len(x)
    ex, ey = ExactSums(x), ExactSums(y)

    def filter_():
        m = (x < 25.0) & (y > 10.0)
        return "ef", [(int(m.sum()), ex.sums(m)[0])]

    def agg_nogrp():
        return "eff", [(n, ex.sums()[0], ey.sums()[0] / n)]

    def agg_group():
        cnt = np.bincount(cat, minlength=26)
        sx = ex.sums(groups=cat, G=26)
        sy = ey.sums(groups=cat, G=26)
        return "eeff", [(cats[c], int(cnt[c]), sx[c], sy[c] / int(cnt[c]))
                        for c in range(26) if cnt[c]]

    def join_agg():
        m = x < 50.0                     # every aid has its t1 row
        return "ef", [(int(m.sum()), ex.sums(m)[0])]

    def star_group():
        g = f["aid"] % 40
        cnt = np.bincount(g, minlength=40)
        sx = ex.sums(groups=g, G=40)
        return "eef", [(k, int(cnt[k]), sx[k]) for k in range(40) if cnt[k]]

    def star4way():
        return "eff", [(n, ex.sums()[0], ey.sums()[0])]

    def sort():
        top = np.lexsort((f["id"], -x))[:100]      # x desc; ties by id
        return "ee", [(int(f["id"][i]), float(x[i])) for i in top]

    def window_rank():
        m = y > 5.0
        maxr = 0
        for c in range(26):
            xs = x[m & (cat == c)]
            if len(xs):
                # rank of the partition's smallest x = 1 + rows above it
                maxr = max(maxr, 1 + int((xs > xs.min()).sum()))
        return "eee", [(int(m.sum()), maxr, 1)]

    def rollup():
        key = cat.astype(np.int64) * 8 + f["cid"] % 8
        cnt = np.bincount(key, minlength=26 * 8)
        sx = ex.sums(groups=key, G=26 * 8)
        rows = [(cats[k // 8], k % 8, int(cnt[k]), sx[k])
                for k in range(26 * 8) if cnt[k]]
        ccnt = np.bincount(cat, minlength=26)
        csx = ex.sums(groups=cat, G=26)
        rows += [(cats[c], None, int(ccnt[c]), csx[c])
                 for c in range(26) if ccnt[c]]
        rows.append((None, None, n, ex.sums()[0]))
        return "eeef", rows

    fns = {"filter": filter_, "agg_nogrp": agg_nogrp, "agg_group": agg_group,
           "join_agg": join_agg, "star_group": star_group,
           "star4way": star4way, "sort": sort, "window_rank": window_rank,
           "rollup": rollup}
    return {nm: fns[nm]() for nm in names}


def _unordered_key(r):
    return tuple((v is None, v) for v in r[:-2])


def compare_rows(name: str, got: list, want: tuple, nterms: int,
                 unordered: bool = False) -> int:
    """Engine rows against the reference; returns how many float cells
    are not bit-equal to the exactly rounded value (each within
    sum_tolerance(nterms))."""
    kinds, rows = want
    got = [tuple(r) for r in got]
    if unordered:
        got = sorted(got, key=_unordered_key)
        rows = sorted(rows, key=_unordered_key)
    check(len(got) == len(rows),
          f"{name}: {len(got)} rows, reference has {len(rows)}")
    tol = sum_tolerance(nterms)
    inexact = 0
    for i, (g, w) in enumerate(zip(got, rows)):
        check(len(g) == len(kinds), f"{name}: row {i} has {len(g)} columns")
        for j, (gv, wv, k) in enumerate(zip(g, w, kinds)):
            if k == "f" and gv is not None and wv is not None:
                ok = abs(float(gv) - wv) <= tol * abs(wv)
                inexact += float(gv) != wv
            else:
                ok = gv == wv
            check(ok, f"{name}: row {i} col {j}: engine {gv!r}, "
                      f"numpy {wv!r}")
    return inexact


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

_KERNEL_RE = re.compile(r"kernel (\S+): total [\d.]+ms, calls (\d+)")
_COUNT_RE = re.compile(r"^\s*(\w+): (\d+)$")


def explain_counts(execute, sql: str, db) -> tuple[dict, dict]:
    """(kernel -> calls, counter -> value) from EXPLAIN ANALYZE."""
    lines = [r[0] for r in execute("explain analyze " + sql, db).rows]
    kernels, counters = {}, {}
    for ln in lines:
        m = _KERNEL_RE.search(ln)
        if m:
            kernels[m.group(1)] = int(m.group(2))
            continue
        m = _COUNT_RE.match(ln)
        if m:
            counters[m.group(1)] = int(m.group(2))
        m = re.search(r"cpu_fallback: total [\d.]+ms, calls (\d+)", ln)
        if m:
            counters["cpu_fallback_calls"] = int(m.group(1))
    return kernels, counters


def set_cache_budget(db) -> None:
    """Keep t0 device-resident: its planes pad to whole 2^26-row chunks
    (10^8 rows -> 2 x 2^26 x 69 B = 9.3 GB), above the default 8 GiB
    pg_strom.tcache_size_mb, which would stream every query from the
    host.  16 GiB is what a deployment on a 141 GB card would set."""
    from pg_strom_tpu.sql import execute
    execute("set pg_strom.tcache_size_mb = 16384", db)


def phase_load(fact_rows: int):
    from pg_strom_tpu.datastore import Database
    from pg_strom_tpu.models.testdb import build_testdb
    db = Database()
    t0 = time.perf_counter()
    build_testdb(db, fact_rows=fact_rows, dim_rows=DIM_ROWS, seed=0)
    log(f"[load] testdb fact_rows={fact_rows} dim_rows={DIM_ROWS} "
        f"built in {time.perf_counter() - t0:.3f}s")
    return db


def phase_queries(db, names) -> dict:
    import jax
    from pg_strom_tpu.models.testdb import BENCH_QUERIES
    from pg_strom_tpu.sql import execute
    results = {}
    dev = jax.devices()[0]
    for i, name in enumerate(names):
        sql = BENCH_QUERIES[name]
        t0 = time.perf_counter()
        cold = execute(sql, db)
        cold_s = time.perf_counter() - t0
        if i == 0:
            st = dev.memory_stats() or {}
            log(f"[load] device bytes in use after the first query: "
                f"{st.get('bytes_in_use')} (peak {st.get('peak_bytes_in_use')})")
        # EXPLAIN ANALYZE runs second: it may still compile (the executors
        # right-size their bucket count from the groups the cold run saw),
        # so the timed warm run comes after it
        kernels, counters = explain_counts(execute, sql, db)
        check(sum(kernels.values()) > 0,
              f"{name}: no device program ran (kernels {kernels})")
        t0 = time.perf_counter()
        warm = execute(sql, db)
        warm_s = time.perf_counter() - t0
        check(warm.formatted(-3) == cold.formatted(-3),
              f"{name}: warm output differs from cold output")
        log(f"[query] {name}: cold {cold_s:.6f}s warm {warm_s:.6f}s "
            f"rows {len(cold.rows)} kernels {kernels} "
            f"recheck_chunks {counters.get('recheck_chunks', 0)} "
            f"cpu_fallback_calls {counters.get('cpu_fallback_calls', 0)} "
            f"counters {counters}")
        results[name] = cold.rows
    return results


def phase_reference(db, results: dict) -> None:
    t0 = time.perf_counter()
    ref = numpy_reference(db, list(results))
    n = db.tables["t0"].nrows
    inexact = {name: compare_rows(name, rows, ref[name], n,
                                  unordered=(name == "rollup"))
               for name, rows in results.items()}
    log(f"[reference] {len(results)} queries match numpy (exact; float8 "
        f"sums/averages within {sum_tolerance(n):.3e} relative of the "
        f"exactly rounded value); float cells not bit-equal to it: "
        f"{inexact} ({time.perf_counter() - t0:.3f}s)")


def _pg_text(v) -> str:
    """PostgreSQL's text for a reference value at extra_float_digits = -3
    (float8out: "%.*g" with DBL_DIG - 3 = 12 digits; NULL prints empty)."""
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.12g}"
    return str(v)


def _within_bound_texts(w: float, tol: float) -> set:
    """The texts a float within tol (relative) of w can print as."""
    return {_pg_text(w), _pg_text(w * (1 - tol)), _pg_text(w * (1 + tol))}


def phase_parity(parity_rows: int) -> None:
    """Device text == host-exact text, character for character, except in
    float8 sum/average cells: PostgreSQL adds in scan order, the engine in
    its own order (sum_tolerance), so where the sum sits near a rounding
    boundary of the printed digits the last digit may differ.  There the
    device's cell must print the exact sum to within the engine's bound,
    and every other cell of the line must be identical."""
    from pg_strom_tpu.datastore import Database
    from pg_strom_tpu.models.testdb import build_testdb, BENCH_QUERIES
    from pg_strom_tpu.sql import execute
    db = Database()
    build_testdb(db, fact_rows=parity_rows, dim_rows=DIM_ROWS, seed=0)
    t0 = time.perf_counter()
    ref = numpy_reference(db, list(BENCH_QUERIES))
    tol = sum_tolerance(parity_rows)
    nlines = 0
    differ = []
    for name, sql in BENCH_QUERIES.items():
        dev = execute(sql, db).formatted(-3)
        execute("set pg_strom.enabled = off", db)
        try:
            host = execute(sql, db).formatted(-3)
        finally:
            execute("set pg_strom.enabled = on", db)
        kinds, rrows = ref[name]
        # reference rows keyed by their printed exact cells
        keyed = {tuple(_pg_text(v) for v, k in zip(r, kinds) if k != "f"): r
                 for r in rrows}
        if name == "rollup":             # no ORDER BY: compare as sets
            dev, host = sorted(dev), sorted(host)
        check(len(dev) == len(host) == len(rrows),
              f"parity {name}: {len(dev)} device rows, {len(host)} host, "
              f"{len(rrows)} reference")
        for a, b in zip(dev, host):
            if a == b:
                continue
            ca, cb = a.split("|"), b.split("|")
            check(len(ca) == len(cb) == len(kinds),
                  f"parity {name}: device {a!r}, host-exact {b!r}")
            r = keyed.get(tuple(c for c, k in zip(ca, kinds) if k != "f"))
            ok = r is not None and all(
                x == y or (k == "f" and x in _within_bound_texts(v, tol))
                for x, y, k, v in zip(ca, cb, kinds, r))
            check(ok, f"parity {name}: device {a!r}, host-exact {b!r}, "
                      f"reference {r!r}")
            differ.append(f"{name}: device {a!r} host {b!r} exact "
                          f"{'|'.join(_pg_text(v) for v in r)!r}")
        nlines += len(dev)
    log(f"[parity] {len(BENCH_QUERIES)} queries, {nlines} lines at "
        f"{parity_rows} fact rows, extra_float_digits=-3: "
        f"{nlines - len(differ)} identical, {len(differ)} differ only in "
        f"float8 sum/average cells, each within {tol:.3e} relative of the "
        f"exact sum {differ} ({time.perf_counter() - t0:.3f}s)")


def _median_time(fn, runs: int = 5) -> tuple[float, list]:
    import jax
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def phase_kernels(n: int) -> None:
    """Flagship GROUP BY through both grouped-reduction formulations, and
    the dense-probe gather, at n rows against numpy."""
    import jax
    from pg_strom_tpu import T, backend
    from pg_strom_tpu.datastore import column_from_numpy
    from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function
    from pg_strom_tpu.expr.lower_jax import ColMeta, schema_from_chunk_columns
    from pg_strom_tpu.ops.preagg import (AggInstance, lookup_agg,
                                         build_preagg_fn, extract_partials,
                                         merge_partials)
    from pg_strom_tpu.ops.preagg_mxu import (mxu_absorb, mxu_recipes,
                                             mxu_shadow_cols)
    from pg_strom_tpu.exec.hostexec import canon_group_key
    from pg_strom_tpu.ops.hashjoin import (build_hash_table,
                                           build_probe_dense_fn,
                                           dense_cap_for)

    dev = jax.devices()[0]
    rng = np.random.default_rng(1)
    key_np = rng.integers(0, 30, n).astype(np.int32)
    x_np = rng.random(n).astype(np.float32)
    xv_np = rng.random(n) > 0.05
    y_np = rng.integers(0, 1 << 40, n).astype(np.int64)
    yv_np = rng.random(n) > 0.05
    names = ["key", "x", "y"]
    schema = schema_from_chunk_columns(names, [
        column_from_numpy(T.INT4, key_np[:8]),
        column_from_numpy(T.FLOAT4, x_np[:8]),
        column_from_numpy(T.INT8, y_np[:8])])
    key = ColumnRef(type=T.INT4, name="key", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    y = ColumnRef(type=T.INT8, name="y", index=2)
    pred = resolve_function(">", (x, Const(type=T.FLOAT4, value=0.25)))
    insts = []
    for aggname, arg in (("sum", x), ("count", x), ("sum", y)):
        d, fam = lookup_agg(aggname, (arg.type,))
        insts.append(AggInstance(aggname=aggname, family=fam,
                                 slots=d.slots, args=(arg,)))
    cols = tuple((jax.device_put(d), jax.device_put(v)) for d, v in (
        (key_np, np.ones(n, np.bool_)), (x_np, xv_np), (y_np, yv_np)))

    # numpy reference: exact integers; the float4 sum is exact in float64
    # too (values in [0.25, 1) are multiples of 2^-26 and partial sums stay
    # below 2^22, so no float64 partial sum rounds)
    okx = (x_np > np.float32(0.25)) & xv_np     # a NULL x fails the filter
    oky = okx & yv_np
    want = {}
    for k in range(30):
        sel = key_np == k
        want[k] = (float(x_np[sel & okx].astype(np.float64).sum()),
                   int((sel & okx).sum()),
                   int(y_np[sel & oky].sum()))
    sums = {}
    for route in backend.GROUPED_REDUCE_ROUTES:
        fn = jax.jit(build_preagg_fn(schema, [key], insts, pred, 128,
                                     strategy="mxu_dense",
                                     reduce_route=route))
        args = (cols, np.int32(n), np.uint64(0))
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        out = jax.device_get(compiled(*args))
        med, times = _median_time(lambda: compiled(*args))
        sums[route] = np.asarray(out["mxu_sums"])
        states, displays = {}, {}
        collided, overflow = mxu_absorb(
            out, [key], insts, [None], states, displays, merge_partials,
            extract_partials, canon_group_key, dense_key=True)
        check(not collided and not overflow and int(out["err"]) == 0,
              f"kernel {route}: flags collided={collided} "
              f"overflow={overflow} err={int(out['err'])}")
        for ck, parts in states.items():
            k = displays[ck][0]
            got = (parts[0]["sum_f"], parts[1]["count"], parts[2]["sum_i"])
            check(got == want[k], f"kernel {route}: key {k}: engine {got}, "
                                  f"numpy {want[k]}")
        check(len(states) == 30, f"kernel {route}: {len(states)} groups")
        st = dev.memory_stats() or {}
        log(f"[kernel] grouped reduce {route} @ {n} rows (flagship): "
            f"median {med * 1e3:.3f}ms runs_ms "
            f"{[round(t * 1e3, 3) for t in times]} compile {compile_s:.3f}s "
            f"temp_bytes {getattr(mem, 'temp_size_in_bytes', None)} "
            f"peak_bytes_in_use {st.get('peak_bytes_in_use')}")
    # shadow columns are f64 threshold guards summed beside the limbs, not
    # exact integers; every other column must agree bit for bit
    _, slotr, ncols = mxu_recipes([T.INT4], insts,
                                  [tuple(a.type for a in i.args) for i in insts],
                                  dense_key=True)
    exact = [c for c in range(ncols) if c not in set(mxu_shadow_cols(slotr))]
    a, b = (sums[r][:, exact] for r in backend.GROUPED_REDUCE_ROUTES)
    check(np.array_equal(a, b), "grouped reduce: the two formulations' "
                                "integer limb sums differ")
    log(f"[kernel] both formulations: identical limb sums, equal to numpy "
        f"(default on {backend.platform()} at G=128: "
        f"{backend.grouped_reduce_route(128)})")

    # dense-probe gather: unique, non-identity build keys (permuted window)
    nb = DIM_ROWS
    bkeys = (rng.permutation(nb) + 1).astype(np.int32)
    bcap = 1 << (nb - 1).bit_length()
    bdata = np.zeros(bcap, np.int32)
    bdata[:nb] = bkeys
    bk = ColumnRef(type=T.INT4, name="k", index=0)
    ht = jax.jit(build_hash_table([ColMeta("k", T.INT4)], [bk]))(
        ((bdata, np.arange(bcap) < nb),), np.int32(nb))
    check(bool(ht["dense_ok"]) and not bool(ht["dense_ident"]),
          "gather: build did not take the direct-address table")
    pkeys = rng.integers(-5, nb + 5, n).astype(np.int32)
    pcols = ((jax.device_put(pkeys), jax.device_put(np.ones(n, np.bool_))),)
    probe = jax.jit(build_probe_dense_fn([ColMeta("k", T.INT4)], [bk],
                                         dense_cap_for(bcap)))
    matched, brow, nout, err = jax.device_get(probe(ht, pcols, np.int32(n)))
    inv = np.full(nb + 16, -1, np.int64)
    inv[bkeys] = np.arange(nb)
    wantrow = np.where((pkeys >= 0) & (pkeys < nb + 16),
                       inv[np.clip(pkeys, 0, nb + 15)], -1)
    check(np.array_equal(matched, wantrow >= 0)
          and np.array_equal(brow[wantrow >= 0], wantrow[wantrow >= 0])
          and int(nout) == int((wantrow >= 0).sum()) and int(err) == 0,
          "gather: probe result differs from numpy")
    med, times = _median_time(lambda: probe(ht, pcols, np.int32(n)))
    log(f"[kernel] dense-probe gather @ {n} rows, {nb}-row build: "
        f"median {med * 1e3:.3f}ms runs_ms "
        f"{[round(t * 1e3, 3) for t in times]} (equal to numpy)")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

_COLLECTIVE = ("all-to-all", "alltoall", "all_to_all", "nccl", "all-gather",
               "allgather", "all-reduce", "allreduce")


def trace_warm_query(execute, sql: str, db, trace_dir: str) -> str:
    """Profile one warm run of `sql`; per GPU, the wall time of the run
    and, per trace line (a stream, "XLA Modules", "XLA Ops": lines of one
    GPU overlap, so they are not added), the summed event time and the
    part spent in collectives."""
    import glob
    import jax
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        execute(sql, db)
    wall = time.perf_counter() - t0
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return "no trace written"
    pd = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    per_gpu = []
    for plane in pd.planes:
        if "gpu" not in plane.name.lower():
            continue
        lines = {}
        for line in plane.lines:
            busy = coll = 0
            for ev in line.events:
                busy += ev.duration_ns
                if any(s in ev.name.lower() for s in _COLLECTIVE):
                    coll += ev.duration_ns
            if busy:
                lines[line.name] = (f"{busy / 1e6:.3f}ms"
                                    f" (collective {coll / 1e6:.3f}ms)")
        per_gpu.append(f"{plane.name}: {lines}")
    return f"traced run {wall * 1e3:.3f}ms wall; " + "; ".join(per_gpu)


def run_cards4(fact_rows: int, trace_dir: str) -> None:
    import jax
    from pg_strom_tpu import T
    from pg_strom_tpu.datastore import Table, Column, column_from_numpy
    from pg_strom_tpu.models.testdb import BENCH_QUERIES
    from pg_strom_tpu.sql import execute
    check(len(jax.devices()) >= 4,
          f"--cards 4 needs 4 devices, found {len(jax.devices())}")
    db = phase_load(fact_rows)
    set_cache_budget(db)
    ref = numpy_reference(db, ["star_group", "agg_group", "sort",
                               "star4way"])
    # skewed join: the hottest key holds 90% of the fact rows (above
    # skew_heavy_threshold = 0.10), the rest spread over the dimension
    rng = np.random.default_rng(2)
    n = fact_rows
    k = np.where(rng.random(n) < 0.9, 1,
                 rng.integers(1, DIM_ROWS + 1, n)).astype(np.int32)
    xs = db.tables["t0"].columns["x"].data
    db.create(Table.from_columns("skew_f", {
        "k": column_from_numpy(T.INT4, k),
        "x": column_from_numpy(T.FLOAT8, xs)}))
    g = k % 40
    cnt = np.bincount(g, minlength=40)
    sx = ExactSums(xs).sums(groups=g, G=40)
    skew_sql = ("select t1.aid % 40, count(*), sum(skew_f.x) from skew_f "
                "join t1 on skew_f.k = t1.aid group by t1.aid % 40 "
                "order by t1.aid % 40")
    ref["skew_join"] = ("eef", [(i, int(cnt[i]), sx[i])
                                for i in range(40) if cnt[i]])
    queries = {q: BENCH_QUERIES[q]
               for q in ("star_group", "agg_group", "sort", "star4way")}
    queries["skew_join"] = skew_sql
    execute("set pg_strom.distributed = on", db)
    for name, sql in queries.items():
        t0 = time.perf_counter()
        cold = execute(sql, db)
        cold_s = time.perf_counter() - t0
        _, counters = explain_counts(execute, sql, db)
        t0 = time.perf_counter()
        warm = execute(sql, db)
        warm_s = time.perf_counter() - t0
        check(warm.formatted(-3) == cold.formatted(-3),
              f"{name}: warm output differs from cold output")
        dist = {c: v for c, v in counters.items() if c.startswith("dist_")}
        check(any(c.endswith("_steps") and v > 0 for c, v in dist.items()),
              f"{name}: the distributed path did not run ({counters})")
        if name == "skew_join":
            check(dist.get("dist_skew_routed", 0) > 0,
                  f"skew_join: skew routing did not engage ({counters})")
        inexact = compare_rows(name, cold.rows, ref[name], n)
        log(f"[cards4] {name}: cold {cold_s:.6f}s warm {warm_s:.6f}s "
            f"rows {len(cold.rows)} {dist} — matches numpy "
            f"({inexact} float cells not bit-equal to the exact sum)")
    log(f"[cards4] star_group trace: "
        f"{trace_warm_query(execute, queries['star_group'], db, trace_dir)}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--fact-rows", type=int, default=10 ** 8)
    ap.add_argument("--parity-rows", type=int, default=1 << 18)
    ap.add_argument("--kernel-rows", type=int, default=1 << 26)
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help="run on CPU devices and exit 3 without a result")
    args = ap.parse_args()

    if args.rehearse_on_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.cards == 4:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    else:
        log(nvidia_smi_line())
    sys.path.insert(0, HERE)
    import pg_strom_tpu  # noqa: F401  (x64, compile cache)
    import jax
    devs = jax.devices()
    if not args.rehearse_on_cpu:
        check(devs[0].platform == "gpu",
              f"no GPU: JAX found {devs[0].platform!r} devices")
    log(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)} "
        f"jax {jax.__version__}")
    if args.rehearse_on_cpu:
        # tiny rehearsal tables sit below the cost model's offload
        # breakeven; force the device plan so the same paths run
        from pg_strom_tpu.config import set_config
        set_config("debug_force_offload", True)

    if args.cards == 4:
        run_cards4(args.fact_rows,
                   os.path.join(HERE, "traces", "cards4"))
    else:
        from pg_strom_tpu.models.testdb import BENCH_QUERIES
        db = phase_load(args.fact_rows)
        set_cache_budget(db)
        results = phase_queries(db, list(BENCH_QUERIES))
        phase_reference(db, results)
        from pg_strom_tpu.sql import execute
        log("[trace] star_group: " + trace_warm_query(
            execute, BENCH_QUERIES["star_group"], db,
            os.path.join(HERE, "traces", "cards1")))
        del db
        phase_parity(args.parity_rows)
        phase_kernels(args.kernel_rows)
    if args.rehearse_on_cpu:
        log("rehearsal passed on CPU (not a device result)")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
