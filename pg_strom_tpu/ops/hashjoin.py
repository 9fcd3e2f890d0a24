"""Equi hash join: device build + streamed probe.

The GpuHashJoin/MultiHash analog (reference gpuhashjoin.c 5073 LoC +
opencl_hashjoin.h).  Architecture mapping:

  reference                                  here
  -----------------------------------        ----------------------------------
  host-side CRC32 chained-bucket build       device sorted-bucket build: sort
  (multihash_preload_khashtable,             build rows by bucket id, bucket
   gpuhashjoin.c:3614-3816)                  offsets via searchsorted — no
                                             chains, no atomics
  hash table DMA'd once per device, reused   build arrays live in HBM across
  across in-flight chunks (4497-4555)        all probe chunks (jax arrays)
  two-phase kernel: count matches ->         same two phases, vectorized:
  stairlike prefix sum -> write              bounded-chain gather loop, cumsum,
  (opencl_hashjoin.h:284-416)                scatter
  StromError_DataStoreNoSpace -> server      nout > out-capacity -> executor
  regrows dest KDS and re-enqueues           re-dispatches with 2x capacity
  (gpuhashjoin.c:4323-4425)                  (compile cached per capacity)

Bucket chains longer than `max_chain` (config.join_max_bucket_probe) flag
CPU_RECHECK and the chunk falls back to the exact host join — same
graceful-degradation contract as everything else.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..sqltypes import T
from ..errors import ERR_CPU_RECHECK
from ..expr.ir import Expr
from ..expr.lower_jax import Lowerer, DVal, ColMeta
from .hashing import hash_column32, combine_hashes32


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class HashTable:
    """Device-resident sorted-bucket hash table over the build side."""
    nbuckets: int
    bucket_start: jnp.ndarray      # int32[nbuckets+1]
    order: jnp.ndarray             # int32[cap]: sorted position -> build row
    key_planes: tuple              # sorted key DVal planes per key expr
    key_types: tuple[T, ...]
    nbuild: int                    # live build rows


# single-int-key PK joins (the dim-join shape) get a direct-address table:
# the probe costs ONE gather instead of a bounded bucket-chain walk of up to
# join_max_bucket_probe random-access passes.  Types with an integer data
# lane whose value IS the join identity:
_DENSE_KEY_TYPES = {T.INT2, T.INT4, T.INT8, T.DATE, T.TIME, T.TIMESTAMP,
                    T.BOOL}


def dense_cap_for(build_cap: int) -> int:
    """Static direct-address table size for a build capacity (4x slack lets
    serial PKs with gaps still qualify)."""
    return _next_pow2(max(4 * build_cap, 1024))


def build_hash_table(schema: Sequence[ColMeta], key_exprs: Sequence[Expr],
                     pred: Optional[Expr] = None) -> Callable:
    """Build-side kernel: f(cols, nrows) -> pytree of table arrays.

    Rows with NULL in any join key never match (SQL equi-join semantics), so
    they are excluded from buckets entirely.

    Besides the sorted-bucket table, emits a direct-address `dense` lookup
    (key - kmin -> build row, -1 empty) with `dense_ok` true when the build
    side has ONE integer key whose live values fit the static window with no
    duplicates — the executor then probes with the one-gather kernel."""
    key_exprs = list(key_exprs)

    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        nbuckets = _next_pow2(max(2 * n, 16))
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        mask = live
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)
        keys = [lw.lower(k, mask) for k in key_exprs]
        allvalid = mask
        for k in keys:
            allvalid = allvalid & k.valid
        hs = [hash_column32(k.t, k.data, k.valid,
                            k.exp if k.t is T.NUMERIC else None,
                            getattr(k, "bits", None)) for k in keys]
        h = combine_hashes32(hs)
        bucket = (h & jnp.uint32(nbuckets - 1)).astype(jnp.int32)
        bucket = jnp.where(allvalid, bucket, jnp.int32(nbuckets))
        from .sort import argsort_i32
        order = argsort_i32(bucket, n, vbits=nbuckets.bit_length() + 1)
        bsorted = bucket[order]
        edges = jnp.arange(nbuckets + 1, dtype=jnp.int32)
        bucket_start = jnp.searchsorted(bsorted, edges, side="left").astype(jnp.int32)
        key_planes = []
        for k in keys:
            planes = [k.data[order], k.valid[order]]
            if k.t is T.NUMERIC:
                planes.append(k.exp[order])
            key_planes.append(tuple(planes))

        # direct-address table for single integer keys
        if len(keys) == 1 and keys[0].t in _DENSE_KEY_TYPES:
            dcap = dense_cap_for(n)
            kd = keys[0].data.astype(jnp.int64)
            kmin = jnp.min(jnp.where(allvalid, kd, jnp.int64(1) << 62))
            off = kd - kmin
            in_r = allvalid & (off >= 0) & (off < dcap)
            # every live key in window + kmin far from int64 extremes (so a
            # probe-side `key - kmin` can never wrap INTO the window)
            fits = (jnp.all(in_r == allvalid) & jnp.any(allvalid)
                    & (jnp.abs(kmin) < (jnp.int64(1) << 62)))
            tgt = jnp.where(in_r, off.astype(jnp.int32), jnp.int32(dcap))
            rows = jnp.arange(n, dtype=jnp.int32)
            dense = jnp.full(dcap, -1, jnp.int32).at[tgt].set(
                rows, mode="drop")
            cnt = jnp.zeros(dcap, jnp.int32).at[tgt].add(1, mode="drop")
            dense_ok = fits & jnp.all(cnt <= 1)
            # IDENTITY fast path: build key of row i is exactly kmin + i for
            # EVERY build row (the serial-PK dim-table shape — reference
            # testdb.sql t1..t5, and star schemas generally).  Then
            # slot == build row and occupied slots are exactly [0, nbuild):
            # the probe needs NO table access at all — pure lane arithmetic.
            live_rows = jnp.arange(n, dtype=jnp.int32) < nrows
            dense_ident = (dense_ok
                           & jnp.all(allvalid == live_rows)
                           & jnp.all(jnp.where(live_rows,
                                               off == rows.astype(jnp.int64),
                                               True)))
        else:
            dense = jnp.full(1, -1, jnp.int32)
            kmin = jnp.int64(0)
            dense_ok = jnp.bool_(False)
            dense_ident = jnp.bool_(False)
        return {"bucket_start": bucket_start, "order": order,
                "key_planes": tuple(key_planes),
                "dense": dense, "kmin": kmin, "dense_ok": dense_ok,
                "dense_ident": dense_ident,
                "nbuild": jnp.sum(allvalid.astype(jnp.int32)),
                "err": jnp.max(jnp.where(live, lw.err, jnp.uint8(0)))}

    return f


def build_probe_dense_fn(schema: Sequence[ColMeta], key_exprs: Sequence[Expr],
                         dense_cap: int, pred: Optional[Expr] = None,
                         use_ident: bool = False) -> Callable:
    """One-gather probe against a direct-address build table:
       f(ht, cols, nrows) -> (matched bool[n], build_row int32[n], nout, err).

    Output stays ROW-ALIGNED (no compaction pass): at most one match per
    probe row by construction (dense_ok => unique build keys), so the
    executor materializes pairs with a host flatnonzero.  Replaces the
    two-phase chained probe's bucket walk with one gather from the
    direct-address table (int32[dense_cap]).

    use_ident (executor sets it when ht['dense_ident'] held): the slot IS
    the build row, so the probe reads no table at all."""
    key_exprs = list(key_exprs)

    def f(ht: dict, cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        mask = live
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)
        k = lw.lower(key_exprs[0], mask)
        off = k.data.astype(jnp.int64) - ht["kmin"]
        in_r = mask & k.valid & (off >= 0) & (off < dense_cap)
        slot = jnp.clip(off, 0, dense_cap - 1).astype(jnp.int32)
        if use_ident:
            # identity build (ht['dense_ident']): slot IS the build row and
            # occupied slots are exactly [0, nbuild) — no table access
            br = slot
            matched = in_r & (off < ht["nbuild"].astype(jnp.int64))
        else:
            br = ht["dense"][slot]
            matched = in_r & (br >= 0)
        err = jnp.max(jnp.where(live, lw.err, jnp.uint8(0))) if n \
            else jnp.uint8(0)
        return (matched, jnp.where(matched, br, 0),
                jnp.sum(matched.astype(jnp.int64)), err)

    return f


def _keys_match(probe_keys: list[DVal], ht_key_planes: tuple,
                key_types: tuple, j: jnp.ndarray) -> jnp.ndarray:
    """probe row lanes vs build rows at sorted positions j (lane-wise)."""
    ok = None
    for pk, planes, t in zip(probe_keys, ht_key_planes, key_types):
        bdata = planes[0][j]
        bvalid = planes[1][j]
        pd = pk.data
        if t in (T.FLOAT4, T.FLOAT8):
            # PostgreSQL float equality is float8_cmp_internal == 0:
            # -0 = +0 AND NaN = NaN (the btree semantics the host tier's
            # cmp_values implements) — plain IEEE == would drop NaN pairs
            pd0 = jnp.where(pd == 0, jnp.zeros_like(pd), pd)
            bd0 = jnp.where(bdata == 0, jnp.zeros_like(bdata), bdata)
            same = (pd0 == bd0) | (jnp.isnan(pd) & jnp.isnan(bdata))
        else:
            same = pd == bdata
        if t is T.NUMERIC:
            same = same & (pk.exp == planes[2][j])
        e = pk.valid & bvalid & same
        ok = e if ok is None else (ok & e)
    return ok


def build_probe_multi_fn(schema: Sequence[ColMeta],
                         key_exprs: Sequence[Expr], key_types: tuple,
                         max_chain: int, fanout: int,
                         pred: Optional[Expr] = None) -> Callable:
    """ROW-ALIGNED bounded-fanout probe: f(ht, cols, nrows) ->
       (brs int32[fanout, n], counts int32[n], ovf bool, err).

    brs[f, i] = build row of probe row i's f-th match (first-seen order);
    counts[i] = total matches (capped at observation); ovf = some row had
    more than `fanout` matches OR a bucket chain exceeded max_chain — the
    caller raises the fanout/chain ladder or falls back to the pairwise
    compacting probe.  Handles arbitrary equi-keys (multi-key, non-unique
    build sides) via the same sorted-bucket walk as build_probe_fn, but
    with NO compaction: the output stays aligned with the probe chunk, so
    a fused join chain can AND per-match masks and keep everything
    device-resident (the kern_gpuhashjoin_main depth-loop analog,
    opencl_hashjoin.h:284-416, without materializing pairs).
    """
    key_exprs = list(key_exprs)

    def f(ht: dict, cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        mask = live
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)
        keys = [lw.lower(k, mask) for k in key_exprs]
        allvalid = mask
        for k in keys:
            allvalid = allvalid & k.valid
        nbuckets = ht["bucket_start"].shape[0] - 1
        hs = [hash_column32(k.t, k.data, k.valid,
                            k.exp if k.t is T.NUMERIC else None,
                            getattr(k, "bits", None)) for k in keys]
        h = combine_hashes32(hs)
        bucket = (h & jnp.uint32(nbuckets - 1)).astype(jnp.int32)
        bucket = jnp.where(allvalid, bucket, jnp.int32(nbuckets - 1))
        start = ht["bucket_start"][bucket]
        end = ht["bucket_start"][bucket + 1]
        blen = jnp.where(allvalid, end - start, 0)
        too_long = jnp.any(blen > max_chain)
        err = jnp.max(jnp.where(live, lw.err, jnp.uint8(0))) if n \
            else jnp.uint8(0)
        bs_max = ht["order"].shape[0]

        brs = [jnp.full(n, bs_max, jnp.int32) for _ in range(fanout)]
        cnt = jnp.zeros(n, dtype=jnp.int32)
        for k in range(max_chain):
            j = jnp.clip(start + k, 0, max(bs_max - 1, 0))
            in_b = allvalid & (k < blen)
            m = in_b & _keys_match(keys, ht["key_planes"], key_types, j)
            row = ht["order"][j]
            for fx in range(fanout):
                brs[fx] = jnp.where(m & (cnt == fx), row, brs[fx])
            cnt = cnt + m.astype(jnp.int32)
        ovf = too_long | jnp.any(cnt > fanout)
        return jnp.stack(brs), cnt, ovf, err

    return f


def build_probe_fn(schema: Sequence[ColMeta], key_exprs: Sequence[Expr],
                   key_types: tuple, nbuckets: int, max_chain: int,
                   out_cap: int, pred: Optional[Expr] = None) -> Callable:
    """Probe kernel: f(ht_arrays, cols, nrows) ->
       (probe_idx[out_cap], build_row[out_cap], nout, err).

    Two-phase count-then-write with a bounded per-bucket scan; chains longer
    than max_chain or nout > out_cap are flagged (executor grows/falls back).
    """
    key_exprs = list(key_exprs)

    def f(ht: dict, cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        mask = live
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)
        keys = [lw.lower(k, mask) for k in key_exprs]
        allvalid = mask
        for k in keys:
            allvalid = allvalid & k.valid
        hs = [hash_column32(k.t, k.data, k.valid,
                            k.exp if k.t is T.NUMERIC else None,
                            getattr(k, "bits", None)) for k in keys]
        h = combine_hashes32(hs)
        bucket = (h & jnp.uint32(nbuckets - 1)).astype(jnp.int32)
        bucket = jnp.where(allvalid, bucket, jnp.int32(nbuckets - 1))
        start = ht["bucket_start"][bucket]
        end = ht["bucket_start"][bucket + 1]
        blen = jnp.where(allvalid, end - start, 0)
        # chains longer than the bounded scan: defer chunk to host
        too_long = jnp.any(blen > max_chain)
        err = jnp.maximum(jnp.max(jnp.where(live, lw.err, jnp.uint8(0))),
                          jnp.where(too_long, jnp.uint8(ERR_CPU_RECHECK),
                                    jnp.uint8(0)))

        bs_max = ht["order"].shape[0]

        def match_at(k: int):
            j = jnp.clip(start + k, 0, max(bs_max - 1, 0))
            in_b = allvalid & (k < blen)
            return in_b & _keys_match(keys, ht["key_planes"], key_types, j), j

        # phase 1: count
        counts = jnp.zeros(n, dtype=jnp.int32)
        for k in range(max_chain):
            m, _ = match_at(k)
            counts = counts + m.astype(jnp.int32)
        pos = jnp.cumsum(counts) - counts      # exclusive prefix
        nout = jnp.sum(counts)

        # phase 2: write pairs
        probe_idx = jnp.full(out_cap, n, dtype=jnp.int32)
        build_row = jnp.full(out_cap, bs_max, dtype=jnp.int32)
        written = jnp.zeros(n, dtype=jnp.int32)
        src = jnp.arange(n, dtype=jnp.int32)
        for k in range(max_chain):
            m, j = match_at(k)
            w = pos + written
            tgt = jnp.where(m & (w < out_cap), w, out_cap)
            probe_idx = probe_idx.at[tgt].set(src, mode="drop")
            build_row = build_row.at[tgt].set(ht["order"][j], mode="drop")
            written = written + m.astype(jnp.int32)

        return probe_idx, build_row, nout, err

    return f
