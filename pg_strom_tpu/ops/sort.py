"""ORDER BY: multi-key device sort.

The reference kept GpuSort in deadcode (deadcode/gpusort.c: CustomPlan Sort
replacement with bitonic kernels) but it is part of the capability envelope
and the benchmark includes ORDER BY — here it is first-class.

Design — single-operand packed sorts: every sort here is ONE int64 operand
(a variadic key + payload `lax.sort` compiled far slower on the hardware
this was first built for, and one operand moves fewer bytes):

  wide = (unsigned-comparable key bits << rbits) | row_id
  perm = lax.sort(wide) & (2^rbits - 1)

Row-id in the low bits makes the sort stable by construction.  Multi-key
ORDER BY packs all key lanes into the word when they fit (≤ 63-rbits bits);
wider key sets run LSD passes (least-significant key group first), composing
permutations between passes — the classic radix strategy, each pass again a
single-operand sort.

Per-key encoding to unsigned-comparable bit chunks:
  ints/date/time  biased two's complement within the type's width
  floats          exact IEEE total-order keys (NaN greatest — PG btree order)
  numeric         (magnitude class, normalized mantissa) lanes — exact
  DESC            chunk bits inverted within their width
  NULLS           one leading bit per key (first/last by ORDER BY spec)
  padding rows    one global leading dead bit → always sort last
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..sqltypes import T
from ..expr.ir import Expr
from ..expr.lower_jax import Lowerer, DVal, ColMeta, _f64_orderkey


@dataclasses.dataclass(frozen=True)
class SortSpec:
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None   # None = PG default (last if ASC)

    def nulls_go_first(self) -> bool:
        return self.descending if self.nulls_first is None else self.nulls_first


def _rbits(n: int) -> int:
    b = 1
    while (1 << b) < max(n, 2):
        b += 1
    return b


def _order_lanes(v: DVal) -> list[tuple[jnp.ndarray, int]]:
    """(int64 lane, bit width) pairs; lexicographic ascending order of the
    biased chunks == SQL ascending order of the value."""
    if v.t is T.NUMERIC:
        from .preagg import _num_sort_keys
        p, s = _num_sort_keys(v.data, v.exp)
        return _bias_chunks(p, 10) + _bias_chunks(s, 62)
    if v.t is T.FLOAT8:
        bits = getattr(v, "bits", None)
        if bits is not None:
            key = _f64_orderkey(bits)
        else:
            key = _f64_orderkey(jax.lax.bitcast_convert_type(
                v.data.astype(jnp.float64), jnp.int64))
        return _bias_chunks(key, 64)
    if v.t is T.FLOAT4:
        b32 = jax.lax.bitcast_convert_type(v.data.astype(jnp.float32), jnp.int32)
        b32 = jnp.where(b32 == jnp.int32(-(1 << 31)), jnp.int32(0), b32)
        expm = jnp.int32(0x7F800000)
        isn = ((b32 & expm) == expm) & ((b32 & jnp.int32(0x007FFFFF)) != 0)
        b32 = jnp.where(isn, jnp.int32(0x7FC00000), b32)
        key = jnp.where(b32 < 0, jnp.int32(-1) - (b32 & jnp.int32(0x7FFFFFFF)), b32)
        return _bias_chunks(key.astype(jnp.int64), 32)
    width = {T.BOOL: 1, T.INT2: 16, T.INT4: 32, T.DATE: 32,
             T.TIME: 64, T.TIMESTAMP: 64, T.INT8: 64}.get(v.t, 64)
    return _bias_chunks(v.data.astype(jnp.int64), width)


def _bias_chunks(lane: jnp.ndarray, width: int) -> list[tuple[jnp.ndarray, int]]:
    """Signed int64 lane of `width` significant bits -> non-negative
    unsigned-comparable chunks of <= 33 bits each (so chunk+rowid packs)."""
    if width <= 1:
        return [(lane.astype(jnp.int64) & jnp.int64(1), 1)]
    u = lane.astype(jnp.uint64) ^ jnp.uint64(1 << (width - 1) if width < 64
                                             else 1 << 63)
    if width < 64:
        u = u & jnp.uint64((1 << width) - 1)
    if width <= 33:
        return [(u.astype(jnp.int64), width)]
    hi_w = width - 31
    hi = (u >> 31).astype(jnp.int64)
    lo = (u & jnp.uint64((1 << 31) - 1)).astype(jnp.int64)
    out = []
    if hi_w > 33:                      # width 64: hi is 33 bits after this
        out.extend(_chunks_from_unsigned(hi, hi_w))
    else:
        out.append((hi, hi_w))
    out.append((lo, 31))
    return out


def _chunks_from_unsigned(u: jnp.ndarray, width: int) -> list[tuple[jnp.ndarray, int]]:
    out = []
    while width > 33:
        out.append(((u >> (width - 31)) & jnp.int64((1 << 31) - 1), 31))
        width -= 31
    out.append((u & jnp.int64((1 << width) - 1), width))
    return out


def _key_lanes(v: DVal, sp: SortSpec) -> list[tuple[jnp.ndarray, int]]:
    """Null bit + encoded value chunks for one ORDER BY key."""
    isnull = (~v.valid).astype(jnp.int64)
    null_bit = isnull if not sp.nulls_go_first() else (1 - isnull)
    lanes = [(null_bit, 1)]
    for chunk, w in _order_lanes(v):
        c = jnp.where(v.valid, chunk, jnp.int64(0))
        if sp.descending:
            c = jnp.int64((1 << w) - 1) - c
        lanes.append((c, w))
    return lanes


def _bias_unsigned(lane: jnp.ndarray, width: int) -> jnp.ndarray:
    """Signed int64 lane of `width` significant bits -> the whole
    unsigned-comparable uint64 value (the un-chunked form of _bias_chunks)."""
    u = lane.astype(jnp.uint64) ^ jnp.uint64(1 << (width - 1) if width < 64
                                             else 1 << 63)
    if width < 64:
        u = u & jnp.uint64((1 << width) - 1)
    return u


def _full_specs(v: DVal, sp: SortSpec) -> tuple:
    """Adaptive-pack spec for one key: (null_bit, [u64 whole encoded
    lanes], descending, valid).  Keeping each encoded value WHOLE (no
    31-bit chunking) lets runtime min-reduction shrink it to its true bit
    width — a small-range int8/timestamp key costs its range's bits, not
    64."""
    isnull = (~v.valid).astype(jnp.int64)
    null_bit = isnull if not sp.nulls_go_first() else (1 - isnull)
    if v.t is T.NUMERIC:
        from .preagg import _num_sort_keys
        p, s = _num_sort_keys(v.data, v.exp)
        fulls = [_bias_unsigned(p, 10), _bias_unsigned(s, 62)]
    elif v.t is T.FLOAT8:
        bits = getattr(v, "bits", None)
        if bits is None:
            bits = jax.lax.bitcast_convert_type(
                v.data.astype(jnp.float64), jnp.int64)
        fulls = [_bias_unsigned(_f64_orderkey(bits), 64)]
    elif v.t is T.FLOAT4:
        b32 = jax.lax.bitcast_convert_type(v.data.astype(jnp.float32),
                                           jnp.int32)
        b32 = jnp.where(b32 == jnp.int32(-(1 << 31)), jnp.int32(0), b32)
        expm = jnp.int32(0x7F800000)
        isn = ((b32 & expm) == expm) & ((b32 & jnp.int32(0x007FFFFF)) != 0)
        b32 = jnp.where(isn, jnp.int32(0x7FC00000), b32)
        key = jnp.where(b32 < 0, jnp.int32(-1) - (b32 & jnp.int32(0x7FFFFFFF)),
                        b32)
        fulls = [_bias_unsigned(key.astype(jnp.int64), 32)]
    else:
        width = {T.BOOL: 1, T.INT2: 16, T.INT4: 32, T.DATE: 32,
                 T.TIME: 64, T.TIMESTAMP: 64, T.INT8: 64}.get(v.t, 64)
        fulls = [_bias_unsigned(v.data.astype(jnp.int64), max(width, 2))]
    return (null_bit, fulls, sp.descending, v.valid)


def _bit_width_u64(x: jnp.ndarray) -> jnp.ndarray:
    """ceil(log2(x+1)) of a non-negative traced uint64 scalar."""
    w = jnp.uint64(0)
    for k in range(64):   # full 64: a range >= 2^63 must report width 64
        w = w + (x >= jnp.uint64(1 << k)).astype(jnp.uint64)
    return w


def _argsort_adaptive(dead_bit: jnp.ndarray,
                      key_specs: Sequence[tuple], n: int):
    """Adaptive single-pass stable multi-key argsort: (perm, fits).

    Per key, reduce the whole encoded value by its runtime min and measure
    its true bit width; when the dead bit + null bits + reduced widths +
    row-id bits fit one 64-bit word, ONE packed lax.sort is the exact
    stable answer (dynamic shift amounts are ordinary XLA ops).  Multi-key
    ORDER BY over real data (ids, categories, dates, dictionary codes)
    almost always fits — removing the per-pass composition gathers of the
    static multi-pass path.

    fits=False => perm is meaningless; the CALLER re-dispatches the static
    LSD program (packed_argsort) — the engine's standard host-driven retry
    shape.  A traced lax.cond was measured 2x WORSE than the plain static
    path on the non-fitting case, so the decision is a host round trip.
    """
    rb = _rbits(n)
    iota = jax.lax.broadcasted_iota(jnp.uint64, (n,), 0)
    wide = iota
    shift = jnp.uint64(rb)
    big = jnp.uint64((1 << 64) - 1)
    for null_bit, fulls, desc, valid in reversed(list(key_specs)):
        for lane in reversed(fulls):
            any_ok = jnp.any(valid)
            m = jnp.where(any_ok, jnp.min(jnp.where(valid, lane, big)),
                          jnp.uint64(0))
            red = jnp.where(valid, lane - m, jnp.uint64(0))
            rmax = jnp.where(any_ok, jnp.max(red), jnp.uint64(0))
            if desc:
                red = jnp.where(valid, rmax - red, jnp.uint64(0))
            wk = _bit_width_u64(rmax)
            wide = wide | (red << jnp.minimum(shift, jnp.uint64(63)))
            shift = shift + wk
        wide = wide | (null_bit.astype(jnp.uint64)
                       << jnp.minimum(shift, jnp.uint64(63)))
        shift = shift + jnp.uint64(1)
    # dead/qual bit (the most significant) on top
    wide = wide | (dead_bit.astype(jnp.uint64)
                   << jnp.minimum(shift, jnp.uint64(63)))
    fits = (shift + jnp.uint64(1)) <= jnp.uint64(64)
    s = jax.lax.sort(wide)
    perm = (s & jnp.uint64((1 << rb) - 1)).astype(jnp.int32)
    return perm, fits


def _argsort_adaptive2(dead_bit: jnp.ndarray,
                       key_specs: Sequence[tuple], n: int):
    """Two-word adaptive stable multi-key argsort: (perm, fits).

    Same runtime range reduction as _argsort_adaptive, but the reduced keys
    pack into TWO 64-bit words sorted lexicographically by ONE variadic
    lax.sort (num_keys=2) — the wide-key tier between the single-word fast
    path and the static LSD passes, with NO per-pass composition gathers.  Key sets up
    to ~128 - rowid bits wide fit; fits=False => caller takes the static
    path."""
    rb = _rbits(n)
    iota = jax.lax.broadcasted_iota(jnp.uint64, (n,), 0)
    lo = iota
    hi = jnp.zeros((n,), jnp.uint64)
    shift = jnp.uint64(rb)
    big = jnp.uint64((1 << 64) - 1)
    c64 = jnp.uint64(64)
    c63 = jnp.uint64(63)

    def put(bits, width):
        nonlocal lo, hi, shift
        off = shift
        lo_part = jnp.where(off < c64,
                            bits << jnp.minimum(off, c63), jnp.uint64(0))
        straddle = jnp.where((off > jnp.uint64(0)) & (off < c64),
                             bits >> jnp.minimum(c64 - off, c63),
                             jnp.uint64(0))
        hi_part = jnp.where(off >= c64,
                            bits << jnp.minimum(off - c64, c63),
                            jnp.uint64(0))
        lo = lo | lo_part
        hi = hi | straddle | hi_part
        shift = shift + width

    for null_bit, fulls, desc, valid in reversed(list(key_specs)):
        for lane in reversed(fulls):
            any_ok = jnp.any(valid)
            m = jnp.where(any_ok, jnp.min(jnp.where(valid, lane, big)),
                          jnp.uint64(0))
            red = jnp.where(valid, lane - m, jnp.uint64(0))
            rmax = jnp.where(any_ok, jnp.max(red), jnp.uint64(0))
            if desc:
                red = jnp.where(valid, rmax - red, jnp.uint64(0))
            put(red, _bit_width_u64(rmax))
        put(null_bit.astype(jnp.uint64), jnp.uint64(1))
    put(dead_bit.astype(jnp.uint64), jnp.uint64(1))
    fits = shift <= jnp.uint64(128)
    hs, ls = jax.lax.sort((hi, lo), num_keys=2)
    perm = (ls & jnp.uint64((1 << rb) - 1)).astype(jnp.int32)
    return perm, fits


def packed_argsort(lanes: Sequence[tuple[jnp.ndarray, int]], n: int) -> jnp.ndarray:
    """Stable ascending argsort over lexicographic (lane, width) chunks,
    most-significant first.  Every lax.sort call is single-operand; key sets
    wider than 63-rbits bits run LSD passes with permutation composition."""
    rb = _rbits(n)
    budget = 63 - rb
    # group lanes from the LEAST significant end; each group <= budget bits
    groups: list[list[tuple[jnp.ndarray, int]]] = []
    cur: list[tuple[jnp.ndarray, int]] = []
    used = 0
    for lane, w in reversed(list(lanes)):
        if w > budget:
            raise ValueError(f"lane width {w} exceeds pack budget {budget}")
        if used + w > budget:
            groups.append(cur)
            cur, used = [], 0
        cur.append((lane, w))          # within group: LSB-first
        used += w
    if cur:
        groups.append(cur)

    iota = jax.lax.broadcasted_iota(jnp.int64, (n,), 0)
    # pack every group's word BEFORE any permutation: an LSD pass then costs
    # ONE gather (wide[perm]) + one composition gather (perm[idx]) instead of
    # a gather per lane
    packed: list[jnp.ndarray] = []
    for g in groups:                   # least-significant group first (LSD)
        wide = jnp.zeros((n,), dtype=jnp.int64)
        shift = rb
        for lane, w in g:              # g is LSB-first: shift upward
            wide = wide | (lane << shift)
            shift += w
        packed.append(wide)
    perm = None
    for wide in packed:
        w = wide if perm is None else wide[perm]
        s = jax.lax.sort(w | iota)     # low bits = current position: stable
        idx = (s & jnp.int64((1 << rb) - 1)).astype(jnp.int32)
        perm = idx if perm is None else perm[idx]
    return perm if perm is not None else iota.astype(jnp.int32)


def argsort_i32(vals: jnp.ndarray, n: int, vbits: int = 32) -> jnp.ndarray:
    """Stable argsort of a non-negative int lane (< 2^vbits) — the packed
    replacement for jnp.argsort(..., stable=True) used by hashjoin bucket
    ordering, preagg hash-sort grouping and the shuffle partitioner."""
    return packed_argsort([(vals.astype(jnp.int64), vbits)], n)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def build_sort_topk_fn(schema: Sequence[ColMeta], specs: Sequence[SortSpec],
                       pred: Optional[Expr], k: int,
                       exact: bool = False) -> Callable:
    """ORDER BY ... LIMIT k kernel: f(cols, nrows) ->
       (top int32[k], key_lanes tuple of int64[k], nqual, err, ovf).

    Returns the k first row indexes in sort order among rows passing `pred`
    (rows failing the qual carry a leading dead bit and sort last), plus the
    encoded key-lane values at those rows so the host can merge candidates
    across chunks with a lexicographic compare — the merge sees exactly the
    bits the device sorted on, so cross-chunk order == single-chunk order.

    Strategies (chosen at trace time; replaces the reference deadcode
    GpuSort's full bitonic sort for LIMIT queries):
      * packed top-k — when every key lane + the row id fit in one 63-bit
        word, a single `lax.top_k` over the negated packed keys IS the exact
        stable top-k (row id in the low bits = stability).  Measured 10-24x
        over the full packed argsort at 4M rows.
      * threshold top-k — wider keys: `lax.top_k` over a 63-bit key PREFIX
        finds the k-th smallest prefix t; every true top-k row has prefix
        <= t, so gather the candidate set {prefix <= t} (second top_k as the
        static-shape compaction) and finish with an exact packed argsort over
        the small candidate buffer.  If prefix ties overflow the buffer
        (`ovf` output), the caller re-runs the chunk with exact=True — the
        same host-driven regrow/retry contract as the join's
        DataStoreNoSpace analog (gpuhashjoin.c:4323-4425).
      * exact=True (or large k) — the original full packed argsort.
    """
    specs = list(specs)

    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        qual = live
        if pred is not None:
            pv = lw.lower(pred, live)
            qual = live & pv.valid & pv.data.astype(jnp.bool_)
        lanes: list[tuple[jnp.ndarray, int]] = [
            ((~qual).astype(jnp.int64), 1)]           # non-matches last
        for sp in specs:
            v = lw.lower(sp.expr, qual)
            lanes.extend(_key_lanes(v, sp))
        nqual = jnp.sum(qual.astype(jnp.int64))
        err = (jnp.max(jnp.where(live, lw.err, jnp.uint8(0))) if n
               else jnp.uint8(0))
        no_ovf = jnp.zeros((), dtype=jnp.bool_)
        kk = min(k, n) if n else 0
        if kk == 0:
            top = jnp.zeros((0,), dtype=jnp.int32)
            return top, tuple(lane[:0] for lane, _ in lanes), nqual, err, no_ovf

        rb = _rbits(n)
        total = sum(w for _, w in lanes)

        if exact or kk > 8192 or kk * 4 >= n:
            if exact:
                perm = packed_argsort(lanes, n)
                fits = None
            else:
                # adaptive single-pass; a non-fitting key set raises `ovf`
                # and the caller re-runs with exact=True (static passes)
                fs = [_full_specs(lw.lower(sp.expr, qual), sp)
                      for sp in specs]
                perm, fits = _argsort_adaptive(lanes[0][0], fs, n)
            top = perm[:kk]
            ovf = no_ovf if fits is None else ~fits
            return (top, tuple(lane[top] for lane, _ in lanes), nqual, err,
                    ovf)

        if total + rb <= 63:
            # packed top-k: keys + row id in one word -> all values distinct,
            # one top_k is the exact stable answer.
            wide = jax.lax.broadcasted_iota(jnp.int64, (n,), 0)
            shift = rb
            for lane, w in reversed(lanes):    # lanes are MSB-first
                wide = wide | (lane << shift)
                shift += w
            maxv = jnp.int64((1 << shift) - 1)
            desc, _ = jax.lax.top_k(maxv - wide, kk)
            top = ((maxv - desc) & jnp.int64((1 << rb) - 1)).astype(jnp.int32)
            return (top, tuple(lane[top] for lane, _ in lanes), nqual, err,
                    no_ovf)

        # threshold top-k: 63-bit key prefix (order-preserving truncation)
        prefix = jnp.zeros((n,), dtype=jnp.int64)
        used = 0
        for lane, w in lanes:
            if used >= 63:
                break
            take = min(w, 63 - used)
            prefix = (prefix << take) | (lane >> (w - take))
            used += take
        maxp = jnp.int64((1 << used) - 1)
        desc, _ = jax.lax.top_k(maxp - prefix, kk)
        thresh = maxp - desc[kk - 1]           # k-th smallest prefix
        # every true top-k row has prefix <= thresh (full-key order refines
        # prefix order); qual-failing rows can never win, drop them here so
        # an under-full chunk (nqual < k) can't flood the candidate buffer
        cand = (prefix <= thresh) & qual
        C = min(n, max(512, 2 * _next_pow2(kk)))
        ovf = jnp.sum(cand.astype(jnp.int64)) > jnp.int64(C)
        # static-shape compaction: top_k over (is_cand, rowid) packed words
        iota = jax.lax.broadcasted_iota(jnp.int64, (n,), 0)
        w2 = ((~cand).astype(jnp.int64) << rb) | iota
        max2 = jnp.int64((1 << (rb + 1)) - 1)
        cdesc, _ = jax.lax.top_k(max2 - w2, C)
        cw = max2 - cdesc                      # candidates first, rowid asc
        is_cand = (cw >> rb) == 0
        idx = (cw & jnp.int64((1 << rb) - 1)).astype(jnp.int32)
        glanes: list[tuple[jnp.ndarray, int]] = []
        for li, (lane, w) in enumerate(lanes):
            g = lane[idx]
            if li == 0:                        # non-candidates sort last
                g = jnp.where(is_cand, g, jnp.int64(1))
            glanes.append((g, w))
        perm_c = packed_argsort(glanes, C)     # stable: idx is rowid-asc
        sel = perm_c[:kk]
        top = idx[sel]
        return (top, tuple(g[sel] for g, _ in glanes), nqual, err, ovf)

    return f


def build_sort_fn(schema: Sequence[ColMeta], specs: Sequence[SortSpec],
                  adaptive: bool | int = True) -> Callable:
    """f(cols, nrows) -> (perm int32[n], err, fits bool).

    perm[:nrows] orders the live rows per the sort specs; dead (padding)
    rows sort last.  Tiers: adaptive in (True, 1) = single-word
    range-reduced sort; adaptive == 2 = TWO-word lexicographic lax.sort
    (wide key sets, still gather-free); adaptive in (False, 0) = static
    LSD passes (always valid, fits=True).  fits=False means the runtime
    key widths didn't fit the tier's word budget and perm is meaningless —
    the caller re-dispatches the next tier down."""
    specs = list(specs)
    tier = 1 if adaptive is True else (0 if adaptive is False
                                       else int(adaptive))

    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        lanes: list[tuple[jnp.ndarray, int]] = [
            ((~live).astype(jnp.int64), 1)]           # dead rows last
        fs = []
        for sp in specs:
            v = lw.lower(sp.expr, live)
            lanes.extend(_key_lanes(v, sp))
            fs.append(_full_specs(v, sp))
        err = jnp.max(jnp.where(live, lw.err, jnp.uint8(0)))
        if tier == 1:
            perm, fits = _argsort_adaptive(lanes[0][0], fs, n)
        elif tier == 2:
            perm, fits = _argsort_adaptive2(lanes[0][0], fs, n)
        else:
            perm = packed_argsort(lanes, n)
            fits = jnp.bool_(True)
        return perm, err, fits

    return f
