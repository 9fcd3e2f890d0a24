"""Grouped partial aggregation on device + exact host finalization.

The GpuPreAgg analog (reference: gpupreagg.c 4773 LoC + opencl_gpupreagg.h).
Same two-phase architecture as the reference (aggfunc_catalog rewrite into
NROWS/PSUM/PSUM_X2/PCOV_* partials computed on-device, exact finalization on
the host — gpupreagg.c:104-333, pg_strom--1.0.sql:229-401), but the device
algorithm is redesigned for XLA:

  reference: bitonic-sort ladder + keycomp-delimited local reduction
             (opencl_gpupreagg.h:459-860)
  here     : one XLA sort by key-hash per chunk, segment boundaries by exact
             key comparison, jax.ops.segment_* reductions into G static group
             slots.  Ungrouped aggregation skips the sort entirely.

Exactness strategy per slot kind (all device sums are *provably exact or
flagged*, so host finalization in python ints / Decimal / f64 reproduces
PostgreSQL results):

  sum_i64     int64 modular sum + f64 shadow; |shadow| > 2^62 => CPU_RECHECK
              (int64 wrap is modular, so if the true sum fits, the lanes are
               exact regardless of intermediate wraps)
  sumsq       int2: direct (x^2<=2^30, safe); int4/int8: x^2 split into
              hi/lo limbs summed separately (exact 128-bit via 2 int64 lanes);
              int8 rows with |x| >= 2^31 => CPU_RECHECK
  sum_num     per-group min-exponent alignment, int64 mantissa sum + shadow;
              rescale overflow => CPU_RECHECK (device numeric window analog
              of opencl_numeric.h)
  sum_f64     plain f64 segment sum (the CPU route; see preagg_mxu for the
              order-independent limb route the GPU takes)
  min/max     sentinel-masked segment min/max; numeric via two-pass
              lexicographic (magnitude-class, normalized-mantissa) reduction
              + argmin-row gather so display scale is preserved
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .. import backend
from ..sqltypes import T, STORAGE_DTYPE
from ..errors import ERR_CPU_RECHECK
from .. import pgnumeric as pgn
from ..expr.ir import Expr
from ..expr.lower_jax import Lowerer, DVal, ColMeta
from .hashing import hash_column, combine_hashes, hash_column32, combine_hashes32, _mix32

# np scalar, not eager jnp array (see ops/hashing.py header note)
_BIG = np.int64(1 << 62)
_SHADOW_LIMIT = float(1 << 62)

# ---------------------------------------------------------------------------
# aggregate definitions: (aggname, family) -> slots + finalizer + rettype
# family: 'i2','i4','i8','f4','f8','num','any'(count), pair aggs use 'f8f8'
# ---------------------------------------------------------------------------

_FAMILY = {T.INT2: "i2", T.INT4: "i4", T.INT8: "i8",
           T.FLOAT4: "f4", T.FLOAT8: "f8", T.NUMERIC: "num"}


@dataclasses.dataclass(frozen=True)
class AggDef:
    slots: tuple[str, ...]
    final: Callable[..., Any]          # final(merged: dict) -> python value
    rettype: T
    nargs: int = 1


def _final_count(m):
    return m["count"]


def _final_nrows(m):
    return m["nrows"]


def _final_sum_small_int(m):
    # sum(int2/int4) -> bigint
    if m["count"] == 0:
        return None
    from ..pgops import check_int_range
    return check_int_range(T.INT8, m["sum_i"])


def _final_sum_int8(m):
    # sum(int8) -> numeric
    if m["count"] == 0:
        return None
    return Decimal(m["sum_i"])


def _final_sum_f4(m):
    if m["count"] == 0:
        return None
    return float(np.float32(m["sum_f"]))


def _final_sum_f8(m):
    if m["count"] == 0:
        return None
    return float(m["sum_f"])


def _final_sum_num(m):
    if m["count"] == 0:
        return None
    return pgn.round_to_scale(m["sum_num"], m["maxdscale"])


def _final_avg_int(m):
    if m["count"] == 0:
        return None
    return pgn.int_avg(m["sum_i"], m["count"])


def _final_avg_f(m):
    if m["count"] == 0:
        return None
    return float(m["sum_f"]) / float(m["count"])


def _final_avg_num(m):
    if m["count"] == 0:
        return None
    return pgn.num_div(pgn.round_to_scale(m["sum_num"], m["maxdscale"]),
                       Decimal(m["count"]))


def _final_max(m):
    return m["max"]


def _final_min(m):
    return m["min"]


def _stddev_int_like(variance: bool, sample: bool):
    def f(m):
        return pgn.numeric_stddev_internal(
            m["count"], Decimal(m["sum_i"]), Decimal(m["sumsq_i"]),
            variance, sample)
    return f


def _stddev_num(variance: bool, sample: bool):
    def f(m):
        if m["count"] == 0 or (sample and m["count"] == 1):
            return None
        return pgn.numeric_stddev_internal(
            m["count"], pgn.round_to_scale(m["sum_num"], m["maxdscale"]),
            m["sumsq_num"], variance, sample)
    return f


def _stddev_float(variance: bool, sample: bool):
    def f(m):
        n = m["count"]
        if n == 0 or (sample and n <= 1):
            return None
        sx, sx2 = float(m["sum_f"]), float(m["sumsq_f"])
        numerator = n * sx2 - sx * sx
        if numerator <= 0.0:
            return 0.0
        denom = n * (n - 1) if sample else n * n
        v = numerator / denom
        return v if variance else float(np.sqrt(v))
    return f


def _final_corr(m):
    n = m["count"]
    if n < 1:
        return None
    sx, sy = float(m["sum_x"]), float(m["sum_y"])
    sxx = n * float(m["sumsq_x"]) - sx * sx
    syy = n * float(m["sumsq_y"]) - sy * sy
    sxy = n * float(m["sum_xy"]) - sx * sy
    if sxx <= 0.0 or syy <= 0.0:
        return None
    return sxy / float(np.sqrt(sxx * syy))


def _final_covar(sample: bool):
    def f(m):
        n = m["count"]
        if n < (2 if sample else 1):
            return None
        sxy = n * float(m["sum_xy"]) - float(m["sum_x"]) * float(m["sum_y"])
        return sxy / (n * (n - 1) if sample else n * n)
    return f


AGG_CATALOG: dict[tuple[str, str], AggDef] = {}


def _adef(name: str, fam: str, slots: tuple[str, ...], final, ret: T, nargs=1):
    AGG_CATALOG[(name, fam)] = AggDef(slots, final, ret, nargs)


for fam in ("i2", "i4", "i8", "f4", "f8", "num", "any"):
    _adef("count", fam, ("count",), _final_count, T.INT8)
_adef("count", "star", ("nrows",), _final_nrows, T.INT8, nargs=0)

for fam in ("i2", "i4"):
    _adef("sum", fam, ("count", "sum_i"), _final_sum_small_int, T.INT8)
    _adef("avg", fam, ("count", "sum_i"), _final_avg_int, T.NUMERIC)
_adef("sum", "i8", ("count", "sum_i"), _final_sum_int8, T.NUMERIC)
_adef("avg", "i8", ("count", "sum_i"), _final_avg_int, T.NUMERIC)
_adef("sum", "f4", ("count", "sum_f"), _final_sum_f4, T.FLOAT4)
_adef("sum", "f8", ("count", "sum_f"), _final_sum_f8, T.FLOAT8)
_adef("avg", "f4", ("count", "sum_f"), _final_avg_f, T.FLOAT8)
_adef("avg", "f8", ("count", "sum_f"), _final_avg_f, T.FLOAT8)
_adef("sum", "num", ("count", "sum_num", "maxdscale"), _final_sum_num, T.NUMERIC)
_adef("avg", "num", ("count", "sum_num", "maxdscale"), _final_avg_num, T.NUMERIC)

_MINMAX_RET = {"i2": T.INT2, "i4": T.INT4, "i8": T.INT8,
               "f4": T.FLOAT4, "f8": T.FLOAT8, "num": T.NUMERIC}
for fam, ret in _MINMAX_RET.items():
    _adef("max", fam, ("max",), _final_max, ret)
    _adef("min", fam, ("min",), _final_min, ret)
# text/date/time/timestamp/bool min-max share the sentinel path
for fam, ret in (("text", T.TEXT), ("date", T.DATE), ("time", T.TIME),
                 ("timestamp", T.TIMESTAMP), ("bool", T.BOOL)):
    _FAMILY.setdefault({"text": T.TEXT, "date": T.DATE, "time": T.TIME,
                        "timestamp": T.TIMESTAMP, "bool": T.BOOL}[fam], fam)
    _adef("max", fam, ("max",), _final_max, ret)
    _adef("min", fam, ("min",), _final_min, ret)

for sname, variance, sample in (("stddev", False, True),
                                ("stddev_samp", False, True),
                                ("stddev_pop", False, False),
                                ("variance", True, True),
                                ("var_samp", True, True),
                                ("var_pop", True, False)):
    for fam in ("i2", "i4", "i8"):
        _adef(sname, fam, ("count", "sum_i", "sumsq_i"),
              _stddev_int_like(variance, sample), T.NUMERIC)
    for fam in ("f4", "f8"):
        _adef(sname, fam, ("count", "sum_f", "sumsq_f"),
              _stddev_float(variance, sample), T.FLOAT8)
    _adef(sname, "num", ("count", "sum_num", "maxdscale", "sumsq_num"),
          _stddev_num(variance, sample), T.NUMERIC)

_PAIR_SLOTS = ("count", "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y")
_adef("corr", "f8f8", _PAIR_SLOTS, _final_corr, T.FLOAT8, nargs=2)
_adef("covar_pop", "f8f8", _PAIR_SLOTS, _final_covar(False), T.FLOAT8, nargs=2)
_adef("covar_samp", "f8f8", _PAIR_SLOTS, _final_covar(True), T.FLOAT8, nargs=2)


def agg_family(t: T) -> str:
    return _FAMILY.get(t, "any")


def lookup_agg(aggname: str, argtypes: Sequence[T], star: bool = False) -> tuple[AggDef, str]:
    """Resolve an Aggref to its AggDef (+ canonical family key).

    corr/covar cast args to float8 (like PG); count accepts anything."""
    if aggname == "count":
        fam = "star" if star else agg_family(argtypes[0]) if argtypes else "star"
        if star or not argtypes:
            return AGG_CATALOG[("count", "star")], "star"
        use = fam if ("count", fam) in AGG_CATALOG else "any"
        return AGG_CATALOG[("count", use)], use
    if aggname in ("corr", "covar_pop", "covar_samp"):
        return AGG_CATALOG[(aggname, "f8f8")], "f8f8"
    fam = agg_family(argtypes[0])
    key = (aggname, fam)
    if key not in AGG_CATALOG:
        raise TypeError(f"function {aggname}({argtypes[0].value}) does not exist")
    return AGG_CATALOG[key], fam


# ---------------------------------------------------------------------------
# device kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggInstance:
    """One aggregate in the target list, bound to lowered arg expressions."""
    aggname: str
    family: str
    slots: tuple[str, ...]
    args: tuple[Expr, ...]   # bound arg expressions (cast already applied)
    distinct: bool = False   # agg(DISTINCT x): runs on the host-exact tier


def _seg(vals: jnp.ndarray, seg_id, G: int, how: str) -> jnp.ndarray:
    if seg_id is None:
        # ungrouped: ONE group in slot 0 — a direct streaming reduction
        # instead of a scatter.
        # Dead lanes already carry the reduction identity via masking.
        r = {"sum": jnp.sum, "min": jnp.min, "max": jnp.max}[how](vals)
        return jnp.concatenate([r[None], jnp.zeros((G - 1,), r.dtype)])
    if (how == "sum" and jnp.issubdtype(vals.dtype, jnp.floating)
            and not backend.ordered_float_scatter()):
        return _ordered_segment_sum(vals, seg_id, G)
    f = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
         "max": jax.ops.segment_max}[how]
    return f(vals, seg_id, num_segments=G)


def _ordered_segment_sum(vals: jnp.ndarray, seg_id, G: int) -> jnp.ndarray:
    """Float segment sum whose addition order depends only on the data:
    rows sorted stably by segment, then a segmented associative scan (a
    fixed tree of adds), and each segment's last prefix scattered to its
    slot (one writer per slot).  Ids outside [0, G) are dropped, as in
    jax.ops.segment_sum."""
    n = vals.shape[0]
    if n == 0:
        return jnp.zeros(G, vals.dtype)
    order = jnp.argsort(seg_id, stable=True)
    s = seg_id[order]
    v = vals[order]
    edge = s[1:] != s[:-1]
    start = jnp.concatenate([jnp.ones(1, jnp.bool_), edge])
    last = jnp.concatenate([edge, jnp.ones(1, jnp.bool_)])

    def add(a, b):
        (va, fa), (vb, fb) = a, b
        return jnp.where(fb, vb, va + vb), fa | fb

    csum, _ = jax.lax.associative_scan(add, (v, start))
    tgt = jnp.where(last & (s >= 0) & (s < G), s, G)
    return jnp.zeros(G, vals.dtype).at[tgt].set(csum, mode="drop")


def _gref(garr: jnp.ndarray, seg_id) -> jnp.ndarray:
    """Broadcast per-group array back to rows (group 0 when ungrouped)."""
    return garr[0] if seg_id is None else garr[seg_id]


_DENSE_KEY_TYPES = (T.BOOL, T.INT2, T.INT4, T.DATE, T.TEXT, T.BPCHAR,
                    T.INT8, T.TIME, T.TIMESTAMP)


def _bucket_ids(keys, mask: jnp.ndarray, salt, G: int) -> jnp.ndarray:
    """Per-row bucket id in [0, G); rows outside `mask` get G (dropped).

    A single narrow int-lane key (ints, date, dict-coded text) whose chunk
    value range fits the bucket count uses DENSE range bucketing
    (bucket = key - min(key); NULL keys get their own bucket at range+1) —
    collision-free by construction, so the executor's salt/escalation retry
    ladder never fires for the common small-key GROUP BY.  Everything else
    falls back to salted-hash buckets with host-verified key constancy.
    The dense test is per-chunk and in-trace: no host round trip, no stats."""
    hs = [hash_column32(k.t, k.data, k.valid,
                        k.exp if k.t is T.NUMERIC else None,
                        getattr(k, "bits", None)) for k in keys]
    h = _mix32(combine_hashes32(hs) ^ salt.astype(jnp.uint32))
    bucket = (h & jnp.uint32(G - 1)).astype(jnp.int32)
    if len(keys) == 1 and keys[0].t in _DENSE_KEY_TYPES:
        k = keys[0]
        okk = mask & k.valid
        kd = k.data.astype(jnp.int64)
        # int64 extremes: an int8 key >= 2^62 must not lose to the sentinel
        big = jnp.int64((1 << 63) - 1)
        kmin = jnp.min(jnp.where(okk, kd, big))
        kmax = jnp.max(jnp.where(okk, kd, jnp.int64(-(1 << 63))))
        # int64 wrap on a huge range flips rng negative -> dense_ok False
        rng = kmax - kmin
        # <= G-2 leaves bucket rng+1 free for the NULL-key group
        dense_ok = (rng >= jnp.int64(0)) & (rng <= jnp.int64(G - 2))
        dense = jnp.where(k.valid, (kd - kmin).astype(jnp.int32),
                          (rng + 1).astype(jnp.int32))
        bucket = jnp.where(dense_ok, dense, bucket)
    return jnp.where(mask, bucket, jnp.int32(G))


def _ndigits(m_abs: jnp.ndarray) -> jnp.ndarray:
    """decimal digit count of |mant| lanes (0 -> 0)."""
    nd = jnp.zeros_like(m_abs, dtype=jnp.int32)
    for k in range(19):
        nd = nd + (m_abs >= jnp.int64(10 ** k)).astype(jnp.int32)
    return nd


_P10 = np.array([10 ** k for k in range(19)], dtype=np.int64)


def _num_sort_keys(mant: jnp.ndarray, exp: jnp.ndarray):
    """(primary, secondary) int64 keys ordering numeric values exactly.

    primary  = sign * (decimal_magnitude + 64)   (0 for zero)
    secondary= sign * mantissa_normalized_to_18_digits"""
    m_abs = jnp.abs(mant)
    sign = jnp.sign(mant)
    nd = _ndigits(m_abs)
    E = nd + exp.astype(jnp.int32)
    p = jnp.where(mant == 0, jnp.int64(0),
                  sign * (E.astype(jnp.int64) + 64))
    shift = jnp.clip(18 - nd, 0, 18)
    m18 = m_abs * jnp.asarray(_P10)[shift]
    s = jnp.where(mant == 0, jnp.int64(0), sign * m18)
    return p, s


def _slot_compute(kind: str, inst_args: list[DVal], mask: jnp.ndarray,
                  seg_id: jnp.ndarray, G: int, lw: Lowerer,
                  row_idx: jnp.ndarray) -> dict[str, jnp.ndarray]:
    """Compute one partial slot over segments. Lanes are in sorted order."""
    a = inst_args[0] if inst_args else None
    ok = mask if a is None else (mask & a.valid)
    if len(inst_args) == 2:
        ok = mask & inst_args[0].valid & inst_args[1].valid

    if kind == "nrows":
        return {"nrows": _seg(mask.astype(jnp.int64), seg_id, G, "sum")}
    if kind == "count":
        return {"count": _seg(ok.astype(jnp.int64), seg_id, G, "sum")}

    if kind == "sum_i":
        x = jnp.where(ok, a.data.astype(jnp.int64), jnp.int64(0))
        s = _seg(x, seg_id, G, "sum")
        shadow = _seg(jnp.where(ok, a.data.astype(jnp.float64), 0.0), seg_id, G, "sum")
        bad = jnp.abs(shadow) > _SHADOW_LIMIT
        lw.err = jnp.maximum(lw.err, jnp.where(bad.any(), jnp.uint8(ERR_CPU_RECHECK),
                                               jnp.uint8(0)))
        return {"sum_i": s}

    if kind == "sumsq_i":
        x = jnp.where(ok, a.data.astype(jnp.int64), jnp.int64(0))
        if a.t is T.INT2:
            x2 = x * x  # <= 2^30/row: direct int64 sum is safe to 2^32 rows
            return {"sumsq_i_lo": _seg(x2, seg_id, G, "sum"),
                    "sumsq_i_hi": _seg(jnp.zeros_like(x2), seg_id, G, "sum")}
        if a.t is T.INT8:
            # rows with |x| >= 2^31 square out of int64: defer to host
            big = ok & (jnp.abs(x) >= jnp.int64(1 << 31))
            lw.err = jnp.maximum(lw.err, jnp.where(big.any(),
                                                   jnp.uint8(ERR_CPU_RECHECK),
                                                   jnp.uint8(0)))
        x2 = x * x  # < 2^62 given |x| < 2^31
        hi = x2 >> 30
        lo = x2 & jnp.int64((1 << 30) - 1)
        return {"sumsq_i_hi": _seg(hi, seg_id, G, "sum"),
                "sumsq_i_lo": _seg(lo, seg_id, G, "sum")}

    if kind in ("sum_f", "sumsq_f"):
        x = jnp.where(ok, a.data.astype(jnp.float64), 0.0)
        v = x * x if kind == "sumsq_f" else x
        out = _seg(v, seg_id, G, "sum")
        # any inf in the partial (or per-row square) means the f64 range
        # was exceeded — the host replay decides whether PostgreSQL
        # raises (CHECKFLOATVAL) or the value is representable
        bad = jnp.isinf(out).any() | jnp.isinf(v).any()
        if kind == "sum_f" and a.t is T.FLOAT4:
            # PG sums float4 stepwise in f32: a sequential prefix can
            # overflow even when the total is finite; if the absolute mass
            # could reach f32-inf territory, replay sequentially on host
            absmass = _seg(jnp.abs(x), seg_id, G, "sum")
            bad = bad | (absmass > 3.0e38).any() | jnp.isinf(absmass).any()
        lw.err = jnp.maximum(lw.err, jnp.where(bad, jnp.uint8(ERR_CPU_RECHECK),
                                               jnp.uint8(0)))
        return {kind: out}

    if kind in ("sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y"):
        x = jnp.where(ok, inst_args[0].data.astype(jnp.float64), 0.0)
        y = jnp.where(ok, inst_args[1].data.astype(jnp.float64), 0.0)
        v = {"sum_x": x, "sum_y": y, "sum_xy": x * y,
             "sumsq_x": x * x, "sumsq_y": y * y}[kind]
        out = _seg(v, seg_id, G, "sum")
        bad = jnp.isinf(out).any() | jnp.isinf(v).any()
        lw.err = jnp.maximum(lw.err, jnp.where(bad, jnp.uint8(ERR_CPU_RECHECK),
                                               jnp.uint8(0)))
        return {kind: out}

    if kind in ("sum_num", "maxdscale", "sumsq_num"):
        return _slot_num_sum(kind, a, ok, seg_id, G, lw)

    if kind in ("min", "max"):
        return _slot_minmax(kind, a, ok, seg_id, G, lw, row_idx)

    raise ValueError(f"unknown slot kind {kind}")


def _slot_num_sum(kind: str, a: DVal, ok: jnp.ndarray, seg_id: jnp.ndarray,
                  G: int, lw: Lowerer) -> dict[str, jnp.ndarray]:
    mant = jnp.where(ok, a.data, jnp.int64(0))
    exp = jnp.where(ok, a.exp.astype(jnp.int32), jnp.int32(127))
    if kind == "maxdscale":
        ds = getattr(a, "dscale_lane")
        return {"maxdscale": _seg(jnp.where(ok, ds, jnp.int32(0)), seg_id, G, "max")}
    if kind == "sumsq_num":
        big = ok & (jnp.abs(mant) > jnp.int64(3_000_000_000))
        lw.err = jnp.maximum(lw.err, jnp.where(big.any(), jnp.uint8(ERR_CPU_RECHECK),
                                               jnp.uint8(0)))
        mant = mant * mant
        exp = jnp.where(ok, (a.exp * 2).astype(jnp.int32), jnp.int32(127))
    # per-group min exponent, then align mantissas to it
    gexp = _seg(exp, seg_id, G, "min")           # invalid rows carry +127
    gexp = jnp.where(gexp == 127, jnp.int32(0), gexp)
    delta = jnp.clip(exp.astype(jnp.int32) - _gref(gexp, seg_id), 0, 127)
    p = jnp.asarray(_P10)[jnp.clip(delta, 0, 18)]
    lim = jnp.asarray(_POW10_LIMIT_NP)[jnp.clip(delta, 0, 18)]
    ovf = ok & ((delta > 18) | (jnp.abs(mant) > lim))
    lw.err = jnp.maximum(lw.err, jnp.where(ovf.any(), jnp.uint8(ERR_CPU_RECHECK),
                                           jnp.uint8(0)))
    aligned = jnp.where(ok, mant * jnp.where(ovf, jnp.int64(1), p), jnp.int64(0))
    s = _seg(aligned, seg_id, G, "sum")
    shadow = _seg(jnp.where(ok, mant.astype(jnp.float64), 0.0) *
                  jnp.asarray(_P10).astype(jnp.float64)[jnp.clip(delta, 0, 18)],
                  seg_id, G, "sum")
    bad = jnp.abs(shadow) > _SHADOW_LIMIT
    lw.err = jnp.maximum(lw.err, jnp.where(bad.any(), jnp.uint8(ERR_CPU_RECHECK),
                                           jnp.uint8(0)))
    pre = "sumsq_num" if kind == "sumsq_num" else "sum_num"
    return {f"{pre}_mant": s, f"{pre}_exp": gexp}


_POW10_LIMIT_NP = np.array([( (1 << 63) - 1) // (10 ** k) for k in range(19)],
                           dtype=np.int64)


def _slot_minmax(kind: str, a: DVal, ok: jnp.ndarray, seg_id: jnp.ndarray,
                 G: int, lw: Lowerer, row_idx: jnp.ndarray) -> dict[str, jnp.ndarray]:
    how = "min" if kind == "min" else "max"
    if a.t is T.NUMERIC:
        n = a.data.shape[0]
        p, s = _num_sort_keys(a.data, a.exp)
        sent = _BIG if kind == "min" else -_BIG
        pm = jnp.where(ok, p, sent)
        gp = _seg(pm, seg_id, G, how)
        on_p = ok & (p == _gref(gp, seg_id))
        sm = jnp.where(on_p, s, sent)
        gs = _seg(sm, seg_id, G, how)
        on_s = on_p & (s == _gref(gs, seg_id))
        # winners all share (mant,exp) (normalized repr is canonical); only
        # dscale can differ — PG's numeric_larger keeps the FIRST-seen value,
        # so pick the winner with the smallest original row index, then map
        # it back to its position in these (sorted-order) lanes for the gather
        ridx = jnp.where(on_s, row_idx.astype(jnp.int64), _BIG)
        gmin_orig = _seg(ridx, seg_id, G, "min")
        pos = jnp.arange(n, dtype=jnp.int64)
        sel = on_s & (row_idx.astype(jnp.int64) == _gref(gmin_orig, seg_id))
        gpos = _seg(jnp.where(sel, pos, _BIG), seg_id, G, "min")
        gi_c = jnp.clip(gpos, 0, max(n - 1, 0)).astype(jnp.int32)
        has = gmin_orig < _BIG
        ds = getattr(a, "dscale_lane")
        return {f"{kind}_mant": jnp.where(has, a.data[gi_c], jnp.int64(0)),
                f"{kind}_exp": jnp.where(has, a.exp[gi_c], jnp.int32(0)),
                f"{kind}_dscale": jnp.where(has, ds[gi_c], jnp.int32(0)),
                f"{kind}_has": has}
    if a.t is T.FLOAT8 and getattr(a, "bits", None) is not None:
        from ..expr.lower_jax import _f64_orderkey
        key = _f64_orderkey(a.bits)
        # sentinel must beat EVERY real order key: doubles >= 2.0 have
        # okey >= 2^62 (bits of 2.0 are 0x4000...), so a 2^62 sentinel
        # used to WIN the min for any group whose true min was >= 2.0 and
        # decode as a phantom 2.0 (caught by the differential fuzzer);
        # int64 extremes are unreachable (0x7FFF.. is a NaN payload no
        # ingestion path produces, and the has-lane guards empty groups)
        sent = jnp.int64((1 << 63) - 1) if kind == "min" \
            else jnp.int64(-(1 << 63))
        x = jnp.where(ok, key, sent)
        g = _seg(x, seg_id, G, how)
        return {f"{kind}_okey": g,
                f"{kind}_has": _seg(ok.astype(jnp.int32), seg_id, G, "max") > 0}
    if a.t in (T.FLOAT4, T.FLOAT8):
        dt = a.data.dtype
        sent = jnp.array(np.inf if kind == "min" else -np.inf, dtype=dt)
        x = jnp.where(ok, a.data, sent)
        g = _seg(x, seg_id, G, how)
        return {kind: g, f"{kind}_has": _seg(ok.astype(jnp.int32), seg_id, G, "max") > 0}
    info = jnp.iinfo(a.data.dtype) if a.data.dtype != jnp.bool_ else None
    if a.data.dtype == jnp.bool_:
        x = jnp.where(ok, a.data, kind == "min")
        g = _seg(x.astype(jnp.int32), seg_id, G, how).astype(jnp.bool_)
    else:
        sent = info.max if kind == "min" else info.min
        x = jnp.where(ok, a.data, jnp.array(sent, dtype=a.data.dtype))
        g = _seg(x, seg_id, G, how)
    return {kind: g, f"{kind}_has": _seg(ok.astype(jnp.int32), seg_id, G, "max") > 0}


def build_preagg_fn(schema: Sequence[ColMeta], group_exprs: Sequence[Expr],
                    aggs: Sequence[AggInstance], pred: Optional[Expr],
                    G: int, strategy: str = "scatter",
                    reduce_route: Optional[str] = None) -> Callable:
    """Build f(cols, nrows, salt) -> chunk partials.

    reduce_route: the limb-matrix reduction formulation of the mxu
    strategies (preagg_mxu.mxu_reduce); None = the backend's choice.

    Grouping strategies:
      scatter — hash keys straight into G buckets and segment-reduce in
                *row order* (no sort, no full-length gathers).
                Per-bucket exactness check (segment min==max over every key
                plane) raises `collision`; the executor re-dispatches with a
                new salt and falls back to the sort strategy if collisions
                persist (two distinct keys genuinely sharing a bucket).
      sort    — hash-sort segmentation (the bitonic-ladder analog); exact
                for any group cardinality up to G, costlier per row.

    Output pytree:
      err      : uint8 scalar (max over rows; nonzero => host replays chunk)
      collision: bool scalar (scatter only)
      ngroups  : int32
      gmask    : bool[G] — which group slots are populated
      keys     : tuple per group expr of plane tuple
                 (data, valid) or (mant, valid, exp, dscale) for numeric,
                 (data, valid, bits) for float8
      slots    : tuple per agg of dict name->array[G]
    """
    group_exprs = list(group_exprs)
    aggs = list(aggs)

    def f(cols: tuple, nrows, salt):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)

        mask = live
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)

        keys = [lw.lower(g, mask) for g in group_exprs]
        # numeric DVals need a display-scale lane; plain column refs carry it
        # from the store, computed numeric expressions default to 0 (the
        # planner routes those to the host path for exact dscale semantics)
        def _attach_dscale(v: DVal):
            if v.t is T.NUMERIC and getattr(v, "dscale_lane", None) is None:
                v.dscale_lane = jnp.zeros(n, dtype=jnp.int32)
            return v

        for k in keys:
            _attach_dscale(k)
        arg_vals: list[list[DVal]] = []
        for inst in aggs:
            vs = [_attach_dscale(lw.lower(aexp, mask)) for aexp in inst.args]
            arg_vals.append(vs)

        collision = jnp.bool_(False)
        if group_exprs and strategy in ("mxu", "mxu_dense"):
            # limb-matrix grouping: ONE grouped reduction computes every
            # additive partial AND the per-bucket key-constancy sums; the
            # host recovers keys / detects collisions in exact big-int
            # arithmetic (see ops/preagg_mxu.py).  Non-additive slots
            # (min/max, numeric, f8 on the CPU) scatter over the same
            # buckets.
            #
            # mxu_dense (single int-lane key): bucket = key - min(key), so
            # the bucket INDEX recovers the key — the ~17 key
            # constancy/recovery columns are dropped entirely and collisions
            # are impossible.  A chunk whose key range exceeds G-2 raises
            # `dense_fail` and the executor re-dispatches the generic 'mxu'.
            from .preagg_mxu import (
                build_mxu_columns, mxu_reduce, mxu_recipes, mxu_shadow_cols,
                _kind_mxu_ok,
            )
            dense_key = strategy == "mxu_dense"
            if dense_key:
                k = keys[0]
                okk = mask & k.valid
                kd = k.data.astype(jnp.int64)
                # int64 extremes (an int8 key >= 2^62 must beat the sentinel)
                big = jnp.int64((1 << 63) - 1)
                any_ok = jnp.any(okk)
                kmin = jnp.where(any_ok, jnp.min(jnp.where(okk, kd, big)),
                                 jnp.int64(0))
                kmax = jnp.where(any_ok,
                                 jnp.max(jnp.where(okk, kd,
                                                   jnp.int64(-(1 << 63)))),
                                 jnp.int64(0))
                rng = kmax - kmin          # int64 wrap => negative => fail
                dense_fail = ~((rng >= 0) & (rng <= jnp.int64(G - 2)))
                seg = jnp.where(okk, jnp.clip(kd - kmin, 0, G - 1),
                                jnp.clip(rng + 1, 0, G - 1)).astype(jnp.int32)
                seg_id = jnp.where(mask, seg, jnp.int32(G))
            else:
                seg_id = _bucket_ids(keys, mask, salt, G)
            seg_id, mask = jax.lax.optimization_barrier((seg_id, mask))
            key_ts = [g.type for g in group_exprs]
            arg_ts = [tuple(a.type for a in inst.args) for inst in aggs]
            V, f4exps = build_mxu_columns(keys, aggs, arg_vals, mask, n,
                                          dense_key=dense_key)
            _, slotr_static, _ = mxu_recipes(key_ts, aggs, arg_ts,
                                             dense_key=dense_key)
            sums, fsums = mxu_reduce(
                V, seg_id, G, n, fsum_cols=mxu_shadow_cols(slotr_static),
                route=reduce_route)
            row_idx = jnp.arange(n, dtype=jnp.int64)
            slot_out = []
            for inst, vs in zip(aggs, arg_vals):
                d: dict[str, jnp.ndarray] = {}
                a_t = vs[0].t if vs else None
                for kind in inst.slots:
                    if _kind_mxu_ok(kind, a_t):
                        continue
                    d.update(_slot_compute(kind, vs, mask, seg_id, G, lw,
                                           row_idx))
                slot_out.append(d)
            out = {"err": jnp.max(lw.err) if n else jnp.uint8(0),
                   "mxu_sums": sums,
                   "mxu_fsums": fsums,
                   "mxu_f4exps": f4exps,
                   "slots": tuple(slot_out)}
            if dense_key:
                out["dense_kmin"] = kmin
                out["dense_rng"] = jnp.clip(rng, 0,
                                            (1 << 31) - 1).astype(jnp.int32)
                out["dense_fail"] = dense_fail
            return out
        if group_exprs and strategy == "scatter":
            seg_id = _bucket_ids(keys, mask, salt, G)
            # keep the hash chain out of the scatter fusions
            seg_id, mask = jax.lax.optimization_barrier((seg_id, mask))
            # lanes stay in row order: no sort, no gathers
            mask_s = mask
            args_s = arg_vals
            row_idx = jnp.arange(n, dtype=jnp.int64)
            nonempty = _seg(mask.astype(jnp.int32), seg_id, G, "max") > 0
            ngroups = jnp.sum(nonempty.astype(jnp.int32))
            # exactness: every key plane must be constant within its bucket
            for k in keys:
                collision = collision | _bucket_mixed(k, mask, seg_id, G,
                                                      nonempty)
            # representative = first row per bucket (PG shows first-seen)
            frow = jnp.clip(_seg(jnp.where(mask, row_idx, _BIG), seg_id, G, "min"),
                            0, max(n - 1, 0)).astype(jnp.int32)
            key_out = []
            for k in keys:
                planes = [jnp.where(nonempty, k.data[frow], 0),
                          k.valid[frow] & nonempty]
                if k.t is T.NUMERIC:
                    planes.append(k.exp[frow])
                    planes.append(getattr(k, "dscale_lane")[frow])
                elif k.t is T.FLOAT8 and getattr(k, "bits", None) is not None:
                    planes.append(k.bits[frow])
                key_out.append(tuple(planes))
            gmask = nonempty
        elif group_exprs:
            hs = [hash_column32(k.t, k.data, k.valid,
                                k.exp if k.t is T.NUMERIC else None,
                                getattr(k, "bits", None)) for k in keys]
            h = (combine_hashes32(hs) >> 2).astype(jnp.int32)
            hkey = jnp.where(mask, h, jnp.int32(1 << 30))
            from .sort import argsort_i32
            order = argsort_i32(hkey, n, vbits=31)
            mask_s = mask[order]
            keys_s = [_gather_dval(k, order) for k in keys]
            args_s = [[_gather_dval(v, order) for v in vs] for vs in arg_vals]
            same = mask_s & jnp.concatenate(
                [jnp.zeros(1, dtype=jnp.bool_),
                 _rows_equal(keys_s, slice(1, None), slice(0, -1))])
            new_seg = mask_s & ~same
            seg_id = jnp.clip(jnp.cumsum(new_seg.astype(jnp.int32)) - 1, 0, G - 1)
            ngroups = jnp.sum(new_seg.astype(jnp.int32))
            lw.err = jnp.maximum(lw.err, jnp.where(ngroups > G,
                                                   jnp.uint8(ERR_CPU_RECHECK),
                                                   jnp.uint8(0)))
            row_idx = order.astype(jnp.int64)
            # representative (first) row per group for key output
            pos = jnp.where(new_seg, jnp.arange(n, dtype=jnp.int64), _BIG)
            first_pos = jnp.clip(_seg(pos, seg_id, G, "min"), 0, max(n - 1, 0)).astype(jnp.int32)
            key_out = []
            gvalid = jnp.arange(G, dtype=jnp.int32) < ngroups
            for k in keys_s:
                planes = [k.data[first_pos], k.valid[first_pos] & gvalid]
                if k.t is T.NUMERIC:
                    planes.append(k.exp[first_pos])
                    planes.append(getattr(k, "dscale_lane",
                                          jnp.zeros(n, dtype=jnp.int32))[first_pos])
                elif k.t is T.FLOAT8 and getattr(k, "bits", None) is not None:
                    planes.append(k.bits[first_pos])
                key_out.append(tuple(planes))
            gmask = gvalid
        else:
            mask_s = mask
            args_s = arg_vals
            # seg_id None => _seg uses direct streaming reductions into
            # slot 0 (no scatter at all on the ungrouped path)
            seg_id = None
            ngroups = jnp.int32(1)
            row_idx = jnp.arange(n, dtype=jnp.int64)
            key_out = []
            gmask = jnp.concatenate([jnp.ones(1, jnp.bool_),
                                     jnp.zeros(G - 1, jnp.bool_)])

        slot_out = []
        for inst, vs in zip(aggs, args_s):
            d: dict[str, jnp.ndarray] = {}
            for kind in inst.slots:
                d.update(_slot_compute(kind, vs, mask_s, seg_id, G, lw, row_idx))
            slot_out.append(d)

        return {"err": jnp.max(lw.err) if n else jnp.uint8(0),
                "collision": collision,
                "ngroups": ngroups,
                "gmask": gmask,
                "keys": tuple(key_out),
                "slots": tuple(slot_out)}

    return f


def _remix(h: jnp.ndarray) -> jnp.ndarray:
    h = (h ^ (h >> 33)) * jnp.uint64(0xFF51AFD7ED558CCD)
    return h ^ (h >> 33)


def _bucket_mixed(k: DVal, mask: jnp.ndarray, seg_id: jnp.ndarray,
                  G: int, nonempty: jnp.ndarray) -> jnp.ndarray:
    """True if any bucket holds two SQL-distinct values of key column k.
    (Rows with NULL keys group together; a NULL/value mix in one bucket
    shows up via the validity lane.)"""
    lanes = []
    if k.t is T.FLOAT8 and getattr(k, "bits", None) is not None:
        from .hashing import canonical_f64_bits
        lanes.append(canonical_f64_bits(k.bits))
    elif k.t in (T.FLOAT4, T.FLOAT8):
        d = k.data
        d = jnp.where(d == 0, jnp.zeros_like(d), d)          # -0 == +0
        d = jnp.where(jnp.isnan(d), jnp.full_like(d, jnp.nan), d)
        import jax as _jax
        bits = _jax.lax.bitcast_convert_type(
            d.astype(jnp.float32 if k.t is T.FLOAT4 else jnp.float64),
            jnp.int32 if k.t is T.FLOAT4 else jnp.int64)
        lanes.append(bits.astype(jnp.int64))
    else:
        lanes.append(k.data.astype(jnp.int64))
        if k.t is T.NUMERIC:
            lanes.append(k.exp.astype(jnp.int64))
    # NULL rows carry zeroed data lanes; the validity lane distinguishes them
    lanes.append(k.valid.astype(jnp.int64))
    mixed = jnp.bool_(False)
    for lane in lanes:
        lo = _seg(lane, seg_id, G, "min")   # dead rows (seg G) are dropped
        hi = _seg(lane, seg_id, G, "max")
        mixed = mixed | jnp.any(nonempty & (lo != hi))
    return mixed


def _gather_dval(v: DVal, order: jnp.ndarray) -> DVal:
    out = DVal(v.t, v.data[order], v.valid[order],
               v.exp[order] if v.exp is not None else None)
    ds = getattr(v, "dscale_lane", None)
    if ds is not None:
        out.dscale_lane = ds[order]
    bits = getattr(v, "bits", None)
    if bits is not None:
        out.bits = bits[order]
    return out


def _rows_equal(keys_s: list[DVal], i, j) -> jnp.ndarray:
    """lane-wise: row[i] keys equal row[j] keys (NULLs equal for grouping)."""
    eq = None
    for k in keys_s:
        va, vb = k.valid[i], k.valid[j]
        da, db = k.data[i], k.data[j]
        kb = getattr(k, "bits", None)
        if k.t is T.FLOAT8 and kb is not None:
            from .hashing import canonical_f64_bits
            same_val = canonical_f64_bits(kb[i]) == canonical_f64_bits(kb[j])
        elif k.t in (T.FLOAT4, T.FLOAT8):
            da = jnp.where(da == 0, jnp.zeros_like(da), da)
            db = jnp.where(db == 0, jnp.zeros_like(db), db)
            same_val = (da == db) | (jnp.isnan(da) & jnp.isnan(db))
        else:
            same_val = da == db
        if k.t is T.NUMERIC:
            same_val = same_val & (k.exp[i] == k.exp[j])
        e = (va & vb & same_val) | (~va & ~vb)
        eq = e if eq is None else (eq & e)
    return eq if eq is not None else jnp.ones_like(keys_s)


# ---------------------------------------------------------------------------
# host: partial extraction, merge, finalize
# ---------------------------------------------------------------------------

def extract_partials(inst: AggInstance, arrays: dict[str, np.ndarray],
                     g: int, skip: tuple = (),
                     text_dict: tuple | None = None) -> dict[str, Any]:
    """python partial dict for group g from device slot arrays.

    `skip` names slot kinds computed elsewhere (the MXU matmul path).
    `text_dict` is the arg column's sorted dictionary for min/max over
    TEXT/BPCHAR: the device aggregates int32 dict CODES (the dictionary is
    order-preserving, datastore.py:138, so code order == C-collation
    order), and the code decodes to its string HERE so device partials
    merge type-consistently with host-replay partials (which hold
    strings, hostexec.update_state)."""
    out: dict[str, Any] = {}
    for kind in inst.slots:
        if kind in skip:
            continue
        if kind == "nrows":
            out["nrows"] = int(arrays["nrows"][g])
        elif kind == "count":
            out["count"] = int(arrays["count"][g])
        elif kind == "sum_i":
            out["sum_i"] = int(arrays["sum_i"][g])
        elif kind == "sumsq_i":
            out["sumsq_i"] = (int(arrays["sumsq_i_hi"][g]) << 30) + \
                int(arrays["sumsq_i_lo"][g])
        elif kind in ("sum_f", "sumsq_f", "sum_x", "sum_y", "sum_xy",
                      "sumsq_x", "sumsq_y"):
            out[kind] = float(arrays[kind][g])
        elif kind == "maxdscale":
            out["maxdscale"] = int(arrays["maxdscale"][g])
        elif kind in ("sum_num", "sumsq_num"):
            out[kind] = Decimal(int(arrays[f"{kind}_mant"][g])).scaleb(
                int(arrays[f"{kind}_exp"][g]))
        elif kind in ("min", "max"):
            out[kind] = _extract_minmax(kind, inst, arrays, g, text_dict)
        else:
            raise ValueError(kind)
    return out


def unflip_f64_orderkey(k: int) -> float:
    """Invert _f64_orderkey: int64 key -> exact float64 value."""
    if k < 0:
        bits = (-1 - k) + (-(1 << 63))
    else:
        bits = k
    return float(np.int64(bits).view(np.float64))


def _extract_minmax(kind: str, inst: AggInstance, arrays, g: int,
                    text_dict: tuple | None = None):
    if f"{kind}_okey" in arrays:  # float8 via exact bit order keys
        if not bool(arrays[f"{kind}_has"][g]):
            return None
        return unflip_f64_orderkey(int(arrays[f"{kind}_okey"][g]))
    if f"{kind}_mant" in arrays:  # numeric
        if not bool(arrays[f"{kind}_has"][g]):
            return None
        from ..sqltypes import numeric_to_decimal
        return numeric_to_decimal(int(arrays[f"{kind}_mant"][g]),
                                  int(arrays[f"{kind}_exp"][g]),
                                  int(arrays[f"{kind}_dscale"][g]))
    if not bool(arrays[f"{kind}_has"][g]):
        return None
    v = arrays[kind][g]
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if text_dict is not None:
        return text_dict[int(v)]
    return int(v)


def merge_partials(inst: AggInstance, a: dict[str, Any],
                   b: dict[str, Any]) -> dict[str, Any]:
    out = dict(a)
    for kind in inst.slots:
        if kind in ("nrows", "count", "sum_i", "sumsq_i"):
            out[kind] = a[kind] + b[kind]
        elif kind in ("sum_f", "sumsq_f", "sum_x", "sum_y", "sum_xy",
                      "sumsq_x", "sumsq_y"):
            out[kind] = a[kind] + b[kind]
        elif kind in ("sum_num", "sumsq_num"):
            out[kind] = a[kind] + b[kind]
        elif kind == "maxdscale":
            out[kind] = max(a[kind], b[kind])
        elif kind in ("min", "max"):
            out[kind] = _merge_minmax(kind, a[kind], b[kind])
    return out


def _merge_minmax(kind: str, x, y):
    from ..pgops import cmp_values
    if x is None:
        return y
    if y is None:
        return x
    c = cmp_values(y, x)
    # first-seen (x) wins ties, matching PG's {min,max}_larger transition
    if kind == "max":
        return y if c > 0 else x
    return y if c < 0 else x
