"""Lowering of typed expression trees to JAX (the device compute path).

Replaces the reference's codegen.c expression walker (codegen.c:1065-1392)
which emitted OpenCL C.  Here the same tree is *traced* into an XLA program:
each SQL value becomes struct-of-arrays lanes

    DVal(data, valid[, exp])      # exp lane only for NUMERIC

and errors become a per-row uint8 code lane, max-merged so the most severe
error wins (the kern_writeback_error_status analog, opencl_common.h:1481).
Error contributions are masked by a `live` lane (rows actually being
evaluated — rows beyond nrows, NULL-strict argument rows, and untaken CASE
branches never raise), which reproduces PostgreSQL's lazy evaluation
semantics on a data-parallel device.

Device numeric is (mant int64, exp int32) with the reference's representable
window (|mant| < 2^57, exp in [-32,31], opencl_numeric.h); any op leaving the
window writes ERR_CPU_RECHECK instead of a wrong answer.
"""

from __future__ import annotations

import bisect
import dataclasses
from functools import partial
from typing import Any, Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..sqltypes import T, STORAGE_DTYPE, INT_BOUNDS, NUMERIC_MAX_MANT
from ..errors import (
    ERR_CPU_RECHECK, ERR_DIV_BY_ZERO, ERR_INT2_OVERFLOW, ERR_INT4_OVERFLOW,
    ERR_INT8_OVERFLOW, ERR_FLOAT_OVERFLOW, ERR_FLOAT_UNDERFLOW,
)
from .ir import (Expr, Const, ColumnRef, Param, FuncExpr, BoolExpr, NullTest,
                 BooleanTest, CaseExpr, CoalesceExpr)
from .catalog import entry_for_funcexpr

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

# 10^k tables for numeric rescaling (k in [0,18]; >18 always overflows i64)
_POW10 = np.array([10 ** k for k in range(19)], dtype=np.int64)
_POW10_LIMIT = np.array([INT64_MAX // (10 ** k) for k in range(19)],
                        dtype=np.int64)
_POW10_F64 = np.array([10.0 ** k for k in range(-40, 41)], dtype=np.float64)

_INT_OVF_ERR = {T.INT2: ERR_INT2_OVERFLOW, T.INT4: ERR_INT4_OVERFLOW,
                T.INT8: ERR_INT8_OVERFLOW}


@dataclasses.dataclass
class ColMeta:
    """Static (trace-time) metadata of one input slot."""
    name: str
    type: T
    dictionary: Optional[tuple[str, ...]] = None  # text columns
    dict_id: int = -1   # identity token; equal ids => comparable codes


@dataclasses.dataclass
class DVal:
    t: T
    data: jnp.ndarray
    valid: jnp.ndarray
    exp: Optional[jnp.ndarray] = None  # NUMERIC only


class Lowerer:
    """One lowering session over a fixed input schema.

    cols[i] is the runtime plane tuple for slot i:
      non-numeric: (data, valid) ; numeric: (data, valid, exp)
    """

    def __init__(self, schema: Sequence[ColMeta], cols: Sequence[tuple],
                 base_live: jnp.ndarray, params: Sequence[Any] = ()):
        self.schema = list(schema)
        self.cols = list(cols)
        self.base_live = base_live
        self.params = list(params)
        self.n = base_live.shape[0]
        # scalar until the first vector raise: full-length constant lanes
        # bloat every executable
        self.err = jnp.uint8(0)

    # -- error plumbing ------------------------------------------------------

    def _raise(self, cond: jnp.ndarray, code: int, live: jnp.ndarray) -> None:
        e = jnp.where(cond & live, jnp.uint8(code), jnp.uint8(0))
        self.err = jnp.maximum(self.err, e)

    # -- entry ---------------------------------------------------------------

    def lower(self, e: Expr, live: jnp.ndarray) -> DVal:
        if isinstance(e, Const):
            return self._lower_const(e, live)
        if isinstance(e, Param):
            return self._lower_pyvalue(e.type, self.params[e.index], live)
        if isinstance(e, ColumnRef):
            if e.index < 0:
                # -1 would silently index the LAST column's planes
                # (round-5 fuzzer find on the distributed filter path)
                raise RuntimeError(
                    f"unbound column ref {e.name} reached device lowering")
            planes = self.cols[e.index]
            meta = self.schema[e.index]
            if meta.type is T.NUMERIC:
                v = DVal(T.NUMERIC, planes[0], planes[1], planes[2])
                if len(planes) >= 4:  # display-scale plane (aggregation uses it)
                    v.dscale_lane = planes[3]
                return v
            v = DVal(meta.type, planes[0], planes[1])
            if meta.type is T.FLOAT8 and len(planes) >= 3:
                v.bits = planes[2]  # exact IEEE bits (see planes_of_column)
            return v
        if isinstance(e, FuncExpr):
            return self._lower_func(e, live)
        if isinstance(e, BoolExpr):
            return self._lower_bool(e, live)
        if isinstance(e, NullTest):
            v = self.lower(e.arg, live)
            d = (~v.valid) if e.isnull else v.valid
            return DVal(T.BOOL, d, jnp.ones_like(d, dtype=jnp.bool_))
        if isinstance(e, BooleanTest):
            v = self.lower(e.arg, live)
            tv = v.valid & v.data.astype(jnp.bool_)
            fv = v.valid & ~v.data.astype(jnp.bool_)
            uv = ~v.valid
            d = {"is_true": tv, "is_not_true": ~tv, "is_false": fv,
                 "is_not_false": ~fv, "is_unknown": uv,
                 "is_not_unknown": ~uv}[e.test]
            return DVal(T.BOOL, d, jnp.ones_like(d, dtype=jnp.bool_))
        if isinstance(e, CaseExpr):
            return self._lower_case(e, live)
        if isinstance(e, CoalesceExpr):
            vals = [self.lower(a, live) for a in e.args]
            out = vals[-1]
            for v in reversed(vals[:-1]):
                out = _select(v.valid, v, out)
            return out
        raise TypeError(f"cannot lower {type(e)}")

    # -- leaves --------------------------------------------------------------

    def _template(self, live: jnp.ndarray) -> jnp.ndarray:
        return live  # any per-row bool lane gives us the shape

    def _lower_pyvalue(self, t: T, v: Any, live: jnp.ndarray) -> DVal:
        # constants lower as SCALAR lanes; jnp broadcasting handles the rest
        if v is None:
            dt = STORAGE_DTYPE[t]
            z = jnp.zeros((), dtype=dt)
            return DVal(t, z, jnp.bool_(False),
                        jnp.zeros((), dtype=jnp.int32) if t is T.NUMERIC else None)
        if t is T.NUMERIC:
            from ..sqltypes import numeric_from_decimal
            from decimal import Decimal
            d = v if isinstance(v, Decimal) else Decimal(v)
            mant, exp, _, ok = numeric_from_decimal(d)
            if not ok:
                # constant outside device window: whole-expression recheck
                self._raise(jnp.bool_(True), ERR_CPU_RECHECK, live)
                mant, exp = 0, 0
            return DVal(t, jnp.int64(mant), jnp.bool_(True), jnp.int32(exp))
        if t in (T.TEXT, T.BPCHAR):
            raise NotImplementedError(
                "text constants lower inside comparisons only")
        dt = STORAGE_DTYPE[t]
        return DVal(t, jnp.array(v, dtype=dt), jnp.bool_(True))

    def _lower_const(self, e: Const, live: jnp.ndarray) -> DVal:
        return self._lower_pyvalue(e.type, e.value, live)

    # -- bool ----------------------------------------------------------------

    def _lower_bool(self, e: BoolExpr, live: jnp.ndarray) -> DVal:
        if e.op == "not":
            v = self.lower(e.args[0], live)
            return DVal(T.BOOL, ~v.data.astype(jnp.bool_), v.valid)
        vals = [self.lower(a, live) for a in e.args]
        if e.op == "and":
            # Kleene: false dominates null
            d = jnp.ones_like(live)
            allv = jnp.ones_like(live)
            for v in vals:
                dv = jnp.where(v.valid, v.data.astype(jnp.bool_), True)
                d = d & dv
                allv = allv & v.valid
            return DVal(T.BOOL, d, allv | ~d)
        if e.op == "or":
            d = jnp.zeros_like(live)
            allv = jnp.ones_like(live)
            for v in vals:
                dv = jnp.where(v.valid, v.data.astype(jnp.bool_), False)
                d = d | dv
                allv = allv & v.valid
            return DVal(T.BOOL, d, allv | d)
        raise ValueError(e.op)

    # -- CASE ----------------------------------------------------------------

    def _lower_case(self, e: CaseExpr, live: jnp.ndarray) -> DVal:
        taken = jnp.bool_(False)
        branches: list[tuple[jnp.ndarray, DVal]] = []
        for cond, res in e.whens:
            cv = self.lower(cond, live)
            fire = cv.valid & cv.data.astype(jnp.bool_) & ~taken
            rv = self.lower(res, live & fire)
            branches.append((fire, rv))
            taken = taken | fire
        if e.orelse is not None:
            ev = self.lower(e.orelse, live & ~taken)
            out = ev
        else:
            out = self._lower_pyvalue(e.type, None, live)
        for fire, rv in reversed(branches):
            out = _select(fire, rv, out)
        return out

    # -- function dispatch ---------------------------------------------------

    def _lower_func(self, e: FuncExpr, live: jnp.ndarray) -> DVal:
        entry = entry_for_funcexpr(e)
        kind = entry.kind

        # text comparison special case: needs dictionary metadata
        if kind[0] == "cmp" and kind[2] in (T.TEXT, T.BPCHAR):
            return self._lower_text_cmp(e, kind[1], live)

        args = [self.lower(a, live) for a in e.args]
        valid = jnp.ones_like(live)
        for a in args:
            valid = valid & a.valid
        alive = live & valid  # strict: errors only where args valid

        k0 = kind[0]
        if k0 == "int_arith":
            return self._int_arith(kind[1], kind[2], args[0], args[1], valid, alive)
        if k0 == "float_arith":
            return self._float_arith(kind[1], kind[2], args[0], args[1], valid, alive)
        if k0 == "num_arith":
            return self._num_arith(kind[1], args[0], args[1], valid, alive)
        if k0 == "int_neg":
            t = kind[1]
            r = -args[0].data.astype(jnp.int64)
            return self._int_result(t, r, valid, alive)
        if k0 == "int_abs":
            t = kind[1]
            r = jnp.abs(args[0].data.astype(jnp.int64))
            # abs(INT64_MIN) wraps; detect
            if t is T.INT8:
                self._raise(args[0].data == INT64_MIN, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if k0 == "float_neg":
            return DVal(kind[1], -args[0].data, valid)
        if k0 == "float_abs":
            return DVal(kind[1], jnp.abs(args[0].data), valid)
        if k0 == "num_neg":
            return DVal(T.NUMERIC, -args[0].data, valid, args[0].exp)
        if k0 == "num_abs":
            return DVal(T.NUMERIC, jnp.abs(args[0].data), valid, args[0].exp)
        if k0 == "cmp":
            return self._cmp(kind[1], args[0], args[1], valid)
        if k0 == "cast":
            return self._cast(kind[1], kind[2], args[0], valid, alive)
        if k0 == "math1":
            return self._math1(kind[1], args[0], valid, alive)
        if k0 == "math2":
            return self._math2(kind[1], args[0], args[1], valid, alive)
        if k0 == "const_pi":
            return DVal(T.FLOAT8, jnp.float64(np.pi), jnp.bool_(True))
        if k0 == "bit":
            return self._bit(kind[1], kind[2], args, valid)
        if k0 == "date_pl_int":
            r = args[0].data.astype(jnp.int32) + args[1].data.astype(jnp.int32)
            return DVal(T.DATE, r, valid)
        if k0 == "date_mi_int":
            r = args[0].data.astype(jnp.int32) - args[1].data.astype(jnp.int32)
            return DVal(T.DATE, r, valid)
        if k0 == "date_mi_date":
            r = args[0].data.astype(jnp.int32) - args[1].data.astype(jnp.int32)
            return DVal(T.INT4, r, valid)
        if k0 == "date_pl_time":
            r = (args[0].data.astype(jnp.int64) * jnp.int64(86_400_000_000)
                 + args[1].data.astype(jnp.int64))
            return DVal(T.TIMESTAMP, r, valid)
        if k0 == "time_pl_date":
            r = (args[1].data.astype(jnp.int64) * jnp.int64(86_400_000_000)
                 + args[0].data.astype(jnp.int64))
            return DVal(T.TIMESTAMP, r, valid)
        raise NotImplementedError(f"no device lowering for kind {kind}")

    # -- integer arithmetic with PG overflow semantics ----------------------

    def _int_result(self, t: T, wide: jnp.ndarray, valid: jnp.ndarray,
                    alive: jnp.ndarray) -> DVal:
        """wide is int64; range-check into t and narrow."""
        if t is not T.INT8:
            lo, hi = INT_BOUNDS[t]
            self._raise((wide < lo) | (wide > hi), _INT_OVF_ERR[t], alive)
        return DVal(t, wide.astype(STORAGE_DTYPE[t].name), valid)

    def _int_arith(self, op: str, t: T, a: DVal, b: DVal,
                   valid: jnp.ndarray, alive: jnp.ndarray) -> DVal:
        x = a.data.astype(jnp.int64)
        y = b.data.astype(jnp.int64)
        if op == "add":
            r = x + y
            if t is T.INT8:
                ovf = (jnp.sign(x) == jnp.sign(y)) & (jnp.sign(r) != jnp.sign(x)) & (x != 0)
                self._raise(ovf, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if op == "sub":
            r = x - y
            if t is T.INT8:
                ovf = (jnp.sign(x) != jnp.sign(y)) & (jnp.sign(r) == jnp.sign(y)) & (y != 0)
                self._raise(ovf, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if op == "mul":
            r = x * y
            if t is T.INT8:
                # exact check: r/x != y  (trunc division) unless x==0
                safe_x = jnp.where(x == 0, jnp.int64(1), x)
                bad = (x != 0) & (jax.lax.div(r, safe_x) != y)
                bad = bad | ((x == -1) & (y == INT64_MIN)) | ((y == -1) & (x == INT64_MIN))
                self._raise(bad, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if op == "div":
            self._raise(y == 0, ERR_DIV_BY_ZERO, alive)
            safe_y = jnp.where(y == 0, jnp.int64(1), y)
            minedge = (x == INT64_MIN) & (y == -1)
            if t is T.INT8:
                self._raise(minedge, ERR_INT8_OVERFLOW, alive)
            safe_y = jnp.where(minedge, jnp.int64(1), safe_y)
            r = jax.lax.div(x, safe_y)  # trunc toward zero, PG semantics
            return self._int_result(t, r, valid, alive)
        if op == "mod":
            self._raise(y == 0, ERR_DIV_BY_ZERO, alive)
            safe_y = jnp.where((y == 0) | (y == -1), jnp.int64(1), y)
            r = jax.lax.rem(x, safe_y)  # sign follows dividend
            return DVal(t, r.astype(STORAGE_DTYPE[t].name), valid)
        raise ValueError(op)

    # -- float arithmetic with CHECKFLOATVAL semantics -----------------------

    def _float_arith(self, op: str, t: T, a: DVal, b: DVal,
                     valid: jnp.ndarray, alive: jnp.ndarray) -> DVal:
        # float4 runs native f32: CHECKFLOATVAL anomalies are hard SQL
        # errors.  A float8 anomaly (inf/zero result) is flagged
        # CPU_RECHECK and the host-exact replay decides whether it is a
        # true PostgreSQL overflow error or a fine finite value — never a
        # silent wrong answer.
        dt = jnp.float32 if t is T.FLOAT4 else jnp.float64
        ovf_err = ERR_FLOAT_OVERFLOW if t is T.FLOAT4 else ERR_CPU_RECHECK
        und_err = ERR_FLOAT_UNDERFLOW if t is T.FLOAT4 else ERR_CPU_RECHECK
        x = a.data.astype(dt)
        y = b.data.astype(dt)
        inf_in = jnp.isinf(x) | jnp.isinf(y)
        if op == "add":
            r = x + y
            zero_ok = True
        elif op == "sub":
            r = x - y
            zero_ok = True
        elif op == "mul":
            r = x * y
            zero_ok = None  # (x==0)|(y==0)
        elif op == "div":
            self._raise(y == 0, ERR_DIV_BY_ZERO, alive)
            r = x / jnp.where(y == 0, dt(1), y)
            zero_ok = "div"
        else:
            raise ValueError(op)
        self._raise(jnp.isinf(r) & ~inf_in, ovf_err, alive)
        if zero_ok is None:
            self._raise((r == 0) & (x != 0) & (y != 0), und_err, alive)
        elif zero_ok == "div":
            self._raise((r == 0) & (x != 0), und_err, alive)
        return DVal(t, r, valid)

    # -- device numeric ------------------------------------------------------

    def _pow10(self, k: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(10^k as int64, overflow_flag) for k >= 0 lanes."""
        kk = jnp.clip(k, 0, 18)
        return jnp.asarray(_POW10)[kk], k > 18

    def _num_rescale(self, mant: jnp.ndarray, delta: jnp.ndarray,
                     alive: jnp.ndarray) -> jnp.ndarray:
        """mant * 10^delta with CpuReCheck on overflow (delta >= 0)."""
        p, kovf = self._pow10(delta)
        lim = jnp.asarray(_POW10_LIMIT)[jnp.clip(delta, 0, 18)]
        ovf = kovf | (jnp.abs(mant) > lim)
        self._raise(ovf, ERR_CPU_RECHECK, alive)
        return mant * jnp.where(ovf, jnp.int64(1), p)

    def _num_window_check(self, mant: jnp.ndarray, exp: jnp.ndarray,
                          alive: jnp.ndarray) -> None:
        from ..sqltypes import NUMERIC_MIN_EXP, NUMERIC_MAX_EXP
        bad = (jnp.abs(mant) > NUMERIC_MAX_MANT) | \
              (exp < NUMERIC_MIN_EXP) | (exp > NUMERIC_MAX_EXP)
        self._raise(bad, ERR_CPU_RECHECK, alive)

    def _num_align(self, a: DVal, b: DVal, alive: jnp.ndarray):
        e = jnp.minimum(a.exp, b.exp)
        ma = self._num_rescale(a.data, a.exp - e, alive)
        mb = self._num_rescale(b.data, b.exp - e, alive)
        return ma, mb, e

    def _num_arith(self, op: str, a: DVal, b: DVal, valid: jnp.ndarray,
                   alive: jnp.ndarray) -> DVal:
        if op in ("add", "sub"):
            ma, mb, e = self._num_align(a, b, alive)
            r = ma + mb if op == "add" else ma - mb
            self._num_window_check(r, e, alive)
            return DVal(T.NUMERIC, r, valid, e)
        if op == "mul":
            x, y = a.data, b.data
            r = x * y
            safe_x = jnp.where(x == 0, jnp.int64(1), x)
            bad = (x != 0) & (jax.lax.div(r, safe_x) != y)
            self._raise(bad, ERR_CPU_RECHECK, alive)
            e = a.exp + b.exp
            self._num_window_check(r, e, alive)
            return DVal(T.NUMERIC, r, valid, e)
        raise NotImplementedError(f"device numeric {op}")

    # -- comparisons ---------------------------------------------------------

    def _cmp(self, tag: str, a: DVal, b: DVal, valid: jnp.ndarray) -> DVal:
        if a.t is T.NUMERIC:
            # align exponents exactly; if the rescale would overflow int64
            # lanes (huge magnitude gap) flag CPU_RECHECK — an inexact float
            # compare could silently misorder, which the contract forbids
            e = jnp.minimum(a.exp, b.exp)
            pa, ova = self._pow10(a.exp - e)
            pb, ovb = self._pow10(b.exp - e)
            la = jnp.asarray(_POW10_LIMIT)[jnp.clip(a.exp - e, 0, 18)]
            lb = jnp.asarray(_POW10_LIMIT)[jnp.clip(b.exp - e, 0, 18)]
            exact = ~(ova | ovb | (jnp.abs(a.data) > la) | (jnp.abs(b.data) > lb))
            self._raise(~exact, ERR_CPU_RECHECK, valid)
            ma = a.data * jnp.where(exact, pa, jnp.int64(1))
            mb = b.data * jnp.where(exact, pb, jnp.int64(1))
            d = _cmp_from_lt_eq(tag, ma < mb, ma == mb)
            return DVal(T.BOOL, d, valid)
        # float8: when both sides carry exact IEEE bits (plain columns /
        # consts), compare via the integer total-order map — bit-exact
        # whatever the value lanes went through
        ab = getattr(a, "bits", None)
        bb = getattr(b, "bits", None)
        if a.t is T.FLOAT8 and ab is not None and bb is not None:
            x, y = _f64_orderkey(ab), _f64_orderkey(bb)
        else:
            x, y = a.data, b.data
            if x.dtype != y.dtype:
                ct = jnp.promote_types(x.dtype, y.dtype)
                x = x.astype(ct)
                y = y.astype(ct)
            if a.t in (T.FLOAT4, T.FLOAT8):
                # PG float comparison (float8_cmp_internal): NaN == NaN and
                # NaN > everything — emulate on value lanes
                xn, yn = jnp.isnan(x), jnp.isnan(y)
                lt = jnp.where(xn | yn, (~xn) & yn, x < y)
                eq = jnp.where(xn | yn, xn & yn, x == y)
                return DVal(T.BOOL, _cmp_from_lt_eq(tag, lt, eq), valid)
        d = {"eq": x == y, "ne": x != y, "lt": x < y, "le": x <= y,
             "gt": x > y, "ge": x >= y}[tag]
        return DVal(T.BOOL, d, valid)

    def _lower_text_cmp(self, e: FuncExpr, tag: str, live: jnp.ndarray) -> DVal:
        """Text comparisons via order-preserving dictionary codes.

        col vs const: const is translated to a code boundary at trace time.
        col vs col: only when both share the same dictionary object."""
        a, b = e.args
        if isinstance(a, Const) and isinstance(b, Const):
            # const vs const folds at trace time (C collation: bytewise)
            if a.value is None or b.value is None:
                z = jnp.zeros_like(live)
                return DVal(T.BOOL, z, z)          # NULL result
            c = (a.value.encode() > b.value.encode()) - \
                (a.value.encode() < b.value.encode())
            r = {"eq": c == 0, "ne": c != 0, "lt": c < 0, "le": c <= 0,
                 "gt": c > 0, "ge": c >= 0}[tag]
            return DVal(T.BOOL, jnp.full_like(live, bool(r)),
                        jnp.ones_like(live))
        if isinstance(b, Const) and isinstance(a, ColumnRef):
            return self._text_col_const(a, b, tag, live)
        if isinstance(a, Const) and isinstance(b, ColumnRef):
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                    "eq": "eq", "ne": "ne"}[tag]
            return self._text_col_const(b, a, flip, live)
        if isinstance(a, ColumnRef) and isinstance(b, ColumnRef):
            ma, mb = self.schema[a.index], self.schema[b.index]
            if ma.dict_id == mb.dict_id and ma.dict_id != -1:
                va, vb = self.lower(a, live), self.lower(b, live)
                return self._cmp(tag, va, vb, va.valid & vb.valid)
        raise NotImplementedError("text compare requires col-vs-const or "
                                  "same-dictionary columns on device")

    def _text_col_const(self, col: ColumnRef, c: Const, tag: str,
                        live: jnp.ndarray) -> DVal:
        meta = self.schema[col.index]
        d = list(meta.dictionary or ())
        v = self.lower(col, live)
        s = c.value
        if s is None:
            z = jnp.zeros_like(live)
            return DVal(T.BOOL, z, z)  # NULL compare -> NULL
        lo = bisect.bisect_left(d, s)
        present = lo < len(d) and d[lo] == s
        code = v.data
        if tag == "eq":
            r = (code == lo) if present else jnp.zeros_like(live)
        elif tag == "ne":
            r = (code != lo) if present else jnp.ones_like(live)
        elif tag == "lt":
            r = code < lo
        elif tag == "le":
            r = code < (lo + 1 if present else lo)
        elif tag == "gt":
            r = code >= (lo + 1 if present else lo)
        else:  # ge
            r = code >= lo
        return DVal(T.BOOL, r, v.valid)

    # -- casts ---------------------------------------------------------------

    def _cast(self, src: T, dst: T, a: DVal, valid: jnp.ndarray,
              alive: jnp.ndarray) -> DVal:
        if dst in INT_BOUNDS:
            if src in INT_BOUNDS:
                return self._int_result(dst, a.data.astype(jnp.int64), valid, alive)
            if src in (T.FLOAT4, T.FLOAT8):
                f = a.data.astype(jnp.float64)
                bad = jnp.isnan(f) | jnp.isinf(f)
                lo, hi = INT_BOUNDS[dst]
                bad = bad | (f < lo - 1.0) | (f > hi + 1.0)
                self._raise(bad, _INT_OVF_ERR[dst], alive)
                r = jnp.rint(jnp.where(bad, 0.0, f)).astype(jnp.int64)
                return self._int_result(dst, r, valid, alive)
            if src is T.NUMERIC:
                return self._numeric_to_int(dst, a, valid, alive)
        if dst in (T.FLOAT4, T.FLOAT8):
            dt = jnp.float32 if dst is T.FLOAT4 else jnp.float64
            if src is T.NUMERIC:
                f = a.data.astype(jnp.float64) * \
                    jnp.asarray(_POW10_F64)[jnp.clip(a.exp + 40, 0, 80)]
                # rows whose scaled value overflows or underflows the f64
                # product defer to the host
                self._raise((jnp.isinf(f) | ((f == 0) & (a.data != 0))),
                            ERR_CPU_RECHECK, alive)
                r = f.astype(dt)
            else:
                r = a.data.astype(dt)
            if dst is T.FLOAT4 and src in (T.FLOAT8, T.NUMERIC):
                self._raise(jnp.isinf(r) & ~jnp.isinf(a.data.astype(jnp.float64)),
                            ERR_FLOAT_OVERFLOW, alive)
            return DVal(dst, r, valid)
        if dst is T.NUMERIC:
            if src in INT_BOUNDS:
                return DVal(T.NUMERIC, a.data.astype(jnp.int64), valid,
                            jnp.zeros_like(a.data, dtype=jnp.int32))
            # float->numeric needs shortest-repr digits: host only
            self._raise(jnp.ones_like(valid), ERR_CPU_RECHECK, alive)
            return DVal(T.NUMERIC, jnp.zeros_like(a.data, dtype=jnp.int64),
                        valid, jnp.zeros_like(a.data, dtype=jnp.int32))
        if dst is T.TIMESTAMP and src is T.DATE:
            r = a.data.astype(jnp.int64) * 86_400_000_000
            return DVal(T.TIMESTAMP, r, valid)
        if dst is T.DATE and src is T.TIMESTAMP:
            # pgfn_timestamp_date analog (opencl_timelib.h): usec -> days,
            # floored so pre-epoch timestamps land on the right day
            r = jnp.floor_divide(a.data.astype(jnp.int64),
                                 jnp.int64(86_400_000_000))
            return DVal(T.DATE, r.astype(jnp.int32), valid)
        if dst is T.TIME and src is T.TIMESTAMP:
            # pgfn_timestamp_time analog (opencl_timelib.h:261): floored
            # day division keeps pre-epoch times in [0, 86400e6)
            ts = a.data.astype(jnp.int64)
            day = jnp.floor_divide(ts, jnp.int64(86_400_000_000))
            return DVal(T.TIME, ts - day * jnp.int64(86_400_000_000), valid)
        if dst is T.TEXT and src is T.BPCHAR:
            return DVal(T.TEXT, a.data, valid)
        raise NotImplementedError(f"device cast {src} -> {dst}")

    def _numeric_to_int(self, dst: T, a: DVal, valid: jnp.ndarray,
                        alive: jnp.ndarray) -> DVal:
        mant, exp = a.data, a.exp
        # exp >= 0: value = mant * 10^exp
        up = self._num_rescale(mant, jnp.maximum(exp, 0), alive)
        # exp < 0: round half away from zero
        k = jnp.clip(-exp, 0, 18)
        p = jnp.asarray(_POW10)[k]
        q = jax.lax.div(mant, p)
        r = jax.lax.rem(mant, p)
        half = jax.lax.div(p, jnp.int64(2))
        adj = jnp.where(jnp.abs(r) * 2 >= p, jnp.sign(mant), jnp.int64(0))
        down = q + adj
        self._raise((-exp) > 18, ERR_CPU_RECHECK, alive)  # ultra-small: host
        res = jnp.where(exp >= 0, up, down)
        return self._int_result(dst, res, valid, alive)

    # -- math ----------------------------------------------------------------

    def _math1(self, name: str, a: DVal, valid: jnp.ndarray,
               alive: jnp.ndarray) -> DVal:
        x = a.data.astype(jnp.float64)
        fns = {
            "cbrt": jnp.cbrt, "ceil": jnp.ceil, "ceiling": jnp.ceil,
            "floor": jnp.floor, "exp": jnp.exp, "ln": jnp.log,
            "log": jnp.log10, "sqrt": jnp.sqrt,
            "sign": jnp.sign, "degrees": jnp.degrees, "radians": jnp.radians,
            "trunc": jnp.trunc, "round": jnp.rint,
            "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
            "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
            "cot": lambda v: jnp.cos(v) / jnp.sin(v),
        }
        r = fns[name](x)
        if name in ("sqrt", "ln", "log", "asin", "acos"):
            self._raise(jnp.isnan(r) & ~jnp.isnan(x), ERR_CPU_RECHECK, alive)
        # float8 anomalies defer to the host-exact tier
        self._raise(jnp.isinf(r) & ~jnp.isinf(x), ERR_CPU_RECHECK, alive)
        return DVal(T.FLOAT8, r, valid)

    def _math2(self, name: str, a: DVal, b: DVal, valid: jnp.ndarray,
               alive: jnp.ndarray) -> DVal:
        x = a.data.astype(jnp.float64)
        y = b.data.astype(jnp.float64)
        if name in ("pow", "power"):
            r = jnp.power(x, y)
            self._raise(jnp.isnan(r) & ~(jnp.isnan(x) | jnp.isnan(y)),
                        ERR_CPU_RECHECK, alive)
        else:
            r = jnp.arctan2(x, y)
        self._raise(jnp.isinf(r) & ~(jnp.isinf(x) | jnp.isinf(y)),
                    ERR_CPU_RECHECK, alive)
        return DVal(T.FLOAT8, r, valid)

    # -- bit ops -------------------------------------------------------------

    def _bit(self, op: str, t: T, args: list[DVal], valid: jnp.ndarray) -> DVal:
        dt = STORAGE_DTYPE[t].name
        x = args[0].data.astype(dt)
        if op == "not":
            return DVal(t, ~x, valid)
        y = args[1].data.astype(dt)
        if op == "and":
            return DVal(t, x & y, valid)
        if op == "or":
            return DVal(t, x | y, valid)
        if op == "xor":
            return DVal(t, x ^ y, valid)
        bits = {T.INT2: 16, T.INT4: 32, T.INT8: 64}[t]
        sh = (args[1].data.astype(jnp.int32) & (bits - 1)).astype(dt)
        if op == "shl":
            return DVal(t, x << sh, valid)
        return DVal(t, x >> sh, valid)


def _f64_orderkey(bits: jnp.ndarray) -> jnp.ndarray:
    """Map IEEE-754 double bits (int64) to int64 keys with PG float ordering:
    total order, -0 == +0, NaN equal to NaN and greater than everything."""
    b = bits.astype(jnp.int64)
    # canonicalize -0.0 -> +0.0 and all NaNs -> +quiet-NaN bit pattern
    b = jnp.where(b == jnp.int64(-(1 << 63)), jnp.int64(0), b)
    expmask = jnp.int64(0x7FF0000000000000)
    frac = b & jnp.int64(0x000FFFFFFFFFFFFF)
    is_nan = ((b & expmask) == expmask) & (frac != 0)
    b = jnp.where(is_nan, jnp.int64(0x7FF8000000000000), b)
    neg = b < 0
    return jnp.where(neg, jnp.int64(-1) - (b & jnp.int64(0x7FFFFFFFFFFFFFFF)), b)


def _select(mask: jnp.ndarray, a: DVal, b: DVal) -> DVal:
    """where(mask, a, b) lane-wise; a and b must share type."""
    exp = None
    if a.t is T.NUMERIC:
        exp = jnp.where(mask, a.exp, b.exp)
    return DVal(a.t, jnp.where(mask, a.data, b.data),
                jnp.where(mask, a.valid, b.valid), exp)


def _cmp_from_lt_eq(tag: str, lt: jnp.ndarray, eq: jnp.ndarray) -> jnp.ndarray:
    return {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
            "gt": ~(lt | eq), "ge": ~lt}[tag]


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------

def schema_from_chunk_columns(names: Sequence[str], cols) -> list[ColMeta]:
    """Build ColMeta list from datastore Columns (dictionary identity via id)."""
    out = []
    for name, c in zip(names, cols):
        out.append(ColMeta(name=name, type=c.type,
                           dictionary=tuple(c.dictionary) if c.dictionary else None,
                           dict_id=id(c.dictionary) if c.dictionary is not None else -1))
    return out


def planes_of_column(c) -> tuple:
    """Runtime plane tuple for one datastore Column (host ndarrays).

    FLOAT8 carries a third plane: the raw IEEE-754 bits as int64.  The bits
    plane lets comparisons, grouping, join keys and min/max run bit-exactly
    via integer ordering (sign-flip trick) while arithmetic uses the value
    lanes."""
    if c.type is T.NUMERIC:
        return (c.data, c.valid, c.num_exp, c.num_dscale)
    if c.type is T.FLOAT8:
        return (c.data, c.valid, c.data.view(np.int64))
    return (c.data, c.valid)


def build_qual_fn(pred: Expr, schema: Sequence[ColMeta]) -> Callable:
    """Return f(cols, nrows) -> (pass_mask bool[n], err uint8[n]).

    pass_mask is True only for rows < nrows where the qual is TRUE (SQL:
    NULL/false both drop the row).  The gpuscan_qual kernel analog
    (opencl_gpuscan.h:98-136)."""
    def f(cols: tuple, nrows: jnp.ndarray):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        v = lw.lower(pred, live)
        mask = live & v.valid & v.data.astype(jnp.bool_)
        return mask, jnp.where(live, lw.err, jnp.uint8(0))
    return f


def build_project_fn(exprs: Sequence[Expr], schema: Sequence[ColMeta],
                     pred: Optional[Expr] = None) -> Callable:
    """Return f(cols, nrows) -> (outs, mask, err) where outs is a tuple of
    plane-tuples per expression (fused filter+projection — the operator-fusion
    analog of the reference's bulk-load path, gpuscan.c:1318)."""
    def f(cols: tuple, nrows: jnp.ndarray):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)
        else:
            mask = live
        outs = []
        for e in exprs:
            v = lw.lower(e, mask)
            if v.t is T.NUMERIC:
                outs.append((v.data, v.valid & mask, v.exp))
            else:
                outs.append((v.data, v.valid & mask))
        return tuple(outs), mask, jnp.where(live, lw.err, jnp.uint8(0))
    return f
