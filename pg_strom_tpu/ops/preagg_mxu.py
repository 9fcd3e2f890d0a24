"""Limb-matrix grouped aggregation: exact additive partials per bucket.

Every additive quantity (counts, integer sums, float sums, squares,
key-constancy checks) becomes a column of an N x S value matrix V of small
integers, and ONE grouped reduction of V by bucket id computes all of them:

    partials[G, S] = sum over rows r in bucket g of V[r, :]

  - Exactness: integers are decomposed into 8-bit limbs, the reduction
    sums integers (exact in any order), and the host reconstructs
    arbitrary-width integers with python big ints.  Two formulations of
    the reduction give the same sums bit for bit (mxu_reduce; the backend
    module picks one per platform): an int64 segment sum, and a bf16
    one-hot dot_general with f32 accumulation over segments of <= 65536
    rows (bf16 holds 0..255 exactly and every per-segment sum stays below
    2^24, so the f32 accumulator is exact).
  - sum(int*) keeps the modular-int64 contract of the scatter path (exact
    when the true sum fits; a sum-|v| shadow column guards the window).
  - sum(float4) uses SIGNED-digit 72-bit fixed point below the chunk max:
    each column holds digit(|x|) * sign(x) in [-255, 255], so one digit
    block carries both signs.  Per-row truncation <= 2^(E-72), n-row error
    <= 2^(E-50).  Because the sum is of integers, its result does not
    depend on the order in which the device adds rows.
  - Group keys, without per-bucket gathers: for each (narrow) key lane the
    kernel emits per-bucket n, sum(kb), sum(kb^2) with kb = key + 2^31 >= 0.
    The host checks  n * sum(kb^2) == sum(kb)^2  (Cauchy-Schwarz equality
    <=> all bucket values equal) in exact big-int arithmetic and recovers
    the key as sum(kb)/n - 2^31.  A failed check IS the scatter strategy's
    `collision` signal — the executor re-salts, then sort-falls-back.

Aggregate kinds not mapped to columns (min/max, numeric, and on the CPU
the float8 sums) run segment ops over the same bucket ids inside the same
program, so a query pays for those scatters only on the slots that need
them.

Reference parity: replaces gpupreagg's bitonic-sort + keycomp reduction
(opencl_gpupreagg.h:459-860) with the same partials contract.  The module
and strategy names ('mxu', 'mxu_dense') are historical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .. import backend
from ..sqltypes import T
from ..expr.lower_jax import DVal

# the one-hot formulation's f32 accumulation is exact for integer columns
# while per-segment sums stay < 2^24  (65536 rows x limb<=255 = 2^24)
SEG_ROWS = 1 << 16

F4_LIMBS = 9
F4_WINDOW = 8 * F4_LIMBS         # 72-bit fixed-point window for float4 sums

_MXU_KINDS = {"nrows", "count", "sum_i", "sum_f", "sumsq_i", "sumsq_f",
              "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y"}
_F64_KINDS = {"sumsq_f", "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y"}
_KEY_OK_TYPES = {T.BOOL, T.INT2, T.INT4, T.DATE, T.TEXT, T.BPCHAR,
                 T.INT8, T.TIME, T.TIMESTAMP}
# 64-bit key lanes ride as TWO independent 32-bit word blocks: constancy of
# the lo word AND of the hi word within a bucket <=> constancy of the key,
# so each word gets its own sum/sumsq Cauchy-Schwarz check and the host
# reassembles the value from the two word means.
_KEY_WIDE_TYPES = {T.INT8, T.TIME, T.TIMESTAMP}


def mxu_keys_supported(key_types: Sequence[T]) -> bool:
    """Narrow (<=32-bit data lane) key types get exact sum/sumsq checks."""
    return bool(key_types) and all(t in _KEY_OK_TYPES for t in key_types)


def mxu_dense_supported(key_types: Sequence[T]) -> bool:
    """Single int-lane key => the DENSE-key strategy ('mxu_dense'): buckets
    are key - min(key), so the bucket INDEX recovers the key and the ~17
    key-constancy/recovery matmul columns (sum/sumsq limb blocks + nval)
    vanish — collisions are impossible by construction.  A chunk whose key
    range exceeds G-2 sets `dense_fail` and the executor re-dispatches the
    generic 'mxu' strategy."""
    return (len(key_types) == 1 and key_types[0] in _KEY_OK_TYPES)


# f64 additive kinds (float8 sums, pair and variance sums) ride the limb
# matrix as double-float fixed point wherever the backend says so
# (backend.f64_limb_sums: on the GPU, where an f64 scatter-add would sum in
# a run-dependent order); elsewhere they run as f64 segment sums.  Tests
# force the limb route on the CPU through this hook.
F64_BLOCKS_ON_CPU = False


def _f64_blocks_enabled() -> bool:
    return F64_BLOCKS_ON_CPU or backend.f64_limb_sums()


def _kind_mxu_ok(kind: str, argtype: Optional[T]) -> bool:
    if kind not in _MXU_KINDS:
        return False
    if kind == "sum_f":
        if argtype is T.FLOAT4:
            return True
        return argtype is T.FLOAT8 and _f64_blocks_enabled()
    if kind in _F64_KINDS:
        return _f64_blocks_enabled()
    if kind == "sumsq_i":
        return argtype in (T.INT2, T.INT4)
    return True


# ---------------------------------------------------------------------------
# static column recipes — the device builder and the host extractor both
# derive the layout from this single walk, so they cannot drift
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SlotRecipe:
    kind: str
    # signed-digit limb columns, low first: column j sums digit_j(|v|)*sign(v)
    limbs: list[int] = dataclasses.field(default_factory=list)
    okcnt: int = -1
    shadow: int = -1
    bias_bits: int = 0
    f4_slot_no: int = -1         # index into the kernel's f4_exps vector
    # f64 (double-float) variant: limbs hold the f32 HEAD, these hold the
    # residual TAIL (q - f32(q)), each with its own exponent slot
    lo_limbs: list[int] = dataclasses.field(default_factory=list)
    lo_slot_no: int = -1


@dataclasses.dataclass
class _KeyRecipe:
    sum_limbs: list[int]
    sumsq_limbs: list[int]
    nval: int
    bias: int
    t: T
    # 64-bit keys: the hi-word block (sum_limbs/sumsq_limbs hold the lo word)
    sum_limbs_hi: list[int] = dataclasses.field(default_factory=list)
    sumsq_limbs_hi: list[int] = dataclasses.field(default_factory=list)


def mxu_recipes(key_types: Sequence[T], aggs, arg_types: Sequence[tuple],
                dense_key: bool = False):
    """(key_recipes, per-agg {kind: _SlotRecipe}, ncols).

    Column 0 is always the bucket row count (mask).  aggs[i].slots with
    arg types arg_types[i] drive the slot walk — identical on device.
    dense_key (the 'mxu_dense' strategy): buckets ARE biased key values, so
    no key recovery/constancy columns are emitted at all."""
    c = 1                                    # col 0: rows-per-bucket
    keyr: list[_KeyRecipe] = []
    for t in [] if dense_key else key_types:
        if t in _KEY_WIDE_TYPES:
            s_lo = list(range(c, c + 4)); c += 4
            q_lo = list(range(c, c + 8)); c += 8
            s_hi = list(range(c, c + 4)); c += 4
            q_hi = list(range(c, c + 8)); c += 8
            nv = c; c += 1
            keyr.append(_KeyRecipe(s_lo, q_lo, nv, 1 << 63, t,
                                   sum_limbs_hi=s_hi, sumsq_limbs_hi=q_hi))
        else:
            s = list(range(c, c + 5)); c += 5
            q = list(range(c, c + 8)); c += 8
            nv = c; c += 1
            keyr.append(_KeyRecipe(s, q, nv, 1 << 31, t))
    slotr: list[dict[str, _SlotRecipe]] = []
    nf4 = 0
    for inst, at in zip(aggs, arg_types):
        a_t = at[0] if at else None
        d: dict[str, _SlotRecipe] = {}
        for kind in inst.slots:
            if not _kind_mxu_ok(kind, a_t):
                continue
            if kind in ("nrows", "count"):
                d[kind] = _SlotRecipe(kind, [c]); c += 1
            elif kind == "sum_i":
                d[kind] = _SlotRecipe(kind, list(range(c, c + 8)),
                                      okcnt=c + 8, shadow=c + 9,
                                      bias_bits=63)
                c += 10
            elif kind == "sumsq_i":
                d[kind] = _SlotRecipe(kind, list(range(c, c + 8)))
                c += 8
            elif kind == "sum_f" and a_t is T.FLOAT4:
                d[kind] = _SlotRecipe(kind, list(range(c, c + F4_LIMBS)),
                                      shadow=c + F4_LIMBS,
                                      f4_slot_no=nf4)
                nf4 += 1
                c += F4_LIMBS + 1
            else:
                # f64 additive quantity: signed-digit double-float fixed
                # point (head + residual tail, each its own 72-bit window)
                L = F4_LIMBS
                d[kind] = _SlotRecipe(
                    kind,
                    limbs=list(range(c, c + L)),
                    lo_limbs=list(range(c + L, c + 2 * L)),
                    shadow=c + 2 * L,
                    f4_slot_no=nf4, lo_slot_no=nf4 + 1)
                nf4 += 2
                c += 2 * L + 1
        slotr.append(d)
    return keyr, slotr, c


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def _mask0(x: jnp.ndarray, ok: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(ok, x, jnp.zeros_like(x))


def _u64_limbs(u: jnp.ndarray, nlimbs: int) -> list[jnp.ndarray]:
    return [((u >> jnp.uint64(8 * j)) & jnp.uint64(0xFF)).astype(jnp.float32)
            for j in range(nlimbs)]


def _exact_pow2_f32(e: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact 2^e for int32 e in [-126, 127] (XLA's exp2 is a polynomial
    approximation that can be 1 ulp off a true power of two, which breaks
    the fixed-point digit extraction's exactness premise)."""
    bits = (jnp.clip(e, -126, 127) + jnp.int32(127)) << 23
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _f4_scale_exp(absx: jnp.ndarray):
    """(scale, E): scale = 2^-E exact power of two with max|v| * scale < 1."""
    m = jnp.max(absx)
    e = (jnp.floor(jnp.log2(jnp.maximum(m, jnp.float32(1e-38))))
         .astype(jnp.int32) + 1)
    e = jnp.clip(e, -125, 126)
    sc = _exact_pow2_f32(-e)
    bump = (m * sc) >= 1.0                      # guard log2 rounding
    e = jnp.where(bump, e + 1, e)
    sc = jnp.where(bump, sc * jnp.float32(0.5), sc)
    return sc, e.astype(jnp.int32)


def _f4_limb_cols(x: jnp.ndarray, sc: jnp.ndarray) -> list[jnp.ndarray]:
    """SIGNED 72-bit fixed-point limbs of one f32 lane, low limb FIRST
    (matches _SlotRecipe): column j is digit_j(|x|) * sign(x) in
    [-255, 255].  NaN lanes contribute 0 digits (the |x| shadow column
    carries the NaN to the host-replay guard)."""
    pos = jnp.where(x > 0, x, jnp.float32(0.0))
    neg = jnp.where(x < 0, -x, jnp.float32(0.0))     # NaN compares false
    sgn = jnp.where(x < 0, jnp.float32(-1.0), jnp.float32(1.0))
    v = (pos + neg) * sc
    high_first = []
    for _ in range(F4_LIMBS):
        v = v * jnp.float32(256.0)
        d = jnp.floor(v)
        v = v - d
        high_first.append(d * sgn)
    return list(reversed(high_first))


def build_mxu_columns(key_vals: Sequence[DVal], aggs, arg_vals,
                      mask: jnp.ndarray, n: int, dense_key: bool = False):
    """N x S f32 column matrix + per-f4-slot exponents, in recipe order."""
    cols: list[jnp.ndarray] = [mask.astype(jnp.float32)]       # col 0
    f4_exps: list[jnp.ndarray] = []

    for k in [] if dense_key else key_vals:
        okk = mask & k.valid
        if k.t in _KEY_WIDE_TYPES:
            # 64-bit key: biased word pair, one sum/sumsq block per word
            u = (k.data.astype(jnp.int64).astype(jnp.uint64)
                 ^ jnp.uint64(1 << 63))
            u = jnp.where(okk, u, jnp.uint64(0))
            for w in (u & jnp.uint64(0xFFFFFFFF), u >> jnp.uint64(32)):
                cols.extend(_u64_limbs(w, 4))
                cols.extend(_u64_limbs(w * w, 8))
            cols.append(okk.astype(jnp.float32))
            continue
        kb = (k.data.astype(jnp.int64) + jnp.int64(1 << 31)).astype(jnp.uint64)
        kb = jnp.where(okk, kb, jnp.uint64(0))
        cols.extend(_u64_limbs(kb, 5))
        cols.extend(_u64_limbs(kb * kb, 8))
        cols.append(okk.astype(jnp.float32))

    def _f32_signed_block(x32: jnp.ndarray):
        """(signed limbs, exp) of a masked f32 lane."""
        absx = jnp.where(jnp.isnan(x32), jnp.float32(0.0), jnp.abs(x32))
        sc, e = _f4_scale_exp(absx)
        return _f4_limb_cols(x32, sc), e

    for inst, vals in zip(aggs, arg_vals):
        a = vals[0] if vals else None
        ok = mask if a is None else (mask & a.valid)
        if len(vals) == 2:
            ok = mask & vals[0].valid & vals[1].valid
        for kind in inst.slots:
            if not _kind_mxu_ok(kind, a.t if a is not None else None):
                continue
            if kind == "nrows":
                cols.append(mask.astype(jnp.float32))
            elif kind == "count":
                cols.append(ok.astype(jnp.float32))
            elif kind == "sum_i":
                v = jnp.where(ok, a.data.astype(jnp.int64), jnp.int64(0))
                biased = jnp.where(ok, v.astype(jnp.uint64) +
                                   jnp.uint64(1 << 63), jnp.uint64(0))
                cols.extend(_u64_limbs(biased, 8))
                cols.append(ok.astype(jnp.float32))
                cols.append(_mask0(jnp.abs(a.data.astype(jnp.float32)), ok))
            elif kind == "sumsq_i":
                v = jnp.where(ok, a.data.astype(jnp.int64), jnp.int64(0))
                cols.extend(_u64_limbs((v * v).astype(jnp.uint64), 8))
            elif kind == "sum_f" and a.t is T.FLOAT4:
                x = _mask0(a.data.astype(jnp.float32), ok)
                absx = jnp.where(jnp.isnan(x), jnp.float32(0.0), jnp.abs(x))
                sc, e = _f4_scale_exp(absx)
                f4_exps.append(e)
                cols.extend(_f4_limb_cols(x, sc))
                cols.append(_mask0(jnp.abs(a.data.astype(jnp.float32)), ok))
            else:
                # f64 additive quantity q -> f32 head + f32 tail
                q = _f64_quantity(kind, vals, ok)
                hi, lo = _f64_head_tail(q)
                hp, he = _f32_signed_block(hi)
                lp, le = _f32_signed_block(lo)
                f4_exps.append(he)
                f4_exps.append(le)
                cols.extend(hp)
                cols.extend(lp)
                cols.append(jnp.abs(hi))           # shadow: inf/nan guard
    # bf16 column matrix: every integer column is in [-255, 255] (exact in
    # bf16's 8-bit significand); shadow columns are threshold guards with a
    # 4x band, so bf16 quantization is safe.  Halves V's HBM traffic vs f32.
    V = jnp.stack([c.astype(jnp.bfloat16) for c in cols], axis=1)
    exps = (jnp.stack(f4_exps) if f4_exps else jnp.zeros(0, jnp.int32))
    return V, exps


def _f64_head_tail(q: jnp.ndarray):
    """(head f32, tail f32) with head + tail == q to ~2^-47 relative.

    The head is q with its low 29 mantissa bits cleared — an f32 value
    held in f64, made with integer bit operations.  The obvious
    f32(q) - f64(f32(q)) is not safe: XLA's GPU compiler may fold the
    f64->f32->f64 convert pair away (excess precision), which zeroes the
    tail and leaves only the head's ~2^-24 precision.  Heads below f32's
    smallest normal are zero (the tail carries the value)."""
    bits = jax.lax.bitcast_convert_type(q, jnp.int64)
    head = jax.lax.bitcast_convert_type(bits & np.int64(~((1 << 29) - 1)),
                                        jnp.float64)
    head = jnp.where(jnp.abs(head) < np.float64(2.0 ** -126), 0.0, head)
    # exact conversion: head holds an f32 value (or overflows to +-inf,
    # which the shadow column turns into a host replay)
    return head.astype(jnp.float32), (q - head).astype(jnp.float32)


def _f64_quantity(kind: str, vals, ok: jnp.ndarray) -> jnp.ndarray:
    """The per-row f64 value each additive f64 slot kind sums."""
    x = jnp.where(ok, vals[0].data.astype(jnp.float64), 0.0)
    if kind in ("sum_f", "sum_x"):
        return x
    if kind in ("sumsq_f", "sumsq_x"):
        return x * x
    y = jnp.where(ok, vals[1].data.astype(jnp.float64), 0.0)
    if kind == "sum_y":
        return y
    if kind == "sumsq_y":
        return y * y
    if kind == "sum_xy":
        return x * y
    raise ValueError(kind)


def mxu_shadow_cols(slotr) -> list[int]:
    """Global column indexes needing the f64 shadow reduction (sorted)."""
    return sorted(r.shadow for d in slotr for r in d.values()
                  if r.shadow >= 0)


def mxu_reduce(V: jnp.ndarray, seg_id: jnp.ndarray, G: int, n: int,
               fsum_cols=None, route: Optional[str] = None):
    """Grouped reduction of the limb matrix: (sums int64[G,S] exact ints,
    fsums f64[G,len(fsum_cols)] for the shadow columns).  seg_id == G
    drops the row.

    route (default: backend.grouped_reduce_route(G)) picks the formulation;
    both give the same integer sums bit for bit:
      segment_sum — int64 segment sum over V (exact in any summation
                    order, so a GPU's atomic scatter-add reproduces it);
      onehot_dot  — per SEG_ROWS-row segment, a one-hot(seg_id) x V
                    dot_general on bf16 operands with f32 accumulation,
                    then an exact int64 sum across segments.  Operands are
                    integers in [-255, 255] (exact in bf16) and every
                    per-segment sum stays below 2^24 (65536 rows x 255),
                    so the f32 accumulator holds it exactly.  DEFAULT
                    precision is exact here: TF32 or bf16 operand rounding
                    cannot change a value that is already a bf16 integer.
    The shadow columns are threshold guards, not exact results; their f64
    sums may differ in the last bits between routes and runs."""
    route = route or backend.grouped_reduce_route(G)
    if route not in backend.GROUPED_REDUCE_ROUTES:
        raise ValueError(f"unknown grouped-reduction route {route!r}")
    S = V.shape[1]
    if fsum_cols is None:
        fsum_cols = list(range(S))
    fsel = jnp.asarray(fsum_cols, dtype=jnp.int32) if fsum_cols \
        else jnp.zeros(0, jnp.int32)
    if route == "segment_sum":
        sums = jax.ops.segment_sum(V.astype(jnp.int64), seg_id,
                                   num_segments=G)
        fsums = jax.ops.segment_sum(V[:, fsel].astype(jnp.float64), seg_id,
                                    num_segments=G)
        return sums, fsums
    rows = SEG_ROWS if n > SEG_ROWS else max(n, 1)
    pad = (-n) % rows
    if pad:
        V = jnp.pad(V, ((0, pad), (0, 0)))
        seg_id = jnp.pad(seg_id, (0, pad), constant_values=G)
    nseg = (n + pad) // rows
    oh = jax.nn.one_hot(seg_id.reshape(nseg, rows), G, dtype=jnp.bfloat16)
    vb = V.reshape(nseg, rows, -1)
    if vb.dtype != jnp.bfloat16:
        vb = vb.astype(jnp.bfloat16)
    part = jax.lax.dot_general(oh, vb, (((1,), (1,)), ((0,), (0,))),
                               precision=jax.lax.Precision.DEFAULT,
                               preferred_element_type=jnp.float32)
    sums = jnp.sum(part.astype(jnp.int64), axis=0)
    fsums = jnp.sum(part[:, :, fsel].astype(jnp.float64), axis=0)
    return sums, fsums


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def _limb_int(sums: np.ndarray, g: int, idxs: Sequence[int]) -> int:
    v = 0
    for j, ci in enumerate(idxs):
        v += int(sums[g, ci]) << (8 * j)
    return v


def mxu_host_groups(out, key_recipes, key_metas):
    """Exact key-constancy check + key recovery over nonempty buckets.

    Returns (collision, [(g, keyvals tuple)]); collision True triggers the
    executor's salt-retry / sort-fallback, same as the scatter contract."""
    sums = np.asarray(out["mxu_sums"])
    nrows_b = sums[:, 0]
    groups = []
    for g in np.flatnonzero(nrows_b > 0):
        g = int(g)
        nb = int(nrows_b[g])
        kv = []
        for kr, meta in zip(key_recipes, key_metas):
            nval = int(sums[g, kr.nval])
            if nval not in (0, nb):
                return True, []              # NULL/value mix in one bucket
            if nval == 0:
                kv.append(None)
                continue
            s1 = _limb_int(sums, g, kr.sum_limbs)
            s2 = _limb_int(sums, g, kr.sumsq_limbs)
            if nval * s2 != s1 * s1:
                return True, []              # two distinct keys share bucket
            if kr.sum_limbs_hi:
                # 64-bit key: hi word must be constant too
                h1 = _limb_int(sums, g, kr.sum_limbs_hi)
                h2 = _limb_int(sums, g, kr.sumsq_limbs_hi)
                if nval * h2 != h1 * h1:
                    return True, []
                raw = ((h1 // nval) << 32 | (s1 // nval)) - kr.bias
                kv.append(_decode_key(kr.t, raw, meta))
            else:
                kv.append(_decode_key(kr.t, s1 // nval - kr.bias, meta))
        groups.append((g, tuple(kv)))
    return False, groups


def _decode_key(t: T, raw: int, meta):
    if t in (T.TEXT, T.BPCHAR):
        return meta.dictionary[raw] if meta and meta.dictionary else None
    if t is T.BOOL:
        return bool(raw)
    return int(raw)


def mxu_overflow(out, slot_recipes) -> bool:
    """Any additive slot outside its exact window => host replay.

    mxu_fsums carries ONLY the shadow columns (mxu_shadow_cols order)."""
    fsums = np.asarray(out["mxu_fsums"])
    spos = {c: i for i, c in enumerate(mxu_shadow_cols(slot_recipes))}
    for d in slot_recipes:
        for kind, r in d.items():
            if kind == "sum_i" and r.shadow >= 0 and np.any(
                    fsums[:, spos[r.shadow]] > float(1 << 61)):
                return True
            if kind == "sum_f" and not r.lo_limbs:
                sh = fsums[:, spos[r.shadow]]
                # PG sums float4 stepwise in f32: if the absolute mass could
                # reach f32-inf territory the host must replay sequentially
                # to reproduce PostgreSQL's mid-sum overflow error (the same
                # guard the scatter path applies on-device)
                if (np.any(np.isinf(sh)) or np.any(np.isnan(sh))
                        or np.any(sh > 3.0e38)):
                    return True
            elif r.lo_limbs:
                # f64 double-float block: inf/nan head (value beyond the f32
                # head range, or inf/nan input/square) => host replay
                sh = fsums[:, spos[r.shadow]]
                if np.any(np.isinf(sh)) or np.any(np.isnan(sh)):
                    return True
    return False


def mxu_extract_slot(r: _SlotRecipe, out, g: int) -> dict:
    """Host-exact partial(s) for one MXU slot kind at bucket g."""
    sums = np.asarray(out["mxu_sums"])
    if r.kind in ("nrows", "count"):
        return {r.kind: int(sums[g, r.limbs[0]])}
    if r.kind == "sum_i":
        okcnt = int(sums[g, r.okcnt])
        total = _limb_int(sums, g, r.limbs) - (okcnt << r.bias_bits)
        total &= (1 << 64) - 1               # modular-int64 contract
        if total >= (1 << 63):
            total -= 1 << 64
        return {"sum_i": total}
    if r.kind == "sumsq_i":
        return {"sumsq_i": _limb_int(sums, g, r.limbs)}
    if r.kind == "sum_f" and not r.lo_limbs:
        E = int(np.asarray(out["mxu_f4exps"])[r.f4_slot_no])
        m = _limb_int(sums, g, r.limbs)          # signed digit sums
        return {"sum_f": float(m) * 2.0 ** (E - F4_WINDOW)}
    if r.lo_limbs:
        exps = np.asarray(out["mxu_f4exps"])
        Eh = int(exps[r.f4_slot_no])
        El = int(exps[r.lo_slot_no])
        mh = _limb_int(sums, g, r.limbs)
        ml = _limb_int(sums, g, r.lo_limbs)
        # both terms are dyadic rationals: combine exactly in big ints and
        # round ONCE — the correctly rounded sum of the rows' head + tail
        # values, each within 2^-47 of its f64 value (the f32 tail,
        # _f64_head_tail) and the per-row 2^(E-72) truncation window
        emin = min(Eh, El) - F4_WINDOW
        M = (mh << (Eh - F4_WINDOW - emin)) + (ml << (El - F4_WINDOW - emin))
        return {r.kind: _dyadic_float(M, emin)}
    raise ValueError(r.kind)


def _dyadic_float(M: int, e: int) -> float:
    """Correctly rounded float of M * 2^e for arbitrary-width int M."""
    if M == 0:
        return 0.0
    if e >= 0:
        f = float(M)                      # one rounding
        return f * (2.0 ** e) if e < 1024 else float(M << e)
    # M / 2^-e: keep 54+ significant bits, let float division round once
    shift = max(M.bit_length() - 63, 0)
    if shift <= -e:
        return float(M >> shift) / float(1 << (-e - shift)) if -e - shift < 1024 \
            else float(M >> shift) * (2.0 ** (e + shift))
    return float(M) * (2.0 ** e)


# ---------------------------------------------------------------------------
# executor glue: one call consumes a fetched MXU-strategy chunk output
# ---------------------------------------------------------------------------

def mxu_dense_groups(out, key_type: T, meta):
    """Populated buckets of a dense-key ('mxu_dense') chunk: bucket index
    IS key - kmin; bucket rng+1 is the NULL-key group."""
    sums = np.asarray(out["mxu_sums"])
    kmin = int(np.asarray(out["dense_kmin"]))
    rng = int(np.asarray(out["dense_rng"]))
    groups = []
    for g in np.flatnonzero(sums[:, 0] > 0):
        g = int(g)
        kv = None if g == rng + 1 else _decode_key(key_type, kmin + g, meta)
        groups.append((g, (kv,)))
    return groups


def mxu_absorb(out_host, group_exprs, aggs, key_metas, states, displays,
               merge_partials, extract_partials, canon_group_key,
               dense_key: bool = False):
    """Merge one fetched MXU-strategy output into (states, displays).

    Returns (collision, overflow): collision => executor re-salts / falls
    back to the sort strategy; overflow => host replays the chunk (the
    CpuReCheck contract).  Either way states are untouched on failure.
    dense_key must match the strategy that produced out_host ('mxu_dense')."""
    key_types = [g.type for g in group_exprs]
    arg_types = [tuple(a.type for a in inst.args) for inst in aggs]
    keyr, slotr, _ = mxu_recipes(key_types, aggs, arg_types,
                                 dense_key=dense_key)
    if dense_key:
        groups = mxu_dense_groups(out_host, key_types[0], key_metas[0])
    else:
        collision, groups = mxu_host_groups(out_host, keyr, key_metas)
        if collision:
            return True, False
    if mxu_overflow(out_host, slotr):
        return False, True
    slots = [{k: np.asarray(v) for k, v in d.items()}
             for d in out_host["slots"]]
    for g, kvals in groups:
        ck = tuple(canon_group_key(v) for v in kvals)
        parts = []
        for inst, rd, arrs in zip(aggs, slotr, slots):
            p = extract_partials(inst, arrs, g, skip=tuple(rd.keys()))
            for kind, r in rd.items():
                p.update(mxu_extract_slot(r, out_host, g))
            parts.append(p)
        if ck not in states:
            states[ck] = parts
            displays[ck] = kvals
        else:
            st = states[ck]
            states[ck] = [merge_partials(inst, a, b)
                          for inst, a, b in zip(aggs, st, parts)]
    return False, False
