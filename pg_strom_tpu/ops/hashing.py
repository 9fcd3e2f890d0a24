"""Vectorized key hashing for group-by and hash join.

The reference hashes join/group keys with PostgreSQL's CRC32 table walked
byte-by-byte (opencl_hashjoin.h:21-60, gpuhashjoin.c:3614).  A table-walk is
scalar-loop-shaped — hostile to vector units — so this design hashes
whole int64 lanes with a splitmix64-style avalanche and combines columns with
a boost-style mixer.  Only equality structure matters (host rehashes by key
value when merging partials), so the engine is free to pick a vector-friendly
hash.

Canonicalization before hashing (SQL equality, not bit equality):
  float   : -0.0 -> +0.0, any NaN -> canonical NaN   (PG: -0=0, NaN=NaN)
  numeric : (mant,exp) lanes are normalized at load (no trailing zeros)
  NULL    : hashed as a fixed tag; SQL GROUP BY puts NULLs in one group
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..sqltypes import T

# numpy scalar, NOT an eager jnp array: a module-level jnp constant is
# created on a device at import and captured into every jit that uses it
_NULL_TAG = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: jnp.ndarray) -> jnp.ndarray:
    """splitmix64 finalizer: full avalanche on uint64 lanes."""
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def _canonical_bits(t: T, data: jnp.ndarray) -> jnp.ndarray:
    """uint64 lanes such that SQL-equal values have equal bits."""
    if t in (T.FLOAT4, T.FLOAT8):
        d = data.astype(jnp.float64)
        d = jnp.where(d == 0.0, 0.0, d)          # -0.0 == +0.0
        d = jnp.where(jnp.isnan(d), jnp.float64(jnp.nan), d)  # canonical NaN
        return jax_bitcast_f64_u64(d)
    if t is T.BOOL:
        return data.astype(jnp.uint64)
    return data.astype(jnp.int64).astype(jnp.uint64)


def jax_bitcast_f64_u64(d: jnp.ndarray) -> jnp.ndarray:
    import jax
    return jax.lax.bitcast_convert_type(d, jnp.uint64)


def canonical_f64_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """Canonicalize raw IEEE double bits: -0 -> +0, NaNs -> one pattern.
    Equal canonical bits <=> SQL-equal float8 values (exact, no float
    arithmetic involved)."""
    b = bits.astype(jnp.int64)
    b = jnp.where(b == jnp.int64(-(1 << 63)), jnp.int64(0), b)
    expmask = jnp.int64(0x7FF0000000000000)
    frac = b & jnp.int64(0x000FFFFFFFFFFFFF)
    is_nan = ((b & expmask) == expmask) & (frac != 0)
    return jnp.where(is_nan, jnp.int64(0x7FF8000000000000), b)


def hash_column(t: T, data: jnp.ndarray, valid: jnp.ndarray,
                exp: jnp.ndarray | None = None,
                bits: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-row uint64 hash of one key column (NULL-aware).

    For float8, pass the exact IEEE bits plane when available — hashing
    integer bits cannot be changed by float arithmetic on the value lanes."""
    if t is T.FLOAT8 and bits is not None:
        h = _mix64(canonical_f64_bits(bits).astype(jnp.uint64))
    else:
        h = _mix64(_canonical_bits(t, data))
    if t is T.NUMERIC and exp is not None:
        h = _mix64(h ^ _mix64(exp.astype(jnp.int64).astype(jnp.uint64)))
    return jnp.where(valid, h, _NULL_TAG)


def combine_hashes(hs: list[jnp.ndarray]) -> jnp.ndarray:
    """boost::hash_combine-style fold across key columns."""
    acc = jnp.zeros_like(hs[0]) if hs else None
    for h in hs:
        acc = _mix64(acc ^ (h + jnp.uint64(0x9E3779B97F4A7C15) +
                            (acc << 6) + (acc >> 2)))
    return acc


# ---------------------------------------------------------------------------
# 32-bit pipeline: bucketing hashes.
#
# Bucket selection only needs ~log2(nbuckets) good bits, so the grouped-agg
# and join partitioners hash entirely in native uint32; exactness never
# depends on hash quality (collision checks / exact key compares downstream).
# ---------------------------------------------------------------------------

_NULL_TAG32 = np.uint32(0x9E3779B9)


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """lowbias32 finalizer: full avalanche on uint32 lanes."""
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def _fold32(t: T, data: jnp.ndarray) -> jnp.ndarray:
    """uint32 lanes such that SQL-equal values have equal bits."""
    if t in (T.FLOAT4,):
        import jax
        d = data.astype(jnp.float32)
        d = jnp.where(d == 0.0, 0.0, d)
        d = jnp.where(jnp.isnan(d), jnp.float32(jnp.nan), d)
        return jax.lax.bitcast_convert_type(d, jnp.uint32)
    if t is T.BOOL:
        return data.astype(jnp.uint32)
    if data.dtype in (jnp.int64, jnp.uint64, jnp.float64):
        d = data.astype(jnp.int64)
        return (d ^ (d >> 32)).astype(jnp.uint32)
    return data.astype(jnp.int32).astype(jnp.uint32)


def hash_column32(t: T, data: jnp.ndarray, valid: jnp.ndarray,
                  exp: jnp.ndarray | None = None,
                  bits: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-row uint32 hash of one key column (NULL-aware, SQL equality)."""
    if t is T.FLOAT8 and bits is not None:
        cb = canonical_f64_bits(bits)
        h = _mix32((cb ^ (cb >> 32)).astype(jnp.uint32))
    elif t is T.FLOAT8:
        import jax
        d = data.astype(jnp.float64)
        d = jnp.where(d == 0.0, 0.0, d)
        d = jnp.where(jnp.isnan(d), jnp.float64(jnp.nan), d)
        b = jax.lax.bitcast_convert_type(d, jnp.int64)
        h = _mix32((b ^ (b >> 32)).astype(jnp.uint32))
    else:
        h = _mix32(_fold32(t, data))
    if t is T.NUMERIC and exp is not None:
        h = _mix32(h ^ _mix32(exp.astype(jnp.int32).astype(jnp.uint32)))
    return jnp.where(valid, h, _NULL_TAG32)


def combine_hashes32(hs: list[jnp.ndarray]) -> jnp.ndarray:
    acc = jnp.zeros_like(hs[0]) if hs else None
    for h in hs:
        acc = _mix32(acc ^ (h + jnp.uint32(0x9E3779B9) +
                            (acc << 6) + (acc >> 2)))
    return acc
