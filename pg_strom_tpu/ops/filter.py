"""Scan filter with device-side compaction.

The GpuScan kernel analog (reference opencl_gpuscan.h:98-177): 1 work-item
per row evaluates the generated qual, then passing row indexes are compacted
via `arithmetic_stairlike_add` prefix-sum + an atomic base counter.  Here
the same compaction is a vectorized cumsum + scatter over the whole chunk —
no atomics, no workgroups:

    mask -> positions = cumsum(mask) - 1 -> scatter row ids to positions

Output is a padded int32 row-index vector plus `nmatch` (static shapes for
XLA; the executor reads only the first nmatch entries), exactly the shape of
the reference's kern_resultbuf (opencl_common.h results[] + nitems).

Fused variants (filter+project, filter+aggregate) live with their consumers
(expr/lower_jax.build_project_fn, ops/preagg) — the operator-fusion analog of
the reference's bulk-load path (pgstrom_bulkslot, gpuscan.c:1318) where a
chunk never leaves the device between operators.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..expr.ir import Expr
from ..expr.lower_jax import Lowerer, ColMeta


def compact_mask(mask: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(row_ids int32[n] padded with n, nmatch int32).

    row_ids[:nmatch] are the indexes of True lanes, in row order."""
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    nmatch = jnp.sum(mask.astype(jnp.int32))
    src = jnp.arange(n, dtype=jnp.int32)
    row_ids = jnp.full(n, n, dtype=jnp.int32).at[
        jnp.where(mask, pos, n)].set(src, mode="drop")
    return row_ids, nmatch


def bitpack_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """bool[n] -> uint8[ceil(n/8 to 128)] TILED bitmask (n padded to 1024).

    Pure elementwise + tiny reduce — replaces the cumsum+scatter compaction
    and shrinks the device->host result 32x vs padded int32 row ids.

    Tiled bit order: bit b of byte [j, l] (flattened j*128 + l) holds row
    (j*8 + b)*128 + l — the pack reduces along the middle axis of a
    (J, 8, 128) view.  unpack_maskbits() is the matching host decoder."""
    n = mask.shape[0]
    pad = (-n) % 1024
    if pad:
        mask = jnp.pad(mask, (0, pad))
    m = mask.reshape(-1, 8, 128).astype(jnp.uint8)
    w = np.asarray([1, 2, 4, 8, 16, 32, 64, 128],
                   dtype=np.uint8).reshape(1, 8, 1)
    return jnp.sum(m * w, axis=1, dtype=jnp.uint8).reshape(-1)


def unpack_maskbits(maskbits: np.ndarray, nrows: int) -> np.ndarray:
    """Host decoder for bitpack_mask's tiled order -> bool[nrows]."""
    b = np.asarray(maskbits).reshape(-1, 1, 128)
    bits = np.unpackbits(b, axis=1, bitorder="little")   # (J, 8, 128)
    return bits.reshape(-1)[:nrows].astype(bool)


def build_filter_mask_fn(pred: Optional[Expr],
                         schema: Sequence[ColMeta]) -> Callable:
    """f(cols, nrows) -> (maskbits uint8[ceil(n/8)], nmatch, err_max).

    The standalone GpuScan with a bit-packed match mask instead of
    device-side compaction (see bitpack_mask)."""
    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        mask = live
        if pred is not None:
            v = lw.lower(pred, live)
            mask = live & v.valid & v.data.astype(jnp.bool_)
        nmatch = jnp.sum(mask.astype(jnp.int32))
        err = jnp.max(jnp.where(live, lw.err, jnp.uint8(0))) if n \
            else jnp.uint8(0)
        return bitpack_mask(mask), nmatch, err
    return f


def build_filter_compact_fn(pred: Expr, schema: Sequence[ColMeta]) -> Callable:
    """f(cols, nrows) -> (row_ids, nmatch, err_max).

    The standalone GpuScan: qual eval + compaction.  err_max != 0 => the
    executor replays the chunk host-side (per-row granularity is preserved
    by the row-level error lanes if the caller wants it)."""
    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(schema, cols, live)
        v = lw.lower(pred, live)
        mask = live & v.valid & v.data.astype(jnp.bool_)
        row_ids, nmatch = compact_mask(mask)
        return row_ids, nmatch, jnp.max(jnp.where(live, lw.err, jnp.uint8(0)))
    return f


def gather_columns(cols: tuple, row_ids: jnp.ndarray) -> tuple:
    """Materialize passing rows: gather every plane at row_ids (clipped);
    lanes past nmatch are garbage and masked by the caller."""
    n = cols[0][0].shape[0] if cols else 0
    idx = jnp.clip(row_ids, 0, max(n - 1, 0))
    out = []
    for planes in cols:
        out.append(tuple(p[idx] for p in planes))
    return tuple(out)
