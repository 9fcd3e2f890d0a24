"""Fused hash-join -> grouped partial aggregation in one device program.

The bulk-load analog: the reference passes a device-resident chunk between
GPU nodes without host materialization (`pgstrom_bulkslot`, pg_strom.h:317-329;
gpuscan_exec_multi gpuscan.c:1318-1446 feeding gpuhashjoin/gpupreagg), so a
scan->join->aggregate pipeline touches host memory only for final partials.
Here the same contract is one jitted XLA program: probe kernel -> on-device
projection gathers (kern_gpuhashjoin_projection_slot analog,
opencl_hashjoin.h:691+) -> the preagg kernel over the joined lanes.  The
joined rows never exist on the host.

Error/retry contracts compose:
  nout > out_cap   -> executor regrows and re-dispatches (DataStoreNoSpace)
  err lane nonzero -> host replays the probe chunk (CpuReCheck)
  scatter collision-> salt retry / sort-strategy fallback (preagg contract)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax.numpy as jnp

from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef
from ..expr.lower_jax import ColMeta, Lowerer
from .hashjoin import build_probe_fn, build_probe_dense_fn
from .preagg import AggInstance, build_preagg_fn


def build_join_preagg_fn(pschema: Sequence[ColMeta],
                         probe_keys: Sequence[Expr],
                         key_types: tuple,
                         nbuckets: int, max_chain: int, out_cap: int,
                         probe_pred: Optional[Expr],
                         jschema: Sequence[ColMeta],
                         probe_slots: Sequence[int],
                         build_slots: Sequence[tuple[int, tuple]],
                         group_exprs: Sequence[Expr],
                         aggs: Sequence[AggInstance],
                         G: int, strategy: str = "scatter",
                         dense: bool = False, dense_cap: int = 0) -> Callable:
    """Build f(ht, pcols, bcols, nrows, salt) -> preagg pytree + 'nout'.

    jschema describes the joined (projected) layout the group/agg exprs are
    bound to; each jschema slot is filled by gathering either a probe column
    (probe_slots[i] = probe layout index, or -1) or a build column
    (build_slots entries are (jslot, bcol_index)).

    dense=True (direct-address unique build, hashjoin.build_probe_dense_fn):
    joined lanes stay ROW-ALIGNED with the probe chunk — probe columns pass
    through untouched, build columns gather once at build_row, and the match
    mask feeds the aggregation as a synthetic bool filter column.  No pair
    materialization, no output capacity, no regrow."""
    probe_slots = list(probe_slots)
    build_map = dict(build_slots)

    if dense:
        dprobe_fn = build_probe_dense_fn(pschema, list(probe_keys),
                                         dense_cap, probe_pred)
        jschema_eff = list(jschema) + [ColMeta("__match__", T.BOOL)]
        match_pred = ColumnRef(type=T.BOOL, name="__match__",
                               index=len(jschema))
        pre_fn = build_preagg_fn(jschema_eff, list(group_exprs), list(aggs),
                                 match_pred, G, strategy)

        def f_dense(ht: dict, pcols: tuple, bcols: tuple, nrows, salt):
            matched, build_row, nout, jerr = dprobe_fn(ht, pcols, nrows)
            jcols = []
            for jslot in range(len(jschema)):
                if probe_slots[jslot] >= 0:
                    g = list(pcols[probe_slots[jslot]])
                    g[1] = g[1] & matched
                else:
                    g = [p[build_row] for p in bcols[build_map[jslot]]]
                    g[1] = g[1] & matched
                jcols.append(tuple(g))
            ones = jnp.ones_like(matched)
            jcols.append((matched, ones))          # __match__ filter lane
            out = pre_fn(tuple(jcols), nrows, salt)
            out["err"] = jnp.maximum(out["err"], jerr)
            out["nout"] = jnp.int32(0)             # row-aligned: no capacity
            return out

        return f_dense

    probe_fn = build_probe_fn(pschema, list(probe_keys), key_types, nbuckets,
                              max_chain, out_cap, probe_pred)
    # count(*)-only queries reference no columns; the preagg still needs a
    # lane to carry the joined-row mask, so inject a synthetic bool column
    jschema_eff = list(jschema) or [ColMeta("__rows__", T.BOOL)]
    pre_fn = build_preagg_fn(jschema_eff, list(group_exprs), list(aggs), None,
                             G, strategy)

    def f(ht: dict, pcols: tuple, bcols: tuple, nrows, salt):
        probe_idx, build_row, nout, jerr = probe_fn(ht, pcols, nrows)
        n = pcols[0][0].shape[0] if pcols else 0
        bs_max = bcols[0][0].shape[0] if bcols else 0
        nlive = jnp.minimum(nout, jnp.int32(out_cap))
        live_out = jnp.arange(out_cap, dtype=jnp.int32) < nlive
        pi = jnp.clip(probe_idx, 0, max(n - 1, 0))
        br = jnp.clip(build_row, 0, max(bs_max - 1, 0))

        jcols = []
        for jslot in range(len(jschema)):
            if probe_slots[jslot] >= 0:
                planes, idx = pcols[probe_slots[jslot]], pi
            else:
                planes, idx = bcols[build_map[jslot]], br
            g = [p[idx] for p in planes]
            g[1] = g[1] & live_out          # validity plane
            jcols.append(tuple(g))
        if not jcols:                        # synthetic row-mask lane
            jcols.append((live_out, live_out))

        out = pre_fn(tuple(jcols), nlive, salt)
        out["err"] = jnp.maximum(out["err"], jerr)
        out["nout"] = nout
        return out

    return f


def build_join_preagg_pregrouped_fn(
        pschema: Sequence[ColMeta], probe_keys: Sequence[Expr],
        dense_cap: int, probe_pred: Optional[Expr],
        jschema: Sequence[ColMeta], probe_slots: Sequence[int],
        aggs: Sequence[AggInstance], G: int,
        strategy: str = "mxu") -> Callable:
    """Star-schema fused join->aggregate with PRE-ASSIGNED group ids.

    When every GROUP BY expression reads only build-side (dimension) columns
    and every aggregate reads only probe-side (fact) columns, the executor
    enumerates the distinct group-key tuples over the small build side ONCE
    (host, exact — text keys ride free) into a slot -> group-id table
    (`ht['seg_tab']`, int32[dense_cap], sentinel G for empty slots).  The
    per-chunk device program is then ONE gather (probe key -> group id)
    feeding the grouped preagg — no build-row gather, no build-column
    gathers, no salt ladder (group ids are dense ints < G-2, the
    collision-free range bucketing in preagg._bucket_ids).

    Reference contrast: the reference always materializes the join output
    before GpuPreAgg re-derives groups from key values
    (kern_gpuhashjoin_projection_slot -> gpupreagg_keycomp); pre-resolving
    dimension groups at build time has no reference counterpart — it trades
    one gather per build column for one gather in total.

    f(ht, pcols, nrows, salt) -> preagg pytree (+'nout'=0); group keys in
    the output are the int seg ids, which the executor maps back to the
    enumerated display tuples."""
    probe_keys = list(probe_keys)
    probe_slots = list(probe_slots)
    jschema_eff = (list(jschema)
                   + [ColMeta("__seg__", T.INT4), ColMeta("__match__", T.BOOL)])
    seg_ref = ColumnRef(type=T.INT4, name="__seg__", index=len(jschema))
    match_pred = ColumnRef(type=T.BOOL, name="__match__",
                           index=len(jschema) + 1)
    pre_fn = build_preagg_fn(jschema_eff, [seg_ref], list(aggs), match_pred,
                             G, strategy)

    def f(ht: dict, pcols: tuple, nrows, salt):
        n = pcols[0][0].shape[0] if pcols else 0
        live = jnp.arange(n, dtype=jnp.int32) < nrows
        lw = Lowerer(pschema, pcols, live)
        mask = live
        if probe_pred is not None:
            pv = lw.lower(probe_pred, live)
            mask = live & pv.valid & pv.data.astype(jnp.bool_)
        k = lw.lower(probe_keys[0], mask)
        off = k.data.astype(jnp.int64) - ht["kmin"]
        in_r = mask & k.valid & (off >= 0) & (off < dense_cap)
        slot = jnp.clip(off, 0, dense_cap - 1).astype(jnp.int32)
        seg = ht["seg_tab"][slot]
        matched = in_r & (seg < jnp.int32(G))
        seg = jnp.where(matched, seg, jnp.int32(0))
        jcols = []
        for jslot in range(len(jschema)):
            g = list(pcols[probe_slots[jslot]])
            g[1] = g[1] & matched
            jcols.append(tuple(g))
        ones = jnp.ones_like(matched)
        jcols.append((seg, ones))                  # __seg__ group lane
        jcols.append((matched, ones))              # __match__ filter lane
        out = pre_fn(tuple(jcols), nrows, salt)
        jerr = jnp.max(jnp.where(live, lw.err, jnp.uint8(0))) if n \
            else jnp.uint8(0)
        out["err"] = jnp.maximum(out["err"], jerr)
        out["nout"] = jnp.int32(0)
        return out

    return f
