"""N-way fused device join chain -> grouped partial aggregation.

The multi-relation device join chain (reference: gpuhashjoin merges
consecutive joins into one multi-rel kernel — path merge gpuhashjoin.c:789-835,
probe recursion opencl_hashjoin.h kern_gpuhashjoin_main depths /
gpuhashjoin.c:1184-1318 — and passes device-resident bulkslots between GPU
nodes, pg_strom.h:317-329).  Here every inner relation is probed
ROW-ALIGNED with the fact chunk, so the joined row set never materializes —
no chain recursion on device, no intermediate host Table:

  * unique single-int-key inners ("dense"): ONE direct-address or identity
    probe per inner — match mask + one build-row lane.
  * non-unique or multi-key inners ("multi", round 3): the bounded-fanout
    probe (ops/hashjoin.build_probe_multi_fn) returns up to F build rows
    PER PROBE ROW, still row-aligned.  The fused program then enumerates
    the (small) cartesian product of fanout indices across multi inners as
    SLICES: slice s fixes one match choice per multi inner, its mask is
    the AND of all inner matches, and the grouped partial aggregation runs
    once per slice over the same fact lanes.  Summing partial states over
    slices is exactly the fan-out join semantics (each composite match
    combination contributes once) — the static-shape replacement for
    the reference's dynamic count->reserve->write expansion
    (opencl_hashjoin.h:339-412).

  A fanout overflow (some probe row matched more than F rows of an inner,
  or a bucket chain exceeded the bounded walk) raises `join_ovf`; the
  executor doubles F (recompile — the standard host-driven retry shape)
  and ultimately falls back to the host-exact tier.

Applicability: group/agg exprs and join keys must be device-supported;
text join keys (per-table dictionaries) fall back to the pairwise chain.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import jax.numpy as jnp

from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef
from ..expr.lower_jax import ColMeta
from .hashjoin import build_probe_dense_fn, build_probe_multi_fn
from .preagg import AggInstance, build_preagg_fn


def build_star_join_preagg_fn(pschema: Sequence[ColMeta],
                              dim_specs: Sequence[dict],
                              probe_pred: Optional[Expr],
                              jschema: Sequence[ColMeta],
                              probe_slots: Sequence[int],
                              build_slot_map: dict,
                              group_exprs: Sequence[Expr],
                              aggs: Sequence[AggInstance],
                              G: int, strategy: str = "scatter") -> Callable:
    """f(hts tuple, pcols, bcols_list tuple, nrows, salt) -> out pytree.

    dim_specs[i] (dense): {"mode": "dense", "probe_keys": [Expr],
      "dense_cap": int, "use_ident": bool}
    dim_specs[i] (multi): {"mode": "multi", "probe_keys": [Expr...],
      "key_types": tuple, "max_chain": int, "fanout": int}

    jschema slots fill from the probe chunk (probe_slots[j] >= 0) or from
    dimension d's column b (build_slot_map[j] = (d, b)) gathered at that
    dim's matched row for the current slice.  Output: {"slices": tuple of
    per-slice preagg pytrees, "join_ovf": bool} — the executor absorbs
    each slice like a chunk and merges partial states.
    """
    probe_slots = list(probe_slots)
    dfns = []
    for i, d in enumerate(dim_specs):
        src = d.get("key_source", "probe")
        schema_i = pschema if src == "probe" else d["src_schema"]
        pred_i = probe_pred if (i == 0 and src == "probe") else None
        if d.get("mode", "dense") == "multi":
            dfns.append(("multi", src, build_probe_multi_fn(
                schema_i, list(d["probe_keys"]), tuple(d["key_types"]),
                d["max_chain"], d["fanout"], pred_i)))
        else:
            dfns.append(("dense", src, build_probe_dense_fn(
                schema_i, list(d["probe_keys"]), d["dense_cap"], pred_i,
                use_ident=d.get("use_ident", False))))
    jschema_eff = list(jschema) + [ColMeta("__match__", T.BOOL)]
    match_pred = ColumnRef(type=T.BOOL, name="__match__", index=len(jschema))
    pre_fn = build_preagg_fn(jschema_eff, list(group_exprs), list(aggs),
                             match_pred, G, strategy)
    fan_ranges = [range(d["fanout"]) if d.get("mode") == "multi" else (0,)
                  for d in dim_specs]

    def f(hts: tuple, pcols: tuple, bcols_list: tuple, nrows, salt):
        jerr = jnp.uint8(0)
        ovf = jnp.bool_(False)
        dim_res = []
        for di, ((mode, src, dfn), ht) in enumerate(zip(dfns, hts)):
            if src == "probe":
                cols_in = pcols
            else:
                # snowflake: probe with the PARENT dimension's columns
                # gathered at its matched rows (row-aligned with the fact;
                # spurious values on parent-unmatched rows are killed by
                # the AND over all dims' masks below).  The parent is
                # dense, so its match is slice-independent.
                _, _pm, pbr = dim_res[src]
                cols_in = tuple(tuple(pl[pbr] for pl in colp)
                                for colp in bcols_list[src])
            if mode == "dense":
                m, br, _, e = dfn(ht, cols_in, nrows)
                if src != "probe":
                    m = m & dim_res[src][1]
                dim_res.append(("dense", m, br))
            else:
                brs, cnt, o, e = dfn(ht, cols_in, nrows)
                if src != "probe":
                    cnt = jnp.where(dim_res[src][1], cnt, jnp.int32(0))
                dim_res.append(("multi", brs, cnt))
                ovf = ovf | o
            jerr = jnp.maximum(jerr, e)

        outs = []
        for combo in itertools.product(*fan_ranges):
            matched = None
            brs_eff = []
            for res, fx in zip(dim_res, combo):
                if res[0] == "dense":
                    m, br = res[1], res[2]
                else:
                    m = res[2] > jnp.int32(fx)
                    br = res[1][fx]
                matched = m if matched is None else (matched & m)
                brs_eff.append(br)
            jcols = []
            for jslot in range(len(jschema)):
                if probe_slots[jslot] >= 0:
                    g = list(pcols[probe_slots[jslot]])
                else:
                    di, bci = build_slot_map[jslot]
                    g = [p[brs_eff[di]] for p in bcols_list[di][bci]]
                g[1] = g[1] & matched
                jcols.append(tuple(g))
            jcols.append((matched, jnp.ones_like(matched)))  # __match__
            out = pre_fn(tuple(jcols), nrows, salt)
            out["err"] = jnp.maximum(out["err"], jerr)
            out["nout"] = jnp.int32(0)       # row-aligned: no output cap
            outs.append(out)
        return {"slices": tuple(outs), "join_ovf": ovf}

    return f
