"""Distributed join + aggregation executor over a device mesh.

Engine entry to parallel/dist.py: the planner (plan/planner.py) routes the
fused join->aggregate shape through this executor when
pg_strom.distributed is on and >1 device is visible.  Owns:

  - eligibility (ColumnRef keys/args of mesh-shippable types, slot kinds
    within DIST_SLOT_KINDS; agg(DISTINCT x) rides the dedup exchange,
    one phase per distinct agg — _distinct_agg_distributable)
  - skew routing: sampled heavy-hitter hashes spread hot probe keys over
    all devices and broadcast the matching build rows (round 4)
  - side predicates: applied per side through the single-chip ScanExecutor
    before distribution (the scan tier keeps its own device/host verdict)
  - lane encoding (canonical int64 keys, dictionary codes, f32/f64-bit arg
    lanes) and exact host decoding of group keys
  - the overflow -> repartition loop: any per-device capacity flag
    (partition bucket, probe chain, group slots) re-runs the step with
    doubled capacities — the distributed analog of the reference's
    StromError_DataStoreNoSpace server-side regrow (gpuhashjoin.c:4323-4425)
  - CpuReCheck: a nonzero device err lane abandons the distributed path for
    the single-device executors (which own exact host replay)

Host merge folds per-device group partials through ops/preagg's
merge_partials/extract_partials — the same two-phase exactness contract as
the local preagg pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax

from ..config import config
from ..datastore import Table
from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef
from ..ops.preagg import AggInstance, extract_partials, merge_partials
from ..parallel.dist import (
    LaneSpec, DistPlanSig, build_dist_join_agg_step,
    JOIN_KEY_OK, GROUP_KEY_OK, AGG_ARG_OK, DIST_SLOT_KINDS,
)
from ..parallel.mesh import get_mesh, mesh_for_config
from ..parallel.shuffle import pad_shards
from ..utils.perfmon import Perfmon
from .hostexec import canon_group_key


class DistFallback(Exception):
    """Signal: run this query on the single-device path instead."""


def _next_pow2(n: int, lo: int = 256) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _args_for_specs(inst, specs) -> list:
    """Repeat each arg once per wire lane (numeric args span 3 specs)."""
    out = []
    for a in inst.args:
        out.extend([a] * len(_arg_specs("probe", a.type)))
    assert len(out) == len(specs)
    return out


def _arg_specs(side: str, t: T) -> list:
    """Wire LaneSpecs for one agg argument: one lane, except NUMERIC which
    ships (mantissa, exponent, dscale) — see parallel/dist.DIST_SLOT_KINDS."""
    if t is T.NUMERIC:
        return [LaneSpec(side=side, t=t, role="arg"),
                LaneSpec(side=side, t=t, role="arg_exp"),
                LaneSpec(side=side, t=t, role="arg_dscale")]
    return [LaneSpec(side=side, t=t, role="arg")]


def _f64_orderkey_np(a: np.ndarray) -> np.ndarray:
    """Exact int64 order key of float64 values (PG float8_cmp order:
    NaN greatest and equal to NaN; -0 == +0)."""
    a = np.where(np.isnan(a), np.float64("nan"), a)   # canonical quiet NaN
    a = np.where(a == 0.0, 0.0, a)                    # -0 -> +0
    bits = a.view(np.int64)
    return np.where(bits < 0, np.int64(-1) - (bits & np.int64((1 << 63) - 1)),
                    bits)


def _unflip_orderkey(k: int) -> float:
    from ..ops.preagg import unflip_f64_orderkey
    return unflip_f64_orderkey(k)


def _distinct_agg_distributable(inst) -> bool:
    """agg(DISTINCT x) rides the dedup exchange iff its slot kinds are
    additive (min/max need no dedup and stay host-tier).  Float args are
    canonicalized to PG equality in the dedup phase (-0.0 == +0.0, one
    NaN) — parallel/dist._distinct_phase `canon`/`bitproxy`."""
    if any(k not in ("count", "sum_i", "sumsq_i", "sum_f", "sumsq_f")
           for k in inst.slots):
        return False
    if not inst.args:
        return False
    if any(a.type is T.NUMERIC for a in inst.args):
        # numeric DISTINCT: count only — sum(distinct numeric) would need
        # a defined representative display scale per distinct value
        return set(inst.slots) <= {"count"} and all(
            a.type is T.NUMERIC for a in inst.args)
    return all(a.type in (T.INT2, T.INT4, T.INT8, T.DATE, T.BOOL, T.TEXT,
                          T.BPCHAR, T.FLOAT4, T.FLOAT8)
               for a in inst.args)


def _merge_distinct_aware(gk_out, gkv_out, gvalid, slots, extraB, gmeta,
                          group_exprs, aggs, distinct_idxs, pm):
    """Phase-A merge with every distinct agg neutralized, then one
    phase-B merge per distinct agg from its (gkB, gkvB, gvB, slotB)
    quadruple in `extraB` (step-output order == distinct_idxs order)."""
    skip = set(distinct_idxs)
    states, displays = _merge_device_partials(
        gk_out, gkv_out, gvalid, slots, gmeta, group_exprs, aggs,
        skip_idx=skip if skip else None)
    for j, di in enumerate(distinct_idxs):
        pm.bump("dist_distinct_steps")
        gkB, gkvB, gvB, slotB = extraB[4 * j:4 * j + 4]
        slotsB = [slotB[0] if i == di else {} for i in range(len(aggs))]
        _merge_device_partials(
            gkB, gkvB, gvB, slotsB, gmeta, group_exprs, aggs,
            states=states, displays=displays, only_idx=di)
    return states, displays


class DistJoinAggExecutor:
    """SELECT <aggs> FROM probe JOIN build ON keys [WHERE ...] GROUP BY ...
    executed over the device mesh (hash-partition shuffle join + per-device
    partial aggregation + host merge)."""

    # step cache: (sig, caps, ndev) -> jitted step (compiles are expensive)
    _STEP_CACHE: dict = {}

    def __init__(self, probe: Table, build: Table,
                 probe_keys: Sequence[Expr], build_keys: Sequence[Expr],
                 group_exprs: Sequence[Expr], aggs: Sequence[AggInstance],
                 probe_pred: Optional[Expr] = None,
                 build_pred: Optional[Expr] = None,
                 perfmon: Perfmon | None = None):
        self.probe = probe
        self.build = build
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.probe_pred = probe_pred
        self.build_pred = build_pred
        self.perfmon = perfmon or Perfmon()

    # -- eligibility ---------------------------------------------------------

    def _side_of(self, name: str) -> Optional[str]:
        if name in self.probe.columns:
            return "probe"
        if name in self.build.columns:
            return "build"
        return None

    def _expr_side(self, e: Expr) -> Optional[str]:
        """Side of an expression: the side every referenced column lives
        on (None for mixed-side or unresolvable expressions)."""
        if isinstance(e, ColumnRef):
            return self._side_of(e.name)
        from ..expr.ir import referenced_columns
        sides = {self._side_of(nm) for nm in referenced_columns(e)}
        if len(sides) == 1 and None not in sides:
            return sides.pop()
        return None

    def eligible(self) -> bool:
        if not (config.enabled and config.distributed):
            return False
        if len(jax.devices()) < 2:
            return False
        if self.probe.nrows == 0 or self.build.nrows == 0:
            return False                 # empty sides: local path is fine
        for k in self.probe_keys + self.build_keys:
            if not isinstance(k, ColumnRef) or k.type not in JOIN_KEY_OK:
                return False
        from ..expr.catalog import device_expression_supported
        for g in self.group_exprs:
            if g.type not in GROUP_KEY_OK or self._expr_side(g) is None:
                return False
            if not isinstance(g, ColumnRef):
                # computed keys pre-project (round-3 item 9) — except text
                # (per-column dictionaries) and numeric (dscale semantics)
                if (g.type in (T.TEXT, T.BPCHAR, T.NUMERIC)
                        or not device_expression_supported(g)):
                    return False
        for inst in self.aggs:
            if inst.distinct and not _distinct_agg_distributable(inst):
                return False
            if any(kind not in DIST_SLOT_KINDS for kind in inst.slots):
                return False
            for a in inst.args:
                if a.type not in AGG_ARG_OK:
                    return False
                side = self._expr_side(a)
                if side is None:
                    return False
                if not isinstance(a, ColumnRef):
                    if (a.type is T.NUMERIC
                            or not device_expression_supported(a)):
                        return False
                elif a.type is T.NUMERIC:
                    # values outside the device mantissa/exp window carry
                    # exact host-side Decimals the wire can't ship
                    tbl = self.probe if side == "probe" else self.build
                    c = tbl.columns[a.name]
                    if c.recheck is not None and c.recheck.any():
                        return False
        return True

    # -- lane building -------------------------------------------------------

    def _resident_args(self, mesh, ndev: int, sig, build_host_args):
        """Device-resident sharded input lanes, cached per (referenced
        column versions, predicates, plan signature) in the tcache aux
        space.  First use shards the host lanes over the mesh with the
        step's NamedSharding (one upload); later queries over unchanged
        tables pass the resident arrays straight into the jitted step —
        zero H2D."""
        from .devcache import TCACHE
        from jax.sharding import NamedSharding, PartitionSpec as P
        pm = self.perfmon
        cols = []
        for e in (list(getattr(self, "probe_keys", []))
                  + list(getattr(self, "build_keys", []))
                  + list(self.group_exprs)
                  + [a for i_ in self.aggs for a in i_.args]
                  + [p for p in (getattr(self, "probe_pred", None),
                                 getattr(self, "build_pred", None),
                                 getattr(self, "pred", None))
                     if p is not None]):
            from ..expr.ir import referenced_columns
            for nm in referenced_columns(e):
                for t in (getattr(self, "probe", None),
                          getattr(self, "build", None),
                          getattr(self, "table", None)):
                    if t is not None and nm in t.columns:
                        cols.append(t.columns[nm])
                        break
        ids: tuple = tuple(sorted({c.uid for c in cols}))
        if not ids:
            # count(*)-style plans reference no columns — key on the
            # involved tables' own column uids + nrows so two tables
            # never share resident lanes (round-5 fuzzer find, the same
            # collision devcache.chunks_for had)
            ident = []
            for t in (getattr(self, "probe", None),
                      getattr(self, "build", None),
                      getattr(self, "table", None)):
                if t is not None:
                    ident.append((t.nrows,) + tuple(
                        c.uid for c in t.columns.values()))
            ids = ("norows", tuple(ident))
        key = ("dist_args", type(self).__name__, ids,
               # the full expr set, not just the referenced columns: two
               # queries can reference the same columns in different lane
               # roles (sum(a),count(b) vs sum(b),count(a)) with identical
               # type signatures
               tuple(repr(k) for k in getattr(self, "probe_keys", [])),
               tuple(repr(k) for k in getattr(self, "build_keys", [])),
               tuple(repr(g) for g in self.group_exprs),
               tuple(repr(a) for i_ in self.aggs for a in i_.args),
               repr(getattr(self, "probe_pred", None)),
               repr(getattr(self, "build_pred", None)),
               repr(getattr(self, "pred", None)), sig, ndev,
               tuple(mesh.axis_names))
        cached = TCACHE.get_aux(key, pm)
        if cached is not None:
            pm.bump("dist_resident_hits")
            return cached
        host_args = build_host_args()
        # rows shard over every mesh axis jointly (flat or hosts x chips)
        axes = tuple(mesh.axis_names)
        shard = NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0]))
        args = tuple(jax.device_put(a, shard) for a in host_args)
        pm.add_bytes("h2d", sum(a.nbytes for a in host_args))
        owner = (getattr(self, "probe", None) or self.table).name
        TCACHE.put_aux(key, args, owner, cols)
        return args

    def _filtered_rows(self, table: Table, pred) -> np.ndarray:
        from .scan_exec import ScanExecutor
        if pred is None:
            return np.arange(table.nrows, dtype=np.int64)
        # the planner hands per-rel quals scope-bound (index=-1); bind to
        # THIS table's layout before lowering — an unbound ColumnRef's -1
        # silently indexed the LAST column's planes (round-5 fuzzer find:
        # wrong-column filters / numeric-plane crashes on the dist path).
        # Rebinding an already layout-bound pred is idempotent.
        from ..expr.ir import bind_columns
        try:
            pred = bind_columns(
                pred, {n: i for i, n in enumerate(table.column_names)})
        except KeyError as e:
            # a qual scoped to the wrong rel must fall back to the
            # single-device plan, not crash the query (review finding)
            raise DistFallback(f"filter binds outside {table.name}: {e}")
        return np.asarray(
            ScanExecutor(table, pred, self.perfmon).row_indexes(),
            dtype=np.int64)

    def _jkey_lane(self, table: Table, k: ColumnRef, ii: np.ndarray):
        c = table.columns[k.name]
        valid = c.valid[ii]
        if k.type is T.FLOAT8:
            enc = _f64_orderkey_np(c.data[ii].astype(np.float64))
        elif k.type is T.FLOAT4:
            enc = _f64_orderkey_np(c.data[ii].astype(np.float64))
        else:
            enc = c.data[ii].astype(np.int64)
        return np.where(valid, enc, np.int64(0)), valid

    def _expr_lane(self, table: Table, sp: LaneSpec, e: Expr,
                   ii: np.ndarray):
        """Wire lane for a group/arg EXPRESSION (round-3 item 9): plain
        ColumnRefs read the column planes; computed expressions pre-project
        once per column version through the single-device lowering (cached
        in the tcache aux space) and the projected lane ships like a
        column."""
        if isinstance(e, ColumnRef):
            return self._value_lane(table, sp, e.name, ii)
        from .devcache import TCACHE
        key = ("dist_expr_lane",
               tuple(c.uid for c in table.columns.values()), repr(e))
        proj = TCACHE.get_aux(key, self.perfmon)
        if proj is None:
            import jax
            from ..expr.ir import bind_columns
            from ..expr.lower_jax import (build_project_fn,
                                          schema_from_chunk_columns,
                                          planes_of_column)
            names = table.column_names
            cols = [table.columns[n] for n in names]
            schema = schema_from_chunk_columns(names, cols)
            be = bind_columns(e, {n: i for i, n in enumerate(names)})
            fn = jax.jit(build_project_fn([be], schema))
            planes = tuple(planes_of_column(c) for c in cols)
            outs, _mask, err = jax.device_get(
                fn(planes, np.int32(table.nrows)))
            if int(np.max(np.asarray(err))) != 0:
                raise DistFallback("expr lane needs host recheck")
            proj = (np.asarray(outs[0][0]), np.asarray(outs[0][1]))
            TCACHE.put_aux(key, proj, table.name, cols)
        data_full, valid_full = proj
        valid = valid_full[ii].astype(bool)
        if sp.role == "gkey" and sp.t in (T.FLOAT4, T.FLOAT8):
            data = _f64_orderkey_np(data_full[ii].astype(np.float64))
        elif sp.t is T.FLOAT4 and sp.role != "gkey":
            data = data_full[ii].astype(np.float32)
        elif sp.t is T.FLOAT8 and sp.role != "gkey":
            data = np.ascontiguousarray(
                data_full[ii].astype(np.float64)).view(np.int64)
        else:
            data = data_full[ii].astype(np.int64)
        return np.where(valid, data, data.dtype.type(0)), valid

    def _value_lane(self, table: Table, sp: LaneSpec, name: str,
                    ii: np.ndarray):
        c = table.columns[name]
        valid = c.valid[ii].astype(bool)
        if sp.role == "arg_exp":
            return c.num_exp[ii].astype(np.int64), valid
        if sp.role == "arg_dscale":
            return c.num_dscale[ii].astype(np.int64), valid
        if sp.role == "gkey":
            if sp.t in (T.FLOAT4, T.FLOAT8):
                data = _f64_orderkey_np(c.data[ii].astype(np.float64))
            else:
                data = c.data[ii].astype(np.int64)
        elif sp.t is T.FLOAT4:
            data = c.data[ii].astype(np.float32)
        elif sp.t is T.FLOAT8:
            data = np.ascontiguousarray(
                c.data[ii].astype(np.float64)).view(np.int64)
        else:
            data = c.data[ii].astype(np.int64)
        return np.where(valid, data, data.dtype.type(0)), valid

    # -- run -----------------------------------------------------------------

    def run(self) -> list[tuple]:
        if not self.eligible():
            raise DistFallback("not eligible")
        pm = self.perfmon
        ndev = len(jax.devices())
        mesh = mesh_for_config(ndev)

        # signature
        gspecs = []
        gmeta = []                       # (type, dictionary|None) per gkey
        for g in self.group_exprs:
            side = self._expr_side(g)
            tbl = self.probe if side == "probe" else self.build
            gspecs.append(LaneSpec(side=side, t=g.type, role="gkey"))
            gmeta.append((g.type,
                          tbl.columns[g.name].dictionary
                          if isinstance(g, ColumnRef) else None))
        agg_sigs = []
        for inst in self.aggs:
            specs = tuple(
                sp for a in inst.args
                for sp in _arg_specs(self._expr_side(a), a.type))
            agg_sigs.append((specs, tuple(inst.slots)))
        sig = DistPlanSig(n_probe_jkeys=len(self.probe_keys),
                          n_build_jkeys=len(self.build_keys),
                          gkeys=tuple(gspecs), aggs=tuple(agg_sigs),
                          ungrouped=not self.group_exprs)

        # side filters through the single-chip scan tier
        with pm.timer("dist_prepare"):
            pii = self._filtered_rows(self.probe, self.probe_pred)
            bii = self._filtered_rows(self.build, self.build_pred)
            if pii.size == 0 or bii.size == 0:
                raise DistFallback("empty filtered side")

            pjk = [self._jkey_lane(self.probe, k, pii)
                   for k in self.probe_keys]
            bjk = [self._jkey_lane(self.build, k, bii)
                   for k in self.build_keys]
            # inner equi-join: NULL keys never match — dead rows
            pvalid = np.ones(pii.size, bool)
            for _, v in pjk:
                pvalid &= v
            bvalid = np.ones(bii.size, bool)
            for _, v in bjk:
                bvalid &= v

            plv, plvv, blv, blvv = [], [], [], []
            for gi, g in enumerate(self.group_exprs):
                sp = gspecs[gi]
                tbl, ii = ((self.probe, pii) if sp.side == "probe"
                           else (self.build, bii))
                d, v = self._expr_lane(tbl, sp, g, ii)
                (plv if sp.side == "probe" else blv).append(d)
                (plvv if sp.side == "probe" else blvv).append(v)
            for inst, (specs, _k) in zip(self.aggs, agg_sigs):
                for a, sp in zip(_args_for_specs(inst, specs), specs):
                    tbl, ii = ((self.probe, pii) if sp.side == "probe"
                               else (self.build, bii))
                    d, v = self._expr_lane(tbl, sp, a, ii)
                    (plv if sp.side == "probe" else blv).append(d)
                    (plvv if sp.side == "probe" else blvv).append(v)

        # device-resident sharded lanes (round 3): the prepared lanes are a
        # pure function of (referenced column versions, predicates, plan
        # signature), so shard them over the mesh ONCE with the step's
        # NamedSharding and reuse across queries via the tcache aux space —
        # a repeated distributed query re-ships ZERO bytes to the devices
        # (the devcache lesson applied to the mesh)
        args = self._resident_args(
            mesh, ndev, sig,
            lambda: (
                [pad_shards(d, ndev) for d, _v in pjk]
                + [pad_shards(pvalid, ndev, fill=False)]
                + [pad_shards(d, ndev) for d in plv]
                + [pad_shards(v, ndev, fill=False) for v in plvv]
                + [pad_shards(d, ndev) for d, _v in bjk]
                + [pad_shards(bvalid, ndev, fill=False)]
                + [pad_shards(d, ndev) for d in blv]
                + [pad_shards(v, ndev, fill=False) for v in blvv]))

        # skew-aware repartitioning (SURVEY §5; round-4 verdict Missing
        # #1): sample the probe side's combined key hash for heavy
        # hitters; when found, the step spreads heavy probe rows over all
        # devices and broadcasts the matching build rows (exact either
        # way — see build_dist_join_agg_step).  Without it, one hot key
        # overloads a single device and the capacity ladder doubles
        # EVERYTHING until the query silently de-distributes.
        k_heavy = 0
        heavy_cap = 64
        heavy_np = None
        if config.dist_skew_routing:
            from ..parallel.dist import host_combine_hash
            from ..parallel.shuffle import detect_heavy_keys, \
                _HEAVY_SENTINEL
            ph64 = host_combine_hash([d for d, _v in pjk])
            cand = detect_heavy_keys(ph64, pvalid, k_heavy=8)
            nh = int((cand != _HEAVY_SENTINEL).sum())
            if nh:
                bh64 = host_combine_hash([d for d, _v in bjk])
                hb = int((np.isin(bh64, cand[:nh]) & bvalid).sum())
                # per-device compact cap for the broadcast buffer; bail
                # to plain hash routing when the BUILD side itself is so
                # heavy that replication would blow device memory
                cap = _next_pow2(max(hb, 16))
                if cap * ndev <= (1 << 22):
                    k_heavy, heavy_cap, heavy_np = 8, cap, cand
                    pm.bump("dist_skew_routed")

        # capacity ladder: double everything on any overflow flag
        n_p, n_b = pii.size, bii.size
        bcap = _next_pow2(max(2 * n_p, 2 * n_b) // (ndev * ndev) + 1)
        nbuckets = _next_pow2(max(ndev * bcap, 64))
        mchain = 8
        G = _next_pow2(config.dist_group_slots, lo=64)
        distinct_idxs = tuple(i for i, i_ in enumerate(self.aggs)
                              if i_.distinct)
        dcap = _next_pow2(max(2 * (n_p + n_b) // max(ndev, 1), 64))
        for attempt in range(4):
            # mesh axes in the key: a 1D flat mesh and a 2D hosts x
            # chips mesh compile DIFFERENT collectives for the same
            # query sig (round-3 verdict Weak #3 — toggling
            # pg_strom.dist_mesh_hosts silently reused the old step)
            key = (sig, ndev, tuple(mesh.axis_names),
                   tuple(mesh.devices.shape), bcap, nbuckets, mchain, G,
                   k_heavy, heavy_cap, distinct_idxs, dcap)
            step = self._STEP_CACHE.get(key)
            if step is None:
                step = build_dist_join_agg_step(
                    mesh, sig, bucket_cap=bcap, nbuckets=nbuckets,
                    max_chain=mchain, G=G, k_heavy=k_heavy,
                    heavy_cap=heavy_cap, distinct_idxs=distinct_idxs,
                    dedup_cap=dcap)
                self._STEP_CACHE[key] = step
            with pm.timer("dispatch"):
                out = step(*args, heavy_np) if k_heavy else step(*args)
            with pm.timer("device_wait"):
                out = jax.device_get(out)
            gk_out, gkv_out, gvalid, slots, err, ovf = out[:6]
            extraB = out[6:]
            if np.any(np.asarray(err)):
                pm.bump("dist_recheck")
                raise DistFallback("device err lane (CpuReCheck)")
            if not np.any(np.asarray(ovf)):
                break
            pm.bump("dist_repartitions")
            bcap *= 2
            nbuckets *= 2
            mchain *= 2
            G *= 2
            dcap *= 2
        else:
            raise DistFallback("capacity ladder exhausted")
        pm.bump("dist_steps")

        # ---- host merge of per-device partials --------------------------
        with pm.timer("materialize"):
            states, displays = _merge_distinct_aware(
                gk_out, gkv_out, gvalid, slots, extraB, gmeta,
                self.group_exprs, self.aggs, distinct_idxs, pm)
        from .preagg_exec import finalize_agg_states
        return finalize_agg_states(self.group_exprs, self.aggs, states,
                                   displays)

    @staticmethod
    def _decode_gkey(meta, raw, valid: bool):
        return _decode_gkey(meta, raw, valid)


def _decode_gkey(meta, raw, valid: bool):
    t, dictionary = meta
    if not valid:
        return None
    raw = int(raw)
    if t in (T.TEXT, T.BPCHAR):
        return dictionary[raw] if dictionary else None
    if t in (T.FLOAT4, T.FLOAT8):
        return _unflip_orderkey(raw)
    if t is T.BOOL:
        return bool(raw)
    return raw


def _merge_device_partials(gk_out, gkv_out, gvalid, slots, gmeta,
                           group_exprs, aggs, states=None, displays=None,
                           only_idx=None, skip_idx=None):
    """Fold per-device group partial arrays into (states, displays) via
    the engine's merge_partials — groups appearing on several devices (or
    twice on one, after a hash collision) merge exactly.

    only_idx / skip_idx (an index or a set of indexes) support the
    distinct multi-phase merge: an agg outside the selection contributes
    a NEUTRAL (new_state) partial, so phase-A buckets never pollute the
    distinct aggs and phase-B buckets never pollute the others."""
    from .hostexec import new_state
    if skip_idx is None:
        skip_idx = set()
    elif not isinstance(skip_idx, (set, frozenset)):
        skip_idx = {skip_idx}
    states = {} if states is None else states
    displays = {} if displays is None else displays
    gvalid = np.asarray(gvalid)
    gk_out = [np.asarray(a) for a in gk_out]
    gkv_out = [np.asarray(a) for a in gkv_out]
    slots = [{k: np.asarray(v) for k, v in d.items()} for d in slots]
    for s in np.flatnonzero(gvalid):
        s = int(s)
        kvals = tuple(_decode_gkey(gmeta[i], gk_out[i][s],
                                   bool(gkv_out[i][s]))
                      for i in range(len(group_exprs)))
        ck = tuple(canon_group_key(v) for v in kvals)
        parts = [new_state(inst)
                 if (i in skip_idx
                     or (only_idx is not None and i != only_idx))
                 else extract_partials(inst, d, s)
                 for i, (inst, d) in enumerate(zip(aggs, slots))]
        if ck not in states:
            states[ck] = parts
            displays[ck] = kvals
        else:
            st = states[ck]
            states[ck] = [merge_partials(inst, a, b)
                          for inst, a, b in zip(aggs, st, parts)]
    return states, displays


class DistPreAggExecutor:
    """Single-table GROUP BY over the device mesh: rows shard across
    devices, each computes partials for its rows (pure data parallelism —
    no collective), host merge folds the overlapping groups.  The engine
    analog of SURVEY §2's multi-device scheduling row at mesh scale."""

    _STEP_CACHE: dict = {}

    def __init__(self, table: Table, group_exprs: Sequence[Expr],
                 aggs: Sequence[AggInstance], pred: Optional[Expr] = None,
                 perfmon: Perfmon | None = None):
        self.table = table
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.pred = pred
        self.perfmon = perfmon or Perfmon()

    def eligible(self) -> bool:
        if not config.enabled or self.table.nrows == 0:
            return False
        # device-assisted DISTINCT (round 4): a query carrying an eligible
        # agg(DISTINCT x) routes through this step even WITHOUT
        # pg_strom.distributed — the alternative is the host row loop, and
        # the dedup-exchange runs fine on a 1+-device local mesh.  The
        # reference always punts DISTINCT to the CPU aggregate.
        has_distinct = any(i_.distinct for i_ in self.aggs)
        if config.distributed and len(jax.devices()) >= 2:
            pass
        elif not (has_distinct and config.device_distinct
                  and len(jax.devices()) >= 1):
            return False
        from ..expr.catalog import device_expression_supported
        for g in self.group_exprs:
            if g.type not in GROUP_KEY_OK:
                return False
            if not isinstance(g, ColumnRef) and (
                    g.type in (T.TEXT, T.BPCHAR, T.NUMERIC)
                    or not device_expression_supported(g)):
                return False
        for inst in self.aggs:
            if inst.distinct and not _distinct_agg_distributable(inst):
                return False
            if any(kind not in DIST_SLOT_KINDS for kind in inst.slots):
                return False
            for a in inst.args:
                if a.type not in AGG_ARG_OK:
                    return False
                if not isinstance(a, ColumnRef):
                    if (a.type is T.NUMERIC
                            or not device_expression_supported(a)):
                        return False
                elif a.type is T.NUMERIC:
                    c = self.table.columns.get(a.name)
                    if (c is None or c.recheck is not None
                            and c.recheck.any()):
                        return False
        return True

    def run(self) -> list[tuple]:
        if not self.eligible():
            raise DistFallback("not eligible")
        pm = self.perfmon
        ndev = len(jax.devices())
        mesh = mesh_for_config(ndev)
        helper = DistJoinAggExecutor(self.table, self.table, [], [],
                                     self.group_exprs, self.aggs,
                                     probe_pred=self.pred, perfmon=pm)

        gspecs, gmeta = [], []
        for g in self.group_exprs:
            gspecs.append(LaneSpec(side="probe", t=g.type, role="gkey"))
            gmeta.append((g.type,
                          self.table.columns[g.name].dictionary
                          if isinstance(g, ColumnRef) else None))
        agg_sigs = [(tuple(sp for a in inst.args
                           for sp in _arg_specs("probe", a.type)),
                     tuple(inst.slots))
                    for inst in self.aggs]
        sig = DistPlanSig(n_probe_jkeys=0, n_build_jkeys=0,
                          gkeys=tuple(gspecs), aggs=tuple(agg_sigs),
                          ungrouped=not self.group_exprs)

        with pm.timer("dist_prepare"):
            ii = helper._filtered_rows(self.table, self.pred)
            if ii.size == 0:
                # zero matching rows: finalize handles the empty/ungrouped
                # case exactly on the host
                raise DistFallback("empty filtered input")
            valid = np.ones(ii.size, bool)
            lanes, lvalids = [], []
            for gi, g in enumerate(self.group_exprs):
                d, v = helper._expr_lane(self.table, gspecs[gi], g, ii)
                lanes.append(d)
                lvalids.append(v)
            for inst, (specs, _k) in zip(self.aggs, agg_sigs):
                for a, sp in zip(_args_for_specs(inst, specs), specs):
                    d, v = helper._expr_lane(self.table, sp, a, ii)
                    lanes.append(d)
                    lvalids.append(v)

        from ..parallel.dist import build_dist_preagg_step
        # resident sharded lanes, reused across queries (see
        # DistJoinAggExecutor._resident_args)
        args = helper._resident_args(
            mesh, ndev, sig,
            lambda: ([pad_shards(valid, ndev, fill=False)]
                     + [pad_shards(d, ndev) for d in lanes]
                     + [pad_shards(v, ndev, fill=False) for v in lvalids]))
        distinct_idxs = tuple(i for i, i_ in enumerate(self.aggs)
                              if i_.distinct)
        # dedup exchange capacity: a (src, dst) bucket can never exceed
        # the source shard's rows, so this cap is overflow-free
        n_shard = -(-ii.size // ndev)
        dcap = _next_pow2(max(n_shard, 64))
        G = _next_pow2(config.dist_group_slots, lo=64)
        for attempt in range(4):
            key = (sig, ndev, tuple(mesh.axis_names),
                   tuple(mesh.devices.shape), G, distinct_idxs, dcap)
            step = self._STEP_CACHE.get(key)
            if step is None:
                step = build_dist_preagg_step(mesh, sig, G=G,
                                              distinct_idxs=distinct_idxs,
                                              dedup_cap=dcap)
                self._STEP_CACHE[key] = step
            with pm.timer("dispatch"):
                out = step(*args)
            with pm.timer("device_wait"):
                out = jax.device_get(out)
            gk_out, gkv_out, gvalid, slots, err, ovf = out[:6]
            extraB = out[6:]
            if np.any(np.asarray(err)):
                pm.bump("dist_recheck")
                raise DistFallback("device err lane (CpuReCheck)")
            if not np.any(np.asarray(ovf)):
                break
            pm.bump("dist_repartitions")
            G *= 2
        else:
            raise DistFallback("group-slot ladder exhausted")
        pm.bump("dist_steps")
        with pm.timer("materialize"):
            states, displays = _merge_distinct_aware(
                gk_out, gkv_out, gvalid, slots, extraB, gmeta,
                self.group_exprs, self.aggs, distinct_idxs, pm)
        from .preagg_exec import finalize_agg_states
        return finalize_agg_states(self.group_exprs, self.aggs, states,
                                   displays)
