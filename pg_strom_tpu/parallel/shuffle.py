"""SPMD shuffle hash-join + grouped aggregation over a device mesh.

Dataflow of one distributed step (everything inside one jitted shard_map —
XLA schedules the all_to_alls and overlaps them with local compute):

  per device: local probe shard, local build shard
    1. partition: bucket rows by hash(key) mod ndev (sort + searchsorted,
       the same sorted-bucket machinery as the local hash join)
    2. exchange:  lax.all_to_all both sides -> every key now lives on
       exactly one device
    3. local join: sorted-bucket build + bounded-chain probe (ops/hashjoin
       algorithm, re-instantiated on the received shards)
    4. local partial aggregate: segment reductions by group key
    5. re-aggregate: second (tiny) all_to_all shuffling group partials by
       hash(group) so each group's total lands on one device

Fixed-capacity partition buckets keep shapes static; overflowing a bucket
sets the per-device `ovf` flag (the executor repartitions with a larger
factor — the distributed analog of the DataStoreNoSpace regrow).  Key skew
beyond bucket capacity is detected the same way.

This layer works on pre-projected key/payload lanes (int64 keys — any SQL
key type reduces to canonical int64 bits via the hashing/orderkey machinery).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import get_mesh  # noqa: F401  (re-export convenience)


def _mix64(x):
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def _partition_lanes(lanes: tuple, key: jnp.ndarray, valid: jnp.ndarray,
                     ndev: int, bucket_cap: int, part=None):
    """Sort local rows into ndev fixed-capacity buckets by hash(key)%ndev
    (or by a caller-supplied partition lane — the skew router uses this).

    Returns (bucketed lanes each [ndev, bucket_cap], counts [ndev], ovf)."""
    n = key.shape[0]
    if part is None:
        part = (_mix64(key) % jnp.uint64(ndev)).astype(jnp.int32)
    part = jnp.where(valid, part, jnp.int32(ndev))     # dead rows to the end
    from ..ops.sort import argsort_i32
    order = argsort_i32(part, n, vbits=max(ndev + 1, 2).bit_length())
    psorted = part[order]
    edges = jnp.arange(ndev + 1, dtype=jnp.int32)
    starts = jnp.searchsorted(psorted, edges, side="left").astype(jnp.int32)
    counts = starts[1:] - starts[:-1]
    ovf = jnp.any(counts > bucket_cap)
    # position within bucket
    pos_in_bucket = jnp.arange(n, dtype=jnp.int32) - starts[jnp.clip(psorted, 0, ndev - 1)]
    dest = jnp.where((psorted < ndev) & (pos_in_bucket < bucket_cap),
                     psorted * bucket_cap + pos_in_bucket,
                     ndev * bucket_cap)
    out = []
    for lane in lanes:
        src = lane[order]
        buf = jnp.zeros(ndev * bucket_cap, dtype=lane.dtype).at[dest].set(
            src, mode="drop")
        out.append(buf.reshape(ndev, bucket_cap))
    vb = jnp.zeros(ndev * bucket_cap, dtype=jnp.bool_).at[dest].set(
        valid[order], mode="drop").reshape(ndev, bucket_cap)
    return tuple(out), vb, counts, ovf


def _local_hash_join(pkey, pval, pvalid, bkey, bpay, bvalid, nbuckets: int,
                     max_chain: int):
    """Sorted-bucket join on local shards.  Returns per-probe-row first-match
    fan-out lanes: (matched mask [n, max_chain], build payload [n, max_chain])
    flattened — join output = all (probe, build) matched pairs."""
    nb = bkey.shape[0]
    bucket = (_mix64(bkey) % jnp.uint64(nbuckets)).astype(jnp.int32)
    bucket = jnp.where(bvalid, bucket, jnp.int32(nbuckets))
    from ..ops.sort import argsort_i32
    order = argsort_i32(bucket, nb, vbits=nbuckets.bit_length() + 1)
    bsorted = bucket[order]
    bkey_s = bkey[order]
    bpay_s = bpay[order]
    edges = jnp.arange(nbuckets + 1, dtype=jnp.int32)
    starts = jnp.searchsorted(bsorted, edges, side="left").astype(jnp.int32)

    pb = (_mix64(pkey) % jnp.uint64(nbuckets)).astype(jnp.int32)
    pb = jnp.where(pvalid, pb, jnp.int32(nbuckets - 1))
    s = starts[pb]
    e = starts[pb + 1]
    blen = jnp.where(pvalid, e - s, 0)
    ovf = jnp.any(blen > max_chain)

    ms, pays = [], []
    for k in range(max_chain):
        j = jnp.clip(s + k, 0, max(nb - 1, 0))
        m = pvalid & (k < blen) & (pkey == bkey_s[j])
        ms.append(m)
        pays.append(bpay_s[j])
    matched = jnp.stack(ms, axis=1)        # [n, max_chain]
    paym = jnp.stack(pays, axis=1)
    return matched, paym, ovf


def _local_group_partials(gkey, vals, valid, G: int):
    """Segment partial aggregation by key into G slots: ONE sort per call
    carries any number of value lanes (count + each lane's sum).

    Returns (keys[G], kvalid[G], count[G] int64-exact, [sum[G] per value
    lane], ovf).  `vals` may be a single lane or a list/tuple of lanes.
    The count is an exact int64 segment sum (never re-aggregated through
    floats — counts past 2^53 must stay exact)."""
    single = not isinstance(vals, (list, tuple))
    vlanes = [vals] if single else list(vals)
    n = gkey.shape[0]
    hk = _mix64(gkey).astype(jnp.int64) & ((1 << 62) - 1)
    hk = jnp.where(valid, hk, jnp.int64(1 << 62))
    from ..ops.sort import packed_argsort, _chunks_from_unsigned
    order = packed_argsort(_chunks_from_unsigned(hk, 63), n)
    ks = gkey[order]
    ok = valid[order]
    same = jnp.concatenate([jnp.zeros(1, dtype=jnp.bool_),
                            (ks[1:] == ks[:-1]) & ok[1:] & ok[:-1]])
    new_seg = ok & ~same
    seg = jnp.clip(jnp.cumsum(new_seg.astype(jnp.int32)) - 1, 0, G - 1)
    ngroups = jnp.sum(new_seg.astype(jnp.int32))
    ovf = ngroups > G
    cnt = jax.ops.segment_sum(ok.astype(jnp.int64), seg, num_segments=G)
    sums = []
    for v in vlanes:
        vsorted = v[order]
        zero = jnp.zeros((), dtype=v.dtype)
        sums.append(jax.ops.segment_sum(jnp.where(ok, vsorted, zero), seg,
                                        num_segments=G))
    pos = jnp.where(new_seg, jnp.arange(n, dtype=jnp.int64), jnp.int64(1 << 62))
    first = jnp.clip(jax.ops.segment_min(pos, seg, num_segments=G),
                     0, max(n - 1, 0)).astype(jnp.int32)
    gkeys = ks[first]
    gvalid = jnp.arange(G, dtype=jnp.int32) < ngroups
    if single:
        return gkeys, gvalid, cnt, sums[0], ovf
    return gkeys, gvalid, cnt, sums, ovf


_HEAVY_SENTINEL = -(1 << 63)


def detect_heavy_keys(keys, valid, k_heavy: int,
                      sample_rows: int | None = None,
                      threshold: float | None = None) -> np.ndarray:
    """Host-side heavy-hitter detection (skew sampling).

    Samples up to `sample_rows` valid keys and returns the <= k_heavy keys
    whose sample frequency exceeds `threshold`, padded with _HEAVY_SENTINEL
    to a fixed int64[k_heavy].  Misclassification in either direction is
    correctness-preserving — heaviness only changes ROUTING (spread+broadcast
    vs hash partition), never join/agg semantics — so sampling error is a
    pure performance matter.  Defaults come from config
    (skew_sample_rows / skew_heavy_threshold)."""
    from ..config import config
    if sample_rows is None:
        sample_rows = config.skew_sample_rows
    if threshold is None:
        threshold = config.skew_heavy_threshold
    keys = np.asarray(keys)
    valid = np.asarray(valid, dtype=bool)
    kv = keys[valid]
    out = np.full(k_heavy, _HEAVY_SENTINEL, dtype=np.int64)
    if k_heavy == 0 or kv.size == 0:
        return out
    if kv.size > sample_rows:
        step = kv.size // sample_rows
        kv = kv[::step][:sample_rows]
    uniq, cnt = np.unique(kv, return_counts=True)
    frac = cnt / kv.size
    order = np.argsort(-cnt)
    picked = [int(uniq[i]) for i in order[:k_heavy] if frac[i] > threshold]
    out[:len(picked)] = picked
    return out


def build_shuffle_join_agg_step(mesh: Mesh, axis: str = "dp",
                                bucket_cap: int = 1024,
                                nbuckets: int = 4096,
                                max_chain: int = 8,
                                G: int = 512,
                                k_heavy: int = 0,
                                heavy_cap: int | None = None) -> Callable:
    """Jitted distributed step over `mesh`:

      f(probe_key[Np], probe_val[Np], probe_valid[Np],
        build_key[Nb], build_pay[Nb], build_valid[Nb][, heavy_keys[k_heavy]])
        -> (group_keys [ndev*G], group_valid, count, sum, ovf)

    Inputs are sharded on their leading axis; outputs are the per-device
    disjoint group partials after the re-aggregation shuffle (each group's
    total lives on exactly one device).

    Skew-aware repartitioning (k_heavy > 0): rows whose key is in
    `heavy_keys` (from detect_heavy_keys, replicated) bypass hash
    partitioning — probe rows are spread round-robin over all devices and
    the matching build rows are broadcast (all_gather) to every device, so
    one hot key no longer funnels its whole row mass onto a single device.
    Exactness is unaffected: the second-phase partial re-aggregation already
    merges per-device partials of the same group."""
    ndev = mesh.shape[axis]
    if heavy_cap is None:
        heavy_cap = bucket_cap

    def step(pkey, pval, pvalid, bkey, bpay, bvalid, *rest):
        # ---- phase 0: skew routing lanes ---------------------------------
        hovf = jnp.bool_(False)
        bvalid_hash = bvalid
        ppart = None
        if k_heavy:
            heavy = rest[0]
            p_heavy = jnp.zeros_like(pvalid)
            b_heavy = jnp.zeros_like(bvalid)
            for j in range(k_heavy):
                p_heavy = p_heavy | (pkey == heavy[j])
                b_heavy = b_heavy | (bkey == heavy[j])
            p_heavy = p_heavy & pvalid
            b_heavy = b_heavy & bvalid
            # probe: heavy rows spread round-robin across devices
            base = (_mix64(pkey) % jnp.uint64(ndev)).astype(jnp.int32)
            rr = (jnp.cumsum(p_heavy.astype(jnp.int32)) - 1) % ndev
            ppart = jnp.where(p_heavy, rr, base)
            # build: heavy rows leave the hash path, get broadcast below
            bvalid_hash = bvalid & ~b_heavy
            (hbk_b, hbp_b), hbv_b, _, hovf = _partition_lanes(
                (bkey, bpay), bkey, b_heavy, 1, heavy_cap)
            hbk_g = jax.lax.all_gather(hbk_b[0], axis)     # [ndev, heavy_cap]
            hbp_g = jax.lax.all_gather(hbp_b[0], axis)
            hbv_g = jax.lax.all_gather(hbv_b[0], axis)

        # ---- phase 1+2: partition and exchange both sides over the mesh ------
        (pk_b, pv_b), pvalid_b, _, povf = _partition_lanes(
            (pkey, pval), pkey, pvalid, ndev, bucket_cap, part=ppart)
        (bk_b, bp_b), bvalid_b, _, bovf = _partition_lanes(
            (bkey, bpay), bkey, bvalid_hash, ndev, bucket_cap)
        pk_x = jax.lax.all_to_all(pk_b, axis, 0, 0, tiled=False)
        pv_x = jax.lax.all_to_all(pv_b, axis, 0, 0, tiled=False)
        pva_x = jax.lax.all_to_all(pvalid_b, axis, 0, 0, tiled=False)
        bk_x = jax.lax.all_to_all(bk_b, axis, 0, 0, tiled=False)
        bp_x = jax.lax.all_to_all(bp_b, axis, 0, 0, tiled=False)
        bva_x = jax.lax.all_to_all(bvalid_b, axis, 0, 0, tiled=False)
        pk_l = pk_x.reshape(-1)
        pv_l = pv_x.reshape(-1)
        pva_l = pva_x.reshape(-1)
        bk_l = bk_x.reshape(-1)
        bp_l = bp_x.reshape(-1)
        bva_l = bva_x.reshape(-1)
        if k_heavy:
            # local build side = hash-received rows + broadcast heavy rows
            bk_l = jnp.concatenate([bk_l, hbk_g.reshape(-1)])
            bp_l = jnp.concatenate([bp_l, hbp_g.reshape(-1)])
            bva_l = jnp.concatenate([bva_l, hbv_g.reshape(-1)])

        # ---- phase 3: local join ----------------------------------------
        matched, pay_m, jovf = _local_hash_join(
            pk_l, pv_l, pva_l, bk_l, bp_l, bva_l, nbuckets, max_chain)
        # join output lanes: probe val + build payload per matched pair
        n, mc = matched.shape
        jkey = jnp.broadcast_to(pk_l[:, None], (n, mc)).reshape(-1)
        # aggregate value uses both sides (sum of probe_val * build_payload)
        jval = (jnp.broadcast_to(pv_l[:, None], (n, mc)) *
                pay_m.astype(jnp.float64)).reshape(-1)
        jvalid = matched.reshape(-1)

        # ---- phase 4: local partial aggregate by join key ----------------
        gk, gv, cnt, sm, govf = _local_group_partials(jkey, jval, jvalid, G)

        # ---- phase 5: re-aggregate partials across devices ---------------
        # shuffle group partials by hash(group key) so totals are exact;
        # ONE sort carries both value lanes, and the count lane re-sums in
        # exact int64 (no float64 detour)
        (gk_b, cnt_b, sm_b), gvb, _, rovf = _partition_lanes(
            (gk, cnt, sm), gk, gv, ndev, G)
        gk_x = jax.lax.all_to_all(gk_b, axis, 0, 0).reshape(-1)
        cnt_x = jax.lax.all_to_all(cnt_b, axis, 0, 0).reshape(-1)
        sm_x = jax.lax.all_to_all(sm_b, axis, 0, 0).reshape(-1)
        gv_x = jax.lax.all_to_all(gvb, axis, 0, 0).reshape(-1)
        fk, fv, _fn, (fsum_cnt, fsum_val), fovf = _local_group_partials(
            gk_x, [cnt_x, sm_x], gv_x, G)

        ovf = povf | bovf | jovf | govf | rovf | fovf | hovf
        return fk, fv, fsum_cnt, fsum_val, ovf.reshape(1)

    specs = P(axis)
    in_specs = (specs,) * 6 + ((P(),) if k_heavy else ())
    f = shard_map(step, mesh=mesh,
                  in_specs=in_specs,
                  out_specs=(specs, specs, specs, specs, P(axis)))
    return jax.jit(f)


def pad_shards(arr: np.ndarray, ndev: int, fill=0) -> np.ndarray:
    """Pad the leading axis to a multiple of ndev (shard_map requirement)."""
    n = arr.shape[0]
    m = (-n) % ndev
    if m == 0:
        return arr
    pad = np.full((m,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def run_shuffle_join_agg(step, ndev: int, pkey, pval, pvalid,
                         bkey, bpay, bvalid):
    """Pad inputs to ndev multiples (padding rows valid=False) and run."""
    return step(pad_shards(np.asarray(pkey), ndev),
                pad_shards(np.asarray(pval, dtype=np.float64), ndev),
                pad_shards(np.asarray(pvalid, dtype=bool), ndev, fill=False),
                pad_shards(np.asarray(bkey), ndev),
                pad_shards(np.asarray(bpay), ndev),
                pad_shards(np.asarray(bvalid, dtype=bool), ndev, fill=False))


def host_merge_group_partials(fk, fv, fcnt, fsum):
    """Collect the per-device disjoint partials into {key: (count, sum)}."""
    fk = np.asarray(fk)
    fv = np.asarray(fv)
    fcnt = np.asarray(fcnt)
    fsum = np.asarray(fsum)
    out: dict[int, tuple[int, float]] = {}
    for k, v, c, s in zip(fk, fv, fcnt, fsum):
        if not v or c == 0:
            continue
        kk = int(k)
        if kk in out:  # only if a group straddled devices (shouldn't happen)
            c0, s0 = out[kk]
            out[kk] = (c0 + int(c), s0 + float(s))
        else:
            out[kk] = (int(c), float(s))
    return out
