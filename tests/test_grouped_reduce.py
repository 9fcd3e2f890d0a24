"""The two grouped-reduction formulations of ops/preagg_mxu.mxu_reduce —
the int64 segment sum and the bf16 one-hot dot with f32 accumulation —
against each other and against the host-exact tier.

Runs the SAME build_preagg_fn program under each route and compares the
host-absorbed semantics: recovered group keys, collision and overflow
flags, and every extracted partial (exactly like the executor, through
mxu_absorb).  Where neither route flags, the finalized rows must also
match the host tier (PreAggExecutor with offload=False).

Reference parity: the regression corpus this guards is the gpupreagg
aggregate suite (expected/group_agg.out etc.)."""

from __future__ import annotations

import numpy as np
import pytest

import jax

from pg_strom_tpu import T, backend
from pg_strom_tpu.datastore import Table, column_from_numpy
from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function
from pg_strom_tpu.expr.lower_jax import ColMeta
from pg_strom_tpu.ops.preagg import (AggInstance, lookup_agg,
                                     build_preagg_fn, extract_partials,
                                     merge_partials)
from pg_strom_tpu.ops.preagg_mxu import mxu_absorb
from pg_strom_tpu.exec.hostexec import canon_group_key
from pg_strom_tpu.exec.preagg_exec import PreAggExecutor, finalize_agg_states

N = 512
G = 64


def _insts(specs):
    out = []
    for aggname, arg in specs:
        args = arg if isinstance(arg, tuple) else (arg,)
        d, fam = lookup_agg(aggname, tuple(a.type for a in args))
        out.append(AggInstance(aggname=aggname, family=fam,
                               slots=d.slots, args=args))
    return out


def _absorb(out, group_exprs, insts, key_metas=None):
    states, displays = {}, {}
    collided, overflow = mxu_absorb(
        out, group_exprs, insts, key_metas or [None] * len(group_exprs),
        states, displays, merge_partials, extract_partials, canon_group_key)
    return collided, overflow, states, displays


def _run_both(schema, group_exprs, insts, pred, cols, salt=0):
    """(segment_sum output, onehot_dot output) of the same program."""
    args = (cols, np.int32(N), np.uint64(salt))
    outs = []
    for route in backend.GROUPED_REDUCE_ROUTES:
        fn = build_preagg_fn(schema, group_exprs, insts, pred, G,
                             strategy="mxu", reduce_route=route)
        outs.append(jax.device_get(fn(*args)))
    return tuple(outs)


def _host_rows(schema, group_exprs, insts, pred, cols):
    t = Table.from_columns("t", {
        m.name: column_from_numpy(m.type, np.asarray(d), np.asarray(v))
        for m, (d, v) in zip(schema, cols)})
    return PreAggExecutor(t, pred, group_exprs, insts, offload=False).run()


def _assert_rows_match(got, host, ngroup):
    key = lambda r: tuple((v is None, v) for v in r[:ngroup])  # noqa
    got, host = sorted(got, key=key), sorted(host, key=key)
    assert len(got) == len(host)
    for rg, rh in zip(got, host):
        for vg, vh in zip(rg, rh):
            if isinstance(vh, float) and isinstance(vg, float) and vg != vh:
                # PG sums float4 stepwise in f32; the device sum is exact
                # and rounded once — equal at extra_float_digits=-3
                assert vg == pytest.approx(vh, rel=1e-5, abs=1e-30), (vg, vh)
            else:
                assert vg == vh, (vg, vh)


def _assert_semantic_equal(out_f, out_x, group_exprs, insts, key_metas=None,
                           host=None):
    cf, of_, sf, df = _absorb(out_f, group_exprs, insts, key_metas)
    cx, ox, sx, dx = _absorb(out_x, group_exprs, insts, key_metas)
    assert (cf, of_) == (cx, ox), f"flags seg={cf},{of_} dot={cx},{ox}"
    if cf or of_:
        return
    assert sorted(map(repr, sf)) == sorted(map(repr, sx))
    for k in sf:
        for pf, px in zip(sf[k], sx[k]):
            assert set(pf) == set(px), (k, set(pf), set(px))
            for kk in pf:
                a, b = pf[kk], px[kk]
                if isinstance(a, float):
                    assert a == pytest.approx(b, rel=1e-12, abs=1e-300), \
                        (k, kk, a, b)
                else:
                    assert a == b, (k, kk, a, b)
    if host is not None:
        got = finalize_agg_states(group_exprs, insts, sf, df)
        _assert_rows_match(got, host, len(group_exprs))


def _check(schema, group_exprs, insts, pred, cols):
    out_f, out_x = _run_both(schema, group_exprs, insts, pred, cols)
    host = _host_rows(schema, group_exprs, insts, pred, cols)
    _assert_semantic_equal(out_f, out_x, group_exprs, insts, host=host)


def _cols(*pairs):
    return tuple((jax.device_put(np.asarray(d)),
                  jax.device_put(np.asarray(v, np.bool_))) for d, v in pairs)


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)


def _keys_int4(rng, nkeys=5):
    return (rng.integers(0, nkeys, N) * 11 - 17).astype(np.int32)


def test_flagship_mix():
    rng = np.random.default_rng(1)
    schema = [ColMeta("k", T.INT4), ColMeta("x", T.FLOAT4),
              ColMeta("y", T.INT8)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    y = ColumnRef(type=T.INT8, name="y", index=2)
    pred = resolve_function(">", (x, Const(type=T.FLOAT4, value=0.0)))
    insts = _insts([("sum", x), ("count", x), ("sum", y), ("max", y)])
    cols = _cols(
        (_keys_int4(rng), np.ones(N, np.bool_)),
        ((rng.random(N).astype(np.float32) - 0.4) * 100, rng.random(N) > 0.1),
        (rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
         rng.random(N) > 0.1),
    )
    _check(schema, [k], insts, pred, cols)


def test_int_sum_sumsq_families():
    """stddev/var over int2/int4 exercise sum_i + sumsq_i lanes."""
    rng = np.random.default_rng(2)
    schema = [ColMeta("k", T.INT4), ColMeta("a", T.INT2),
              ColMeta("b", T.INT4)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    a = ColumnRef(type=T.INT2, name="a", index=1)
    b = ColumnRef(type=T.INT4, name="b", index=2)
    insts = _insts([("stddev", a), ("variance", b), ("sum", a), ("avg", b)])
    cols = _cols(
        (_keys_int4(rng, 4), np.ones(N, np.bool_)),
        (rng.integers(-32768, 32767, N).astype(np.int16),
         rng.random(N) > 0.2),
        (rng.integers(-(1 << 31), (1 << 31) - 1, N).astype(np.int32),
         rng.random(N) > 0.2),
    )
    _check(schema, [k], insts, None, cols)


def test_multi_key_types():
    """bool + int2 + date keys: three C-S blocks in one kernel."""
    rng = np.random.default_rng(3)
    schema = [ColMeta("kb", T.BOOL), ColMeta("ks", T.INT2),
              ColMeta("kd", T.DATE), ColMeta("x", T.FLOAT4)]
    kb = ColumnRef(type=T.BOOL, name="kb", index=0)
    ks = ColumnRef(type=T.INT2, name="ks", index=1)
    kd = ColumnRef(type=T.DATE, name="kd", index=2)
    x = ColumnRef(type=T.FLOAT4, name="x", index=3)
    insts = _insts([("sum", x), ("count", x)])
    cols = _cols(
        (rng.integers(0, 2, N).astype(np.bool_), np.ones(N, np.bool_)),
        ((rng.integers(0, 3, N) * 9 - 5).astype(np.int16),
         rng.random(N) > 0.1),
        ((rng.integers(0, 2, N) + 7000).astype(np.int32),
         np.ones(N, np.bool_)),
        (rng.random(N).astype(np.float32), rng.random(N) > 0.1),
    )
    _check(schema, [kb, ks, kd], insts, None, cols)


def test_all_null_group_and_extremes():
    rng = np.random.default_rng(4)
    schema = [ColMeta("k", T.INT4), ColMeta("y", T.INT8)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    y = ColumnRef(type=T.INT8, name="y", index=1)
    insts = _insts([("sum", y), ("count", y)])
    yv = rng.integers(-(1 << 55), 1 << 55, N).astype(np.int64)
    yv[:8] = [np.iinfo(np.int64).max // 2, np.iinfo(np.int64).min // 2,
              0, -1, 1, 255, -256, 1 << 40]
    keys = _keys_int4(rng, 3)
    valid = rng.random(N) > 0.3
    valid[keys == keys.min()] = False          # one group entirely NULL
    cols = _cols((keys, np.ones(N, np.bool_)), (yv, valid))
    _check(schema, [k], insts, None, cols)


def test_sum_i_overflow_flags_match():
    """values whose |v| mass exceeds 2^61 must raise overflow both ways."""
    rng = np.random.default_rng(5)
    schema = [ColMeta("k", T.INT4), ColMeta("y", T.INT8)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    y = ColumnRef(type=T.INT8, name="y", index=1)
    insts = _insts([("sum", y)])
    yv = np.full(N, (1 << 61) // 16, np.int64)
    cols = _cols((np.zeros(N, np.int32), np.ones(N, np.bool_)),
                 (yv, np.ones(N, np.bool_)))
    out_f, out_x = _run_both(schema, [k], insts, None, cols)
    cf, of_, _, _ = _absorb(out_f, [k], insts)
    cx, ox, _, _ = _absorb(out_x, [k], insts)
    assert of_ and ox


def test_collision_flag_matches():
    """more distinct keys than buckets: both paths must flag collision."""
    rng = np.random.default_rng(6)
    schema = [ColMeta("k", T.INT4), ColMeta("x", T.FLOAT4)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    insts = _insts([("sum", x)])
    cols = _cols((np.arange(N, dtype=np.int32), np.ones(N, np.bool_)),
                 (rng.random(N).astype(np.float32), np.ones(N, np.bool_)))
    out_f, out_x = _run_both(schema, [k], insts, None, cols)
    cf, *_ = _absorb(out_f, [k], insts)
    cx, *_ = _absorb(out_x, [k], insts)
    assert cf and cx


def test_route_default_and_unknown_route():
    """The CPU takes the segment sum at every bucket count; mxu_reduce
    refuses an unknown route rather than guessing."""
    from pg_strom_tpu.ops.preagg_mxu import mxu_reduce
    assert all(backend.grouped_reduce_route(G) == "segment_sum"
               for G in (8, 128, 4096))
    V = jax.numpy.ones((4, 2), jax.numpy.bfloat16)
    seg = jax.numpy.zeros(4, jax.numpy.int32)
    with pytest.raises(ValueError, match="route"):
        mxu_reduce(V, seg, 2, 4, route="scatter")


@pytest.fixture()
def _f64_blocks(monkeypatch):
    """f64 double-float blocks are the GPU's route in production; force
    them on the CPU backend so the head/tail lanes are exercised here."""
    from pg_strom_tpu.ops import preagg_mxu
    monkeypatch.setattr(preagg_mxu, "F64_BLOCKS_ON_CPU", True)
    yield


def test_f64_families(_f64_blocks):
    """float8 sum + stddev: head/tail signed-digit pairs, both routes."""
    rng = np.random.default_rng(41)
    schema = [ColMeta("k", T.INT4), ColMeta("x", T.FLOAT8),
              ColMeta("y", T.FLOAT8)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    x = ColumnRef(type=T.FLOAT8, name="x", index=1)
    y = ColumnRef(type=T.FLOAT8, name="y", index=2)
    insts = _insts([("sum", x), ("stddev", x)])
    cols = _cols(
        (_keys_int4(rng, 4), np.ones(N, np.bool_)),
        ((rng.random(N) - 0.5) * 1e9, rng.random(N) > 0.1),
        ((rng.random(N) - 0.5) * 1e3, rng.random(N) > 0.1),
    )
    _check(schema, [k], insts, None, cols)


def test_f64_corr(_f64_blocks):
    """corr(x, y): five f64 blocks — the widest limb matrix (114 columns)."""
    rng = np.random.default_rng(42)
    schema = [ColMeta("k", T.INT4), ColMeta("x", T.FLOAT8),
              ColMeta("y", T.FLOAT8)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    x = ColumnRef(type=T.FLOAT8, name="x", index=1)
    y = ColumnRef(type=T.FLOAT8, name="y", index=2)
    insts = _insts([("corr", (x, y))])
    cols = _cols(
        (_keys_int4(rng, 4), np.ones(N, np.bool_)),
        ((rng.random(N) - 0.5) * 100, rng.random(N) > 0.1),
        ((rng.random(N) - 0.5) * 100, rng.random(N) > 0.1),
    )
    _check(schema, [k], insts, None, cols)


def test_f4_stddev(_f64_blocks):
    """stddev(float4): sumsq_f f64 block alongside the f4 signed block."""
    rng = np.random.default_rng(43)
    schema = [ColMeta("k", T.INT4), ColMeta("x", T.FLOAT4)]
    k = ColumnRef(type=T.INT4, name="k", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    insts = _insts([("stddev", x), ("sum", x)])
    cols = _cols(
        (_keys_int4(rng, 4), np.ones(N, np.bool_)),
        ((rng.random(N).astype(np.float32) - 0.5) * 1e4,
         rng.random(N) > 0.1),
    )
    _check(schema, [k], insts, None, cols)


def test_wide_int8_key():
    """64-bit group key: two-word limb blocks, both routes."""
    rng = np.random.default_rng(31)
    schema = [ColMeta("k", T.INT8), ColMeta("x", T.FLOAT4)]
    k = ColumnRef(type=T.INT8, name="k", index=0)
    x = ColumnRef(type=T.FLOAT4, name="x", index=1)
    base = np.asarray([0, -1, (1 << 62), -(1 << 62), 123456789012345678,
                       (1 << 33) + 7], dtype=np.int64)
    insts = _insts([("sum", x), ("count", x)])
    cols = _cols(
        (base[rng.integers(0, len(base), N)], rng.random(N) > 0.05),
        ((rng.random(N).astype(np.float32) - 0.4) * 10, rng.random(N) > 0.1),
    )
    _check(schema, [k], insts, None, cols)


def test_wide_timestamp_key():
    rng = np.random.default_rng(32)
    schema = [ColMeta("k", T.TIMESTAMP), ColMeta("y", T.INT8)]
    k = ColumnRef(type=T.TIMESTAMP, name="k", index=0)
    y = ColumnRef(type=T.INT8, name="y", index=1)
    base = (np.asarray([150, 700, 820, 123], dtype=np.int64)
            * 86400_000_000 * 30)
    insts = _insts([("sum", y), ("count", y)])
    cols = _cols(
        (base[rng.integers(0, len(base), N)], np.ones(N, np.bool_)),
        (rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
         rng.random(N) > 0.1),
    )
    _check(schema, [k], insts, None, cols)
