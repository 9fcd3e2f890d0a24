"""Limb-matrix grouped-aggregation primitives: exactness vs numpy.

Covers the full round trip: recipe walk -> device column build -> segmented
bf16 matmul reduce -> host big-int extraction, plus the key-recovery /
collision contract (Cauchy-Schwarz equality check) and overflow shadows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pg_strom_tpu.sqltypes import T
from pg_strom_tpu.expr.lower_jax import DVal
from pg_strom_tpu.ops.preagg import AggInstance
from pg_strom_tpu.ops.preagg_mxu import (
    SEG_ROWS, build_mxu_columns, mxu_reduce, mxu_recipes, mxu_host_groups,
    mxu_overflow, mxu_extract_slot, mxu_keys_supported, mxu_shadow_cols,
)


def _dval(t, data, valid):
    return DVal(t, jnp.asarray(data), jnp.asarray(valid))


def _run(key_vals, key_types, aggs, arg_vals, arg_types, seg_id, G, n):
    keyr, slotr, ncols = mxu_recipes(key_types, aggs, arg_types)
    mask = jnp.ones(n, dtype=jnp.bool_)

    def f():
        V, exps = build_mxu_columns(key_vals, aggs, arg_vals, mask, n)
        # the bf16 one-hot dot formulation (the CPU would otherwise take
        # the segment sum) — these tests prove its exactness claims
        sums, fsums = mxu_reduce(V, jnp.asarray(seg_id), G, n,
                                 route="onehot_dot",
                                 fsum_cols=mxu_shadow_cols(slotr))
        return {"mxu_sums": sums, "mxu_fsums": fsums, "mxu_f4exps": exps}

    out = jax.jit(f)()
    out = {k: np.asarray(v) for k, v in out.items()}
    assert out["mxu_sums"].shape == (G, ncols)
    return keyr, slotr, out


class TestMxuPrimitives:
    def test_count_sum_exact(self):
        rng = np.random.default_rng(3)
        n, G = 4096, 16
        seg = rng.integers(0, G, n).astype(np.int32)
        vi = rng.integers(-10**9, 10**9, n).astype(np.int32)
        vokay = rng.random(n) > 0.15
        a = _dval(T.INT4, vi, vokay)
        inst = AggInstance("sum", "i4", ("count", "sum_i"), (None,))
        keyr, slotr, out = _run([], [], [inst], [[a]], [(T.INT4,)], seg, G, n)
        assert not mxu_overflow(out, slotr)
        for g in range(G):
            m = mxu_extract_slot(slotr[0]["count"], out, g)
            assert m["count"] == int(np.sum((seg == g) & vokay))
            s = mxu_extract_slot(slotr[0]["sum_i"], out, g)
            want = int(np.sum(vi[(seg == g) & vokay], dtype=object))
            assert s["sum_i"] == want

    def test_sum_i_modular_window(self):
        # big int8 values: true sum fits int64 -> exact
        n, G = 512, 4
        rng = np.random.default_rng(5)
        seg = rng.integers(0, G, n).astype(np.int32)
        vi = rng.integers(-(1 << 52), 1 << 52, n).astype(np.int64)
        a = _dval(T.INT8, vi, np.ones(n, np.bool_))
        inst = AggInstance("sum", "i8", ("count", "sum_i"), (None,))
        keyr, slotr, out = _run([], [], [inst], [[a]], [(T.INT8,)], seg, G, n)
        assert not mxu_overflow(out, slotr)
        for g in range(G):
            s = mxu_extract_slot(slotr[0]["sum_i"], out, g)["sum_i"]
            assert s == int(np.sum(vi[seg == g], dtype=object))

    def test_sum_i_overflow_shadow_flags(self):
        n, G = 256, 2
        seg = np.zeros(n, np.int32)
        vi = np.full(n, (1 << 62) // 16, dtype=np.int64)  # sum >> 2^61
        a = _dval(T.INT8, vi, np.ones(n, np.bool_))
        inst = AggInstance("sum", "i8", ("count", "sum_i"), (None,))
        _, slotr, out = _run([], [], [inst], [[a]], [(T.INT8,)], seg, G, n)
        assert mxu_overflow(out, slotr)

    def test_sumsq_int_exact(self):
        rng = np.random.default_rng(11)
        n, G = 2048, 8
        seg = rng.integers(0, G, n).astype(np.int32)
        vi = rng.integers(-32768, 32768, n).astype(np.int16)
        a = _dval(T.INT2, vi, np.ones(n, np.bool_))
        inst = AggInstance("stddev", "i2", ("count", "sum_i", "sumsq_i"),
                           (None,))
        _, slotr, out = _run([], [], [inst], [[a]], [(T.INT2,)], seg, G, n)
        for g in range(G):
            q = mxu_extract_slot(slotr[0]["sumsq_i"], out, g)["sumsq_i"]
            want = int(np.sum(vi[seg == g].astype(object) ** 2))
            assert q == want

    def test_sum_f4_fixed_point_window(self):
        rng = np.random.default_rng(7)
        n, G = 8192, 8
        seg = rng.integers(0, G, n).astype(np.int32)
        vf = ((rng.random(n) - 0.5) * 1e6).astype(np.float32)
        ok = rng.random(n) > 0.1
        a = _dval(T.FLOAT4, vf, ok)
        inst = AggInstance("sum", "f4", ("count", "sum_f"), (None,))
        _, slotr, out = _run([], [], [inst], [[a]], [(T.FLOAT4,)], seg, G, n)
        assert not mxu_overflow(out, slotr)
        for g in range(G):
            s = mxu_extract_slot(slotr[0]["sum_f"], out, g)["sum_f"]
            want = float(np.sum(vf[(seg == g) & ok].astype(np.float64)))
            # 72-bit window below chunk max: error way below f64 epsilon-mass
            assert s == pytest.approx(want, abs=max(1e-6, abs(want) * 1e-12))

    def test_key_recovery_and_collision(self):
        rng = np.random.default_rng(13)
        n, G = 4096, 64
        keys = rng.integers(-20, 20, n).astype(np.int32)
        kvalid = rng.random(n) > 0.05
        # perfect bucketing: one key value per bucket (NULLs to their own)
        uniq = {}
        seg = np.empty(n, np.int32)
        for i in range(n):
            kk = int(keys[i]) if kvalid[i] else None
            seg[i] = uniq.setdefault(kk, len(uniq) % G)
        kd = _dval(T.INT4, keys, kvalid)
        inst = AggInstance("count", "star", ("nrows",), ())
        assert mxu_keys_supported([T.INT4])
        keyr, slotr, out = _run([kd], [T.INT4], [inst], [[]], [()], seg, G, n)
        collision, groups = mxu_host_groups(out, keyr, [None])
        assert not collision
        got = {}
        for g, kv in groups:
            got[g] = kv[0]
        for kk, g in uniq.items():
            assert got[g] == kk

        # force two distinct keys into one bucket -> collision MUST trip
        seg2 = np.zeros(n, np.int32)
        keyr, slotr, out = _run([kd], [T.INT4], [inst], [[]], [()], seg2,
                                G, n)
        collision, _ = mxu_host_groups(out, keyr, [None])
        assert collision

    def test_multi_segment_reduce(self):
        # n a multiple of SEG_ROWS exercises the batched-segment path
        n, G = 2 * SEG_ROWS, 32
        rng = np.random.default_rng(17)
        seg = rng.integers(0, G, n).astype(np.int32)
        vi = rng.integers(-1000, 1000, n).astype(np.int32)
        a = _dval(T.INT4, vi, np.ones(n, np.bool_))
        inst = AggInstance("sum", "i4", ("count", "sum_i"), (None,))
        _, slotr, out = _run([], [], [inst], [[a]], [(T.INT4,)], seg, G, n)
        for g in range(0, G, 7):
            s = mxu_extract_slot(slotr[0]["sum_i"], out, g)["sum_i"]
            assert s == int(np.sum(vi[seg == g], dtype=object))

    def test_sum_f8_double_float(self):
        rng = np.random.default_rng(23)
        n, G = 4096, 8
        seg = rng.integers(0, G, n).astype(np.int32)
        vf = (rng.random(n) - 0.5) * 1e9          # full f64 values
        ok = rng.random(n) > 0.1
        a = _dval(T.FLOAT8, vf, ok)
        inst = AggInstance("sum", "f8", ("count", "sum_f"), (None,))
        _, slotr, out = _run([], [], [inst], [[a]], [(T.FLOAT8,)], seg, G, n)
        assert not mxu_overflow(out, slotr)
        for g in range(G):
            s = mxu_extract_slot(slotr[0]["sum_f"], out, g)["sum_f"]
            want = float(np.sum(vf[(seg == g) & ok]))
            assert s == pytest.approx(want, rel=1e-12)

    def test_pair_agg_covariance_slots(self):
        rng = np.random.default_rng(29)
        n, G = 2048, 4
        seg = rng.integers(0, G, n).astype(np.int32)
        x = (rng.random(n) - 0.5) * 100.0
        y = (rng.random(n) - 0.3) * 50.0
        ok = rng.random(n) > 0.05
        ax = _dval(T.FLOAT8, x, ok)
        ay = _dval(T.FLOAT8, y, ok)
        slots = ("count", "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y")
        inst = AggInstance("covar_pop", "f8f8", slots, (None, None))
        _, slotr, out = _run([], [], [inst], [[ax, ay]],
                             [(T.FLOAT8, T.FLOAT8)], seg, G, n)
        assert not mxu_overflow(out, slotr)
        for g in range(G):
            m = (seg == g) & ok
            got = {}
            for kind in slots[1:]:
                got.update(mxu_extract_slot(slotr[0][kind], out, g))
            assert got["sum_x"] == pytest.approx(float(np.sum(x[m])), rel=1e-12)
            assert got["sum_xy"] == pytest.approx(float(np.sum(x[m] * y[m])),
                                                  rel=1e-12)
            assert got["sumsq_y"] == pytest.approx(float(np.sum(y[m] ** 2)),
                                                   rel=1e-12)

    def test_f8_inf_flags_overflow(self):
        n, G = 256, 2
        seg = np.zeros(n, np.int32)
        vf = np.full(n, 1e308)
        a = _dval(T.FLOAT8, vf, np.ones(n, np.bool_))
        inst = AggInstance("sum", "f8", ("count", "sum_f"), (None,))
        _, slotr, out = _run([], [], [inst], [[a]], [(T.FLOAT8,)], seg, G, n)
        assert mxu_overflow(out, slotr)     # f32 head is inf -> host replay


@pytest.fixture(autouse=True)
def _enable_f64_blocks(monkeypatch):
    """f64 double-float blocks are the GPU's route in production (the CPU
    keeps the f64 segment sums); these unit tests exercise them here."""
    from pg_strom_tpu.ops import preagg_mxu
    monkeypatch.setattr(preagg_mxu, "F64_BLOCKS_ON_CPU", True)
    yield


class TestWideKeys:
    """64-bit group keys (int8/time/timestamp) ride as two 32-bit word
    blocks: per-word Cauchy-Schwarz constancy + host word reassembly."""

    def _roundtrip(self, t, keys, kvalid, n=4096, G=64):
        uniq = {}
        seg = np.empty(n, np.int32)
        for i in range(n):
            kk = int(keys[i]) if kvalid[i] else None
            seg[i] = uniq.setdefault(kk, len(uniq) % G)
        kd = _dval(t, keys, kvalid)
        inst = AggInstance("count", "star", ("nrows",), ())
        assert mxu_keys_supported([t])
        keyr, slotr, out = _run([kd], [t], [inst], [[]], [()], seg, G, n)
        collision, groups = mxu_host_groups(out, keyr, [None])
        assert not collision
        got = {g: kv[0] for g, kv in groups}
        for kk, g in uniq.items():
            assert got[g] == kk, (t, kk, got[g])

    def test_int8_large_magnitudes(self):
        rng = np.random.default_rng(23)
        base = np.asarray([0, -1, 1, (1 << 62), -(1 << 62),
                           123456789012345678, -42, (1 << 33) + 7],
                          dtype=np.int64)
        keys = base[rng.integers(0, len(base), 4096)]
        kvalid = rng.random(4096) > 0.05
        self._roundtrip(T.INT8, keys, kvalid)

    def test_timestamp_keys(self):
        rng = np.random.default_rng(24)
        # microseconds since 2000-01-01: ~2004-2026 range
        base = (np.asarray([150, 700, 820, 123, 456], dtype=np.int64)
                * 86400_000_000 * 30)
        keys = base[rng.integers(0, len(base), 4096)]
        self._roundtrip(T.TIMESTAMP, keys, np.ones(4096, dtype=bool))

    def test_wide_key_collision_trips(self):
        # same lo word, different hi word in one bucket -> must collide
        n = 256
        keys = np.where(np.arange(n) % 2 == 0,
                        np.int64(5), np.int64(5 + (1 << 40)))
        kd = _dval(T.INT8, keys, np.ones(n, dtype=bool))
        inst = AggInstance("count", "star", ("nrows",), ())
        keyr, slotr, out = _run([kd], [T.INT8], [inst], [[]], [()],
                                np.zeros(n, np.int32), 16, n)
        collision, _ = mxu_host_groups(out, keyr, [None])
        assert collision

    def test_wide_key_same_hi_diff_lo_collision(self):
        n = 256
        keys = np.where(np.arange(n) % 2 == 0,
                        np.int64((1 << 40) + 1), np.int64((1 << 40) + 2))
        kd = _dval(T.INT8, keys, np.ones(n, dtype=bool))
        inst = AggInstance("count", "star", ("nrows",), ())
        keyr, slotr, out = _run([kd], [T.INT8], [inst], [[]], [()],
                                np.zeros(n, np.int32), 16, n)
        collision, _ = mxu_host_groups(out, keyr, [None])
        assert collision
