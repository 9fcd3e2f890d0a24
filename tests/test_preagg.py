"""Aggregation regression suite: device path vs host-exact path.

The port of the reference's {nogrp,where,group,zero}_agg corpus (SURVEY §4):
every aggregate x every numeric type, with no grouping / WHERE filter /
GROUP BY / zero rows.  The host path (config.enabled=False) plays the role
vanilla PostgreSQL plays for make_expected.sh; the device path must produce
text-identical rows under PG formatting rules with extra_float_digits=-3.
"""

import pytest

import pg_strom_tpu  # noqa: F401
from pg_strom_tpu import T, override
from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function, bind_columns
from pg_strom_tpu.ops.preagg import AggInstance, lookup_agg
from pg_strom_tpu.exec.preagg_exec import PreAggExecutor
from pg_strom_tpu.models.fixtures import (
    make_preagg_test, make_preagg_zero, make_preagg_overflow,
)
from pg_strom_tpu.utils.pgformat import row_out
from pg_strom_tpu.expr.ir import explicit_cast

AGG_NAMES = ["avg", "count", "max", "min", "sum", "stddev", "stddev_pop",
             "stddev_samp", "variance", "var_pop", "var_samp"]
PAIR_AGGS = ["corr", "covar_pop", "covar_samp"]
TYPE_COLS = [("smlint_x", T.INT2), ("integer_x", T.INT4), ("bigint_x", T.INT8),
             ("real_x", T.FLOAT4), ("float_x", T.FLOAT8), ("nume_x", T.NUMERIC)]


@pytest.fixture(scope="module")
def tbl():
    return make_preagg_test(nrows=2000)


@pytest.fixture(scope="module")
def tbl_zero():
    return make_preagg_zero()


@pytest.fixture(scope="module")
def tbl_overflow():
    return make_preagg_overflow(nrows=800)


def make_agg(table, aggname, colname, coltype):
    layout = {n: i for i, n in enumerate(table.column_names)}
    if aggname in PAIR_AGGS:
        arg = bind_columns(explicit_cast(
            ColumnRef(type=coltype, name=colname), T.FLOAT8), layout)
        d, fam = lookup_agg(aggname, (T.FLOAT8, T.FLOAT8))
        return AggInstance(aggname=aggname, family=fam, slots=d.slots,
                           args=(arg, arg)), d.rettype
    arg = bind_columns(ColumnRef(type=coltype, name=colname), layout)
    d, fam = lookup_agg(aggname, (coltype,))
    return AggInstance(aggname=aggname, family=fam, slots=d.slots,
                       args=(arg,)), d.rettype


def run_query(table, aggname, colname, coltype, pred=None, group=False,
              device=True):
    from pg_strom_tpu.errors import SqlError
    layout = {n: i for i, n in enumerate(table.column_names)}
    inst, ret = make_agg(table, aggname, colname, coltype)
    gexprs = []
    ktypes = []
    if group:
        gexprs = [bind_columns(ColumnRef(type=T.INT4, name="key"), layout)]
        ktypes = [T.INT4]
    p = bind_columns(pred, layout) if pred is not None else None
    try:
        with override(enabled=device, chunk_rows=512, max_groups_device=64):
            rows = PreAggExecutor(table, p, gexprs, [inst]).run()
    except SqlError as e:
        # both paths must raise the same PostgreSQL error (overflow corpus)
        return [f"ERROR: {e.message}"]
    # deterministic order: sort by key (None last)
    rows.sort(key=lambda r: (tuple((v is None, v) for v in r[:len(gexprs)])))
    types = tuple(ktypes) + (ret,)
    return [row_out(r, types, extra_float_digits=-3) for r in rows]


def _rows_equivalent(got: list[str], want: list[str]) -> bool:
    """Formatted-row compare; float fields tolerate last-digit drift.

    Parallel float aggregation is order-independent while PostgreSQL's is
    stepwise; under catastrophic cancellation the 12-digit rendering can
    flip its final digit even though |device - host| is ~1e-12 (the device
    fixed-point sum is the MORE accurate one).  pg_regress absorbs this via
    extra_float_digits; a string compare at a rounding boundary cannot."""
    import math
    if got == want:
        return True
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g == w:
            continue
        gf, wf = g.split("|"), w.split("|")
        if len(gf) != len(wf):
            return False
        for a, b in zip(gf, wf):
            if a == b:
                continue
            try:
                if not math.isclose(float(a), float(b),
                                    rel_tol=1e-9, abs_tol=1e-9):
                    return False
            except ValueError:
                return False
    return True


def assert_match(table, aggname, colname, coltype, pred=None, group=False):
    got = run_query(table, aggname, colname, coltype, pred, group, device=True)
    want = run_query(table, aggname, colname, coltype, pred, group, device=False)
    assert _rows_equivalent(got, want), (
        f"{aggname}({colname}) group={group}:\n"
        f"device: {got[:5]}\nhost  : {want[:5]}")


@pytest.mark.parametrize("colname,coltype", TYPE_COLS,
                         ids=[c for c, _ in TYPE_COLS])
@pytest.mark.parametrize("aggname", AGG_NAMES + PAIR_AGGS)
class TestNogrpAgg:
    def test_nogrp(self, aggname, colname, coltype, tbl):
        assert_match(tbl, aggname, colname, coltype)


@pytest.mark.parametrize("colname,coltype", TYPE_COLS,
                         ids=[c for c, _ in TYPE_COLS])
@pytest.mark.parametrize("aggname", AGG_NAMES)
class TestGroupAgg:
    def test_group(self, aggname, colname, coltype, tbl):
        assert_match(tbl, aggname, colname, coltype, group=True)


@pytest.mark.parametrize("colname,coltype", TYPE_COLS[:3] + TYPE_COLS[5:],
                         ids=[c for c, _ in TYPE_COLS[:3] + TYPE_COLS[5:]])
@pytest.mark.parametrize("aggname", ["avg", "sum", "stddev", "max", "min"])
class TestWhereAgg:
    def test_where(self, aggname, colname, coltype, tbl):
        pred = resolve_function(
            "=", (ColumnRef(type=T.INT4, name="key"), Const(type=T.INT4, value=1)))
        assert_match(tbl, aggname, colname, coltype, pred=pred, group=True)


@pytest.mark.parametrize("colname,coltype", TYPE_COLS,
                         ids=[c for c, _ in TYPE_COLS])
@pytest.mark.parametrize("aggname", AGG_NAMES + PAIR_AGGS)
class TestZeroAgg:
    def test_zero(self, aggname, colname, coltype, tbl_zero):
        got = run_query(tbl_zero, aggname, colname, coltype, device=True)
        want = run_query(tbl_zero, aggname, colname, coltype, device=False)
        assert got == want
        assert len(got) == 1  # one all-NULL row for ungrouped agg

    def test_zero_grouped_empty(self, aggname, colname, coltype, tbl_zero):
        got = run_query(tbl_zero, aggname, colname, coltype, group=True,
                        device=True)
        assert got == []


@pytest.mark.parametrize("colname,coltype",
                         [("bigint_x", T.INT8), ("nume_x", T.NUMERIC),
                          ("float_x", T.FLOAT8), ("real_x", T.FLOAT4)])
@pytest.mark.parametrize("aggname", ["sum", "avg", "max", "min", "count"])
class TestOverflowAgg:
    """Extreme magnitudes: int64-max sums, 1e308 float8 (beyond the
    f32-exponent window of the device's f64 sums), 21-digit numerics — must still match host exactly
    via the CpuReCheck tier."""

    def test_overflow_group(self, aggname, colname, coltype, tbl_overflow):
        assert_match(tbl_overflow, aggname, colname, coltype, group=True)


class TestGroupKeyEdgeCases:
    def test_null_key_groups_together(self, tbl):
        got = run_query(tbl, "count", "id", T.INT4, group=True, device=True)
        want = run_query(tbl, "count", "id", T.INT4, group=True, device=False)
        assert got == want
        # 30 int keys + the NULL-key group
        assert len(got) == 31

    def test_many_groups_overflow_device_slots(self, tbl):
        # group by id: 2000 groups > max_groups_device=64 -> recheck tier
        layout = {n: i for i, n in enumerate(tbl.column_names)}
        inst, ret = make_agg(tbl, "sum", "integer_x", T.INT4)
        g = bind_columns(ColumnRef(type=T.INT4, name="id"), layout)
        with override(enabled=True, chunk_rows=512, max_groups_device=64):
            rows_dev = PreAggExecutor(tbl, None, [g], [inst]).run()
        with override(enabled=False):
            rows_host = PreAggExecutor(tbl, None, [g], [inst]).run()
        assert sorted(map(repr, rows_dev)) == sorted(map(repr, rows_host))


class TestDenseBucketing:
    """Single narrow int keys whose chunk range fits G use dense range
    buckets (ops/preagg._bucket_ids): collision-free, so the salt/escalation
    retry ladder never fires; wide ranges fall back to salted hashing."""

    def _run(self, keys, vals, G=64):
        import numpy as np
        from pg_strom_tpu import Table, column_from_values
        from pg_strom_tpu.utils.perfmon import Perfmon
        table = Table.from_columns("t", {
            "key": column_from_values(T.INT4, keys),
            "x": column_from_values(T.FLOAT8, vals),
        })
        layout = {n: i for i, n in enumerate(table.column_names)}
        arg = bind_columns(ColumnRef(type=T.FLOAT8, name="x"), layout)
        d, fam = lookup_agg("sum", (T.FLOAT8,))
        inst = AggInstance(aggname="sum", family=fam, slots=d.slots,
                           args=(arg,))
        g = bind_columns(ColumnRef(type=T.INT4, name="key"), layout)
        pm = Perfmon()
        with override(max_groups_device=G):
            rows = PreAggExecutor(table, None, [g], [inst],
                                  perfmon=pm).run()
        got = {r[0]: r[1] for r in rows}
        want = {}
        for k, v in zip(keys, vals):
            want[k] = want.get(k, 0.0) + v
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < 1e-9 * max(1.0, abs(want[k]))
        return pm

    def test_dense_keys_zero_retries(self):
        # 50 distinct keys into 64 buckets: hashing would collide w.h.p.
        # (birthday ~1-exp(-50*49/128) ~ 1.0); dense bucketing never does
        import numpy as np
        rng = np.random.default_rng(9)
        keys = [int(v) for v in rng.integers(100, 150, 4000)]
        vals = [float(v) for v in rng.random(4000)]
        pm = self._run(keys, vals, G=64)
        assert pm.counts.get("salt_retries", 0) == 0
        assert pm.counts.get("device_chunks", 0) >= 1

    def test_dense_null_key_group(self):
        keys = [1, 2, None, 2, None, 3, 1]
        vals = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]
        pm = self._run(keys, vals, G=64)
        assert pm.counts.get("salt_retries", 0) == 0

    def test_wide_range_falls_back_exact(self):
        # range >> G: dense ineligible; hash path (retries allowed) stays exact
        import numpy as np
        rng = np.random.default_rng(10)
        keys = [int(v) * 100003 for v in rng.integers(0, 30, 2000)]
        vals = [float(v) for v in rng.random(2000)]
        self._run(keys, vals, G=64)

    def test_negative_keys_dense(self):
        keys = [-5, -3, -5, 0, 7, -3, 7]
        vals = [1.0] * 7
        pm = self._run(keys, vals, G=16)
        assert pm.counts.get("salt_retries", 0) == 0


class TestGroupCountMemo:
    """Cross-query group-count memo (exec/preagg_exec._GROUP_STATS): repeated
    GROUP BYs over unchanged columns start at a right-sized G; mutation
    (fresh column uids) drops the memo."""

    def test_second_run_uses_small_G(self):
        import numpy as np
        from pg_strom_tpu import Table, column_from_values
        from pg_strom_tpu.exec import preagg_exec as pe
        rng = np.random.default_rng(21)
        keys = [int(v) for v in rng.integers(0, 10, 3000)]
        vals = [float(v) for v in rng.random(3000)]
        table = Table.from_columns("t", {
            "key": column_from_values(T.INT4, keys),
            "x": column_from_values(T.FLOAT8, vals),
        })
        layout = {n: i for i, n in enumerate(table.column_names)}
        arg = bind_columns(ColumnRef(type=T.FLOAT8, name="x"), layout)
        d, fam = lookup_agg("sum", (T.FLOAT8,))
        inst = AggInstance(aggname="sum", family=fam, slots=d.slots,
                           args=(arg,))
        g = bind_columns(ColumnRef(type=T.INT4, name="key"), layout)

        ex1 = PreAggExecutor(table, None, [g], [inst])
        r1 = sorted(ex1.run())
        ngroups, dense_rng = pe._GROUP_STATS.get(ex1._gskey)
        assert ngroups == 10
        assert dense_rng == 9           # dense keys 0..9 observed

        ex2 = PreAggExecutor(table, None, [g], [inst])
        r2 = sorted(ex2.run())
        assert r1 == r2
        # CPU backend (no fused kernel): the memo right-sizes down to the
        # unpacked 128-bucket floor on the second run
        assert ex2._G == 128

    def test_mutation_invalidates_memo(self):
        from pg_strom_tpu import Table, column_from_values
        from pg_strom_tpu.exec import preagg_exec as pe
        table = Table.from_columns("t", {
            "key": column_from_values(T.INT4, [1, 2, 1]),
            "x": column_from_values(T.FLOAT8, [1.0, 2.0, 3.0]),
        })
        layout = {n: i for i, n in enumerate(table.column_names)}
        arg = bind_columns(ColumnRef(type=T.FLOAT8, name="x"), layout)
        d, fam = lookup_agg("sum", (T.FLOAT8,))
        inst = AggInstance(aggname="sum", family=fam, slots=d.slots,
                           args=(arg,))
        g = bind_columns(ColumnRef(type=T.INT4, name="key"), layout)
        ex1 = PreAggExecutor(table, None, [g], [inst])
        ex1.run()
        k1 = ex1._gskey
        # replace the key column (fresh uid, as DML does)
        table.columns["key"] = column_from_values(T.INT4, [1, 2, 3])
        ex2 = PreAggExecutor(table, None, [g], [inst])
        ex2.run()
        assert ex2._gskey != k1


class TestWideKeyGrouping:
    """GROUP BY int8/timestamp now rides the MXU strategy (64-bit keys as
    two 32-bit word blocks, ops/preagg_mxu._KEY_WIDE_TYPES) instead of
    scatter."""

    def test_group_by_bigint_exact(self):
        import numpy as np
        from pg_strom_tpu import Table, column_from_values
        rng = np.random.default_rng(33)
        base = [0, -1, 1 << 62, -(1 << 62), 123456789012345678, -42]
        keys = [base[int(i)] if rng.random() > 0.05 else None
                for i in rng.integers(0, len(base), 3000)]
        vals = [float(v) for v in rng.random(3000)]
        table = Table.from_columns("t", {
            "key": column_from_values(T.INT8, keys),
            "x": column_from_values(T.FLOAT8, vals),
        })
        layout = {n: i for i, n in enumerate(table.column_names)}
        arg = bind_columns(ColumnRef(type=T.FLOAT8, name="x"), layout)
        d, fam = lookup_agg("sum", (T.FLOAT8,))
        inst = AggInstance(aggname="sum", family=fam, slots=d.slots,
                           args=(arg,))
        g = bind_columns(ColumnRef(type=T.INT8, name="key"), layout)
        ex = PreAggExecutor(table, None, [g], [inst])
        rows = ex.run()
        # single int key starts on the dense-key variant; this key set spans
        # ~2^63 so every chunk raises dense_fail and re-dispatches the
        # generic mxu strategy (and the memo skips dense next time)
        assert ex._strategy == "mxu_dense"
        assert ex.perfmon.counts.get("dense_fallbacks", 0) > 0
        ex2 = PreAggExecutor(table, None, [g], [inst])
        ex2.run()
        # _DENSE_FAILED memo skips the dense attempt; round 5's ladder
        # memo may jump even further, straight to the remembered winning
        # rung (sort for this 2^63-spanning key set) with no per-chunk
        # dense re-dispatches
        assert ex2._strategy != "mxu_dense"
        assert ex2.perfmon.counts.get("dense_fallbacks", 0) == 0
        got = {r[0]: r[1] for r in rows}
        want = {}
        for k, v in zip(keys, vals):
            want[k] = want.get(k, 0.0) + v
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < 1e-9 * max(1.0, abs(want[k]))
