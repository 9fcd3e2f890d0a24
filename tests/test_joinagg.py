"""Fused join->aggregate pipeline (ops/joinagg.py + exec/joinagg_exec.py).

The bulk-load chain analog: probe + projection + partial aggregation in one
device program.  Differential-tested against the host-exact path, including
the degradation contracts (output regrow, group overflow -> host replay).
"""

from decimal import Decimal

import numpy as np
import pytest

import pg_strom_tpu  # noqa: F401
from pg_strom_tpu import override
from pg_strom_tpu.datastore import Database, Table, column_from_values
from pg_strom_tpu.sqltypes import T
from pg_strom_tpu.sql import execute
from pg_strom_tpu.exec import joinagg_exec


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(42)
    n = 3000
    d = Database()
    d.create(Table.from_columns("fact", {
        "k": column_from_values(T.INT4, [
            int(v) if v < 45 else None for v in rng.integers(0, 50, n)]),
        "g": column_from_values(T.INT4, list(rng.integers(0, 6, n))),
        "x": column_from_values(T.FLOAT4, [
            float(v) if v > 0.05 else None for v in rng.random(n)]),
        "y": column_from_values(T.INT8, list(rng.integers(-20, 20, n))),
        "num": column_from_values(T.NUMERIC, [
            None if v < 0.1 else Decimal(f"{v * 10:.2f}")
            for v in rng.random(n)]),
    }))
    d.create(Table.from_columns("dim", {
        "k": column_from_values(T.INT4, list(range(50))),
        "w": column_from_values(T.INT8, [7 * i - 100 for i in range(50)]),
        "lab": column_from_values(T.TEXT, [f"lab{i % 4}" for i in range(50)]),
    }))
    # fan-out dimension: 8 rows per key -> probe output 8x input rows
    d.create(Table.from_columns("fan", {
        "k": column_from_values(T.INT4, [i % 50 for i in range(400)]),
        "v": column_from_values(T.INT4, list(range(400))),
    }))
    return d


def both(db, sql, chunk_rows=512, **cfg):
    outs = []
    for device in (True, False):
        with override(enabled=device, chunk_rows=chunk_rows, **cfg):
            r = execute(sql, db)
        outs.append(r.formatted(-3))
    assert outs[0] == outs[1], \
        f"device != host for {sql}\ndev : {outs[0][:4]}\nhost: {outs[1][:4]}"
    return outs[0]


def test_fused_path_engages(db):
    before = sum(1 for k in joinagg_exec._JIT_CACHE if k[0] == "joinagg")
    both(db, "select count(*), sum(fact.x) from fact "
             "join dim on fact.k = dim.k")
    after = sum(1 for k in joinagg_exec._JIT_CACHE if k[0] == "joinagg")
    assert after > before, "fused join-agg kernel was not used"


def test_count_star_only(db):
    both(db, "select count(*) from fact join dim on fact.k = dim.k")


def test_grouped_by_probe_col(db):
    both(db, "select fact.g, count(*), sum(fact.y), avg(fact.x), "
             "min(dim.w), max(dim.w) from fact join dim on fact.k = dim.k "
             "group by fact.g order by fact.g")


def test_grouped_by_build_text(db):
    both(db, "select dim.lab, count(*), sum(fact.y) from fact "
             "join dim on fact.k = dim.k group by dim.lab order by dim.lab")


def test_preds_both_sides(db):
    both(db, "select count(*), sum(dim.w) from fact "
             "join dim on fact.k = dim.k "
             "where fact.x > 0.4 and dim.w >= 0")


def test_cross_side_expression_agg(db):
    both(db, "select fact.g, sum(fact.y + dim.w), stddev(fact.y - dim.w) "
             "from fact join dim on fact.k = dim.k "
             "group by fact.g having count(*) > 5 order by fact.g")


def test_numeric_agg_through_join(db):
    both(db, "select fact.g, sum(fact.num), avg(fact.num) from fact "
             "join dim on fact.k = dim.k group by fact.g order by fact.g")


def test_corr_covar_through_join(db):
    both(db, "select dim.lab, corr(fact.x, fact.y), covar_pop(fact.x, fact.y) "
             "from fact join dim on fact.k = dim.k "
             "group by dim.lab order by dim.lab")


def test_null_keys_never_match(db):
    # ~10% of fact.k are NULL; they must not join
    rows = both(db, "select count(*) from fact join dim on fact.k = dim.k")
    with override(enabled=False):
        nn = execute("select count(k) from fact", db).scalar()
        total = execute("select count(*) from fact", db).scalar()
    assert nn < total  # fixture really has NULL keys
    assert int(rows[0]) <= nn


def test_output_regrow(db):
    # 8x fan-out exceeds the initial 2x output capacity -> regrow re-dispatch
    both(db, "select count(*), sum(fan.v) from fact "
             "join fan on fact.k = fan.k where fact.y > 0")


def test_group_overflow_host_replay(db):
    # more groups than device slots -> CPU_RECHECK replay, still exact
    both(db, "select fact.y, count(*), sum(dim.w) from fact "
             "join dim on fact.k = dim.k group by fact.y order by fact.y",
         max_groups_device=16)


def test_empty_result(db):
    both(db, "select count(*), sum(fact.y) from fact "
             "join dim on fact.k = dim.k where fact.x > 99.0")


def test_limit_offset_after_agg(db):
    both(db, "select fact.g, count(*) from fact join dim on fact.k = dim.k "
             "group by fact.g order by fact.g limit 3 offset 1")


def test_pregrouped_path_engages(db):
    """Star shape (dim-only GROUP BY, fact-only agg args) must take the
    pregrouped path: dimension group ids enumerated at build time, probe =
    one slot->seg lookup (exec/joinagg_exec._compose_pregroup)."""
    before = sum(1 for k in joinagg_exec._JIT_CACHE
                 if k[0] == "joinagg_pregroup")
    both(db, "select dim.lab, count(*), sum(fact.y), avg(fact.x) from fact "
             "join dim on fact.k = dim.k group by dim.lab order by dim.lab")
    after = sum(1 for k in joinagg_exec._JIT_CACHE
                if k[0] == "joinagg_pregroup")
    assert after > before, "pregrouped star path was not used"


def test_pregrouped_group_expr_and_pred(db):
    # group key is an EXPRESSION over dim columns; preds on both sides
    # (dim pred folds into the seg table, fact pred into the probe mask)
    both(db, "select dim.w % 3, count(*), sum(fact.y) from fact "
             "join dim on fact.k = dim.k "
             "where fact.x > 0.2 and dim.w > -50 "
             "group by dim.w % 3 order by dim.w % 3")


def test_pregrouped_vs_generic_same_result(db, monkeypatch):
    q = ("select dim.lab, count(*), sum(fact.y) from fact "
         "join dim on fact.k = dim.k group by dim.lab order by dim.lab")
    with override(enabled=True, chunk_rows=512):
        a = execute(q, db).formatted(-3)
    from pg_strom_tpu.exec.joinagg_exec import JoinPreAggExecutor
    monkeypatch.setattr(JoinPreAggExecutor, "_compose_pregroup",
                        lambda self, *args: None)
    with override(enabled=True, chunk_rows=512):
        b = execute(q, db).formatted(-3)   # generic dense path, no pregroup
    assert a == b


def test_pregrouped_many_groups_g_escalation(db):
    # one group per dim row (50 groups; G_pre = 128 minimum) + NULL fact keys
    both(db, "select dim.w, count(*) from fact join dim on fact.k = dim.k "
             "group by dim.w order by dim.w")
