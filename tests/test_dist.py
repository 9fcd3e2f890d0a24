"""Engine-integrated distributed execution (exec/dist_exec.py +
parallel/dist.py) on the 8-device virtual CPU mesh.

The contract: real SQL
join+GROUP BY queries run through the planner on the mesh behind
pg_strom.distributed and match the single-device (host-exact) results,
including the overflow -> repartition ladder (the distributed analog of
the reference's DataStoreNoSpace regrow, gpuhashjoin.c:4323-4425).
"""

import numpy as np
import pytest

import pg_strom_tpu  # noqa: F401
import jax

from pg_strom_tpu import T
from pg_strom_tpu.config import config, override
from pg_strom_tpu.datastore import Database, Table, column_from_values
from pg_strom_tpu.sql.api import execute


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    jax.clear_caches()
    yield


def _mesh_ready():
    return len(jax.devices()) >= 2


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(20260820)
    nf, nd = 12000, 240
    db = Database()
    fk = rng.integers(0, nd, nf)
    db.create(Table.from_columns("fact", {
        "k": column_from_values(T.INT4, [int(v) for v in fk]),
        "k2": column_from_values(T.INT4, [int(v) % 3 for v in fk]),
        "x": column_from_values(
            T.FLOAT8, [None if i % 37 == 0 else float(v)
                       for i, v in enumerate(rng.random(nf))]),
        "xf": column_from_values(
            T.FLOAT4, [float(np.float32(v)) for v in rng.random(nf)]),
        "q": column_from_values(
            T.INT8, [int(v) for v in rng.integers(-10**9, 10**9, nf)]),
        "s": column_from_values(
            T.INT2, [int(v) for v in rng.integers(-300, 300, nf)]),
    }))
    db.create(Table.from_columns("dim", {
        "dk": column_from_values(T.INT4, list(range(nd))),
        "dk2": column_from_values(T.INT4, [i % 3 for i in range(nd)]),
        "cat": column_from_values(T.TEXT, [f"cat{i % 7}" for i in range(nd)]),
        "w": column_from_values(T.FLOAT8, [float(i) * 0.5
                                           for i in range(nd)]),
    }))
    return db


def _both(db, q):
    host = execute(q, db).rows
    with override(distributed=True, debug_force_offload=True):
        dist = execute(q, db).rows
    return host, dist


def _rows_equal(host, dist):
    if len(host) != len(dist):
        return False
    for h, d in zip(host, dist):
        for hv, dv in zip(h, d):
            if isinstance(hv, float) and isinstance(dv, float):
                if not (hv == dv
                        or abs(hv - dv) <= 1e-9 * max(abs(hv), abs(dv), 1.0)):
                    return False
            elif hv != dv:
                return False
    return True


def _dist_engaged(db, q) -> bool:
    """True when the planner actually ran the distributed executor."""
    from pg_strom_tpu.exec import dist_exec as de
    ran = {}
    orig = de.DistJoinAggExecutor.run

    def wrapped(self):
        ran["yes"] = True
        return orig(self)

    de.DistJoinAggExecutor.run = wrapped
    try:
        with override(distributed=True, debug_force_offload=True):
            execute(q, db)
    finally:
        de.DistJoinAggExecutor.run = orig
    return ran.get("yes", False)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
class TestDistributedSQL:
    def test_join_group_by_text_key(self, db):
        q = ("select dim.cat, count(*), sum(fact.x) from fact, dim "
             "where fact.k = dim.dk group by dim.cat order by dim.cat")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist), (host[:3], dist[:3])
        assert _dist_engaged(db, q)

    def test_full_agg_families(self, db):
        q = ("select dim.cat, count(fact.x), sum(fact.q), min(fact.q), "
             "max(fact.q), avg(fact.x), stddev(fact.x), var_samp(fact.x), "
             "sum(fact.xf), corr(fact.x, dim.w) "
             "from fact, dim where fact.k = dim.dk "
             "group by dim.cat order by dim.cat")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_multi_key_join(self, db):
        q = ("select dim.cat, count(*), sum(fact.s) from fact, dim "
             "where fact.k = dim.dk and fact.k2 = dim.dk2 "
             "group by dim.cat order by dim.cat")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_group_by_int_key_from_probe(self, db):
        q = ("select fact.k2, count(*), sum(dim.w), min(fact.s) "
             "from fact, dim where fact.k = dim.dk "
             "group by fact.k2 order by fact.k2")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_ungrouped(self, db):
        q = ("select count(*), sum(fact.x), max(dim.w) from fact, dim "
             "where fact.k = dim.dk")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_where_preds_applied_per_side(self, db):
        q = ("select dim.cat, count(*), sum(fact.x) from fact, dim "
             "where fact.k = dim.dk and fact.s > 0 and dim.w < 60 "
             "group by dim.cat order by dim.cat")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_overflow_repartitions_and_stays_exact(self, db):
        # a dominant key funnels most rows into one partition bucket; the
        # initial capacity ladder must overflow and double (the
        # DataStoreNoSpace-regrow analog), still yielding exact results
        rng = np.random.default_rng(5)
        nf = 4000
        skewed = np.where(rng.random(nf) < 0.9, 7, rng.integers(0, 50, nf))
        db2 = Database()
        db2.create(Table.from_columns("f2", {
            "k": column_from_values(T.INT4, [int(v) for v in skewed]),
            "x": column_from_values(T.FLOAT8,
                                    [float(v) for v in rng.random(nf)]),
        }))
        db2.create(Table.from_columns("d2", {
            "dk": column_from_values(T.INT4, list(range(50))),
        }))
        q = ("select f2.k, count(*), sum(f2.x) from f2, d2 "
             "where f2.k = d2.dk group by f2.k order by f2.k")
        host = execute(q, db2).rows
        from pg_strom_tpu.utils.perfmon import Perfmon
        from pg_strom_tpu.plan import planner as pl
        with override(distributed=True, debug_force_offload=True):
            dist = execute(q, db2).rows
        assert _rows_equal(host, dist)

    def test_numeric_agg_distributes(self, db):
        # round 3 (VERDICT item 9): the numeric (Decimal) family rides the
        # mesh — mantissa/exp/dscale ship as int64 lanes, per-device
        # partials use the same _slot_num_sum windows as the local path
        db3 = Database()
        from decimal import Decimal
        rng = np.random.default_rng(13)
        n = 600
        vals = [None if i % 17 == 0
                else Decimal(int(rng.integers(-10**9, 10**9)))
                / Decimal(100)
                for i in range(n)]
        db3.create(Table.from_columns("fn", {
            "k": column_from_values(T.INT4,
                                    [int(v) for v in
                                     rng.integers(1, 9, n)]),
            "n": column_from_values(T.NUMERIC, vals),
        }))
        db3.create(Table.from_columns("dn", {
            "dk": column_from_values(T.INT4, list(range(1, 9))),
        }))
        q = ("select fn.k, sum(fn.n), avg(fn.n), count(fn.n), min(fn.n), "
             "max(fn.n) from fn, dn where fn.k = dn.dk "
             "group by fn.k order by fn.k")
        host, dist = _both(db3, q)
        assert host == dist, (host[:2], dist[:2])
        assert _dist_engaged(db3, q), "numeric agg did not distribute"

    def test_numeric_recheck_rows_fall_back(self, db):
        # values outside the device numeric window carry exact host-side
        # Decimals the wire cannot ship: silently fall back, still exact
        db4 = Database()
        from decimal import Decimal
        db4.create(Table.from_columns("fr", {
            "k": column_from_values(T.INT4, [1, 1, 2]),
            "n": column_from_values(T.NUMERIC,
                                    [Decimal("1E+49"), Decimal("2"),
                                     Decimal("3")]),
        }))
        db4.create(Table.from_columns("dr", {
            "dk": column_from_values(T.INT4, [1, 2]),
        }))
        q = ("select fr.k, sum(fr.n) from fr, dr where fr.k = dr.dk "
             "group by fr.k order by fr.k")
        host, dist = _both(db4, q)
        assert host == dist

    def test_distributed_guc_surface(self, db):
        execute("set pg_strom.distributed to on", db)
        assert config.distributed is True
        execute("set pg_strom.distributed to off", db)
        assert config.distributed is False


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_executor_repartition_counter():
    """Drive the executor directly with tiny capacities via a small
    dist_group_slots so the ladder provably fires at least once."""
    rng = np.random.default_rng(9)
    nf = 6000
    ngroups = 2000        # per-DEVICE slots overflow: groups are hash-
    # sharded over the mesh, so forcing the ladder needs
    # > dist_group_slots * n_devices distinct keys (2000 > 64*8)
    db = Database()
    db.create(Table.from_columns("f", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in
                                 rng.integers(0, ngroups, nf)]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("d", {
        "dk": column_from_values(T.INT4, list(range(ngroups))),
    }))
    # ~250 groups/device > 64 slots: the G ladder must double until they fit
    q = ("select f.k, count(*), sum(f.x) from f, d where f.k = d.dk "
         "group by f.k order by f.k")
    host = execute(q, db).rows
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    with override(distributed=True, debug_force_offload=True,
                  dist_group_slots=64, perfmon=True):
        pq = plan_query(parse(q), db)
        dist = pq.execute()
    assert _rows_equal(host, dist)
    # the ladder PROVABLY fired: 400 groups never fit 64 slots, so the
    # executor must have doubled G at least once and counted it
    assert pq.perfmon.counts.get("dist_repartitions", 0) >= 1, \
        dict(pq.perfmon.counts)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_distinct_aggregate_distributes():
    """agg(DISTINCT x) rides the mesh (round-4 verdict item 9): the dedup
    exchange routes every (group, x) pair to one device, so per-device
    partials merge with no double count — and the result is host-exact."""
    rng = np.random.default_rng(46)
    n = 9000
    db = Database()
    db.create(Table.from_columns("dd", {
        "g": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 12, n)]),
        "x": column_from_values(
            T.INT4, [None if i % 17 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 60, n))]),
        "y": column_from_values(T.INT8,
                                [int(v) for v in
                                 rng.integers(-1000, 1000, n)]),
    }))
    for q in (
        "select dd.g, count(distinct dd.x), count(*), sum(dd.y) from dd "
        "group by dd.g order by dd.g",
        "select dd.g, sum(distinct dd.x), min(dd.y) from dd "
        "group by dd.g order by dd.g",
        "select count(distinct dd.x) from dd",
        "select dd.g, avg(distinct dd.x) from dd group by dd.g "
        "order by dd.g",
    ):
        host = execute(q, db).rows
        from pg_strom_tpu.sql.parser import parse
        from pg_strom_tpu.plan.planner import plan_query
        with override(distributed=True, debug_force_offload=True,
                      perfmon=True):
            pq = plan_query(parse(q), db)
            dist = pq.execute()
        assert _rows_equal(host, dist), (q, host[:3], dist[:3])
        assert pq.perfmon.counts.get("dist_distinct_steps", 0) >= 1, (
            q, dict(pq.perfmon.counts))


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_distinct_aggregate_distributes_through_join():
    """agg(DISTINCT x) over JOINED rows also rides the mesh: the dedup
    exchange runs on the join-output lanes."""
    rng = np.random.default_rng(47)
    nf, nd = 8000, 30
    db = Database()
    db.create(Table.from_columns("jf", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, nd, nf)]),
        "x": column_from_values(
            T.INT4, [None if i % 13 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 40, nf))]),
    }))
    db.create(Table.from_columns("jd", {
        "dk": column_from_values(T.INT4, list(range(nd))),
        "cat": column_from_values(T.TEXT, [f"c{i % 4}" for i in range(nd)]),
        "w": column_from_values(T.INT8, [5 * i for i in range(nd)]),
    }))
    for q in (
        "select jd.cat, count(distinct jf.x), count(*), sum(jd.w) "
        "from jf, jd where jf.k = jd.dk group by jd.cat order by jd.cat",
        "select count(distinct jf.x), sum(jf.x) from jf, jd "
        "where jf.k = jd.dk",
    ):
        host = execute(q, db).rows
        from pg_strom_tpu.sql.parser import parse
        from pg_strom_tpu.plan.planner import plan_query
        with override(distributed=True, debug_force_offload=True,
                      perfmon=True):
            pq = plan_query(parse(q), db)
            dist = pq.execute()
        assert _rows_equal(host, dist), (q, host[:3], dist[:3])
        assert pq.perfmon.counts.get("dist_distinct_steps", 0) >= 1, (
            q, dict(pq.perfmon.counts))


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_skew_routing_keeps_hot_key_distributed():
    """~90% of probe rows carry ONE key (SURVEY §5 "skew-aware
    repartitioning"; round-4 verdict item 4): the heavy-hitter router must
    keep the query distributed — no DistFallback, no capacity-ladder
    blowup — and stay host-exact."""
    rng = np.random.default_rng(44)
    nf, nd = 16000, 50
    keys = np.where(rng.random(nf) < 0.9, 7,
                    rng.integers(0, nd, nf)).astype(int)
    db = Database()
    db.create(Table.from_columns("sf", {
        "k": column_from_values(T.INT4, [int(v) for v in keys]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("sd", {
        "dk": column_from_values(T.INT4, list(range(nd))),
        "w": column_from_values(T.INT8, [3 * i for i in range(nd)]),
    }))
    q = ("select sf.k, count(*), sum(sf.x), sum(sd.w) from sf, sd "
         "where sf.k = sd.dk group by sf.k order by sf.k")
    host = execute(q, db).rows
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    from pg_strom_tpu.exec import dist_exec as de
    fell_back = {}
    orig = de.DistJoinAggExecutor.run

    def spy(self):
        try:
            return orig(self)
        except de.DistFallback as e:
            fell_back["why"] = str(e)
            raise

    de.DistJoinAggExecutor.run = spy
    try:
        with override(distributed=True, debug_force_offload=True,
                      perfmon=True):
            pq = plan_query(parse(q), db)
            dist = pq.execute()
    finally:
        de.DistJoinAggExecutor.run = orig
    assert not fell_back, fell_back
    assert _rows_equal(host, dist)
    counts = dict(pq.perfmon.counts)
    assert counts.get("dist_skew_routed", 0) >= 1, counts
    # the whole point: the hot key must not force capacity doubling
    assert counts.get("dist_repartitions", 0) == 0, counts


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_skew_routing_2d_mesh_exact():
    """Skew routing on the hosts x chips mesh: the heavy-build broadcast
    all_gathers over BOTH axes and the spread part lane must survive the
    two-stage exchange."""
    if len(jax.devices()) % 4 or len(jax.devices()) < 8:
        pytest.skip("needs 8 devices for a 2x4 mesh")
    rng = np.random.default_rng(48)
    nf = 8000
    keys = np.where(rng.random(nf) < 0.9, 11,
                    rng.integers(0, 30, nf)).astype(int)
    db = Database()
    db.create(Table.from_columns("sf3", {
        "k": column_from_values(T.INT4, [int(v) for v in keys]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("sd3", {
        "dk": column_from_values(T.INT4, list(range(30))),
    }))
    q = ("select sf3.k, count(*), sum(sf3.x) from sf3, sd3 "
         "where sf3.k = sd3.dk group by sf3.k order by sf3.k")
    host = execute(q, db).rows
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    with override(distributed=True, debug_force_offload=True,
                  dist_mesh_hosts=2, perfmon=True):
        pq = plan_query(parse(q), db)
        dist = pq.execute()
    assert _rows_equal(host, dist)
    counts = dict(pq.perfmon.counts)
    assert counts.get("dist_skew_routed", 0) >= 1, counts
    assert counts.get("dist_repartitions", 0) == 0, counts


def test_device_distinct_without_distributed():
    """agg(DISTINCT x) engages the device dedup tier even with
    pg_strom.distributed OFF (round 4: the host row loop is the only
    alternative; the reference always punts DISTINCT to the CPU agg)."""
    rng = np.random.default_rng(51)
    n = 8000
    db = Database()
    db.create(Table.from_columns("lv", {
        "g": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 10, n)]),
        "x": column_from_values(
            T.INT4, [None if i % 19 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 50, n))]),
    }))
    q = ("select g, count(distinct x), count(*) from lv group by g "
         "order by g")
    with override(enabled=False):
        host = execute(q, db).rows
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    with override(debug_force_offload=True, perfmon=True):
        assert not config.distributed
        pq = plan_query(parse(q), db)
        got = pq.execute()
    assert _rows_equal(host, got)
    assert pq.perfmon.counts.get("dist_distinct_steps", 0) >= 1, \
        dict(pq.perfmon.counts)
    # kill switch: device_distinct=off reverts to the host tier
    with override(debug_force_offload=True, device_distinct=False,
                  perfmon=True):
        pq2 = plan_query(parse(q), db)
        got2 = pq2.execute()
    assert _rows_equal(host, got2)
    assert pq2.perfmon.counts.get("dist_distinct_steps", 0) == 0


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_distinct_float_args_pg_equality():
    """DISTINCT over float args follows PG equality: -0.0 == +0.0 and
    every NaN payload is ONE value (bit-lane dedup would miscount both)."""
    from decimal import Decimal  # noqa: F401
    f4 = [1.5, -0.0, 0.0, float("nan"), float("nan"), 2.5, 1.5, None]
    f8 = [3.25, 0.0, -0.0, float("nan"), 7.5, float("nan"), 3.25, None]
    g = [1, 1, 1, 1, 1, 2, 2, 2]
    db = Database()
    db.create(Table.from_columns("fd", {
        "g": column_from_values(T.INT4, g * 50),
        "a": column_from_values(T.FLOAT4, f4 * 50),
        "b": column_from_values(T.FLOAT8, f8 * 50),
    }))
    for q in (
        "select g, count(distinct a) from fd group by g order by g",
        "select g, count(distinct b) from fd group by g order by g",
        "select g, sum(distinct b) from fd group by g order by g",
    ):
        host = execute(q, db).rows
        from pg_strom_tpu.sql.parser import parse
        from pg_strom_tpu.plan.planner import plan_query
        with override(distributed=True, debug_force_offload=True,
                      perfmon=True):
            pq = plan_query(parse(q), db)
            dist = pq.execute()
        import math
        assert len(host) == len(dist), (q, host, dist)
        for rh, rd in zip(host, dist):
            for vh, vd in zip(rh, rd):
                if isinstance(vh, float) and math.isnan(vh):
                    assert isinstance(vd, float) and math.isnan(vd), (q, rh, rd)
                elif isinstance(vh, float):
                    assert vd == pytest.approx(vh, rel=1e-12), (q, rh, rd)
                else:
                    assert vh == vd, (q, rh, rd)
        assert pq.perfmon.counts.get("dist_distinct_steps", 0) >= 1, q


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_multiple_distinct_aggs_one_query():
    """count(distinct a), count(distinct b), sum(distinct a): one dedup
    exchange per distinct agg, all in one step."""
    rng = np.random.default_rng(52)
    n = 6000
    db = Database()
    db.create(Table.from_columns("md", {
        "g": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 7, n)]),
        "a": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 25, n)]),
        "b": column_from_values(
            T.INT8, [None if i % 11 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 90, n))]),
    }))
    q = ("select g, count(distinct a), count(distinct b), sum(distinct a), "
         "count(*) from md group by g order by g")
    host = execute(q, db).rows
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    with override(distributed=True, debug_force_offload=True, perfmon=True):
        pq = plan_query(parse(q), db)
        dist = pq.execute()
    assert _rows_equal(host, dist), (host[:2], dist[:2])
    assert pq.perfmon.counts.get("dist_distinct_steps", 0) >= 3, \
        dict(pq.perfmon.counts)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_distinct_numeric_count():
    """count(DISTINCT numeric): equality is on the VALUE (1.0 == 1.00 ==
    1.000), not the (mantissa, exponent, dscale) lanes."""
    from decimal import Decimal
    vals = [Decimal("1.0"), Decimal("1.00"), Decimal("1.000"),
            Decimal("2.5"), Decimal("2.50"), None, Decimal("0"),
            Decimal("0.00"), Decimal("-3.14")]
    g = [1, 1, 1, 1, 2, 2, 2, 2, 2]
    db = Database()
    db.create(Table.from_columns("nd", {
        "g": column_from_values(T.INT4, g * 40),
        "n": column_from_values(T.NUMERIC, vals * 40),
    }))
    q = "select g, count(distinct n), count(n) from nd group by g order by g"
    host = execute(q, db).rows
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    with override(distributed=True, debug_force_offload=True, perfmon=True):
        pq = plan_query(parse(q), db)
        dist = pq.execute()
    assert _rows_equal(host, dist), (host, dist)
    # fixture sanity: g1 = {1.0, 2.5}; g2 = {2.5, 0, -3.14}
    assert host[0][1] == 2 and host[1][1] == 3
    assert pq.perfmon.counts.get("dist_distinct_steps", 0) >= 1


def test_skew_routing_balance_property():
    """SURVEY §7 hard-part 5 (scaling efficiency under skew): the router's
    device-load balance is a pure function of the hash + spread logic, so
    it is PROVABLE host-side without multi-chip hardware.  With 90% of
    rows on one key, plain hash partitioning overloads one device ~7x the
    mean; the heavy-key spread keeps every device within 15% of the mean."""
    from pg_strom_tpu.parallel.dist import host_combine_hash
    from pg_strom_tpu.parallel.shuffle import detect_heavy_keys, \
        _HEAVY_SENTINEL
    rng = np.random.default_rng(50)
    n, ndev = 200_000, 8
    keys = np.where(rng.random(n) < 0.9, 7,
                    rng.integers(0, 1000, n)).astype(np.int64)
    h = host_combine_hash([keys])
    part_plain = (h.astype(np.uint64) % np.uint64(ndev)).astype(int)
    loads = np.bincount(part_plain, minlength=ndev)
    assert loads.max() > 3.0 * loads.mean(), loads   # the problem is real
    heavy = detect_heavy_keys(h, np.ones(n, bool), k_heavy=8)
    nh = int((heavy != _HEAVY_SENTINEL).sum())
    assert nh >= 1
    is_heavy = np.isin(h, heavy[:nh])
    part = np.where(is_heavy, np.arange(n) % ndev, part_plain)
    loads2 = np.bincount(part, minlength=ndev)
    assert loads2.max() <= 1.15 * loads2.mean(), loads2
    # uniform workloads must stay balanced and unrouted
    uk = rng.integers(0, 1 << 40, n).astype(np.int64)
    hu = host_combine_hash([uk])
    hv = detect_heavy_keys(hu, np.ones(n, bool), k_heavy=8)
    assert int((hv != _HEAVY_SENTINEL).sum()) == 0
    lu = np.bincount((hu.astype(np.uint64) % np.uint64(ndev)).astype(int),
                     minlength=ndev)
    assert lu.max() <= 1.1 * lu.mean(), lu


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_skew_routing_off_still_exact():
    """Same hot-key shape with routing disabled: results stay exact
    (the ladder may fire — that is the de-distribution the router
    exists to avoid)."""
    rng = np.random.default_rng(45)
    nf = 4000
    keys = np.where(rng.random(nf) < 0.9, 3,
                    rng.integers(0, 20, nf)).astype(int)
    db = Database()
    db.create(Table.from_columns("sf2", {
        "k": column_from_values(T.INT4, [int(v) for v in keys]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("sd2", {
        "dk": column_from_values(T.INT4, list(range(20))),
    }))
    q = ("select sf2.k, count(*), sum(sf2.x) from sf2, sd2 "
         "where sf2.k = sd2.dk group by sf2.k order by sf2.k")
    host = execute(q, db).rows
    with override(distributed=True, debug_force_offload=True,
                  dist_skew_routing=False):
        dist = execute(q, db).rows
    assert _rows_equal(host, dist)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
class TestDistPreAgg:
    """Single-table distributed GROUP BY (data-parallel shards + host
    merge) must match the local path exactly and actually engage."""

    def test_single_table_group_by(self, db):
        q = ("select fact.k2, count(*), sum(fact.q), min(fact.s), "
             "max(fact.s), avg(fact.x), stddev(fact.x) "
             "from fact group by fact.k2 order by fact.k2")
        from pg_strom_tpu.exec import dist_exec as de
        ran = {}
        orig = de.DistPreAggExecutor.run

        def wrapped(self):
            ran["yes"] = True
            return orig(self)

        host = execute(q, db).rows
        de.DistPreAggExecutor.run = wrapped
        try:
            with override(distributed=True, debug_force_offload=True):
                dist = execute(q, db).rows
        finally:
            de.DistPreAggExecutor.run = orig
        assert ran.get("yes"), "DistPreAggExecutor did not engage"
        assert _rows_equal(host, dist)

    def test_single_table_with_where(self, db):
        q = ("select fact.k2, count(fact.x), sum(fact.x) from fact "
             "where fact.s > 0 group by fact.k2 order by fact.k2")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_ungrouped_single_table(self, db):
        q = "select count(*), sum(fact.q), max(fact.x) from fact"
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)

    def test_group_slot_ladder(self, db):
        # fact.k has 240 distinct values > the 64-slot floor: ladder doubles
        q = ("select fact.k, count(*) from fact group by fact.k "
             "order by fact.k")
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True,
                      dist_group_slots=64):
            dist = execute(q, db).rows
        assert _rows_equal(host, dist)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
class TestDistEdgeCases:
    def test_all_null_join_keys(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.INT4, [None] * 64),
            "x": column_from_values(T.FLOAT8, [1.0] * 64)}))
        db.create(Table.from_columns("d", {
            "dk": column_from_values(T.INT4, list(range(8)))}))
        q = "select count(*), sum(f.x) from f, d where f.k = d.dk"
        host, dist = _both(db, q)
        assert host == dist == [(0, None)]

    def test_null_group_key_group(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.INT4, [1, 1, 2, 2, 1, 2] * 20),
            "g": column_from_values(T.INT4,
                                    ([None, 5, None, 7, 5, 7] * 20)),
            "x": column_from_values(T.FLOAT8, [float(i) for i in range(120)]),
        }))
        db.create(Table.from_columns("d", {
            "dk": column_from_values(T.INT4, [1, 2])}))
        q = ("select f.g, count(*), sum(f.x) from f, d where f.k = d.dk "
             "group by f.g order by f.g")
        host, dist = _both(db, q)
        assert _rows_equal(host, dist)
        assert host[-1][0] is None       # the NULL-key group exists

    def test_float_join_keys_negzero_and_nan(self):
        # PG float equality: -0 == +0 and NaN == NaN (btree semantics);
        # the order-key encoding must preserve both
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.FLOAT8,
                                    [0.0, -0.0, float("nan"), 1.5] * 16),
            "x": column_from_values(T.FLOAT8, [1.0] * 64)}))
        db.create(Table.from_columns("d", {
            "dk": column_from_values(T.FLOAT8, [0.0, float("nan"), 1.5])}))
        q = "select count(*) from f, d where f.k = d.dk"
        host, dist = _both(db, q)
        assert host == dist
        assert host[0][0] == 64          # every row matches exactly one dim

    def test_single_table_all_rows_filtered(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.INT4, [1, 2, 3]),
            "x": column_from_values(T.FLOAT8, [1.0, 2.0, 3.0])}))
        q = "select f.k, count(*) from f where f.x > 99 group by f.k"
        host, dist = _both(db, q)        # dist falls back on empty input
        assert host == dist == []


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_resident_sharded_lanes_reused():
    """Round-3 item 5: the distributed executor shards prepared lanes over
    the mesh ONCE (tcache aux space); a repeated query consumes the
    resident arrays — dist_resident_hits fires and the H2D byte counter
    stays at zero for the second run."""
    rng = np.random.default_rng(21)
    nf = 2000
    db = Database()
    db.create(Table.from_columns("rf", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 40, nf)]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("rd_", {
        "dk": column_from_values(T.INT4, list(range(40))),
    }))
    q = ("select rf.k, count(*), sum(rf.x) from rf, rd_ "
         "where rf.k = rd_.dk group by rf.k order by rf.k")
    from pg_strom_tpu.sql.parser import parse
    from pg_strom_tpu.plan.planner import plan_query
    with override(distributed=True, debug_force_offload=True, perfmon=True):
        pq1 = plan_query(parse(q), db)
        r1 = pq1.execute()
        pq2 = plan_query(parse(q), db)
        r2 = pq2.execute()
    assert _rows_equal(r1, r2)
    assert pq1.perfmon.counts.get("dist_resident_hits", 0) == 0
    assert pq1.perfmon.bytes.get("h2d", 0) > 0
    assert pq2.perfmon.counts.get("dist_resident_hits", 0) >= 1, \
        dict(pq2.perfmon.counts)
    assert pq2.perfmon.bytes.get("h2d", 0) == 0, dict(pq2.perfmon.bytes)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
class TestHierarchicalMesh:
    """2D hosts x chips mesh (round-3 item 6): the shuffle exchange runs
    all_to_all over "chips" then "hosts"; results must match
    the flat mesh and the host tier exactly."""

    def _db(self):
        rng = np.random.default_rng(77)
        nf, nd = 4000, 120
        db = Database()
        db.create(Table.from_columns("hf", {
            "k": column_from_values(T.INT4,
                                    [int(v) for v in
                                     rng.integers(0, nd, nf)]),
            "x": column_from_values(T.FLOAT8,
                                    [None if i % 23 == 0 else float(v)
                                     for i, v in enumerate(rng.random(nf))]),
            "q": column_from_values(T.INT8,
                                    [int(v) for v in
                                     rng.integers(-10**6, 10**6, nf)]),
        }))
        db.create(Table.from_columns("hd", {
            "dk": column_from_values(T.INT4, list(range(nd))),
            "cat": column_from_values(T.TEXT,
                                      [f"c{i % 5}" for i in range(nd)]),
        }))
        return db

    def test_2d_mesh_join_agg_matches(self):
        db = self._db()
        q = ("select hd.cat, count(*), sum(hf.x), min(hf.q), max(hf.q) "
             "from hf, hd where hf.k = hd.dk group by hd.cat "
             "order by hd.cat")
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True,
                      dist_mesh_hosts=2):
            d2 = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True):
            d1 = execute(q, db).rows
        assert _rows_equal(host, d2), (host[:2], d2[:2])
        assert _rows_equal(host, d1)

    def test_2d_mesh_shapes(self):
        from pg_strom_tpu.parallel.mesh import get_mesh2, mesh_for_config
        m = get_mesh2(2, 4)
        assert m.axis_names == ("hosts", "chips")
        assert m.shape["hosts"] == 2 and m.shape["chips"] == 4
        with override(dist_mesh_hosts=2):
            m2 = mesh_for_config(8)
            assert m2.axis_names == ("hosts", "chips")
        with override(dist_mesh_hosts=1):
            m1 = mesh_for_config(8)
            assert m1.axis_names == ("dp",)

    def test_2d_single_table_group_by(self):
        db = self._db()
        q = "select hf.k, count(*), sum(hf.q) from hf group by hf.k order by hf.k"
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True,
                      dist_mesh_hosts=2):
            d2 = execute(q, db).rows
        assert _rows_equal(host, d2)

    def test_2d_distinct_aggregate(self):
        """agg(DISTINCT x) over the hosts x chips mesh: the dedup exchange
        rides the two-stage exchange path."""
        db = self._db()
        q = ("select hf.k, count(distinct hf.q), count(*) from hf "
             "group by hf.k order by hf.k")
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True,
                      dist_mesh_hosts=2):
            d2 = execute(q, db).rows
        assert _rows_equal(host, d2)

    def test_mesh_toggle_switches_programs(self):
        """Toggling pg_strom.dist_mesh_hosts mid-process must BUILD a step
        for the new topology, not silently serve the cached one (round-3
        verdict Weak #3: the step-cache key ignored the mesh shape)."""
        from pg_strom_tpu.parallel.dist import BUILD_COUNTS
        db = self._db()
        q = ("select hd.cat, count(*), sum(hf.q) from hf, hd "
             "where hf.k = hd.dk group by hd.cat order by hd.cat")
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True):
            d1 = execute(q, db).rows
        n2d = BUILD_COUNTS["exchange_2stage"]
        with override(distributed=True, debug_force_offload=True,
                      dist_mesh_hosts=2):
            d2 = execute(q, db).rows
        assert BUILD_COUNTS["exchange_2stage"] > n2d, (
            "same query after a flat-mesh run must compile a 2-stage "
            "exchange when the 2D mesh is requested", BUILD_COUNTS)
        nflat = BUILD_COUNTS["exchange_flat"]
        with override(distributed=True, debug_force_offload=True):
            d1b = execute(q, db).rows
        # back to flat: the cached flat step may serve (same key) — results
        # must stay exact either way
        assert BUILD_COUNTS["exchange_flat"] == nflat
        assert _rows_equal(host, d1) and _rows_equal(host, d2) \
            and _rows_equal(host, d1b)


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_expression_keys_and_args_distribute():
    """Round-3 item 9: computed group keys and agg args pre-project into
    wire lanes — the mesh no longer sits idle for expression shapes."""
    rng = np.random.default_rng(31)
    nf = 3000
    db = Database()
    db.create(Table.from_columns("ef", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 60, nf)]),
        "a": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 50, nf)]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("ed", {
        "dk": column_from_values(T.INT4, list(range(60))),
    }))
    q = ("select ef.k % 7, count(*), sum(ef.a + 1), sum(ef.x * 2) "
         "from ef, ed where ef.k = ed.dk group by ef.k % 7 "
         "order by ef.k % 7")
    host, dist = _both(db, q)
    assert _rows_equal(host, dist), (host[:3], dist[:3])
    assert _dist_engaged(db, q), "expression shapes did not distribute"


@pytest.mark.skipif(not _mesh_ready(), reason="needs a multi-device mesh")
def test_distributed_topk():
    """Round-3 item 9: ORDER BY + LIMIT shards over the mesh (local top-k
    per device, host candidate merge) and matches the host tier exactly,
    including ties resolved by row order."""
    rng = np.random.default_rng(41)
    n = 9000
    db = Database()
    db.create(Table.from_columns("tk", {
        "a": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 500, n)]),
        "x": column_from_values(T.FLOAT8,
                                [None if i % 31 == 0 else float(v)
                                 for i, v in enumerate(rng.random(n))]),
        "id": column_from_values(T.INT8, list(range(n))),
    }))
    q = ("select tk.a, tk.x, tk.id from tk where tk.a < 400 "
         "order by tk.a desc, tk.x limit 25")
    host = execute(q, db).rows
    from pg_strom_tpu.plan import planner as pl
    ran = {}
    orig = pl._topk_rows_dist

    def spy(*a, **kw):
        r = orig(*a, **kw)
        ran["engaged"] = r is not None
        return r

    pl._topk_rows_dist = spy
    try:
        with override(distributed=True, debug_force_offload=True):
            dist = execute(q, db).rows
    finally:
        pl._topk_rows_dist = orig
    assert ran.get("engaged"), "distributed top-k did not engage"
    assert host == dist, (host[:5], dist[:5])


class TestDistNewSurface:
    """Round-5 verdict item 8: the round-4 surface shapes under
    pg_strom.distributed — grouping sets ride the distributed aggregate
    per set (the single-pass rollup intentionally yields to the per-set
    path when distributed, planner._gs_single_pass), and windowed
    queries distribute their INNER stage (the window computation itself
    stays host-side — measured reason in PARITY.md)."""

    @pytest.fixture(scope="class")
    def db(self):
        rng = np.random.default_rng(11)
        n = 4000
        d = Database()
        d.create(Table.from_columns("ds", {
            "a": column_from_values(T.INT4,
                                    [int(v) for v in rng.integers(0, 6, n)]),
            "b": column_from_values(T.INT4,
                                    [int(v) for v in rng.integers(0, 4, n)]),
            "v": column_from_values(T.INT4,
                                    [int(v) for v in
                                     rng.integers(0, 100, n)]),
        }))
        return d

    def test_rollup_engages_mesh(self, db):
        from pg_strom_tpu.sql import parser
        from pg_strom_tpu.plan.planner import plan_query
        q = "select a, b, sum(v), count(*) from ds group by rollup(a, b)"
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True):
            stmt = parser.parse(q)
            pq = plan_query(stmt, db)
            dist = pq.execute()
            assert pq.perfmon.counts.get("dist_steps", 0) >= 1, \
                "rollup subplan did not ride the mesh"
        key = lambda r: tuple((x is None, x) for x in r)
        assert sorted(host, key=key) == sorted(dist, key=key)

    def test_window_inner_engages_mesh(self, db):
        from pg_strom_tpu.sql import parser
        from pg_strom_tpu.plan.planner import plan_query
        # window over a grouped inner: the inner aggregation distributes
        q = ("select a, rank() over (order by s desc) from "
             "(select a, sum(v) s from ds group by a) q")
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True):
            dist = execute(q, db).rows
        assert sorted(host) == sorted(dist)
        # mesh engagement assert on the inner aggregation itself
        with override(distributed=True, debug_force_offload=True):
            stmt = parser.parse("select a, sum(v) s from ds group by a")
            pq = plan_query(stmt, db)
            pq.execute()
            assert pq.perfmon.counts.get("dist_steps", 0) >= 1

    def test_windowed_plain_query_runs_distributed(self, db):
        q = ("select a, sum(v) over (partition by a order by b, v) "
             "from ds where v > 10")
        host = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True):
            dist = execute(q, db).rows
        assert sorted(host) == sorted(dist)


def test_mesh_hosts_gucs_degrade_on_too_few_devices(monkeypatch):
    # round-5 fuzzer find: dist_mesh_hosts=2 with 1 visible device crashed
    # mesh_for_config with reshape(2, 0); the GUC is a layout hint and must
    # degrade to the flat mesh
    import pg_strom_tpu.parallel.mesh as M
    only = jax.devices()[:1]
    monkeypatch.setattr(M, "_devices",
                        lambda n=None: only if n in (None, 1) else only)
    with override(dist_mesh_hosts=2):
        m = M.mesh_for_config()
        assert m.devices.size == 1
    with override(dist_mesh_hosts=3):    # 8 % 3 != 0 also degrades
        monkeypatch.setattr(M, "_devices", lambda n=None: jax.devices())
        m = M.mesh_for_config()
        assert m.devices.ndim == 1
