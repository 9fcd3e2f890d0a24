"""Dense and limb-matrix GROUP BY through the real executor vs host-exact.

Every case runs the executor twice — on the CPU's own route, and with the
backend module reporting a GPU, so the GPU's route (its grouped-reduction
formulation and the integer-limb float8 sums) runs here on the CPU — and
compares each result against the pure host tier (offload=False), which is
golden-parity-proven against PostgreSQL."""

from __future__ import annotations

import numpy as np
import pytest

from pg_strom_tpu import T
from pg_strom_tpu.config import override
from pg_strom_tpu.datastore import Table, column_from_values, column_from_numpy
from pg_strom_tpu.expr.ir import ColumnRef, Const, resolve_function, BoolExpr, NullTest
from pg_strom_tpu.ops.preagg import AggInstance, lookup_agg
from pg_strom_tpu.exec.preagg_exec import PreAggExecutor


@pytest.fixture(params=["cpu", "gpu"])
def platform(request):
    """Which platform's route the executor takes (conftest.gpu_route)."""
    if request.param == "gpu":
        request.getfixturevalue("gpu_route")
    return request.param


def _mk_table(n=3000, seed=0, with_nulls=True):
    rng = np.random.default_rng(seed)
    kv = rng.integers(5, 21, n).astype(np.int32)           # dense key 5..20
    x = (rng.random(n).astype(np.float32) - 0.3) * 10.0
    y = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    z = rng.integers(-5000, 5000, n).astype(np.int32)
    if with_nulls:
        kvalid = rng.random(n) > 0.1
        xvalid = rng.random(n) > 0.15
        yvalid = rng.random(n) > 0.2
        zvalid = rng.random(n) > 0.05
    else:
        kvalid = xvalid = yvalid = zvalid = np.ones(n, np.bool_)
    return Table.from_columns("t", {
        "k": column_from_numpy(T.INT4, kv, kvalid),
        "x": column_from_numpy(T.FLOAT4, x, xvalid),
        "y": column_from_numpy(T.INT8, y, yvalid),
        "z": column_from_numpy(T.INT4, z, zvalid),
    })


def _agg(name, col):
    d, fam = lookup_agg(name, (col.type,) if col is not None else ())
    return AggInstance(aggname=name, family=fam, slots=d.slots,
                       args=(col,) if col is not None else ())


def _cols(t):
    names = t.column_names
    return {nm: ColumnRef(type=t.columns[nm].type, name=nm,
                          index=names.index(nm)) for nm in names}


def _run(t, pred, groups, aggs):
    with override(chunk_rows=1 << 11):
        got = PreAggExecutor(t, pred, groups, aggs).run()
    host = PreAggExecutor(t, pred, groups, aggs, offload=False).run()
    key = lambda r: tuple((v is None, v) for v in r[:len(groups)])  # noqa
    got_s, host_s = sorted(got, key=key), sorted(host, key=key)
    assert len(got_s) == len(host_s)
    for rg, rh in zip(got_s, host_s):
        assert len(rg) == len(rh)
        for vg, vh in zip(rg, rh):
            if isinstance(vh, float) and isinstance(vg, float):
                # float aggregates: engine contract is PG text equality at
                # extra_float_digits=-3 (stepwise-f32 host accumulation vs
                # the device's once-rounded exact sum differ in last ulps)
                if vh != vg:
                    assert vg == pytest.approx(vh, rel=1e-5, abs=1e-30,
                                               nan_ok=True), (vg, vh)
            else:
                assert vg == vh, (vg, vh)


def test_flagship_shape(platform):
    t = _mk_table()
    c = _cols(t)
    pred = resolve_function(">", (c["x"], Const(type=T.FLOAT4, value=0.25)))
    _run(t, pred, [c["k"]],
         [_agg("sum", c["x"]), _agg("count", c["x"]), _agg("sum", c["y"])])


def test_no_pred_all_kinds(platform):
    t = _mk_table(seed=1)
    c = _cols(t)
    _run(t, None, [c["k"]],
         [_agg("sum", c["z"]), _agg("stddev", c["z"]), _agg("avg", c["z"]),
          _agg("count", c["y"]), _agg("count", None), _agg("sum", c["x"])])


def test_negative_and_wide_int8(platform):
    vals = [-(1 << 62), (1 << 62) - 7, 0, None, 12345, -987654321]
    keys = [1, 1, 2, 2, 3, 3]
    t = Table.from_columns("w", {
        "k": column_from_values(T.INT4, keys),
        "y": column_from_values(T.INT8, vals),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["y"]), _agg("count", c["y"])])


def test_int8_narrow_range_large_offset(platform):
    rng = np.random.default_rng(3)
    n = 2000
    t = Table.from_columns("nr", {
        "k": column_from_numpy(T.INT4, rng.integers(0, 4, n).astype(np.int32)),
        "y": column_from_numpy(T.INT8, (rng.integers(0, 200, n)
                                        + 10**15).astype(np.int64)),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["y"])])


def test_pred_3vl_and_nulltest(platform):
    t = _mk_table(seed=2)
    c = _cols(t)
    lt = resolve_function("<", (c["z"], Const(type=T.INT4, value=1000)))
    nn = NullTest(type=T.BOOL, arg=c["y"], isnull=False)
    pred = BoolExpr(type=T.BOOL, op="and", args=(lt, nn))
    _run(t, pred, [c["k"]], [_agg("sum", c["z"]), _agg("count", None)])


def test_float_nan_replays_exactly(platform):
    """NaN in a float4 sum rides the fabs shadow to a host replay — result
    must still match the host tier bit-for-bit."""
    t = Table.from_columns("nan", {
        "k": column_from_values(T.INT4, [1, 1, 2, 2]),
        "x": column_from_values(T.FLOAT4, [1.5, float("nan"), 2.5, 3.0]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["x"])])


def test_computed_arg_and_two_keys(platform):
    t = _mk_table(seed=4)
    c = _cols(t)
    plus = resolve_function("+", (c["z"], Const(type=T.INT4, value=1)))
    _run(t, None, [c["k"]], [_agg("sum", plus)])
    _run(t, None, [c["k"], c["z"]], [_agg("count", None)])


def test_sparse_key(platform):
    """Key range beyond the dense window: dense_fail re-dispatches the
    generic limb-matrix strategy."""
    t = Table.from_columns("sp", {
        "k": column_from_values(T.INT4, [0, 10**9, 5]),
        "y": column_from_values(T.INT8, [1, 2, 3]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["y"])])


def test_all_null_key_column(platform):
    t = Table.from_columns("an", {
        "k": column_from_values(T.INT4, [None, None, None]),
        "y": column_from_values(T.INT8, [7, 8, None]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["y"]), _agg("count", c["y"])])


def test_nullfree_columns(platform):
    t = _mk_table(with_nulls=False)
    c = _cols(t)
    _run(t, None, [c["k"]],
         [_agg("sum", c["x"]), _agg("count", c["x"]), _agg("sum", c["y"])])


def test_sum_count_avg_same_column(platform):
    t = _mk_table()
    c = _cols(t)
    _run(t, None, [c["k"]],
         [_agg("sum", c["x"]), _agg("count", c["x"]), _agg("avg", c["x"])])


def test_f4_narrow_magnitudes_exact(platform):
    """Floats spanning [0.5, 8): the signed-digit sum is the EXACT sum."""
    rng = np.random.default_rng(7)
    n = 4000
    x = (rng.random(n).astype(np.float32) * 7.5 + 0.5).astype(np.float32)
    t = Table.from_columns("w", {
        "k": column_from_numpy(T.INT4, rng.integers(0, 8, n).astype(np.int32)),
        "x": column_from_numpy(T.FLOAT4, x),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["x"])])


def test_f4_all_zero_column(platform):
    t = Table.from_columns("z0", {
        "k": column_from_values(T.INT4, [1, 1, 2]),
        "x": column_from_values(T.FLOAT4, [0.0, -0.0, 0.0]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["x"])])


def test_f4_inf(platform):
    t = Table.from_columns("inf", {
        "k": column_from_values(T.INT4, [1, 1, 2, 2]),
        "x": column_from_values(T.FLOAT4, [1.0, float("inf"), 2.0, 3.0]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["x"])])


def test_f4_nan_group(platform):
    t = Table.from_columns("nans", {
        "k": column_from_values(T.INT4, [1, 2]),
        "x": column_from_values(T.FLOAT4, [1.0, float("nan")]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["x"])])


def test_f4_denormal_spread(platform):
    """1e30 beside a denormal: truncation below 2^(E-72), PG-text
    invisible."""
    t = Table.from_columns("dn", {
        "k": column_from_values(T.INT4, [1, 1]),
        "x": column_from_values(T.FLOAT4, [1.0e30, 1.0e-40]),
    })
    c = _cols(t)
    _run(t, None, [c["k"]], [_agg("sum", c["x"])])


def test_float8_sums_and_stddev(platform):
    """float8 sum/stddev: f64 segment sums on the CPU route, integer-limb
    double-float blocks on the GPU's."""
    rng = np.random.default_rng(8)
    n = 3000
    t = Table.from_columns("f8", {
        "k": column_from_numpy(T.INT4, rng.integers(0, 6, n).astype(np.int32)),
        "x": column_from_numpy(T.FLOAT8, (rng.random(n) - 0.5) * 1e6,
                               rng.random(n) > 0.1),
    })
    c = _cols(t)
    _run(t, None, [c["k"]],
         [_agg("sum", c["x"]), _agg("avg", c["x"]), _agg("stddev", c["x"])])


def test_text_dict_key(platform):
    t = Table.from_columns("tx", {
        "s": column_from_values(T.TEXT, ["b", "a", "b", None, "c"] * 40),
        "z": column_from_values(T.INT4, list(range(200))),
    })
    c = _cols(t)
    _run(t, None, [c["s"]], [_agg("sum", c["z"]), _agg("min", c["z"])])
    _run(t, None, [c["s"]], [_agg("sum", c["z"])])
