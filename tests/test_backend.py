"""The backend module, the compile-cache location, the entry points'
refusal to switch platforms, and the GPU's route run on the CPU.

The GPU's route (conftest.gpu_route) runs the flagship, agg_group, rollup
and join_agg shapes through the GPU's grouped-reduction formulation and its
integer-limb float8 sums, and every result must equal the host-exact tier
(pg_strom.enabled = off) character for character at extra_float_digits=-3.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax
import pytest

from pg_strom_tpu import backend
from pg_strom_tpu.utils import devprog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# backend module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plat", ["cpu", "gpu"])
def test_known_platforms(monkeypatch, plat):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    assert backend.platform() == plat
    for G in (8, 128, 512, 4096):
        r = backend.grouped_reduce_route(G)
        assert r in backend.GROUPED_REDUCE_ROUTES
        # the one-hot dot only where it was measured to win: few buckets
        assert r == ("onehot_dot" if plat == "gpu" and G <= 128
                     else "segment_sum")
    assert backend.f64_limb_sums() is (plat == "gpu")
    assert backend.async_program_builds() is (plat == "gpu")


@pytest.mark.parametrize("plat", ["tpu", "rocm", "METAL"])
def test_unknown_platform_raises_with_its_name(monkeypatch, plat):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    for question in (backend.platform, lambda: backend.grouped_reduce_route(8),
                     backend.f64_limb_sums, backend.async_program_builds):
        with pytest.raises(RuntimeError, match=repr(plat)):
            question()


def test_tiered_capacity_engages_only_on_gpu(monkeypatch):
    """The async-build tier is the backend's decision: on the GPU a big
    program that is not built within the parking window sends the query
    to the small tier."""
    from pg_strom_tpu.config import override
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(devprog, "DEVPROG", devprog.ProgramBuilder())
    with override(devprog_async_build=True, chunk_rows_cold=1 << 10,
                  devprog_build_wait_ms=0):
        # fn=None: the background build fails, which the tier reports as
        # not ready
        assert devprog.tiered_capacity(1 << 20, ("k",), None, ()) == 1 << 10


# ---------------------------------------------------------------------------
# compile cache location
# ---------------------------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert devprog.compile_cache_dir() == str(tmp_path / "cc")
    before = jax.config.jax_compilation_cache_dir
    # the variable names the directory: the engine sets nothing itself
    assert devprog.init_compilation_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "cc").exists()


def test_compile_cache_default_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(devprog, "_primary_platform", lambda: "cuda")
    d = devprog.compile_cache_dir()
    assert d == os.path.join(ROOT, ".jax_cache")
    assert ".jax_cache" in open(os.path.join(ROOT, ".gitignore")).read()


def test_compile_cache_off_in_cpu_primary_process(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(devprog, "_primary_platform", lambda: "cpu")
    assert devprog.compile_cache_dir() is None
    assert devprog.init_compilation_cache() is None


# ---------------------------------------------------------------------------
# entry points never switch platform on their own
# ---------------------------------------------------------------------------

def test_dryrun_multichip_fails_without_enough_devices():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        ge.dryrun_multichip(n)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(ValueError, match="platform"):
        ge.dryrun_multichip(2, platform="gpu")


def _run_smoke(cwd: str, script: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _chip_smoke_module():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("scale_exp,signed", [(0, False), (2, False),
                                              (30, True), (300, True)])
def test_chip_smoke_exact_sums_match_fsum(scale_exp, signed):
    """The smoke's numpy reference sums float8 exactly (math.fsum is the
    exactly rounded sum), over any magnitudes and signs."""
    import math
    import numpy as np
    cs = _chip_smoke_module()
    rng = np.random.default_rng(scale_exp)
    n, G = 4000, 9
    v = rng.random(n) * 10.0 ** rng.integers(-scale_exp, scale_exp + 1, n)
    if signed:
        v *= rng.choice([-1.0, 1.0], n)
    g = rng.integers(0, G, n)
    rows = rng.random(n) < 0.7
    es = cs.ExactSums(v)
    assert es.sums() == [math.fsum(v.tolist())]
    got = es.sums(rows=rows, groups=g, G=G)
    for k in range(G):
        assert got[k] == math.fsum(v[rows & (g == k)].tolist())


def test_chip_smoke_bound_texts():
    """A sum cell may print any text within the engine's bound of the
    exact sum; at 12 digits that is the exact text or its neighbour."""
    cs = _chip_smoke_module()
    tol = cs.sum_tolerance(1 << 18)
    assert 2.0 ** -47 < tol < 1e-13
    assert cs._within_bound_texts(328760.4254955, tol) == {
        "328760.425495", "328760.425496"}
    assert cs._within_bound_texts(0.5, tol) == {"0.5"}
    assert cs._pg_text(None) == "" and cs._pg_text(7) == "7"


def test_chip_smoke_fails_alone(tmp_path):
    """A directory with chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# ---------------------------------------------------------------------------
# the GPU's route, run on the CPU, against the host-exact tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def testdb():
    from pg_strom_tpu.datastore import Database
    from pg_strom_tpu.models.testdb import build_testdb
    db = Database()
    build_testdb(db, fact_rows=6000, dim_rows=500, seed=3)
    return db


@pytest.mark.parametrize("name", ["agg_group", "rollup", "join_agg",
                                  "star_group"])
def test_gpu_route_testdb_matches_host(gpu_route, testdb, name):
    from pg_strom_tpu.models.testdb import BENCH_QUERIES
    from pg_strom_tpu.sql import execute
    sql = BENCH_QUERIES[name]
    dev = execute(sql, testdb).formatted(-3)
    execute("set pg_strom.enabled = off", testdb)
    try:
        host = execute(sql, testdb).formatted(-3)
    finally:
        execute("set pg_strom.enabled = on", testdb)
    if name == "rollup":                  # no ORDER BY
        dev, host = sorted(dev), sorted(host)
    assert dev == host


def test_gpu_route_flagship_matches_host(gpu_route):
    """The flagship shape: int4 key (30 values), float4 x, int8 y,
    WHERE x > 0.25 — sum(x), count(x), sum(y)."""
    import numpy as np
    from pg_strom_tpu import T
    from pg_strom_tpu.datastore import Database, Table, column_from_numpy
    from pg_strom_tpu.sql import execute
    rng = np.random.default_rng(5)
    n = 5000
    db = Database()
    db.create(Table.from_columns("f", {
        "key": column_from_numpy(T.INT4, rng.integers(0, 30, n)
                                 .astype(np.int32)),
        "x": column_from_numpy(T.FLOAT4, rng.random(n).astype(np.float32),
                               rng.random(n) > 0.05),
        "y": column_from_numpy(T.INT8, rng.integers(0, 1 << 40, n),
                               rng.random(n) > 0.05)}))
    sql = ("select key, sum(x), count(x), sum(y) from f where x > 0.25 "
           "group by key order by key")
    dev = execute(sql, db).formatted(-3)
    execute("set pg_strom.enabled = off", db)
    try:
        host = execute(sql, db).formatted(-3)
    finally:
        execute("set pg_strom.enabled = on", db)
    assert dev == host and len(dev) == 30


@pytest.mark.parametrize("n,G", [(1, 4), (1000, 7), (4096, 128),
                                 (10000, 1024)])
def test_ordered_segment_sum_matches_segment_sum(rng, n, G):
    """The GPU's float segment sum (sorted, fixed-tree segmented scan)
    equals the scatter-add up to float rounding; ids == G are dropped."""
    import numpy as np
    import jax.numpy as jnp
    from pg_strom_tpu.ops.preagg import _ordered_segment_sum
    v = rng.standard_normal(n) * 1e3
    s = rng.integers(0, G + 1, n).astype(np.int32)
    got = np.asarray(jax.jit(_ordered_segment_sum, static_argnums=2)(
        jnp.asarray(v), jnp.asarray(s), G))
    want = np.zeros(G)
    np.add.at(want, s[s < G], v[s < G])
    # a few ulps of the group's absolute mass: both sum the same terms in
    # different orders
    mass = np.zeros(G)
    np.add.at(mass, s[s < G], np.abs(v[s < G]))
    assert np.all(np.abs(got - want) <= 1e-13 * np.maximum(mass, 1.0))


@pytest.mark.parametrize("name", ["agg_group", "star_group"])
def test_gpu_route_distributed_matches_host(gpu_route, testdb, name):
    """pg_strom.distributed on the virtual CPU mesh, through the GPU's
    route (its float segment sums are the ordered ones)."""
    from pg_strom_tpu.config import override
    from pg_strom_tpu.models.testdb import BENCH_QUERIES
    from pg_strom_tpu.sql import execute
    sql = BENCH_QUERIES[name]
    with override(distributed=True):
        dev = execute(sql, testdb).formatted(-3)
        again = execute(sql, testdb).formatted(-3)
    execute("set pg_strom.enabled = off", testdb)
    try:
        host = execute(sql, testdb).formatted(-3)
    finally:
        execute("set pg_strom.enabled = on", testdb)
    assert dev == again == host
