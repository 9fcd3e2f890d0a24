"""Columnar data store.

Replacement for the reference's kern_data_store / datastore.c (three
row-ish layouts over 8KB heap pages, opencl_common.h:276-434).  For XLA the
native data model is struct-of-arrays, so the store IS columnar:

  Column      — host-resident planes (data / valid / extra numeric planes /
                string dictionary), append-friendly.
  Table       — named columns + row count, plus the fixture loaders that
                replace testdb.sql / agg_init.sql.
  Chunk       — a fixed-capacity slice of a table, padded to a static shape
                (XLA wants static shapes), carrying nrows + per-row recheck
                flags.  The analog of one pgstrom_data_store (~15MB chunk,
                main.c:132-141); produced by Table.chunks() for the streaming
                executor (gpuscan.c:1065-1163 async window analog).

Text columns are dictionary-encoded with a bytewise-sorted dictionary, so
device int32 code comparisons implement C-collation strcmp (the only collation
the reference allows on device, codegen.c:152-164).
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Iterator, Sequence

import numpy as np

from .config import config
from .sqltypes import (
    T, STORAGE_DTYPE, INT_BOUNDS, numeric_from_decimal, numeric_to_decimal,
)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _chunk_plane(n: int, dtype) -> np.ndarray:
    """Zeroed plane for a padded query chunk, allocated from the tracked
    native arena when available (the reference allocates every data store
    from shmem — shmem.c/datastore.c; small planes ride the slab tier,
    large ones the buddy tier, and the arena's magic/redzone guards verify
    on release).  Falls back to plain numpy when the native library is
    absent or the arena is full — capacity never blocks a query."""
    try:
        from .native import arena_ndarray
        return arena_ndarray(n, dtype)
    except Exception:
        return np.zeros(n, dtype=dtype)


_COL_UID = iter(range(1, 1 << 62))


@dataclasses.dataclass
class Column:
    """One column: host planes. data under NULL lanes is 0.

    Columns are immutable once built (loaders construct, executors read);
    `uid` identifies the column contents for the device chunk cache
    (exec/devcache.py) and stays stable across planner aliasing, which
    re-wraps Tables but shares Column objects.  Code that mutates planes
    in place must assign a fresh uid (`next_column_uid()`)."""

    type: T
    data: np.ndarray                       # primary plane (see STORAGE_DTYPE)
    valid: np.ndarray                      # bool
    # numeric extra planes
    num_exp: np.ndarray | None = None      # int32, value = mant * 10**exp
    num_dscale: np.ndarray | None = None   # int32 display scale
    recheck: np.ndarray | None = None      # bool: device can't represent row
    # string dictionary (sorted, code -> bytes); shared per column
    dictionary: list[str] | None = None
    uid: int = dataclasses.field(default_factory=lambda: next(_COL_UID))

    def __len__(self) -> int:
        return len(self.data)

    def nrows(self) -> int:
        return len(self.data)

    def get(self, i: int) -> Any:
        """Exact python value of row i (None when NULL)."""
        if not self.valid[i]:
            return None
        t = self.type
        if t is T.NUMERIC:
            return numeric_to_decimal(
                int(self.data[i]), int(self.num_exp[i]), int(self.num_dscale[i])
            ) if not self.recheck[i] else self._exact[i]
        if t in (T.TEXT, T.BPCHAR):
            return self.dictionary[int(self.data[i])]
        if t is T.BOOL:
            return bool(self.data[i])
        if t in (T.FLOAT4, T.FLOAT8):
            return float(self.data[i])
        return int(self.data[i])

    # exact-value side store for numeric rows outside the device window
    @property
    def _exact(self) -> dict[int, Decimal]:
        if not hasattr(self, "_exact_store"):
            self._exact_store: dict[int, Decimal] = {}
        return self._exact_store


def column_from_values(t: T, values: Sequence[Any]) -> Column:
    """Build a Column from python values (None = NULL). Exact semantics."""
    n = len(values)
    dt = STORAGE_DTYPE[t]
    data = np.zeros(n, dtype=dt)
    valid = np.zeros(n, dtype=np.bool_)
    col = Column(type=t, data=data, valid=valid)

    if t is T.NUMERIC:
        col.num_exp = np.zeros(n, dtype=np.int32)
        col.num_dscale = np.zeros(n, dtype=np.int32)
        col.recheck = np.zeros(n, dtype=np.bool_)
        for i, v in enumerate(values):
            if v is None:
                continue
            valid[i] = True
            d = v if isinstance(v, Decimal) else Decimal(v)
            mant, exp, dscale, ok = numeric_from_decimal(d)
            if ok:
                data[i] = mant
                col.num_exp[i] = exp
                col.num_dscale[i] = dscale
            else:
                col.recheck[i] = True
                col.num_dscale[i] = dscale
                col._exact[i] = d
        return col

    if t in (T.TEXT, T.BPCHAR):
        # order-preserving dictionary: sorted bytewise (C collation)
        present = sorted({v for v in values if v is not None})
        codes = {s: i for i, s in enumerate(present)}
        col.dictionary = present
        for i, v in enumerate(values):
            if v is None:
                continue
            valid[i] = True
            data[i] = codes[v]
        return col

    for i, v in enumerate(values):
        if v is None:
            continue
        valid[i] = True
        if t in INT_BOUNDS:
            iv = int(v)
            lo, hi = INT_BOUNDS[t]
            if not (lo <= iv <= hi):
                raise OverflowError(f"{t.value} out of range: {iv}")
            data[i] = iv
        elif t is T.BOOL:
            data[i] = bool(v)
        else:
            data[i] = v
    return col


def column_from_values_fast(t: T, values: Sequence[Any]) -> Column:
    """column_from_values with numpy bulk paths for the fixed-width
    types (int/float/bool/date/time/timestamp): one fromiter for data,
    one for validity, a vectorized range check — ~10x on megarow
    query-result materialization (round 5: FROM-subquery and worktable
    rebuilds were the dominant cost of windowed/recursive pipelines).
    Text/numeric keep the exact per-value path."""
    n = len(values)
    if n < 1024 or t in (T.TEXT, T.BPCHAR, T.NUMERIC):
        return column_from_values(t, values)
    if t in (T.FLOAT4, T.FLOAT8):
        try:
            data = np.fromiter((0.0 if v is None else v for v in values),
                               np.float64, n)
        except TypeError:
            return column_from_values(t, values)
        valid = np.fromiter((v is not None for v in values), np.bool_, n)
        return column_from_numpy(t, data, valid)
    try:
        data = np.fromiter((0 if v is None else v for v in values),
                           np.int64, n)
    except (TypeError, OverflowError, ValueError):
        return column_from_values(t, values)
    valid = np.fromiter((v is not None for v in values), np.bool_, n)
    if t in INT_BOUNDS:
        lo, hi = INT_BOUNDS[t]
        live = data[valid]
        if len(live) and (live.min() < lo or live.max() > hi):
            return column_from_values(t, values)   # exact error surface
    return column_from_numpy(t, data, valid)


def column_from_numpy(t: T, arr: np.ndarray, valid: np.ndarray | None = None) -> Column:
    dt = STORAGE_DTYPE[t]
    data = np.ascontiguousarray(arr, dtype=dt)
    if valid is None:
        valid = np.ones(len(data), dtype=np.bool_)
    else:
        valid = np.ascontiguousarray(valid, dtype=np.bool_)
        data = np.where(valid, data, np.zeros((), dtype=dt))
    col = Column(type=t, data=data, valid=valid)
    if t is T.NUMERIC:
        col.num_exp = np.zeros(len(data), dtype=np.int32)
        col.num_dscale = np.zeros(len(data), dtype=np.int32)
        col.recheck = np.zeros(len(data), dtype=np.bool_)
    return col


def next_column_uid() -> int:
    """Fresh identity for a Column whose planes were mutated in place."""
    return next(_COL_UID)


def column_gather(col: Column, ii: np.ndarray,
                  extra_valid: np.ndarray | None = None) -> Column:
    """col at row indexes ii as a new Column, pure plane gathers (the
    text dictionary is shared, numeric side-planes ride along).
    extra_valid (aligned with ii) is AND'd into validity — masked slots
    read as NULL regardless of the source row.  An identity gather with
    no mask returns col itself (same uid, so the device chunk cache
    keeps serving the resident buffers)."""
    n0 = len(col.data)
    if extra_valid is None and len(ii) == n0 and \
            (n0 == 0 or (ii[0] == 0 and ii[-1] == n0 - 1
                         and np.array_equal(ii, np.arange(n0)))):
        return col
    valid = col.valid[ii]
    if extra_valid is not None:
        valid = valid & extra_valid
    data = np.where(valid, col.data[ii], np.zeros((), col.data.dtype))
    out = Column(type=col.type, data=data, valid=valid,
                 dictionary=col.dictionary)
    if col.num_exp is not None:
        out.num_exp = np.where(valid, col.num_exp[ii], np.int32(0))
        out.num_dscale = np.where(valid, col.num_dscale[ii], np.int32(0))
        rc = col.recheck[ii] & valid
        out.recheck = rc
        if rc.any():
            for newpos in np.flatnonzero(rc):
                out._exact[int(newpos)] = col._exact[int(ii[int(newpos)])]
    return out


def column_scatter(col: Column, hit: np.ndarray, sub: Column) -> Column:
    """col with rows `hit` replaced by sub's rows (len(sub) == len(hit)):
    the plane-level UPDATE primitive.  Text dictionaries merge
    order-preservingly (both sides' codes remap through the union
    dictionary in one vectorized pass)."""
    t = col.type
    if t in (T.TEXT, T.BPCHAR):
        od = col.dictionary or []
        sd = sub.dictionary or []
        merged = sorted(set(od) | set(sd))
        code = {s: i for i, s in enumerate(merged)}
        data = np.zeros(len(col.data), dtype=col.data.dtype)
        if od:
            omap = np.asarray([code[s] for s in od], dtype=col.data.dtype)
            data = omap[col.data]
        if sd:
            smap = np.asarray([code[s] for s in sd], dtype=col.data.dtype)
            data[hit] = smap[sub.data]
        else:
            data[hit] = 0
        valid = col.valid.copy()
        valid[hit] = sub.valid
        data = np.where(valid, data, np.zeros((), data.dtype))
        return Column(type=t, data=data, valid=valid,
                      dictionary=merged or None)
    data = col.data.copy()
    data[hit] = sub.data
    valid = col.valid.copy()
    valid[hit] = sub.valid
    out = Column(type=t, data=data, valid=valid)
    if col.num_exp is not None:
        out.num_exp = col.num_exp.copy()
        out.num_exp[hit] = sub.num_exp
        out.num_dscale = col.num_dscale.copy()
        out.num_dscale[hit] = sub.num_dscale
        out.recheck = col.recheck.copy()
        out.recheck[hit] = sub.recheck
        if out.recheck.any():
            hitmask = np.zeros(len(col.data), dtype=np.bool_)
            hitmask[hit] = True
            for i, v in col._exact.items():
                if not hitmask[i]:
                    out._exact[i] = v
            if sub.recheck.any():
                for j in np.flatnonzero(sub.recheck):
                    out._exact[int(hit[int(j)])] = sub._exact[int(j)]
    return out


# ---------------------------------------------------------------------------
# column statistics — the ANALYZE analog.
#
# The reference leans on PostgreSQL's pg_statistic for its cost model
# (cost_gpuhashjoin/gpupreagg consume baserel rows/selectivity the DBMS
# computed).  This engine owns its datastore, so statistics are exact where
# cheap (min/max/null_count: one vectorized pass) and sampled where not
# (ndistinct: the Duj1 / Haas-Stokes estimator PostgreSQL's ANALYZE uses).
# Consumers: plan/cost.py (group-count and join-selectivity estimates) and
# the fused preagg kernel (range-compressed integer limbs: a column whose
# [min, max] span fits fewer 8-bit limbs builds a narrower V matrix).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColumnStats:
    nrows: int
    null_count: int
    min_val: Any = None          # python int/float over valid rows
    max_val: Any = None
    ndistinct: float | None = None   # distinct non-null values (maybe est.)
    exact_ndistinct: bool = False
    has_nan: bool = False        # float lanes: NaN present among valid rows

    @property
    def n_valid(self) -> int:
        return self.nrows - self.null_count


_NDISTINCT_EXACT_MAX = 1 << 22   # np.unique up to 4M rows (~100ms)
_NDISTINCT_SAMPLE = 1 << 16


def _estimate_ndistinct(vals: np.ndarray, uid: int) -> tuple[float, bool]:
    """Distinct-count estimate: exact for small columns, else the Duj1
    (Haas–Stokes) estimator over a uniform sample — the same estimator
    PostgreSQL ANALYZE applies (analyze.c compute_distinct_stats)."""
    n_total = len(vals)
    if n_total <= _NDISTINCT_EXACT_MAX:
        return float(len(np.unique(vals))), True
    rng = np.random.default_rng(uid & 0xFFFFFFFF)   # deterministic per version
    # with-replacement draw: choice(replace=False) materializes an O(N)
    # permutation; at 64k of many millions the difference is negligible
    idx = rng.integers(0, n_total, size=_NDISTINCT_SAMPLE)
    sample = vals[idx]
    uniq, counts = np.unique(sample, return_counts=True)
    d = len(uniq)
    f1 = int((counts == 1).sum())
    n = len(sample)
    if f1 == n:
        # every sampled value unique: assume the column is (nearly) unique
        return float(n_total), False
    # Duj1: d / (1 - f1/n + f1/N * ...) — PostgreSQL's form:
    #   stadistinct = n*d / (n - f1 + f1*n/N)
    denom = n - f1 + f1 * (n / n_total)
    est = n * d / max(denom, 1e-9)
    return float(min(max(est, d), n_total)), False


def column_stats(col: Column) -> ColumnStats:
    """Lazy per-column statistics, cached on the Column (columns are
    immutable; a mutated column gets a fresh object/uid, dropping the
    cache)."""
    st = getattr(col, "_stats_store", None)
    if st is not None:
        return st
    n = len(col.data)
    nulls = int(n - np.count_nonzero(col.valid))
    mn = mx = None
    nd = None
    exact = False
    has_nan = False
    t = col.type
    if n - nulls > 0 and t is not T.NUMERIC:
        vals = col.data[col.valid] if nulls else col.data
        if t in (T.FLOAT4, T.FLOAT8):
            nanmask = np.isnan(vals)
            has_nan = bool(nanmask.any())
            finite = vals[~nanmask] if has_nan else vals
            if len(finite):
                mn = float(finite.min())
                mx = float(finite.max())
        elif t is T.BOOL:
            mn = int(vals.min())
            mx = int(vals.max())
        else:
            mn = int(vals.min())
            mx = int(vals.max())
        if t in (T.TEXT, T.BPCHAR) and col.dictionary is not None:
            nd, exact = float(len(col.dictionary)), True
        else:
            nd, exact = _estimate_ndistinct(vals, col.uid)
    elif n - nulls > 0 and t is T.NUMERIC:
        # distinct of (mantissa, exponent) pairs via a 64-bit mix (display
        # scale does not affect equality; hash collisions are negligible
        # for an estimate)
        with np.errstate(over="ignore"):
            vals = (col.data[col.valid].astype(np.int64)
                    * np.int64(-7046029254386353131)
                    + col.num_exp[col.valid].astype(np.int64))
        nd, exact = _estimate_ndistinct(vals, col.uid)
    st = ColumnStats(nrows=n, null_count=nulls, min_val=mn, max_val=mx,
                     ndistinct=nd, exact_ndistinct=exact, has_nan=has_nan)
    col._stats_store = st
    return st


@dataclasses.dataclass
class Table:
    """Host table: ordered named columns, equal length."""

    name: str
    columns: dict[str, Column]

    @property
    def nrows(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).nrows()

    @property
    def column_names(self) -> list[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> Column:
        if name not in self.columns:
            raise KeyError(f'column "{name}" does not exist')
        return self.columns[name]

    def row(self, i: int) -> dict[str, Any]:
        return {k: c.get(i) for k, c in self.columns.items()}

    def chunks(self, chunk_rows: int | None = None) -> Iterator["Chunk"]:
        """Stream fixed-capacity chunks (the 15MB-chunk analog).  The last
        chunk is padded to the same static capacity so XLA compiles once."""
        cap = chunk_rows or config.chunk_rows
        n = self.nrows
        if n == 0:
            return
        for start in range(0, n, cap):
            stop = min(start + cap, n)
            yield Chunk.from_table(self, start, stop, cap)

    @staticmethod
    def from_columns(name: str, cols: dict[str, Column]) -> "Table":
        lens = {len(c) for c in cols.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns in table {name}: {lens}")
        return Table(name=name, columns=dict(cols))


@dataclasses.dataclass
class Chunk:
    """A padded, fixed-capacity columnar slice ready for device transfer.

    Equivalent of one pgstrom_data_store message payload.  `nrows` <= capacity;
    rows beyond nrows have valid=False in every column.  `row_recheck` marks
    rows the device cannot evaluate exactly (numeric out of window); the
    executor routes them to the host-exact path (CpuReCheck analog)."""

    table_name: str
    start: int                  # global row offset of this chunk
    nrows: int
    capacity: int
    columns: dict[str, Column]
    row_recheck: np.ndarray     # bool[capacity]

    @staticmethod
    def from_table(tbl: Table, start: int, stop: int, cap: int) -> "Chunk":
        n = stop - start
        out: dict[str, Column] = {}
        recheck = np.zeros(cap, dtype=np.bool_)
        for name, c in tbl.columns.items():
            data = _chunk_plane(cap, c.data.dtype)
            valid = _chunk_plane(cap, np.bool_)
            data[:n] = c.data[start:stop]
            valid[:n] = c.valid[start:stop]
            cc = Column(type=c.type, data=data, valid=valid,
                        dictionary=c.dictionary)
            if c.type is T.FLOAT8:
                # the device encodes f64 sums as f32 head/tail digit blocks
                # (ops/preagg_mxu.py), whose exponent range is f32's; route
                # out-of-window rows to the host-exact path (same CpuReCheck
                # mechanism the reference uses for unrepresentable
                # numerics, opencl_numeric.h)
                a = np.abs(data[:n])
                recheck[:n] |= valid[:n] & ((a > 1e37) | ((a != 0) & (a < 1e-37)))
            if c.type is T.NUMERIC:
                cc.num_exp = np.zeros(cap, dtype=np.int32)
                cc.num_dscale = np.zeros(cap, dtype=np.int32)
                cc.recheck = np.zeros(cap, dtype=np.bool_)
                cc.num_exp[:n] = c.num_exp[start:stop]
                cc.num_dscale[:n] = c.num_dscale[start:stop]
                cc.recheck[:n] = c.recheck[start:stop]
                recheck[:n] |= cc.recheck[:n]
                if cc.recheck.any():
                    # carry the exact-value side store for out-of-window rows
                    src = c._exact
                    for gi in np.flatnonzero(cc.recheck[:n]):
                        cc._exact[int(gi)] = src[start + int(gi)]
            out[name] = cc
        return Chunk(table_name=tbl.name, start=start, nrows=n, capacity=cap,
                     columns=out, row_recheck=recheck)

    def device_arrays(self) -> dict[str, Any]:
        """Flat dict of ndarray planes for jax transfer: name -> plane."""
        planes: dict[str, Any] = {}
        for name, c in self.columns.items():
            planes[f"{name}.data"] = c.data
            planes[f"{name}.valid"] = c.valid
            if c.type is T.NUMERIC:
                planes[f"{name}.exp"] = c.num_exp
                planes[f"{name}.dscale"] = c.num_dscale
        planes["__nrows__"] = np.int32(self.nrows)
        planes["__recheck__"] = self.row_recheck
        return planes


# ---------------------------------------------------------------------------
# Catalog: a tiny in-memory database of named tables
# ---------------------------------------------------------------------------

class Database:
    def __init__(self) -> None:
        self.tables: dict[str, Table] = {}

    def create(self, tbl: Table, replace: bool = True) -> None:
        if not replace and tbl.name in self.tables:
            raise KeyError(f'relation "{tbl.name}" already exists')
        self.tables[tbl.name] = tbl

    def drop(self, name: str, missing_ok: bool = True) -> None:
        if name in self.tables:
            del self.tables[name]
        elif not missing_ok:
            raise KeyError(f'table "{name}" does not exist')

    def get(self, name: str) -> Table:
        if name not in self.tables:
            if name.startswith("pgstrom_"):
                # introspection virtual tables (reference SRF analog)
                from .utils.introspect import virtual_table
                vt = virtual_table(name)
                if vt is not None:
                    return vt
            raise KeyError(f'relation "{name}" does not exist')
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables
