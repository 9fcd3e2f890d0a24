"""Device-resident columnar chunk cache — the tcache analog.

Reference: deadcode/tcache.c (4107 LoC) — a T-tree columnar cache filled by
background "columnizer" workers so repeated scans skip per-tuple heap
deforming (tcache.c:1-60).  In this engine the datastore is columnar at
rest, so the cost the cache removes is the other half of the same problem:
per-query host slicing/padding and host->HBM transfer.  Chunk planes are
uploaded once and kept resident in HBM, then reused by every later query
over the same columns.

Design:
  - Keyed by the *Column* identities (Column.uid), not the Table: the SQL
    planner re-wraps tables per query (plan/planner.py rename_table) but
    shares the underlying Column objects, so cache hits survive aliasing.
  - LRU eviction bounded by pg_strom.tcache_size_mb (GUC analog of the
    reference's tcache shmem sizing); entries whose Columns were garbage
    collected are swept on access (restrack-style ownership: dropping the
    table releases its device memory).
  - Chunks whose rows need host recheck (numeric outside the device window,
    f64 outside the f32-exponent window) are recorded with planes=None — the
    executor routes them straight to the host-exact path.
  - Tables that would not fit in the budget stream untouched (numpy planes,
    transferred per dispatch) rather than thrash the cache.
  - Auxiliary pytrees (device-resident join hash tables) share the same
    LRU + budget via put_aux/get_aux — the cross-query extension of the
    reference's DMA-hashtable-once pattern (gpuhashjoin.c:4497-4555).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import OrderedDict
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from ..config import config
from ..datastore import Table, Chunk
from ..expr.lower_jax import planes_of_column


def _next_pow2(n: int, lo: int = 1024) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def chunk_capacity(nrows: int) -> int:
    """Canonical chunk capacity for a table: one shared value across the
    scan/join/preagg executors so they share cache entries."""
    return min(config.chunk_rows, _next_pow2(max(nrows, 1)))


def fetch_host(tree):
    """Device->host read of a result pytree: one device_get of the whole
    in-flight tree (it waits for the device), so a drain costs one
    transfer call rather than one per leaf."""
    import jax
    return jax.device_get(tree)


def planes_on_device(planes) -> bool:
    """True when chunk planes are device-resident (cache hit) — the executor
    then need not bound its in-flight window on input-transfer memory."""
    import jax
    return bool(planes) and isinstance(planes[0][0], jax.Array)


@dataclasses.dataclass
class CachedChunk:
    """One resident (or streamed) chunk: static metadata + device planes."""

    table_name: str
    start: int
    nrows: int
    capacity: int
    recheck_any: bool
    planes: Optional[tuple]      # per-column plane tuples; None => host path

    def host_chunk(self, table: Table) -> Chunk:
        """(Re)build the host-side padded chunk, e.g. for CPU replay."""
        return Chunk.from_table(table, self.start, self.start + self.nrows,
                                self.capacity)


@dataclasses.dataclass
class _Entry:
    key: tuple
    table_name: str
    kind: str                    # 'chunks' | 'aux'
    chunks: list[CachedChunk] | None
    aux: Any
    nbytes: int
    col_refs: list               # weakrefs keeping eviction honest
    hits: int = 0
    created: float = dataclasses.field(default_factory=time.monotonic)

    def alive(self) -> bool:
        return all(r() is not None for r in self.col_refs)


def _pytree_nbytes(tree: Any) -> int:
    import jax
    return sum(int(np.prod(l.shape)) * l.dtype.itemsize
               for l in jax.tree_util.tree_leaves(tree)
               if hasattr(l, "dtype"))


class DeviceChunkCache:
    def __init__(self) -> None:
        self._lru: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # concurrent SELECTs are a legitimate serving shape (the reference
        # is a multi-backend DBMS); every LRU mutation holds this lock —
        # chunk UPLOADS intentionally happen outside it (a generator must
        # not hold a lock across yields)
        import threading
        self._mu = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.streamed = 0        # chunks served uncached (budget/disabled)

    # -- accounting ----------------------------------------------------------

    def budget_bytes(self) -> int:
        return int(config.tcache_size_mb) << 20

    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._lru.values())

    def clear(self) -> None:
        with self._mu:
            self._lru.clear()

    def _sweep(self) -> None:
        dead = [k for k, e in self._lru.items() if not e.alive()]
        for k in dead:
            del self._lru[k]

    def _evict_to_fit(self, incoming: int) -> None:
        budget = self.budget_bytes()
        while self._lru and self.total_bytes() + incoming > budget:
            self._lru.popitem(last=False)
            self.evictions += 1

    # -- chunk planes ----------------------------------------------------------

    def chunks_for(self, table: Table, names: Sequence[str], cap: int,
                   pm=None) -> Iterator[CachedChunk]:
        """Yield this table's chunks with device-resident planes when cached.

        Falls back to streaming numpy planes (uploaded per dispatch by jax)
        when the cache is disabled or the table exceeds the byte budget."""
        cols = [table.columns[n] for n in names]
        n = table.nrows
        if n == 0:
            return
        if not (config.enabled and config.enable_tcache):
            yield from self._stream(table, n, cap, pm)
            return

        ids = tuple(c.uid for c in cols)
        if not ids:
            # count(*)-style empty layouts carry no referenced-column uid
            # to key on — key on the table's own column uids (+nrows) so
            # two different tables can never share an entry (round-5
            # fuzzer find: a 12-row recursive worktable's cached chunks
            # served count(*) over a 600-row table)
            ids = ("norows", n) + tuple(
                c.uid for c in table.columns.values())
        key = ("chunks", ids, cap)
        with self._mu:
            self._sweep()
            ent = self._lru.get(key)
            if ent is not None:
                self._lru.move_to_end(key)
                ent.hits += 1
                self.hits += 1
        if ent is not None:
            if pm is not None:
                pm.bump("tcache_hits")
            yield from ent.chunks
            return

        # estimate: padded plane bytes across all chunks
        nchunks = -(-n // cap)
        est = nchunks * cap * sum(
            sum(p.dtype.itemsize for p in planes_of_column(c)) for c in cols)
        if est > self.budget_bytes():
            yield from self._stream(table, n, cap, pm)
            return

        import jax
        self.misses += 1
        if pm is not None:
            pm.bump("tcache_misses")
        chunks: list[CachedChunk] = []
        nbytes = 0
        for start in range(0, n, cap):
            stop = min(start + cap, n)
            hc = Chunk.from_table(table, start, stop, cap)
            if hc.row_recheck.any():
                cc = CachedChunk(table.name, start, stop - start, cap,
                                 True, None)
            else:
                host_planes = tuple(planes_of_column(hc.columns[nm])
                                    for nm in names)
                dev_planes = jax.device_put(host_planes)
                up = sum(p.nbytes for ps in host_planes for p in ps)
                nbytes += up
                if pm is not None:
                    pm.add_bytes("h2d", up)
                cc = CachedChunk(table.name, start, stop - start, cap,
                                 False, dev_planes)
            chunks.append(cc)
            yield cc
        with self._mu:
            self._evict_to_fit(nbytes)
            self._lru[key] = _Entry(key=key, table_name=table.name,
                                    kind="chunks", chunks=chunks, aux=None,
                                    nbytes=nbytes,
                                    col_refs=[weakref.ref(c) for c in cols])

    def _stream(self, table: Table, n: int, cap: int,
                pm=None) -> Iterator[CachedChunk]:
        names = table.column_names
        for start in range(0, n, cap):
            stop = min(start + cap, n)
            hc = Chunk.from_table(table, start, stop, cap)
            self.streamed += 1
            if hc.row_recheck.any():
                yield CachedChunk(table.name, start, stop - start, cap,
                                  True, None)
                continue
            planes = tuple(planes_of_column(hc.columns[nm]) for nm in names)
            if pm is not None:
                pm.add_bytes("h2d", sum(p.nbytes for ps in planes for p in ps))
            yield CachedChunk(table.name, start, stop - start, cap,
                              False, planes)

    # -- auxiliary device pytrees (join hash tables) ---------------------------

    def get_aux(self, key: tuple, pm=None) -> Any:
        with self._mu:
            self._sweep()
            ent = self._lru.get(("aux",) + key)
            if ent is None:
                return None
            self._lru.move_to_end(("aux",) + key)
            ent.hits += 1
            self.hits += 1
        if pm is not None:
            pm.bump("tcache_hits")
        return ent.aux

    def put_aux(self, key: tuple, value: Any, table_name: str,
                cols: Sequence = ()) -> None:
        if not (config.enabled and config.enable_tcache):
            return
        nbytes = _pytree_nbytes(value)
        if nbytes > self.budget_bytes():
            return
        with self._mu:
            self.misses += 1
            self._evict_to_fit(nbytes)
            self._lru[("aux",) + key] = _Entry(
                key=("aux",) + key, table_name=table_name, kind="aux",
                chunks=None, aux=value, nbytes=nbytes,
                col_refs=[weakref.ref(c) for c in cols])

    # -- introspection ----------------------------------------------------------

    def info_rows(self) -> list[dict]:
        with self._mu:
            self._sweep()
            entries = list(self._lru.values())
        rows = []
        for e in entries:
            rows.append({"table_name": e.table_name, "kind": e.kind,
                         "nchunks": len(e.chunks) if e.chunks else 0,
                         "nbytes": e.nbytes, "hits": e.hits})
        return rows


TCACHE = DeviceChunkCache()
