"""Streaming scan executor: device filter + row materialization.

The GpuScan execution path (reference §3.3): chunked load -> device qual
kernel -> compacted row indexes -> materialize matching rows.  Chunks whose
error lane fires are replayed with exact host predicate evaluation
(gpuscan_next_tuple negative-rindex CPU recheck analog, gpuscan.c:999-1056).
Chunk planes come from the device-resident cache (exec/devcache.py, the
tcache analog) so repeated scans skip host slicing and re-upload.
"""

from __future__ import annotations

import collections
from typing import Any, Optional, Sequence

import numpy as np
import jax

from ..config import config
from ..datastore import Table, Chunk
from ..expr.ir import Expr
from ..expr.catalog import device_expression_supported
from ..expr.eval_cpu import eval_expr_cpu
from ..expr.lower_jax import schema_from_chunk_columns, planes_of_column
from ..ops.filter import build_filter_mask_fn, unpack_maskbits
from .devcache import TCACHE, CachedChunk, chunk_capacity, planes_on_device, fetch_host
from ..utils.perfmon import Perfmon

_JIT_CACHE: dict[Any, Any] = {}



class ScanExecutor:
    """Yields global row indexes (int64 ndarray) of `table` rows passing
    `pred` (None = all).  Kept as numpy end to end — consumers gather with
    it directly; a python int list at megarow scale costs ~1s alone."""

    def __init__(self, table: Table, pred: Optional[Expr],
                 perfmon: Perfmon | None = None, offload: bool = True):
        self.table = table
        self.pred = pred
        self.perfmon = perfmon or Perfmon()
        # cost-model verdict from the planner (plan/cost.py): False routes
        # this scan to the host tier (cost_gpuscan loses, gpuscan.c:101-231)
        self.offload = offload

    def row_indexes(self) -> np.ndarray:
        t = self.table
        if t.nrows == 0:
            return np.empty(0, np.int64)
        if self.pred is None:
            return np.arange(t.nrows, dtype=np.int64)
        use_device = (config.enabled and config.enable_tpuscan
                      and self.offload
                      and device_expression_supported(self.pred))
        out: list[np.ndarray] = []
        pm = self.perfmon
        if not use_device:
            for chunk in t.chunks():
                with pm.timer("cpu_fallback"):
                    out.append(self._replay(chunk))
            return np.concatenate(out) if out else np.empty(0, np.int64)
        names = t.column_names
        schema = schema_from_chunk_columns(names, [t.columns[n] for n in names])
        cap = chunk_capacity(t.nrows)
        key = ("scan", tuple((m.name, m.type, m.dict_id) for m in schema),
               self.pred, cap)
        fn = _JIT_CACHE.get(key)
        if fn is None:
            # bit-packed match mask: no device compaction scatter (~150ms
            # per 16M rows) and a 32x smaller device->host result; the host
            # recovers row ids with unpackbits + flatnonzero
            fn = jax.jit(build_filter_mask_fn(self.pred, schema))
            _JIT_CACHE[key] = fn
        # async program build (opencl_devprog.c analog, utils/devprog.py):
        # run at the small tier while a cold big-chunk program compiles
        from ..utils.devprog import tiered_capacity
        from ..datastore import Chunk as _Chunk
        from ..expr.lower_jax import planes_of_column as _poc

        def _shapes(c):
            probe = _Chunk.from_table(t, 0, min(t.nrows, 8), 8)
            return (tuple(tuple(jax.ShapeDtypeStruct((c,), p.dtype)
                                for p in _poc(probe.columns[nm]))
                          for nm in names),
                    jax.ShapeDtypeStruct((), np.int32))
        cap2 = tiered_capacity(cap, key[:-1], fn, _shapes(cap), pm)
        if cap2 != cap:
            cap = cap2
        # dispatch all chunks, read results back in batched transfers (one
        # device->host read per drain, not 3 per chunk); streamed chunks
        # drain every
        # max_async_chunks to bound in-flight input transfers
        pending: list = []
        streamed = 0
        for cc in TCACHE.chunks_for(t, names, cap, pm):
            if cc.recheck_any:
                with pm.timer("cpu_fallback"):
                    out.extend(self._replay(cc.host_chunk(t)))
                continue
            with pm.timer("dispatch"):
                res = pm.device_call("tpuscan_qual", fn, cc.planes,
                                     np.int32(cc.nrows))
            pending.append((cc, res))
            if not planes_on_device(cc.planes):
                streamed += 1
                if streamed >= config.max_async_chunks:
                    self._drain(pending, out)
                    streamed = 0
        self._drain(pending, out)
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def _drain(self, pending, out: list[np.ndarray]) -> None:
        if not pending:
            return
        with self.perfmon.timer("device_wait"):
            results = fetch_host([r for _, r in pending])
        for (cc, _), rh in zip(pending, results):
            out.append(self._consume(cc, rh))
        pending.clear()

    def _consume(self, cc: CachedChunk, res) -> np.ndarray:
        pm = self.perfmon
        maskbits, nmatch, err = res
        if int(err) != 0:
            pm.bump("recheck_chunks")
            with pm.timer("cpu_fallback"):
                return self._replay(cc.host_chunk(self.table))
        pm.bump("device_chunks")
        bits = unpack_maskbits(maskbits, cc.nrows)
        ids = np.flatnonzero(bits)
        return ids + cc.start

    def _replay(self, chunk: Chunk) -> np.ndarray:
        names = self.table.column_names
        cols = [chunk.columns[n] for n in names]
        out = []
        for i in range(chunk.nrows):
            if eval_expr_cpu(self.pred, lambda s: cols[s].get(i)) is True:
                out.append(chunk.start + i)
        return np.asarray(out, dtype=np.int64)
