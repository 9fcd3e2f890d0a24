"""Runtime configuration ("GUC") system.

Analog of PG-Strom's GUC variables (reference: main.c:104-199 and the full
GUC list catalogued in SURVEY.md §5).  Same grouping, same defaults where
they still make sense (the tpu_* names are historical; they mean "device"):

  behavior : enabled, enable_gpuscan/gpuhashjoin/gpupreagg/gpusort,
             debug_force_gpupreagg  (reference main.c:104-131, gpupreagg.c:2947)
  sizing   : chunk_size (reference default 15MB -> here expressed in rows),
             min/max_async_chunks (reference main.c:132-161)
  cost     : tpu_setup_cost / tpu_operator_cost / tpu_tuple_cost
             (reference gpu_setup_cost=500*seq_page, gpu_operator_cost=cpu/100,
              gpu_tuple_cost=cpu/32, main.c:167-198)
  codegen  : show_device_kernel, perfmon (reference main.c:399-439, 441-660)

Values are plain attributes; `set_config`/`get_config`/`show_all` give a
SQL-SET-like surface, and `override(...)` is a context manager used by tests
(the analog of `SET pg_strom.debug_force_gpupreagg TO on` in the regression
corpus, input/enable.conf).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator


@dataclasses.dataclass
class _Config:
    # --- behavior -----------------------------------------------------------
    _enabled: bool = True                 # session switch (pg_strom.enabled)
    # superuser/global kill switch for benchmarking sessions (reference
    # pg_strom.enabled_global, main.c:49-102: lives in shmem so one SET
    # disables offloading engine-wide); effective enablement = AND of both
    enabled_global: bool = True
    enable_tpuscan: bool = True           # enable_gpuscan
    enable_tpuhashjoin: bool = True       # enable_gpuhashjoin
    enable_tpupreagg: bool = True         # enable_gpupreagg
    enable_tpusort: bool = True           # gpusort (deadcode in reference; first-class here)
    debug_force_tpupreagg: bool = False   # pg_strom.debug_force_gpupreagg
    debug_force_offload: bool = False     # force device plan regardless of cost (test determinism)

    # --- sizing -------------------------------------------------------------
    # rows per streamed columnar chunk (15MB analog).  Large chunks amortize
    # the fixed per-launch cost (~1.3GB planes for a 20B/row schema at
    # 2^26); chunk_capacity() still clamps to the table's next pow2.  The
    # value is inherited and not yet derived from a measurement on the GPU.
    chunk_rows: int = 1 << 26
    # cold-compile fallback tier (utils/devprog.py, the opencl_devprog.c
    # async-build analog): queries whose big-chunk program is still
    # compiling run at this capacity while the build finishes behind them
    chunk_rows_cold: int = 1 << 24
    # park at most this long on an in-flight program build before taking
    # the fallback tier (the reference parks messages on the build waitq,
    # opencl_devprog.c:128-250; mqueue-style timeout)
    devprog_build_wait_ms: int = 3000
    devprog_async_build: bool = True
    min_async_chunks: int = 2             # pipeline low-water mark (main.c:142-151)
    max_async_chunks: int = 3             # pipeline high-water mark (main.c:152-161)
    # per-chunk device group-bucket count.  One-hot traffic scales with
    # N x G, so the executor starts here and escalates 4x on collision
    # before falling back to the sort strategy at max_groups_cap
    max_groups_device: int = 1 << 10
    max_groups_cap: int = 1 << 12
    join_max_bucket_probe: int = 16       # bounded probe-chain length before fallback
    # fused N-way chain: cap on the cartesian product of per-inner fanout
    # slices (ops/starjoin.py); beyond it the pairwise chain runs
    join_star_max_slices: int = 16
    # HBM budget for a device-resident join build side; larger builds run
    # the nloops partition loop (gpuhashjoin.c:322-431 divide + outer
    # rescan) instead of abandoning the device path
    join_build_hbm_mb: int = 2048
    mqueue_timeout_ms: int = 60_000       # reference pg_strom.mqueue_timeout
    loader_threads: int = 0               # 0 = #CPUs (reference opencl_num_threads)

    # --- device table cache (the tcache analog, reference deadcode/tcache.c:
    #     columnar T-tree cache; here: HBM-resident chunk planes reused across
    #     queries with LRU eviction) ------------------------------------------
    enable_tcache: bool = True
    tcache_size_mb: int = 8192            # device bytes budget for cached planes

    # --- cost model ---------------------------------------------------------
    cpu_tuple_cost: float = 0.01          # PostgreSQL defaults, for the cost model
    cpu_operator_cost: float = 0.0025
    seq_page_cost: float = 1.0
    tpu_setup_cost: float = 500.0         # gpu_setup_cost = 500 * seq_page_cost
    tpu_operator_cost: float = 0.0025 / 100.0   # gpu_operator_cost = cpu/100
    tpu_tuple_cost: float = 0.01 / 32.0   # gpu_tuple_cost = cpu/32

    # --- observability ------------------------------------------------------
    perfmon: bool = False                 # collect+show per-node perf counters
    show_device_kernel: bool = False      # dump lowered HLO/jaxpr in EXPLAIN VERBOSE
    client_min_messages: str = "notice"

    # --- numeric device format limits (mirrors reference opencl_numeric.h:
    #     sign(1) + exponent(6, signed, [-32,31]) + mantissa(57) packed 64-bit;
    #     values outside are CpuReCheck'd, which reproduces the recheck_agg
    #     corpus behavior: 1E+48/1E-32 on-device, 1E+49/1E-33 rechecked) ------
    numeric_max_mantissa: int = (1 << 57) - 1
    numeric_min_exponent: int = -32
    numeric_max_exponent: int = 31

    # --- distributed --------------------------------------------------------
    # route eligible join+GROUP BY queries through the device mesh
    # (parallel/dist.py via exec/dist_exec.py); off by default — a single
    # visible device makes it a no-op either way
    distributed: bool = False
    # >1: 2D ("hosts", "chips") mesh for a multi-node cluster — the shuffle
    # exchange runs within a node first, then across nodes; 1 = flat (the
    # layout for the cards of one machine, which all reach each other)
    dist_mesh_hosts: int = 1
    dist_group_slots: int = 1024          # per-device group-partial slots
    shuffle_partitions_per_device: int = 1
    skew_sample_rows: int = 4096          # rows sampled for heavy-hitter detection
    skew_heavy_threshold: float = 0.10    # key freq above this => broadcast side
    # engine-path skew routing (exec/dist_exec.py): spread heavy probe
    # rows + broadcast matching build rows instead of hash-funneling a hot
    # key onto one device
    dist_skew_routing: bool = True
    # device-assisted agg(DISTINCT x) even WITHOUT pg_strom.distributed:
    # route eligible distinct aggregations through the dedup-exchange step
    # on the local device mesh instead of the host row loop (the reference
    # always punts DISTINCT to the CPU aggregate — this exceeds it)
    device_distinct: bool = True
    # plane-space window execution (plan/window.py _run_columnar): window
    # keys sort/compute on numpy planes with zero python row objects; off
    # falls back to the exact per-row tier (the reference runs windows on
    # the PostgreSQL CPU executor — this flag picks which host tier)
    vectorized_windows: bool = True


def _enabled_get(self) -> bool:
    return self._enabled and self.enabled_global


def _enabled_set(self, v: bool) -> None:
    self._enabled = v


_Config.enabled = property(_enabled_get, _enabled_set)

config = _Config()
_lock = threading.Lock()

_FIELD_NAMES = {f.name for f in dataclasses.fields(_Config)} | {"enabled"}
_FIELD_NAMES.discard("_enabled")


def get_config(name: str) -> Any:
    if name not in _FIELD_NAMES:
        raise KeyError(f'unrecognized configuration parameter "{name}"')
    return getattr(config, name)


def set_config(name: str, value: Any) -> None:
    if name not in _FIELD_NAMES:
        raise KeyError(f'unrecognized configuration parameter "{name}"')
    cur = getattr(config, name)
    if isinstance(cur, bool) and isinstance(value, str):
        value = value.strip().lower() in ("on", "true", "yes", "1", "t")
    elif isinstance(cur, int) and not isinstance(cur, bool):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    with _lock:
        setattr(config, name, value)


def show_all() -> dict[str, Any]:
    d = dataclasses.asdict(config)
    d["enabled"] = config.enabled
    d.pop("_enabled", None)
    return d


@contextlib.contextmanager
def override(**kwargs: Any) -> Iterator[None]:
    """Temporarily override config values (test fixture analog of SET/RESET)."""
    # snapshot the raw session field for 'enabled' — the property ANDs in
    # enabled_global, so saving the property value would clobber the session
    # flag to False whenever the global switch happened to be off (ADVICE r2)
    saved = {k: getattr(config, "_enabled" if k == "enabled" else k)
             for k in kwargs}
    for k, v in kwargs.items():
        set_config(k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            with _lock:
                setattr(config, k, v)
