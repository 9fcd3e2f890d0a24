"""pg_strom_tpu — a vectorized SQL query-execution engine in JAX.

A from-scratch reimplementation of the capability set of PG-Strom
(reference: /root/reference, a PostgreSQL extension offloading scan /
hash-join / pre-aggregation to OpenCL devices), redesigned for XLA:

  reference mechanism                      replacement here
  ------------------------------------     -------------------------------------
  OpenCL C runtime codegen (codegen.c)     typed expr IR traced to XLA (expr/)
  program cache (opencl_devprog.c)         jax jit compilation cache
  kern_data_store row layouts              struct-of-arrays columnar chunks
  mqueue + OpenCL server bgworker          async jit dispatch + C++ loader pool
  per-row error writeback + CpuReCheck     uint8 error lanes + host-exact replay
  round-robin multi-device scheduling      jax.sharding.Mesh + shard_map
  (absent: distributed)                    all_to_all shuffle join/agg (parallel/)

PostgreSQL exactness (NULL logic, int overflow errors, numeric semantics,
text collation) is preserved via the same two-tier design the reference uses:
a fast device path plus a host-exact fallback for anything out of window.
It runs on the CPU (tests) and on an NVIDIA GPU (see backend.py).
"""

from __future__ import annotations

import os

# float8/int8 SQL types need real f64/i64 lanes; must be set before any jax
# array is created.
os.environ.setdefault("JAX_ENABLE_X64", "1")
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from .utils.devprog import init_compilation_cache  # noqa: E402

init_compilation_cache()

__version__ = "0.1.0"

from .config import config, set_config, get_config, show_all, override  # noqa: F401,E402
from .sqltypes import T  # noqa: F401,E402
from .datastore import Table, Column, Chunk, Database, column_from_values, column_from_numpy  # noqa: F401,E402
from .errors import SqlError, CpuReCheck  # noqa: F401,E402
