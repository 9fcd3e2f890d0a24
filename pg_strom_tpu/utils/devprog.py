"""Device program cache + asynchronous builds — the opencl_devprog.c analog.

The reference keeps a shared CRC-keyed cache of built cl_programs and builds
them ASYNCHRONOUSLY: a message that needs a program still being built is
parked on the entry's waitq and re-enqueued by the clBuildProgram callback
(reference /root/reference/opencl_devprog.c:128-250, 270-569) — queries never
stall for the compiler.  XLA's jit replaces the cache itself, but not the
async discipline: a big-chunk program can take long to compile cold, and a
synchronous first-touch compile stalls the query for all of it.

This module restores the reference behavior with two mechanisms:

1. **Persistent compilation cache** (the on-disk analog of the reference's
   shared devprog_entry hash): `init_compilation_cache()` points JAX's
   persistent cache at one fixed directory (`compile_cache_dir()`), so a
   program compiled once is found again by later processes.

2. **Async AOT builds with parking** (the build-waitq analog): `ensure()`
   submits `jit(fn).lower(shapes).compile()` on a daemon thread while the
   main thread keeps executing other programs, and `wait()` parks the
   caller for at most `config.devprog_build_wait_ms`.  An executor whose
   big-chunk program is not ready within the parking window runs THIS
   query at the small fallback tier (`config.chunk_rows_cold`) while the
   big program builds behind it; later queries switch to the big tier when
   `ready()`.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Any, Callable

from .. import backend
from ..config import config

_ENV_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"
# fixed, inside the checkout (listed in .gitignore): the path is part of
# the cache's identity, so it must not move between runs
_CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str | None:
    """Directory of JAX's persistent compilation cache, or None (off).

    JAX_COMPILATION_CACHE_DIR, when set, names it (JAX reads the variable
    itself).  Otherwise the cache lives at <checkout>/.jax_cache — except in
    a CPU-primary process (the test suite's JAX_PLATFORMS=cpu): reading back
    cached multi-device CPU-mesh executables segfaults (observed with the
    virtual CPU mesh the tests use), and CPU compiles are cheap anyway."""
    env = os.environ.get(_ENV_CACHE_DIR)
    if env:
        return env
    if _primary_platform() == "cpu":
        return None
    return str(_CHECKOUT_CACHE_DIR)


def _primary_platform() -> str:
    """First entry of the configured JAX platforms ('' when unset)."""
    import jax
    return (jax.config.jax_platforms or "").split(",")[0]


def init_compilation_cache() -> str | None:
    """Point JAX's persistent cache at compile_cache_dir() (package import
    calls this).  Sets nothing when the environment variable names the
    directory or the cache is off.  Returns the directory in use."""
    d = compile_cache_dir()
    if d is None or os.environ.get(_ENV_CACHE_DIR):
        return d
    import jax
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d


class _Build:
    __slots__ = ("event", "error", "started", "finished", "compiled")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.error: BaseException | None = None
        self.started = time.monotonic()
        self.finished: float | None = None
        self.compiled: Any = None


class ProgramBuilder:
    """Background AOT program builder with parking (build-waitq analog)."""

    def __init__(self) -> None:
        self._builds: dict[Any, _Build] = {}
        self._mu = threading.Lock()

    def ensure(self, key: Any, build_thunk: Callable[[], Any]) -> None:
        """Schedule build_thunk (typically fn.lower(shapes).compile()) on a
        daemon thread unless a build for `key` already ran or is running."""
        with self._mu:
            if key in self._builds:
                return
            b = _Build()
            self._builds[key] = b

        def run() -> None:
            try:
                b.compiled = build_thunk()
            except BaseException as e:   # noqa: BLE001 — recorded, surfaced
                b.error = e
            finally:
                b.finished = time.monotonic()
                b.event.set()

        threading.Thread(target=run, daemon=True,
                         name=f"pgstrom-devprog-{abs(hash(key)) & 0xffff:04x}"
                         ).start()

    def ready(self, key: Any) -> bool:
        b = self._builds.get(key)
        return b is not None and b.event.is_set() and b.error is None

    def failed(self, key: Any) -> BaseException | None:
        b = self._builds.get(key)
        return b.error if b is not None and b.event.is_set() else None

    def wait(self, key: Any, timeout_s: float) -> bool:
        """Park on the build for at most timeout_s; True when it completed
        successfully (the caller may then use the big-tier program)."""
        b = self._builds.get(key)
        if b is None:
            return False
        b.event.wait(timeout_s)
        return b.event.is_set() and b.error is None

    def info_rows(self) -> list[dict]:
        """pgstrom_program_info analog (reference opencl_devprog.c:770)."""
        rows = []
        with self._mu:
            items = list(self._builds.items())
        for k, b in items:
            rows.append({
                "key": repr(k)[:120],
                "state": ("error" if b.error is not None
                          else "built" if b.event.is_set() else "building"),
                "build_s": round(((b.finished or time.monotonic())
                                  - b.started), 2),
                "error": (repr(b.error)[:120] if b.error is not None
                          else None),
            })
        return rows


DEVPROG = ProgramBuilder()


def tiered_capacity(cap: int, plan_key: Any, fn: Any,
                    shape_args: tuple, pm=None) -> int:
    """Pick the chunk capacity for this query: `cap` when its program is
    (or becomes, within the parking window) compiled; otherwise schedule the
    big build in the background and return the small fallback tier.

    `fn` must be the jax.jit-wrapped program; `shape_args` the
    ShapeDtypeStruct pytree matching a `cap`-sized call.  Mirrors
    clserv_lookup_device_program's park-or-fallback (opencl_devprog.c:270).
    """
    small = int(config.chunk_rows_cold)
    if cap <= small or not config.devprog_async_build:
        return cap
    if not backend.async_program_builds():
        return cap
    key = (plan_key, cap)
    if DEVPROG.ready(key):
        return cap
    if DEVPROG.failed(key) is not None:
        return cap               # build errored: let the sync path raise it
    DEVPROG.ensure(key, lambda: fn.lower(*shape_args).compile())
    if DEVPROG.wait(key, max(config.devprog_build_wait_ms, 0) / 1000.0):
        return cap
    if pm is not None:
        pm.bump("devprog_tier_fallbacks")
    return small
