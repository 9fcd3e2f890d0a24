"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is validated
without accelerators; chip_smoke.py runs the engine on a GPU).  This
mirrors the reference's
trick of using CPU OpenCL platforms as the no-GPU test backend
(opencl_devinfo.c:1066-1096, pg_strom.opencl_device_types=cpu).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

# the suite never opens an accelerator, whatever the environment says
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20140601)  # reference v0 era


def _clear_program_caches():
    from pg_strom_tpu.exec import join_exec, joinagg_exec, preagg_exec, \
        scan_exec
    for m in (join_exec, joinagg_exec, preagg_exec, scan_exec):
        m._JIT_CACHE.clear()


@pytest.fixture
def gpu_route(monkeypatch):
    """Run the GPU's decisions on the CPU backend: the backend module
    reports 'gpu', so the GPU's grouped-reduction formulation and its
    integer-limb float8 sums run here.  The executors' program caches are
    keyed by plan, not platform, so they are cleared around the test."""
    from pg_strom_tpu import backend
    _clear_program_caches()
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    yield
    monkeypatch.undo()
    _clear_program_caches()


@pytest.fixture(scope="session", autouse=True)
def _force_offload_for_determinism():
    """The regression contract is forced-offload determinism: the reference
    runs pg_regress with pg_strom.debug_force_gpupreagg=on (input/enable.conf)
    because test fixtures are far below the cost model's offload breakeven.
    Same trick here: the suite forces the device plan so every test exercises
    the device path; cost-model tests override this back off explicitly."""
    from pg_strom_tpu.config import set_config
    set_config("debug_force_offload", True)
    yield


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_compiler_state():
    """Clear jit caches at each test module: the XLA CPU compiler crashes
    (SIGABRT inside backend_compile, latent jaxlib bug) once a process
    accumulates >~1000 compiled programs — the limb-matrix strategy variants
    pushed the full suite past that line.  Per-module recompiles are cheap on CPU
    and keep every module hermetic."""
    jax.clear_caches()
    yield
