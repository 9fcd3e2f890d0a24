"""The questions the engine asks of its device, answered in one place.

Two platforms are known: ``cpu`` (the test suite and host-only runs) and
``gpu`` (an NVIDIA card through JAX's CUDA plugin).  Any other platform
raises with its name: no code path of the engine was written or checked
for it, and a silent default would hide that.
"""

from __future__ import annotations

import jax

KNOWN_PLATFORMS = ("cpu", "gpu")

# ops/preagg_mxu.mxu_reduce formulations.  Both produce the same exact
# integer-limb sums, bit for bit:
#   segment_sum — int64 jax.ops.segment_sum over the limb matrix (a scatter-
#                 add; integer adds are exact in any order);
#   onehot_dot  — bf16 one-hot dot_general with f32 accumulation, per
#                 SEG_ROWS-row segment.
GROUPED_REDUCE_ROUTES = ("segment_sum", "onehot_dot")
# On the GPU the one-hot dot wins at few buckets, where the segment sum's
# atomics pile onto few addresses, and loses at many buckets, where the
# N x G one-hot dominates (at G = 1024 it does not fit a 2^26-row chunk in
# device memory).  Measured on an H200 at 2^26 rows (PERF.md, Findings):
# G = 128 flagship 39.4 ms vs 131.9 ms, agg_group 67.7 ms vs 96.1 ms;
# G = 512 rollup 114.4 ms vs 70.2 ms.
_ONEHOT_MAX_G = 128


def platform() -> str:
    """The default JAX backend's platform: 'cpu' or 'gpu'."""
    p = jax.default_backend()
    if p not in KNOWN_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: pg_strom_tpu runs on "
            f"{' or '.join(KNOWN_PLATFORMS)}")
    return p


def grouped_reduce_route(G: int) -> str:
    """Which exact grouped-reduction formulation mxu_reduce runs for G
    buckets.  The CPU always takes the segment sum: a one-hot product costs
    N x G multiply-adds per column there."""
    if platform() == "gpu" and G <= _ONEHOT_MAX_G:
        return "onehot_dot"
    return "segment_sum"


def f64_limb_sums() -> bool:
    """Whether float8 sums and the f64 pair/variance sums ride the
    integer-limb route (order-independent, hence bit-reproducible).

    On the GPU a float scatter-add is an atomic whose order changes from
    run to run, so an f64 segment sum would not even repeat its own last
    bits; the limb route sums integers, which any order adds exactly, so
    its result is the same in every run.  (Each value enters it to within
    2^-47; PostgreSQL's scan-order f64 sum can differ from it in the last
    bits: PARITY.md.)  On the CPU the f64
    segment sum runs sequentially and is deterministic, and the wider limb
    programs trip an XLA-CPU compiler fault, so the CPU keeps it."""
    return platform() == "gpu"


def ordered_float_scatter() -> bool:
    """Whether a float segment sum (scatter-add) adds in a fixed order.

    XLA's CPU scatter runs sequentially; the GPU's is an atomic whose
    order changes from run to run, so the same query could print a
    different last digit each time.  Where it is not ordered,
    ops/preagg._seg sums floats by a sort and a fixed-tree segmented
    scan instead."""
    return platform() == "cpu"


def async_program_builds() -> bool:
    """Whether utils/devprog builds big-chunk programs in the background
    while a query runs at the small tier.  CPU compiles are cheap and the
    tests rely on stable chunk shapes, so only the GPU engages it."""
    return platform() == "gpu"
