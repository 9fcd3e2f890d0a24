"""Error model.

Analog of the reference's StromError_* codes (opencl_common.h:106-123)
and the per-row error writeback (`kern_writeback_error_status`,
opencl_common.h:1481-1527).  On the device we carry a per-row uint8 error lane through
every lowered expression; the chunk-level error is the max over rows (errors are
priority-ordered so max() == "most severe", mirroring STROM_SET_ERROR's
priority rule, opencl_common.h:132-144).

Severity ordering (higher wins):
  0 SUCCESS < 1 CPU_RECHECK < 2..  hard SQL errors (division by zero, overflow)

CPU_RECHECK means "this row/chunk must be re-evaluated on the exact host path"
— the load-bearing exactness escape used throughout the reference
(gpuscan.c:1038-1046, gpupreagg.c:2507-2608, recheck_agg corpus).
Hard errors surface as SqlError with PostgreSQL-compatible message text
(overflow_agg corpus checks these strings).
"""

from __future__ import annotations

# Per-row error codes (device lanes are uint8; keep <= 255).
ERR_SUCCESS = 0
ERR_CPU_RECHECK = 1          # StromError_CpuReCheck analog
ERR_DIV_BY_ZERO = 2
ERR_INT2_OVERFLOW = 3        # smallint out of range
ERR_INT4_OVERFLOW = 4        # integer out of range
ERR_INT8_OVERFLOW = 5        # bigint out of range
ERR_FLOAT_OVERFLOW = 6       # value out of range: overflow
ERR_FLOAT_UNDERFLOW = 7      # value out of range: underflow
ERR_NUMERIC_OVERFLOW = 8     # numeric field overflow / out of device range
ERR_SANITY_CHECK = 9         # StromError_SanityCheckViolation analog
ERR_DATA_CORRUPTION = 10     # StromError_DataStoreCorruption analog

_MESSAGES = {
    ERR_DIV_BY_ZERO: "division by zero",
    ERR_INT2_OVERFLOW: "smallint out of range",
    ERR_INT4_OVERFLOW: "integer out of range",
    ERR_INT8_OVERFLOW: "bigint out of range",
    ERR_FLOAT_OVERFLOW: "value out of range: overflow",
    ERR_FLOAT_UNDERFLOW: "value out of range: underflow",
    ERR_NUMERIC_OVERFLOW: "numeric field overflow",
    ERR_SANITY_CHECK: "sanity check violation on device",
    ERR_DATA_CORRUPTION: "data store corrupted on device",
}


class SqlError(Exception):
    """A PostgreSQL-style execution error (message text matches PG where the
    regression corpus checks it, e.g. overflow_agg.out)."""

    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.message = message
        self.code = code


class CpuReCheck(Exception):
    """Internal signal: this row/chunk needs host-exact re-evaluation."""


class InternalError(Exception):
    pass


def error_message(code: int) -> str:
    return _MESSAGES.get(code, f"device error {code}")


def raise_for_code(code: int) -> None:
    if code in (ERR_SUCCESS,):
        return
    if code == ERR_CPU_RECHECK:
        raise CpuReCheck()
    raise SqlError(error_message(code), code)
