"""Expression engine: typed IR, function catalog, exact host evaluation, and
JAX lowering.

This package replaces the reference's runtime OpenCL-C code generator
(codegen.c, 1794 LoC).  Where the reference emits C source strings and
compiles them per plan (opencl_devprog.c program cache), this design
*traces* the same typed expression tree into a jitted XLA program —
jax's compilation cache is the devprog cache analog, and NULL propagation /
per-row error lanes replace the generated pg_<t>_t wrappers
(codegen.c:632-861).
"""

from .ir import (  # noqa: F401
    Expr, Const, ColumnRef, Param, FuncExpr, BoolExpr, NullTest, BooleanTest,
    CaseExpr, Aggref, CoalesceExpr, resolve_function, implicit_cast, bind_columns,
)
from .catalog import FUNCTION_CATALOG, device_expression_supported  # noqa: F401
from .eval_cpu import eval_expr_cpu  # noqa: F401
