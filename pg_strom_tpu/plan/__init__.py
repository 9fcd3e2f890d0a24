"""Planner: AST binding, logical planning, device/host operator placement,
cost model, EXPLAIN.

The analog of the reference's L7 planner integration (gpuscan.c path hooks,
gpuhashjoin.c hashjoin path hook, gpupreagg.c + grafter.c Agg rewriting,
cost GUCs in main.c:167-198) — re-homed as a standalone planner since there
is no PostgreSQL optimizer to hook into.
"""

from .binder import BindError  # noqa: F401
from .planner import plan_select, plan_query, PlannedQuery  # noqa: F401
