"""Distributed execution: SPMD shuffle over a device mesh.

The reference is strictly single-node — its only "communication" is pthread
message queues in shared memory plus PCIe DMA (SURVEY §5: mqueue.c,
opencl_serv.c:115-214).  This package is the new capability this engine
adds: tables hash-partitioned across devices, all-to-all
shuffles over the device interconnect for join/group-by exchanges (lax.all_to_all under
shard_map), skew-aware handling, and exchange/compute overlap.
"""
