"""Device operators: the engine's kernel library (plain JAX/XLA).

Replaces the reference's OpenCL kernel headers:
  opencl_gpuscan.h    -> ops/filter.py   (predicate eval + compaction)
  opencl_gpupreagg.h  -> ops/preagg.py   (grouped partial aggregation)
  opencl_hashjoin.h   -> ops/hashjoin.py (build/probe equi-join)
  deadcode/gpusort    -> ops/sort.py     (ORDER BY / top-k)
plus ops/hashing.py (pg_crc32-table analog: vectorized avalanche hashing).
"""
