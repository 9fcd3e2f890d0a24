"""Open-ended differential SQL soak: the same generator + contract as
tests/test_fuzz_sql.py over an arbitrary seed range.

Usage:  python tools/fuzz_sql.py [first_seed] [n_seeds] [queries_per_seed]

Every generated statement runs twice — pg_strom.enabled on and off — and
must produce identical rows (sorted multiset of formatted rows unless the
statement carries a total ORDER BY) or identical SqlError text.  Mirrors
the reference's enable.conf/disable.conf pg_regress discipline (SURVEY §4)
with a random corpus.  Exit code 1 on the first mismatch, with a repro
header (seed, query index, engine config, SQL).
"""

import os
import random
import sys

sys.path.insert(0, ".")          # run from the repo root, like bench.py

# 8 virtual devices BEFORE jax import: the distributed config axis needs
# a mesh to actually exercise (same trick as tests/conftest.py)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = \
        (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")   # the fuzzer never opens a GPU

import pg_strom_tpu  # noqa: E402,F401
from pg_strom_tpu.datastore import Database  # noqa: E402
from pg_strom_tpu.models.fixtures import make_preagg_test  # noqa: E402
from pg_strom_tpu.config import set_config  # noqa: E402
from pg_strom_tpu.utils.sqlgen import QueryGen  # noqa: E402

sys.path.insert(0, "tests")
from test_fuzz_sql import (fuzz_schema, build_fuzz_db, rand_cfg,  # noqa: E402
                           run_one, outcomes_match)


def main() -> int:
    first = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    nseeds = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    nq = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    set_config("debug_force_offload", True)
    db = build_fuzz_db()
    tables, pairs = fuzz_schema()

    total = bad = 0
    for seed in range(first, first + nseeds):
        rng = random.Random(seed)
        gen = QueryGen(rng, tables, pairs)
        cfg = rand_cfg(rng)
        for i in range(nq):
            sql, ordered = gen.gen()
            dev = run_one(db, sql, True, cfg)
            host = run_one(db, sql, False, cfg)
            if dev[0] == host[0] == "rows" and not ordered:
                dev = (dev[0], dev[1], tuple(sorted(dev[2])))
                host = (host[0], host[1], tuple(sorted(host[2])))
            total += 1
            if not outcomes_match(dev, host, cfg):
                bad += 1
                print(f"MISMATCH seed={seed} q#{i} cfg={cfg}\n  SQL: {sql}\n"
                      f"  dev : {str(dev)[:300]}\n"
                      f"  host: {str(host)[:300]}")
                return 1
        jax.clear_caches()   # jaxlib CPU compiler SIGABRTs past ~1000 programs
        print(f"seed {seed}: {nq} queries ok ({total} total)")
    print(f"done: {total} queries, {bad} mismatches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
