"""Parity harness: run the reference's regression SQL against pg_strom_tpu
and diff against the reference's own expected/*.out goldens.

This is the strongest possible correctness check (exact-match results on
the reference agg/join regression suite): the fixture data is
regenerated bit-exactly from PostgreSQL's PRNG (models/pg_fixture.py), the
reference SQL files are executed as-is, and every output value must match
the golden .out text character-for-character.

Usage:  python tools/pg_parity.py [nogrp_agg group_agg ...] [--max-diffs N]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference"


def split_statements(sql_text: str) -> list[str]:
    """Split on ';' outside quotes; keep statements with content."""
    out, cur, in_str = [], [], False
    i = 0
    while i < len(sql_text):
        c = sql_text[i]
        if c == "'" :
            in_str = not in_str
            cur.append(c)
        elif c == ";" and not in_str:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    if cur:
        out.append("".join(cur))
    stmts = []
    for s in out:
        s2 = "\n".join(ln for ln in s.splitlines()
                       if not ln.strip().startswith("--"))
        if s2.strip():
            stmts.append(s2.strip())
    return stmts


def parse_expected(path: str):
    """Parse a pg_regress .out file into per-statement results.

    Yields (statement_text, kind, payload):
      kind='rows'  payload=(colnames, [row tuples of str])
      kind='error' payload=error text
      kind='none'  payload=None (SET etc.)
    """
    lines = open(path).read().splitlines()
    i = 0
    results = []
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("--") or not ln.strip():
            i += 1
            continue
        # statement echo: read until the echoed text contains ';'
        stmt_lines = [ln]
        while ";" not in ln and i + 1 < len(lines):
            i += 1
            ln = lines[i]
            stmt_lines.append(ln)
        stmt = "\n".join(stmt_lines).strip().rstrip(";")
        i += 1
        # what follows: header / ERROR / nothing
        if i < len(lines) and lines[i].startswith("ERROR:"):
            err = lines[i][len("ERROR:"):].strip()
            i += 1
            # skip DETAIL/HINT lines
            while i < len(lines) and (lines[i].startswith(("DETAIL:", "HINT:",
                                                           "LINE ", " ", "^"))
                                      and lines[i].strip()):
                i += 1
            results.append((stmt, "error", err))
            continue
        if i + 1 < len(lines) and re.match(r"^-[-+]*-$", lines[i + 1].replace(" ", "")):
            header = [h.strip() for h in lines[i].split("|")]
            i += 2
            rows = []
            while i < len(lines) and not re.match(r"^\(\d+ rows?\)$", lines[i]):
                rows.append(tuple(c.strip() for c in lines[i].split("|")))
                i += 1
            i += 1  # the "(N rows)" line
            results.append((stmt, "rows", (header, rows)))
            continue
        results.append((stmt, "none", None))
    return results


def run_parity(names: list[str], max_diffs: int = 10,
               use_reference_fixture: bool = True, gpu: bool = False):
    import jax
    if not gpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise SystemExit(f"--gpu: no GPU, JAX found {dev.platform!r}")
        print("running on:", dev, flush=True)
    from pg_strom_tpu.datastore import Database
    from pg_strom_tpu.models.pg_fixture import (
        regen_preagg_test, regen_preagg_overflow, regen_preagg_mix)
    from pg_strom_tpu.models.fixtures import make_preagg_zero
    from pg_strom_tpu.sql import execute
    from pg_strom_tpu.sql.api import _SESSION
    from pg_strom_tpu.errors import SqlError
    from pg_strom_tpu.utils.pgformat import value_out
    from pg_strom_tpu.datastore import Table, column_from_values

    db = Database()
    print("regenerating fixture from PostgreSQL PRNG ...", flush=True)
    db.create(regen_preagg_test())
    db.create(regen_preagg_overflow())
    db.create(make_preagg_zero())
    zt = db.get("gpupreagg_test")
    db.create(Table.from_columns(
        "gpupreagg_zero_test",
        {c: column_from_values(col.type, []) for c, col in zt.columns.items()}))
    if any(n in ("group_agg",) for n in names):
        print("building gpupreagg_mix view ...", flush=True)
        db.create(regen_preagg_mix(db))

    total = {"match": 0, "diff": 0, "error": 0, "skip": 0}
    for name in names:
        out_path = f"{REF}/expected/{name}.out"
        exp = parse_expected(out_path)
        ndiff = 0
        for stmt, kind, payload in exp:
            if kind == "none":
                try:
                    execute(stmt, db)
                except Exception:
                    pass
                continue
            try:
                r = execute(stmt, db)
                got_kind = "rows"
                got_rows = [tuple(value_out(v, t, _SESSION["extra_float_digits"])
                                  for v, t in zip(row, r.types))
                            for row in r.rows]
            except SqlError as e:
                got_kind = "error"
                got_err = e.message
            except Exception as e:
                total["error"] += 1
                if ndiff < max_diffs:
                    print(f"[{name}] ENGINE ERROR on: {stmt[:90]}\n  {type(e).__name__}: {e}")
                ndiff += 1
                continue
            if kind == "error":
                if got_kind == "error" and got_err == payload:
                    total["match"] += 1
                else:
                    total["diff"] += 1
                    if ndiff < max_diffs:
                        print(f"[{name}] expected ERROR {payload!r}, got "
                              f"{'ERROR ' + got_err if got_kind == 'error' else got_rows[:2]}"
                              f" on: {stmt[:90]}")
                    ndiff += 1
                continue
            want_header, want_rows = payload
            if got_kind != "rows":
                total["diff"] += 1
                if ndiff < max_diffs:
                    print(f"[{name}] expected rows, got ERROR {got_err!r} on: {stmt[:90]}")
                ndiff += 1
                continue
            norm_got = [tuple(r2) for r2 in got_rows]
            if norm_got == [tuple(r2) for r2 in want_rows]:
                total["match"] += 1
            else:
                total["diff"] += 1
                if ndiff < max_diffs:
                    print(f"[{name}] DIFF on: {stmt[:90]}")
                    for a, b in list(zip(want_rows, norm_got))[:4]:
                        if tuple(a) != tuple(b):
                            print(f"   want {a}")
                            print(f"   got  {b}")
                    if len(want_rows) != len(norm_got):
                        print(f"   want {len(want_rows)} rows, got {len(norm_got)}")
                ndiff += 1
        print(f"[{name}] done; diffs so far: {ndiff}")
    print("TOTAL:", total)
    return total


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("suites", nargs="*",
                    default=["nogrp_agg", "zero_agg", "where_agg",
                             "group_agg", "overflow_agg", "recheck_agg"])
    ap.add_argument("--max-diffs", type=int, default=10)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (fails without one) instead of "
                         "forcing CPU")
    args = ap.parse_args()
    run_parity(args.suites or None, args.max_diffs, gpu=args.gpu)
