# Verbatim copy of datafusion_tpu/testing/port_slt.py; host-only, kept in step with the original.
"""Port reference sqllogictest files into the local dialect, oracle-checked.

The reference's primary test corpus is 193 .slt files / ~169k lines
(datafusion/sqllogictest/test_files). This porter replays a reference file
against THIS engine and emits a local .slt containing every record whose
behavior matches the reference's committed expected output:

  * `statement ok` records are kept when they execute here (table DDL via
    CREATE TABLE ... AS VALUES, INSERT INTO, ...); unsupported statements
    (SET, EXPLAIN snapshots, CREATE EXTERNAL TABLE on absent fixtures,
    arrow_typeof, ...) are dropped along with anything that depends on them
    -- dependent queries then fail to execute and are dropped too.
  * `query` records are kept ONLY when our result matches the reference's
    expected block (numerics compared by value: the reference prints f64 at
    full precision, our dialect at %.3f; NULL/"(empty)" conventions are
    shared). The emitted expected block is re-rendered in our format, but
    its VALUES were verified against the reference engine's answers at port
    time -- the corpus stays a genuine differential, not a self-snapshot.
  * `statement error` / `query error` records are kept (without the
    reference's message text, which is engine-specific) when we also error.
  * `N values hashing to <md5>` blocks and skipif/onlyif records for other
    engines are dropped.

Provenance: the emitted files derive from Apache DataFusion's test corpus
(Apache-2.0); each carries a header naming its source file and port stats.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import signal
from typing import List, Optional, Tuple

from .slt import Record, format_rows


@contextlib.contextmanager
def _record_deadline(seconds: int):
    """SIGALRM guard: one pathological record (a query whose compile or
    evaluation never finishes) must not stall a whole-file port. Only
    effective in the main thread; no-op elsewhere."""

    def onalarm(signum, frame):
        raise TimeoutError("slt record exceeded port deadline")

    try:
        prev = signal.signal(signal.SIGALRM, onalarm)
    except ValueError:  # not the main thread
        yield
        return
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)

_SKIP_SQL = re.compile(
    r"^\s*(explain\b|describe\b|create\s+unbounded\b)", re.IGNORECASE)

# reference corpus root: relative LOCATION/COPY paths resolve against it
# (the reference runner executes from datafusion/sqllogictest)
SLT_REF_ROOT = "/root/reference/datafusion/sqllogictest"
# fixtures living in git submodules that are not checked out, mapped to an
# equivalent in-tree file (same rows sorted by c1; every kept query is
# still verified against the reference's committed expected output, so
# order-sensitive records simply drop)
FIXTURE_SUBS = {
    "../../testing/data/csv/aggregate_test_100.csv":
        "../core/tests/data/aggregate_test_100_order_by_c1_asc.csv",
}


def _synth_with_dates(dst: str) -> None:
    """aggregate_test_100_with_dates.csv = the 13 base columns (from the
    in-tree sorted copy) + placeholder c14 DATE / c15 TIMESTAMP columns.
    Queries that touch c14/c15 fail their value check and drop; the many
    c1..c13 queries keep."""
    import os

    src = os.path.normpath(os.path.join(
        SLT_REF_ROOT,
        "../core/tests/data/aggregate_test_100_order_by_c1_asc.csv"))
    with open(src) as f:
        lines = f.read().splitlines()
    out = [lines[0] + ",c14,c15"]
    out += [ln + ",1970-01-01,1970-01-01T00:00:00" for ln in lines[1:] if ln]
    with open(dst, "w") as f:
        f.write("\n".join(out) + "\n")


# fixtures that do not exist anywhere in the checkout, rebuilt from in-tree
# data (values of the synthesized columns are placeholders; see builders)
SYNTH_FIXTURES = {
    "../../testing/data/csv/aggregate_test_100_with_dates.csv":
        _synth_with_dates,
}
_QUOTED = re.compile(r"'([^']*)'")
_FIXTURE_CAP_BYTES = 64 << 20


def _tree_bytes(p: str) -> int:
    import os

    if os.path.isfile(p):
        return os.path.getsize(p)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, fs in os.walk(p) for f in fs)


def rewrite_fixture_paths(sql: str, data_dir: str) -> str:
    """Rewrite path literals in a reference SLT statement to portable
    tokens: scratch outputs -> $SCRATCH/..., reference fixtures -> copied
    into data_dir and referenced as $SLTDATA/<name>. Unresolvable paths are
    left alone (the statement then fails and the record drops)."""
    import os
    import shutil

    def repl(m):
        path = m.group(1)
        if path.startswith("test_files/scratch/"):
            return "'$SCRATCH/" + path[len("test_files/scratch/"):] + "'"
        if not (path.startswith("../") or path.startswith("test_files/")):
            return m.group(0)
        if path in SYNTH_FIXTURES:
            name = os.path.basename(path)
            dst = os.path.join(data_dir, name)
            if not os.path.exists(dst):
                os.makedirs(data_dir, exist_ok=True)
                SYNTH_FIXTURES[path](dst)
            return f"'$SLTDATA/{name}'"
        src = os.path.normpath(
            os.path.join(SLT_REF_ROOT, FIXTURE_SUBS.get(path, path)))
        if not os.path.exists(src):
            return m.group(0)
        name = os.path.basename(src.rstrip("/"))
        dst = os.path.join(data_dir, name)
        if os.path.exists(dst):
            pass  # same basename == same fixture across the corpus
        elif _tree_bytes(src) > _FIXTURE_CAP_BYTES:
            return m.group(0)
        elif os.path.isdir(src):
            shutil.copytree(src, dst)
        else:
            os.makedirs(data_dir, exist_ok=True)
            shutil.copy2(src, dst)
        return f"'$SLTDATA/{name}'"

    return _QUOTED.sub(repl, sql)


@dataclasses.dataclass
class RefRecord:
    kind: str        # statement_ok | statement_error | query | query_error
    sql: str
    line: int
    types: str = ""
    sort_mode: str = "nosort"
    expected: Tuple[str, ...] = ()
    condition: str = ""   # "", "keep", "drop" (from skipif/onlyif)


def parse_reference_slt(text: str) -> List[RefRecord]:
    lines = text.splitlines()
    out: List[RefRecord] = []
    i, n = 0, len(lines)
    condition = ""

    def read_sql(j):
        sql = []
        while j < n and lines[j].strip() and lines[j].strip() != "----":
            sql.append(lines[j])
            j += 1
        return "\n".join(sql).strip(), j

    while i < n:
        s = lines[i].strip()
        if not s or s.startswith("#"):
            i += 1
            continue
        low = s.lower()
        if low.startswith(("hash-threshold", "halt", "control")):
            i += 1
            continue
        if low.startswith(("skipif", "onlyif")):
            eng = s.split()[1].lower() if len(s.split()) > 1 else ""
            keep = (low.startswith("skipif") and eng != "datafusion") or \
                   (low.startswith("onlyif") and eng == "datafusion")
            condition = "keep" if keep else "drop"
            i += 1
            continue
        start = i + 1
        m = re.match(r"statement\s+(ok|error|count)\s*(.*)", s, re.IGNORECASE)
        q = re.match(r"query\s+error(\s+.*)?$", s, re.IGNORECASE)
        q2 = re.match(r"query\s+(\S+)\s*(\S+)?\s*(\S+)?\s*$", s, re.IGNORECASE)
        if m:
            i += 1
            sql, i = read_sql(i)
            kind = "statement_error" if m.group(1).lower() == "error" \
                else "statement_ok"
            out.append(RefRecord(kind, sql, start, condition=condition))
        elif q:
            i += 1
            sql, i = read_sql(i)
            out.append(RefRecord("query_error", sql, start,
                                 condition=condition))
        elif q2 and q2.group(1):
            i += 1
            sql, i = read_sql(i)
            expected: List[str] = []
            if i < n and lines[i].strip() == "----":
                i += 1
                while i < n and lines[i].strip():
                    expected.append(lines[i].rstrip())
                    i += 1
            types = q2.group(1).upper()
            sort_mode = (q2.group(2) or "nosort").lower()
            if sort_mode not in ("nosort", "rowsort", "valuesort"):
                sort_mode = "nosort"
            out.append(RefRecord("query", sql, start, types=types,
                                 sort_mode=sort_mode,
                                 expected=tuple(expected),
                                 condition=condition))
        else:
            i += 1  # unknown directive: skip the line
            continue
        condition = ""
    return out


def _norm_token(tok: str, tch: str):
    if tok == "NULL":
        return ("null",)
    if tch == "I":
        try:
            return ("r", float(int(tok)))
        except ValueError:
            pass
    if tch in ("I", "R"):
        try:
            f = float(tok)
            if f != f:
                # NaN: bitwise-equal token, not float != ; keep the key
                # tuple float-typed so rowsort can order mixed rows
                return ("r", float("inf"), "nan")
            return ("r", round(f, 3))
        except ValueError:
            return ("t", tok)
    if tch == "B":
        return ("b", tok.lower() in ("true", "t", "1"))
    return ("t", "" if tok == "(empty)" else tok)


def _row_keys(rows: List[str], types: str, sep: Optional[str]):
    """Normalized per-row token keys; None when a row cannot be tokenized
    to the arity the type string promises."""
    keys = []
    for row in rows:
        toks = row.split(sep) if sep else row.split()
        if len(types) == 1:
            # single-column rows compare whole-line, whitespace-stripped on
            # BOTH sides (the slt format cannot represent trailing spaces)
            toks = [row.strip()]
        if len(toks) != len(types):
            if len(types) == 1:
                toks = [row.strip()]
            elif (sep is None and len(toks) > len(types)
                    and types.count("T") == 1):
                # a space-separated reference row whose single T column
                # itself contains spaces (e.g. "Decimal128(10, 4) 1.23"
                # under types TR): give the surrounding typed columns one
                # token each and merge the middle back into the T column
                ti = types.index("T")
                ntrail = len(types) - ti - 1
                mid = " ".join(toks[ti:len(toks) - ntrail])
                toks = toks[:ti] + [mid] + (toks[len(toks) - ntrail:]
                                            if ntrail else [])
            else:
                return None
        keys.append(tuple(_norm_token(t, tc) for t, tc in zip(toks, types)))
    return keys


def _match(actual_rows: List[str], ref_expected: Tuple[str, ...],
           types: str, sort_mode: str) -> bool:
    ref = list(ref_expected)
    if len(ref) == 1 and re.match(r"\d+ values hashing to", ref[0]):
        return False  # cannot verify hashed blocks
    if sort_mode == "valuesort":
        a = sorted(v for row in actual_rows for v in row.split("\t"))
        b = sorted(v for row in ref for v in row.split())
        if len(a) != len(b):
            return False
        return all(_norm_token(x, types[0]) == _norm_token(y, types[0])
                   for x, y in zip(a, b))
    ka = _row_keys(actual_rows, types, "\t")
    kb = _row_keys(ref, types, None)
    if ka is None or kb is None or len(ka) != len(kb):
        # fall back to whitespace-collapsed full-line comparison
        na = [" ".join(r.split("\t")) for r in actual_rows]
        nb = [" ".join(r.split()) for r in ref]
        if sort_mode == "rowsort":
            na, nb = sorted(na), sorted(nb)
        return na == nb
    if sort_mode == "rowsort":
        ka, kb = sorted(ka), sorted(kb)
    return ka == kb


def _inline_includes(path: str, seen=None) -> str:
    """Expand `include ./x.slt.part` directives (the reference corpus keeps
    shared DDL in .part files), recursively, relative to the including
    file."""
    import os

    seen = seen or set()
    rp = os.path.realpath(path)
    if rp in seen:
        return ""
    seen.add(rp)
    out = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.lower().startswith("include "):
                inc = os.path.join(os.path.dirname(path), s.split(None, 1)[1])
                if os.path.exists(inc):
                    out.append(_inline_includes(inc, seen))
                continue
            out.append(line)
    return "".join(out)


def port_file(ref_path: str, out_path: str, ctx_factory) -> dict:
    """Replay ref_path against a fresh context; write the surviving records
    to out_path. Returns stats."""
    import os
    import tempfile

    refs = parse_reference_slt(_inline_includes(ref_path))
    data_dir = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(out_path)), "..", "data"))
    scratch = tempfile.mkdtemp(prefix="slt_port_scratch_")
    for r in refs:
        if "'" in r.sql:
            r.sql = rewrite_fixture_paths(r.sql, data_dir)

    def _x(sql: str) -> str:
        return sql.replace("$SLTDATA", data_dir).replace("$SCRATCH", scratch)

    ctx = ctx_factory()
    kept: List[Record] = []
    stats = {"total": len(refs), "kept": 0, "skipped_stmt": 0,
             "failed_stmt": 0, "mismatch": 0, "query_failed": 0,
             "dropped_cond": 0, "error_kept": 0}
    for r in refs:
        if r.condition == "drop":
            stats["dropped_cond"] += 1
            continue
        if r.kind == "statement_ok":
            if _SKIP_SQL.match(r.sql):
                stats["skipped_stmt"] += 1
                continue
            try:
                with _record_deadline(30):
                    ctx.sql(_x(r.sql)).collect()
            except Exception:  # noqa: BLE001
                stats["failed_stmt"] += 1
                continue
            kept.append(Record("statement_ok", r.sql, r.line))
            stats["kept"] += 1
            continue
        if r.kind in ("statement_error", "query_error"):
            try:
                with _record_deadline(30):
                    ctx.sql(_x(r.sql)).collect()
            except TimeoutError:  # noqa: PERF203 -- hang is not an error-match
                continue
            except Exception:  # noqa: BLE001
                kept.append(Record("statement_error", r.sql, r.line))
                stats["kept"] += 1
                stats["error_kept"] += 1
            continue
        # query
        types = re.sub(r"[^IRTBD]", "T", r.types)
        try:
            with _record_deadline(30):
                table = ctx.sql(_x(r.sql)).collect()
                actual = format_rows(table, types, r.sort_mode)
        except Exception:  # noqa: BLE001
            stats["query_failed"] += 1
            continue
        if not _match(actual, r.expected, types, r.sort_mode):
            stats["mismatch"] += 1
            continue
        kept.append(Record("query", r.sql, r.line, types=types,
                           sort_mode=r.sort_mode, expected=tuple(actual)))
        stats["kept"] += 1

    lines = [
        f"# Ported from apache/datafusion sqllogictest corpus "
        f"(Apache-2.0): {ref_path}",
        f"# {stats['kept']} of {stats['total']} records survived the port; "
        "every kept query's values were verified against the reference's",
        "# committed expected output at port time (testing/port_slt.py),",
        "# then re-rendered in this dialect (tab-separated, %.3f reals).",
        "",
    ]
    for rec in kept:
        if rec.kind == "statement_ok":
            lines += ["statement ok", rec.sql, ""]
        elif rec.kind == "statement_error":
            lines += ["statement error", rec.sql, ""]
        else:
            head = f"query {rec.types}"
            if rec.sort_mode != "nosort":
                head += f" {rec.sort_mode}"
            lines += [head, rec.sql, "----", *rec.expected, ""]
    import os

    if stats["kept"] == 0:
        # nothing survived: don't leave a record-less file behind (the
        # runner treats an empty .slt as a parse failure)
        if os.path.exists(out_path):
            os.remove(out_path)
        return stats
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    return stats
