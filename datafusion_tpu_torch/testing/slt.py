# Verbatim copy of datafusion_tpu/testing/slt.py; host-only, kept in step with the original.
"""sqllogictest-style golden-file runner.

Capability analog of the reference's primary test mechanism
(datafusion/sqllogictest/bin/sqllogictests.rs over 193 .slt files): golden
SQL files with expected results, plus a COMPLETION mode that regenerates the
expected blocks from actual engine output (the reference's
`--complete` flag). Dialect (the subset the reference's files use most):

    # comment
    statement ok
    <sql>

    statement error <substring of expected error>
    <sql>

    query <typechars> [nosort|rowsort|valuesort]
    <sql>
    ----
    <expected rows, one per line, values TAB-separated>

Type chars: I(nt) R(eal, 3 decimals) T(ext) B(ool) D(ate) — used for value
formatting, matching sqllogictest conventions: NULL -> "NULL", empty string
-> "(empty)", floats -> %.3f.

Run a file:      run_slt_file(path)            -> list of Failure
Regenerate:      run_slt_file(path, complete=True)  (rewrites expected blocks)
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class Record:
    kind: str                      # 'statement_ok' | 'statement_error' | 'query'
    sql: str
    line: int                      # 1-based line of the directive
    error_substr: str = ""
    types: str = ""
    sort_mode: str = "nosort"
    expected: Tuple[str, ...] = ()


@dataclasses.dataclass
class Failure:
    path: str
    line: int
    sql: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.message}\n  {self.sql}"


def parse_slt(text: str) -> List[Record]:
    lines = text.splitlines()
    records: List[Record] = []
    i = 0
    n = len(lines)

    def skip_blank(j):
        while j < n and (not lines[j].strip() or lines[j].lstrip().startswith("#")):
            j += 1
        return j

    i = skip_blank(i)
    while i < n:
        head = lines[i].strip()
        start = i + 1
        m = re.match(r"statement\s+(ok|error)\s*(.*)", head)
        q = re.match(r"query\s+([IRTBD]+)\s*(nosort|rowsort|valuesort)?\s*$", head)
        if m:
            i += 1
            sql_lines = []
            while i < n and lines[i].strip():
                sql_lines.append(lines[i])
                i += 1
            records.append(Record(
                kind=f"statement_{m.group(1)}",
                sql="\n".join(sql_lines).strip(),
                line=start, error_substr=m.group(2).strip()))
        elif q:
            i += 1
            sql_lines = []
            while i < n and lines[i].strip() and lines[i].strip() != "----":
                sql_lines.append(lines[i])
                i += 1
            expected: List[str] = []
            if i < n and lines[i].strip() == "----":
                i += 1
                while i < n and lines[i].strip():
                    expected.append(lines[i].rstrip("\n"))
                    i += 1
            records.append(Record(
                kind="query", sql="\n".join(sql_lines).strip(), line=start,
                types=q.group(1), sort_mode=q.group(2) or "nosort",
                expected=tuple(expected)))
        elif head.startswith(("onlyif", "skipif", "halt", "hash-threshold")):
            i += 1
            while i < n and lines[i].strip():
                i += 1
        else:
            raise ValueError(f"slt parse error at line {i + 1}: {head!r}")
        i = skip_blank(i)
    return records


def _render_interval_us(us: int) -> str:
    """arrow-rs IntervalMonthDayNano-style display over a microsecond
    duration: nonzero components only, trailing seconds carry a 9-digit
    fraction (reference interval.slt: '5 days', '65 mons 5 days 5 hours
    5 mins 5.005005005 secs')."""
    us = int(us)
    days, rem = abs(us) // 86_400_000_000, abs(us) % 86_400_000_000
    hours, rem = rem // 3_600_000_000, rem % 3_600_000_000
    mins, rem = rem // 60_000_000, rem % 60_000_000
    secs, frac_us = rem // 1_000_000, rem % 1_000_000
    sign = "-" if us < 0 else ""
    parts = []
    if days:
        parts.append(f"{sign}{days} days")
    if hours:
        parts.append(f"{sign}{hours} hours")
    if mins:
        parts.append(f"{sign}{mins} mins")
    if secs or frac_us or not parts:
        parts.append(f"{sign}{secs}.{frac_us * 1000:09d} secs")
    return " ".join(parts)


def format_value(v, tch: str, dtype=None) -> str:
    if v is None:
        return "NULL"
    if dtype is not None:
        from ..common import types as _T

        if dtype.kind is _T.TypeKind.INTERVAL_US:
            import datetime as _dt

            if isinstance(v, _dt.timedelta):
                v = (v.days * 86_400_000_000 + v.seconds * 1_000_000
                     + v.microseconds)
            return _render_interval_us(int(v))
        if dtype.kind is _T.TypeKind.INTERVAL_MONTHS:
            return f"{int(v)} mons"
        if dtype.kind is _T.TypeKind.INTERVAL_DAYS:
            return f"{int(v)} days"
    if tch == "R":
        f = float(v)
        if math.isnan(f):
            return "NaN"
        return f"{f:.3f}"
    if tch == "B":
        return "true" if bool(v) else "false"
    if tch == "I":
        try:
            return str(int(v))
        except (TypeError, ValueError):
            return str(v)
    if isinstance(v, (bytes, bytearray)):
        # binary renders as lowercase hex (arrow-rs Display, binary.slt)
        return bytes(v).hex() or "(empty)"
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        # ISO 'T' separator, trailing-zero-trimmed fraction: the reference
        # engine's timestamp rendering (arrow-rs Display)
        s = v.isoformat()
        if "." in s:
            s = s.rstrip("0").rstrip(".")
        return s
    if isinstance(v, dict):
        # arrow-rs struct/map display: {name: value, ...}, bare strings,
        # NULL for null fields (reference struct.slt)
        return "{" + ", ".join(f"{k}: {_struct_field(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(_struct_field(x) for x in v) + "]"
    s = str(v)
    return "(empty)" if s == "" else s


def _struct_field(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (dict, list)):
        return format_value(v, "T")
    return str(v)


def format_rows(table, types: str, sort_mode: str) -> List[str]:
    """Render a host Table into expected-block lines."""
    cols = [table.columns[i] for i in range(len(table.schema.fields))]
    pylists = [
        _pylist(table, i) for i in range(len(cols))
    ]
    nrows = table.num_rows
    rows = []
    for r in range(nrows):
        vals = []
        for c in range(len(cols)):
            tch = types[c] if c < len(types) else "T"
            vals.append(format_value(pylists[c][r], tch,
                                     table.schema.fields[c].dtype))
        rows.append("\t".join(vals))
    if sort_mode == "rowsort":
        rows.sort()
    elif sort_mode == "valuesort":
        rows = sorted(v for row in rows for v in row.split("\t"))
    return rows


def _pylist(table, i: int) -> list:
    from ..data.table import _to_pylist

    return _to_pylist(table.schema.fields[i].dtype, table.columns[i])


def run_records(records: List[Record], ctx, path: str = "<slt>",
                complete: bool = False) -> Tuple[List[Failure], List[Record]]:
    """Execute records against a SessionContext. Returns (failures,
    possibly-updated records). With complete=True, query expectations are
    REPLACED by actual output (and never fail).

    Path tokens from the porter are substituted per run: $SLTDATA ->
    the corpus fixture dir (tests/slt/data, located relative to `path`),
    $SCRATCH -> a fresh temp dir (COPY targets / external-table outputs)."""
    failures: List[Failure] = []
    updated: List[Record] = []
    subs = None
    if any("$SLTDATA" in r.sql or "$SCRATCH" in r.sql for r in records):
        import os
        import tempfile

        base = os.path.dirname(os.path.abspath(path))
        data = None
        for up in (".", "..", "../.."):
            cand = os.path.normpath(os.path.join(base, up, "data"))
            if os.path.isdir(cand):
                data = cand
                break
        subs = (data or "tests/slt/data", tempfile.mkdtemp(prefix="slt_scratch_"))

    def _exec_sql(r):
        if subs is None:
            return r.sql
        return (r.sql.replace("$SLTDATA", subs[0])
                     .replace("$SCRATCH", subs[1]))

    for rec in records:
        if rec.kind == "statement_ok":
            try:
                ctx.sql(_exec_sql(rec)).collect()
            except Exception as exc:  # noqa: BLE001
                failures.append(Failure(path, rec.line, rec.sql,
                                        f"statement failed: {exc}"))
            updated.append(rec)
            continue
        if rec.kind == "statement_error":
            try:
                ctx.sql(_exec_sql(rec)).collect()
                failures.append(Failure(path, rec.line, rec.sql,
                                        "expected an error, statement succeeded"))
            except Exception as exc:  # noqa: BLE001
                if rec.error_substr and rec.error_substr.lower() not in str(exc).lower():
                    failures.append(Failure(
                        path, rec.line, rec.sql,
                        f"error {exc!r} does not contain {rec.error_substr!r}"))
            updated.append(rec)
            continue
        # query
        try:
            table = ctx.sql(_exec_sql(rec)).collect()
            actual = format_rows(table, rec.types, rec.sort_mode)
        except Exception as exc:  # noqa: BLE001
            failures.append(Failure(path, rec.line, rec.sql, f"query failed: {exc}"))
            updated.append(rec)
            continue
        if complete:
            updated.append(dataclasses.replace(rec, expected=tuple(actual)))
            continue
        if list(rec.expected) != actual:
            diff = _first_diff(list(rec.expected), actual)
            failures.append(Failure(path, rec.line, rec.sql, diff))
        updated.append(rec)
    return failures, updated


def _first_diff(expected: List[str], actual: List[str]) -> str:
    if len(expected) != len(actual):
        return (f"row count {len(actual)} != expected {len(expected)}\n"
                f"  actual:   {actual[:4]}\n  expected: {expected[:4]}")
    for i, (e, a) in enumerate(zip(expected, actual)):
        if e != a:
            return f"row {i}: actual {a!r} != expected {e!r}"
    return "mismatch"


def render(records: List[Record]) -> str:
    out: List[str] = []
    for rec in records:
        if rec.kind == "statement_ok":
            out.append("statement ok")
            out.append(rec.sql)
        elif rec.kind == "statement_error":
            out.append(f"statement error {rec.error_substr}".rstrip())
            out.append(rec.sql)
        else:
            mode = "" if rec.sort_mode == "nosort" else f" {rec.sort_mode}"
            out.append(f"query {rec.types}{mode}")
            out.append(rec.sql)
            out.append("----")
            out.extend(rec.expected)
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def run_slt_file(path: str, ctx=None, complete: bool = False) -> List[Failure]:
    """Run (or, with complete=True, regenerate) one .slt file."""
    if ctx is None:
        from ..context import SessionContext

        ctx = SessionContext()
        if "spark" in os.path.basename(path).split("__")[0]:
            # spark/ corpus files were ported under the Spark-semantics
            # function library; replay them the same way
            ctx.enable_spark_functions()
    with open(path) as f:
        records = parse_slt(f.read())
    failures, updated = run_records(records, ctx, path, complete=complete)
    if complete and not failures:
        with open(path, "w") as f:
            f.write(render(updated))
    return failures
