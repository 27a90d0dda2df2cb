# Verbatim copy of datafusion_tpu/models/tpcds/sqlite_oracle.py; host-only, kept in step with the original.
"""SQLite as an independent differential oracle for TPC-DS execution.

The reference checks TPC benchmark answers against committed fixtures
(sqllogictest/test_files/tpch/answers) and runs a postgres differential for
compatibility files (SURVEY.md §4). We have no dsdgen answer fixtures, so the
oracle is a second, unrelated SQL engine: the same generated data (datagen.py)
is loaded into sqlite and every supported query's result frames are compared
(floats to tolerance, rows canonicalized).

Queries are transpiled only where sqlite lacks the syntax:
  * `cast('d' as date) +/- INTERVAL 'n days'` -> `date('d', '+n days')`
    (DATE32 columns surface as ISO text in sqlite, which compares
    lexicographically, so date arithmetic stays correct);
  * `cast(x as decimal(p,s))` -> `cast(x as real)` (sqlite NUMERIC affinity
    would keep integer division semantics);
  * ROLLUP / GROUPING / stddev queries are out of oracle scope (sqlite has
    no equivalents) -- those shapes are covered by the engine's own SLT and
    fuzz suites instead.
"""
from __future__ import annotations

import re
import sqlite3
from typing import Dict, Optional

import numpy as np
import pandas as pd


def _pad_date(d: str) -> str:
    y, m, day = d.split("-")
    return f"{y}-{int(m):02d}-{int(day):02d}"


def to_sqlite_sql(sql: str) -> str:
    # strip the license header comment lines
    sql = "\n".join(l for l in sql.splitlines()
                    if not l.strip().startswith("--"))
    if re.search(r"\brollup\b", sql, re.IGNORECASE):
        sql = expand_rollup(sql)

    def interval_repl(m):
        return f"date('{_pad_date(m.group(1))}', '{m.group(2)}{m.group(3)} days')"

    sql = re.sub(
        r"cast\s*\(\s*'([0-9-]+)'\s+as\s+date\s*\)\s*([+-])\s*"
        r"INTERVAL\s*'(\d+)\s*days?'",
        interval_repl, sql, flags=re.IGNORECASE)
    sql = re.sub(
        r"cast\s*\(\s*'([0-9-]+)'\s+as\s+date\s*\)\s*([+-])\s*(\d+)\s+days?",
        interval_repl, sql, flags=re.IGNORECASE)
    sql = re.sub(r"cast\s*\(\s*'([0-9-]+)'\s+as\s+date\s*\)",
                 lambda m: f"date('{_pad_date(m.group(1))}')", sql,
                 flags=re.IGNORECASE)
    # (d_date + 5) day arithmetic on columns: sqlite date(col, '+5 days')
    sql = re.sub(r"\(\s*([\w.]+)\s*\+\s*(\d+)\s+days?\s*\)",
                 r"date(\1, '+\2 days')", sql, flags=re.IGNORECASE)
    sql = re.sub(r"\bas\s+decimal\s*\(\s*\d+\s*,\s*\d+\s*\)", "as real", sql,
                 flags=re.IGNORECASE)
    sql = re.sub(r"\bas\s+decimal\b", "as real", sql, flags=re.IGNORECASE)
    # column + INTERVAL 'N days' (q72): sqlite date(col, '+N days')
    sql = re.sub(r"([\w.]+)\s*([+-])\s*interval\s*'(\d+)\s*days?'",
                 r"date(\1, '\g<2>\g<3> days')", sql, flags=re.IGNORECASE)
    # parenthesized compound operands `(q1) except (q2)` (q14/q87): sqlite
    # rejects parens around set-op operands; `(q1 except q2)` is equivalent
    sql = re.sub(r"\)\s*(except|intersect|union(?:\s+all)?)\s*\(",
                 r" \1 ", sql, flags=re.IGNORECASE)
    # ORDER BY bare output names sqlite deems ambiguous; the standard (and
    # this engine) resolve them against the SELECT list first (q58, q72)
    sql = re.sub(r"order by item_id\b", "order by 1", sql,
                 flags=re.IGNORECASE)
    sql = re.sub(
        r"(order by total_cnt desc, i_item_desc, w_warehouse_name), d_week_seq",
        r"\1, 3", sql, flags=re.IGNORECASE)
    # bare date literals must be zero-padded: DATE32 columns are ISO text in
    # sqlite and compare lexicographically ('1999-2-01' > '1999-02-01')
    sql = re.sub(r"'(\d{4})-(\d{1,2})-(\d{1,2})'",
                 lambda m: f"'{m.group(1)}-{int(m.group(2)):02d}-{int(m.group(3)):02d}'",
                 sql)
    return sql


_ROLLUP_RE = re.compile(r"group\s+by\s+rollup\s*\(([^)]*)\)", re.IGNORECASE)


def expand_rollup(sql: str) -> str:
    """Rewrite `GROUP BY ROLLUP(a, b, ...)` into a UNION ALL of its grouping
    sets so sqlite (which has no ROLLUP) can serve as the differential
    oracle. Per level k the dropped key columns become NULL in the select
    list and grouping(col) folds to the 0/1 constant. Window functions in
    the same select stay correct because TPC-DS partitions them by the
    grouping level itself. Applies to every ROLLUP occurrence bottom-up."""
    while True:
        m = _ROLLUP_RE.search(sql)
        if m is None:
            return sql
        cols = [c.strip() for c in m.group(1).split(",") if c.strip()]
        # the clause this GROUP BY belongs to: back up to its SELECT by
        # scanning for the enclosing statement start at paren depth 0
        start = m.start()
        depth = 0
        sel_start = 0
        for i in range(start - 1, -1, -1):
            ch = sql[i]
            if ch == ")":
                depth += 1
            elif ch == "(":
                if depth == 0:
                    sel_start = i + 1
                    break
                depth -= 1
        region = sql[sel_start:m.start()]
        # the SELECT owning this GROUP BY is the last depth-0 'select' in
        # the region (anything before it — WITH CTEs — is emitted once)
        depth = 0
        own_sel = 0
        for tm in re.finditer(r"[()]|\bselect\b", region, re.IGNORECASE):
            t = tm.group(0)
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
            elif depth == 0:
                own_sel = tm.start()
        prefix = region[:own_sel]
        body = region[own_sel:]
        # tail after the rollup group-by within the same paren level:
        # HAVING/ORDER/LIMIT or the closing paren
        rest = sql[m.end():]
        depth = 0
        tail_end = len(rest)
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    tail_end = i
                    break
                depth -= 1
        tail = rest[:tail_end]
        after = rest[tail_end:]

        # replacements may only touch the SELECT list — the FROM/WHERE part
        # keeps its own references (subqueries there reuse the same names)
        depth = 0
        from_at = len(body)
        for tm in re.finditer(r"[()]|\bfrom\b", body, re.IGNORECASE):
            t = tm.group(0)
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
            elif depth == 0:
                from_at = tm.start()
                break
        sel_list, from_part = body[:from_at], body[from_at:]

        def level_body(k: int) -> str:
            b = sel_list
            for c in cols[k:]:
                b = re.sub(r"grouping\s*\(\s*" + re.escape(c) + r"\s*\)",
                           "1", b, flags=re.IGNORECASE)
                # bare references become NULL (skip alias-definition sites
                # `... as c` and qualified `t.c` forms)
                b = re.sub(r"(?<![\w.])(?<!as )" + re.escape(c) + r"(?!\w)",
                           "null", b, flags=re.IGNORECASE)
            for c in cols[:k]:
                b = re.sub(r"grouping\s*\(\s*" + re.escape(c) + r"\s*\)",
                           "0", b, flags=re.IGNORECASE)
            g = (" group by " + ", ".join(cols[:k])) if k else ""
            return b + from_part + g

        branches = " union all ".join(
            level_body(k) for k in range(len(cols), -1, -1))
        # wrap so HAVING/ORDER BY exprs see the union's output columns
        # (sqlite restricts compound-select ORDER BY to plain output names)
        sql = (sql[:sel_start] + prefix + "select * from (" + branches + ")"
               + tail + after)
    return sql


def load_sqlite(tables: Dict) -> sqlite3.Connection:
    """Load generated Tables into an in-memory sqlite database. DATE32
    columns become ISO text (lexicographically date-ordered); decimals
    become floats."""
    conn = sqlite3.connect(":memory:")

    class _Stddev:
        """Welford sample/population stddev + variance (sqlite lacks
        stddev_samp; q17/q39 need it)."""

        population = False
        variance = False

        def __init__(self):
            self.n = 0
            self.mean = 0.0
            self.m2 = 0.0

        def step(self, v):
            if v is None:
                return
            v = float(v)
            self.n += 1
            d = v - self.mean
            self.mean += d / self.n
            self.m2 += d * (v - self.mean)

        def finalize(self):
            div = self.n if self.population else self.n - 1
            if div <= 0:
                return None
            var = self.m2 / div
            return var if self.variance else var ** 0.5

    class _StddevPop(_Stddev):
        population = True

    class _VarSamp(_Stddev):
        variance = True

    class _VarPop(_Stddev):
        population = True
        variance = True

    for name_, cls in (("stddev_samp", _Stddev), ("stddev", _Stddev),
                       ("stddev_pop", _StddevPop), ("var_samp", _VarSamp),
                       ("variance", _VarSamp), ("var_pop", _VarPop)):
        conn.create_aggregate(name_, 1, cls)
    for name, t in tables.items():
        df = t.to_pandas()
        for c in df.columns:
            if pd.api.types.is_datetime64_any_dtype(df[c].dtype):
                s = df[c].dt.strftime("%Y-%m-%d")
                df[c] = s.where(df[c].notna(), None)
        df.to_sql(name, conn, index=False)
    return conn


def run_sqlite(conn: sqlite3.Connection, sql: str) -> pd.DataFrame:
    stmts = [s for s in to_sqlite_sql(sql).split(";") if s.strip()]
    for s in stmts[:-1]:  # multi-statement templates (q23/q24): last wins
        pd.read_sql_query(s, conn)
    return pd.read_sql_query(stmts[-1], conn)


def normalize(df: pd.DataFrame) -> pd.DataFrame:
    """Shared canonical form for engine/sqlite frames: positional column
    names (duplicate output names are legal SQL), dates as ISO strings."""
    df = df.copy()
    df.columns = range(len(df.columns))
    for c in df.columns:
        s = df[c]
        if pd.api.types.is_datetime64_any_dtype(s.dtype):
            df[c] = s.dt.strftime("%Y-%m-%d").where(s.notna(), None)
    return df


def frames_match(ours: pd.DataFrame, ref: pd.DataFrame,
                 ordered: bool = False) -> Optional[str]:
    """None when frames agree (column-positional, floats to 1e-6 rtol);
    otherwise a short mismatch description."""
    from ..tpch.compare import frames_diff

    a, b = normalize(ours), normalize(ref)
    # unify numeric column dtypes: sqlite returns int64 where we produce
    # float (avg of ints) and vice versa
    for i in range(min(len(a.columns), len(b.columns))):
        ca, cb = a.columns[i], b.columns[i]
        na = pd.api.types.is_numeric_dtype(a[ca].dtype)
        nb = pd.api.types.is_numeric_dtype(b[cb].dtype)
        if na and nb and a[ca].dtype != b[cb].dtype:
            a[ca] = a[ca].astype(np.float64)
            b[cb] = b[cb].astype(np.float64)
    return frames_diff(a, b, ordered=ordered)
