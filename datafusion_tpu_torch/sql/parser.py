# Verbatim copy of datafusion_tpu/sql/parser.py; host-only, kept in step with the original.
"""Recursive-descent SQL parser.

Capability analog of the reference's DFParser (datafusion/sql/src/parser.rs,
which extends sqlparser-rs): SELECT with joins/subqueries/CTEs/set-ops, the
expression grammar (CASE/CAST/EXTRACT/SUBSTRING/BETWEEN/IN/LIKE/EXISTS/
window OVER), and the DDL used by the CLI (CREATE EXTERNAL TABLE, CREATE
TABLE AS, DROP, EXPLAIN, SHOW, SET)."""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..common import types as T
from ..common.errors import ParseError
from ..expr import nodes as E
from . import ast as A
from .lexer import Token, tokenize


def parse_sql(sql: str, recursion_limit: int = 64,
              float_as_decimal: bool = False) -> List[object]:
    p = Parser(tokenize(sql), recursion_limit=recursion_limit,
               float_as_decimal=float_as_decimal)
    out = []
    while not p.at("eof"):
        out.append(p.statement())
        while p.eat_op(";"):
            pass
    return out


class Parser:
    def __init__(self, tokens: List[Token], recursion_limit: int = 64,
                 float_as_decimal: bool = False):
        self.toks = tokens
        self.i = 0
        self.depth = 0
        self.recursion_limit = recursion_limit
        # sql_parser.parse_float_as_decimal (reference default: false —
        # '1.23' is a Float64 literal)
        self.float_as_decimal = float_as_decimal

    # ---- token helpers ---------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def at(self, kind: str, value: Optional[str] = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def eat_kw(self, *kws: str) -> Optional[str]:
        if self.at_kw(*kws):
            return self.next().value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise ParseError(f"expected {kw.upper()}, got {self.peek()}")

    def eat_op(self, op: str) -> bool:
        if self.at("op", op):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise ParseError(f"expected {op!r}, got {self.peek()}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().value
        if t.kind == "kw":  # allow non-reserved-ish keywords as idents
            return self.next().value
        raise ParseError(f"expected identifier, got {t}")

    def qualified_ident(self) -> str:
        """Dotted object name: table / schema.table / catalog.schema.table."""
        name = self.ident()
        while self.at("op", ".") and self.peek(1).kind in ("ident", "kw"):
            self.next()
            name += "." + self.ident()
        return name

    # ---- statements ------------------------------------------------------
    def statement(self):
        if self.at_kw("explain"):
            self.next()
            analyze = self.eat_kw("analyze") is not None
            fmt = None
            if self.peek().kind == "ident" and \
                    self.peek().value.lower() == "format":
                self.next()
                fmt = self.next().value.lower().strip("'\"")
            return A.Explain(self.select_stmt(), analyze, fmt)
        if self.at_kw("create"):
            return self._create()
        if self.at_kw("drop"):
            self.next()
            if not self.eat_kw("view"):  # DROP TABLE and DROP VIEW share
                self.expect_kw("table")  # the catalog deregistration path
            if_exists = False
            if self.eat_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropTable(self.qualified_ident(), if_exists)
        if self.at_kw("show"):
            self.next()
            t = self.peek()
            word = t.value.lower()
            if word == "tables":
                self.next()
                return A.ShowTables()
            if word == "all":
                self.next()
                verbose = (self.peek().kind == "ident"
                           and self.peek().value.lower() == "verbose")
                if verbose:
                    self.next()
                return A.ShowVariable("all", verbose)
            if word == "columns":
                self.next()
                self.expect_kw("from")
                name = self.qualified_ident()
                like = None
                if self.eat_kw("like"):
                    like = self.next().value
                where = self.expr() if self.eat_kw("where") else None
                return A.ShowColumns(name, like, where)
            if word == "create":
                self.next()
                self.expect_kw("table")
                return A.ShowCreateTable(self.qualified_ident())
            # SHOW <dotted.variable>
            key = self.ident()
            while self.eat_op("."):
                key += "." + self.ident()
            return A.ShowVariable(key)
        if self.at_kw("insert"):
            self.next()
            self.expect_kw("into")
            name = self.qualified_ident()
            cols = None
            if self.at("op", "(") :
                self.next()
                cols = [self.ident()]
                while self.eat_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            if self.at_kw("values"):
                self.next()
                rows = []
                while True:
                    self.expect_op("(")
                    row = [self.expr()]
                    while self.eat_op(","):
                        row.append(self.expr())
                    self.expect_op(")")
                    rows.append(row)
                    if not self.eat_op(","):
                        break
                return A.InsertInto(name, cols, rows)
            return A.InsertInto(name, cols, self.select_stmt())
        if self.at_kw("copy"):
            self.next()
            if self.at("op", "("):
                self.next()
                src = self.select_stmt()
                self.expect_op(")")
            else:
                src = self.qualified_ident()
            self.expect_kw("to")
            path = self.next().value
            fmt = "parquet"
            if self.eat_kw("stored"):
                self.expect_kw("as")
                fmt = self.ident().lower()
            return A.CopyTo(src, path, fmt)
        if self.peek().kind == "ident" and self.peek().value.lower() == "delete":
            self.next()
            self.expect_kw("from")
            name = self.qualified_ident()
            where = self.expr() if self.eat_kw("where") else None
            return A.Delete(name, where)
        if self.peek().kind == "ident" and self.peek().value.lower() == "update":
            self.next()
            name = self.qualified_ident()
            self.expect_kw("set")
            assigns = []
            while True:
                col = self.ident()
                self.expect_op("=")
                assigns.append((col, self.expr()))
                if not self.eat_op(","):
                    break
            where = self.expr() if self.eat_kw("where") else None
            return A.Update(name, assigns, where)
        if self.peek().kind == "ident" and self.peek().value.lower() == "prepare":
            # PREPARE name [(type, ...)] AS <statement>
            self.next()
            name = self.ident()
            types = None
            if self.eat_op("("):
                types = [self.type_name()]
                while self.eat_op(","):
                    types.append(self.type_name())
                self.expect_op(")")
            self.expect_kw("as")
            return A.Prepare(name, types, self.statement())
        if self.peek().kind == "ident" and self.peek().value.lower() == "execute":
            self.next()
            name = self.ident()
            params: List[E.Expr] = []
            if self.eat_op("("):
                if not self.at("op", ")"):
                    params.append(self.expr())
                    while self.eat_op(","):
                        params.append(self.expr())
                self.expect_op(")")
            return A.Execute(name, params)
        if self.peek().kind == "ident" and self.peek().value.lower() == "deallocate":
            self.next()
            if self.peek().kind == "ident" and self.peek().value.lower() == "prepare":
                self.next()
            return A.Deallocate(self.ident())
        if self.at_kw("set"):
            self.next()
            key = self.ident()
            if key.lower() == "time" and self.peek().kind == "ident" \
                    and self.peek().value.lower() == "zone":
                # SET TIME ZONE '<tz>' (reference: datafusion.execution.time_zone)
                self.next()
                t = self.next()
                return A.SetVariable("datafusion.execution.time_zone",
                                     t.value)
            while self.eat_op("."):
                key += "." + self.ident()
            self.expect_op("=")
            t = self.next()
            return A.SetVariable(key, t.value)
        return self.select_stmt()

    _INTERVAL_UNIT_US = {
        "hour": 3_600_000_000, "hr": 3_600_000_000, "h": 3_600_000_000,
        "minute": 60_000_000, "min": 60_000_000,
        "second": 1_000_000, "sec": 1_000_000, "s": 1_000_000,
        "millisecond": 1_000, "ms": 1_000,
        "microsecond": 1, "us": 1,
        "nanosecond": 1e-3, "ns": 1e-3,
    }

    def _interval_literal(self, parts):
        """Multi-part interval string '<n unit [n unit ...]>' (reference:
        arrow-rs parse_interval / MonthDayNano). Stored as one of the three
        interval kinds this engine carries: MONTHS (calendar), DAYS, or US;
        a mix of calendar months and sub-month parts cannot be represented
        and raises."""
        if len(parts) % 2 != 0:
            raise ParseError(f"malformed interval {' '.join(parts)!r}")
        months = 0
        days = 0
        us = 0.0
        for i in range(0, len(parts), 2):
            try:
                n = float(parts[i])
            except ValueError:
                raise ParseError(f"malformed interval quantity {parts[i]!r}")
            unit = parts[i + 1].lower().rstrip("s") or "s"
            if parts[i + 1].lower() in ("s", "ms", "us", "ns"):
                unit = parts[i + 1].lower()
            if unit in ("year", "yr", "y"):
                months += 12 * n
            elif unit in ("month", "mon"):
                months += n
            elif unit in ("week", "w"):
                days += 7 * n
            elif unit in ("day", "d"):
                days += n
            elif unit in self._INTERVAL_UNIT_US:
                us += n * self._INTERVAL_UNIT_US[unit]
            else:
                raise ParseError(f"unsupported interval unit {unit!r}")
        if months and (days or us):
            raise ParseError(
                "mixed month/sub-month intervals are not representable")
        if months:
            if months != int(months):
                days += (months - int(months)) * 30  # arrow: 1 mon = 30 days
                months = int(months)
                if days or us:
                    raise ParseError("fractional months are not representable")
            return E.Literal(int(months), T.INTERVAL_MONTHS)
        if us == 0 and days == int(days):
            return E.Literal(int(days), T.INTERVAL_DAYS)
        total_us = int(round(days * 86_400_000_000 + us))
        return E.Literal(total_us, T.INTERVAL_US)

    def _column_defs(self):
        """Typed column list after an already-consumed '(': name TYPE
        [constraints], ... ')'. Constraint tokens are accepted and ignored."""
        columns = []
        while True:
            cname = self.ident()
            dtype = self.type_name()
            while True:  # constraint tokens we accept and ignore
                if self.eat_kw("not"):
                    self.expect_kw("null")
                elif self.eat_kw("null"):
                    pass
                elif self.peek().kind == "ident" and \
                        self.peek().value.lower() in ("primary", "unique"):
                    self.next()
                    if self.peek().kind == "ident" and \
                            self.peek().value.lower() == "key":
                        self.next()
                else:
                    break
            columns.append((cname, dtype))
            if not self.eat_op(","):
                break
            if self.at("op", ")"):  # trailing comma before ')'
                break
        self.expect_op(")")
        return columns

    def _create(self):
        self.expect_kw("create")
        or_replace = False
        if self.eat_kw("or"):  # CREATE OR REPLACE
            self.expect_kw("replace")
            or_replace = True
        if self.eat_kw("external"):
            # reference grammar (sql/src/parser.rs CreateExternalTable):
            # CREATE EXTERNAL TABLE [IF NOT EXISTS] name [(cols)] STORED AS
            # fmt [WITH HEADER ROW] [WITH ORDER (..)] [DELIMITER c]
            # [PARTITIONED BY (..)] [OPTIONS (k v, ..)] LOCATION p — clause
            # order is free and OPTIONS may follow LOCATION.
            self.expect_kw("table")
            if self.eat_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
            name = self.qualified_ident()
            columns = None
            if self.at("op", "("):
                self.next()
                columns = self._column_defs()
            fmt = None
            has_header = False
            delimiter = ","
            loc = None
            options = {}
            partitioned_by = []
            while True:
                if self.eat_kw("stored"):
                    self.expect_kw("as")
                    fmt = self.ident().lower()
                elif self.eat_kw("with"):
                    if self.eat_kw("header"):
                        self.ident()  # row
                        has_header = True
                    else:  # WITH ORDER (col [ASC|DESC], ...): accepted, inert
                        self.expect_kw("order")
                        self.expect_op("(")
                        depth = 1
                        while depth:
                            t = self.next()
                            if t.kind == "op" and t.value == "(":
                                depth += 1
                            elif t.kind == "op" and t.value == ")":
                                depth -= 1
                elif self.eat_kw("delimiter"):
                    delimiter = self.next().value
                elif self.eat_kw("partitioned"):
                    self.expect_kw("by")
                    self.expect_op("(")
                    partitioned_by.append(self.ident())
                    while self.eat_op(","):
                        partitioned_by.append(self.ident())
                    self.expect_op(")")
                elif self.eat_kw("location"):
                    loc = self.next().value
                elif self.eat_kw("options"):
                    self.expect_op("(")
                    while not self.eat_op(")"):
                        k = self.next().value
                        v = self.next().value
                        options[str(k).lower()] = str(v)
                        self.eat_op(",")
                else:
                    break
            if fmt is None or loc is None:
                raise ParseError("CREATE EXTERNAL TABLE needs STORED AS "
                                 "and LOCATION")
            if options.get("format.has_header", "").lower() == "true":
                has_header = True
            if "format.delimiter" in options:
                delimiter = options["format.delimiter"]
            return A.CreateExternalTable(name, fmt, loc, has_header,
                                         delimiter, columns, options,
                                         partitioned_by)
        is_view = self.eat_kw("view") is not None
        if not is_view:
            self.expect_kw("table")
        if_not_exists = False
        if self.eat_kw("if"):  # IF NOT EXISTS
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        if or_replace and if_not_exists:
            raise ParseError(
                "'IF NOT EXISTS' cannot coexist with 'REPLACE'")
        name = self.qualified_ident()
        columns = None
        if not is_view and self.at("op", "("):
            # typed column list: CREATE TABLE t(a INT, b VARCHAR) [AS ...]
            self.next()
            columns = self._column_defs()
        if self.eat_kw("as"):
            q = self.select_stmt()
        elif columns is not None and not is_view:
            q = None  # empty table from the declared schema
        else:
            self.expect_kw("as")  # raise the usual error
        return A.CreateViewAs(name, q) if is_view \
            else A.CreateTableAs(name, q, columns, or_replace, if_not_exists)

    # ---- queries ---------------------------------------------------------
    def select_stmt(self) -> A.SelectStmt:
        ctes: List[Tuple[str, Optional[List[str]], A.SelectStmt]] = []
        recursive = False
        if self.eat_kw("with"):
            recursive = self.eat_kw("recursive")
            while True:
                name = self.ident()
                cols: Optional[List[str]] = None
                if self.eat_op("("):
                    cols = [self.ident()]
                    while self.eat_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                q = self.select_stmt()
                self.expect_op(")")
                ctes.append((name, cols, q))
                if not self.eat_op(","):
                    break
        body = self.set_expr()
        order_by: List[A.OrderItem] = []
        limit = offset = None
        if self.eat_kw("order"):
            self.expect_kw("by")
            order_by = self.order_items()
        if self.eat_kw("limit"):
            limit = int(self.next().value)
        if self.eat_kw("offset"):
            offset = int(self.next().value)
        return A.SelectStmt(body, ctes, order_by, limit, offset, recursive)

    def order_items(self) -> List[A.OrderItem]:
        items = []
        while True:
            e = self.expr()
            asc = True
            if self.eat_kw("desc"):
                asc = False
            elif self.eat_kw("asc"):
                asc = True
            nf = None
            if self.eat_kw("nulls"):
                w = self.eat_kw("first", "last")
                nf = w == "first"
            items.append(A.OrderItem(e, asc, nf))
            if not self.eat_op(","):
                return items

    def set_expr(self):
        left = self.select_core()
        while self.at_kw("union", "except", "intersect"):
            op = self.next().value
            if op == "union" and self.eat_kw("all"):
                op = "union_all"
            elif self.eat_kw("distinct"):
                pass
            right = self.select_core()
            left = A.SetOp(op, left, right)
        return left

    def select_core(self):
        if self.eat_op("("):
            inner = self.select_stmt()
            self.expect_op(")")
            return inner
        if self.at_kw("values"):
            # bare VALUES statement: SELECT * over an inline relation
            vt = A.ValuesTable(self._values_rows())
            return A.SelectCore([A.SelectItem(A.Star())], [vt], None, None,
                                None, False, None)
        self.expect_kw("select")
        distinct = self.eat_kw("distinct") is not None
        self.eat_kw("all")
        items: List[A.SelectItem] = []
        while True:
            if self.at("op", "*"):
                self.next()
                items.append(A.SelectItem(A.Star()))
            else:
                e = self.expr()
                alias = None
                if self.eat_kw("as"):
                    # single-quoted aliases are accepted like the reference's
                    # generic dialect (TPC-DS writes `... as '30 days'`)
                    if self.peek().kind == "string":
                        alias = self.next().value
                    else:
                        alias = self.ident()
                elif self.peek().kind == "ident":
                    alias = self.next().value
                items.append(A.SelectItem(e, alias))
            if not self.eat_op(","):
                break
        from_: List[object] = []
        if self.eat_kw("from"):
            from_.append(self.table_ref())
            while self.eat_op(","):
                from_.append(self.table_ref())
        where = self.expr() if self.eat_kw("where") else None
        group_by = None
        grouping_sets = None
        if self.eat_kw("group"):
            self.expect_kw("by")
            if self.peek().kind == "ident" and self.peek().value.lower() in ("rollup", "cube") \
                    and self.peek(1).kind == "op" and self.peek(1).value == "(":
                kind = self.ident().lower()
                self.expect_op("(")
                cols = [self.expr()]
                while self.eat_op(","):
                    cols.append(self.expr())
                self.expect_op(")")
                if kind == "rollup":
                    grouping_sets = [cols[:i] for i in range(len(cols), -1, -1)]
                else:  # cube
                    import itertools as _it

                    grouping_sets = [list(sub) for r in range(len(cols), -1, -1)
                                     for sub in _it.combinations(cols, r)]
                group_by = cols
            elif self.peek().kind == "ident" and self.peek().value.lower() == "grouping" \
                    and self.peek(1).kind in ("ident", "kw") and self.peek(1).value.lower() == "sets":
                self.ident()  # GROUPING
                self.ident()  # SETS
                self.expect_op("(")
                grouping_sets = []
                all_cols = []
                while True:
                    self.expect_op("(")
                    s = []
                    if not self.at("op", ")"):
                        s.append(self.expr())
                        while self.eat_op(","):
                            s.append(self.expr())
                    self.expect_op(")")
                    grouping_sets.append(s)
                    for e in s:
                        if e not in all_cols:
                            all_cols.append(e)
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                group_by = all_cols
            else:
                group_by = [self.expr()]
                while self.eat_op(","):
                    group_by.append(self.expr())
        having = self.expr() if self.eat_kw("having") else None
        qualify = None
        if self.peek().kind == "ident" and self.peek().value.lower() == "qualify":
            self.next()
            qualify = self.expr()
        if self._at_window_clause():
            # WINDOW w1 AS (...), w2 AS (...): resolve OVER w references in
            # the select list (reference: sql/src/select.rs named windows)
            self.next()  # 'window'
            named = {}
            while True:
                wname = self.ident().lower()
                self.expect_kw("as")
                named[wname] = self._over_spec()
                if not self.eat_op(","):
                    break
            items = [A.SelectItem(_resolve_named_windows(it.expr, named),
                                  it.alias) if isinstance(it.expr, E.Expr)
                     else it for it in items]
            if qualify is not None:
                qualify = _resolve_named_windows(qualify, named)
        if qualify is None and self.peek().kind == "ident" \
                and self.peek().value.lower() == "qualify":
            self.next()  # QUALIFY may also follow the WINDOW clause
            qualify = self.expr()
        return A.SelectCore(items, from_, where, group_by, having, distinct,
                            grouping_sets, qualify)

    def table_ref(self):
        left = self.table_primary()
        while True:
            kind = None
            if self.eat_kw("cross"):
                self.expect_kw("join")
                kind = "cross"
            elif self.eat_kw("inner"):
                self.expect_kw("join")
                kind = "inner"
            elif self.at_kw("left", "right", "full"):
                kind = self.next().value
                self.eat_kw("outer")
                self.expect_kw("join")
            elif self.eat_kw("join"):
                kind = "inner"
            else:
                return left
            right = self.table_primary()
            on = None
            using = None
            if kind != "cross":
                if self.eat_kw("on"):
                    on = self.expr()
                elif self.eat_kw("using"):
                    self.expect_op("(")
                    using = [self.ident()]
                    while self.eat_op(","):
                        using.append(self.ident())
                    self.expect_op(")")
            left = A.JoinRef(left, right, kind, on, using)

    def _values_rows(self):
        """Rows of a VALUES clause (the VALUES keyword itself)."""
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.expr()]
            while self.eat_op(","):
                row.append(self.expr())
            self.expect_op(")")
            rows.append(row)
            if not self.eat_op(","):
                return rows

    def _table_alias(self):
        """[AS] alias [(col, ...)] after a derived table / VALUES."""
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident" and not self._at_window_clause() \
                and self.peek().value.lower() != "qualify":
            # QUALIFY is reserved as an implicit table alias (sqlparser
            # keeps it reserved for table aliases too)
            alias = self.next().value
        columns = None
        if alias is not None and self.at("op", "("):
            self.next()
            columns = [self.ident()]
            while self.eat_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        return alias, columns

    def table_primary(self):
        if self.at_kw("values") and self.peek(1).kind == "op" \
                and self.peek(1).value == "(":
            # bare FROM VALUES (...), (...) — Spark/reference idiom. The
            # lookahead keeps `FROM values` working for a table named
            # "values" (array.slt fixtures).
            rows = self._values_rows()
            alias, columns = self._table_alias()
            return A.ValuesTable(rows, alias, columns)
        if self.eat_op("("):
            if self.at_kw("values"):
                rows = self._values_rows()
                self.expect_op(")")
                alias, columns = self._table_alias()
                return A.ValuesTable(rows, alias, columns)
            if self.at_kw("select", "with") or self.at("op", "("):
                q = self.select_stmt()
                self.expect_op(")")
                alias, columns = self._table_alias()
                if alias is None:
                    self._anon_derived = getattr(self, "_anon_derived", 0) + 1
                    alias = f"__derived{self._anon_derived}"
                return A.Derived(q, alias, columns)
            inner = self.table_ref()
            self.expect_op(")")
            return inner
        name = self.ident()
        if self.at("op", "("):
            # table function in FROM position
            self.next()
            args: List[E.Expr] = []
            if not self.at("op", ")"):
                args.append(self.expr())
                while self.eat_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            alias, columns = self._table_alias()
            return A.TableFunction(name.lower(), args, alias, columns)
        while self.at("op", ".") and self.peek(1).kind in ("ident", "kw"):
            self.next()
            name += "." + self.ident()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident" and not self._at_window_clause() \
                and self.peek().value.lower() != "qualify":
            # QUALIFY is reserved as an implicit table alias (sqlparser
            # keeps it reserved for table aliases too)
            alias = self.next().value
        return A.Relation(name, alias)

    def _over_spec(self):
        """'(' [PARTITION BY ...] [ORDER BY ...] [frame] ')' -> (partition,
        order, frame) tuple shared by OVER (...) and WINDOW name AS (...)."""
        self.expect_op("(")
        partition_by: List[E.Expr] = []
        order_by: List[E.SortSpec] = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.expr())
            while self.eat_op(","):
                partition_by.append(self.expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            for it in self.order_items():
                order_by.append(E.SortSpec(
                    it.expr, it.asc,
                    it.nulls_first if it.nulls_first is not None else not it.asc))
        frame = self._window_frame()
        self.expect_op(")")
        return (tuple(partition_by), tuple(order_by), frame)

    def _at_window_clause(self) -> bool:
        """True when the upcoming tokens start a named-WINDOW clause
        (`WINDOW name AS (`), which must not be eaten as a table alias."""
        t = self.peek()
        return (t.kind == "ident" and t.value.lower() == "window"
                and self.peek(1).kind in ("ident", "kw")
                and self.peek(2).kind == "kw" and self.peek(2).value == "as")

    # ---- expressions -----------------------------------------------------
    def expr(self) -> E.Expr:
        # bounded nesting, like the reference's sql_parser.recursion_limit
        # (session_state.rs:458): deep expressions error cleanly instead of
        # exhausting the interpreter stack
        self.depth += 1
        if self.depth > self.recursion_limit:
            raise ParseError(
                f"expression nesting exceeds sql_parser.recursion_limit "
                f"({self.recursion_limit})")
        try:
            return self.or_expr()
        finally:
            self.depth -= 1

    def or_expr(self) -> E.Expr:
        left = self.and_expr()
        while self.eat_kw("or"):
            left = E.BinaryOp(E.Op.OR, left, self.and_expr())
        return left

    def and_expr(self) -> E.Expr:
        left = self.not_expr()
        while self.eat_kw("and"):
            left = E.BinaryOp(E.Op.AND, left, self.not_expr())
        return left

    def not_expr(self) -> E.Expr:
        if self.eat_kw("not"):
            return E.Not(self.not_expr())
        return self.comparison()

    def comparison(self) -> E.Expr:
        left = self.additive()
        while True:
            negated = False
            if self.at_kw("not") and self.peek(1).kind == "kw" and self.peek(1).value in ("in", "between", "like", "ilike"):
                self.next()
                negated = True
            if self.at("op") and self.peek().value in ("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                opmap = {"=": E.Op.EQ, "<>": E.Op.NEQ, "!=": E.Op.NEQ, "<": E.Op.LT,
                         "<=": E.Op.LE, ">": E.Op.GT, ">=": E.Op.GE}
                right = self.additive()
                left = E.BinaryOp(opmap[op], left, right)
                continue
            if self.eat_kw("is"):
                neg = self.eat_kw("not") is not None
                if self.eat_kw("null"):
                    left = E.Not(E.IsNull(left)) if neg else E.IsNull(left)
                elif self.eat_kw("true"):
                    e = left
                    left = E.Not(e) if neg else e
                elif self.eat_kw("false"):
                    e = E.Not(left)
                    left = E.Not(e) if neg else e
                else:
                    raise ParseError(f"expected NULL after IS, got {self.peek()}")
                continue
            if self.eat_kw("between"):
                low = self.additive()
                self.expect_kw("and")
                high = self.additive()
                left = E.Between(left, low, high, negated)
                continue
            if self.at_kw("like", "ilike"):
                ci = self.next().value == "ilike"
                pattern = self.additive()
                if self.eat_kw("escape"):
                    self.next()
                left = E.Like(left, pattern, negated, ci)
                continue
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.select_stmt()
                    self.expect_op(")")
                    left = A.SqlInSubquery(left, q, negated)
                else:
                    vals = [self.expr()]
                    while self.eat_op(","):
                        vals.append(self.expr())
                    self.expect_op(")")
                    left = E.InList(left, tuple(vals), negated)
                continue
            return left

    def additive(self) -> E.Expr:
        left = self.multiplicative()
        while True:
            if self.at("op", "+"):
                self.next()
                left = E.BinaryOp(E.Op.ADD, left, self.multiplicative())
            elif self.at("op", "-"):
                self.next()
                left = E.BinaryOp(E.Op.SUB, left, self.multiplicative())
            elif self.at("op", "||"):
                self.next()
                right = self.multiplicative()
                if isinstance(left, E.ScalarFunction) and left.fname == "concat":
                    left = E.ScalarFunction("concat", left.args + (right,))
                else:
                    left = E.ScalarFunction("concat", (left, right))
            else:
                return left

    def multiplicative(self) -> E.Expr:
        left = self.unary()
        while True:
            if self.at("op", "*"):
                self.next()
                left = E.BinaryOp(E.Op.MUL, left, self.unary())
            elif self.at("op", "/"):
                self.next()
                left = E.BinaryOp(E.Op.DIV, left, self.unary())
            elif self.at("op", "%"):
                self.next()
                left = E.BinaryOp(E.Op.MOD, left, self.unary())
            else:
                return left

    def unary(self) -> E.Expr:
        if self.at("op", "-"):
            self.next()
            inner = self.unary()
            if isinstance(inner, E.Literal) and inner.dtype.is_numeric:
                return E.Literal(-inner.value, inner.dtype)
            return E.Negative(inner)
        if self.at("op", "+"):
            self.next()
            return self.unary()
        return self.postfix()

    def postfix(self) -> E.Expr:
        e = self.primary()
        while True:
            if self.at("op", "::"):
                self.next()
                e = E.Cast(e, self.type_name())
            elif self.at("op", "["):  # subscript: arr[i] (1-based) or
                # struct/map field access s['name'] (get_field)
                self.next()
                idx = self.expr()
                self.expect_op("]")
                base = idx.expr if isinstance(idx, E.Alias) else idx
                if isinstance(base, E.Literal) and isinstance(base.value, str):
                    e = E.ScalarFunction("get_field", (e, idx))
                else:
                    e = E.ScalarFunction("array_element", (e, idx))
            elif self.peek().kind == "ident" \
                    and self.peek().value.lower() == "at" \
                    and self.peek(1).kind == "kw" \
                    and self.peek(1).value == "time":
                # expr AT TIME ZONE 'tz' (reference: Expr::Cast to
                # Timestamp(..., tz); this engine is naive-UTC so only
                # UTC-equivalent zones evaluate)
                self.next()
                self.next()
                zt = self.next()
                if not (zt.kind == "ident" and zt.value.lower() == "zone"):
                    raise ParseError("expected ZONE after AT TIME")
                tz = self.next().value
                e = E.ScalarFunction("at_time_zone",
                                     (e, E.Literal(str(tz), T.STRING)))
            else:
                return e

    def _tz_suffix(self):
        """Accept [WITHOUT TIME ZONE] on TIME/TIMESTAMP types; WITH TIME
        ZONE is rejected (naive-UTC engine)."""
        t = self.peek()
        if (t.value or "").lower() in ("with", "without") \
                and (self.peek(1).value or "").lower() == "time" \
                and (self.peek(2).value or "").lower() == "zone":
            word = self.next().value.lower()
            self.next()
            self.next()
            if word == "with":
                raise ParseError("WITH TIME ZONE types are not supported "
                                 "(naive-UTC engine)")

    def type_name(self) -> T.DataType:
        name = self.ident().lower()

        def _int(t: T.DataType) -> T.DataType:
            # optional UNSIGNED widens into the next signed width this
            # engine carries (same convention as arrow_cast UInt mapping)
            if self.peek().kind == "ident" \
                    and self.peek().value.lower() == "unsigned":
                self.next()
                return {T.INT8: T.INT16, T.INT16: T.INT32,
                        T.INT32: T.INT64}.get(t, T.INT64)
            return t

        if name in ("int", "integer"):
            return _int(T.INT32)
        if name == "smallint":
            return _int(T.INT16)
        if name == "tinyint":
            return _int(T.INT8)
        if name == "bigint":
            return _int(T.INT64)
        if name in ("double", "float8"):
            self.eat_kw("precision") or (self.peek().kind == "ident" and self.peek().value.lower() == "precision" and self.next())
            return T.FLOAT64
        if name in ("real", "float", "float4"):
            return T.FLOAT32
        if name in ("decimal", "numeric"):
            p, s = 38, 10
            if self.eat_op("("):
                p = int(self.next().value)
                s = 0
                if self.eat_op(","):
                    s = int(self.next().value)
                self.expect_op(")")
            return T.decimal(p, s)
        if name in ("varchar", "char", "text", "string", "character"):
            if self.eat_op("("):
                self.next()
                self.expect_op(")")
            return T.STRING
        if name in ("binary", "varbinary", "bytea", "blob"):
            if self.eat_op("("):
                self.next()
                self.expect_op(")")
            return T.BINARY
        if name == "date":
            return T.DATE32
        if name == "timestamp":
            # TIMESTAMP(p): fractional-second precision accepted; storage is
            # always microseconds (reference: Timestamp(unit, tz))
            if self.eat_op("("):
                self.next()
                self.expect_op(")")
            self._tz_suffix()
            return T.TIMESTAMP
        if name == "time":
            if self.eat_op("("):
                self.next()
                self.expect_op(")")
            self._tz_suffix()
            return T.TIME
        if name in ("boolean", "bool"):
            return T.BOOL
        if name == "array":
            # ARRAY<T> (Spark) / ARRAY (bare)
            if self.at("op", "<"):
                self.next()
                elem = self.type_name()
                self.expect_op(">")
                return T.list_of(elem)
            return T.list_of(T.INT64)
        if name == "struct" and self.at("op", "<"):
            # struct<INT> (positional c0..) / struct<a INT, b VARCHAR>
            self.next()
            fields = []
            i = 0
            while not self.at("op", ">"):
                if self.peek().kind == "ident" and self.peek(1).kind in (
                        "ident", "kw"):
                    fn = self.ident()
                    ft = self.type_name()
                else:
                    fn = f"c{i}"
                    ft = self.type_name()
                fields.append((fn, ft))
                i += 1
                if not self.eat_op(","):
                    break
            self.expect_op(">")
            return T.struct(tuple(fields))
        if name == "map" and self.at("op", "<"):
            # MAP<K, V> (Spark)
            self.next()
            k = self.type_name()
            self.expect_op(",")
            v = self.type_name()
            self.expect_op(">")
            return T.map_of(k, v) if hasattr(T, "map_of") else T.STRING
        raise ParseError(f"unknown type {name!r}")

    def primary(self) -> E.Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "[":  # array literal [a, b, c]
            self.next()
            items: List[E.Expr] = []
            if not self.at("op", "]"):
                items.append(self.expr())
                while self.eat_op(","):
                    items.append(self.expr())
            self.expect_op("]")
            return E.ScalarFunction("make_array", tuple(items))
        if t.kind == "ident" and t.value.lower() == "array" \
                and self.peek(1).kind == "op" and self.peek(1).value == "[":
            self.next()
            return self.primary()  # ARRAY[...] -> [...]
        if t.kind == "number":
            self.next()
            v = t.value
            if "." in v and "e" not in v.lower() and self.float_as_decimal:
                # sql_parser.parse_float_as_decimal=true (reference
                # config.rs): '1.23' types as Decimal128(p, s) with p/s
                # taken from the digit count, not (38, s)
                digits = len(v.replace(".", "").replace("-", "").lstrip("0")) \
                    or 1
                scale = len(v.split(".", 1)[1])
                return E.Literal(float(v), T.decimal(max(digits, scale), scale))
            if "e" in v.lower() or "." in v:
                # reference default: float literals are Float64
                # (sql/src/planner.rs sql_number_to_expr)
                return E.Literal(float(v), T.FLOAT64)
            return E.Literal(int(v), T.INT64)
        if t.kind == "string":
            self.next()
            return E.Literal(t.value, T.STRING)
        if t.kind == "bytes":
            self.next()
            return E.Literal(bytes.fromhex(t.value), T.BINARY)
        if t.kind == "param":
            self.next()
            return E.Placeholder(t.value)
        if t.kind == "kw":
            kw = t.value
            if kw == "null":
                self.next()
                return E.Literal(None, T.NULL)
            if kw in ("true", "false"):
                self.next()
                return E.Literal(kw == "true", T.BOOL)
            if kw == "date":
                if self.peek(1).kind == "string":
                    self.next()
                    s = self.next().value
                    from ..utils.dates import date_str_to_days

                    return E.Literal(date_str_to_days(s), T.DATE32)
            if kw == "timestamp":
                if self.peek(1).kind == "string":
                    self.next()
                    s = self.next().value
                    import numpy as np

                    return E.Literal(int(np.datetime64(s, "us").astype(np.int64)), T.TIMESTAMP)
            if kw == "time":
                if self.peek(1).kind == "string":
                    self.next()
                    s = self.next().value
                    from ..utils.dates import time_str_to_us

                    return E.Literal(time_str_to_us(s), T.TIME)
            if kw == "interval":
                self.next()
                tv = self.next()
                parts = tv.value.split()
                if len(parts) < 2:
                    # INTERVAL '5' <unit>: unit follows as an identifier
                    unit_toks = [self.ident().lower()]
                    if self.peek().kind == "ident" and \
                            self.peek().value.lower() == "to":
                        # INTERVAL 'a-b' DAY TO SECOND etc: accepted, the
                        # string itself carries the value
                        self.next()
                        self.ident()
                    parts = [tv.value, unit_toks[0]]
                return self._interval_literal(parts)
            if kw == "case":
                return self._case()
            if kw in ("cast", "try_cast"):
                self.next()
                self.expect_op("(")
                inner = self.expr()
                self.expect_kw("as")
                ty = self.type_name()
                self.expect_op(")")
                return E.Cast(inner, ty, safe=kw == "try_cast")
            if kw == "extract":
                self.next()
                self.expect_op("(")
                part = self.ident().lower()
                self.expect_kw("from")
                inner = self.expr()
                self.expect_op(")")
                return E.ScalarFunction("extract", (E.Literal(part, T.STRING), inner))
            if kw == "substring":
                self.next()
                self.expect_op("(")
                inner = self.expr()
                if self.eat_kw("from"):
                    start = self.expr()
                    args = (inner, start)
                    if self.eat_kw("for"):
                        args = args + (self.expr(),)
                else:
                    self.expect_op(",")
                    start = self.expr()
                    args = (inner, start)
                    if self.eat_op(","):
                        args = args + (self.expr(),)
                self.expect_op(")")
                return E.ScalarFunction("substr", args)
            if kw == "exists":
                self.next()
                self.expect_op("(")
                q = self.select_stmt()
                self.expect_op(")")
                return A.SqlExists(q, False)
            if kw == "distinct":
                raise ParseError("unexpected DISTINCT")
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.at_kw("select", "with"):
                q = self.select_stmt()
                self.expect_op(")")
                return A.SqlScalarSubquery(q)
            inner = self.expr()
            self.expect_op(")")
            return inner
        # identifier chain / function call
        if t.kind in ("ident", "kw"):
            name = self.ident()
            if self.at("op", "("):
                return self._function_call(name)
            low = name.lower()
            if low in ("current_date", "current_time", "current_timestamp",
                       "localtime", "localtimestamp"):
                # niladic SQL-standard datetime functions: no parens
                fn = {"localtime": "current_time",
                      "localtimestamp": "current_timestamp"}.get(low, low)
                return E.ScalarFunction(fn, ())
            parts = [name]
            while self.at("op", ".") and self.peek(1).kind in ("ident", "kw"):
                self.next()
                if self.at("op", "*"):
                    self.next()
                    return A.Star(qualifier=parts[0])
                parts.append(self.ident())
            if self.eat_op("."):
                if self.eat_op("*"):
                    return A.Star(qualifier=parts[0])
            if len(parts) == 1:
                return E.Column(parts[0])
            return E.Column(parts[-1], ".".join(parts[:-1]))
        raise ParseError(f"unexpected token {t}")

    _AGG_FNS = {
        "count", "sum", "avg", "mean", "min", "max", "stddev", "stddev_samp",
        "stddev_pop", "var", "var_samp", "var_pop", "median", "approx_median",
        "approx_distinct", "first_value", "last_value", "any_value", "corr",
        "covar", "covar_pop", "covar_samp", "bit_and", "bit_or", "bit_xor",
        "bool_and", "bool_or", "string_agg", "array_agg",
        "approx_percentile_cont", "percentile_cont", "nth_value",
        "regr_slope", "regr_intercept", "regr_count", "regr_r2", "regr_avgx",
        "regr_avgy", "regr_sxx", "regr_syy", "regr_sxy",
        "try_sum", "try_avg", "collect_list",
    }

    # spark-library aliases (reference: spark/src/function/aggregate)
    _AGG_ALIASES = {"try_sum": "sum", "try_avg": "avg",
                    "collect_list": "array_agg"}
    # scalar-name aliases resolved at parse time (reference: each UDF's
    # aliases() list, functions/src/lib.rs)
    _SCALAR_ALIASES = {"date_format": "to_char"}
    _WINDOW_FNS = {"row_number", "rank", "dense_rank", "percent_rank",
                   "cume_dist", "ntile", "lead", "lag", "nth_value"}

    def _arg_expr(self) -> E.Expr:
        """Function argument: a lambda `x -> body` / `(x, i) -> body` or a
        plain expression (reference: Expr::Lambda for higher-order nested
        functions, expr/src/expr.rs lambda variant)."""
        t = self.peek()
        if t.kind == "ident" and self.peek(1).kind == "op" \
                and self.peek(1).value == "->":
            p = self.ident()
            self.next()  # ->
            return E.Lambda((p,), self.expr())
        if t.kind == "op" and t.value == "(" and self.peek(1).kind == "ident":
            # lookahead for "(a, b) ->"
            save = self.i
            self.next()
            params = [self.peek().value]
            j = 1
            ok = True
            while True:
                nxt = self.peek(j)
                if nxt.kind == "op" and nxt.value == ",":
                    pn = self.peek(j + 1)
                    if pn.kind != "ident":
                        ok = False
                        break
                    params.append(pn.value)
                    j += 2
                elif nxt.kind == "op" and nxt.value == ")":
                    after = self.peek(j + 1)
                    ok = after.kind == "op" and after.value == "->"
                    break
                else:
                    ok = False
                    break
            self.i = save
            if ok:
                self.next()  # (
                for k in range(len(params)):
                    self.ident()
                    if k < len(params) - 1:
                        self.expect_op(",")
                self.expect_op(")")
                self.next()  # ->
                return E.Lambda(tuple(params), self.expr())
        e = self.expr()
        if self.eat_kw("as"):
            # struct(1 AS a, 'x' AS b) — named struct fields (reference:
            # sqlparser named function arguments; struct.slt)
            if self.peek().kind == "string":
                return E.Alias(e, self.next().value)
            return E.Alias(e, self.ident())
        return e

    def _function_call(self, name: str) -> E.Expr:
        fname = name.lower()
        self.expect_op("(")
        distinct = self.eat_kw("distinct") is not None
        args: List[E.Expr] = []
        star = False
        agg_order: List[E.SortSpec] = []
        if self.at("op", "*"):
            self.next()
            star = True
        elif not self.at("op", ")"):
            args.append(self._arg_expr())
            while self.eat_op(","):
                args.append(self._arg_expr())
        inner_ignore_nulls = False

        def eat_null_treatment():
            nonlocal inner_ignore_nulls
            t0 = self.peek()
            if t0.kind == "ident" and t0.value.lower() in ("ignore", "respect") \
                    and self.peek(1).kind == "kw" \
                    and self.peek(1).value == "nulls":
                # first_value(x IGNORE NULLS [ORDER BY ..]): null treatment
                # inside the parens (reference: params.null_treatment)
                inner_ignore_nulls = self.next().value.lower() == "ignore"
                self.next()

        eat_null_treatment()
        if self.eat_kw("order"):
            # agg(x ORDER BY y [DESC] [NULLS FIRST|LAST], ...) — reference:
            # AggregateFunction params.order_by
            self.expect_kw("by")
            while True:
                oe = self.expr()
                asc = True
                if self.eat_kw("desc"):
                    asc = False
                else:
                    self.eat_kw("asc")
                nf = not asc
                if self.eat_kw("nulls"):
                    w = self.ident().lower()
                    nf = w == "first"
                agg_order.append(E.SortSpec(oe, asc, nf))
                if not self.eat_op(","):
                    break
        eat_null_treatment()
        self.expect_op(")")

        # WITHIN GROUP (ORDER BY e [DESC]) — ordered-set aggregates
        # (reference: percentile_cont/approx_percentile_cont WITHIN GROUP,
        # functions-aggregate/src/approx_percentile_cont.rs): rewrites to
        # the positional form fn(e, fraction, ...); DESC flips a literal
        # fraction p to 1-p
        if self.peek().kind == "ident" \
                and self.peek().value.lower() == "within" \
                and self.peek(1).kind == "kw" \
                and self.peek(1).value == "group":
            if fname not in ("percentile_cont", "percentile_disc",
                             "approx_percentile_cont",
                             "approx_percentile_cont_with_weight"):
                raise ParseError(
                    f"WITHIN GROUP is only for ordered-set aggregates, "
                    f"not {fname!r}")
            self.next()
            self.next()
            self.expect_op("(")
            self.expect_kw("order")
            self.expect_kw("by")
            oexpr = self.expr()
            desc = False
            if self.eat_kw("desc"):
                desc = True
            else:
                self.eat_kw("asc")
            self.expect_op(")")
            if desc:
                if args and isinstance(args[0], E.Literal) \
                        and isinstance(args[0].value, (int, float)):
                    args[0] = E.Literal(1 - args[0].value, args[0].dtype)
                else:
                    raise ParseError(
                        "WITHIN GROUP (ORDER BY ... DESC) needs a literal "
                        "fraction")
            args = [oexpr] + args
        agg_filter = None
        if self.at("kw", "filter"):
            save = self.i
            self.next()
            if self.eat_op("("):
                self.expect_kw("where")
                agg_filter = self.expr()
                self.expect_op(")")
            else:
                self.i = save  # bare identifier named "filter"

        # IGNORE NULLS / RESPECT NULLS (window null treatment)
        ignore_nulls = False
        t0 = self.peek()
        if t0.kind == "ident" and t0.value.lower() in ("ignore", "respect") \
                and self.peek(1).kind == "kw" and self.peek(1).value == "nulls":
            ignore_nulls = self.next().value.lower() == "ignore"
            self.next()

        over = None
        over_name = None
        if self.eat_kw("over"):
            if self.peek().kind in ("ident", "kw") and not self.at("op", "("):
                # OVER window_name: spec resolved from the WINDOW clause
                # after the select list parses (reference: sqlparser
                # WindowType::NamedWindow)
                over_name = self.ident().lower()
                over = ((), (), None)
            else:
                over = self._over_spec()

        if over is not None:
            if agg_order:
                raise ParseError(
                    "ORDER BY inside a window function call is not supported")
            wf = E.WindowFunction(fname, tuple(args), over[0], over[1],
                                  over[2], agg_filter,
                                  ignore_nulls or inner_ignore_nulls)
            if over_name is not None:
                object.__setattr__(wf, "_named_over", over_name)
            return wf
        if ignore_nulls:
            raise ParseError("IGNORE NULLS requires an OVER clause")

        if fname in self._AGG_FNS:
            fname = self._AGG_ALIASES.get(fname, fname)
            if star or (fname == "count" and not args):
                return E.AggregateFunction("count", (), distinct, agg_filter)
            return E.AggregateFunction(fname, tuple(args), distinct,
                                       agg_filter, tuple(agg_order),
                                       inner_ignore_nulls)
        if agg_filter is not None:
            raise ParseError(f"FILTER clause on non-aggregate function {fname!r}")
        if agg_order:
            raise ParseError(f"ORDER BY inside non-aggregate function {fname!r}")
        return E.ScalarFunction(self._SCALAR_ALIASES.get(fname, fname),
                                tuple(args))

    def _window_frame(self):
        """Frame clause: [ROWS|RANGE|GROUPS] (BETWEEN b AND b | b)
        (reference: sqlparser window frame grammar; semantics
        datafusion/expr/src/window_frame.rs)."""
        units = self.eat_kw("rows", "range", "groups")
        if units is None:
            return None

        def bound():
            if self.eat_kw("unbounded"):
                if self.eat_kw("preceding"):
                    return ("unbounded_preceding", None)
                self.expect_kw("following")
                return ("unbounded_following", None)
            if self.eat_kw("current"):
                self.expect_kw("row")
                return ("current_row", None)
            off = self.expr()
            if not isinstance(off, E.Literal):
                raise ParseError("window frame offset must be a literal")
            if self.eat_kw("preceding"):
                return ("preceding", off.value)
            self.expect_kw("following")
            return ("following", off.value)

        if self.eat_kw("between"):
            s = bound()
            self.expect_kw("and")
            e = bound()
        else:
            s = bound()
            e = ("current_row", None)
        return E.WindowFrame(units, s[0], s[1], e[0], e[1])

    def _case(self) -> E.Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        branches = []
        while self.eat_kw("when"):
            w = self.expr()
            self.expect_kw("then")
            th = self.expr()
            branches.append((w, th))
        else_expr = None
        if self.eat_kw("else"):
            else_expr = self.expr()
        self.expect_kw("end")
        return E.Case(operand, tuple(branches), else_expr)


def _resolve_named_windows(e: E.Expr, named) -> E.Expr:
    """Rebuild WindowFunction nodes carrying an `OVER window_name` reference
    with the named spec from the WINDOW clause."""
    import dataclasses

    def rec(x):
        if isinstance(x, E.Expr):
            nm = getattr(x, "_named_over", None)
            if isinstance(x, E.WindowFunction) and nm is not None:
                spec = named.get(nm)
                if spec is None:
                    raise ParseError(f"window {nm!r} is not defined")
                x = dataclasses.replace(x, partition_by=spec[0],
                                        order_by=spec[1], frame=spec[2])
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            changes = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                nv = rec(v)
                if nv is not v:
                    changes[f.name] = nv
            if changes:
                return dataclasses.replace(x, **changes)
            return x
        if isinstance(x, (list, tuple)):
            out = [rec(i) for i in x]
            if any(a is not b for a, b in zip(out, x)):
                return type(x)(out)
            return x
        return x

    return rec(e)
