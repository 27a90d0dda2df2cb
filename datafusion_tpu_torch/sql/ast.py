# Verbatim copy of datafusion_tpu/sql/ast.py; host-only, kept in step with the original.
"""SQL AST (reference capability: sqlparser-rs AST + DataFusion statements,
datafusion/sql/src/parser.rs). Expressions reuse the logical Expr IR with
three SQL-only subquery wrappers resolved by the planner."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from ..expr import nodes as E


@dataclasses.dataclass(frozen=True, eq=True)
class SqlScalarSubquery(E.Expr):
    query: object  # SelectStmt


@dataclasses.dataclass(frozen=True, eq=True)
class SqlExists(E.Expr):
    query: object
    negated: bool = False


@dataclasses.dataclass(frozen=True, eq=True)
class SqlInSubquery(E.Expr):
    expr: E.Expr
    query: object
    negated: bool = False


@dataclasses.dataclass(frozen=True, eq=True)
class Star(E.Expr):
    qualifier: Optional[str] = None


@dataclasses.dataclass
class SelectItem:
    expr: E.Expr
    alias: Optional[str] = None


@dataclasses.dataclass
class Relation:
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass
class Derived:
    query: "SelectStmt"
    alias: str
    columns: Optional[List[str]] = None  # AS alias(c1, c2, ...) renames


@dataclasses.dataclass
class ValuesTable:
    """Inline VALUES relation: `(VALUES (1,'a'), (2,'b')) AS v(id, s)` or the
    bare `VALUES ...` statement (reference: LogicalPlan::Values,
    expr/src/logical_plan/plan.rs)."""

    rows: List[List[object]]  # E.Expr per cell (literals after folding)
    alias: Optional[str] = None
    columns: Optional[List[str]] = None


@dataclasses.dataclass
class TableFunction:
    """FROM-position function call: `FROM generate_series(1, 10) AS t(n)`
    (reference: functions-table/, TableFunctionImpl)."""

    name: str
    args: List[E.Expr]
    alias: Optional[str] = None
    columns: Optional[List[str]] = None


@dataclasses.dataclass
class JoinRef:
    left: object
    right: object
    kind: str  # inner, left, right, full, cross
    on: Optional[E.Expr] = None
    using: Optional[List[str]] = None


@dataclasses.dataclass
class OrderItem:
    expr: E.Expr
    asc: bool = True
    nulls_first: Optional[bool] = None


@dataclasses.dataclass
class SelectCore:
    items: List[SelectItem]
    from_: List[object]  # Relation | Derived | JoinRef
    where: Optional[E.Expr] = None
    group_by: Optional[List[E.Expr]] = None
    having: Optional[E.Expr] = None
    distinct: bool = False
    grouping_sets: Optional[List[List[E.Expr]]] = None
    # QUALIFY: filter evaluated after window functions (reference:
    # sqllogictest/test_files/qualify.slt, sql/src/select.rs)
    qualify: Optional[E.Expr] = None


@dataclasses.dataclass
class SetOp:
    op: str  # union, union_all, except, intersect
    left: object  # SelectCore | SetOp
    right: object


@dataclasses.dataclass
class SelectStmt:
    body: object  # SelectCore | SetOp
    # each CTE: (name, optional column aliases, query)
    ctes: List[Tuple[str, Optional[List[str]], "SelectStmt"]] = dataclasses.field(default_factory=list)
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    recursive: bool = False  # WITH RECURSIVE


@dataclasses.dataclass
class CreateExternalTable:
    name: str
    format: str  # parquet, csv
    location: str
    has_header: bool = True
    delimiter: str = ","
    # declared (name, DataType) pairs: schema for CSV / rename+coerce others
    columns: Optional[List[Tuple[str, object]]] = None
    options: dict = dataclasses.field(default_factory=dict)
    partitioned_by: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CreateTableAs:
    name: str
    query: Optional[SelectStmt]  # None: empty table from `columns`
    # declared (name, DataType) pairs: rename + coerce the source, or the
    # schema of an empty table when query is None
    columns: Optional[List[Tuple[str, object]]] = None
    or_replace: bool = False
    if_not_exists: bool = False


@dataclasses.dataclass
class CreateViewAs:
    name: str
    query: SelectStmt


@dataclasses.dataclass
class Delete:
    """DELETE FROM t [WHERE pred] (reference: Dml(Delete),
    expr/src/logical_plan/plan.rs:211; test_files/dml_delete.slt)."""
    table: str
    where: Optional[E.Expr] = None


@dataclasses.dataclass
class Update:
    """UPDATE t SET col = expr, ... [WHERE pred] (reference: Dml(Update),
    test_files/dml_update.slt)."""
    table: str
    assignments: List[Tuple[str, E.Expr]] = dataclasses.field(default_factory=list)
    where: Optional[E.Expr] = None


@dataclasses.dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class Explain:
    query: SelectStmt
    analyze: bool = False
    format: Optional[str] = None  # indent | tree (explain.format default)


@dataclasses.dataclass
class ShowVariable:
    """SHOW ALL [VERBOSE] | SHOW <dotted.key> (reference: SqlToRel
    show_variable -> information_schema.df_settings scan)."""
    key: str  # "all" or a dotted option key
    verbose: bool = False


@dataclasses.dataclass
class ShowColumns:
    table: str
    like: Optional[str] = None
    where: Optional[E.Expr] = None


@dataclasses.dataclass
class ShowCreateTable:
    name: str


@dataclasses.dataclass
class ShowTables:
    pass


@dataclasses.dataclass
class SetVariable:
    key: str
    value: str


@dataclasses.dataclass
class InsertInto:
    table: str
    columns: Optional[List[str]]
    source: object  # SelectStmt | list of literal rows


@dataclasses.dataclass
class CopyTo:
    source: object  # SelectStmt | table name str
    path: str
    format: str  # parquet | csv


@dataclasses.dataclass
class Prepare:
    """PREPARE name [(types)] AS statement (reference:
    sql/src/statement.rs Statement::Prepare -> LogicalPlan::Prepare)."""
    name: str
    param_types: object  # Optional[List[DataType]]
    stmt: object


@dataclasses.dataclass
class Execute:
    name: str
    params: list


@dataclasses.dataclass
class Deallocate:
    name: str
