"""SessionContext + DataFrame: the user-facing API.

Port of datafusion_tpu/context.py: register in-memory tables, pyarrow
tables, pandas frames, files (Parquet, CSV, JSON, Arrow IPC, Avro) and
native plugins; register user-defined functions (scalar, aggregate, window,
table and host/async ones) and the Spark function library; run the
session's statements (SELECT, EXPLAIN [ANALYZE], CREATE [EXTERNAL] TABLE,
CREATE VIEW, DROP TABLE, COPY ... TO, INSERT INTO, DELETE, UPDATE, SHOW,
SET, PREPARE/EXECUTE/DEALLOCATE) or build plans with the DataFrame methods;
collect results. Plans run on the session's device, which is the CUDA card
unless the caller passes another (`SessionContext(device="cpu")`): operator
by operator the first time a DataFrame is collected, then as a steady state
(physical/fused.py). A session with a memory limit
(`execution.memory_limit_bytes`) streams a query whose scans would not fit
in it chunk by chunk instead (`execution.out_of_core`, physical/chunked.py),
as it does every query over a streaming table (`register_streaming_table`);
`DataFrame.execute_stream` yields a query's answer chunk by chunk. Plans
travel as Substrait (`to_substrait`/`from_substrait`) and as DataFusion's
protobuf LogicalPlanNode (`to_proto`/`from_proto`); a decoded plan runs as
one planned from SQL does."""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Union as TyUnion

from .catalog.catalog import (ArrowTable, AvroTable, Catalog, CsvTable,
                              JsonTable, MemTable, ParquetTable, TableProvider)
from .common import types as T
from .common.errors import PlanError
from .common.schema import Field, Schema
from .expr import nodes as E
from .data.device import resolve_device, to_host
from .data.table import Table
from .expr.udf import (AggregateUDF, FunctionRegistry, ScalarUDF, TableUDF,
                       WindowUDF, make_async_scalar, with_registry)
from .logical import plan as L
from .physical.planner import create_physical_plan
from .runtime.context import ExecContext, planning_device


class SessionContext:
    def __init__(self, config: Optional[Dict] = None, device=None):
        """device=None means the CUDA card, and raises when there is none;
        pass device="cpu" to run on the CPU."""
        from .common.config import ConfigOptions

        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.config = dict(config or {})
        self.options = ConfigOptions(self.config)
        self.functions = FunctionRegistry()
        self._prepared: Dict[str, object] = {}  # PREPARE name -> A.Prepare
        self._cancel = threading.Event()
        # back-link for session-scoped virtual tables
        # (information_schema.df_settings / routines)
        self.catalog.session = self

    def interrupt(self):
        """Cancel queries currently executing under this session (analog of
        dropping the reference's record-batch stream): the cooperative check
        runs at every operator dispatch and chunk, so a steady state (one
        CUDA graph replay) cancels at its next collect()."""
        self._cancel.set()

    def register_object_store(self, url: str, store) -> None:
        """Register an ObjectStore for a URL scheme/authority so external
        tables can point at non-local locations (reference:
        RuntimeEnv::register_object_store,
        execution/src/object_store.rs ObjectStoreRegistry)."""
        from .io.object_store import default_registry

        default_registry().register(url, store)

    def register_table(self, name: str, data) -> None:
        if isinstance(data, TableProvider):
            self.catalog.register(name, data)
        elif isinstance(data, Table):
            self.catalog.register(name, MemTable(data))
        elif isinstance(data, dict):
            self.catalog.register(name, MemTable(Table.from_pydict(data)))
        else:
            import pandas as pd
            import pyarrow as pa

            if isinstance(data, pa.Table):
                self.catalog.register(name, MemTable(Table.from_arrow(data)))
            elif isinstance(data, pd.DataFrame):
                self.catalog.register(name, MemTable(Table.from_pandas(data)))
            else:
                raise PlanError(f"cannot register {type(data)}")

    def register_streaming_table(self, name: str, batches, schema,
                                 unbounded: bool = False) -> None:
        """Register a stream of record batches (reference: StreamingTable /
        StreamingTableExec, physical-plan/src/streaming.rs:63). `batches` is
        a zero-argument callable returning an iterator of host Tables or
        pydicts; `schema` is a Schema or {name: DataType}. Over an unbounded
        stream only pipeline-friendly plans (filters, projections, limits,
        INNER stream joins) run, incrementally."""
        from .catalog.catalog import StreamingTable

        if isinstance(schema, dict):
            schema = Schema([Field(n, t) for n, t in schema.items()])
        self.catalog.register(name, StreamingTable(schema, batches, unbounded))

    def register_parquet(self, name: str, path: str) -> None:
        self.catalog.register(name, ParquetTable(path))

    def register_csv(self, name: str, path: str, has_header: bool = True,
                     delimiter: str = ",") -> None:
        self.catalog.register(name, CsvTable(path, has_header, delimiter))

    def register_json(self, name: str, path: str) -> None:
        self.catalog.register(name, JsonTable(path))

    def deregister_table(self, name: str) -> None:
        self.catalog.deregister(name)

    # ---- user-defined functions (reference: expr/src/udf.rs:537,
    # SessionContext::register_udf, core/src/execution/context/mod.rs) ------
    def register_udf(self, name: str, fn, return_type: T.DataType,
                     nullable: bool = True) -> None:
        """Register a scalar UDF callable from SQL and the DataFrame API.

        `fn` receives one torch tensor per argument on the session's device
        (vectorized over the whole column; decimals arrive descaled as
        float64, dates as int32 days) and returns a tensor, or a (tensor,
        validity) pair for custom NULL semantics."""
        self.functions.register_scalar(ScalarUDF(name, fn, return_type, nullable))

    def register_udaf(self, name: str, state, combine, identity, finalize,
                      return_type: T.DataType, nullable: bool = True) -> None:
        """Register an aggregate UDF as a commutative monoid:
        state(x) -> pytree of per-row tensors, combine(a, b) -> pytree
        (associative), identity a pytree of scalars, finalize(state) ->
        values. One segmented associative scan evaluates it per group
        (reference: udaf.rs + accumulator.rs:51 state/merge_batch contract)."""
        self.functions.register_aggregate(
            AggregateUDF(name, state, combine, identity, finalize,
                         return_type, nullable))

    def register_udwf(self, name: str, state, combine, identity, finalize,
                      return_type: T.DataType, nullable: bool = True) -> None:
        """Register a window UDF (same monoid spec, evaluated as a running
        partition-resetting scan over the default frame; reference: udwf.rs)."""
        self.functions.register_window(
            WindowUDF(name, state, combine, identity, finalize,
                      return_type, nullable))

    def register_async_udf(self, name: str, fn, return_type: T.DataType,
                           nullable: bool = True) -> None:
        """Register a host-side (optionally `async def`) scalar function --
        e.g. a remote-service or model call -- invoked once per batch with
        numpy arrays; its result goes back to the session's device. A query
        holding one runs eagerly, outside a captured CUDA graph (reference:
        AsyncFuncExec, physical-plan/src/async_func.rs)."""
        self.functions.register_scalar(
            make_async_scalar(name, fn, return_type, nullable))

    def enable_spark_functions(self) -> None:
        """Opt this session into the Spark-compatible function library
        (reference: datafusion-spark crate, spark/src/function/): Spark-only
        names (sha2, crc32, elt, date_add, ...) become available, and names
        whose Spark semantics differ (round = HALF_UP, substring with
        negative positions) switch to the Spark behavior."""
        self.functions.spark = True

    def register_plugin(self, path: str) -> dict:
        """Load a native plugin shared library (see native/plugin.h): its
        table providers join the catalog (rows cross the boundary as Arrow
        record batches over the Arrow C Data Interface) and its scalar
        functions become SQL-callable host functions (reference:
        datafusion-ffi crate, ffi/src/lib.rs:28-55)."""
        from .interchange.ffi import load_plugin

        return load_plugin(self, path)

    def register_udtf(self, name: str, fn) -> None:
        """Register a table function usable in FROM position:
        `fn(*literal_args)` runs host-side and returns a dict of columns or a
        Table (reference: TableFunctionImpl, catalog/src/table.rs;
        functions-table/)."""
        self.functions.register_table_function(TableUDF(name, fn))

    # ---- plan entry points ----------------------------------------------
    def table(self, name: str) -> "DataFrame":
        return DataFrame(self, L.TableScan(name, self.catalog.get(name)))

    def from_substrait(self, doc) -> "DataFrame":
        """Bind a Substrait plan (proto3-JSON dict or JSON string) against
        this session's catalog (reference analog:
        substrait/src/logical_plan/consumer.rs)."""
        import json as _json

        from .interchange.substrait import plan_from_substrait

        if isinstance(doc, (str, bytes)):
            doc = _json.loads(doc)
        return DataFrame(self, plan_from_substrait(doc, self.catalog))

    def from_proto(self, data: bytes) -> "DataFrame":
        """Bind a DataFusion-protobuf-serialized LogicalPlanNode against
        this session's catalog (reference analog:
        proto/src/bytes/mod.rs logical_plan_from_bytes)."""
        from .interchange.dfproto import plan_from_proto_bytes

        return DataFrame(self, plan_from_proto_bytes(data, self.catalog))

    @with_registry
    def sql(self, query: str) -> "DataFrame":
        """Run one or more SQL statements; DDL runs at once, the last query
        statement is returned lazily as a DataFrame (an empty one when there
        is none)."""
        from .sql import ast as A
        from .sql.parser import parse_sql
        from .sql.planner import SqlPlanner

        opts = self.options.to_dict()
        stmts = parse_sql(
            query,
            recursion_limit=int(opts.get("sql_parser.recursion_limit", 64)),
            float_as_decimal=bool(
                opts.get("sql_parser.parse_float_as_decimal", False)))
        out: Optional[DataFrame] = None
        with planning_device(self.device):  # VALUES cells evaluate here
            for stmt in stmts:
                out = self._run_statement(stmt, A, SqlPlanner)
        if out is None:
            out = DataFrame(self, L.EmptyRelation(False))
        return out

    def _run_statement(self, stmt, A, SqlPlanner) -> Optional["DataFrame"]:
        if isinstance(stmt, A.Prepare):
            # reference: LogicalPlan::Statement(Prepare) stored on the
            # session; EXECUTE re-plans with params substituted
            # (expr/src/logical_plan/plan.rs replace_params_with_values)
            self._prepared[stmt.name.lower()] = stmt
            return None
        if isinstance(stmt, A.Execute):
            prep = self._prepared.get(stmt.name.lower())
            if prep is None:
                raise PlanError(f"prepared statement {stmt.name!r} not found")
            values = []
            for i, p in enumerate(stmt.params):
                if not isinstance(p, E.Literal):
                    raise PlanError("EXECUTE parameters must be literals")
                if prep.param_types and i < len(prep.param_types):
                    values.append(E.Literal(p.value, prep.param_types[i]))
                else:
                    values.append(p)
            return self._run_statement(_replace_params(prep.stmt, values),
                                       A, SqlPlanner)
        if isinstance(stmt, A.Deallocate):
            if stmt.name.lower() not in self._prepared:
                raise PlanError(f"prepared statement {stmt.name!r} not found")
            del self._prepared[stmt.name.lower()]
            return None
        if isinstance(stmt, A.SelectStmt):
            return DataFrame(self, SqlPlanner(self.catalog).plan_statement(stmt))
        if isinstance(stmt, A.Explain):
            df = DataFrame(self, SqlPlanner(self.catalog).plan_statement(stmt.query))
            text = (df.explain_analyze() if stmt.analyze
                    else df.explain(format=getattr(stmt, "format", None)))
            lines = Table.from_pydict({"plan": text.splitlines()},
                                      {"plan": T.STRING})
            return DataFrame(self, L.TableScan("explain", MemTable(lines)))
        if isinstance(stmt, A.CreateExternalTable):
            self.catalog.register(stmt.name, _file_table(stmt))
            return None
        if isinstance(stmt, A.CreateTableAs):
            self._create_table(stmt, SqlPlanner)
            return None
        if isinstance(stmt, A.CreateViewAs):
            plan = SqlPlanner(self.catalog).plan_statement(stmt.query)
            self.catalog.views[stmt.name.lower()] = plan
            return None
        if isinstance(stmt, A.DropTable):  # an absent table is not an error
            self.catalog.deregister(stmt.name)
            self.catalog.views.pop(stmt.name.lower(), None)
            return None
        if isinstance(stmt, A.ShowTables):
            return self._strings({"table_name": self.catalog.names()})
        if isinstance(stmt, A.ShowVariable):
            return self._show_variable(stmt)
        if isinstance(stmt, A.ShowColumns):
            return self._show_columns(stmt, SqlPlanner)
        if isinstance(stmt, A.ShowCreateTable):
            return self._show_create_table(stmt)
        if isinstance(stmt, A.SetVariable):
            # parse through the typed registry first; storing the raw string
            # in self.config would override the parsed value in exec_context
            # (and e.g. "false" is truthy)
            self.options.set(stmt.key, stmt.value)
            self.config[stmt.key] = self.options.to_dict().get(
                stmt.key, stmt.value)
            return None
        if isinstance(stmt, A.InsertInto):
            return self._insert_into(stmt, SqlPlanner)
        if isinstance(stmt, A.Delete):
            return self._delete(stmt, A, SqlPlanner)
        if isinstance(stmt, A.Update):
            return self._update(stmt, A, SqlPlanner)
        if isinstance(stmt, A.CopyTo):
            if isinstance(stmt.source, str):
                table = self.table(stmt.source).collect()
            else:
                table = DataFrame(self, SqlPlanner(self.catalog).plan_statement(
                    stmt.source)).collect()
            _write_table(table, stmt.format, stmt.path)
            return self._dml_count(table.num_rows)
        raise PlanError(f"unsupported statement {type(stmt).__name__}")

    def _create_table(self, stmt, SqlPlanner) -> None:
        """CREATE [OR REPLACE] TABLE [IF NOT EXISTS] t AS SELECT ... (a
        declared column list renames and casts the query's columns) and
        CREATE TABLE t(a INT, ...), an empty table; the result is held as an
        in-memory table."""
        try:
            self.catalog.get(stmt.name)
            exists = True
        except Exception:  # noqa: BLE001 -- absent name
            exists = False
        if exists:
            if stmt.if_not_exists:
                return
            if not stmt.or_replace:
                raise PlanError(f"Table '{stmt.name}' already exists")
        cols = getattr(stmt, "columns", None)
        if stmt.query is None:
            self.register_table(stmt.name, Table.from_pydict(
                {n: [] for n, _ in cols}, {n: dt for n, dt in cols}))
            return
        plan = SqlPlanner(self.catalog).plan_statement(stmt.query)
        if cols:
            fields = plan.schema.fields
            if len(fields) != len(cols):
                raise PlanError(
                    f"CREATE TABLE {stmt.name}: {len(cols)} declared "
                    f"columns but query produces {len(fields)}")
            plan = L.Projection(plan, [
                E.Alias(E.Cast(E.Column(f.name, f.qualifier), dt, False), n)
                for f, (n, dt) in zip(fields, cols)])
        self.register_table(stmt.name, DataFrame(self, plan).collect())

    def _strings(self, rows: Dict[str, list], nullable=()) -> "DataFrame":
        """A statement's answer: string columns, given column-wise."""
        names = list(rows)
        n = len(rows[names[0]])
        return DataFrame(self, L.Values(
            Schema([Field(c, T.STRING, c in nullable) for c in names]),
            [[E.lit(rows[c][i]) for c in names] for i in range(n)]))

    def _show_variable(self, stmt) -> "DataFrame":
        """SHOW ALL [VERBOSE] | SHOW <key> (reference: SqlToRel
        show_variable -> information_schema.df_settings)."""
        from .common.config import REGISTRY

        if stmt.key.lower() == "all":
            keys = sorted(REGISTRY)
            rows = {"name": keys,
                    "value": [str(self.options.get(k)) for k in keys]}
            if stmt.verbose:
                rows["description"] = [REGISTRY[k].doc for k in keys]
        else:
            v = self.options.get(stmt.key)
            if v is None and stmt.key not in REGISTRY:
                raise PlanError(f"unknown configuration option {stmt.key!r}")
            rows = {"name": [stmt.key], "value": [str(v)]}
        return self._strings(rows)

    def _show_columns(self, stmt, SqlPlanner) -> "DataFrame":
        """SHOW COLUMNS FROM t [LIKE pat | WHERE pred]."""
        import re

        prov = self.catalog.get(stmt.table)
        like_re = None
        if stmt.like is not None:
            pat = re.escape(stmt.like).replace("%", ".*").replace("_", ".")
            like_re = re.compile(f"^{pat}$", re.IGNORECASE)
        names, types_, nulls = [], [], []
        for f in prov.schema().fields:
            if like_re is not None and not like_re.match(f.name):
                continue
            names.append(f.name)
            types_.append(repr(f.dtype))
            nulls.append("YES" if f.nullable else "NO")
        n = len(names)
        cols = {"table_catalog": [self.catalog.default_catalog] * n,
                "table_schema": [self.catalog.default_schema] * n,
                "table_name": [stmt.table] * n, "column_name": names,
                "data_type": types_, "is_nullable": nulls}
        t = Table.from_pydict(cols, {c: T.STRING for c in cols})
        plan: L.LogicalPlan = L.TableScan("columns", MemTable(t), alias="columns")
        if stmt.where is not None:
            plan = L.Filter(plan, SqlPlanner(self.catalog).resolve(
                stmt.where, plan.schema))
        return DataFrame(self, plan)

    def _show_create_table(self, stmt) -> "DataFrame":
        """SHOW CREATE TABLE: a view's definition unparsed to SQL, NULL for
        a table."""
        from .sql.unparser import plan_to_sql

        vname = stmt.name.lower()
        definition = None
        if vname in self.catalog.views:
            try:
                definition = ("CREATE VIEW " + stmt.name + " AS "
                              + plan_to_sql(self.catalog.views[vname]))
            except Exception:  # noqa: BLE001 -- not unparseable: NULL
                definition = None
        else:
            self.catalog.get(stmt.name)  # raises if absent
        return self._strings({"table_catalog": [self.catalog.default_catalog],
                              "table_schema": [self.catalog.default_schema],
                              "table_name": [stmt.name],
                              "definition": [definition]},
                             nullable=("definition",))

    def _dml_count(self, n: int) -> "DataFrame":
        return DataFrame(self, L.Values(
            Schema([Field("count", T.INT64, False)]), [[E.lit(int(n))]]))

    def _delete(self, stmt, A, SqlPlanner) -> "DataFrame":
        """Eager DELETE on a registered table: keep rows where the predicate
        is not TRUE, re-register (reference: LogicalPlan::Dml(Delete),
        expr/src/logical_plan/plan.rs:211; test_files/dml_delete.slt)."""
        target = self.catalog.get(stmt.table).host_table()
        n_before = target.num_rows
        if stmt.where is None:
            new = Table.from_pydict(
                {f.name: [] for f in target.schema.fields},
                {f.name: f.dtype for f in target.schema.fields})
        else:
            # DELETE removes rows where pred IS TRUE; NULL predicates keep
            keep = E.Not(E.ScalarFunction(
                "coalesce", (stmt.where, E.lit(False))))
            core = A.SelectCore([A.SelectItem(A.Star())],
                                [A.Relation(stmt.table)], keep)
            new = DataFrame(self, SqlPlanner(self.catalog).plan_statement(
                A.SelectStmt(core))).collect()
        self.catalog.register(stmt.table, MemTable(new))
        return self._dml_count(n_before - new.num_rows)

    def _update(self, stmt, A, SqlPlanner) -> "DataFrame":
        """Eager UPDATE: rewrite assigned columns through CASE WHEN pred,
        re-register (reference: Dml(Update), test_files/dml_update.slt)."""
        target = self.catalog.get(stmt.table).host_table()
        assigned = {c.lower(): e for c, e in stmt.assignments}
        unknown = [c for c in assigned
                   if c not in [f.name.lower() for f in target.schema.fields]]
        if unknown:
            raise PlanError(f"UPDATE column(s) not in table: {unknown}")
        items = []
        for f in target.schema.fields:
            if f.name.lower() in assigned:
                newv = E.Cast(assigned[f.name.lower()], f.dtype, False)
                e = (newv if stmt.where is None else
                     E.Case(None, ((stmt.where, newv),), E.Column(f.name)))
            else:
                e = E.Column(f.name)
            items.append(A.SelectItem(e, f.name))
        core = A.SelectCore(items, [A.Relation(stmt.table)])
        new = DataFrame(self, SqlPlanner(self.catalog).plan_statement(
            A.SelectStmt(core))).collect()
        if stmt.where is None:
            n = target.num_rows
        else:
            cnt_core = A.SelectCore(
                [A.SelectItem(E.AggregateFunction("count", ()), "count")],
                [A.Relation(stmt.table)], stmt.where)
            cnt = DataFrame(self, SqlPlanner(self.catalog).plan_statement(
                A.SelectStmt(cnt_core))).collect().to_pydict()
            n = int(cnt["count"][0])
        self.catalog.register(stmt.table, MemTable(new))
        return self._dml_count(n)

    def _insert_into(self, stmt, SqlPlanner) -> "DataFrame":
        """Eager INSERT INTO: the table's rows and the new ones, re-registered
        as an in-memory table (a DataFrame planned before keeps the old
        provider)."""
        target = self.catalog.get(stmt.table).host_table()
        if isinstance(stmt.source, list):  # VALUES rows
            names = stmt.columns or target.schema.names()
            data = {n: [] for n in names}
            for row in stmt.source:
                for n, litexpr in zip(names, row):
                    v = litexpr.value if isinstance(litexpr, E.Literal) else None
                    if isinstance(litexpr, E.Negative) and isinstance(litexpr.expr, E.Literal):
                        v = -litexpr.expr.value
                    data[n].append(v)
            types = {f.name: f.dtype for f in target.schema.fields if f.name in data}
            new = Table.from_pydict(data, types)
        else:
            new = DataFrame(self, SqlPlanner(self.catalog).plan_statement(
                stmt.source)).collect()
        merged = Table.concat([target, _align_to(new, target)])
        self.catalog.register(stmt.table, MemTable(merged))
        return self._dml_count(new.num_rows)

    def exec_context(self) -> ExecContext:
        merged = self.options.to_dict()
        merged.update(self.config)
        self._cancel.clear()  # a new execution starts un-cancelled
        merged["_cancel_event"] = self._cancel
        return ExecContext(merged, self.device)


_JOIN_TYPES = {"inner": L.JoinType.INNER, "left": L.JoinType.LEFT,
               "right": L.JoinType.RIGHT, "full": L.JoinType.FULL,
               "semi": L.JoinType.LEFT_SEMI, "anti": L.JoinType.LEFT_ANTI,
               "cross": L.JoinType.CROSS}


class DataFrame:
    def __init__(self, ctx: SessionContext, plan: L.LogicalPlan):
        self._ctx = ctx
        self._plan = plan

    def _new(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self._ctx, plan)

    # ---- builders (reference: DataFrame API + LogicalPlanBuilder) -------
    @with_registry
    def select(self, *exprs: TyUnion[str, E.Expr]) -> "DataFrame":
        return self._new(L.Projection(
            self._plan, [E.col(e) if isinstance(e, str) else e for e in exprs]))

    def filter(self, predicate: E.Expr) -> "DataFrame":
        return self._new(L.Filter(self._plan, predicate))

    @with_registry
    def aggregate(self, group_by: Sequence[E.Expr], aggs: Sequence[E.Expr]) -> "DataFrame":
        return self._new(L.Aggregate(self._plan, list(group_by), list(aggs)))

    def sort(self, *specs) -> "DataFrame":
        return self._new(L.Sort(self._plan, [s if isinstance(s, E.SortSpec)
                                             else E.SortSpec(s) for s in specs]))

    def limit(self, fetch: int, skip: int = 0) -> "DataFrame":
        return self._new(L.Limit(self._plan, skip, fetch))

    def join(self, right: "DataFrame", on: Sequence, how: str = "inner",
             filter: Optional[E.Expr] = None) -> "DataFrame":
        """Equi-join on `on`: column names (the same on both sides) or
        (left, right) pairs of names or expressions."""
        pairs = []
        for item in on:
            if isinstance(item, str):
                pairs.append((E.col(item), E.col(item)))
            else:
                l, r = item
                pairs.append((E.col(l) if isinstance(l, str) else l,
                              E.col(r) if isinstance(r, str) else r))
        return self._new(L.Join(self._plan, right._plan, pairs, _JOIN_TYPES[how],
                                filter))

    def distinct(self) -> "DataFrame":
        return self._new(L.Distinct(self._plan))

    def union(self, other: "DataFrame", all: bool = True) -> "DataFrame":
        u = L.Union([self._plan, other._plan], all=True)
        return self._new(u if all else L.Distinct(u))

    def alias(self, name: str) -> "DataFrame":
        return self._new(L.SubqueryAlias(self._plan, name))

    # ---- reference DataFrame surface (core/src/dataframe/mod.rs) --------
    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*names)

    def drop_columns(self, *names: str) -> "DataFrame":
        return self._new(L.Projection(self._plan, [
            E.Column(f.name, f.qualifier) for f in self._plan.schema.fields
            if f.name not in names]))

    def with_column(self, name: str, expr: E.Expr) -> "DataFrame":
        """Add (or replace) one column (reference: DataFrame::with_column)."""
        fields = self._plan.schema.fields
        exprs = [E.Alias(expr, name) if f.name == name else E.Column(f.name, f.qualifier)
                 for f in fields]
        if all(f.name != name for f in fields):
            exprs.append(E.Alias(expr, name))
        return self._new(L.Projection(self._plan, exprs))

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return self._new(L.Projection(self._plan, [
            E.Alias(E.Column(f.name, f.qualifier), new) if f.name == old
            else E.Column(f.name, f.qualifier) for f in self._plan.schema.fields]))

    def union_distinct(self, other: "DataFrame") -> "DataFrame":
        return self.union(other, all=False)

    def union_by_name(self, other: "DataFrame", all: bool = True) -> "DataFrame":
        """Union matching columns by NAME, not position (reference:
        union_by_name): the right side is re-projected into the left's
        column order."""
        rhs = L.Projection(other._plan, [E.Column(f.name, None)
                                         for f in self._plan.schema.fields])
        u = L.Union([self._plan, rhs], all=True)
        return self._new(u if all else L.Distinct(u))

    def _setop(self, other: "DataFrame", jt: L.JoinType) -> "DataFrame":
        on = [(E.Column(f.name, f.qualifier), E.Column(g.name, g.qualifier))
              for f, g in zip(self._plan.schema.fields, other._plan.schema.fields)]
        return self._new(L.Distinct(L.Join(self._plan, other._plan, on, jt, None)))

    def intersect(self, other: "DataFrame") -> "DataFrame":
        return self._setop(other, L.JoinType.LEFT_SEMI)

    intersect_distinct = intersect

    def except_all(self, other: "DataFrame") -> "DataFrame":
        return self._setop(other, L.JoinType.LEFT_ANTI)

    except_ = except_distinct = except_all

    def distinct_on(self, on_exprs: Sequence[E.Expr],
                    select_exprs: Sequence[E.Expr],
                    sort_exprs: Optional[Sequence] = None) -> "DataFrame":
        """First row per distinct on_exprs value, ordered by sort_exprs
        (reference: DataFrame::distinct_on / DISTINCT ON)."""
        order = [s if isinstance(s, E.SortSpec) else E.SortSpec(s)
                 for s in (sort_exprs or [])]
        rn = E.Alias(E.WindowFunction("row_number", (), tuple(on_exprs),
                                      tuple(order), None), "__df_rn")
        first = L.Filter(L.Window(self._plan, [rn]),
                         E.BinaryOp(E.Op.EQ, E.Column("__df_rn", None), E.lit(1)))
        return self._new(L.Projection(first, list(select_exprs)))

    def fill_null(self, value, columns: Sequence[str] = ()) -> "DataFrame":
        cols = set(columns or [f.name for f in self._plan.schema.fields])
        exprs = []
        for f in self._plan.schema.fields:
            c = E.Column(f.name, f.qualifier)
            if f.name in cols and f.nullable:
                c = E.Alias(E.ScalarFunction("coalesce", (c, E.lit(value))), f.name)
            exprs.append(c)
        return self._new(L.Projection(self._plan, exprs))

    def unnest_columns(self, *names: str) -> "DataFrame":
        """Explode list columns in place (reference: unnest_columns -- the
        exploded elements REPLACE the list column under its name)."""
        plan = self._plan
        for n in names:
            u = L.Unnest(plan, [E.Column(n, None)], names=[f"__unnest_{n}"])
            plan = L.Projection(u, [
                E.Alias(E.Column(f"__unnest_{n}", None), n) if f.name == n
                else E.Column(f.name, f.qualifier) for f in plan.schema.fields])
        return self._new(plan)

    def sort_by(self, *exprs) -> "DataFrame":
        return self.sort(*exprs)

    def join_on(self, right: "DataFrame", how: str = "inner",
                *predicates: E.Expr) -> "DataFrame":
        """Join on arbitrary predicates (reference: DataFrame::join_on);
        the optimizer extracts equi-pairs from the conjunction. `how` is
        one of join()'s but "cross"."""
        if how == "cross":  # a cross join has no predicate to join on
            raise PlanError("join_on needs a join type other than 'cross'")
        pred = None
        for p in predicates:
            pred = p if pred is None else E.BinaryOp(E.Op.AND, pred, p)
        return self._new(L.Join(self._plan, right._plan, [], _JOIN_TYPES[how], pred))

    def describe(self) -> Table:
        """Summary statistics per column (reference: DataFrame::describe):
        count, null_count, mean, std, min, max, median rows (NaN for a
        non-numeric column)."""
        import math

        import numpy as np

        t = self.collect()
        d = t.to_pydict()
        out: Dict[str, list] = {"describe": ["count", "null_count", "mean", "std",
                                             "min", "max", "median"]}
        for f in t.schema.fields:
            vals = d[f.name]
            nn = [v for v in vals if v is not None]
            col = [float(len(vals)), float(len(vals) - len(nn))]
            if f.dtype.is_numeric and nn:
                arr = np.asarray(nn, dtype=float)
                col += [float(arr.mean()),
                        float(arr.std(ddof=1)) if len(arr) > 1 else math.nan,
                        float(arr.min()), float(arr.max()), float(np.median(arr))]
            else:
                col += [math.nan] * 5
            out[f.name] = col
        return Table.from_pydict(out)

    def cache(self) -> "DataFrame":
        """Materialize and continue from an in-memory table (reference:
        DataFrame::cache)."""
        t = self.collect()
        name = f"__cache_{id(t)}"
        self._ctx.catalog.register(name, MemTable(t))
        return self._ctx.table(name)

    def into_view(self, name: str) -> None:
        """Register this DataFrame's plan as a named view
        (reference: DataFrame::into_view)."""
        self._ctx.catalog.views[name.lower()] = self._plan

    @with_registry
    def window(self, window_exprs: Sequence[E.Expr]) -> "DataFrame":
        return self._new(L.Window(self._plan, list(window_exprs)))

    # ---- introspection ---------------------------------------------------
    @property
    def schema(self) -> Schema:
        return self._plan.schema

    def logical_plan(self) -> L.LogicalPlan:
        return self._plan

    def to_substrait(self) -> dict:
        """Serialize this DataFrame's logical plan to a Substrait plan
        (proto3-JSON dict; reference analog:
        substrait/src/logical_plan/producer.rs)."""
        from .interchange.substrait import plan_to_substrait

        return plan_to_substrait(self._plan)

    def to_proto(self) -> bytes:
        """Serialize this DataFrame's logical plan to DataFusion's protobuf
        wire format (reference analog: proto/src/bytes/mod.rs
        logical_plan_to_bytes)."""
        from .interchange.dfproto import plan_to_proto_bytes

        return plan_to_proto_bytes(self._plan)

    @with_registry
    def optimized_plan(self) -> L.LogicalPlan:
        from .optimizer.optimizer import optimize

        merged = self._ctx.options.to_dict()
        merged.update(self._ctx.config)
        return optimize(self._plan, self._ctx.catalog, merged)

    @with_registry
    def physical_plan(self):
        """Cached: one physical plan per DataFrame, shared by collect() and
        explain() so per-node decisions persist."""
        if getattr(self, "_pp", None) is None:
            self._pp = create_physical_plan(self.optimized_plan())
        return self._pp

    @with_registry
    def explain(self, format: Optional[str] = None) -> str:
        """Render the plan. format: 'indent' (default) or 'tree'."""
        opts = self._ctx.options
        fmt = (format or opts.get("explain.format", "indent")).lower()
        lp = self.optimized_plan()
        pp = create_physical_plan(lp)
        lonly = bool(opts.get("explain.logical_plan_only", False))
        ponly = bool(opts.get("explain.physical_plan_only", False))
        if fmt == "tree":
            ltxt, ptxt = _tree_render(lp.display()), _tree_render(pp.display())
        elif fmt == "indent":
            ltxt, ptxt = lp.display(), pp.display()
        else:
            raise PlanError(f"unknown explain format {fmt!r} "
                            "(expected 'indent' or 'tree')")
        if lonly and not ponly:
            return f"== Logical Plan ==\n{ltxt}"
        if ponly and not lonly:
            return f"== Physical Plan ==\n{ptxt}"
        return f"== Logical Plan ==\n{ltxt}\n== Physical Plan ==\n{ptxt}"

    @with_registry
    def explain_analyze(self) -> str:
        """Execute the plan operator by operator and report per-operator
        metrics (reference: AnalyzeExec, physical-plan/src/analyze.rs:46 +
        EXPLAIN ANALYZE rendering); elapsed times are host times, which on a
        CUDA device are the times to enqueue each operator's kernels."""
        import time

        import torch

        ctx = self._ctx.exec_context()
        phys = self.physical_plan()
        t0 = time.perf_counter()
        rel = phys.execute(ctx)
        rows = int(rel.num_rows())  # waits for the device
        if rel.sel.device.type == "cuda":
            torch.cuda.synchronize(rel.sel.device)
        total = time.perf_counter() - t0
        lines = ["== Physical Plan (EXPLAIN ANALYZE) ==", phys.display(),
                 f"-- total: {total * 1000:.2f} ms, output rows: {rows}",
                 f"-- peak device memory accounted: {ctx.memory_pool.peak / 1e6:.1f} MB"]
        for name, m in sorted(ctx.metrics.items()):
            lines.append(f"--   {name}: elapsed={m.elapsed_seconds * 1000:.2f} ms"
                         + (f", rows={m.output_rows}" if m.output_rows else ""))
        return "\n".join(lines)

    @with_registry
    def collect(self) -> Table:
        """Execute on the session's device and return the live rows as a
        host Table. Runs through FusedQuery (physical/fused.py): the first
        collect() of a DataFrame executes the plan operator by operator and
        discovers its capacities; the second builds the steady state (on a
        CUDA device, one captured CUDA graph) and every later one replays
        it. A query that takes the out-of-core route (_chunked_query) runs
        through the chunked executor instead (physical/chunked.py)."""
        ctx = self._ctx.exec_context()
        cq = self._chunked_query(ctx)
        if cq is not None:
            from .physical.chunked import plan_boundedness

            if plan_boundedness(cq.plan):
                raise PlanError("query output is an unbounded stream; use "
                                "execute_stream() or add a LIMIT")
            return cq.collect(ctx)
        return to_host(self._fused_query().execute(ctx))

    def execute_stream(self, chunk_rows: Optional[int] = None):
        """Yield the answer as host Tables, chunk by chunk, through the
        chunked executor (reference: DataFrame::execute_stream ->
        SendableRecordBatchStream): the only way to consume a query whose
        output is unbounded."""
        from .physical.chunked import ChunkedQuery, plan_boundedness

        ctx = self._ctx.exec_context()
        cq = ChunkedQuery(self.physical_plan(), chunk_rows or _chunk_rows(ctx))
        plan_boundedness(cq.plan)  # rejects breakers over unbounded inputs
        for rel in cq._stream(cq.plan, ctx):
            t = to_host(rel)
            if t.num_rows:
                yield t

    def _chunked_query(self, ctx):
        """The ChunkedQuery of this DataFrame when the out-of-core route
        applies, else None: always over an unbounded stream; otherwise by
        `execution.out_of_core` -- 'on', 'off', or 'auto', which takes it
        when the pool is bounded and the scans' estimated device bytes pass
        half of its limit."""
        from .physical.chunked import (ChunkedQuery, estimate_scan_bytes,
                                       plan_boundedness, scan_unbounded)

        mode = str(ctx.opt("execution.out_of_core", "auto")).lower()
        plan = self.physical_plan()
        if scan_unbounded(plan):
            plan_boundedness(plan)  # raises on breakers over the stream
        elif mode in ("off", "false", "0", "none"):
            return None
        elif mode not in ("on", "true", "1"):
            pool = ctx.memory_pool
            if pool.headroom() is None or \
                    estimate_scan_bytes(plan) <= pool.limit // 2:
                return None
        rows = _chunk_rows(ctx)
        cq = getattr(self, "_cq", None)
        if cq is None or cq.chunk_rows != ChunkedQuery(plan, rows).chunk_rows:
            cq = self._cq = ChunkedQuery(plan, rows)
        return cq

    def _fused_query(self):
        """One FusedQuery per DataFrame, over its cached physical plan."""
        if getattr(self, "_fq", None) is None:
            from .physical.fused import FusedQuery

            self._fq = FusedQuery(self.physical_plan())
        return self._fq

    def to_pandas(self):
        return self.collect().to_pandas()

    def to_pydict(self):
        return self.collect().to_pydict()

    def count(self) -> int:
        return self.collect().num_rows

    def write_parquet(self, path: str) -> None:
        self.collect().write_parquet(path)

    def write_csv(self, path: str) -> None:
        self.collect().write_csv(path)

    def show(self, limit: int = 20):
        print(self.limit(limit).to_pandas().to_string(index=False))


def _chunk_rows(ctx) -> int:
    return int(ctx.opt("execution.chunk_rows", 1 << 21) or (1 << 21))


def _file_table(stmt) -> TableProvider:
    """The provider of CREATE EXTERNAL TABLE ... STORED AS <format>."""
    if stmt.format == "parquet":
        return ParquetTable(stmt.location)
    if stmt.format == "csv":
        return CsvTable(stmt.location, stmt.has_header, stmt.delimiter,
                        schema=stmt.columns)
    if stmt.format == "json":
        return JsonTable(stmt.location)
    if stmt.format in ("arrow", "ipc", "feather"):
        return ArrowTable(stmt.location)
    if stmt.format == "avro":
        return AvroTable(stmt.location)
    raise PlanError(f"unsupported format {stmt.format!r}")


def _write_table(table: Table, fmt: str, path: str) -> None:
    """COPY ... TO path STORED AS fmt: one file."""
    if fmt == "parquet":
        table.write_parquet(path)
    elif fmt == "csv":
        table.write_csv(path)
    elif fmt == "json":
        import json

        cols = table.to_pydict()
        names = list(cols)
        with open(path, "w") as fh:
            for i in range(table.num_rows):
                json.dump({n: cols[n][i] for n in names}, fh, default=str)
                fh.write("\n")
    elif fmt in ("arrow", "ipc", "feather"):
        import pyarrow.ipc as pipc

        at = table.to_arrow()
        with pipc.new_file(path, at.schema) as w:
            w.write_table(at)
    elif fmt == "avro":
        from .io.avro import write_avro

        write_avro(table.to_arrow(), path)
    else:
        raise PlanError(f"unsupported COPY format {fmt!r}")


def _align_to(new: Table, target: Table) -> Table:
    """Reorder/rename inserted columns positionally to the target schema."""
    if new.schema.names() == target.schema.names():
        return new
    if len(new.schema) != len(target.schema):
        raise PlanError(
            f"INSERT column count {len(new.schema)} != table {len(target.schema)}")
    import dataclasses

    fields = [dataclasses.replace(f, name=t.name)
              for f, t in zip(new.schema.fields, target.schema.fields)]
    return Table(Schema(fields), new.columns)


def _replace_params(obj, values):
    """Rebuild a parsed-statement tree with $N placeholders replaced by the
    EXECUTE argument literals (reference:
    LogicalPlan::replace_params_with_values, expr/src/logical_plan/plan.rs).
    Walks AST/Expr dataclasses, tuples and lists generically."""
    import dataclasses

    if isinstance(obj, E.Placeholder):
        idx = int(obj.pid.lstrip("$")) - 1
        if not 0 <= idx < len(values):
            raise PlanError(f"no value for placeholder {obj.pid}")
        return values[idx]
    if isinstance(obj, (list, tuple)):
        return type(obj)([_replace_params(x, values) for x in obj])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            nv = _replace_params(v, values)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(obj, **changes) if changes else obj
    return obj


def _tree_render(indent_text: str) -> str:
    """Re-render a 2-space-indented operator listing as a connector tree."""
    lines = [l for l in indent_text.splitlines() if l.strip()]
    depths = [(len(l) - len(l.lstrip())) // 2 for l in lines]

    def has_next_sibling(i: int, depth: int) -> bool:
        for j in range(i + 1, len(lines)):
            if depths[j] < depth:
                return False
            if depths[j] == depth:
                return True
        return False

    out = []
    for i, (d, l) in enumerate(zip(depths, lines)):
        if d == 0:
            out.append(l.strip())
            continue
        prefix = "".join("│   " if has_next_sibling(i, anc) else "    "
                         for anc in range(1, d))
        prefix += "├── " if has_next_sibling(i, d) else "└── "
        out.append(prefix + l.strip())
    return "\n".join(out)
