"""SessionContext + DataFrame: the user-facing API.

Port of the SQL path of datafusion_tpu/context.py: register in-memory tables,
run SELECT and EXPLAIN statements, CREATE TABLE ... AS SELECT, CREATE
TABLE t(...) and DROP TABLE, collect results. Plans run on the session's
device, which is the CUDA card unless the caller passes another
(`SessionContext(device="cpu")`): operator by operator the first time a
DataFrame is collected, then as a steady state (physical/fused.py). Other DDL, DML, file tables, UDF
registration and streaming execution are not ported yet (ROADMAP queue 1,
item 12 'Remaining surface')."""
from __future__ import annotations

from typing import Dict, Optional

from .catalog.catalog import Catalog, MemTable, TableProvider
from .common import types as T
from .common.errors import PlanError
from .expr import nodes as E
from .data.device import resolve_device, to_host
from .data.table import Table
from .expr.udf import FunctionRegistry, with_registry
from .logical import plan as L
from .physical.planner import create_physical_plan
from .runtime.context import ExecContext, planning_device

_SURFACE_ITEM = "ROADMAP queue 1, item 12 'Remaining surface'"


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
        # back-link for session-scoped virtual tables
        # (information_schema.df_settings / routines)
        self.catalog.session = self

    def register_table(self, name: str, data) -> None:
        if isinstance(data, TableProvider):
            self.catalog.register(name, data)
        elif isinstance(data, Table):
            self.catalog.register(name, MemTable(data))
        elif isinstance(data, dict):
            self.catalog.register(name, MemTable(Table.from_pydict(data)))
        else:
            import pandas as pd

            if not isinstance(data, pd.DataFrame):
                raise PlanError(f"cannot register {type(data)}")
            self.catalog.register(name, MemTable(Table.from_pandas(data)))

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
        if isinstance(stmt, A.SelectStmt):
            return DataFrame(self, SqlPlanner(self.catalog).plan_statement(stmt))
        if isinstance(stmt, A.Explain):
            if stmt.analyze:
                raise NotImplementedError(
                    f"EXPLAIN ANALYZE is not ported yet ({_SURFACE_ITEM})")
            plan = SqlPlanner(self.catalog).plan_statement(stmt.query)
            text = DataFrame(self, plan).explain(format=getattr(stmt, "format", None))
            lines = Table.from_pydict({"plan": text.splitlines()},
                                      {"plan": T.STRING})
            return DataFrame(self, L.TableScan("explain", MemTable(lines)))
        if isinstance(stmt, A.CreateTableAs):
            self._create_table(stmt, SqlPlanner)
            return None
        if isinstance(stmt, A.DropTable):  # an absent table is not an error
            self.catalog.deregister(stmt.name)
            self.catalog.views.pop(stmt.name.lower(), None)
            return None
        raise NotImplementedError(
            f"{type(stmt).__name__} statements are not ported yet ({_SURFACE_ITEM})")

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

    def exec_context(self) -> ExecContext:
        merged = self.options.to_dict()
        merged.update(self.config)
        return ExecContext(merged, self.device)


class DataFrame:
    def __init__(self, ctx: SessionContext, plan: L.LogicalPlan):
        self._ctx = ctx
        self._plan = plan

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
    def collect(self) -> Table:
        """Execute on the session's device and return the live rows as a
        host Table. Runs through FusedQuery (physical/fused.py): the first
        collect() of a DataFrame executes the plan operator by operator and
        discovers its capacities; the second builds the steady state (on a
        CUDA device, one captured CUDA graph) and every later one replays
        it."""
        return to_host(self._fused_query().execute(self._ctx.exec_context()))

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
