# Verbatim copy of datafusion_tpu/models/tpcds/__init__.py; host-only, kept in step with the original.
"""TPC-DS model: the 99 public benchmark queries + schema-only tables.

The queries under queries/*.sql are the public TPC-DS query set (copyright
2015 Transaction Processing Performance Council), the same set the reference
plans in its tpcds_planning tests (reference: core/tests/tpcds_planning.rs,
core/tests/tpc-ds/*.sql). Planning all 99 against empty typed tables is the
parity check for SQL-frontend + optimizer breadth.
"""
from __future__ import annotations

import os

from ...data.table import Table
from .schema import SCHEMAS

_QUERY_DIR = os.path.join(os.path.dirname(__file__), "queries")

ALL_QUERY_IDS = list(range(1, 100))


def query(qid: int) -> str:
    """Return the SQL text of TPC-DS query `qid` (may contain several
    statements for the multi-part queries, e.g. q14)."""
    with open(os.path.join(_QUERY_DIR, f"{qid}.sql")) as f:
        return f.read()


def empty_tables() -> dict:
    """Empty, correctly-typed tables for all 24 TPC-DS relations
    (planning-only fixtures, like the reference's MemTable::try_new with
    empty partitions)."""
    out = {}
    for name, cols in SCHEMAS.items():
        data = {c: [] for c, _ in cols}
        types = {c: t for c, t in cols}
        out[name] = Table.from_pydict(data, types=types)
    return out


def register_tpcds_tables(ctx) -> None:
    for name, t in empty_tables().items():
        ctx.register_table(name, t)
