"""Catalog: table registration and providers.

Port of the in-memory half of datafusion_tpu/catalog/catalog.py (reference:
datafusion/catalog/src/{catalog.rs,table.rs,memory/}). A MemTable caches the
torch encoding of the columns it has been asked for, per device, so repeated
queries find their columns resident on the card. File-backed providers,
streaming tables and the recursive-CTE work table are not ported yet: a
WorkTable raises NotImplementedError when the planner builds one."""
from __future__ import annotations

from typing import Dict, List, Optional

from ..common.errors import PlanError
from ..common.schema import Schema
from ..data.device import DeviceRelation, resolve_device, to_device
from ..data.table import Table


class TableProvider:
    def schema(self) -> Schema:
        raise NotImplementedError

    def host_table(self) -> Table:
        raise NotImplementedError

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        """Device-resident scan. `filters`/`projection` are pushed-down hints;
        providers may ignore them -- the engine always re-applies filters
        exactly (Inexact pushdown semantics)."""
        raise NotImplementedError

    def statistics(self):
        """Table statistics for cost-based planning (reference: Statistics,
        common/src/stats.rs:368), computed once from the host table."""
        cached = getattr(self, "_stats", None)
        if cached is None:
            from ..common.stats import Statistics, table_statistics

            try:
                cached = table_statistics(self.host_table())
            except Exception:  # noqa: BLE001 -- unreadable table: no stats
                cached = Statistics(0.0)
            self._stats = cached
        return cached

    def is_unique(self, cols: tuple) -> bool:
        """Whether `cols` is a unique key of this table: declared keys
        answer immediately, otherwise one exact host pass (cached) decides.
        Columns with NULLs are never a unique key here."""
        cols = tuple(cols)
        for k in getattr(self, "_unique_keys", ()):
            if set(k) <= set(cols):
                return True  # a superset of a unique key is unique
        cache = getattr(self, "_unique_cache", None)
        if cache is None:
            cache = self._unique_cache = {}
        hit = cache.get(cols)
        if hit is not None:
            return hit
        import numpy as np

        try:
            t = self.host_table()
            arrs = []
            for name in cols:
                c = t.column(name)
                if c.validity is not None and not c.validity.all():
                    cache[cols] = False
                    return False
                arrs.append(np.asarray(c.data))
            n = t.num_rows
            if n == 0:
                uniq = True
            elif len(arrs) == 1:
                uniq = len(np.unique(arrs[0])) == n
            else:
                uniq = len(np.unique(np.stack(arrs, axis=1), axis=0)) == n
        except Exception:  # noqa: BLE001 -- unknown column / unloadable table
            uniq = False
        cache[cols] = uniq
        return uniq


class WorkTable(TableProvider):
    """The recursive CTE's working table. Recursive queries are not ported
    yet, so planning a `WITH RECURSIVE` stops here."""

    def __init__(self, name: str, schema: Schema):
        raise NotImplementedError(
            f"recursive CTE {name!r} (WITH RECURSIVE) is not ported to "
            "datafusion_tpu_torch yet (ROADMAP queue 1, item 12 'Remaining "
            "surface')")


class MemTable(TableProvider):
    def __init__(self, table: Table, unique_keys=()):
        self._table = table
        self._unique_keys = tuple(tuple(k) for k in unique_keys)
        # per-device lazy COLUMN cache: only projected columns are encoded
        # and uploaded
        self._device: Dict[str, Dict[str, object]] = {}
        self._device_sel: Dict[str, object] = {}

    def schema(self) -> Schema:
        return self._table.schema

    def host_table(self) -> Table:
        return self._table

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        device = resolve_device(ctx.device if ctx is not None else None)
        key = str(device)
        schema = self._table.schema
        all_names = [f.name for f in schema.fields]
        want = list(projection if projection is not None else all_names)
        if not want:  # zero-column scan (COUNT(*)): sel still needed
            want = all_names[:1]
        cache = self._device.setdefault(key, {})
        missing = [n for n in want if n not in cache]
        if missing:
            idx = [schema.find(n) for n in missing]
            sub = Table(Schema([schema.fields[i] for i in idx]),
                        [self._table.columns[i] for i in idx])
            rel = to_device(sub, device=device)
            for f, c in zip(rel.schema.fields, rel.columns):
                cache[f.name] = c
            self._device_sel.setdefault(key, rel.sel)
        fields = [schema.fields[schema.find(n)] for n in want]
        return DeviceRelation(Schema(fields), tuple(cache[n] for n in want),
                              self._device_sel[key])


class SchemaProvider:
    """One namespace of tables (reference: SchemaProvider,
    datafusion/catalog/src/schema.rs)."""

    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, TableProvider] = {}

    def register(self, name: str, provider: TableProvider):
        self.tables[name.lower()] = provider

    def deregister(self, name: str):
        self.tables.pop(name.lower(), None)

    def table(self, name: str) -> Optional[TableProvider]:
        return self.tables.get(name.lower())

    def names(self) -> List[str]:
        return sorted(self.tables)


class CatalogProvider:
    """A named collection of schemas (reference: CatalogProvider,
    datafusion/catalog/src/catalog.rs)."""

    def __init__(self, name: str):
        self.name = name
        self.schemas: Dict[str, SchemaProvider] = {}

    def schema(self, name: str, create: bool = False) -> Optional[SchemaProvider]:
        s = self.schemas.get(name.lower())
        if s is None and create:
            s = self.schemas[name.lower()] = SchemaProvider(name.lower())
        return s

    def schema_names(self) -> List[str]:
        return sorted(self.schemas)


DEFAULT_CATALOG = "datafusion"
DEFAULT_SCHEMA = "public"


class Catalog:
    """Session catalog list with a three-level namespace
    catalog.schema.table. Bare names resolve against the default
    catalog/schema."""

    def __init__(self):
        self.catalogs: Dict[str, CatalogProvider] = {}
        self.default_catalog = DEFAULT_CATALOG
        self.default_schema = DEFAULT_SCHEMA
        self.register_catalog(DEFAULT_CATALOG)
        self.views: Dict[str, object] = {}  # name -> LogicalPlan

    # ---- catalogs/schemas -------------------------------------------------
    def register_catalog(self, name: str) -> CatalogProvider:
        c = self.catalogs.get(name.lower())
        if c is None:
            c = self.catalogs[name.lower()] = CatalogProvider(name.lower())
            c.schema(DEFAULT_SCHEMA, create=True)
        return c

    def catalog(self, name: str) -> Optional[CatalogProvider]:
        return self.catalogs.get(name.lower())

    def _split(self, name: str):
        parts = name.split(".")
        if len(parts) == 1:
            return self.default_catalog, self.default_schema, parts[0]
        if len(parts) == 2:
            return self.default_catalog, parts[0], parts[1]
        if len(parts) == 3:
            return parts[0], parts[1], parts[2]
        raise PlanError(f"invalid table reference {name!r}")

    # ---- tables -------------------------------------------------------------
    def register(self, name: str, provider: TableProvider):
        c, s, t = self._split(name)
        self.register_catalog(c).schema(s, create=True).register(t, provider)

    def deregister(self, name: str):
        c, s, t = self._split(name)
        cat = self.catalog(c)
        sch = cat.schema(s) if cat else None
        if sch:
            sch.deregister(t)

    def get(self, name: str) -> TableProvider:
        c, s, t = self._split(name)
        cat = self.catalog(c)
        sch = cat.schema(s) if cat else None
        p = sch.table(t) if sch else None
        if p is None:
            raise PlanError(
                f"table {name!r} not found; registered: {self.names()}")
        return p

    def names(self) -> List[str]:
        """Registered table names: bare for the default schema, qualified
        elsewhere."""
        out = []
        for cn, cat in sorted(self.catalogs.items()):
            for sn, sch in sorted(cat.schemas.items()):
                for t in sch.names():
                    if cn == self.default_catalog and sn == self.default_schema:
                        out.append(t)
                    elif cn == self.default_catalog:
                        out.append(f"{sn}.{t}")
                    else:
                        out.append(f"{cn}.{sn}.{t}")
        return sorted(out)
