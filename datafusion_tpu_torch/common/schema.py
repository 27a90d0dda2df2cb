# Verbatim copy of datafusion_tpu/common/schema.py; host-only, kept in step with the original.
"""Schema: named, typed, nullable fields.

Capability parity with the reference's DFSchema (datafusion/common/src/dfschema.rs:112):
qualified field names (table.column), lookup by bare or qualified name, merging for
joins. Designed as a frozen value object so plans can hash/compare schemas.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

from .errors import PlanError
from .types import DataType


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    qualifier: Optional[str] = None  # table alias / relation name

    @property
    def qualified_name(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name

    def with_qualifier(self, qualifier: Optional[str]) -> "Field":
        return dataclasses.replace(self, qualifier=qualifier)


class Schema:
    """Ordered collection of fields with (optionally qualified) name lookup."""

    __slots__ = ("fields", "_index", "_ci_index")

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))
        index = {}
        ci = {}
        for i, f in enumerate(self.fields):
            index.setdefault(f.name, []).append(i)
            ci.setdefault(f.name.lower(), []).append(i)
            if f.qualifier:
                index.setdefault(f.qualified_name, []).append(i)
                ci.setdefault(f.qualified_name.lower(), []).append(i)
        object.__setattr__(self, "_index", index)
        object.__setattr__(self, "_ci_index", ci)

    # ---- lookup ---------------------------------------------------------
    def find(self, name: str) -> Optional[int]:
        """Index of field by bare or qualified name; None if absent,
        PlanError if ambiguous. Exact-case match wins; otherwise SQL's
        case-insensitive identifier folding applies (the reference lowercases
        unquoted idents at parse time — sql/src/planner.rs ident
        normalization; we fold at lookup so case-sensitive registrations
        keep working, e.g. ClickBench's CamelCase columns)."""
        hits = self._index.get(name)
        if not hits:
            hits = self._ci_index.get(name.lower())
        if not hits:
            return None
        if len(hits) > 1:
            # A bare name that is ambiguous across qualifiers is an error,
            # but identical duplicates (self-join of same column name) resolve
            # to the first occurrence only when qualified.
            raise PlanError(f"ambiguous column reference: {name!r}")
        return hits[0]

    def field(self, name: str) -> Field:
        i = self.find(name)
        if i is None:
            raise PlanError(
                f"column {name!r} not found; available: {[f.qualified_name for f in self.fields]}"
            )
        return self.fields[i]

    def index_of(self, name: str) -> int:
        i = self.find(name)
        if i is None:
            raise PlanError(f"column {name!r} not found")
        return i

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    # ---- construction ---------------------------------------------------
    def with_qualifier(self, qualifier: Optional[str]) -> "Schema":
        return Schema([f.with_qualifier(qualifier) for f in self.fields])

    def join(self, other: "Schema") -> "Schema":
        return Schema(list(self.fields) + list(other.fields))

    def project(self, names: Iterable[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.qualified_name}: {f.dtype}" for f in self.fields)
        return f"Schema[{inner}]"


def schema_of(*pairs: Tuple[str, DataType]) -> Schema:
    return Schema([Field(n, t) for n, t in pairs])
