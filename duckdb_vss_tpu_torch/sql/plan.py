"""Logical/physical plan nodes with EXPLAIN rendering (copy of
duckdb_vss_tpu/sql/plan.py: the operator names and the EXPLAIN text are
the JAX package's, which the reference's sqllogic files match on).

There is no DuckDB host engine here, so the plan layer is small and
explicit: queries are built through the relational API, the optimizer
rewrites logical shapes into physical operators, and EXPLAIN renders the
physical tree so tests can do plan-shape assertions — the analog of the
reference's `EXPLAIN ... <REGEX>:.*HNSW_INDEX_SCAN.*` sqllogictests
(test/sql/hnsw/hnsw_basic.test).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class PlanNode:
    children: list = dataclasses.field(default_factory=list)

    @property
    def op_name(self) -> str:
        return type(self).__name__.removeprefix("Physical").upper()

    def params(self) -> str:
        return ""

    def explain(self, indent: int = 0) -> str:
        pad = "   " * indent
        line = f"{pad}{self.op_name}"
        p = self.params()
        if p:
            line += f" ({p})"
        lines = [line]
        for c in self.children:
            lines.append(c.explain(indent + 1))
        return "\n".join(lines)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


# ---------------------------------------------------------------------------
# physical operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhysicalSeqScan(PlanNode):
    table: Any = None

    @property
    def op_name(self):
        return "SEQ_SCAN"

    def params(self):
        return self.table.name if self.table is not None else ""


@dataclasses.dataclass
class PhysicalFlatTopN(PlanNode):
    """Brute-force top-k over the device-resident column block (the
    device path replacing DuckDB's TopN operator over a projection)."""

    table: Any = None
    column: str = ""
    metric: Any = None
    limit: int = 0

    @property
    def op_name(self):
        return "FLAT_TOPN_SCAN"

    def params(self):
        return (f"{self.table.name}.{self.column}, "
                f"metric={self.metric.value}, k={self.limit}")


@dataclasses.dataclass
class PhysicalHNSWIndexScan(PlanNode):
    """hnsw_index_scan table function analog
    (the reference's src/hnsw/hnsw_index_scan.cpp:138-153)."""

    table: Any = None
    index: Any = None
    limit: int = 0

    @property
    def op_name(self):
        return "HNSW_INDEX_SCAN"

    def params(self):
        return f"{self.table.name} ({self.index.name}), k={self.limit}"


@dataclasses.dataclass
class PhysicalHNSWIndexJoin(PlanNode):
    """Batched k-NN lateral join (hnsw_optimize_join.cpp:33-181)."""

    table: Any = None
    index: Any = None
    limit: int = 0

    @property
    def op_name(self):
        return "HNSW_INDEX_JOIN"

    def params(self):
        return f"{self.table.name} ({self.index.name}), k={self.limit}"


@dataclasses.dataclass
class PhysicalFlatKNNJoin(PlanNode):
    table: Any = None
    column: str = ""
    metric: Any = None
    limit: int = 0

    @property
    def op_name(self):
        return "FLAT_KNN_JOIN"

    def params(self):
        return (f"{self.table.name}.{self.column}, "
                f"metric={self.metric.value}, k={self.limit}")


@dataclasses.dataclass
class PhysicalFilter(PlanNode):
    predicate: Any = None

    @property
    def op_name(self):
        return "FILTER"

    def params(self):
        return repr(self.predicate)


@dataclasses.dataclass
class PhysicalProjection(PlanNode):
    exprs: list = dataclasses.field(default_factory=list)

    @property
    def op_name(self):
        return "PROJECTION"

    def params(self):
        return ", ".join(repr(e) for e in self.exprs)


@dataclasses.dataclass
class PhysicalTopN(PlanNode):
    order: Any = None
    limit: int = 0

    @property
    def op_name(self):
        return "TOP_N"

    def params(self):
        return f"{self.order!r}, k={self.limit}"


@dataclasses.dataclass
class PhysicalListAggregate(PlanNode):
    """list(value ORDER BY dist) produced by the min_by rewrite
    (hnsw_optimize_topk.cpp:22-46)."""

    value: Any = None
    order: Any = None
    limit: int = 0

    @property
    def op_name(self):
        return "LIST_AGGREGATE"

    def params(self):
        return f"{self.value!r} ORDER BY {self.order!r}, k={self.limit}"
