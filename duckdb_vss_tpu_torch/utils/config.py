"""Index configuration, metric kinds, and option validation (copy of
duckdb_vss_tpu/utils/config.py; the port imports nothing of the JAX
package, so it keeps its own copy with the same values and error texts).

Mirrors the reference's semantics:
- metric map {l2sq, cosine, ip}: duckdb_vss/src/hnsw/hnsw_index.cpp:232-245
- scalar map {FLOAT -> f32 only}: duckdb_vss/src/hnsw/hnsw_index.cpp:247-260
- WITH-option validation (metric / ef_construction / ef_search / M >= 2 /
  M0 >= 2): duckdb_vss/src/hnsw/hnsw_index_plan.cpp:33-80
- usearch defaults M=16, M0=32, ef_construction=128, ef_search=64:
  duckdb_vss/src/include/usearch/index.hpp:1097-1107
"""

from __future__ import annotations

import dataclasses
import enum


class MetricKind(enum.Enum):
    L2SQ = "l2sq"
    COSINE = "cosine"
    IP = "ip"


# Which SQL distance functions (and operator aliases) each index metric can
# serve. Mirrors HNSWIndex::MakeFunctionMatcher
# (duckdb_vss/src/hnsw/hnsw_index.cpp:632-662).
METRIC_FUNCTIONS = {
    MetricKind.L2SQ: ("array_distance", "<->"),
    MetricKind.COSINE: ("array_cosine_distance", "<=>"),
    MetricKind.IP: ("array_negative_inner_product", "<#>"),
}

FUNCTION_TO_METRIC = {
    fn: metric for metric, fns in METRIC_FUNCTIONS.items() for fn in fns
}

DEFAULT_M = 16
DEFAULT_M0 = 32
DEFAULT_EF_CONSTRUCTION = 128
DEFAULT_EF_SEARCH = 64


class BinderError(ValueError):
    """Raised for invalid index options (reference raises BinderException)."""


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """Validated CREATE INDEX ... WITH (...) options."""

    metric: MetricKind = MetricKind.L2SQ
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    ef_search: int = DEFAULT_EF_SEARCH
    m: int = DEFAULT_M
    m0: int = DEFAULT_M0

    @staticmethod
    def from_options(options: dict | None = None, **kwargs) -> "HNSWConfig":
        """Validate WITH options with the reference's error semantics
        (duckdb_vss/src/hnsw/hnsw_index_plan.cpp:33-80)."""
        opts = dict(options or {})
        opts.update(kwargs)
        fields = {}
        for key, raw in opts.items():
            key_l = str(key).lower()
            if key_l == "metric":
                name = str(raw).lower()
                try:
                    fields["metric"] = MetricKind(name)
                except ValueError:
                    accepted = ", ".join(f"'{m.value}'" for m in MetricKind)
                    raise BinderError(
                        f"Unknown metric kind: '{name}', accepted values are: {accepted}"
                    )
            elif key_l == "ef_construction":
                fields["ef_construction"] = _positive_int(key_l, raw)
            elif key_l == "ef_search":
                fields["ef_search"] = _positive_int(key_l, raw)
            elif key_l == "m":
                # canonical option spelling in errors, like the
                # reference (hnsw_index_plan.cpp:59-72 uses 'M'/'M0')
                fields["m"] = _min_int("M", raw, 2)
            elif key_l == "m0":
                fields["m0"] = _min_int("M0", raw, 2)
            else:
                raise BinderError(f"Unknown option for HNSW index: '{key}'")
        return HNSWConfig(**fields)


def _positive_int(name: str, raw) -> int:
    try:
        val = int(raw)
    except (TypeError, ValueError):
        raise BinderError(f"HNSW index '{name}' must be an integer")
    if val < 1:
        raise BinderError(f"HNSW index '{name}' must be at least 1")
    return val


def _min_int(name: str, raw, lo: int) -> int:
    try:
        val = int(raw)
    except (TypeError, ValueError):
        raise BinderError(f"HNSW index '{name}' must be an integer")
    if val < lo:
        raise BinderError(f"HNSW index '{name}' must be at least {lo}")
    return val
