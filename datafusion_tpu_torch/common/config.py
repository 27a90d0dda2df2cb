# Verbatim copy of datafusion_tpu/common/config.py; host-only, kept in step with the original.
"""Typed configuration system.

Capability analog of the reference's config_namespace! machinery
(datafusion/common/src/config.rs:122, ConfigOptions at :1822): namespaced,
typed, documented options settable via the builder API, `SET key = value` in
SQL, or environment variables (DATAFUSION_TPU__<NAMESPACE>__<KEY>); docs are
generated from the registry (render_docs())."""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

_BOOL_TRUE = {"1", "true", "on", "yes"}


@dataclasses.dataclass
class ConfigEntry:
    key: str  # namespaced: execution.batch_min_capacity
    default: Any
    doc: str
    parse: Callable[[str], Any]
    # reference-compat entries: `alias` mirrors writes into a live native
    # option; `inert` marks accepted-but-ignored knobs (the engine's design
    # makes them moot — e.g. batch coalescing in a capacity+mask model)
    alias: Optional[str] = None
    inert: bool = False


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in _BOOL_TRUE


REGISTRY: Dict[str, ConfigEntry] = {}


def _opt(key: str, default, doc: str):
    parse: Callable[[str], Any]
    if isinstance(default, bool):
        parse = _parse_bool
    elif isinstance(default, int):
        parse = int
    elif isinstance(default, float):
        parse = float
    else:
        parse = str
    REGISTRY[key] = ConfigEntry(key, default, doc, parse)


# ---- execution ------------------------------------------------------------
_opt("execution.batch_min_capacity", 128,
     "Minimum device-relation capacity; capacities are padded to powers of two.")
_opt("execution.dense_group_limit", 16384,
     "Max group-domain size for the arithmetic (sort-free) dense aggregation path.")
_opt("execution.target_partitions", 0,
     "Number of mesh shards for distributed execution (0 = all local devices).")
_opt("execution.memory_limit_bytes", 0,
     "HBM accounting limit; 0 = unbounded. Exceeding raises ResourceExhausted "
     "naming the top consumers.")
_opt("execution.memory_pool", "greedy",
     "Bounded-pool policy: 'greedy' (first-come-first-served) or "
     "'fair_spill' (divides the budget evenly among spillable consumers so "
     "one large sort cannot starve its siblings; FairSpillPool analog).")
_opt("execution.spill_dir", "",
     "Directory for host->disk spill files (empty = host RAM only).")
_opt("execution.parquet_scan_threads", 8,
     "Concurrent row-group reads per parquet scan (1 = serial). pyarrow "
     "releases the GIL during IO/decompression, so a small pool overlaps "
     "disk reads with decode (file_stream.rs async-opener analog).")
_opt("execution.parquet_scan_ahead", True,
     "Chunked parquet scans prefetch the next batch of row groups on a "
     "background thread while the current chunk executes on device.")
_opt("execution.spill_max_host_bytes", 0,
     "Host-RAM budget for spilled relations; beyond it the oldest spills "
     "demote to .npz files under execution.spill_dir (0 = unlimited).")
_opt("execution.spill_compression", False,
     "Compress disk spill files (zlib; reference: spill_compression with "
     "lz4/zstd IPC writers, physical-plan/src/spill/mod.rs:240).")
_opt("execution.timeout_seconds", 0.0,
     "Cooperative per-query deadline; 0 = none. Checked at every operator "
     "dispatch, scan chunk, and recursion step (a fused single-XLA-program "
     "query cancels at its next host sync). QueryCancelled on expiry; "
     "SessionContext.interrupt() cancels explicitly.")
_opt("execution.use_fused_queries", True,
     "Compile whole plans into a single XLA program after capacity discovery.")
_opt("execution.out_of_core", "auto",
     "off|auto|on: chunked out-of-core execution. Scans stream in bounded "
     "chunks; aggregations merge Partial states across chunks; accumulated "
     "intermediates spill to host under memory-pool pressure. 'auto' engages "
     "when a memory limit is set and the estimated scan size exceeds half "
     "of it.")
_opt("execution.chunk_rows", 1 << 21,
     "Target rows per scan chunk for out-of-core execution (capacities are "
     "padded to the enclosing power of two).")
_opt("execution.collect_metrics", True,
     "Record per-operator elapsed/memory metrics (EXPLAIN ANALYZE).")
_opt("execution.approx_distinct_hll", False,
     "Distributed approx_distinct via a HyperLogLog register plane "
     "(4096 registers, ~1.6% error): shards merge sketches with one pmax "
     "collective instead of exchanging every distinct value (reference: "
     "approx_distinct.rs HyperLogLog accumulator). Off = exact everywhere.")
_opt("execution.parquet_bloom_pruning", True,
     "Prune parquet row groups via split-block bloom filters for equality "
     "and IN-list predicates (footer parsed natively; pyarrow does not "
     "expose bloom reading).")

# ---- optimizer ------------------------------------------------------------
_opt("optimizer.filter_pushdown", True,
     "Push filter conjuncts below joins and extract equi-join keys from "
     "cross joins.")
_opt("optimizer.late_materialization", True,
     "Drop GROUP BY keys functionally determined (via verified-unique join "
     "keys) by the remaining keys, re-attaching them by a post-aggregation "
     "join; determined keys otherwise ride every join table and gather as "
     "payload lanes.")
_opt("optimizer.projection_pruning", True,
     "Prune unreferenced columns at table scans (avoids dictionary-encoding "
     "and device residency for unused columns).")
_opt("optimizer.decorrelate_subqueries", True,
     "Rewrite EXISTS/IN/scalar subqueries into joins.")
_opt("optimizer.max_passes", 3,
     "Fixpoint iteration bound for rule application.")
_opt("optimizer.simplify_expressions", True,
     "Constant-fold and simplify expressions before and after decorrelation.")
_opt("optimizer.join_reorder", True,
     "Cost-based join reordering and semi/anti join placement "
     "(statistics-driven; reference: EliminateCrossJoin + JoinSelection).")
_opt("optimizer.eliminate_outer_joins", True,
     "Convert LEFT/RIGHT/FULL joins to INNER under null-rejecting filters.")
_opt("optimizer.common_subplan_dedup", True,
     "Unify structurally identical sub-plans so shared CTEs/subqueries "
     "compute once (CommonSubexprEliminate analog at plan granularity).")
_opt("optimizer.limit_into_sort", True,
     "Fuse LIMIT into an adjacent ORDER BY as a top-k sort.")
_opt("optimizer.plan_cleanup", True,
     "Erase degenerate operators: constant filters, empty-relation "
     "propagation, zero/identity limits, duplicated sort/group keys, "
     "constant GROUP BY keys (EliminateFilter/PropagateEmptyRelation/"
     "EliminateLimit/EliminateDuplicatedExpr/EliminateGroupByConstant "
     "analogs).")
_opt("optimizer.filter_null_join_keys", False,
     "Filter NULL keys below INNER equi-joins with nullable keys "
     "(FilterNullJoinKeys analog). Off by default: the join kernels "
     "already AND key validity into the live masks, so NULL keys are "
     "dead rows at zero extra cost; the explicit filters only change "
     "plan shapes (= fresh XLA compiles).")
_opt("optimizer.dynamic_filter_pushdown", True,
     "In chunked joins, push build-side min/max key bounds into the probe "
     "side as per-chunk BETWEEN filters and parquet pruning hints "
     "(DynamicFilterPhysicalExpr analog).")

# ---- sql ------------------------------------------------------------------
_opt("sql_parser.dialect", "generic", "Accepted SQL dialect (informational).")
_opt("sql_parser.recursion_limit", 64,
     "Maximum expression-nesting depth; deeper queries raise ParseError "
     "(reference: recursion limit in session_state.rs:458).")
_opt("sql_parser.parse_float_as_decimal", False,
     "Numeric literals with a decimal point parse as exact decimals; the "
     "default (false, matching the reference) types them Float64.")

# ---- explain --------------------------------------------------------------
_opt("explain.show_sizes", True, "Include capacities in EXPLAIN output.")
_opt("explain.format", "indent",
     "EXPLAIN rendering: 'indent' (one line per operator) or 'tree' "
     "(box-drawing operator tree; reference explain.format, "
     "common/src/config.rs ExplainFormat).")
_opt("explain.logical_plan_only", False,
     "EXPLAIN shows only the logical plan.")
_opt("explain.physical_plan_only", False,
     "EXPLAIN shows only the physical plan.")


# ---- reference-named compatibility surface --------------------------------
# The reference exposes ~150 `datafusion.*` keys (common/src/config.rs:222-
# 1800). SET / information_schema.df_settings accept the most-used ones here:
# aliased keys drive the native option of the same meaning; inert keys are
# accepted and surfaced (SLT files SET them freely) but have no engine effect
# because the TPU design has no analogous mechanism (no per-batch pipeline,
# no row-group writer pool, ...).
def _ref(key: str, default, alias: Optional[str] = None, doc: str = ""):
    parse: Callable[[str], Any]
    if isinstance(default, bool):
        parse = _parse_bool
    elif isinstance(default, int):
        parse = int
    elif isinstance(default, float):
        parse = float
    else:
        parse = str
    REGISTRY["datafusion." + key] = ConfigEntry(
        "datafusion." + key, default, doc or
        ("mirrors " + alias if alias else "accepted for reference "
         "compatibility; no effect in this engine"),
        parse, alias=alias, inert=alias is None)


_ref("catalog.create_default_catalog_and_schema", True)
_ref("catalog.default_catalog", "datafusion")
_ref("catalog.default_schema", "public")
_ref("catalog.information_schema", True,
     doc="information_schema is always available in this engine")
_ref("catalog.has_header", True)
_ref("catalog.newlines_in_values", False)
_ref("sql_parser.parse_float_as_decimal", False,
     alias="sql_parser.parse_float_as_decimal")
_ref("sql_parser.enable_ident_normalization", True)
_ref("sql_parser.dialect", "generic", alias="sql_parser.dialect")
_ref("sql_parser.support_varchar_with_length", True)
_ref("sql_parser.recursion_limit", 50, alias="sql_parser.recursion_limit")
_ref("sql_parser.collect_spans", False)
_ref("execution.batch_size", 8192)
_ref("execution.coalesce_batches", True,
     doc="no-op: the capacity+selection-mask model never fragments batches")
_ref("execution.collect_statistics", True)
_ref("execution.target_partitions", 0, alias="execution.target_partitions")
_ref("execution.time_zone", "+00:00")
_ref("execution.planning_concurrency", 4)
_ref("execution.spill_compression", "uncompressed")
_ref("execution.sort_spill_reservation_bytes", 10 * 1024 * 1024)
_ref("execution.sort_in_place_threshold_bytes", 1024 * 1024)
_ref("execution.meta_fetch_concurrency", 32)
_ref("execution.minimum_parallel_output_files", 4)
_ref("execution.soft_max_rows_per_output_file", 50_000_000)
_ref("execution.max_buffered_batches_per_output_file", 2)
_ref("execution.listing_table_ignore_subdirectory", True)
_ref("execution.enable_recursive_ctes", True,
     doc="recursive CTEs are always on (host-driven fixpoint)")
_ref("execution.split_file_groups_by_statistics", False)
_ref("execution.keep_partition_by_columns", False)
_ref("execution.skip_partial_aggregation_probe_ratio_threshold", 0.8)
_ref("execution.skip_partial_aggregation_probe_rows_threshold", 100_000)
_ref("execution.use_row_number_estimates_to_optimize_partitioning", False)
_ref("execution.enforce_batch_size_in_joins", False)
_ref("execution.parquet.enable_page_index", True)
_ref("execution.parquet.pruning", True)
_ref("execution.parquet.skip_metadata", True)
_ref("execution.parquet.metadata_size_hint", 512 * 1024)
_ref("execution.parquet.pushdown_filters", False)
_ref("execution.parquet.reorder_filters", False)
_ref("execution.parquet.schema_force_view_types", True)
_ref("execution.parquet.binary_as_string", False)
_ref("execution.parquet.bloom_filter_on_read", True)
_ref("execution.parquet.data_pagesize_limit", 1024 * 1024)
_ref("execution.parquet.write_batch_size", 1024)
_ref("execution.parquet.writer_version", "1.0")
_ref("execution.parquet.compression", "zstd(3)")
_ref("execution.parquet.dictionary_enabled", True)
_ref("execution.parquet.dictionary_page_size_limit", 1024 * 1024)
_ref("execution.parquet.statistics_enabled", "page")
_ref("execution.parquet.max_row_group_size", 1024 * 1024)
_ref("execution.parquet.column_index_truncate_length", 64)
_ref("execution.parquet.data_page_row_count_limit", 20_000)
_ref("execution.parquet.encoding", "")
_ref("execution.parquet.bloom_filter_on_write", False)
_ref("execution.parquet.bloom_filter_fpp", 0.05)
_ref("execution.parquet.bloom_filter_ndv", 1_000_000)
_ref("execution.parquet.allow_single_file_parallelism", True)
_ref("execution.parquet.maximum_parallel_row_group_writers", 1)
_ref("execution.parquet.maximum_buffered_record_batches_per_stream", 2)
_ref("optimizer.enable_distinct_aggregation_soft_limit", True)
_ref("optimizer.enable_round_robin_repartition", True)
_ref("optimizer.enable_topk_aggregation", True)
_ref("optimizer.enable_window_limits", True)
_ref("optimizer.enable_dynamic_filter_pushdown", True,
     alias="optimizer.dynamic_filter_pushdown")
_ref("optimizer.filter_null_join_keys", False,
     alias="optimizer.filter_null_join_keys")
_ref("optimizer.repartition_aggregations", True)
_ref("optimizer.repartition_file_min_size", 1024 * 1024)
_ref("optimizer.repartition_joins", True)
_ref("optimizer.allow_symmetric_joins_without_pruning", True)
_ref("optimizer.repartition_file_scans", True)
_ref("optimizer.repartition_windows", True)
_ref("optimizer.repartition_sorts", True)
_ref("optimizer.prefer_existing_sort", False)
_ref("optimizer.skip_failed_rules", False)
_ref("optimizer.max_passes", 3, alias="optimizer.max_passes")
_ref("optimizer.top_down_join_key_reordering", True)
_ref("optimizer.prefer_hash_join", True)
_ref("optimizer.hash_join_single_partition_threshold", 1024 * 1024)
_ref("optimizer.hash_join_single_partition_threshold_rows", 1024 * 128)
_ref("optimizer.default_filter_selectivity", 20)
_ref("optimizer.prefer_existing_union", False)
_ref("optimizer.expand_views_at_output", False)
_ref("explain.logical_plan_only", False, alias="explain.logical_plan_only")
_ref("explain.physical_plan_only", False, alias="explain.physical_plan_only")
_ref("explain.show_statistics", False)
_ref("explain.show_sizes", True, alias="explain.show_sizes")
_ref("explain.show_schema", False)
_ref("explain.format", "indent", alias="explain.format")
_ref("format.safe", True)
_ref("format.null", "")
_ref("format.date_format", "%Y-%m-%d")
_ref("format.duration_format", "pretty")
_ref("format.types_info", False)


class ConfigOptions:
    """Resolved option values with dotted-key get/set."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {k: e.default for k, e in REGISTRY.items()}
        self._extensions: Dict[str, str] = {}
        self._load_env()
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def _load_env(self):
        for k, e in REGISTRY.items():
            env = "DATAFUSION_TPU__" + k.upper().replace(".", "__")
            if env in os.environ:
                self._values[k] = e.parse(os.environ[env])

    def get(self, key: str, default=None):
        if key in self._values:
            return self._values[key]
        return self._extensions.get(key, default)

    def set(self, key: str, value) -> None:
        e = REGISTRY.get(key)
        if e is None:
            # extension namespace (reference: ConfigExtension)
            self._extensions[key] = value
            return
        if isinstance(value, str):
            value = e.parse(value)
        self._values[key] = value
        if e.alias is not None:  # reference-named key drives the native one
            self.set(e.alias, value)

    def to_dict(self) -> Dict[str, Any]:
        out = dict(self._values)
        out.update(self._extensions)
        return out


def render_docs() -> str:
    """Markdown table of all options (reference: docs auto-generated into
    docs/source/user-guide/configs.md)."""
    lines = ["| key | default | description |", "|---|---|---|"]
    for k in sorted(REGISTRY):
        e = REGISTRY[k]
        lines.append(f"| `{k}` | `{e.default}` | {e.doc} |")
    return "\n".join(lines)
