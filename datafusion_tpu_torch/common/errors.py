# Verbatim copy of datafusion_tpu/common/errors.py; host-only, kept in step with the original.
"""Error hierarchy, mirroring the capability of the reference's DataFusionError
(datafusion/common/src/error.rs): one root with planning / execution / resource
subclasses so callers can catch at the right granularity."""


class DataFusionTpuError(Exception):
    """Root error for the engine."""


class ParseError(DataFusionTpuError):
    """SQL text could not be tokenized/parsed."""


class PlanError(DataFusionTpuError):
    """Logical/physical planning failure (unknown column, bad types, ...)."""


class ExecutionError(DataFusionTpuError):
    """Runtime failure during query execution."""


class ResourceExhausted(DataFusionTpuError):
    """Memory-pool style resource failure (analog of ResourcesExhausted)."""


class QueryCancelled(ExecutionError):
    """Query interrupted by SessionContext.interrupt() or a configured
    execution.timeout_seconds deadline (analog of the reference's stream
    drop / cancellation propagation, see benchmarks/src/cancellation)."""


class NotImplementedYet(DataFusionTpuError):
    """Feature recognized but not yet supported."""
