"""datafusion_tpu_torch: the PyTorch/CUDA port of datafusion_tpu, a vectorized
SQL query engine, for NVIDIA Hopper cards. It imports torch and nothing of
JAX or of the datafusion_tpu package; see README.md ("PyTorch/CUDA port")."""

from .common import types  # noqa: F401
from .common.errors import (DataFusionTpuError, ExecutionError, ParseError,  # noqa: F401
                            PlanError)
from .common.schema import Field, Schema  # noqa: F401
from .context import DataFrame, SessionContext  # noqa: F401
from .data.table import Table  # noqa: F401
from .expr.nodes import col, lit  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "SessionContext", "DataFrame", "Table", "Schema", "Field", "col", "lit",
    "types", "DataFusionTpuError", "ParseError", "PlanError", "ExecutionError",
]
