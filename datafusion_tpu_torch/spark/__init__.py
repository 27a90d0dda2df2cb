"""Spark-compatible function library.

Port of datafusion_tpu/spark/ (reference: the `datafusion-spark` crate,
datafusion/spark/src/function/): a parallel function set with Spark
semantics, opt-in per session. Enable with
``ctx.enable_spark_functions()`` — Spark-semantic functions then resolve
first (e.g. ``round`` switches to HALF_UP), and Spark-only names
(``sha2``, ``crc32``, ``elt``, ``date_add`` …) become available.
"""
from .functions import SPARK_FNS  # noqa: F401
