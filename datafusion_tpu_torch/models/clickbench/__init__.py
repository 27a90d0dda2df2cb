# Verbatim copy of datafusion_tpu/models/clickbench/__init__.py; host-only, kept in step with the original.
