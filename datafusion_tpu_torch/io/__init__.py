# Verbatim copy of datafusion_tpu/io/__init__.py; host-only, kept in step with the original.
