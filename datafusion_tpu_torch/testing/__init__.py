# Verbatim copy of datafusion_tpu/testing/__init__.py; host-only, kept in step with the original.
