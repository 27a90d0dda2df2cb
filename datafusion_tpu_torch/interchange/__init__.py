"""Plan and data interchange.

Port of datafusion_tpu/interchange/: the native plugin ABI (ffi.py, a
verbatim copy: ctypes over the Arrow C Data Interface, host only). The
Substrait and DataFusion-protobuf plan interchange (substrait.py,
dfproto.py, dfproto_physical.py) is not ported yet (ROADMAP queue 1, item
12 'Remaining surface'), so this package imports neither."""
