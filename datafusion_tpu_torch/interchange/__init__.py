"""Plan and data interchange.

Port of datafusion_tpu/interchange/. Substrait (substrait.py, proto3-JSON,
no protobuf runtime) and DataFusion's protobuf logical plans (dfproto.py,
over the generated bindings in proto/) are verbatim copies: they map plans
to and from the copied logical plan IR. The protobuf physical plans
(dfproto_physical.py) are ported over this package's operators. ffi.py, the
native plugin ABI, is a verbatim copy as well. Substrait is the
engine-neutral plan representation, so plans produced by other engines can
execute here, and plans made here can be shipped out."""
from .substrait import plan_from_substrait, plan_to_substrait  # noqa: F401
