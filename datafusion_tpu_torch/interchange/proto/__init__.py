"""Generated protobuf bindings for the DataFusion plan wire format.

The generated modules are the reference's files byte for byte, except that
datafusion_pb2.py imports its sibling package-relatively: protoc emits the
absolute `import datafusion_common_pb2`, which would need this directory on
sys.path, and in a process that also loaded the reference's bindings would
hand back that package's module object instead of this one."""
from . import datafusion_common_pb2 as common_pb2  # noqa: F401
from . import datafusion_pb2 as plan_pb2  # noqa: F401
