#!/bin/sh
# Regenerate the protobuf bindings (requires protoc on PATH).
cd "$(dirname "$0")" && protoc --python_out=. -I. datafusion.proto datafusion_common.proto
