# Verbatim copy of datafusion_tpu/io/avro.py; host-only, kept in step with the original.
"""Avro Object Container File reader (and writer, used for fixtures and
COPY TO AVRO).

Capability analog of the reference's read-only Avro source
(datasource-avro crate; docs/source/user-guide/features.md lists Avro as
read-only). No Avro library ships in this image, so this is a self-contained
binary decoder for the container format:

    header  = magic "Obj\\x01" + metadata map (avro.schema JSON, avro.codec)
            + 16-byte sync marker
    block*  = record-count long + byte-size long + (possibly deflated)
              record bytes + sync marker

Supported schema shapes: a top-level record whose fields are primitives
(null/boolean/int/long/float/double/bytes/string), nullable unions of one
primitive, enums (decoded to their symbol strings), fixed, logical types
date / time-millis / timestamp-millis / timestamp-micros, and arrays of
primitives (decoded to list values). Unsupported shapes raise PlanError
naming the field."""
from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from ..common.errors import PlanError

_MAGIC = b"Obj\x01"


class _Decoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def long(self) -> int:
        result = shift = 0
        buf, pos = self.buf, self.pos
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        self.pos = pos
        return (result >> 1) ^ -(result & 1)  # zigzag

    def raw(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def bytes_(self) -> bytes:
        return self.raw(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def boolean(self) -> bool:
        b = self.buf[self.pos]
        self.pos += 1
        return b != 0

    def float_(self) -> float:
        (v,) = struct.unpack_from("<f", self.buf, self.pos)
        self.pos += 4
        return v

    def double(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def map_(self) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        while True:
            n = self.long()
            if n == 0:
                return out
            if n < 0:  # negative count: a byte size follows (skippable form)
                self.long()
                n = -n
            for _ in range(n):
                k = self.string()  # RHS of a subscript assignment would
                out[k] = self.bytes_()  # evaluate first and swap the reads

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


def _field_reader(schema, name: str):
    """(value-reader closure over a _Decoder, arrow type factory name)."""
    if isinstance(schema, list):  # union
        branches = [_field_reader(s, name) for s in schema]
        readers = [b[0] for b in branches]
        atypes = [b[1] for b in branches if b[1] is not None]
        if len(atypes) > 1:
            raise PlanError(f"avro field {name!r}: only null-unions supported")

        def read_union(d: _Decoder):
            return readers[d.long()](d)

        return read_union, (atypes[0] if atypes else "null")
    if isinstance(schema, dict):
        t = schema.get("type")
        lt = schema.get("logicalType")
        if t == "array":
            item, _at = _field_reader(schema["items"], name)

            def read_array(d: _Decoder):
                out = []
                while True:
                    n = d.long()
                    if n == 0:
                        return out
                    if n < 0:
                        d.long()
                        n = -n
                    for _ in range(n):
                        out.append(item(d))

            return read_array, "array"
        if t == "enum":
            symbols = schema["symbols"]
            return (lambda d: symbols[d.long()]), "string"
        if t == "fixed":
            size = schema["size"]
            return (lambda d: d.raw(size)), "binary"
        if t in ("record", "map"):
            raise PlanError(f"avro field {name!r}: nested {t} not supported")
        # primitive (possibly logical) spelled as {"type": "...", ...}
        base, _ = _field_reader(t, name)
        if lt == "date":
            return base, "date32"
        if lt == "timestamp-millis":
            return base, "timestamp_ms"
        if lt == "timestamp-micros":
            return base, "timestamp_us"
        if lt == "time-millis":
            return base, "int32"
        atype = _field_reader(t, name)[1]
        return base, atype
    if schema == "null":
        return (lambda d: None), None
    if schema == "boolean":
        return _Decoder.boolean, "bool"
    if schema == "int":
        return _Decoder.long, "int32"
    if schema == "long":
        return _Decoder.long, "int64"
    if schema == "float":
        return _Decoder.float_, "float32"
    if schema == "double":
        return _Decoder.double, "float64"
    if schema == "bytes":
        return _Decoder.bytes_, "binary"
    if schema == "string":
        return _Decoder.string, "string"
    raise PlanError(f"avro field {name!r}: unsupported type {schema!r}")


_ARROW_TYPES = {
    "bool": "bool_", "int32": "int32", "int64": "int64",
    "float32": "float32", "float64": "float64", "string": "string",
    "binary": "binary", "date32": "date32",
}


def _arrow_type(tag: str):
    import pyarrow as pa

    if tag == "timestamp_ms":
        return pa.timestamp("ms")
    if tag == "timestamp_us":
        return pa.timestamp("us")
    if tag == "date32":
        return pa.date32()
    if tag == "null":
        return pa.null()
    if tag == "array":
        return None  # let pyarrow infer the list type
    return getattr(pa, _ARROW_TYPES[tag])()


def read_avro(path: str):
    """Decode one .avro container file into a pyarrow Table."""
    import pyarrow as pa

    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != _MAGIC:
        raise PlanError(f"{path}: not an Avro object container file")
    d = _Decoder(buf)
    d.pos = 4
    meta = d.map_()
    sync = d.raw(16)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise PlanError(f"{path}: unsupported avro codec {codec!r}")
    schema = json.loads(meta["avro.schema"])
    if isinstance(schema, dict) and schema.get("type") != "record":
        raise PlanError(f"{path}: top-level avro schema must be a record")
    fields = schema["fields"]
    readers = []
    for f in fields:
        rd, atype = _field_reader(f["type"], f["name"])
        readers.append((f["name"], rd, atype))
    columns: Dict[str, List] = {name: [] for name, _r, _a in readers}
    while not d.at_end():
        count = d.long()
        size = d.long()
        block = d.raw(size)
        if d.raw(16) != sync:
            raise PlanError(f"{path}: sync marker mismatch (corrupt block)")
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bd = _Decoder(block)
        for _ in range(count):
            for name, rd, _a in readers:
                columns[name].append(rd(bd))
    arrays, names = [], []
    for name, _rd, atype in readers:
        at = _arrow_type(atype)
        vals = columns[name]
        if atype == "date32":
            import datetime

            vals = [None if v is None else
                    datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
                    for v in vals]
        arrays.append(pa.array(vals, type=at))
        names.append(name)
    return pa.table(dict(zip(names, arrays)))


# ---------------------------------------------------------------------------
# writer (fixtures + COPY TO AVRO; the reference is read-only here)
# ---------------------------------------------------------------------------


def _zigzag_long(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | (0x80 if u else 0))
        if not u:
            return bytes(out)


def _avro_schema_for(field) -> Tuple[object, Optional[str]]:
    """(avro type json, encoder tag) for an arrow field."""
    import pyarrow as pa

    t = field.type
    if pa.types.is_boolean(t):
        base: object = "boolean"
    elif pa.types.is_integer(t):
        base = "int" if t.bit_width <= 32 else "long"
    elif pa.types.is_float32(t):
        base = "float"
    elif pa.types.is_float64(t):
        base = "double"
    elif pa.types.is_string(t) or pa.types.is_large_string(t):
        base = "string"
    elif pa.types.is_binary(t):
        base = "bytes"
    elif pa.types.is_date32(t):
        base = {"type": "int", "logicalType": "date"}
    elif pa.types.is_timestamp(t):
        unit = "micros" if t.unit == "us" else "millis"
        base = {"type": "long", "logicalType": f"timestamp-{unit}"}
    else:
        raise PlanError(f"COPY TO AVRO: unsupported column type {t}")
    tag = base if isinstance(base, str) else base["type"]
    return ["null", base], tag


def _encode_value(v, tag: str) -> bytes:
    if tag in ("int", "long"):
        return _zigzag_long(int(v))
    if tag == "boolean":
        return b"\x01" if v else b"\x00"
    if tag == "float":
        return struct.pack("<f", float(v))
    if tag == "double":
        return struct.pack("<d", float(v))
    if tag == "string":
        raw = str(v).encode("utf-8")
        return _zigzag_long(len(raw)) + raw
    if tag == "bytes":
        return _zigzag_long(len(v)) + bytes(v)
    raise PlanError(f"avro encode: unsupported tag {tag}")


def write_avro(table, path: str, codec: str = "null",
               block_rows: int = 64 * 1024) -> None:
    """Write a pyarrow Table as an Avro OCF (every field nullable union)."""
    import datetime

    import pyarrow as pa

    fields = []
    tags = []
    for f in table.schema:
        avro_t, tag = _avro_schema_for(f)
        fields.append({"name": f.name, "type": avro_t})
        tags.append(tag)
    schema = {"type": "record", "name": "row", "fields": fields}
    sync = b"datafusion-tpu-s"  # any 16 bytes
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    cols = []
    for f, tag in zip(table.schema, tags):
        col = table.column(f.name).to_pylist()
        if pa.types.is_date32(f.type):
            epoch = datetime.date(1970, 1, 1)
            col = [None if v is None else (v - epoch).days for v in col]
        elif pa.types.is_timestamp(f.type):
            col = [None if v is None else int(v.timestamp() * (
                1_000_000 if f.type.unit == "us" else 1_000)) for v in col]
        cols.append(col)
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(_zigzag_long(len(meta)))
        for k, v in meta.items():
            kb = k.encode()
            fh.write(_zigzag_long(len(kb)) + kb)
            fh.write(_zigzag_long(len(v)) + v)
        fh.write(_zigzag_long(0))
        fh.write(sync)
        n = table.num_rows
        for start in range(0, n, block_rows) or [0]:
            stop = min(start + block_rows, n)
            body = bytearray()
            for i in range(start, stop):
                for col, tag in zip(cols, tags):
                    v = col[i]
                    if v is None:
                        body += _zigzag_long(0)
                    else:
                        body += _zigzag_long(1)
                        body += _encode_value(v, tag)
            raw = bytes(body)
            if codec == "deflate":
                co = zlib.compressobj(9, zlib.DEFLATED, -15)
                raw = co.compress(raw) + co.flush()
            fh.write(_zigzag_long(stop - start))
            fh.write(_zigzag_long(len(raw)))
            fh.write(raw)
            fh.write(sync)
