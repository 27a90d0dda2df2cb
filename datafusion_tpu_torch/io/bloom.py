# Verbatim copy of datafusion_tpu/io/bloom.py; host-only, kept in step with the original.
"""Parquet bloom-filter pruning (split-block bloom filters, SBBF).

Capability analog of the reference's bloom-filter row-group pruning stage
(datasource-parquet/src/opener/mod.rs:388-593, row_group_filter.rs /
bloom_filter.rs). pyarrow does not expose bloom-filter *reading*, so this
module parses the parquet footer itself (thrift compact protocol) to locate
each column chunk's `bloom_filter_offset`/`bloom_filter_length`
(ColumnMetaData fields 14/15), reads the BloomFilterHeader + bitset lazily,
and answers "might this row group contain value v?" for equality predicates.

Split-block bloom filter (parquet spec, BlockSplitBloomFilter): the filter is
N 256-bit blocks of eight 32-bit words. A value hashes with xxHash64(seed=0)
over its PLAIN-encoded bytes; the top 32 bits pick a block, the low 32 bits
spread to one bit per word via the eight salt constants. Membership check =
all eight bits set.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

# thrift compact-protocol element types
_CT_STOP, _CT_TRUE, _CT_FALSE, _CT_BYTE = 0, 1, 2, 3
_CT_I16, _CT_I32, _CT_I64, _CT_DOUBLE = 4, 5, 6, 7
_CT_BINARY, _CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT = 8, 9, 10, 11, 12

_SALT = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
         0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _parse_value(ctype: int, buf: bytes, pos: int):
    if ctype == _CT_TRUE:
        return True, pos
    if ctype == _CT_FALSE:
        return False, pos
    if ctype == _CT_BYTE:
        return buf[pos], pos + 1
    if ctype in (_CT_I16, _CT_I32, _CT_I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if ctype == _CT_DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ctype == _CT_BINARY:
        n, pos = _varint(buf, pos)
        return bytes(buf[pos:pos + n]), pos + n
    if ctype in (_CT_LIST, _CT_SET):
        head = buf[pos]
        pos += 1
        size, etype = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        out = []
        if etype in (_CT_TRUE, _CT_FALSE):
            # unlike struct fields, LIST bool elements occupy one byte each
            # (0x01 = true, 0x02 = false)
            for _ in range(size):
                out.append(buf[pos] == 1)
                pos += 1
            return out, pos
        for _ in range(size):
            v, pos = _parse_value(etype, buf, pos)
            out.append(v)
        return out, pos
    if ctype == _CT_MAP:
        size, pos = _varint(buf, pos)
        out = {}
        if size:
            kv = buf[pos]
            pos += 1
            ktype, vtype = kv >> 4, kv & 0x0F
            for _ in range(size):
                k, pos = _parse_value(ktype, buf, pos)
                v, pos = _parse_value(vtype, buf, pos)
                out[k] = v
        return out, pos
    if ctype == _CT_STRUCT:
        return parse_struct(buf, pos)
    raise ValueError(f"unknown thrift compact type {ctype}")


def parse_struct(buf: bytes, pos: int = 0) -> Tuple[Dict[int, object], int]:
    """Parse one thrift compact struct into {field id: value}."""
    fields: Dict[int, object] = {}
    last_id = 0
    while True:
        byte = buf[pos]
        pos += 1
        if byte == _CT_STOP:
            return fields, pos
        delta, ctype = byte >> 4, byte & 0x0F
        if delta == 0:
            raw, pos = _varint(buf, pos)
            fid = _zigzag(raw)
        else:
            fid = last_id + delta
        last_id = fid
        fields[fid], pos = _parse_value(ctype, buf, pos)
    # unreachable


def encode_plain(value, physical_type: str) -> Optional[bytes]:
    """PLAIN-encode a logical value for bloom hashing; None = unsupported
    (the caller must then treat the filter as inconclusive)."""
    try:
        if physical_type == "INT32":
            return struct.pack("<i", int(value))
        if physical_type == "INT64":
            return struct.pack("<q", int(value))
        if physical_type == "FLOAT":
            return struct.pack("<f", float(value))
        if physical_type == "DOUBLE":
            return struct.pack("<d", float(value))
        if physical_type == "BYTE_ARRAY":
            if isinstance(value, bytes):
                return value
            if isinstance(value, str):
                return value.encode("utf-8")
    except (struct.error, ValueError, OverflowError):
        return None
    return None


class BloomIndex:
    """Lazy per-file access to parquet split-block bloom filters.

    Offsets come from our own footer parse (pyarrow hides them); bitsets are
    read and cached on first probe of each (row group, column)."""

    def __init__(self, path: str, opener=None):
        self.path = path
        # object-store-aware open (io/object_store.py); defaults to local
        self._open = opener or (lambda p: open(p, "rb"))
        # {(rg, column): (offset, length-or-None)}; None until footer parsed
        self._offsets: Optional[Dict[Tuple[int, str], Tuple[int, Optional[int]]]] = None
        self._bitsets: Dict[Tuple[int, str], Optional[List[int]]] = {}

    def _load_offsets(self) -> Dict[Tuple[int, str], Tuple[int, Optional[int]]]:
        if self._offsets is not None:
            return self._offsets
        out: Dict[Tuple[int, str], Tuple[int, Optional[int]]] = {}
        try:
            with self._open(self.path) as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(size - 8)
                tail = f.read(8)
                if tail[4:] != b"PAR1":
                    self._offsets = out
                    return out
                (meta_len,) = struct.unpack("<I", tail[:4])
                f.seek(size - 8 - meta_len)
                meta = f.read(meta_len)
            fmd, _ = parse_struct(meta)
            # FileMetaData.4 = row_groups; RowGroup.1 = columns;
            # ColumnChunk.3 = meta_data; ColumnMetaData.3 = path_in_schema,
            # .14 = bloom_filter_offset, .15 = bloom_filter_length
            for rg, rgroup in enumerate(fmd.get(4) or []):
                for chunk in rgroup.get(1) or []:
                    cmd = chunk.get(3)
                    if not isinstance(cmd, dict) or 14 not in cmd:
                        continue
                    path = b".".join(cmd.get(3) or []).decode("utf-8", "replace")
                    out[(rg, path)] = (cmd[14], cmd.get(15))
        except (OSError, ValueError, KeyError, IndexError, struct.error):
            out = {}
        self._offsets = out
        return out

    def has_filter(self, rg: int, column: str) -> bool:
        return (rg, column) in self._load_offsets()

    def _bitset(self, rg: int, column: str) -> Optional[List[int]]:
        key = (rg, column)
        if key in self._bitsets:
            return self._bitsets[key]
        loc = self._load_offsets().get(key)
        bitset: Optional[List[int]] = None
        if loc is not None:
            offset, length = loc
            try:
                with self._open(self.path) as f:
                    f.seek(offset)
                    raw = f.read(length if length else 4096)
                    hdr, body = parse_struct(raw)
                    num_bytes = hdr.get(1)
                    if num_bytes and num_bytes > 0:
                        if len(raw) < body + num_bytes:
                            f.seek(offset + body)
                            raw = raw[:body] + f.read(num_bytes)
                        data = raw[body:body + num_bytes]
                        if len(data) == num_bytes and num_bytes % 32 == 0:
                            n = num_bytes // 4
                            bitset = list(struct.unpack(f"<{n}I", data))
            except (OSError, ValueError, struct.error):
                bitset = None
        self._bitsets[key] = bitset
        return bitset

    def might_contain_any(self, rg: int, column: str,
                          encoded: List[bytes]) -> Optional[bool]:
        """True/False if the bloom filter answers, None if unavailable."""
        bitset = self._bitset(rg, column)
        if bitset is None or not encoded:
            return None
        from ..spark.functions import _xxhash64

        nblocks = len(bitset) // 8
        for raw in encoded:
            h = _xxhash64(raw, seed=0)
            block = ((h >> 32) * nblocks) >> 32
            key = h & 0xFFFFFFFF
            base = block * 8
            if all((bitset[base + i] >> (((key * _SALT[i]) & 0xFFFFFFFF) >> 27)) & 1
                   for i in range(8)):
                return True
        return False
