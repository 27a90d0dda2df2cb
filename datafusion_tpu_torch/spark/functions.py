"""Spark-semantics scalar functions (reference: datafusion/spark/src/function/).

Port of datafusion_tpu/spark/functions.py, first part: the pure-Python
xxHash64 that the copied io/bloom.py probes Parquet split-block bloom
filters with (seed 0). The Spark function library itself (SPARK_FNS,
spark_function_type, eval_spark_function and the helpers under them) is
not ported yet (ROADMAP queue 1, item 9c)."""
from __future__ import annotations


def _xxhash64(data: bytes, seed: int = 42) -> int:
    """Pure-python xxHash64 (public algorithm; Spark seeds with 42)."""
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
    M = (1 << 64) - 1

    def rot(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    n = len(data)
    if n >= 32:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        i = 0
        while i <= n - 32:
            for j, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 8 * j:i + 8 * j + 8], "little")
                v = (v + lane * P2) & M
                v = rot(v, 31)
                v = (v * P1) & M
                if j == 0:
                    v1 = v
                elif j == 1:
                    v2 = v
                elif j == 2:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (rot(v1, 1) + rot(v2, 7) + rot(v3, 12) + rot(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            v = (v * P2) & M
            v = rot(v, 31)
            v = (v * P1) & M
            h = ((h ^ v) * P1 + P4) & M
    else:
        h = (seed + P5) & M
        i = 0
    h = (h + n) & M
    while i <= n - 8:
        lane = int.from_bytes(data[i:i + 8], "little")
        k = (lane * P2) & M
        k = rot(k, 31)
        k = (k * P1) & M
        h = (rot(h ^ k, 27) * P1 + P4) & M
        i += 8
    if i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        h = (rot(h ^ ((lane * P1) & M), 23) * P2 + P3) & M
        i += 4
    while i < n:
        h = (rot(h ^ ((data[i] * P5) & M), 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h
