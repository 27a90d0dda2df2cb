"""Memory accounting: pools that operators register their outputs with.

Port of the part of datafusion_tpu/runtime/memory.py that
PhysicalPlan._timed uses: an unbounded tracking pool, a bounded greedy pool
(reference: MemoryPool / GreedyMemoryPool, execution/src/memory_pool/), and
the byte count of a relation's tensors."""
from __future__ import annotations

from typing import Dict, List

from ..common.errors import ResourceExhausted


class MemoryPool:
    """Unbounded pool: tracks but never rejects."""

    def __init__(self):
        self.reserved: int = 0
        self.peak: int = 0
        self.by_consumer: Dict[str, int] = {}

    def try_grow(self, consumer: str, additional: int) -> None:
        self._grow(consumer, additional)

    def _grow(self, consumer: str, additional: int) -> None:
        self.reserved += additional
        self.by_consumer[consumer] = self.by_consumer.get(consumer, 0) + additional
        self.peak = max(self.peak, self.reserved)

    def shrink(self, consumer: str, amount: int) -> None:
        self.reserved = max(0, self.reserved - amount)
        if consumer in self.by_consumer:
            self.by_consumer[consumer] = max(0, self.by_consumer[consumer] - amount)

    def top_consumers(self, k: int = 5) -> List[tuple]:
        return sorted(self.by_consumer.items(), key=lambda kv: -kv[1])[:k]


class GreedyMemoryPool(MemoryPool):
    """Bounded pool: first-come-first-served up to the limit."""

    def __init__(self, limit_bytes: int):
        super().__init__()
        self.limit = limit_bytes

    def try_grow(self, consumer: str, additional: int) -> None:
        if self.reserved + additional > self.limit:
            top = ", ".join(f"{n}={b // 1024 // 1024}MB" for n, b in self.top_consumers())
            raise ResourceExhausted(
                f"memory pool exhausted: need {additional} bytes, "
                f"{self.limit - self.reserved} available of {self.limit}; "
                f"top consumers: {top}"
            )
        self._grow(consumer, additional)


def relation_bytes(rel) -> int:
    """Device bytes held by a DeviceRelation."""
    total = rel.sel.numel() * rel.sel.element_size()
    for c in rel.columns:
        total += c.data.numel() * c.data.element_size()
        if c.validity is not None:
            total += c.validity.numel() * c.validity.element_size()
    return int(total)
