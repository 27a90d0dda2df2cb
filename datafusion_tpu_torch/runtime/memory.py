"""Memory accounting: pools + reservations.

Port of datafusion_tpu/runtime/memory.py (reference: MemoryPool /
MemoryReservation, execution/src/memory_pool/mod.rs:188,375, and the pool
implementations in pool.rs). The managed resource is the card's memory:
operators register the device relations they hold; a bounded pool raises
ResourceExhausted naming the top consumers, and the chunked executor
(physical/chunked.py) reads its headroom to merge or spill to the host
(runtime/spill.py) before that happens."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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

    def headroom(self) -> Optional[int]:
        """Bytes available before the limit (None = unbounded). Cooperative
        consumers (the chunked executor) check this to merge or spill before
        try_grow would raise."""
        return None

    def headroom_for(self, consumer: str) -> Optional[int]:
        """Bytes this consumer may still grow by (None = unbounded); equals
        headroom() except under per-consumer policies (FairSpillPool)."""
        return self.headroom()

    @property
    def bounded(self) -> bool:
        return self.headroom() is not None


def _exhausted(pool, additional: int) -> ResourceExhausted:
    top = ", ".join(f"{n}={b // 1024 // 1024}MB" for n, b in pool.top_consumers())
    return ResourceExhausted(
        f"memory pool exhausted: need {additional} bytes, "
        f"{pool.limit - pool.reserved} available of {pool.limit}; "
        f"top consumers: {top}")


class GreedyMemoryPool(MemoryPool):
    """Bounded pool: first-come-first-served up to the limit
    (reference: GreedyMemoryPool, memory_pool/pool.rs:77)."""

    def __init__(self, limit_bytes: int):
        super().__init__()
        self.limit = limit_bytes

    def headroom(self) -> Optional[int]:
        return max(0, self.limit - self.reserved)

    def try_grow(self, consumer: str, additional: int) -> None:
        if self.reserved + additional > self.limit:
            raise _exhausted(self, additional)
        self._grow(consumer, additional)


class FairSpillPool(MemoryPool):
    """Bounded pool that divides the spillable budget evenly among
    registered spillable consumers (reference: FairSpillPool,
    memory_pool/pool.rs:143): unspillable consumers allocate greedily from
    the whole pool; each spillable consumer may hold at most
    (limit - unspillable) / num_spillable bytes, so one large sort cannot
    starve its siblings out of their spill thresholds."""

    def __init__(self, limit_bytes: int):
        super().__init__()
        self.limit = limit_bytes
        self._spillable: Dict[str, bool] = {}
        self._unspillable_used = 0

    def register(self, consumer: str, can_spill: bool) -> None:
        self._spillable[consumer] = can_spill

    def unregister(self, consumer: str) -> None:
        self._spillable.pop(consumer, None)

    def _num_spillable(self) -> int:
        return sum(1 for v in self._spillable.values() if v) or 1

    def _fair_share(self) -> int:
        return max(0, (self.limit - self._unspillable_used)) // self._num_spillable()

    def headroom(self) -> Optional[int]:
        return max(0, self.limit - self.reserved)

    def try_grow(self, consumer: str, additional: int) -> None:
        spillable = self._spillable.get(consumer, False)
        used = self.by_consumer.get(consumer, 0)
        if spillable and used + additional > self._fair_share():
            raise ResourceExhausted(
                f"fair-spill pool: consumer {consumer!r} would exceed "
                f"its share ({self._fair_share()} bytes across "
                f"{self._num_spillable()} spillable consumers); "
                f"spill required")
        if self.reserved + additional > self.limit:
            raise _exhausted(self, additional)
        self._grow(consumer, additional)
        if not spillable:
            self._unspillable_used += additional

    def shrink(self, consumer: str, amount: int) -> None:
        super().shrink(consumer, amount)
        if not self._spillable.get(consumer, False):
            self._unspillable_used = max(0, self._unspillable_used - amount)

    def headroom_for(self, consumer: str) -> Optional[int]:
        room = self.headroom()
        if self._spillable.get(consumer, False):
            share = self._fair_share() - self.by_consumer.get(consumer, 0)
            room = min(room, max(0, share))
        return room


@dataclasses.dataclass
class MemoryReservation:
    """RAII-style reservation (reference: MemoryReservation,
    memory_pool/mod.rs:375)."""

    pool: MemoryPool
    consumer: str
    size: int = 0

    def grow(self, additional: int) -> None:
        self.pool.try_grow(self.consumer, additional)
        self.size += additional

    def resize(self, new_size: int) -> None:
        if new_size > self.size:
            self.grow(new_size - self.size)
        else:
            self.pool.shrink(self.consumer, self.size - new_size)
            self.size = new_size

    def free(self) -> None:
        self.resize(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


def relation_bytes(rel) -> int:
    """Device bytes held by a DeviceRelation (list lengths and slot masks
    included)."""
    total = rel.sel.numel() * rel.sel.element_size()
    for c in rel.columns:
        for t in (c.data, c.validity, c.lengths, c.elem_valid):
            if t is not None:
                total += t.numel() * t.element_size()
    return int(total)
