"""Hash sharding across endpoints (paper §4.3): the part of the reference's
``core/endpoint.py`` the serve engines use for their result store.  The
host-memory pool and the peer endpoints come with later slices (ROADMAP
Q3)."""
from __future__ import annotations

import zlib
from typing import Any, List

NUM_SLOTS = 16384  # the paper's Redis hash-slot count


def hash_slot(key: bytes, num_slots: int = NUM_SLOTS) -> int:
    """CRC16-mod-slots in the paper; CRC32 here — same structure."""
    return zlib.crc32(key) % num_slots


class ShardedStore:
    """Non-overlapping key shards across N endpoints — the host+SmartNIC
    Redis-sharding case study generalized to N sidecar endpoints."""

    def __init__(self, endpoints: List[Any], num_slots: int = NUM_SLOTS):
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self.endpoints = endpoints
        self.num_slots = num_slots
        # slot -> endpoint index (contiguous ranges, like Redis cluster)
        per = num_slots / len(endpoints)
        self.slot_owner = [min(int(s / per), len(endpoints) - 1)
                           for s in range(num_slots)]

    def owner(self, key: str) -> int:
        return self.slot_owner[hash_slot(key.encode())]

    def put(self, key: str, value: Any) -> int:
        i = self.owner(key)
        self.endpoints[i][key] = value
        return i

    def get(self, key: str) -> Any:
        return self.endpoints[self.owner(key)][key]

    def contains(self, key: str) -> bool:
        return key in self.endpoints[self.owner(key)]

    def pop(self, key: str, default: Any = None) -> Any:
        """Consume a key (one-shot payloads)."""
        return self.endpoints[self.owner(key)].pop(key, default)

    def balance(self) -> List[int]:
        counts = [0] * len(self.endpoints)
        for s in range(self.num_slots):
            counts[self.slot_owner[s]] += 1
        return counts
