"""Pod thesaurus + synonym resolver (paper §4.2).

A capacity-bounded mapping from 128-bit pod digests to pod references.
Before writing pod bytes, Chipmink consults the thesaurus: a hit means a
synonymous pod already exists in storage, so only a synonym record is
written.  Eviction is LIFO, as in the paper ("we select the last in first
out eviction policy for its simplicity").  Capacity is expressed in bytes
(16 B per 128-bit entry), matching the paper's 1 GB ≈ 62.5 M pods sizing.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

ENTRY_BYTES = 16  # 128-bit digest


class PodThesaurus:
    def __init__(self, capacity_bytes: int = 1 << 30):
        self.capacity = max(0, int(capacity_bytes))
        self.max_entries = self.capacity // ENTRY_BYTES
        self._map: Dict[bytes, str] = {}
        self._stack: List[bytes] = []   # LIFO order of insertion
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    def lookup(self, digest: bytes) -> Optional[str]:
        ref = self._map.get(digest)
        if ref is None:
            self.misses += 1
        else:
            self.hits += 1
        return ref

    def insert(self, digest: bytes, pod_ref: str) -> None:
        self.insert_many(((digest, pod_ref),))

    def insert_many(self, pairs: Iterable[Tuple[bytes, str]]) -> None:
        """Enter each (digest, pod reference) in order: a digest already
        entered takes the new reference in place; a new one first evicts
        the last one entered (LIFO) while the thesaurus is full."""
        if self.max_entries == 0:
            return
        entries, stack = self._map, self._stack
        for digest, pod_ref in pairs:
            if digest not in entries:
                while len(entries) >= self.max_entries and stack:
                    entries.pop(stack.pop(), None)        # LIFO
                stack.append(digest)
            entries[digest] = pod_ref

    def prune(self, dead_refs) -> int:
        """Drop every entry whose pod reference is in `dead_refs`.

        Must be called after GC deletes pods: a stale entry would make the
        next save skip writing a pod whose bytes no longer exist, leaving
        the new manifest pointing at nothing.  Returns entries removed.
        """
        dead_set = set(dead_refs)
        dead = {d for d, ref in self._map.items() if ref in dead_set}
        for d in dead:
            del self._map[d]
        if dead:
            self._stack = [d for d in self._stack if d not in dead]
        return len(dead)

    def stats(self) -> Tuple[int, int]:
        return self.hits, self.misses
