"""Virtual memo space (paper §4.1, Eq. 1).

Within-pod references use the original natural-number memo IDs (the local
serialization order of nodes inside a pod).  Cross-pod references use the
*global* memo ID plus 2^31.  Each pod allocates page(s) of B global memo IDs
in the range [δ_i, δ_i + B) as needed; the page offsets {δ_i} are persisted
as pod metadata so that, given a virtual memo ID, the referenced object can
be recovered by Eq. (1):

    m_global(m_virtual) = δ_i + r           if m_virtual <  2^31
                        = m_virtual - 2^31  if m_virtual >= 2^31
    where i = m_virtual // B and r = m_virtual % B.

Memo-local preservation: locals are handed out in pod admit order and
pages in global allocation order, both pure functions of the graph
structure and the (memoized) podding decisions.  The incremental save
path therefore reuses the entire GlobalMemoSpace of the previous save
whenever the graph structure is unchanged — untouched pods keep their
locals and page offsets bit-for-bit, which is what keeps synonym digests
stable across delta saves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

CROSS_POD_OFFSET = 1 << 31


@dataclasses.dataclass
class PodMemo:
    """Per-pod view of the memo space: local ids + allocated pages."""

    pod_id: int
    pages: List[int] = dataclasses.field(default_factory=list)  # {δ_i}
    count: int = 0  # number of local memo ids handed out


class GlobalMemoSpace:
    """Allocates B-aligned pages of global memo IDs to pods."""

    def __init__(self, page_size: int = 1024):
        self.B = int(page_size)
        self._next_page = 0
        self._page_owner: Dict[int, Tuple[int, int]] = {}  # δ -> (pod_id, page_idx)
        self.pods: Dict[int, PodMemo] = {}

    def pod(self, pod_id: int) -> PodMemo:
        if pod_id not in self.pods:
            self.pods[pod_id] = PodMemo(pod_id=pod_id)
        return self.pods[pod_id]

    def _alloc_page(self, pod_id: int) -> int:
        delta = self._next_page * self.B
        self._next_page += 1
        pm = self.pod(pod_id)
        self._page_owner[delta] = (pod_id, len(pm.pages))
        pm.pages.append(delta)
        return delta

    def new_local(self, pod_id: int) -> int:
        """Hand out the next local (natural-number) memo id for a pod,
        allocating a fresh global page when the local id crosses a page
        boundary."""
        pm = self.pod(pod_id)
        m_local = pm.count
        pm.count += 1
        page_idx = m_local // self.B
        while len(pm.pages) <= page_idx:
            self._alloc_page(pod_id)
        return m_local

    def global_of_local(self, pod_id: int, m_local: int) -> int:
        """m_global = δ_i + r  for a within-pod (natural) memo id."""
        pm = self.pod(pod_id)
        i, r = divmod(m_local, self.B)
        return pm.pages[i] + r

    def virtual_for_ref(self, src_pod: int, dst_pod: int, dst_local: int) -> int:
        """Virtual memo id used when pod `src_pod` references a node that
        lives at `dst_local` inside `dst_pod`."""
        if src_pod == dst_pod:
            return dst_local
        return self.global_of_local(dst_pod, dst_local) + CROSS_POD_OFFSET

    def resolve(self, ctx_pod: int, m_virtual: int) -> Tuple[int, int]:
        """Eq. (1): virtual memo id -> (pod_id, local index)."""
        if m_virtual < CROSS_POD_OFFSET:
            # within-pod reference: the natural-number memo id itself
            return (ctx_pod, m_virtual)
        g = m_virtual - CROSS_POD_OFFSET
        delta = (g // self.B) * self.B
        owner, page_idx = self._page_owner[delta]
        return (owner, page_idx * self.B + (g - delta))

    # -- persistence ------------------------------------------------------
    def page_tables(self) -> Dict[int, List[int]]:
        return {pid: list(pm.pages) for pid, pm in self.pods.items()}

    @classmethod
    def from_page_tables(cls, tables: Dict[int, List[int]], page_size: int = 1024
                         ) -> "GlobalMemoSpace":
        ms = cls(page_size=page_size)
        max_page = -1
        for pid, pages in tables.items():
            pm = ms.pod(int(pid))
            for idx, delta in enumerate(pages):
                pm.pages.append(int(delta))
                ms._page_owner[int(delta)] = (int(pid), idx)
                max_page = max(max_page, int(delta) // ms.B)
        ms._next_page = max_page + 1
        return ms
