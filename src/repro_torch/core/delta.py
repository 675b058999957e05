"""Chunk-granular pod deltas and the store/recreate cost model.

A pod blob is a canonical msgpack document ``{"pid": int, "e": [entry,
...]}`` (see :func:`repro.core.podding.serialize_pod`); entry order is
local-id order.  When an incremental save reuses the previous
``PodAssignment``, the ``ChangeDetector`` dirty mask tells us *exactly*
which entries of a touched pod differ from its parent-commit pod: only
CHUNK entries whose key is in the dirty set and SCALAR entries whose key
is in ``scalar_changed_keys`` can have changed — every other entry is
byte-identical.  A **pod delta** records just those patched entries,
keyed by local index, against the parent pod's digest:

    {"b": <base digest hex>, "pid": <pod id>, "n": <entry count>,
     "p": {<local index>: <full entry dict>, ...}}

Applying a delta unpacks the base blob, replaces the patched entries,
and re-packs ``{"pid", "e"}`` in the same key order `serialize_pod`
uses — msgpack packing is canonical for the value types involved, so
the reconstruction is *bit-identical* to what `serialize_pod` would
have produced (the reconstructed bytes hash to the delta pod's own
digest; `version/fsck.py` deep mode verifies exactly this).

Whether a pod is worth storing as a delta is the classic
storage/recreation tradeoff (Bhattacherjee et al.; "To Store or Not to
Store"): a delta saves bytes but every read must walk the chain back to
a whole base.  :class:`DeltaPolicy` bounds the chain depth and charges
an expected recreation cost per link, so hot shallow chains are
admitted and long or fat deltas fall back to whole-pod storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import msgpack

#: Hard ceiling on any chain walk, independent of policy — a cycle or a
#: pathological store must terminate with an error, not hang.
MAX_WALK = 64


def encode_pod_delta(new_blob: bytes, base_digest_hex: str,
                     changed_locals: List[int]) -> bytes:
    """Encode `new_blob` as a delta against the pod named by
    `base_digest_hex`, patching only the entries at `changed_locals`.

    Soundness is the caller's burden: every entry of `new_blob` *not*
    listed in `changed_locals` must be byte-identical to the base pod's
    entry at the same local index (guaranteed by assignment reuse + the
    detector mask on the save path).
    """
    doc = msgpack.unpackb(new_blob, raw=False, strict_map_key=False)
    entries = doc["e"]
    patch = {int(i): entries[int(i)] for i in changed_locals}
    return msgpack.packb(
        {"b": base_digest_hex, "pid": doc["pid"], "n": len(entries),
         "p": patch},
        use_bin_type=True)


def parse_delta(blob: bytes) -> Tuple[str, Dict[str, Any]]:
    """Unpack a delta blob; returns (base digest hex, payload dict).

    Raises ValueError if the blob is not a structurally valid delta
    document (fsck maps that to "corrupt").
    """
    doc = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    if not isinstance(doc, dict) or "b" not in doc or "p" not in doc \
            or "n" not in doc:
        raise ValueError("not a pod delta document")
    return doc["b"], doc


def apply_pod_delta(payload: Dict[str, Any], base_blob: bytes) -> bytes:
    """Reconstruct the full pod blob from a parsed delta `payload` and
    the fully-materialized `base_blob` it patches.

    The result is bit-identical to the `serialize_pod` output the delta
    was encoded from (same msgpack packing, same ``{"pid", "e"}`` key
    order).  Raises ValueError on a structural mismatch between payload
    and base (fsck maps that to a broken chain).
    """
    base = msgpack.unpackb(base_blob, raw=False, strict_map_key=False)
    entries = list(base["e"])
    if len(entries) != payload["n"]:
        raise ValueError(
            "chain structure mismatch: base has %d entries, delta expects %d"
            % (len(entries), payload["n"]))
    for idx, entry in payload["p"].items():
        i = int(idx)
        if not 0 <= i < len(entries):
            raise ValueError("chain structure mismatch: patch index %d" % i)
        entries[i] = entry
    return msgpack.packb({"pid": payload["pid"], "e": entries},
                         use_bin_type=True)


@dataclasses.dataclass
class DeltaPolicy:
    """Per-pod materialize-vs-delta decision under bounded recreation.

    A delta at chain depth ``d`` (its base sits at depth ``d-1``; a
    whole pod is depth 0) is admitted iff

        d <= max_chain_depth   and
        delta_bytes + recreation_weight * d * whole_bytes
            <= max_delta_ratio * whole_bytes

    i.e. the stored bytes plus an expected-recreation charge per chain
    link must beat storing the pod whole by at least the ratio margin.
    `recreation_weight` is the estimated cost (in whole-pod-byte units)
    of reading + patching one link at checkout time.
    """
    max_chain_depth: int = 4
    max_delta_ratio: float = 0.5
    recreation_weight: float = 0.05

    def admit(self, delta_bytes: int, whole_bytes: int, depth: int) -> bool:
        if depth > self.max_chain_depth:
            return False
        if whole_bytes <= 0:
            return False
        cost = delta_bytes + self.recreation_weight * depth * whole_bytes
        return cost <= self.max_delta_ratio * whole_bytes
