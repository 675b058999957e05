"""Underlying storage: content-addressed pod store + manifests.

Pods are written once per unique digest (synonymous pods point at the same
object — the synonym resolver of §4.2 realized as content addressing), with
optional zstd compression (the paper's §8.3 LZ4 analog).  Manifests record,
per TimeID: the pod table (pod id → digest, page table, parent), the root
pod, per-save statistics, and the parent TimeID (branching/versioning).

Two backends share one interface: a filesystem store (production path) and
an in-memory store (benchmarks measure logical bytes without disk noise).
Both support enumeration (`list_pods`, `list_time_ids`) and deletion
(`delete_pod`, `delete_manifest`) — the substrate of mark-and-sweep GC
(version/gc.py) — plus small named metadata blobs (`put_meta`/`get_meta`)
used by the version manager to persist branch refs, tags, and HEAD.

Crash consistency
-----------------
Every write on the file backend is tmp + `os.replace`, so a crash leaves
an object either fully present or fully absent — never truncated — plus
at most one orphan ``.tmp`` file (debris that `sweep_tmp` / fsck removes).
The metadata blobs additionally support `compare_and_put_meta`, an atomic
compare-and-swap keyed on the blob's previous bytes: the primitive the
commit DAG uses to advance refs so a concurrent writer or a GC sweeper
can never silently clobber them (see version/commit_graph.py and
version/fsck.py for the full commit protocol: pods → manifest → refs).
``FileStore(fsync=True)`` upgrades atomicity to durability: file contents
and the containing directory entry are fsynced before the rename is
considered landed (slower; for stores that must survive power loss, not
just process death).

Delta-chain pod storage
-----------------------
A pod digest may be backed by one of two *physical forms*: a **whole**
blob (the canonical `serialize_pod` bytes, possibly compressed) or a
**delta** blob (`core/delta.py`: patched entries against a parent pod's
digest).  The digest always names the *full* content — `get_pod`
resolves the form transparently, walking the delta chain back to a
whole base and replaying patches, so every reader above the store sees
bit-identical bytes either way (digest equality ⇒ byte equality is
preserved; that invariant is what dedup, the thesaurus, and delta-aware
checkout already rely on).  The contract:

  * `put_pod_delta(digest, delta_blob)` stores the delta form; dedups
    against *either* existing form.  The caller guarantees the delta's
    base digest is present in the store and that applying the delta to
    the base reproduces exactly the bytes `digest` names (the save path
    derives the patch set from the detector's dirty mask, which proves
    every unpatched entry byte-identical).  The commit's manifest
    records the link as ``pods[pid]["delta_of"] = base_digest`` so
    readers of the manifest alone can see chain structure.
  * Chain depth is bounded by the writer's `DeltaPolicy.max_chain_depth`
    (enforced at encode time via `pod_chain_depth`); the store itself
    only enforces the hard `MAX_WALK` cycle guard.
  * If *both* forms exist, the whole form wins (reads, `pod_nbytes`,
    `pod_base`).  That state is the legal crash window of
    `rematerialize_pod`, which writes the whole form FIRST and only
    then deletes the delta form — a crash between the two leaves a
    readable pod plus redundant delta debris that fsck clears.
  * GC ordering: before sweeping a dead base, every live descendant is
    re-materialized (whole form written from the still-complete chain);
    only then are dead pods deleted (version/gc.py).  Dry-run reports
    reclaim net of the re-materialization bytes it *would* write.
  * `delete_pod` removes both forms and frees their summed bytes;
    `list_pods` enumerates the union; `pod_nbytes` is the physical
    stored size of the winning form.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Dict, Iterable, List, Optional

import msgpack

from .delta import MAX_WALK, apply_pod_delta, parse_delta

try:
    import zstandard as zstd
except Exception:  # pragma: no cover
    zstd = None

#: 1-byte codec tags prefixed to compressed pod blobs so a store written
#: with one codec reads back under another (zstd preferred, stdlib zlib
#: fallback — compress=True must always compress).
_CODEC_ZSTD = b"\x01"
_CODEC_ZLIB = b"\x02"


class StoreStats:
    def __init__(self) -> None:
        self.pod_bytes_written = 0
        self.pods_written = 0
        self.pods_deduped = 0
        self.manifest_bytes = 0
        self.reads = 0
        self.read_bytes = 0
        self.codec = ""               # codec used by the last compressed put
        # deletion counters (mark-and-sweep GC)
        self.pods_deleted = 0
        self.pod_bytes_deleted = 0
        self.manifests_deleted = 0
        self.manifest_bytes_deleted = 0
        # meta CAS counters (refs commit protocol)
        self.meta_cas_ok = 0
        self.meta_cas_conflicts = 0
        # stale CAS lockfiles broken (dead-pid / aged-out; file backend)
        self.meta_locks_broken = 0
        # delta-chain pod storage
        self.delta_pods_written = 0   # pods stored as deltas
        self.delta_bytes_written = 0  # stored bytes of those deltas
        self.chain_reads = 0          # get_pod calls that walked a chain
        self.pods_rematerialized = 0  # delta pods rewritten whole (GC/fsck)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class BaseStore:
    compress: bool = False

    def __init__(self) -> None:
        self.stats = StoreStats()
        self._lock = threading.Lock()
        #: delta digest -> base digest, lazily filled on chain walks and
        #: invalidated when the delta form is deleted/re-materialized.
        self._chain_cache: Dict[str, str] = {}

    # -- blob framing (shared by whole and delta forms) --------------------
    def _encode_blob(self, data: bytes) -> bytes:
        if not self.compress:
            return data
        if zstd is not None:
            self.stats.codec = "zstd"
            return _CODEC_ZSTD + zstd.ZstdCompressor(level=3).compress(data)
        self.stats.codec = "zlib"
        return _CODEC_ZLIB + zlib.compress(data, 6)

    def _decode_blob(self, blob: bytes) -> bytes:
        if not self.compress:
            return blob
        tag, body = blob[:1], blob[1:]
        if tag == _CODEC_ZSTD:
            if zstd is None:
                raise RuntimeError(
                    "pod compressed with zstd but zstandard missing")
            return zstd.ZstdDecompressor().decompress(body)
        if tag == _CODEC_ZLIB:
            return zlib.decompress(body)
        raise ValueError(
            f"blob has unknown codec tag {blob[:1]!r} — corrupted blob "
            "or store written without codec tagging")

    # -- raw physical forms (backends) ------------------------------------
    def _has_whole(self, digest_hex: str) -> bool:
        raise NotImplementedError

    def _put_raw(self, digest_hex: str, data: bytes) -> None:
        raise NotImplementedError

    def _get_raw(self, digest_hex: str) -> bytes:
        raise NotImplementedError

    def _delete_raw(self, digest_hex: str) -> None:
        raise NotImplementedError

    def _whole_nbytes(self, digest_hex: str) -> int:
        raise NotImplementedError

    def _list_whole(self) -> List[str]:
        raise NotImplementedError

    def _has_delta(self, digest_hex: str) -> bool:
        raise NotImplementedError

    def _put_delta_raw(self, digest_hex: str, data: bytes) -> None:
        raise NotImplementedError

    def _get_delta_raw(self, digest_hex: str) -> bytes:
        raise NotImplementedError

    def _delete_delta_raw(self, digest_hex: str) -> None:
        raise NotImplementedError

    def _delta_nbytes(self, digest_hex: str) -> int:
        raise NotImplementedError

    # -- pods -------------------------------------------------------------
    def has_pod(self, digest_hex: str) -> bool:
        """True if the digest is readable — stored in either physical
        form (whole blob or delta link)."""
        return self._has_whole(digest_hex) or self._has_delta(digest_hex)

    def list_pods(self) -> List[str]:
        """Enumerate the digest of every pod currently in the store
        (union of whole and delta forms)."""
        return sorted(set(self._list_whole()) | set(self.list_delta_pods()))

    def list_delta_pods(self) -> List[str]:
        """Digests currently stored in delta form."""
        raise NotImplementedError

    def pod_nbytes(self, digest_hex: str) -> int:
        """Stored (possibly compressed) *physical* size of one pod — the
        whole form if present, else the delta form.

        Raises `FileNotFoundError` when the pod is absent: a pod can
        legitimately be empty (0 bytes means a torn write — serialized
        pods are never empty) but never silently missing.  Callers that
        used to rely on 0-on-missing masked torn stores; fsck reports
        missing and empty pods separately (version/fsck.py).
        """
        if self._has_whole(digest_hex):
            return self._whole_nbytes(digest_hex)
        return self._delta_nbytes(digest_hex)

    def delete_pod(self, digest_hex: str) -> int:
        """Remove a pod (both physical forms); returns the number of
        stored bytes freed (0 if the pod was absent).  Used by
        mark-and-sweep GC — callers must only delete digests unreachable
        from every ref, and must re-materialize live delta descendants
        of a doomed base first (see version/gc.py for the crash-safe
        ordering: re-materialize, then manifests, then pods)."""
        with self._lock:
            n = 0
            if self._has_whole(digest_hex):
                n += self._whole_nbytes(digest_hex)
                self._delete_raw(digest_hex)
            if self._has_delta(digest_hex):
                n += self._delta_nbytes(digest_hex)
                self._delete_delta_raw(digest_hex)
            self._chain_cache.pop(digest_hex, None)
            if n == 0:
                return 0
            self.stats.pods_deleted += 1
            self.stats.pod_bytes_deleted += n
            return n

    def put_pod(self, digest_hex: str, data: bytes) -> bool:
        """Write pod bytes (whole form) unless the digest is already
        present in either form.  Returns True if written."""
        with self._lock:
            if self.has_pod(digest_hex):
                self.stats.pods_deduped += 1
                return False
            blob = self._encode_blob(data)
            self._put_raw(digest_hex, blob)
            self.stats.pods_written += 1
            self.stats.pod_bytes_written += len(blob)
            return True

    def put_pod_delta(self, digest_hex: str, delta_blob: bytes) -> bool:
        """Store `digest_hex` in delta form (a `core/delta.py` blob whose
        base must already be present).  Dedups against either existing
        form.  Returns True if written.

        The caller owns the correctness contract: applying the delta
        chain must reproduce exactly the bytes `digest_hex` names, and
        chain depth must respect its `DeltaPolicy` (the store enforces
        only the hard `MAX_WALK` cycle guard on reads)."""
        with self._lock:
            if self.has_pod(digest_hex):
                self.stats.pods_deduped += 1
                return False
            blob = self._encode_blob(delta_blob)
            self._put_delta_raw(digest_hex, blob)
            self.stats.pods_written += 1
            self.stats.pod_bytes_written += len(blob)
            self.stats.delta_pods_written += 1
            self.stats.delta_bytes_written += len(blob)
            return True

    def _resolve_full_locked(self, digest_hex: str):
        """Resolve a digest to its full pod bytes, walking the delta
        chain if needed.  Caller holds `self._lock` (the lock is
        non-reentrant, so the walk never re-enters public methods).
        Returns (data, bytes_read, chain_depth)."""
        payloads = []
        nread = 0
        d = digest_hex
        for _ in range(MAX_WALK):
            if self._has_whole(d):
                blob = self._get_raw(d)
                nread += len(blob)
                data = self._decode_blob(blob)
                for payload in reversed(payloads):
                    data = apply_pod_delta(payload, data)
                return data, nread, len(payloads)
            if not self._has_delta(d):
                if d == digest_hex:
                    raise FileNotFoundError(f"pod {d} not in store")
                raise FileNotFoundError(
                    f"pod {d} not in store (broken delta chain from "
                    f"{digest_hex})")
            raw = self._get_delta_raw(d)
            nread += len(raw)
            base, payload = parse_delta(self._decode_blob(raw))
            self._chain_cache[d] = base
            payloads.append(payload)
            d = base
        raise ValueError(
            f"delta chain from {digest_hex} exceeds MAX_WALK={MAX_WALK} "
            "links — cycle or pathological store")

    def get_pod(self, digest_hex: str) -> bytes:
        with self._lock:
            data, nread, depth = self._resolve_full_locked(digest_hex)
            self.stats.reads += 1
            self.stats.read_bytes += nread
            if depth:
                self.stats.chain_reads += 1
        return data

    # -- delta-chain metadata ---------------------------------------------
    def _pod_base_locked(self, digest_hex: str) -> Optional[str]:
        if self._has_whole(digest_hex) or not self._has_delta(digest_hex):
            return None
        base = self._chain_cache.get(digest_hex)
        if base is None:
            blob = self._decode_blob(self._get_delta_raw(digest_hex))
            base, _ = parse_delta(blob)
            self._chain_cache[digest_hex] = base
        return base

    def pod_base(self, digest_hex: str) -> Optional[str]:
        """The base digest this pod's stored delta patches, or None when
        the pod is stored whole / absent (whole form wins when both
        physical forms exist)."""
        with self._lock:
            return self._pod_base_locked(digest_hex)

    def pod_chain(self, digest_hex: str) -> List[str]:
        """Digests from `digest_hex` back to (and including) its
        whole-stored base; ``[digest_hex]`` for a pod stored whole.
        Raises FileNotFoundError on a missing link (broken chain) and
        ValueError past the `MAX_WALK` cycle guard."""
        with self._lock:
            out: List[str] = []
            d = digest_hex
            for _ in range(MAX_WALK):
                out.append(d)
                if self._has_whole(d):
                    return out
                if not self._has_delta(d):
                    raise FileNotFoundError(
                        f"pod {d} not in store (delta chain from "
                        f"{digest_hex})")
                d = self._pod_base_locked(d)
            raise ValueError(
                f"delta chain from {digest_hex} exceeds MAX_WALK="
                f"{MAX_WALK} links — cycle or pathological store")

    def pod_chain_depth(self, digest_hex: str) -> int:
        """Number of delta links between `digest_hex` and its whole base
        (0 for a pod stored whole)."""
        return len(self.pod_chain(digest_hex)) - 1

    def pod_whole_nbytes(self, digest_hex: str) -> int:
        """Stored size this pod WOULD occupy as a whole blob — the
        actual size if already whole, else the encoded size of the
        chain-resolved bytes.  GC dry-run uses this so its
        re-materialization estimate equals the real sweep's writes."""
        with self._lock:
            if self._has_whole(digest_hex):
                return self._whole_nbytes(digest_hex)
            data, _, _ = self._resolve_full_locked(digest_hex)
        return len(self._encode_blob(data))

    def drop_whole_form(self, digest_hex: str) -> bool:
        """Remove a pod's whole form when a delta form also exists —
        fsck's repair for a torn re-materialization, where a truncated
        whole blob shadows a still-valid delta chain.  Returns True if
        dropped.  Refuses (False) when only one form exists: deleting
        the sole copy is `delete_pod`'s job, never a repair."""
        with self._lock:
            if not (self._has_whole(digest_hex)
                    and self._has_delta(digest_hex)):
                return False
            n = self._whole_nbytes(digest_hex)
            self._delete_raw(digest_hex)
            self.stats.pod_bytes_deleted += n
            return True

    def rematerialize_pod(self, digest_hex: str) -> int:
        """Rewrite a delta-stored pod as a whole blob; returns the bytes
        written (0 if the pod was already whole).

        Crash-safe ordering: the whole form is written FIRST, then the
        delta form is deleted — a crash between the two leaves both
        forms, and reads prefer the whole form; fsck clears the
        redundant delta.  Byte accounting flows through
        `pod_bytes_written`/`pod_bytes_deleted` so `total_bytes()`
        reflects the swap."""
        with self._lock:
            if self._has_whole(digest_hex):
                if self._has_delta(digest_hex):
                    nd = self._delta_nbytes(digest_hex)
                    self._delete_delta_raw(digest_hex)
                    self._chain_cache.pop(digest_hex, None)
                    self.stats.pod_bytes_deleted += nd
                return 0
            data, _, _ = self._resolve_full_locked(digest_hex)
            blob = self._encode_blob(data)
            self._put_raw(digest_hex, blob)
            self.stats.pod_bytes_written += len(blob)
            nd = self._delta_nbytes(digest_hex)
            self._delete_delta_raw(digest_hex)
            self._chain_cache.pop(digest_hex, None)
            self.stats.pod_bytes_deleted += nd
            self.stats.pods_rematerialized += 1
            return len(blob)

    # -- manifests ----------------------------------------------------------
    def _put_manifest_raw(self, time_id: int, blob: bytes) -> None:
        raise NotImplementedError

    def _get_manifest_raw(self, time_id: int) -> bytes:
        raise NotImplementedError

    def put_manifest(self, time_id: int, manifest: Dict[str, Any]) -> None:
        blob = msgpack.packb(manifest, use_bin_type=True)
        with self._lock:
            self._put_manifest_raw(time_id, blob)
            self.stats.manifest_bytes += len(blob)

    def get_manifest(self, time_id: int) -> Dict[str, Any]:
        return msgpack.unpackb(self._get_manifest_raw(time_id), raw=False,
                               strict_map_key=False)

    def list_time_ids(self) -> List[int]:
        raise NotImplementedError

    def manifest_nbytes(self, time_id: int) -> int:
        """Stored size of one manifest; raises `FileNotFoundError` when
        absent (same missing-vs-empty contract as `pod_nbytes`)."""
        raise NotImplementedError

    def delete_manifest(self, time_id: int) -> int:
        """Remove a manifest; returns bytes freed (0 if absent)."""
        raise NotImplementedError

    # -- small metadata blobs (branch refs, tags, HEAD) ---------------------
    def put_meta(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_meta(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def compare_and_put_meta(self, key: str, expected_old: Optional[bytes],
                             new: bytes) -> bool:
        """Atomic compare-and-swap on a metadata blob.

        Writes `new` iff the blob currently stored under `key` is
        byte-identical to `expected_old` (`None` = the key must not exist
        yet).  Returns True on success, False on conflict — the caller
        must re-read, rebase its change, and retry (version/commit_graph
        does exactly that for refs).  This is the primitive that makes
        refs safe against concurrent writers and GC sweepers, and the
        prerequisite for the multi-host coordinator commit (ROADMAP).
        """
        raise NotImplementedError

    # -- transaction debris -------------------------------------------------
    def sweep_tmp(self) -> int:
        """Remove write-transaction debris (orphan ``.tmp`` / stale
        ``.lock`` files left by a crash mid-write).  Returns the number of
        files removed; backends without such debris return 0.  Safe only
        when no writer is concurrently active (fsck's contract)."""
        return 0

    def head(self) -> Optional[int]:
        """The backend's legacy HEAD pointer, if it keeps one (newest
        TimeID written); None for backends without one."""
        return None

    def repair_head(self) -> bool:
        """Rebuild the backend's legacy HEAD pointer (if it keeps one)
        from the manifests actually present; True if anything changed."""
        return False

    def total_bytes(self) -> int:
        """Current logical footprint: bytes written minus bytes reclaimed."""
        return (self.stats.pod_bytes_written + self.stats.manifest_bytes
                - self.stats.pod_bytes_deleted
                - self.stats.manifest_bytes_deleted)


class MemoryStore(BaseStore):
    def __init__(self, compress: bool = False) -> None:
        super().__init__()
        self.compress = compress
        self._pods: Dict[str, bytes] = {}
        self._delta_pods: Dict[str, bytes] = {}
        self._manifests: Dict[int, bytes] = {}
        self._meta: Dict[str, bytes] = {}
        self._meta_lock = threading.Lock()

    def _has_whole(self, digest_hex: str) -> bool:
        return digest_hex in self._pods

    def _put_raw(self, digest_hex: str, data: bytes) -> None:
        self._pods[digest_hex] = data

    def _get_raw(self, digest_hex: str) -> bytes:
        return self._pods[digest_hex]

    def _list_whole(self) -> List[str]:
        return sorted(self._pods)

    def _whole_nbytes(self, digest_hex: str) -> int:
        blob = self._pods.get(digest_hex)
        if blob is None:
            raise FileNotFoundError(f"pod {digest_hex} not in store")
        return len(blob)

    def _delete_raw(self, digest_hex: str) -> None:
        del self._pods[digest_hex]

    def _has_delta(self, digest_hex: str) -> bool:
        return digest_hex in self._delta_pods

    def _put_delta_raw(self, digest_hex: str, data: bytes) -> None:
        self._delta_pods[digest_hex] = data

    def _get_delta_raw(self, digest_hex: str) -> bytes:
        return self._delta_pods[digest_hex]

    def _delete_delta_raw(self, digest_hex: str) -> None:
        del self._delta_pods[digest_hex]

    def _delta_nbytes(self, digest_hex: str) -> int:
        blob = self._delta_pods.get(digest_hex)
        if blob is None:
            raise FileNotFoundError(f"pod {digest_hex} not in store")
        return len(blob)

    def list_delta_pods(self) -> List[str]:
        return sorted(self._delta_pods)

    def _put_manifest_raw(self, time_id: int, blob: bytes) -> None:
        self._manifests[time_id] = blob

    def _get_manifest_raw(self, time_id: int) -> bytes:
        return self._manifests[time_id]

    def manifest_nbytes(self, time_id: int) -> int:
        blob = self._manifests.get(time_id)
        if blob is None:
            raise FileNotFoundError(f"manifest {time_id} not in store")
        return len(blob)

    def delete_manifest(self, time_id: int) -> int:
        blob = self._manifests.pop(time_id, None)
        if blob is None:
            return 0
        self.stats.manifests_deleted += 1
        self.stats.manifest_bytes_deleted += len(blob)
        return len(blob)

    def put_meta(self, key: str, data: bytes) -> None:
        with self._meta_lock:
            self._meta[key] = data

    def get_meta(self, key: str) -> Optional[bytes]:
        return self._meta.get(key)

    def compare_and_put_meta(self, key: str, expected_old: Optional[bytes],
                             new: bytes) -> bool:
        with self._meta_lock:
            if self._meta.get(key) != expected_old:
                self.stats.meta_cas_conflicts += 1
                return False
            self._meta[key] = new
            self.stats.meta_cas_ok += 1
            return True

    def list_time_ids(self) -> List[int]:
        return sorted(self._manifests)


class FileStore(BaseStore):
    """store_dir/pods/<d0d1>/<digest>.pod  +  store_dir/manifests/<tid>.mp

    With ``fsync=True`` every atomic write also fsyncs the file contents
    and the containing directory before it counts as landed (durability
    against power loss, not just process death).  `compare_and_put_meta`
    serializes cross-process via an O_EXCL ``.lock`` file next to the
    blob.  Each lock records ``"<pid> <wall time>"`` so a lock abandoned
    by a crashed process is *detected*, not waited out: a contender that
    finds the recorded pid dead (same-host check via ``kill(pid, 0)``),
    the lock older than ``STALE_LOCK_AGE_S``, or the content unparseable
    (a legacy/torn lock with no provable owner) breaks it safely —
    `os.replace` to a unique trash name, so exactly one breaker wins
    even when several race — and retries the O_EXCL create.  A *live*
    peer's lock is honored up to ``LOCK_TIMEOUT_S``.  `sweep_tmp` (and
    therefore fsck) applies the same staleness test, so it can run
    while writers are active without breaking their critical sections.
    """

    #: how long compare_and_put_meta spins on another LIVE process's
    #: lock before giving up (the critical section is microseconds; a
    #: live holder stuck this long is pathological).
    LOCK_TIMEOUT_S = 5.0
    #: a lock older than this is stale even if its owner pid is alive
    #: (the pid may have been recycled, or the owner hung mid-CAS).
    STALE_LOCK_AGE_S = 5.0

    def __init__(self, root: str, compress: bool = False,
                 fsync: bool = False) -> None:
        super().__init__()
        self.root = root
        self.compress = compress
        self.fsync = fsync
        os.makedirs(os.path.join(root, "pods"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
        os.makedirs(os.path.join(root, "meta"), exist_ok=True)

    # -- atomic write primitive -------------------------------------------
    def _write_atomic(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: crash-safe (fault tolerance)
        if self.fsync:
            dfd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _pod_path(self, digest_hex: str) -> str:
        d = os.path.join(self.root, "pods", digest_hex[:2])
        return os.path.join(d, digest_hex + ".pod")

    def _delta_path(self, digest_hex: str) -> str:
        # delta form lives beside the whole form in the same shard dir;
        # ".dpod" does not match the "*.pod" suffix test, so each listing
        # sees only its own physical form.
        d = os.path.join(self.root, "pods", digest_hex[:2])
        return os.path.join(d, digest_hex + ".dpod")

    def _has_whole(self, digest_hex: str) -> bool:
        return os.path.exists(self._pod_path(digest_hex))

    def _put_raw(self, digest_hex: str, data: bytes) -> None:
        path = self._pod_path(digest_hex)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._write_atomic(path, data)

    def _get_raw(self, digest_hex: str) -> bytes:
        with open(self._pod_path(digest_hex), "rb") as f:
            return f.read()

    def _list_suffix(self, suffix: str) -> List[str]:
        out: List[str] = []
        pods_dir = os.path.join(self.root, "pods")
        for shard in sorted(os.listdir(pods_dir)):
            sd = os.path.join(pods_dir, shard)
            if not os.path.isdir(sd):
                continue
            for fn in sorted(os.listdir(sd)):
                if fn.endswith(suffix):
                    out.append(fn[:-len(suffix)])
        return out

    def _list_whole(self) -> List[str]:
        return self._list_suffix(".pod")

    def _whole_nbytes(self, digest_hex: str) -> int:
        return os.path.getsize(self._pod_path(digest_hex))

    def _delete_raw(self, digest_hex: str) -> None:
        # single unlink: atomic at the filesystem level, so a crash either
        # leaves the pod intact or fully gone — never truncated (the same
        # guarantee os.replace gives the write path).  Empty shard dirs are
        # left behind deliberately: removing them could race a concurrent
        # _put_raw's makedirs.
        os.remove(self._pod_path(digest_hex))

    def _has_delta(self, digest_hex: str) -> bool:
        return os.path.exists(self._delta_path(digest_hex))

    def _put_delta_raw(self, digest_hex: str, data: bytes) -> None:
        path = self._delta_path(digest_hex)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._write_atomic(path, data)

    def _get_delta_raw(self, digest_hex: str) -> bytes:
        with open(self._delta_path(digest_hex), "rb") as f:
            return f.read()

    def _delete_delta_raw(self, digest_hex: str) -> None:
        os.remove(self._delta_path(digest_hex))

    def _delta_nbytes(self, digest_hex: str) -> int:
        return os.path.getsize(self._delta_path(digest_hex))

    def list_delta_pods(self) -> List[str]:
        return self._list_suffix(".dpod")

    def _manifest_path(self, time_id: int) -> str:
        return os.path.join(self.root, "manifests", f"{time_id:08d}.mp")

    def _head_path(self) -> str:
        return os.path.join(self.root, "HEAD")

    def _put_manifest_raw(self, time_id: int, blob: bytes) -> None:
        self._write_atomic(self._manifest_path(time_id), blob)
        # legacy HEAD file rides the same atomic-rename discipline: a
        # crash between the two writes leaves HEAD one commit behind,
        # never torn (head() tolerates both staleness and corruption).
        self._write_atomic(self._head_path(), str(time_id).encode())

    def _get_manifest_raw(self, time_id: int) -> bytes:
        with open(self._manifest_path(time_id), "rb") as f:
            return f.read()

    def manifest_nbytes(self, time_id: int) -> int:
        return os.path.getsize(self._manifest_path(time_id))

    def delete_manifest(self, time_id: int) -> int:
        path = self._manifest_path(time_id)
        try:
            n = os.path.getsize(path)
            os.remove(path)
        except FileNotFoundError:
            return 0
        self.stats.manifests_deleted += 1
        self.stats.manifest_bytes_deleted += n
        return n

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.root, "meta", key + ".mp")

    def put_meta(self, key: str, data: bytes) -> None:
        self._write_atomic(self._meta_path(key), data)

    # -- stale-lock detection ---------------------------------------------
    @staticmethod
    def _pid_alive(pid: int) -> bool:
        """Same-host liveness probe: signal 0 never delivers, only
        checks.  PermissionError means the pid exists under another
        uid — alive."""
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except (PermissionError, OSError):
            return True
        return True

    def _lock_is_stale(self, lock_path: str) -> bool:
        """True if the lock's recorded owner is provably dead, the lock
        has aged out, or the content is unparseable (legacy empty locks,
        torn writes — no provable owner means no one to honor)."""
        try:
            with open(lock_path) as f:
                pid_s, ts_s = f.read().split()
            pid, ts = int(pid_s), float(ts_s)
        except FileNotFoundError:
            return False              # gone already: nothing to break
        except (OSError, ValueError):
            # unparseable — usually EMPTY: either a torn/legacy lock, or
            # a live peer caught between its O_EXCL create and the
            # owner-stamp write.  Only age can tell those apart, so the
            # lock is honored until its mtime ages out.
            try:
                age = time.time() - os.path.getmtime(lock_path)
            except OSError:
                return False
            return age > self.STALE_LOCK_AGE_S
        if not self._pid_alive(pid):
            return True
        return (time.time() - ts) > self.STALE_LOCK_AGE_S

    def _break_lock(self, lock_path: str) -> bool:
        """Steal a stale lock atomically: rename to a unique trash name
        first, so when several contenders break the same lock exactly
        one `os.replace` wins and no one ever unlinks a FRESH lock a
        peer just created at the original path."""
        trash = f"{lock_path}.stale-{os.getpid()}-{time.monotonic_ns()}"
        try:
            os.replace(lock_path, trash)
        except FileNotFoundError:
            return False                  # someone else broke it first
        try:
            os.remove(trash)
        except FileNotFoundError:  # pragma: no cover - nothing shares trash
            pass
        self.stats.meta_locks_broken += 1
        return True

    def compare_and_put_meta(self, key: str, expected_old: Optional[bytes],
                             new: bytes) -> bool:
        lock_path = self._meta_path(key) + ".lock"
        deadline = time.monotonic() + self.LOCK_TIMEOUT_S
        while True:
            try:
                fd = os.open(lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                # record ownership so a crash here leaves a lock peers
                # can prove stale (pid liveness) instead of waiting out
                os.write(fd, f"{os.getpid()} {time.time():.6f}".encode())
                break
            except FileExistsError:
                if self._lock_is_stale(lock_path):
                    self._break_lock(lock_path)
                    continue              # retry the O_EXCL create now
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"meta lock {lock_path} held past "
                        f"{self.LOCK_TIMEOUT_S}s by a live process — "
                        "a peer hung mid-CAS?  (Dead-owner and aged "
                        "locks are broken automatically; fsck sweeps "
                        "stale .lock debris too.)")
                time.sleep(0.002)
        try:
            if self.get_meta(key) != expected_old:
                self.stats.meta_cas_conflicts += 1
                return False
            self._write_atomic(self._meta_path(key), new)
            self.stats.meta_cas_ok += 1
            return True
        finally:
            os.close(fd)
            try:
                os.unlink(lock_path)
            except FileNotFoundError:
                # a peer (wrongly, but per policy) aged this lock out and
                # broke it mid-section — the CAS result above still
                # stands; crashing the holder here would only add damage.
                pass

    def get_meta(self, key: str) -> Optional[bytes]:
        try:
            with open(self._meta_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def head(self) -> Optional[int]:
        """Legacy HEAD pointer: newest TimeID written by `put_manifest`.

        Tolerates a corrupt/empty HEAD file (a torn write from a
        pre-atomic-HEAD writer, or bitrot) by falling back to the newest
        manifest actually on disk — the same value an intact HEAD would
        carry at worst one commit later.
        """
        try:
            with open(self._head_path()) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return None
        except (ValueError, OSError):
            tids = self.list_time_ids()
            return tids[-1] if tids else None

    def repair_head(self) -> bool:
        tids = self.list_time_ids()
        want = tids[-1] if tids else None
        try:
            with open(self._head_path()) as f:
                have: Optional[int] = int(f.read().strip())
        except FileNotFoundError:
            have = None
        except (ValueError, OSError):
            have = -1  # corrupt: always rewrite
        if have == want:
            return False
        if want is None:
            try:
                os.remove(self._head_path())
            except FileNotFoundError:
                return False
        else:
            self._write_atomic(self._head_path(), str(want).encode())
        return True

    def sweep_tmp(self) -> int:
        n = 0
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                path = os.path.join(dirpath, fn)
                if fn.endswith(".lock"):
                    # only provably-stale locks: a LIVE writer's CAS
                    # critical section must survive a concurrent fsck
                    # (multi-writer stores run fsck-on-open while peers
                    # are active).
                    if self._lock_is_stale(path) and self._break_lock(path):
                        n += 1
                    continue
                if fn.endswith(".tmp") or ".lock.stale-" in fn:
                    try:
                        os.remove(path)
                        n += 1
                    except FileNotFoundError:
                        pass
        return n

    def list_time_ids(self) -> List[int]:
        out = []
        for fn in os.listdir(os.path.join(self.root, "manifests")):
            if fn.endswith(".mp"):
                out.append(int(fn[:-3]))
        return sorted(out)
