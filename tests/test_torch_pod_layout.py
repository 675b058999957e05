"""Pod blobs filled from the layout an assignment keeps
(`podding.PodLayout`, `pod_blob`) against `serialize_pod` and the
reference package's writer.

Every save goes through the port and the reference in lockstep; after
each one the two stores must be byte-identical (every pod in each
physical form, every manifest less its stats, the meta blobs).  A spy
on the port's `pod_blob` holds every blob filled from a layout to the
bytes `serialize_pod` packs for the same pod, and counts the blobs a
save built and filled, which `n_pods_serialized` and
`n_pods_from_layout` must equal.  Tolerance zero.
"""
import msgpack
import numpy as np
import pytest

from repro.core import BundleAll as RefBundleAll
from repro.core import Chipmink as RefChipmink
from repro.core import DeltaPolicy as RefDeltaPolicy
from repro.core import FileStore as RefFileStore
from repro.core import MemoryStore as RefMemoryStore
from repro_torch.core import (BundleAll, Chipmink, DeltaPolicy, FileStore,
                              MemoryStore)
from repro_torch.core import checkpoint, podding
from repro_torch.core.graph import SCALAR

from proptest import base_state
from test_torch_checkpoint import assert_loaded_equal, to_jax, to_torch
from test_torch_version import (assert_stores_equal,  # noqa: F401
                                reference_stats_block_as_the_port)

pytestmark = pytest.mark.usefixtures("reference_stats_block_as_the_port")

CHUNK = 1 << 12


class BlobSpy:
    """Wraps the port's `pod_blob`: checks each blob filled from a layout
    against `serialize_pod`, and counts per save."""

    def __init__(self, monkeypatch):
        self.built = self.from_layout = self.scalar_pods = 0
        real = podding.pod_blob

        def spy(pod, graph, asg, chunk_bytes):
            had = pod.pod_id in (asg.blob_layout or {})
            data, kept = real(pod, graph, asg, chunk_bytes)
            # a layout laid out by an earlier save is used (no chunk here
            # is of another length than its header)
            assert kept == (had and asg.blob_layout[pod.pod_id] is not None)
            want = podding.serialize_pod(pod, graph, asg,
                                         lambda n: chunk_bytes[n.key])
            assert data == want, pod.pod_id
            if any(graph.node(nid).kind == SCALAR for nid in pod.node_ids):
                # a scalar's value changes while the assignment is reused
                assert not kept and asg.blob_layout[pod.pod_id] is None
                self.scalar_pods += 1
            self.built += 1
            self.from_layout += kept
            return data, kept

        monkeypatch.setattr(checkpoint, "pod_blob", spy)

    def take(self):
        out = self.built, self.from_layout
        self.built = self.from_layout = 0
        return out


def pair(ref_store=None, port_store=None, bundle=False, chunk=CHUNK, **kw):
    ref_kw, port_kw = dict(kw), dict(kw)
    if bundle:
        ref_kw["policy"], port_kw["policy"] = RefBundleAll(), BundleAll()
    if kw.get("delta_chains"):
        ref_kw["delta_policy"] = RefDeltaPolicy(max_delta_ratio=0.9)
        port_kw["delta_policy"] = DeltaPolicy(max_delta_ratio=0.9)
    ref = RefChipmink(ref_store or RefMemoryStore(), chunk_bytes=chunk,
                      **ref_kw)
    port = Chipmink(port_store or MemoryStore(), chunk_bytes=chunk,
                    device="cpu", **port_kw)
    return ref, port


def save_both(ref, port, spy, state):
    """One save through both packages; the stores stay byte-identical and
    the counters are what the spy saw.  Returns the port's stats."""
    ref.save(to_jax(state))
    port.save(to_torch(state))
    assert_stores_equal(ref.store, port.store)
    st = port.save_stats[-1]
    built, from_layout = spy.take()
    assert (st["n_pods_serialized"], st["n_pods_from_layout"]) == \
        (built, from_layout)
    # a pod deduplicated by the store was built too
    assert built >= st["pods_written"]
    return st


def short_chunk_state(rng):
    """Leaves whose last chunk is short (6,400 and 2,100 bytes over 4 KiB
    chunks), beside the canonical state's alias and nested containers;
    no scalar."""
    state = base_state(rng, rows=100)
    del state["step"]
    state["params"]["odd"] = rng.standard_normal(525).astype(np.float32)
    return state


def sparse(state, rng, r):
    idx = rng.integers(0, state["params"]["emb"].shape[0], size=2)
    state["params"]["emb"][idx] += np.float32(0.25)
    state["params"]["odd"][-3:] += np.float32(r)
    if "step" in state:
        state["step"] = r


@pytest.mark.parametrize("bundle", [False, True], ids=["lga", "bundle_all"])
@pytest.mark.parametrize("with_scalar", [False, True],
                         ids=["no_scalar", "scalar"])
def test_layout_blobs_equal_serialize_pod_and_the_reference(
        monkeypatch, bundle, with_scalar):
    """Sparse saves on a reused assignment: the short last chunk of a
    leaf, an alias and containers (all in one pod under BundleAll), and a
    scalar, whose pod is packed by `serialize_pod`."""
    spy = BlobSpy(monkeypatch)
    rng = np.random.default_rng(3)
    state = short_chunk_state(rng)
    if with_scalar:
        state["step"] = 0
    ref, port = pair(bundle=bundle)
    st = save_both(ref, port, spy, state)
    assert st["n_pods_reused"] == 0 and st["n_pods_from_layout"] == 0
    assert st["n_pods_serialized"] == st["pods_written"] > 0
    layouts = port.lineage.prev_pods.blob_layout
    for r in range(1, 5):
        sparse(state, rng, r)
        st = save_both(ref, port, spy, state)
        assert st["n_pods_reused"] > 0 and st["pods_written"] > 0
        assert port.lineage.prev_pods.blob_layout is layouts
        if bundle and with_scalar:
            # the one pod holds the scalar: every blob falls back
            assert st["n_pods_from_layout"] == 0
        else:
            assert st["n_pods_from_layout"] >= st["pods_written"] - 1
    if bundle and not with_scalar:
        # one pod, holding every kind but a scalar, filled from its layout
        (layout,) = layouts.values()
        assert st["n_pods_from_layout"] == 1
        assert len(layout.keys) == sum(
            1 for n in port.lineage.prev_graph.nodes.values()
            if n.kind == "chunk")
    assert (spy.scalar_pods > 0) == with_scalar
    assert_loaded_equal(port.load(), state)


@pytest.mark.parametrize("change", ["add_leaf", "reshape", "dtype"])
def test_a_structural_change_lays_the_layout_out_again(monkeypatch, change):
    """A new leaf, a leaf of another shape or another dtype makes a new
    assignment: its first save fills nothing from a layout, and the next
    sparse save fills from the layout the new one laid out."""
    spy = BlobSpy(monkeypatch)
    rng = np.random.default_rng(5)
    state = short_chunk_state(rng)
    ref, port = pair()
    save_both(ref, port, spy, state)
    sparse(state, rng, 1)
    save_both(ref, port, spy, state)
    before = port.lineage.prev_pods
    assert before.blob_layout
    name = "x" if change == "add_leaf" else "w"
    if change == "add_leaf":
        state["params"]["x"] = rng.standard_normal((16, 4)).astype(np.float32)
    elif change == "reshape":
        state["params"]["w"] = rng.standard_normal((40, 32)).astype(np.float32)
    else:
        state["params"]["w"] = (state["params"]["w"] * 64).astype(np.int32)
    st = save_both(ref, port, spy, state)
    after = port.lineage.prev_pods
    assert after is not before and st["n_pods_reused"] == 0
    assert st["n_pods_from_layout"] == 0 and st["n_pods_serialized"] > 0
    sparse(state, rng, 2)
    state["params"][name] += 1
    st = save_both(ref, port, spy, state)
    assert port.lineage.prev_pods is after
    # the changed leaf's pods, written by the first save under `after`,
    # come from the layouts it laid out
    assert st["n_pods_from_layout"] > 0
    assert_loaded_equal(port.load(), state)


def test_delta_chains_store_the_same_deltas(monkeypatch):
    """With delta chains the candidate is encoded from the layout's blob:
    the stored deltas, their chain links and the manifests' ``delta_of``
    are the reference's."""
    spy = BlobSpy(monkeypatch)
    rng = np.random.default_rng(7)
    state = short_chunk_state(rng)
    ref, port = pair(bundle=True, delta_chains=True)
    save_both(ref, port, spy, state)
    n_delta = 0
    for r in range(1, 6):
        sparse(state, rng, r)
        st = save_both(ref, port, spy, state)
        n_delta += st["n_delta_pods"]
        assert st["n_pods_from_layout"] == st["n_pods_serialized"] == 1
        tid = port.versions.head_commit()
        assert port.store.get_manifest(tid)["pods"] == \
            ref.store.get_manifest(tid)["pods"]
    assert n_delta > 0 and port.store.list_delta_pods()
    assert_loaded_equal(port.load(), state)


@pytest.mark.parametrize("backend", ["compressed", "file"])
def test_compressed_and_file_stores_hold_the_same_bytes(monkeypatch,
                                                        tmp_path, backend):
    spy = BlobSpy(monkeypatch)
    rng = np.random.default_rng(11)
    state = short_chunk_state(rng)
    if backend == "compressed":
        stores = RefMemoryStore(compress=True), MemoryStore(compress=True)
    else:
        stores = (RefFileStore(str(tmp_path / "ref")),
                  FileStore(str(tmp_path / "port")))
    ref, port = pair(*stores)
    save_both(ref, port, spy, state)
    for r in range(1, 4):
        sparse(state, rng, r)
        st = save_both(ref, port, spy, state)
        assert 0 < st["n_pods_from_layout"] == st["n_pods_serialized"]
    if backend == "compressed":
        assert port.store.stats.codec == ref.store.stats.codec != ""
    assert_loaded_equal(port.load(), state)


def test_a_chunk_of_another_length_falls_back_to_serialize_pod():
    """A chunk whose bytes are not the length its header was packed for
    (an empty leaf's one chunk is sized 1 byte, and holds none) is packed
    by `serialize_pod`."""
    rng = np.random.default_rng(13)
    port = Chipmink(MemoryStore(), chunk_bytes=CHUNK, device="cpu")
    state = short_chunk_state(rng)
    state["params"]["empty"] = np.zeros((0, 4), np.float32)
    port.save(to_torch(state))
    asg, graph = port.lineage.prev_pods, port.lineage.prev_graph
    nodes = [graph.node(nid) for pod in asg.pods.values()
             for nid in pod.node_ids]
    chunk_bytes, _ = podding.batched_chunk_fetch(graph, nodes)
    n_short = 0
    for pod in asg.pods.values():
        want = podding.serialize_pod(pod, graph, asg,
                                     lambda n: chunk_bytes[n.key])
        layout = asg.blob_layout[pod.pod_id]
        fits = all(len(chunk_bytes[k]) == n
                   for k, n in zip(layout.keys, layout.sizes))
        n_short += not fits
        assert podding.pod_blob(pod, graph, asg, chunk_bytes) == (want, fits)
        if not layout.keys:
            continue
        short = dict(chunk_bytes)
        short[layout.keys[0]] += b"\0\0"
        assert podding.pod_blob(pod, graph, asg, short) == (
            podding.serialize_pod(pod, graph, asg, lambda n: short[n.key]),
            False)
    assert n_short == 1
    assert_loaded_equal(port.load(), state)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 32768, 65535, 65536, 1 << 18])
def test_bin_headers_are_msgpacks(n):
    """8-, 16- and 32-bit lengths: 2 KiB chunks take the 16-bit header,
    256 KiB chunks the 32-bit one."""
    packed = msgpack.packb(bytes(n), use_bin_type=True)
    assert podding._bin_header(n) == packed[:len(packed) - n]


def test_large_and_tiny_chunks(monkeypatch):
    """128 KiB chunks (a 32-bit bin header, and a short last chunk of
    32,000 bytes, a 16-bit one) beside a leaf of 40 bytes (an 8-bit
    one)."""
    spy = BlobSpy(monkeypatch)
    rng = np.random.default_rng(17)
    state = {"big": rng.standard_normal(40768).astype(np.float32),
             "tiny": rng.standard_normal(10).astype(np.float32)}
    ref, port = pair(chunk=1 << 17)
    save_both(ref, port, spy, state)
    for r in range(1, 3):
        state["big"][::1000] += np.float32(r)
        state["tiny"][0] += np.float32(r)
        st = save_both(ref, port, spy, state)
        assert 0 < st["n_pods_from_layout"] == st["n_pods_serialized"]
    assert_loaded_equal(port.load(), state)


@pytest.mark.parametrize("batched", [False, True])
def test_thesaurus_entries_evict_as_the_reference(batched):
    """A batch's pods enter the thesaurus in one call (`insert_many`):
    its map and its LIFO order are the reference's, entry by entry,
    through a capacity of five entries and repeated digests."""
    from repro.core.thesaurus import PodThesaurus as RefThesaurus
    from repro_torch.core.thesaurus import ENTRY_BYTES, PodThesaurus
    rng = np.random.default_rng(19)
    ref, port = RefThesaurus(5 * ENTRY_BYTES), PodThesaurus(5 * ENTRY_BYTES)
    for _ in range(6):
        digests, refs = rng.integers(0, 9, 7), rng.integers(0, 99, 7)
        pairs = [(bytes([int(d)]) * 16, f"ref{int(r)}")
                 for d, r in zip(digests, refs)]
        for d, r in pairs:
            ref.insert(d, r)
        if batched:
            port.insert_many(pairs)
        else:
            for d, r in pairs:
                port.insert(d, r)
        assert port._map == ref._map and port._stack == ref._stack
    assert len(port) == 5
