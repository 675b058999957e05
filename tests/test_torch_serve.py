"""The port's serving driver (`repro_torch.launch.serve.serve`) against
the reference's (`repro.launch.serve.serve`), with the same arguments:
reduced width, 3 sessions (as `examples/incremental_serving.py`), on the
CPU.

The weights differ between the packages (each draws its own from seed
0), so the KV bytes differ and pods cannot match.  The *structure* must,
exactly: the number of snapshots and, per snapshot, its TimeID, dirty
chunks, pods written and reused, bytes written and sync counts; the
fleet's roll-up without timings (tip bytes, dedup ratio, store bytes);
and the eviction's counts and bytes.  They hold because every one of
them depends on which cache slots a step writes and on the chunk and pod
layout, never on the values: both packages write the same slots of
same-shaped caches at the same steps, chunks are fixed-size flat ranges,
stores are uncompressed, and the shared prompt prefix (7 tokens) gives
equal KV across sessions within each package.  Two families are the
exceptions named beside `RECURRENT` and `VALUED` below: when a recurrent
state stops changing in its last bit, and whether two sessions' greedy
tokens coincide, depend on values.

With ``async_mode`` the pool's save bodies run on their own threads, and
which of two sessions' bodies writes a pod they share is a race: one of
them, or both when they run at once (the reference's own runs differ
from run to run, in their totals too).  There the pods and bytes each
snapshot writes are left out, as are the store's footprint and the bytes
reclaimed, which count manifest bytes whose `stats` block carries the
port's snapshot fields;
what the store ends up holding (tip bytes, dedup ratio, the evicted
session's pods) is still compared.
"""
import numpy as np
import pytest

from repro.launch.serve import serve as ref_serve
from repro_torch.launch.serve import serve

from test_torch_version import reference_stats_block_as_the_port  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_stats_block_as_the_port")

SNAP_KEYS = ("time_id", "n_dirty_chunks", "pods_written", "n_pods_reused",
             "bytes_written", "n_digest_syncs", "n_gather_syncs",
             "n_corrective_syncs", "n_spec_hits", "n_spec_misses")
TIMINGS = ("p50_save_stall_s", "p99_save_stall_s", "p50_evict_s",
           "p99_evict_s")
#: left to a race between save bodies in async mode
RACED = ("pods_written", "bytes_written")
#: fleet fields that count manifest bytes, whose `stats` block carries
#: the port's snapshot fields in async mode
FOOTPRINT = ("store_bytes", "bytes_per_session", "bytes_reclaimed")


#: the other families, one sync case each
FAMILIES = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b", "falcon-mamba-7b",
            "recurrentgemma-9b", "qwen2-vl-2b", "whisper-base")
#: families whose cache holds recurrent states, rewritten at every step.
#: From the third snapshot on, greedy decoding of random weights repeats
#: a token, the conv window then holds one input and the state settles
#: on a fixed point; the step at which it stops changing in its last bit
#: is not the same in the two packages, so these run 8 generated tokens:
#: two snapshots per session, each of them all-dirty.
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-9b")
#: Whisper's later snapshots dedup a self-attention K/V chunk against
#: another session's whenever the two sessions' greedy tokens coincide
#: for the chunk's slots, which depends on the logits' last bits: the
#: pods and bytes each snapshot writes, and the store totals and eviction
#: that follow from them, are left out there (Whisper's structure is
#: still compared: dirty chunks, syncs, speculation).
VALUED = {"whisper-base": ("pods_written", "bytes_written")}
VALUED_FLEET = ("logical_tip_bytes", "physical_tip_bytes", "dedup_ratio")


@pytest.mark.parametrize("arch,async_mode", [("qwen1.5-0.5b", False),
                                             ("starcoder2-3b", False),
                                             ("qwen1.5-0.5b", True)]
                         + [(a, False) for a in FAMILIES])
def test_serve_has_the_reference_snapshot_structure(arch, async_mode):
    gen = 8 if arch in RECURRENT else 32
    kw = dict(n_sessions=3, reduced=True, log=False, async_mode=async_mode,
              gen_tokens=gen)
    want = ref_serve(arch, **kw)
    got = serve(arch, device="cpu", **kw)
    assert len(got["snap_stats"]) == len(want["snap_stats"]) == \
        3 * (8 + gen) // 8
    raced = (RACED if async_mode else ()) + VALUED.get(arch, ())
    for g, w in zip(got["snap_stats"], want["snap_stats"]):
        assert {k: g[k] for k in SNAP_KEYS if k not in raced} == \
            {k: w[k] for k in SNAP_KEYS if k not in raced}
    drop = TIMINGS + (FOOTPRINT if async_mode or arch in VALUED else ()) \
        + (VALUED_FLEET if arch in VALUED else ())
    fleet = {k: v for k, v in got["fleet"].items() if k not in drop}
    assert fleet == {k: v for k, v in want["fleet"].items() if k not in drop}
    assert got["fleet"]["dedup_ratio"] > 1
    ge, we = got["evict_stats"], want["evict_stats"]
    if arch not in VALUED:
        assert (ge.n_commits_deleted, ge.n_pods_deleted,
                ge.pod_bytes_reclaimed) == \
            (we.n_commits_deleted, we.n_pods_deleted, we.pod_bytes_reclaimed)
    assert ge.n_commits_deleted == we.n_commits_deleted
    if not async_mode and arch not in VALUED:
        assert ge.bytes_reclaimed == we.bytes_reclaimed
    assert ge.bytes_reclaimed > 0
    assert got["tokens"].shape == want["tokens"].shape == (4, gen)
    assert got["tokens"].dtype == np.int32
    first, last = got["snap_stats"][0], got["snap_stats"][-1]
    svc = got["service"]
    cache = svc.pool[0].load(time_id=first["time_id"])["cache"]

    def chunks(names):
        size = svc.pool[0].chunk_bytes
        return sum(-(-v.numel() * v.element_size() // size)
                   for tree in (cache["layers"], cache.get("cross", {}))
                   for lc in tree.values()
                   for k, v in lc.items() if k in names)

    if arch in RECURRENT:
        # every chunk of every SSM / LRU state is dirty at every
        # snapshot: the all-dirty save
        state = chunks(("ssm", "lru"))
        assert state > 0
        assert all(s["n_dirty_chunks"] >= state for s in got["snap_stats"])
    else:
        # later snapshots write the few slots decoded since the last one
        assert last["bytes_written"] < first["bytes_written"] / 4
    if arch == "whisper-base":
        # the cross K/V is written once per session: no later snapshot
        # dirties any of its chunks
        cross = chunks(("xk", "xv"))
        assert cross > 0
        assert all(s["n_dirty_chunks"] < cross
                   for s in got["snap_stats"][3:])
