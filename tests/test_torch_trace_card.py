"""The program's spans on the profiler's clock, on a card: under
`torch.profiler` the digest kernel (K1, ``leaves_cmp_kernel``) of every
save runs inside that save's ``save.digest.call`` span, for a sync save
(the caller's thread) and an async one (the podding thread, K1 on the
side stream); and a host range the profiler records lies inside the span
around it.

This file imports no JAX and nothing of the reference, so it runs where
the card is: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_trace_card.py``.  Without a card every test skips
through the `cuda` fixture; the spans themselves are tested on the CPU
in `test_torch_trace.py`.
"""
import time

import pytest
import torch

from repro_torch.core import Chipmink, MemoryStore, trace

K1 = "leaves_cmp_kernel"
SAVES = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's device clock and "
                    "the digest kernel run only there (the spans are "
                    "tested in test_torch_trace.py)")
    return torch.device("cuda")


def profiled(fn):
    """The events of `fn` under the profiler, after a window that is
    thrown away (a window's first kernel records can go missing)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def intervals(events, name, cuda_only):
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if name in e.name()
            and (e.device_type() == DeviceType.CUDA) == cuda_only]


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_k1_runs_inside_its_digest_call(cuda, async_mode):
    g = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn(2048, 1024, device=cuda, generator=g),
             "b": torch.randn(8192, device=cuda, generator=g)}
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 16, device=cuda,
                  async_mode=async_mode)
    ck.save(state)                   # builds K1, digests every byte
    ck.wait()

    def saves():
        for k in range(SAVES):
            state["w"][k].add_(1.0)
            ck.save(state)
        ck.wait()

    trace.enable()
    try:
        events = profiled(saves)
    finally:
        trace.disable()
    calls = [(s["start_ns"], s["end_ns"], s["thread"])
             for s in trace.spans() if s["name"] == "save.digest.call"]
    thread = "chipmink-podding" if async_mode else "MainThread"
    assert len(calls) == SAVES and {t for *_, t in calls} == {thread}
    k1 = intervals(events, K1, cuda_only=True)
    assert k1, "the profiler recorded no digest kernel"
    for k0, k1_end in k1:
        inside = [c for c in calls if c[0] <= k0 and k1_end <= c[1]]
        assert len(inside) == 1, (k0, k1_end, calls)


def test_a_host_range_lies_inside_its_span(cuda):
    from torch.profiler import record_function

    def probe():
        for _ in range(3):
            with trace.span("probe"):
                time.sleep(0.002)
                with record_function("probe.range"):
                    time.sleep(0.002)
                time.sleep(0.002)

    trace.enable()
    try:
        events = profiled(probe)
    finally:
        trace.disable()
    spans = [(s["start_ns"], s["end_ns"]) for s in trace.spans()]
    ranges = intervals(events, "probe.range", cuda_only=False)
    assert len(spans) == len(ranges) == 3
    for (s0, s1), (r0, r1) in zip(spans, sorted(ranges)):
        assert s0 <= r0 <= r1 <= s1, (s0, r0, r1, s1)
