"""Serve-step factories, the port of `repro.train.serve_step`.

`make_prefill_step` and `make_decode_step` are the model's steps as plain
eager calls: the dry-run traces them on DTensors and meta shards
(`launch/dryrun.py`) and the model tests run them op by op.

`compile_decode_step` is the port's counterpart of the reference's
`jax.jit` of a decode step (`repro.launch.serve`, `greedy_generate`): a
`DecodeGraph` binds one session's cache and, on a card, replays the step
as one CUDA graph per call.  `launch.serve.serve` builds one per session
and `greedy_generate` one per call.

`greedy_generate` keeps every token on the device and brings the
generated tokens to the host once, at the end.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..models.model import api
from ..models.transformer import step_cache
from ..parallel.sharding import is_dtensor
from .tree import tree_leaves, tree_map

#: eager steps on a scratch cache before a capture: they load every
#: kernel and give the capture stream its cuBLAS workspace outside the
#: graph (`torch.cuda.graph`'s documentation asks for a few)
WARMUP_STEPS = 3


def make_prefill_step(cfg: ArchConfig, *, q_chunk: Optional[int] = 2048
                      ) -> Callable:
    m = api(cfg)

    def prefill_step(params: Dict, batch: Dict) -> torch.Tensor:
        logits, _ = m.prefill(params, batch, cfg, q_chunk=q_chunk)
        return logits

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    m = api(cfg)

    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        return m.decode_step(params, cache, tokens, cfg)

    return decode_step


class DecodeGraph:
    """One session's decode step bound to its cache; built by
    `compile_decode_step`.  ``step(tokens)`` -> ``(logits, cache)``.

    Its static buffers are a (B, 1) int32 token buffer, the session's
    cache tensors themselves, ``pos`` among them, and a logits buffer.
    `cache` is one dict, with the sorted keys of `transformer.
    step_cache`, that holds the same tensor objects at every call;
    `logits` is overwritten by the next call.  The body is the model's
    `decode_step` unchanged, then an in-place copy of its new ``pos``
    into the cache's own and of its logits into the logits buffer.

    On a card the body is captured once and each call copies the tokens
    in and replays the graph on the current stream, so an async save's
    snapshot, taken on that stream, stays ordered before the next step's
    in-place writes.  Each graph has a private memory pool, and nothing
    a caller keeps lives in it; at full width a capture adds 38–130 MB
    of reserved device memory per session (`chip_smoke.py` phases 9b
    and 11b on an H100).  On the CPU each call runs the same body
    eagerly through the same buffers.

    A graph is bound to the tensors it captured: when a resume or a
    checkout hands back new tensors, compile a new step over them.
    """

    def __init__(self, cfg: ArchConfig, params: Dict, cache: Dict,
                 device: torch.device) -> None:
        self._cfg, self._params, self._m = cfg, params, api(cfg)
        self.cache = step_cache(cache, dict(cache["layers"]), cache["pos"])
        B = tree_leaves(cache["layers"])[0].shape[0]
        self.tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if device.type == "cuda":
            self._capture(device)

    def _body(self) -> None:
        logits, out = self._m.decode_step(self._params, self.cache,
                                          self.tokens, self._cfg)
        self.cache["pos"].copy_(out["pos"])
        if self.logits is None:
            self.logits = torch.empty_like(logits)
        self.logits.copy_(logits)

    def _capture(self, device: torch.device) -> None:
        """Warm up on a zeroed copy of the cache, then capture against
        the session's own: a capture records launches and runs none, so
        the session's cache is left as it was."""
        scratch = tree_map(torch.zeros_like, self.cache)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                logits, _ = self._m.decode_step(self._params, scratch,
                                                self.tokens, self._cfg)
            self.logits = torch.empty_like(logits)
        torch.cuda.current_stream(device).wait_stream(side)
        del scratch, logits
        graph = torch.cuda.CUDAGraph()
        # thread-local: an async save body on another thread may sync or
        # allocate while this thread captures.  A sync in the body itself
        # still fails the capture, which raises.
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self._body()
        self.graph = graph

    def __call__(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        self.tokens.copy_(tokens)
        if self.graph is None:
            self._body()
        else:
            self.graph.replay()
        return self.logits, self.cache


def compile_decode_step(cfg: ArchConfig, params: Dict, cache: Dict, *,
                        device: Any = "cuda") -> DecodeGraph:
    """The port's `jax.jit(make_decode_step(cfg))` for one session: a
    `DecodeGraph` over `cache` (see there).  Every leaf of `params` and
    `cache` must lie on `device`, ``"cuda"`` by default: there the step
    is captured as a CUDA graph, and a failed capture or replay raises.
    ``device="cpu"`` runs the same body eagerly.  DTensors (a mesh's
    steps, the dry-run's meta shards) never go through a graph: they
    raise, and `make_decode_step` runs them."""
    device = graph_device("compile_decode_step", "make_decode_step", device,
                          tree_leaves((params, cache)))
    return DecodeGraph(cfg, params, cache, device)


def graph_device(what: str, eager: str, device: Any,
                 leaves: Any) -> torch.device:
    """The device a compiled step (`what`) runs on: ``"cuda"`` (the
    current card when no index is given; it raises without one) or
    ``"cpu"``.  Every tensor in `leaves` must lie there; a DTensor raises,
    since a mesh's steps run eagerly through `eager`."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' "
                               f"to run the step eagerly")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"{what}: device {device} is neither cuda nor cpu")
    for leaf in leaves:
        if is_dtensor(leaf):
            raise TypeError(f"{what}: a DTensor leaf; steps on a mesh run "
                            f"eagerly through {eager}")
        if leaf.device != device:
            raise ValueError(f"{what}: a leaf on {leaf.device}, the step on "
                             f"{device}")
    return device


def greedy_generate(cfg: ArchConfig, params: Dict, prompt: torch.Tensor,
                    n_steps: int, cache_len: int = 256) -> torch.Tensor:
    """Feed the prompt token by token through the compiled decode step
    (also a prefill/decode parity check), then greedy-decode `n_steps`
    tokens, on the prompt's device.  Returns (B, n_steps) int32 there."""
    m = api(cfg)
    B, P = prompt.shape
    step = compile_decode_step(
        cfg, params, m.init_cache(cfg, B, cache_len, device=prompt.device),
        device=prompt.device)
    logits: Any = None
    for i in range(P):
        logits, _ = step(prompt[:, i:i + 1])
    out = [torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)]
    for _ in range(n_steps - 1):
        logits, _ = step(out[-1])
        out.append(torch.argmax(logits, dim=-1, keepdim=True)
                   .to(torch.int32))
    return torch.cat(out, dim=1)
