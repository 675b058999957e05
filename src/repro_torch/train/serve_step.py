"""Serve-step factories: prefill and decode as plain eager calls (the
port of `repro.train.serve_step`; no `torch.compile`).

`greedy_generate` keeps every token on the device and brings the
generated tokens to the host once, at the end.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..models.model import api


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


def greedy_generate(cfg: ArchConfig, params: Dict, prompt: torch.Tensor,
                    n_steps: int, cache_len: int = 256) -> torch.Tensor:
    """Feed the prompt token by token through decode_step (also a
    prefill/decode parity check), then greedy-decode `n_steps` tokens.
    Returns (B, n_steps) int32 on the prompt's device."""
    m = api(cfg)
    B, P = prompt.shape
    cache = m.init_cache(cfg, B, cache_len, device=prompt.device)
    logits: Any = None
    for i in range(P):
        logits, cache = m.decode_step(params, cache, prompt[:, i:i + 1], cfg)
    out = [torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)]
    for _ in range(n_steps - 1):
        logits, cache = m.decode_step(params, cache, out[-1], cfg)
        out.append(torch.argmax(logits, dim=-1, keepdim=True)
                   .to(torch.int32))
    return torch.cat(out, dim=1)
