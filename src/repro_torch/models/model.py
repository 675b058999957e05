"""Model dispatch: the port of `repro.models.model`, one API across all 10
architectures.

    api(cfg)          -> namespace with param_defs / loss_fn / prefill /
                         decode_step / cache_spec / init_cache
    init_model_params -> the parameter tree, on a device, from a generator
    count_params      -> the parameter count from `param_defs` (abstract),
                         or the count active per token of a MoE model

The dry-run's input specs, abstract trees, logical axes and FLOP counts
are not ported yet (ROADMAP.md section 1).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import transformer, whisper
from .layers import init_params


def api(cfg: ArchConfig) -> SimpleNamespace:
    family = whisper if cfg.family == "encdec" else transformer
    return SimpleNamespace(
        param_defs=family.param_defs,
        loss_fn=family.loss_fn,
        prefill=family.prefill,
        decode_step=family.decode_step,
        cache_spec=transformer.cache_spec,
        init_cache=transformer.init_cache,
    )


def init_model_params(cfg: ArchConfig, generator: torch.Generator, *,
                      device: Any,
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters from `generator` (a generator on `device`).
    Tied embeddings are one tensor: `logits_from` reads ``embed``."""
    return init_params(api(cfg).param_defs(cfg), generator, device=device,
                       dtype=dtype)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of `param_defs`; with ``active_only`` a MoE model's
    expert tensors count top_k of n_experts, as in the reference."""
    total = 0
    for path, d in api(cfg).param_defs(cfg).items():
        n = math.prod(d.shape)
        if active_only and cfg.moe is not None and "ffn" in path \
                and path[-1] in ("w_gate", "w_up", "w_down") \
                and len(d.shape) == 3:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total
