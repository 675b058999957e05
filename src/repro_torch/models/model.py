"""Model dispatch: the port of `repro.models.model` for the dense family.

    api(cfg)          -> namespace with param_defs / loss_fn / prefill /
                         decode_step / cache_spec / init_cache
    init_model_params -> the parameter tree, on a device, from a generator
    count_params      -> the parameter count from `param_defs` (abstract)

The other families and the dry-run's input specs are not ported yet
(ROADMAP.md section 1).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import transformer
from .layers import init_params


def api(cfg: ArchConfig) -> SimpleNamespace:
    transformer.layer_plan(cfg)          # raises for a family not ported
    return SimpleNamespace(
        param_defs=transformer.param_defs,
        loss_fn=transformer.loss_fn,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
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


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(d.shape)
               for d in api(cfg).param_defs(cfg).values())
