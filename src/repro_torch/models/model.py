"""Model dispatch: the port of `repro.models.model`, one API across all 10
architectures.

    api(cfg)          -> namespace with param_defs / loss_fn / prefill /
                         decode_step / cache_spec / cache_axes / init_cache
    init_model_params -> the parameter tree, on a device, from a generator
    input_specs(...)  -> `TensorSpec` stand-ins for every model input of an
                         (arch x shape) cell: no allocation (the dry-run's
                         contract)
    count_params      -> the parameter count from `param_defs` (abstract),
                         or the count active per token of a MoE model
    model_flops       -> the analytic FLOPs of a cell
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeCell
from . import transformer, whisper
from .layers import TensorSpec, abstract_params, init_params, logical_axes


def api(cfg: ArchConfig) -> SimpleNamespace:
    family = whisper if cfg.family == "encdec" else transformer
    return SimpleNamespace(
        param_defs=family.param_defs,
        loss_fn=family.loss_fn,
        prefill=family.prefill,
        decode_step=family.decode_step,
        cache_spec=transformer.cache_spec,
        cache_axes=transformer.cache_axes,
        init_cache=transformer.init_cache,
    )


def abstract_model_params(cfg: ArchConfig,
                          dtype: torch.dtype = torch.bfloat16) -> Dict:
    return abstract_params(api(cfg).param_defs(cfg), dtype=dtype)


def model_logical_axes(cfg: ArchConfig) -> Dict:
    return logical_axes(api(cfg).param_defs(cfg))


def init_model_params(cfg: ArchConfig, generator: torch.Generator, *,
                      device: Any,
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters from `generator` (a generator on `device`).
    Tied embeddings are one tensor: `logits_from` reads ``embed``."""
    return init_params(api(cfg).param_defs(cfg), generator, device=device,
                       dtype=dtype)


# ---------------------------------------------------------------------------
# input specs per shape cell
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """`TensorSpec` stand-ins for every input of (arch x shape)."""
    B, S = cell.global_batch, cell.seq_len

    def tok(s: int) -> TensorSpec:
        return TensorSpec((B, s), torch.int32)

    if cell.kind == "train":
        batch: Dict[str, Any] = {"tokens": tok(S), "labels": tok(S)}
        _add_frontend(batch, cfg, B, S)
        return {"batch": batch}
    if cell.kind == "prefill":
        batch = {"tokens": tok(S)}
        _add_frontend(batch, cfg, B, S)
        return {"batch": batch}
    if cell.kind == "decode":
        return {"tokens": TensorSpec((B, 1), torch.int32),
                "cache": api(cfg).cache_spec(cfg, B, S)}
    raise ValueError(cell.kind)


def _add_frontend(batch: Dict, cfg: ArchConfig, B: int, S: int) -> None:
    if cfg.vlm is not None:
        P = min(cfg.vlm.n_patches, S)
        batch["patch_embeds"] = TensorSpec((B, P, cfg.d_model),
                                           torch.bfloat16)
    if cfg.encoder is not None:
        batch["frames"] = TensorSpec((B, cfg.encoder.n_frames, cfg.d_model),
                                     torch.bfloat16)


def concrete_batch(cfg: ArchConfig, cell: ShapeCell, seed: int = 0, *,
                   device: Any = "cpu") -> Dict:
    """Real tensors matching `input_specs`: the reference's numpy draws
    (`default_rng(seed)`, leaves in sorted-key order), integers below the
    vocab as int32, floats cast to their dtype (float64 -> bf16 rounds
    through float32, as `jnp.asarray` does)."""
    rng = np.random.default_rng(seed)

    def materialize(s: Any) -> Any:
        if not isinstance(s, TensorSpec):
            return {k: materialize(s[k]) for k in sorted(s)}
        if not s.dtype.is_floating_point:
            v = rng.integers(0, cfg.vocab, size=s.shape).astype(np.int32)
            return torch.from_numpy(v).to(device)
        v = rng.standard_normal(s.shape).astype(np.float32)
        return torch.from_numpy(v).to(s.dtype).to(device)

    return materialize(input_specs(cfg, cell))


# ---------------------------------------------------------------------------
# analytic FLOPs (roofline: MODEL_FLOPS = 6·N·D dense / 6·N_active·D MoE)
# ---------------------------------------------------------------------------


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


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D per generated
    token for inference cells."""
    n_params = count_params(cfg, active_only=cfg.moe is not None)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_params * tokens
