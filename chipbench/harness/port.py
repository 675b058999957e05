"""The program's view of a configuration file: the port's `ArchConfig`
for the file's ``arch_id``, with the file's sizes."""
from __future__ import annotations

import dataclasses
from typing import Dict

#: configuration-file key -> `ArchConfig` field
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab",
          "rope_theta": "rope_theta",
          "tie_word_embeddings": "tie_embeddings"}


def arch_config(cfg: Dict):
    """The port's configuration of `cfg["arch_id"]`, every size taken
    from `cfg`.  Raises where the port's family cannot hold them."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch_id"])
    kw = {field: type(getattr(base, field))(cfg[key])
          for key, field in FIELDS.items()}
    kw["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    kw["qkv_bias"] = bool(cfg.get("architecture", {}).get("qkv_bias", False))
    kw["d_ff"] = int(cfg["intermediate_size"])
    if cfg.get("num_local_experts"):
        if base.moe is None:
            raise ValueError(f"{cfg['arch_id']}: the port's config has no "
                             f"experts")
        kw["moe"] = dataclasses.replace(
            base.moe, n_experts=int(cfg["num_local_experts"]),
            top_k=int(cfg["num_experts_per_tok"]),
            expert_ff=int(cfg["intermediate_size"]))
    elif base.moe is not None:
        raise ValueError(f"{cfg['arch_id']}: the port's config has experts "
                         f"and the file none")
    if base.family not in ("dense", "moe") or base.norm != "rms" \
            or base.mlp != "swiglu" or base.sliding_window is not None:
        raise ValueError(f"{cfg['arch_id']}: the reference covers dense and "
                         f"MoE decoders with RMSNorm and SwiGLU only")
    return dataclasses.replace(base, **kw)
