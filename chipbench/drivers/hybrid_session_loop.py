"""`session_loop`'s serving loop for a Jamba configuration: the same
file, loaded afresh, with its reference (`reference/jamba.py`), its
view of the port (`arch_config` below) and its counts of work bound to
Jamba's in place of the dense and MoE decoders' (`reference/model.py`,
`harness/port.py`, `reference/counts.py`).  Everything else, the
window, the snapshots and the comparison that decides ``correct``, is
`session_loop`'s own.

One thing differs: `session_loop` scores the served tokens with weights
made anew from the seed while its last session's decode graph, and with
it the program's weights, is still alive, and two copies of Jamba's 58
GB do not fit one card.  So the reference here hands the scoring the
very tensors it made for the program, once their sums show them
unchanged (the program never writes its weights; a write would change
a sum).  Same seed, same bits: the scores are those of a fresh copy.

`session_loop` names its reference in module globals, so a second model
family needs this file.  A later `benchmark` PR should let a
configuration file name its reference and port view, and have the loop
drop its graphs before it scores, which retires this file.
"""
from __future__ import annotations

import dataclasses
import gc
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import torch

from chipbench.harness.bench import load_module
from chipbench.reference import jamba


def arch_config(cfg: Dict):
    """The port's configuration of `cfg["arch_id"]`, every size, the
    layer layout and the expert share taken from `cfg`.  Raises where
    the port's Jamba cannot hold them."""
    from repro_torch.configs import JambaConfig, get_config
    base = get_config(cfg["arch_id"])
    if not isinstance(base, JambaConfig):
        raise ValueError(f"{cfg['arch_id']}: not a Jamba configuration")
    if cfg["mamba_proj_bias"] or not cfg["mamba_conv_bias"] \
            or cfg["hidden_act"] != "silu" or cfg["sliding_window"] \
            or cfg["rms_norm_eps"] != 1e-6:
        raise ValueError(f"{cfg['arch_id']}: the port's Jamba has conv "
                         f"bias, no projection bias, SiLU, full attention "
                         f"and RMSNorm's eps 1e-6")
    s = jamba.Shape.of(cfg)
    return dataclasses.replace(
        base, n_layers=s.L, d_model=s.E, n_heads=s.Hq, n_kv_heads=s.Hkv,
        head_dim=s.D, d_ff=s.F, vocab=s.V,
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        moe=dataclasses.replace(base.moe, n_experts=s.routed,
                                top_k=s.top_k, expert_ff=s.F),
        experts_held=s.held,
        ssm=dataclasses.replace(base.ssm, expand=cfg["mamba_expand"],
                                d_state=s.N, d_conv=s.K, dt_rank=s.R),
        attn_period=s.attn_period, attn_offset=s.attn_offset,
        expert_period=s.expert_period, expert_offset=s.expert_offset)


class Reference:
    """`reference/jamba.py`, whose `make_params` hands the same seed the
    tensors it made the first time, checked unchanged."""

    def __init__(self) -> None:
        self.made = None

    def __getattr__(self, name: str):
        return getattr(jamba, name)

    def make_params(self, s: jamba.Shape, seed: int, device) -> Dict:
        key = (s, seed, str(device))
        if self.made is not None and self.made[0] == key:
            _, params, sums = self.made
            if not torch.equal(leaf_sums(params), sums):
                raise RuntimeError("the program's weights changed")
            return params
        params = jamba.make_params(s, seed, device)
        self.made = (key, params, leaf_sums(params))
        return params


def leaf_sums(params: Dict) -> torch.Tensor:
    """Each leaf's sum and sum of magnitudes, in float64."""
    return torch.stack([torch.stack([torch.sum(v, dtype=torch.float64),
                                     torch.sum(v.abs(), dtype=torch.float64)])
                        for v in jamba.flatten(params).values()])


def run(ctx) -> None:
    loop = load_module(Path(__file__).with_name("session_loop.py"))
    loop.ref = reference = Reference()
    loop.counts = jamba
    loop.port = SimpleNamespace(arch_config=arch_config)
    try:
        loop.run(ctx)
    finally:
        # the weights go with the run: the loop's module and the graphs
        # it made hold each other, so they wait for a collection
        reference.made = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
