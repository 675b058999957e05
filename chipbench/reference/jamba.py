"""The plain reference of Jamba's hybrid decoder, in float32.

Plain PyTorch: no kernel, cache, batching trick or graph of the program,
and nothing imported from it.  It follows Hugging Face's
`transformers.models.jamba.modeling_jamba` (`JambaForCausalLM`, the
slow Mamba path), layer i being:

- attention where ``i % attn_layer_period == attn_layer_offset`` (GQA,
  scores scaled by 1/sqrt(head_dim), causal, no positional encoding),
  else a Mamba-1 mixer: in_proj, a depthwise causal conv with bias and
  SiLU, x_proj to (dt, B, C), an RMSNorm on each of the three, dt_proj
  with bias and softplus, the selective scan run step by step from a
  zero state, the skip D, the SiLU gate, out_proj;
- then, where ``i % expert_layer_period == expert_layer_offset``, routed
  SwiGLU experts: a float32 softmax over every expert's router logit,
  the top k by probability (ties: lower index first), *not*
  renormalised; else one SwiGLU;
- pre-norm residuals, a final RMSNorm and an untied head.  The input
  embedding is not scaled.

Two choices the configuration file states, which the program shares:

- the expert share: ``expert_parallel.experts_held`` experts, starting
  at ``expert_parallel.first_expert_held``, of the ``num_experts`` the
  router scores, are held; the layer adds only their part, and what the
  other chips' experts would add is left out;
- an RMSNorm's weight is stored as an offset from 1 (``1 + scale``).

Every matrix product runs in float32 with TF32 off, or in `Precision`'s
float8 for the control (`model.Precision`).  The parameter tree has the
program's paths and dtypes, so `make_params` hands both sides the same
tensors.  `decode_step_flops` counts a decode step's work from shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .counts import digest_bound_s, digest_work  # noqa: F401 (as `counts`)
from .model import (BF16, DRAW_ELEMS, F32, F32_REF, FP8_CONTROL,  # noqa: F401
                    Precision, flatten, mm, rms, swiglu, unflatten)

#: Mamba's dt initialisation (Gu and Dao, arXiv:2312.00752; HF's
#: `JambaMambaMixer` keeps it): log-uniform in [DT_MIN, DT_MAX], the
#: bias its inverse softplus
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes of a Jamba decoder, read from a configuration file."""
    L: int
    E: int
    Hq: int
    Hkv: int
    D: int
    F: int
    V: int
    eps: float
    routed: int           # experts the router scores
    held: Tuple[int, int]  # (first, count) of the experts held here
    top_k: int
    Ei: int               # Mamba's inner width, expand x E
    N: int                # state size
    K: int                # conv width
    R: int                # dt rank
    attn_period: int
    attn_offset: int
    expert_period: int
    expert_offset: int

    @classmethod
    def of(cls, cfg: Dict) -> "Shape":
        ep = cfg["expert_parallel"]
        return cls(L=cfg["num_hidden_layers"], E=cfg["hidden_size"],
                   Hq=cfg["num_attention_heads"],
                   Hkv=cfg["num_key_value_heads"],
                   D=cfg["hidden_size"] // cfg["num_attention_heads"],
                   F=cfg["intermediate_size"], V=cfg["vocab_size"],
                   eps=float(cfg["rms_norm_eps"]),
                   routed=int(cfg["num_experts"]),
                   held=(int(ep["first_expert_held"]),
                         int(ep["experts_held"])),
                   top_k=int(cfg["num_experts_per_tok"]),
                   Ei=cfg["mamba_expand"] * cfg["hidden_size"],
                   N=cfg["mamba_d_state"], K=cfg["mamba_d_conv"],
                   R=cfg["mamba_dt_rank"],
                   attn_period=cfg["attn_layer_period"],
                   attn_offset=cfg["attn_layer_offset"],
                   expert_period=cfg["expert_layer_period"],
                   expert_offset=cfg["expert_layer_offset"])

    def attention(self, i: int) -> bool:
        return i % self.attn_period == self.attn_offset

    def experts(self, i: int) -> bool:
        return i % self.expert_period == self.expert_offset


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(s: Shape) -> List[Tuple[str, Tuple[int, ...], torch.dtype,
                                         str]]:
    """(path, shape, dtype, init) of every parameter, in sorted path
    order; init is ``normal`` (scaled by 1/sqrt of the contracted
    dimension), ``embed`` (1/sqrt(hidden)), ``zeros``, ``ones``, ``s4d``
    (A_log = log(1..N) in every channel) or ``dt`` (the dt bias)."""
    out = [("embed", (s.V, s.E), BF16, "embed"),
           ("final_norm/scale", (s.E,), F32, "zeros"),
           ("lm_head", (s.E, s.V), BF16, "normal")]
    for i in range(s.L):
        p = f"layers/{i}/"
        out += [(p + "norm1/scale", (s.E,), F32, "zeros"),
                (p + "norm2/scale", (s.E,), F32, "zeros")]
        if s.attention(i):
            out += [(p + "attn/wq", (s.E, s.Hq * s.D), BF16, "normal"),
                    (p + "attn/wk", (s.E, s.Hkv * s.D), BF16, "normal"),
                    (p + "attn/wv", (s.E, s.Hkv * s.D), BF16, "normal"),
                    (p + "attn/wo", (s.Hq * s.D, s.E), BF16, "normal")]
        else:
            m = p + "mamba/"
            out += [(m + "in_proj", (s.E, 2 * s.Ei), BF16, "normal"),
                    (m + "conv_w", (s.K, s.Ei), BF16, "normal"),
                    (m + "conv_b", (s.Ei,), BF16, "zeros"),
                    (m + "x_proj", (s.Ei, s.R + 2 * s.N), BF16, "normal"),
                    (m + "dt_proj", (s.R, s.Ei), BF16, "normal"),
                    (m + "dt_bias", (s.Ei,), F32, "dt"),
                    (m + "A_log", (s.Ei, s.N), F32, "s4d"),
                    (m + "D", (s.Ei,), F32, "ones"),
                    (m + "out_proj", (s.Ei, s.E), BF16, "normal"),
                    (m + "dt_norm", (s.R,), F32, "zeros"),
                    (m + "b_norm", (s.N,), F32, "zeros"),
                    (m + "c_norm", (s.N,), F32, "zeros")]
        if s.experts(i):
            X = s.held[1]
            out += [(p + "ffn/router", (s.E, s.routed), F32, "normal"),
                    (p + "ffn/w_gate", (X, s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_up", (X, s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_down", (X, s.F, s.E), BF16, "normal")]
        else:
            out += [(p + "ffn/w_gate", (s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_up", (s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_down", (s.F, s.E), BF16, "normal")]
    return sorted(out)


def _init(init: str, z: torch.Tensor, shape: Tuple[int, ...]
          ) -> torch.Tensor:
    """A parameter from its float32 normal draw `z` (flat)."""
    if init == "dt":
        # the normal draw's CDF as the log-uniform's quantile
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
        dt = torch.exp(math.log(DT_MIN) + u * (math.log(DT_MAX)
                                               - math.log(DT_MIN)))
        dt = dt.clamp(min=DT_FLOOR)
        return (dt + torch.log(-torch.expm1(-dt))).view(shape)
    scale = 1.0 / math.sqrt(shape[-1] if init == "embed" else shape[-2])
    return z.view(shape) * scale


def make_params(s: Shape, seed: int, device) -> Dict:
    """The parameter tree from `seed`, on `device`: float32 normal draws
    from one generator on the device, at most `DRAW_ELEMS` a call, each
    drawn leaf a slice of them made into its init and cast to its dtype
    (`model.make_params`'s scheme).  The same seed gives the same bits on
    the same kind of device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat: Dict[str, torch.Tensor] = {}
    pool = torch.empty(0, dtype=F32, device=device)
    used = 0
    shapes = param_shapes(s)
    drawn = ("normal", "embed", "dt")
    left = sum(math.prod(sh) for _, sh, _, init in shapes if init in drawn)
    for path, shape, dtype, init in shapes:
        n = math.prod(shape)
        if init not in drawn:
            if init == "s4d":
                v = torch.log(torch.arange(1, shape[-1] + 1, dtype=F32,
                                           device=device)).expand(shape)
            else:
                v = (torch.zeros if init == "zeros" else torch.ones)(
                    shape, dtype=F32, device=device)
            flat[path] = v.to(dtype).contiguous()
            continue
        if used + n > pool.numel():
            pool = torch.randn(max(n, min(DRAW_ELEMS, left)), generator=gen,
                               dtype=F32, device=device)
            used = 0
        left -= n
        flat[path] = _init(init, pool[used:used + n], shape).to(dtype)
        used += n
    del pool
    return unflatten(flat)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def attention(h: torch.Tensor, p: Dict, s: Shape,
              prec: Precision) -> torch.Tensor:
    """Causal GQA self-attention with no positional encoding."""
    B, S, _ = h.shape
    q = mm(h, p["wq"], prec).view(B, S, s.Hq, s.D)
    k = mm(h, p["wk"], prec).view(B, S, s.Hkv, s.D)
    v = mm(h, p["wv"], prec).view(B, S, s.Hkv, s.D)
    G = s.Hq // s.Hkv
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), prec) \
        * s.D ** -0.5                                    # (B, H, S, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(scores, -1), v.transpose(1, 2), prec)
    return mm(o.transpose(1, 2).reshape(B, S, s.Hq * s.D), p["wo"], prec)


def mamba(h: torch.Tensor, p: Dict, s: Shape,
          prec: Precision) -> torch.Tensor:
    """Mamba-1 with Jamba's dt, B and C norms, scanned one step at a
    time from a zero state."""
    B, S, _ = h.shape
    xz = mm(h, p["in_proj"], prec)
    x, z = xz[..., :s.Ei], xz[..., s.Ei:]
    w = p["conv_w"].float()                              # (K, Ei)
    xp = torch.cat([x.new_zeros(B, s.K - 1, s.Ei), x], dim=1)
    conv = sum(xp[:, j:j + S] * w[j] for j in range(s.K))
    x = torch.nn.functional.silu(conv + p["conv_b"].float())
    dbc = mm(x, p["x_proj"], prec)
    dt = rms(dbc[..., :s.R], p["dt_norm"], s.eps)
    Bm = rms(dbc[..., s.R:s.R + s.N], p["b_norm"], s.eps)
    Cm = rms(dbc[..., s.R + s.N:], p["c_norm"], s.eps)
    dt = torch.nn.functional.softplus(mm(dt, p["dt_proj"], prec)
                                      + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                   # (Ei, N)
    state = x.new_zeros(B, s.Ei, s.N)
    ys = []
    for t in range(S):
        d = dt[:, t, :, None]
        state = torch.exp(d * A) * state \
            + d * Bm[:, t, None, :] * x[:, t, :, None]
        ys.append(torch.einsum("ben,bn->be", state, Cm[:, t]))
    y = torch.stack(ys, dim=1) + x * p["D"].float()
    y = y * torch.nn.functional.silu(z)
    return mm(y, p["out_proj"], prec)


def experts(x: torch.Tensor, p: Dict, s: Shape,
            prec: Precision) -> torch.Tensor:
    """The held experts' part of a top-k routed SwiGLU layer: softmax
    over all `s.routed` router logits in float32, each token's k largest
    probabilities (ties: lower index first) as its weights, not
    renormalised; dropless."""
    B, S, E = x.shape
    t = x.reshape(-1, E)
    probs = torch.softmax(mm(t, p["router"], F32_REF), -1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :s.top_k], top_i[:, :s.top_k]
    first, count = s.held
    y = torch.zeros_like(t)
    for e in range(count):
        rows, slot = torch.nonzero(top_i == first + e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(t[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                     prec)
        y = y.index_add(0, rows, out * top_w[rows, slot][:, None])
    return y.view(B, S, E)


def forward(params: Dict, tokens: torch.Tensor, s: Shape,
            prec: Precision = F32_REF) -> torch.Tensor:
    """Logits (B, S, V) in float32 of tokens (B, S)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = params["embed"][tokens.long()].float()
    for i in range(s.L):
        lp = params["layers"][str(i)]
        h = rms(x, lp["norm1"]["scale"], s.eps)
        x = x + (attention(h, lp["attn"], s, prec) if s.attention(i)
                 else mamba(h, lp["mamba"], s, prec))
        h = rms(x, lp["norm2"]["scale"], s.eps)
        f = lp["ffn"]
        x = x + (experts(h, f, s, prec) if s.experts(i) else
                 swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec))
    x = rms(x, params["final_norm"]["scale"], s.eps)
    return mm(x, params["lm_head"], prec)


# ---------------------------------------------------------------------------
# serving: how far below the best token each served token lies
# ---------------------------------------------------------------------------

def served_scores(params: Dict, s: Shape, seqs: torch.Tensor, prompt: int,
                  logits: Optional[torch.Tensor] = None,
                  prec: Optional[Precision] = None,
                  slots: Optional[Sequence[int]] = None
                  ) -> Tuple[float, Optional[float], Optional[float]]:
    """(token gap, logit error, slot error) of served tokens against this
    reference's full forward pass: `model.served_scores`, whose
    docstring defines each, with Jamba's forward."""
    with torch.no_grad():
        ref = forward(params, seqs[:, :-1], s)[:, prompt - 1:]
        chosen = seqs[:, prompt:].long()
        if prec is not None:
            logits = forward(params, seqs[:, :-1], s, prec)[:, prompt - 1:]
            chosen = logits.argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, chosen[..., None])[..., 0]
        err = slot = None
        if logits is not None:
            e = (torch.linalg.vector_norm(logits.float() - ref, dim=-1)
                 / torch.linalg.vector_norm(ref, dim=-1))
            err = float(e.median())
            if slots is not None:
                at = torch.as_tensor(list(slots), device=e.device)
                slot = max(float(e[at == k].median()) for k in set(slots))
        return float(gap.max()), err, slot


# ---------------------------------------------------------------------------
# work counted from shapes
# ---------------------------------------------------------------------------

def decode_step_flops(s: Shape, batch: int, positions: Sequence[int]
                      ) -> float:
    """One decode step of `batch` tokens, each at its position (keys
    attended: position + 1): two operations per multiply-add of every
    matrix product (`counts`' convention; the conv, the scan and the
    norms are element-wise and left out).  An expert layer counts its
    router and this chip's expected share of the routed work: top_k x
    held / routed experts a token."""
    attn = 2 * s.E * (s.Hq + 2 * s.Hkv) * s.D + 2 * s.Hq * s.D * s.E
    mamba_ = 2 * s.E * 2 * s.Ei + 2 * s.Ei * (s.R + 2 * s.N) \
        + 2 * s.R * s.Ei + 2 * s.Ei * s.E
    ffn = 3 * 2 * s.E * s.F
    moe = 2 * s.E * s.routed + s.top_k * s.held[1] / s.routed * ffn
    n_attn = sum(s.attention(i) for i in range(s.L))
    n_moe = sum(s.experts(i) for i in range(s.L))
    per_token = n_attn * attn + (s.L - n_attn) * mamba_ \
        + n_moe * moe + (s.L - n_moe) * ffn + 2 * s.E * s.V
    keys = sum(p + 1 for p in positions)
    return float(batch * per_token + n_attn * 2 * 2 * s.Hq * s.D * keys)
