"""The plain reference of the benchmark's decoder models, in float32.

Plain PyTorch: no kernel, cache, batching trick or graph of the program,
and nothing imported from it.  It follows the published decoder (RMSNorm,
rotary embeddings, grouped-query causal attention, SwiGLU or top-k
routed SwiGLU experts, a tied or untied head) with the departures each
configuration file lists, which the program shares:

- the input embedding is multiplied by sqrt(hidden_size);
- an RMSNorm's weight is stored as an offset from 1 (``1 + scale``);
- Granite's embedding, attention, residual and logit multipliers are
  left out;
- the experts are dropless: every token reaches each of its top-k.

Every matrix product runs in float32 with TF32 off, unless `Precision`
asks for the control's lower precision: float8 (e4m3) operands, each
tensor scaled by its largest magnitude, products summed in float32.

The parameter tree has the paths and dtypes the program's models take
(bf16 weights, float32 norm scales and router), so the same tensors,
made from the seed by `make_params`, are handed to both sides.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

F32 = torch.float32
BF16 = torch.bfloat16
#: largest finite float8 e4m3 value
E4M3_MAX = 448.0
#: normal draws one call of `make_params` makes at most
DRAW_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes of a decoder, read from a configuration file."""
    L: int
    E: int
    Hq: int
    Hkv: int
    D: int
    F: int
    V: int
    theta: float
    eps: float
    tied: bool
    qkv_bias: bool
    experts: int = 0
    top_k: int = 0

    @classmethod
    def of(cls, cfg: Dict) -> "Shape":
        arch = cfg.get("architecture", {})
        return cls(L=cfg["num_hidden_layers"], E=cfg["hidden_size"],
                   Hq=cfg["num_attention_heads"],
                   Hkv=cfg["num_key_value_heads"],
                   D=cfg["hidden_size"] // cfg["num_attention_heads"],
                   F=cfg["intermediate_size"], V=cfg["vocab_size"],
                   theta=float(cfg["rope_theta"]),
                   eps=float(cfg["rms_norm_eps"]),
                   tied=bool(cfg["tie_word_embeddings"]),
                   qkv_bias=bool(arch.get("qkv_bias", False)),
                   experts=int(cfg.get("num_local_experts", 0)),
                   top_k=int(cfg.get("num_experts_per_tok", 0)))


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference multiplies: ``"f32"`` (the reference) or
    ``"fp8"`` (the control)."""
    matmul: str = "f32"


F32_REF = Precision()
FP8_CONTROL = Precision("fp8")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(s: Shape) -> List[Tuple[str, Tuple[int, ...], torch.dtype,
                                         str]]:
    """(path, shape, dtype, init) of every parameter, in sorted path
    order; init is ``normal`` (scaled by 1/sqrt of the contracted
    dimension), ``embed`` (1/sqrt(hidden)) or ``zeros``."""
    out = [("embed", (s.V, s.E), BF16, "embed"),
           ("final_norm/scale", (s.E,), F32, "zeros")]
    if not s.tied:
        out.append(("lm_head", (s.E, s.V), BF16, "normal"))
    for i in range(s.L):
        p = f"layers/{i}/"
        out += [(p + "norm1/scale", (s.E,), F32, "zeros"),
                (p + "norm2/scale", (s.E,), F32, "zeros"),
                (p + "attn/wq", (s.E, s.Hq * s.D), BF16, "normal"),
                (p + "attn/wk", (s.E, s.Hkv * s.D), BF16, "normal"),
                (p + "attn/wv", (s.E, s.Hkv * s.D), BF16, "normal"),
                (p + "attn/wo", (s.Hq * s.D, s.E), BF16, "normal")]
        if s.qkv_bias:
            out += [(p + "attn/bq", (s.Hq * s.D,), BF16, "zeros"),
                    (p + "attn/bk", (s.Hkv * s.D,), BF16, "zeros"),
                    (p + "attn/bv", (s.Hkv * s.D,), BF16, "zeros")]
        if s.experts:
            X = s.experts
            out += [(p + "ffn/router", (s.E, X), F32, "normal"),
                    (p + "ffn/w_gate", (X, s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_up", (X, s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_down", (X, s.F, s.E), BF16, "normal")]
        else:
            out += [(p + "ffn/w_gate", (s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_up", (s.E, s.F), BF16, "normal"),
                    (p + "ffn/w_down", (s.F, s.E), BF16, "normal")]
    return sorted(out)


def make_params(s: Shape, seed: int, device) -> Dict:
    """The parameter tree from `seed`, on `device`: float32 normal draws
    from one generator on the device, at most `DRAW_ELEMS` a call, each
    leaf a scaled slice cast to its dtype.  The same seed gives the same
    bits on the same kind of device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat: Dict[str, torch.Tensor] = {}
    pool = torch.empty(0, dtype=F32, device=device)
    used = 0
    shapes = param_shapes(s)
    left = sum(math.prod(sh) for _, sh, _, init in shapes if init != "zeros")
    for path, shape, dtype, init in shapes:
        n = math.prod(shape)
        if init == "zeros":
            flat[path] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if used + n > pool.numel():
            pool = torch.randn(max(n, min(DRAW_ELEMS, left)), generator=gen,
                               dtype=F32, device=device)
            used = 0
        left -= n
        scale = 1.0 / math.sqrt(shape[-1] if init == "embed"
                                else shape[-2])
        flat[path] = (pool[used:used + n].view(shape) * scale).to(dtype)
        used += n
    del pool
    return unflatten(flat)


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        cur = out
        *head, last = path.split("/")
        for k in head:
            cur = cur.setdefault(k, {})
        cur[last] = v
    return out


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        p = prefix + k
        if isinstance(v, dict):
            out.update(flatten(v, p + "/"))
        else:
            out[p] = v
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor,
    back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    a, b = a.float(), b.float()
    if prec.matmul == "fp8":
        a, b = _fp8(a), _fp8(b)
    return torch.matmul(a, b)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half pairs; x (B, S, H, D) at positions
    0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=F32,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(h: torch.Tensor, p: Dict, s: Shape,
              prec: Precision) -> torch.Tensor:
    B, S, _ = h.shape
    q, k, v = (mm(h, p[w], prec) for w in ("wq", "wk", "wv"))
    if s.qkv_bias:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), \
            v + p["bv"].float()
    q = rope(q.view(B, S, s.Hq, s.D), s.theta)
    k = rope(k.view(B, S, s.Hkv, s.D), s.theta)
    v = v.view(B, S, s.Hkv, s.D)
    G = s.Hq // s.Hkv
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), prec) \
        * s.D ** -0.5                                    # (B, H, S, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(scores, -1), v.transpose(1, 2), prec)
    return mm(o.transpose(1, 2).reshape(B, S, s.Hq * s.D), p["wo"], prec)


def swiglu(x: torch.Tensor, wg, wu, wd, prec: Precision) -> torch.Tensor:
    g = mm(x, wg, prec)
    return mm(torch.nn.functional.silu(g) * mm(x, wu, prec), wd, prec)


def experts(x: torch.Tensor, p: Dict, s: Shape,
            prec: Precision) -> torch.Tensor:
    """Top-k routed SwiGLU experts, dropless: each token's k largest
    router probabilities (ties: lower index first), renormalised to sum
    to one, weight its experts' outputs."""
    B, S, E = x.shape
    t = x.reshape(-1, E)
    probs = torch.softmax(mm(t, p["router"], F32_REF), -1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True,
                               stable=True)
    top_w, top_i = top_w[:, :s.top_k], top_i[:, :s.top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(t)
    for e in range(s.experts):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
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
    x = params["embed"][tokens.long()].float() * math.sqrt(s.E)
    for i in range(s.L):
        lp = params["layers"][str(i)]
        x = x + attention(rms(x, lp["norm1"]["scale"], s.eps), lp["attn"],
                          s, prec)
        h = rms(x, lp["norm2"]["scale"], s.eps)
        f = lp["ffn"]
        x = x + (experts(h, f, s, prec) if s.experts else
                 swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec))
    x = rms(x, params["final_norm"]["scale"], s.eps)
    head = params["embed"].T if s.tied else params["lm_head"]
    return mm(x, head, prec)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


# ---------------------------------------------------------------------------
# serving: how far below the best token each served token lies
# ---------------------------------------------------------------------------

def served_scores(params: Dict, s: Shape, seqs: torch.Tensor, prompt: int,
                  logits: Optional[torch.Tensor] = None,
                  prec: Optional[Precision] = None,
                  slots: Optional[Sequence[int]] = None
                  ) -> Tuple[float, Optional[float], Optional[float]]:
    """seqs (N, prompt + G): prompts and the G tokens served after them;
    `logits` (N, G, V): the logits each served token was chosen from;
    `slots` (N): the batch slot each request was served in.  Returns
    (token gap, logit error, slot error):

    - token gap: the widest gap, over the served tokens, by which a
      token's logit in the reference's full forward pass lies below the
      reference's best logit at its position;
    - logit error: the median, over the served positions, of the
      distance between `logits` and the reference's logits there, as a
      share of the reference's (L2 norms over the vocabulary); None
      without `logits`.  The median and not the largest: where two
      experts' router scores lie within rounding of each other, a
      token's expert choice flips, and with it that position's logits,
      on one position in some hundreds;
    - slot error: the same median over the positions of each slot's
      requests, for the worst slot; None without `logits` or `slots`.
      A fault confined to one slot of the batch moves every position of
      its requests, which a median over all positions does not see.

    With `prec` (the control) the tokens and logits scored are those the
    reference computes in `prec` at each position of the same prompts
    and tokens: the control need not decode."""
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
# training: the first steps of AdamW with clipping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip_norm: float


def train_steps(params: Dict, batches: Sequence[Dict], s: Shape,
                trained: Sequence[str], opt: AdamW,
                prec: Precision = F32_REF, rows: Optional[int] = None,
                moments: Optional[Tuple[Dict, Dict]] = None, count0: int = 0
                ) -> Dict:
    """AdamW steps on `batches` ({"tokens", "labels"} (B, S) each),
    training only the leaves whose path starts with one of `trained`.
    Weights are stored in their own dtype (bf16) after each update; the
    step computes in float32, or in `prec`.  With `rows`, only the first
    `rows` rows of each batch count (a planted fault).  The optimizer
    starts from zero moments after no step, or from `moments` ({leaf:
    first}, {leaf: second}) after `count0` steps.  Returns each step's
    loss, each trained leaf's first clipped gradient, and its change
    over all the steps, in float32."""
    flat = flatten(params)
    keys = sorted(k for k in flat
                  if any(k == t or k.startswith(t + "/") for t in trained))
    start = {k: flat[k].detach().float().clone() for k in keys}
    if moments is None:
        mu = {k: torch.zeros_like(start[k]) for k in keys}
        nu = {k: torch.zeros_like(start[k]) for k in keys}
    else:
        mu, nu = ({k: m[k].float() for k in keys} for m in moments)
    live = dict(flat)
    losses: List[float] = []
    first_grad: Dict[str, torch.Tensor] = {}
    for t, batch in enumerate(batches):
        leaves = {k: live[k].detach().float().requires_grad_(True)
                  for k in keys}
        tree = unflatten({**{k: v for k, v in live.items()
                             if k not in leaves}, **leaves})
        tok, lab = batch["tokens"], batch["labels"]
        if rows is not None:
            tok, lab = tok[:rows], lab[:rows]
        loss = cross_entropy(forward(tree, tok, s, prec), lab)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = torch.clamp(opt.clip_norm / (norm + 1e-9), max=1.0)
        count = count0 + t + 1
        for k, g in zip(keys, grads):
            g = g * clip
            if t == 0:
                first_grad[k] = g.detach()
            mu[k] = opt.b1 * mu[k] + (1 - opt.b1) * g
            nu[k] = opt.b2 * nu[k] + (1 - opt.b2) * g * g
            u = (mu[k] / (1 - opt.b1 ** count)) / (
                torch.sqrt(nu[k] / (1 - opt.b2 ** count)) + opt.eps)
            p = live[k].float()
            live[k] = (p - opt.lr * (u + opt.weight_decay * p)).to(
                flat[k].dtype).detach()
    change = {k: live[k].float() - start[k] for k in keys}
    return {"losses": losses, "grad": first_grad, "change": change,
            "keys": keys}
