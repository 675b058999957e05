"""Work that a step or a save requires, counted from shapes alone.

Nothing here looks at how the program does the work: a kernel's row
table, a dense expert dispatch or a backward pass through frozen layers
are the program's choices, and the counts stay the same whatever
implements them.  Matrix products count two operations per multiply-add;
element-wise work (norms, softmax, the optimizer) is left out, as model
FLOPs leave it out.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from . import peaks
from .digest import DIGEST_BYTES, chunk_grid
from .model import Shape

#: digest instructions: one multiply-add per word and lane; a lane
#: weight mix32(i * A + seed + salt) per word position and lane, once
#: whatever the row count: a multiply-add and mix32's eight
OPS_PER_WORD_LANE = 1
OPS_PER_WEIGHT = 9
#: per chunk besides its bytes: the previous digest read, the new digest
#: and a 4-byte dirty flag written
PER_CHUNK_BYTES = DIGEST_BYTES + DIGEST_BYTES + 4


def digest_work(leaves: Iterable[Tuple[int, int]],
                chunk_bytes: int) -> Tuple[int, int]:
    """(bytes, integer instructions) that digesting and comparing every
    chunk of `leaves` ((nbytes, itemsize) each) needs."""
    nbytes = ops = 0
    widest = 0
    for size, itemsize in leaves:
        elems, n = chunk_grid(max(1, size // itemsize), itemsize, chunk_bytes)
        words = -(-min(size, elems * itemsize) // 4)
        widest = max(widest, words)
        nbytes += size + n * PER_CHUNK_BYTES
        ops += -(-size // 4) * 4 * OPS_PER_WORD_LANE
    ops += widest * 4 * OPS_PER_WEIGHT
    return nbytes, ops


def digest_bound_s(nbytes: int, ops: int) -> float:
    """The least time one digest pass can take on the card."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT32_OPS_PER_S)


def _layer_matmul_flops(s: Shape) -> Tuple[int, int]:
    """(FLOPs per token of one layer's projections and FFN, of which the
    attention input projections)."""
    qkv = 2 * s.E * (s.Hq + 2 * s.Hkv) * s.D
    o = 2 * s.Hq * s.D * s.E
    if s.experts:
        ffn = 2 * s.E * s.experts + s.top_k * 3 * 2 * s.E * s.F
    else:
        ffn = 3 * 2 * s.E * s.F
    return qkv + o + ffn, qkv


def _attn_flops(s: Shape, pairs: int) -> int:
    """Scores and weighted sum of one layer over `pairs` (query, key)
    pairs."""
    return 2 * 2 * s.Hq * s.D * pairs


def train_step_flops(s: Shape, batch: int, seq: int,
                     trained_layers: Sequence[int], trained_head: bool,
                     trained_norm: bool) -> float:
    """A training step on (batch, seq) tokens with only
    `trained_layers` (and the final norm / tied head as flagged)
    trained: every layer forward, and backward only as far down as the
    lowest trained layer."""
    tokens = batch * seq
    pairs = batch * seq * (seq + 1) // 2
    layer, qkv = _layer_matmul_flops(s)
    head = 2 * s.E * s.V * tokens
    fwd = s.L * (layer * tokens + _attn_flops(s, pairs)) + head
    bwd = 0
    lowest = min(trained_layers) if trained_layers else s.L
    if trained_layers or trained_norm or trained_head:
        if lowest < s.L or trained_norm:
            bwd += head                          # into the final norm
        if trained_head:
            bwd += head                          # the tied head's weight
        for i in range(lowest, s.L):
            bwd += 2 * _attn_flops(s, pairs)     # dQ, dK, dV, dP
            bwd += layer * tokens                # into each projection
            if i == lowest:
                bwd -= qkv * tokens              # nothing trains below
            if i in trained_layers:
                bwd += layer * tokens            # the weights' own
    return float(fwd + bwd)


def decode_step_flops(s: Shape, batch: int, positions: Iterable[int]
                      ) -> float:
    """One decode step of `batch` tokens, each at its position (keys
    attended: position + 1)."""
    layer, _ = _layer_matmul_flops(s)
    total = batch * (s.L * layer + 2 * s.E * s.V)
    total += s.L * _attn_flops(s, sum(p + 1 for p in positions))
    return float(total)
