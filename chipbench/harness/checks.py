"""Pieces of the comparison that decides `correct`, shared by the
drivers.  Every number compared is held to a limit of its own, from the
cell's limits file (`chipbench/limits/<cell>.json`)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..reference import digest as spec


def raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in C order, on the host."""
    t = t.detach().contiguous()
    return t.reshape(-1).view(torch.uint8).cpu().numpy()


def flat_leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} with Chipmink's path keys ("a/b/c"); a flat dict of
    such keys comes back as it is."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def same(a: Any, b: Any) -> bool:
    """Equal bits (tensors, compared where they lie) or equal values."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        bits = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in (a, b)]
        return torch.equal(bits[0], bits[1].to(bits[0].device))
    return type(a) is type(b) and a == b


def tree_mismatches(got: Any, want: Any) -> int:
    """Leaves of `want` that `got` lacks or holds with other bits, plus
    leaves `got` has beyond `want`."""
    g, w = flat_leaves(got), flat_leaves(want)
    return sum(1 for k in w if k not in g or not same(g[k], w[k])) + \
        sum(1 for k in g if k not in w)


def digest_mismatches(manifest: Dict, leaves: Dict[str, torch.Tensor],
                      chunk_bytes: int, pick: Callable[[str, int],
                                                       Iterable[int]]
                      ) -> Tuple[int, int]:
    """(chunks checked, chunks whose committed digest is not the spec's
    digest of the bytes they stand for).  `leaves` are the tensor leaves
    the commit holds; `pick(key, n_chunks)` chooses which chunks of a
    leaf to check.  A leaf the manifest has no digests for counts as
    one mismatch."""
    table = manifest["chunks"]
    checked = bad = 0
    for key, t in sorted(leaves.items()):
        blob = table.get(key)
        size, item = t.numel() * t.element_size(), t.element_size()
        n = spec.n_chunks_of(size, item, chunk_bytes)
        if blob is None or len(blob) != n * spec.DIGEST_BYTES:
            bad += 1
            continue
        idx = sorted(set(pick(key, n)))
        if len(idx) == n:
            want = spec.chunk_digests(raw_bytes(t), item, chunk_bytes, idx)
        else:
            step = spec.chunk_step(size, item, chunk_bytes)
            flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
            want = {ci: spec.digest_bytes(
                flat[ci * step:min(size, (ci + 1) * step)].cpu().numpy())
                for ci in idx}
        for ci in idx:
            checked += 1
            got = bytes(blob[ci * spec.DIGEST_BYTES:
                             (ci + 1) * spec.DIGEST_BYTES])
            bad += got != want[ci]
    return checked, bad


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keys: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    keys = sorted(ref) if keys is None else keys
    norms = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in ref}
    med = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k].float()))
                   - norms[k]) / max(norms[k], med) for k in keys)


def moved(ref_grad: Dict[str, torch.Tensor], share: float = 1e-3
          ) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm
    of at least `share` of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.float()))
             for k, v in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    return sorted(k for k, n in norms.items() if n >= share * med)


class Checks:
    """Numbers compared, each beside its limit."""

    def __init__(self, limits: Dict[str, float]) -> None:
        self.limits = limits
        self.items: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, value: float) -> None:
        self.items[name] = {"value": value, "limit": self.limits[name]}

    @property
    def correct(self) -> bool:
        return bool(self.items) and set(self.items) == set(self.limits) \
            and all(v["value"] <= v["limit"] for v in self.items.values())
