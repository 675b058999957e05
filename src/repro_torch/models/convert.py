"""Carry a parameter or cache tree across from numpy: the reference's
arrays (`np.asarray` of each leaf) become the port's tensors, bit for bit,
with tied leaves kept as one tensor.

numpy has no bfloat16 of its own: the reference's bf16 arrays carry the
`ml_dtypes` type, which is read here by its *name* and reinterpreted
through its uint16 bits, so the port never imports `ml_dtypes`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a: Any, device: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device: Any) -> Any:
    """Map every numpy leaf (array or numpy scalar) of a nested dict to a
    tensor on `device`; a leaf object met twice maps to one tensor."""
    memo: Dict[int, torch.Tensor] = {}

    def conv(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (np.ndarray, np.generic)):
            if id(t) not in memo:
                memo[id(t)] = _tensor(t, device)
            return memo[id(t)]
        return t

    return conv(tree)


#: a cache is the same kind of tree (K/V in bf16, ``pos`` a 0-d int32)
cache_from_numpy = params_from_numpy
