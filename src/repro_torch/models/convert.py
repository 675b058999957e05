"""Carry a parameter, cache or train-state tree across from numpy: the
reference's arrays (`np.asarray` of each leaf) become the port's tensors,
bit for bit, with tied leaves kept as one tensor.

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


def train_state_from_numpy(tree: Any, device: Any) -> Dict:
    """The port's TrainState from a reference TrainState as numpy, or from
    a Chipmink load of one: ``params``, ``opt`` (AdamW ``mu``/``nu`` or
    Adafactor ``vr``/``vc``/``v``) and ``ef`` (if present) on `device`,
    and ``step`` as a 0-d int32 tensor.  Other keys (a saved ``data``
    cursor) are left out."""
    def put(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        return t.to(device) if isinstance(t, torch.Tensor) else t

    state = {k: put(params_from_numpy(tree[k], device))
             for k in ("params", "opt", "ef") if k in tree}
    state["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32,
                                 device=device)
    return state
