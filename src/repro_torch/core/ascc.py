"""Allowlist-based static code checker (paper §6.3), on a functionalized
graph of the step.  The port of `repro.core.ascc`, which reads a jaxpr.

The step is traced with `make_fx(tracing_mode="fake")` (shapes and
dtypes, no data: no device memory, no device sync), autograd's backward
included, and the aten graph is traced again through
`torch.func.functionalize`, which turns every in-place write into a pure
op and writes each changed input back with a final ``copy_``; a graph
with no op that may write is its own functionalization and is kept as it
is.  A state leaf is *provably unchanged* when

  * its output traces back to its own input placeholder through
    value-preserving ops only (`alias`, `detach`, `clone`,
    `lift_fresh_copy`, a same-dtype same-device `_to_copy`, a same-shape
    `view`, `reshape` or `_unsafe_view`), and
  * nothing writes into it: the functionalized graph writes into no input
    on its storage (a ``copy_`` back, directly or through a view of it or
    of another leaf on that storage), and the step did not swap the
    leaf's storage or layout (``.data = ...``), which no graph records.

The second condition is the torch-only hazard: a step that changes
``state["w"]`` in place and returns the same object has rewritten it.
Like the paper's ASCC this is conservative: 100% precision (a leaf
declared read-only truly is), recall < 100% (a leaf rewritten with
identical values still counts as written).

Leaves are matched by path, with the reference's sorted-key flatten
(`_flatten_paths`).  As under `jax.make_jaxpr`, Python scalars and numpy
arrays among the arguments are traced as tensors; other non-tensor leaves
raise `TypeError`, and ``None`` is no leaf.

Uses: (1) the active-variable filter skips read-only leaves entirely;
(2) async saving may safely donate/overwrite buffers of leaves the next
execution provably does not rewrite (§6.2's lock analogue).
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import make_fx

from ..train.tree import tree_leaves_with_paths, tree_map

_PASS_THROUGH = {"alias", "detach", "clone", "lift_fresh_copy"}
_SAME_SHAPE = {"view", "reshape", "_unsafe_view"}


def _flatten_paths(tree: Any) -> List[str]:
    """Path strings for tree leaves, mirroring graph._flatten_with_paths."""
    return [p for p, _ in tree_leaves_with_paths(tree)]


def _as_traced(leaf: Any) -> Any:
    """What a jaxpr trace would see: tensors as they are, Python scalars
    and numpy values as tensors, None as no leaf."""
    if leaf is None or isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (bool, int, float, np.ndarray, np.generic)):
        return torch.as_tensor(leaf)
    raise TypeError(f"the static checker cannot trace a leaf of type "
                    f"{type(leaf).__name__}")


def _layout(t: torch.Tensor) -> Tuple:
    return (t.untyped_storage()._cdata, t.shape, t.stride(),
            t.storage_offset(), t.dtype)


class _Trace:
    """The functionalized graph of `step_fn(*args)`, its inputs being every
    distinct tensor of `args` in flatten order (`flat`; `traced` is `args`
    holding them), its outputs the leaves of the new state (`out_paths`).
    `swapped` holds the inputs whose storage or layout the step changed
    outside any op."""

    def __init__(self, step_fn: Callable, args: Tuple[Any, ...]) -> None:
        memo: Dict[int, torch.Tensor] = {}
        self.flat: List[torch.Tensor] = []

        def collect(leaf: Any) -> Any:
            t = _as_traced(leaf)
            if t is None:
                return None
            if id(leaf) not in memo:
                memo[id(leaf)] = t
                self.flat.append(t)
            return memo[id(leaf)]

        self.traced = tree_map(collect, args)
        index = {id(t): i for i, t in enumerate(self.flat)}
        self.out_paths: List[str] = []
        self.swapped: Set[int] = set()

        def flat_fn(*xs: torch.Tensor) -> List[Any]:
            before = [_layout(x) for x in xs]
            out = step_fn(*tree_map(
                lambda t: None if t is None else xs[index[id(t)]],
                self.traced))
            self.swapped |= {i for i, x in enumerate(xs)
                             if _layout(x) != before[i]}
            new_state = out[0] if isinstance(out, (list, tuple)) else out
            leaves = tree_leaves_with_paths(new_state)
            self.out_paths = [p for p, _ in leaves]
            return [v for _, v in leaves]

        gm = make_fx(flat_fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*self.flat)
        # a graph with no op that may write is its own functionalization
        if any(_may_write(n) for n in gm.graph.nodes):
            gm = make_fx(torch.func.functionalize(gm, remove="mutations"),
                         tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*self.flat)
        self.graph = gm.graph
        nodes = list(self.graph.nodes)
        self.inputs = {n: i for i, n in
                       enumerate(n for n in nodes if n.op == "placeholder")}
        self.outputs = list(nodes[-1].args[0])

    def written(self) -> Set[int]:
        """Inputs some op of the functionalized graph writes into (its
        ``copy_`` backs), and those the step swapped."""
        out = set(self.swapped)
        for n in self.graph.nodes:
            if n.op != "call_function" or \
                    not isinstance(n.target, torch._ops.OpOverload):
                continue
            for arg, v in zip(n.target._schema.arguments, n.args):
                if arg.alias_info is not None and arg.alias_info.is_write \
                        and v in self.inputs:
                    out.add(self.inputs[v])
        return out

    def source(self, node: Any) -> Optional[int]:
        """The input whose value `node` is, through value-preserving ops,
        or None."""
        while isinstance(node, fx.Node) and node.op == "call_function":
            src = node.args[0] if node.args else None
            if not isinstance(src, fx.Node) or not _passes_value(node, src):
                return None
            node = src
        return self.inputs.get(node)


def _may_write(node: fx.Node) -> bool:
    """A call that may write into a tensor: an aten op whose schema marks
    an argument as written, or any call but an aten op or `getitem`."""
    if node.op != "call_function" or node.target is operator.getitem:
        return False
    if not isinstance(node.target, torch._ops.OpOverload):
        return True
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in node.target._schema.arguments)


def _passes_value(node: fx.Node, src: fx.Node) -> bool:
    target = node.target
    if not isinstance(target, torch._ops.OpOverload):
        return False
    name = target.overloadpacket.__name__
    out, inp = node.meta.get("val"), src.meta.get("val")
    if not isinstance(out, torch.Tensor) or not isinstance(inp, torch.Tensor):
        return False
    if name in _PASS_THROUGH:
        return True
    if name == "_to_copy":
        return out.dtype == inp.dtype and out.device == inp.device
    return name in _SAME_SHAPE and out.shape == inp.shape


def readonly_state_leaves(step_fn: Callable, state: Any, *rest: Any,
                          state_argnum: int = 0) -> Set[str]:
    """Leaf paths of `state` that `step_fn` provably returns unchanged.

    Convention: `step_fn(state, *rest)` returns the new state as its first
    output (or as the whole output); the leaves checked are those of
    argument `state_argnum`."""
    args = (state,) + tuple(rest)
    tr = _Trace(step_fn, args)
    outs = dict(zip(tr.out_paths, tr.outputs))
    # inputs are traced one by one: a write into one counts for every
    # leaf on the same real storage (a view of it, say)
    written = {_storage(tr.flat[i]) for i in tr.written()}
    index = {id(t): i for i, t in enumerate(tr.flat)}

    readonly: Set[str] = set()
    for path, leaf in tree_leaves_with_paths(tr.traced[state_argnum]):
        if leaf is None:
            continue
        if tr.source(outs.get(path)) == index[id(leaf)] \
                and _storage(leaf) not in written:
            readonly.add(path)
    return readonly


def _storage(t: torch.Tensor) -> Tuple[torch.device, int]:
    return t.device, t.untyped_storage().data_ptr()


def is_static_execution(step_fn: Callable, state: Any, *rest: Any) -> bool:
    """Paper §6.3: an execution is *static* iff it provably rewrites no
    state leaf — safe to run concurrently with an in-flight save."""
    ro = readonly_state_leaves(step_fn, state, *rest)
    paths = set(_flatten_paths(state))
    return ro == paths


# ---------------------------------------------------------------------------
# Host-side allowlist (the paper's original AST-level checker), applied to
# plain-python host callbacks (data-pipeline peeks, logging) which have no
# traced graph.  Prepopulated with definitely-static operations.
# ---------------------------------------------------------------------------

STATIC_HOST_ALLOWLIST = {
    "len", "repr", "str", "print", "sum", "min", "max", "peek", "describe",
}


def host_call_is_static(op_name: str,
                        allowlist: Optional[Set[str]] = None) -> bool:
    allow = allowlist if allowlist is not None else STATIC_HOST_ALLOWLIST
    return op_name in allow
