"""ObjectGraph over torch/numpy state trees (paper §3.3).

The paper's object graph G = (U, E, V, l) is re-instantiated for distributed
training state:

  * interior pytree nodes (dicts / lists / tuples / dataclass-likes) are
    *container* nodes,
  * array leaves are *leaf* nodes carrying shape/dtype metadata,
  * large arrays are further decomposed into *chunk* nodes — a deterministic
    row-block grid aligned to the target pod payload size — because a single
    embedding table is itself a "massive subgraph" whose rows mutate sparsely,
  * shared references (tied weights, aliased subtrees) are detected by object
    identity and represented as *alias* leaf nodes pointing at the canonical
    occurrence, exactly the cross-pod reference problem §4.1 solves with the
    virtual memo space.

Node identity is *path based* (stable across executions — what makes podding
stability §7.3 and change detection §4.2 possible); alias nodes additionally
record the canonical path.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]

# Node kinds
CONTAINER = "container"
LEAF = "leaf"          # array leaf metadata node (children = its chunks)
CHUNK = "chunk"        # payload node: a row-block of a leaf
ALIAS = "alias"        # shared reference to a canonical leaf
SCALAR = "scalar"      # python scalar / small host object (int step counters...)

#: structural overhead charged to non-payload nodes when sizing pods (bytes)
STRUCT_SIZE = 64


def path_str(path: Path) -> str:
    return "/".join(path)


@dataclasses.dataclass
class Node:
    """A node u in the ObjectGraph."""

    node_id: int
    path: Path
    kind: str
    size: int                       # s(u), bytes
    children: List[int] = dataclasses.field(default_factory=list)
    # leaf metadata
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[str] = None
    chunk_rows: int = 0             # elems per chunk in the flat-range grid
    chunk_index: int = -1           # for CHUNK nodes
    alias_of: Optional[Path] = None # for ALIAS nodes
    value: Any = None               # for SCALAR nodes (picklable python scalar)

    @property
    def key(self) -> str:
        if self.kind == CHUNK:
            return f"{path_str(self.path)}#[{self.chunk_index}]"
        return path_str(self.path)


def _is_arraylike(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype") and hasattr(x, "nbytes")


#: canonical (numpy) dtype name of every torch dtype a leaf may carry —
#: the string written into manifests, plans and pods, so that both
#: packages write the same bytes for the same state.
_TORCH_DTYPE_NAMES = {
    torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
    torch.int16: "int16", torch.uint16: "uint16", torch.int32: "int32",
    torch.uint32: "uint32", torch.int64: "int64", torch.uint64: "uint64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_TORCH_DTYPES = {name: dt for dt, name in _TORCH_DTYPE_NAMES.items()}


def dtype_name(dtype: Any) -> str:
    """Canonical dtype name of a torch or numpy dtype ("bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_DTYPE_NAMES[dtype]
        except KeyError:
            raise TypeError(f"unsupported leaf dtype {dtype}") from None
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a canonical dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}") from None


def itemsize_of(dtype: Any) -> int:
    """Bytes per element of a torch dtype, numpy dtype or dtype name.
    Names of torch dtypes resolve without numpy, which has no bfloat16 of
    its own."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if isinstance(dtype, str) and dtype in _TORCH_DTYPES:
        return _TORCH_DTYPES[dtype].itemsize
    return np.dtype(dtype).itemsize


def chunk_grid(shape: Tuple[int, ...], dtype: Any, target_bytes: int) -> Tuple[int, int]:
    """Deterministic *flat-range* chunk grid: (elems_per_chunk, n_chunks)
    over the C-order flattened array.

    Flat ranges subsume row blocks (an embedding's 4 MiB chunk is still a
    run of whole rows) while also isolating deltas whose natural axis is
    not axis 0 — e.g. KV-cache writes along the time dim of a
    (batch, T, heads, dim) buffer.  The grid depends only on
    (shape, dtype, target_bytes): stable across executions (§7.3).  Chunk
    boundaries stay 4-byte aligned so the fingerprint kernel's uint32 word
    stream tiles exactly onto the grid.
    """
    total = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if total == 0:
        return (1, 1)
    itemsize = itemsize_of(dtype)
    elems = max(1, int(target_bytes // itemsize))
    if elems >= total:
        return (total, 1)
    # 4-byte alignment of chunk boundaries (word-stream tiling)
    g = (elems * itemsize) % 4
    if g:
        mult = 2 if (itemsize * 2) % 4 == 0 else 4
        elems = (elems // mult) * mult
        if elems == 0:
            elems = mult
        if elems >= total:
            return (total, 1)
    n_chunks = -(-total // elems)  # ceil
    return elems, n_chunks


def _flatten_with_paths(tree: Any) -> List[Tuple[Path, Any]]:
    """Flatten a pytree into (path, leaf) pairs with deterministic ordering.

    The walk is the contract, the same walk as the reference package's:
    `dict` children are visited in insertion order under their
    `str(key)`, `list`/`tuple` children (including namedtuple-style
    tuples) under their stringified index, and everything else (tensors,
    arrays, scalars, None) is a leaf, so numpy and torch state flatten
    identically; `Chipmink.load(like=...)` re-flows values back into
    custom containers (see `reflow`).
    """
    out: List[Tuple[Path, Any]] = []

    def walk(prefix: Path, x: Any) -> None:
        if isinstance(x, dict):
            for k in x.keys():  # preserve insertion order: deterministic
                walk(prefix + (str(k),), x[k])
        elif isinstance(x, (list, tuple)) and not _is_arraylike(x):
            for i, v in enumerate(x):
                walk(prefix + (str(i),), v)
        else:
            out.append((prefix, x))

    walk((), tree)
    return out


def build_leaf_nodes(path: Path, leaf: Any, chunk_bytes: int,
                     new_node: Callable[..., Node]) -> Node:
    """Construct an array leaf's LEAF node and its CHUNK children through
    the caller-supplied `new_node` allocator.

    Single source of truth for the chunk-grid and size math shared by
    `build_graph` and the incremental `GraphCache` walker — their outputs
    must stay structurally bit-identical, so neither re-implements this.
    """
    shape = tuple(int(d) for d in leaf.shape)
    dtype = dtype_name(leaf.dtype)
    elems, n_chunks = chunk_grid(shape, dtype, chunk_bytes)
    lnode = new_node(path=path, kind=LEAF, size=STRUCT_SIZE,
                     shape=shape, dtype=dtype, chunk_rows=elems)
    itemsize = itemsize_of(dtype)
    total_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
    for ci in range(n_chunks):
        lo = ci * elems
        hi = min(total_elems, (ci + 1) * elems)
        cnode = new_node(path=path, kind=CHUNK,
                         size=max((hi - lo) * itemsize, 1), shape=shape,
                         dtype=dtype, chunk_rows=elems, chunk_index=ci)
        lnode.children.append(cnode.node_id)
    return lnode


@dataclasses.dataclass
class ObjectGraph:
    """G = (U, E, V, l): nodes, edges (via children lists), variables."""

    nodes: Dict[int, Node]
    root_id: int
    by_key: Dict[str, int]
    variables: Dict[str, int]       # l: variable name -> node id (top-level)
    #: leaf path -> the live array (not serialized; used by podding/CD)
    arrays: Dict[str, Any]
    #: lazily built sorted view of by_key for bisect prefix queries
    _sorted_keys: Optional[List[str]] = dataclasses.field(
        default=None, repr=False, compare=False)
    #: lazily built sorted LEAF-only key list (prefix queries that want
    #: leaves must not pay for the chunk keys, which dominate by count)
    _sorted_leaf_keys: Optional[List[str]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def node(self, node_id: int) -> Node:
        return self.nodes[node_id]

    def iter_dfs(self) -> Iterator[Node]:
        """Depth-first traversal in serialization order (paper §4.1)."""
        stack = [self.root_id]
        while stack:
            nid = stack.pop()
            node = self.nodes[nid]
            yield node
            stack.extend(reversed(node.children))

    def chunk_nodes(self) -> Iterator[Node]:
        for n in self.nodes.values():
            if n.kind == CHUNK:
                yield n

    def leaf_nodes(self) -> Iterator[Node]:
        for n in self.nodes.values():
            if n.kind == LEAF:
                yield n

    def n_nodes(self) -> int:
        return len(self.nodes)

    def total_payload_bytes(self) -> int:
        return sum(n.size for n in self.nodes.values() if n.kind == CHUNK)

    def sorted_keys(self) -> List[str]:
        """Sorted key list (cached; the graph is immutable after build)."""
        if self._sorted_keys is None:
            self._sorted_keys = sorted(self.by_key)
        return self._sorted_keys

    def sorted_leaf_keys(self) -> List[str]:
        """Sorted LEAF keys only (cached), for leaf-prefix range scans."""
        if self._sorted_leaf_keys is None:
            self._sorted_leaf_keys = sorted(
                k for k, nid in self.by_key.items()
                if self.nodes[nid].kind == LEAF)
        return self._sorted_leaf_keys

    def subtree_keys(self, prefix: Path) -> List[str]:
        """All node keys under a path prefix (for the active-variable filter).

        Answered with three bisect range scans over the sorted key list —
        the exact match, the chunk range ``p#…``, and the descendant range
        ``p/…`` — so a query costs O(log N + matches) instead of a full
        O(N) key scan per prefix.
        """
        p = path_str(prefix)
        ks = self.sorted_keys()
        out: List[str] = []
        i = bisect.bisect_left(ks, p)
        if i < len(ks) and ks[i] == p:
            out.append(p)
        for sep in ("#", "/"):
            lo = bisect.bisect_left(ks, p + sep)
            hi = bisect.bisect_left(ks, p + chr(ord(sep) + 1))
            out.extend(ks[lo:hi])
        return out


def build_graph(state: Any, *, chunk_bytes: int = 1 << 22) -> ObjectGraph:
    """Build the ObjectGraph of a state pytree.

    Shared references (same underlying array object reachable via two paths)
    become ALIAS nodes pointing at the first (canonical) occurrence — the
    cross-pod reference case handled by the virtual memo space.
    """
    nodes: Dict[int, Node] = {}
    by_key: Dict[str, int] = {}
    arrays: Dict[str, Any] = {}
    seen_objects: Dict[int, Path] = {}  # id(array) -> canonical path
    next_id = [0]

    def new_node(**kw: Any) -> Node:
        nid = next_id[0]
        next_id[0] += 1
        n = Node(node_id=nid, **kw)
        nodes[nid] = n
        by_key[n.key] = nid
        return n

    leaves = _flatten_with_paths(state)

    # Group leaves into a trie so container nodes exist for interior paths.
    root = new_node(path=(), kind=CONTAINER, size=STRUCT_SIZE)
    containers: Dict[Path, Node] = {(): root}

    def get_container(path: Path) -> Node:
        if path in containers:
            return containers[path]
        parent = get_container(path[:-1])
        node = new_node(path=path, kind=CONTAINER, size=STRUCT_SIZE)
        parent.children.append(node.node_id)
        containers[path] = node
        return node

    for path, leaf in leaves:
        parent = get_container(path[:-1]) if path else root
        if leaf is None:
            node = new_node(path=path, kind=SCALAR, size=STRUCT_SIZE, value=None)
            parent.children.append(node.node_id)
            continue
        if _is_arraylike(leaf):
            oid = id(leaf)
            if oid in seen_objects and seen_objects[oid] != path:
                node = new_node(
                    path=path, kind=ALIAS, size=STRUCT_SIZE,
                    alias_of=seen_objects[oid],
                )
                parent.children.append(node.node_id)
                continue
            seen_objects[oid] = path
            lnode = build_leaf_nodes(path, leaf, chunk_bytes, new_node)
            parent.children.append(lnode.node_id)
            arrays[path_str(path)] = leaf
        else:
            # python scalar (int/float/bool/str/bytes) — host state like step
            # counters and data-pipeline cursors.
            node = new_node(path=path, kind=SCALAR, size=STRUCT_SIZE, value=leaf)
            parent.children.append(node.node_id)

    variables = {}
    for cid in root.children:
        n = nodes[cid]
        if len(n.path) == 1:
            variables[n.path[0]] = cid
    return ObjectGraph(nodes=nodes, root_id=root.node_id, by_key=by_key,
                       variables=variables, arrays=arrays)


def chunk_slice(arr: Any, node: Node) -> Any:
    """Return the flat element range of `arr` for a CHUNK node."""
    if node.shape == () or len(node.shape or ()) == 0:
        return arr
    total = int(np.prod(node.shape, dtype=np.int64))
    lo = node.chunk_index * node.chunk_rows
    hi = min(total, lo + node.chunk_rows)
    return arr.reshape(-1)[lo:hi]


def rebuild_tree(flat: Dict[str, Any]) -> Any:
    """Rebuild a nested dict tree from path-keyed leaves (inverse of flatten).

    Loading restores nested dicts; callers that need an exact custom pytree
    type pass `like=` to Chipmink.load which re-flows values into it.
    """
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return out
