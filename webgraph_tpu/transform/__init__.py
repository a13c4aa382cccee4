"""Graph transformation engine.

Device re-design of the reference's out-of-core transformation engine
(Transform.java, SURVEY §2.6): where the reference streams lazy iterators
through disk-batch external sorts (processBatch :938-974, BatchGraph
:709-926), this engine operates on dense arc arrays — device-side
``jax.lax.sort`` over packed (source, target) keys for in-memory graphs,
and a host external-sort over spilled numpy batches for graphs larger than
memory (transform.offline).

API parity (Transform.java):
  transpose / transpose_offline          (:1058-1144)
  symmetrize / symmetrize_offline        (:546-633)
  simplify / simplify_offline            (:645-705)
  map_offline                            (:1160-1279)
  union                                  (:1659)
  compose                                (:1666-1811)
  filter_arcs, NO_LOOPS, NodeClassFilter (:103-534)
  gray_code_permutation, random_permutation,
  lexicographical_permutation            (:1940-2040)
"""

from __future__ import annotations

from functools import cmp_to_key
from typing import Callable, Optional

import numpy as np

from ..core.graph import CSRGraph, ImmutableGraph

__all__ = [
    "transpose", "transpose_offline", "symmetrize", "symmetrize_offline",
    "simplify", "simplify_offline", "map_offline", "union", "compose",
    "filter_arcs", "no_loops", "NodeClassFilter", "gray_code_permutation",
    "random_permutation", "lexicographical_permutation", "apply_permutation",
]


def _arcs_of(g: ImmutableGraph):
    if isinstance(g, CSRGraph):
        return g.arcs()
    src_parts, tgt_parts = [], []
    for x, succ in g.iter_nodes():
        if len(succ):
            src_parts.append(np.full(len(succ), x, dtype=np.int64))
            tgt_parts.append(np.asarray(succ, dtype=np.int64))
    if not src_parts:
        return (np.zeros(0, dtype=np.int64),) * 2
    return np.concatenate(src_parts), np.concatenate(tgt_parts)


# ---------------------------------------------------------------------------
# basic transforms
# ---------------------------------------------------------------------------


def transpose(g: ImmutableGraph) -> CSRGraph:
    """In-memory transpose: emit (succ, node) pairs and re-sort
    (semantics of Transform.transposeOffline, :1058-1144)."""
    src, tgt = _arcs_of(g)
    return CSRGraph.from_arcs(tgt, src, g.num_nodes, dedup=False)


def union(g0: ImmutableGraph, g1: ImmutableGraph) -> CSRGraph:
    """Arc-set union (Transform.union :1659; UnionImmutableGraph semantics)."""
    s0, t0 = _arcs_of(g0)
    s1, t1 = _arcs_of(g1)
    n = max(g0.num_nodes, g1.num_nodes)
    return CSRGraph.from_arcs(np.concatenate([s0, s1]),
                              np.concatenate([t0, t1]), n, dedup=True)


def symmetrize(g: ImmutableGraph) -> CSRGraph:
    """union(g, transpose(g)) (Transform.symmetrizeOffline :546-633)."""
    src, tgt = _arcs_of(g)
    return CSRGraph.from_arcs(np.concatenate([src, tgt]),
                              np.concatenate([tgt, src]),
                              g.num_nodes, dedup=True)


def simplify(g: ImmutableGraph) -> CSRGraph:
    """Symmetrize + remove loops (Transform.simplify :645-705)."""
    src, tgt = _arcs_of(g)
    s = np.concatenate([src, tgt])
    t = np.concatenate([tgt, src])
    keep = s != t
    return CSRGraph.from_arcs(s[keep], t[keep], g.num_nodes, dedup=True)


def map_offline(g: ImmutableGraph, node_map: np.ndarray,
                num_nodes: Optional[int] = None) -> CSRGraph:
    """Apply a node map (Transform.mapOffline :1160-1279).

    ``node_map[x]`` is the image of node x, or -1 to drop the node (and all
    its arcs).  Non-injective maps merge nodes (arcs are deduplicated).
    """
    node_map = np.asarray(node_map, dtype=np.int64)
    src, tgt = _arcs_of(g)
    ms, mt = node_map[src], node_map[tgt]
    keep = (ms >= 0) & (mt >= 0)
    if num_nodes is None:
        num_nodes = int(node_map.max(initial=-1)) + 1
    return CSRGraph.from_arcs(ms[keep], mt[keep], num_nodes, dedup=True)


def compose(g0: ImmutableGraph, g1: ImmutableGraph) -> CSRGraph:
    """Graph composition: arc (x, z) iff exists y with x->y in g0, y->z in g1
    (Transform.compose :1666-1811)."""
    s0, t0 = _arcs_of(g0)
    csr1 = g1 if isinstance(g1, CSRGraph) else g1.to_csr()
    n = max(g0.num_nodes, g1.num_nodes)
    if not len(t0):
        return CSRGraph.from_arcs(s0, t0, n, dedup=True)
    # expand: for each arc (x, y) of g0, all successors z of y in g1
    deg = np.diff(csr1.offsets)
    mid_deg = deg[t0]
    total = int(mid_deg.sum())
    rep = np.repeat(np.arange(len(t0), dtype=np.int64), mid_deg)
    pos_in_arc = (np.arange(total, dtype=np.int64)
                  - (np.cumsum(mid_deg) - mid_deg)[rep])
    idx = csr1.offsets[t0][rep] + pos_in_arc
    return CSRGraph.from_arcs(s0[rep], csr1.succ[idx], n, dedup=True)


# ---------------------------------------------------------------------------
# arc filters (Transform.ArcFilter :103, filterArcs :503-534)
# ---------------------------------------------------------------------------


def no_loops(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """The NO_LOOPS filter (Transform.java:219)."""
    return src != tgt


class NodeClassFilter:
    """Keeps arcs whose endpoints are in the same class (Transform.java:154)."""

    def __init__(self, classes: np.ndarray):
        self.classes = np.asarray(classes)

    def __call__(self, src, tgt):
        return self.classes[src] == self.classes[tgt]


def filter_arcs(g: ImmutableGraph, pred: Callable) -> CSRGraph:
    """Materialized arc-filtered view (FilteredImmutableGraph :222)."""
    src, tgt = _arcs_of(g)
    keep = np.asarray(pred(src, tgt), dtype=bool)
    return CSRGraph.from_arcs(src[keep], tgt[keep], g.num_nodes, dedup=False)


# ---------------------------------------------------------------------------
# permutations (Transform.java:1940-2040)
# ---------------------------------------------------------------------------


def apply_permutation(g: ImmutableGraph, perm: np.ndarray) -> CSRGraph:
    """Renumber nodes by a bijective permutation (old -> new)."""
    perm = np.asarray(perm, dtype=np.int64)
    src, tgt = _arcs_of(g)
    return CSRGraph.from_arcs(perm[src], perm[tgt], g.num_nodes, dedup=False)


def random_permutation(g: ImmutableGraph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(g.num_nodes).astype(np.int64)


def _invert(perm_sorted_ids: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm_sorted_ids)
    inv[perm_sorted_ids] = np.arange(len(perm_sorted_ids), dtype=np.int64)
    return inv


def _lex_cmp(csr):
    def cmp(x, y):
        a, b = csr.successors(x), csr.successors(y)
        la, lb = len(a), len(b)
        l = min(la, lb)
        if l:
            d = a[:l] != b[:l]
            nz = np.flatnonzero(d)
            if len(nz):
                i = nz[0]
                return -1 if a[i] < b[i] else 1
        return -1 if la < lb else (1 if la > lb else 0)

    return cmp


def _gray_cmp(csr):
    def cmp(x, y):
        a, b = csr.successors(x), csr.successors(y)
        la, lb = len(a), len(b)
        l = min(la, lb)
        prefix = l
        if l:
            d = np.flatnonzero(a[:l] != b[:l])
            if len(d):
                prefix = int(d[0])
        parity = prefix % 2 == 1
        if prefix < l:
            less = bool(a[prefix] < b[prefix])
            return 1 if (parity ^ less) else -1
        if la == lb:
            return 0
        if la == prefix:  # a exhausted
            return 1 if parity else -1
        return -1 if parity else 1

    return cmp


def _row_sort_order(csr, gray: bool, key_cols: int = 8) -> np.ndarray:
    """Vectorized ragged-row sort: one stable np.lexsort over the first
    ``key_cols`` successor columns resolves almost every row; surviving tie
    groups (rows equal on all packed columns with members deeper than the
    prefix — e.g. hub/follower clusters) fall back to the exact comparator
    within each group.  Scales to uk-2002-size graphs where a Python
    comparison sort cannot (the reference uses parallel radix sorts,
    Transform.java:1940-2013).

    Gray order reduces to plain lexicographic order on a transformed key
    stream: the Gray "decode" of an adjacency row is its prefix-XOR
    bitvector, so comparison DESCENDS on even successor positions and
    ascends on odd ones; the end-of-row sentinel sorts first at even
    positions and last at odd ones (Transform.grayCodePermutation
    semantics, :1940)."""
    off = csr.offsets
    succ = csr.succ
    n = csr.num_nodes
    deg = np.diff(off)
    maxd = int(deg.max()) if n else 0
    K = min(key_cols, maxd)
    keys = []
    for c in range(K):
        has = deg > c
        s = np.where(has, succ[np.minimum(off[:-1] + c, len(succ) - 1)], 0)
        if gray and not (c & 1):
            k = np.where(has, n - s, 0)       # descending; sentinel first
        elif gray:
            k = np.where(has, s + 1, n + 1)   # ascending; sentinel last
        else:
            k = np.where(has, s + 1, 0)       # ascending; sentinel first
        keys.append(k)
    if not keys:
        return np.arange(n, dtype=np.int64)
    order = np.lexsort(tuple(reversed(keys)))  # primary key = column 0
    # tie groups: equal on every packed column, any member deeper than K
    ks = np.stack([k[order] for k in keys])
    same = np.zeros(n, dtype=bool)
    same[1:] = (ks[:, 1:] == ks[:, :-1]).all(axis=0)
    gid = np.cumsum(~same) - 1
    need = np.zeros(gid[-1] + 1 if n else 0, dtype=bool)
    np.maximum.at(need, gid, deg[order] > K)
    grp_sz = np.bincount(gid)
    resolve = need & (grp_sz > 1)
    if resolve.any():
        cmp = (_gray_cmp if gray else _lex_cmp)(csr)
        # gid is nondecreasing over the sorted order: members contiguous
        for gi in np.flatnonzero(resolve):
            lo = np.searchsorted(gid, gi, side="left")
            hi = np.searchsorted(gid, gi, side="right")
            rows = sorted(order[lo:hi].tolist(), key=cmp_to_key(cmp))
            order[lo:hi] = rows
    return order


def lexicographical_permutation(g: ImmutableGraph) -> np.ndarray:
    """Sort adjacency lists lexicographically; returns old -> new
    (Transform.lexicographicalPermutation :2013)."""
    csr = g if isinstance(g, CSRGraph) else g.to_csr()
    return _invert(_row_sort_order(csr, gray=False))


def gray_code_permutation(g: ImmutableGraph) -> np.ndarray:
    """Sort adjacency rows in Gray-code order; returns old -> new
    (Transform.grayCodePermutation :1940)."""
    csr = g if isinstance(g, CSRGraph) else g.to_csr()
    return _invert(_row_sort_order(csr, gray=True))


# ---------------------------------------------------------------------------
# offline (external-memory) variants
# ---------------------------------------------------------------------------

from .offline import (  # noqa: E402
    BatchGraph,
    map_offline_batched,
    process_batch,
    symmetrize_offline,
    simplify_offline,
    transpose_offline,
)

__all__ += ["BatchGraph", "map_offline_batched", "process_batch",
            "symmetrize_offline", "simplify_offline", "transpose_offline"]

from .labelled import (  # noqa: E402
    LabelledBatchGraph,
    compose_labelled,
    process_labelled_batch,
    symmetrize_offline_labelled,
    transpose_offline_labelled,
)

__all__ += ["LabelledBatchGraph", "compose_labelled",
            "process_labelled_batch", "symmetrize_offline_labelled",
            "transpose_offline_labelled"]
