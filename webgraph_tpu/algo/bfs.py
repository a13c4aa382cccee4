"""Parallel breadth-first visit.

Device re-design of ParallelBreadthFirstVisit (reference
ParallelBreadthFirstVisit.java:94-272): instead of a thread pool stealing
GRANULARITY-sized chunks of a shared queue with CAS marker arrays, each
level is one dense edge-parallel relaxation on device: arcs whose source is
in the frontier propose their targets; unvisited targets form the next
frontier.  Distances and the visit queue (nodes in visit order, with level
cut points) match the reference's outputs.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.graph import CSRGraph

__all__ = ["bfs", "visit", "visit_all", "arc_balanced_ranges"]


@functools.partial(jax.jit, donate_argnums=(3,))
def _bfs_round(arc_src, arc_tgt, frontier, dist, level):
    """One level-synchronous relaxation over all arcs."""
    active = jnp.take(frontier, arc_src)
    proposed = jnp.zeros_like(frontier).at[arc_tgt].max(active)
    new = proposed & (dist < 0)
    dist = jnp.where(new, level + 1, dist)
    return new, dist


def bfs(g: CSRGraph, roots, dist: Optional[np.ndarray] = None
        ) -> Tuple[np.ndarray, int]:
    """Multi-source BFS.  Returns (dist int64[n] with -1 unreached, rounds).

    ``dist`` may carry prior marks (>= 0 entries are treated as visited),
    enabling the reference's visitAll round-marking idiom.
    """
    n = g.num_nodes
    roots = np.atleast_1d(np.asarray(roots, dtype=np.int64))
    if dist is None:
        dist = np.full(n, -1, dtype=np.int64)
    dist = dist.copy()
    dist[roots] = 0
    src, tgt = g.arcs()
    src_d = jnp.asarray(src, dtype=jnp.int32)
    tgt_d = jnp.asarray(tgt, dtype=jnp.int32)
    frontier = jnp.zeros(n, dtype=bool).at[jnp.asarray(roots)].set(True)
    dist_d = jnp.asarray(dist)
    level = 0
    while bool(jnp.any(frontier)):
        frontier, dist_d = _bfs_round(src_d, tgt_d, frontier,
                                      dist_d, jnp.asarray(level))
        level += 1
    return np.asarray(dist_d), level


def visit(g: CSRGraph, start: int) -> Tuple[np.ndarray, np.ndarray]:
    """Visit from one node (ParallelBreadthFirstVisit.visit :209).

    Returns (queue, cut_points): nodes in BFS order (level by level, ids
    ascending within a level — a deterministic representative of the
    reference's nondeterministic intra-level order) and the level
    boundaries, cut_points[i]..cut_points[i+1] being level i.
    """
    dist, rounds = bfs(g, [start])
    queue_parts: List[np.ndarray] = []
    cuts = [0]
    for l in range(rounds):
        nodes = np.flatnonzero(dist == l)
        queue_parts.append(nodes)
        cuts.append(cuts[-1] + len(nodes))
    queue = (np.concatenate(queue_parts) if queue_parts
             else np.zeros(0, dtype=np.int64))
    return queue, np.asarray(cuts, dtype=np.int64)


def visit_all(g: CSRGraph) -> np.ndarray:
    """Visit all nodes, marking each with its visit round
    (ParallelBreadthFirstVisit.visitAll :272).  Returns round[n]."""
    n = g.num_nodes
    marks = np.full(n, -1, dtype=np.int64)
    rnd = 0
    for x in range(n):
        if marks[x] < 0:
            dist, _ = bfs(g, [x], dist=np.where(marks >= 0, 0, -1))
            newly = (dist >= 0) & (marks < 0)
            marks[newly] = rnd
            rnd += 1
    return marks


def arc_balanced_ranges(offsets: np.ndarray, pieces: int) -> List[Tuple[int, int]]:
    """Split nodes into ranges with ~equal arc counts — the work-splitting
    role of EliasFanoCumulativeOutdegreeList (SURVEY §2.7): the cumulative
    outdegree list here is the CSR offsets array itself."""
    n = len(offsets) - 1
    m = int(offsets[-1])
    bounds = [0]
    for i in range(1, pieces):
        target = m * i // pieces
        bounds.append(int(np.searchsorted(offsets, target, side="left")))
    bounds.append(n)
    bounds = sorted(min(b, n) for b in bounds)
    return [(bounds[i], bounds[i + 1]) for i in range(pieces)]
