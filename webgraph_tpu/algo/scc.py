"""Strongly connected components.

The reference uses an iterative Tarjan with an explicit stack
(StronglyConnectedComponents.java:48-126) — inherently sequential.  The
device algorithm is the parallel-friendly **coloring / forward-backward**
method: every node proposes the max reachable id by forward propagation
(color), nodes whose color equals their own id are pivots; the SCC of a
pivot is {x : color[x] == pivot and pivot reachable from x within the
color class} found by one backward reachability per round, all rounds as
dense device relaxations.  Matches the compute() contract (§2.7): number of
SCCs, component array; validated against a recursive Tarjan oracle in the
test-suite (the reference's own testing pattern, SURVEY §4.4).

Also provides ``buckets``: the terminal components (no arc leaving the
component) excluding the trivial dangling ones — the reference's bucket
computation (StronglyConnectedComponents.java:225).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.graph import CSRGraph

__all__ = ["strongly_connected_components", "scc_sizes", "scc_buckets",
           "strongly_connected_components_labelled"]


@jax.jit
def _color_round(arc_src, arc_tgt, color, active):
    """Propagate max color forward along arcs within active nodes."""
    ok = jnp.take(active, arc_src) & jnp.take(active, arc_tgt)
    c = jnp.where(ok, jnp.take(color, arc_src), -1)
    newc = color.at[arc_tgt].max(c)
    return jnp.where(active, newc, color)


@jax.jit
def _reach_round(arc_src, arc_tgt, reach, mask):
    """Backward reachability: reach[src] |= reach[tgt], restricted to mask."""
    ok = jnp.take(mask, arc_src) & jnp.take(mask, arc_tgt)
    r = jnp.take(reach, arc_tgt) & ok
    return reach.at[arc_src].max(r)


def strongly_connected_components(g: CSRGraph) -> Tuple[int, np.ndarray]:
    """Returns (number_of_components, component[n]).

    Component ids are assigned in decreasing order of their pivot node id
    discovery (renumbered 0..k-1 in first-appearance order over nodes, the
    reference's convention of dense component ids).
    """
    n = g.num_nodes
    if n == 0:
        return 0, np.zeros(0, dtype=np.int64)
    src, tgt = g.arcs()
    src_d = jnp.asarray(src, dtype=jnp.int32)
    tgt_d = jnp.asarray(tgt, dtype=jnp.int32)

    comp = np.full(n, -1, dtype=np.int64)  # holds the pivot node id
    active_np = np.ones(n, dtype=bool)
    src_np, tgt_np = src, tgt

    while active_np.any():
        # trim: peel singleton SCCs (no active in-arcs or out-arcs) — webby
        # graphs are dominated by these (the reference reports them as
        # ordinary components; peeling keeps the round count low)
        while True:
            alive = active_np[src_np] & active_np[tgt_np] & (src_np != tgt_np)
            outd = np.zeros(n, dtype=np.int64)
            ind = np.zeros(n, dtype=np.int64)
            np.add.at(outd, src_np[alive], 1)
            np.add.at(ind, tgt_np[alive], 1)
            trivial = active_np & ((outd == 0) | (ind == 0))
            if not trivial.any():
                break
            comp[trivial] = np.flatnonzero(trivial)
            active_np &= ~trivial
        if not active_np.any():
            break
        active = jnp.asarray(active_np)
        # forward max-color propagation to fixpoint
        color = jnp.where(active, jnp.arange(n, dtype=jnp.int32), -1)
        while True:
            newc = _color_round(src_d, tgt_d, color, active)
            if bool(jnp.all(newc == color)):
                break
            color = newc
        # pivots: nodes whose color is their own id
        color_np = np.asarray(color)
        # backward reachability of pivots within same color class
        reach = jnp.asarray(color_np == np.arange(n))  # pivots reach selves
        mask = active
        same_color = jnp.asarray(color_np)
        while True:
            # restrict propagation to arcs inside one color class
            ok = (jnp.take(same_color, src_d) == jnp.take(same_color, tgt_d))
            r = jnp.take(reach, tgt_d) & ok & jnp.take(mask, src_d)
            newr = reach.at[src_d].max(r)
            if bool(jnp.all(newr == reach)):
                break
            reach = newr
        reach_np = np.asarray(reach) & active_np
        # SCC of pivot p = {x active : color[x] == p and x reaches p};
        # pivot node ids are globally unique, so they serve as component keys
        in_scc = reach_np
        comp[in_scc] = color_np[in_scc]
        active_np &= ~in_scc

    # renumber pivot ids to dense 0..k-1 in first-appearance order over nodes
    _, first_idx, inv = np.unique(comp, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    comp = rank[inv]
    return len(order), comp


def scc_sizes(component: np.ndarray) -> np.ndarray:
    return np.bincount(component)


def scc_buckets(g: CSRGraph, component: np.ndarray) -> np.ndarray:
    """Terminal non-dangling components: bool per component, True when the
    component has no arc leaving it and is not a singleton without loops
    (the reference's bucket semantics, StronglyConnectedComponents.java:225).
    """
    src, tgt = g.arcs()
    k = int(component.max(initial=-1)) + 1
    leaves = np.zeros(k, dtype=bool)
    cs, ct = component[src], component[tgt]
    np.logical_or.at(leaves, cs[cs != ct], True)
    terminal = ~leaves
    sizes = np.bincount(component, minlength=k)
    has_loop = np.zeros(k, dtype=bool)
    loops = src == tgt
    np.logical_or.at(has_loop, component[src[loops]], True)
    nondangling = (sizes > 1) | has_loop
    return terminal & nondangling


def strongly_connected_components_labelled(g, pred) -> Tuple[int, np.ndarray]:
    """SCC of a labelled graph considering only arcs accepted by the
    labelled arc filter ``pred(label, source, target)``
    (StronglyConnectedComponents.java:375).  ``g`` must expose
    ``iter_labelled()`` (ArcLabelledGraph / BitStreamArcLabelledGraph)."""
    lists = []
    for x, succ, labs in g.iter_labelled():
        keep = [t for t, l in zip(succ.tolist(), labs) if pred(l, x, t)]
        lists.append(np.asarray(keep, dtype=np.int64))
    return strongly_connected_components(CSRGraph.from_lists(lists))
