"""Connected components of symmetric graphs.

Re-design of ConnectedComponents (reference ConnectedComponents.java:107:
repeated parallel BFS rounds marking components).  The device algorithm
is label propagation with pointer jumping: every node starts with its own
id; each round takes the min label over neighbours, then compresses label
chains (label = label[label]) — converging in O(log n) dense rounds, all on
device.  Matching the reference's outputs: component array, computeSizes,
sortBySize (renumber components by decreasing size).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.graph import CSRGraph

__all__ = ["connected_components", "compute_sizes", "sort_by_size"]


@jax.jit
def _cc_round(arc_src, arc_tgt, label):
    neigh = jnp.take(label, arc_src)
    label = label.at[arc_tgt].min(neigh)
    # pointer jumping
    label = jnp.take(label, label)
    label = jnp.take(label, label)
    return label


def connected_components(g: CSRGraph) -> np.ndarray:
    """Component id per node (ids are the minimum node id of the component,
    then renumbered in first-appearance order like the reference)."""
    n = g.num_nodes
    src, tgt = g.arcs()
    src_d = jnp.asarray(src, dtype=jnp.int32)
    tgt_d = jnp.asarray(tgt, dtype=jnp.int32)
    label = jnp.arange(n, dtype=jnp.int32)
    while True:
        new = _cc_round(src_d, tgt_d, label)
        if bool(jnp.all(new == label)):
            break
        label = new
    lab = np.asarray(label, dtype=np.int64)
    # renumber to 0..k-1 by first appearance
    _, first_idx, inv = np.unique(lab, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv]


def compute_sizes(component: np.ndarray) -> np.ndarray:
    """Size of each component (ConnectedComponents.computeSizes)."""
    return np.bincount(component)


def sort_by_size(component: np.ndarray) -> np.ndarray:
    """Renumber components by decreasing size (ConnectedComponents.sortBySize);
    ties broken by original component id (stable)."""
    sizes = compute_sizes(component)
    order = np.argsort(-sizes, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[component]
