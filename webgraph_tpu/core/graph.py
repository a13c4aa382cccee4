"""Array-first immutable graph abstraction.

This is the device re-design of the reference's universal interface
(ImmutableGraph.java:201: numNodes/numArcs/outdegree/successors/nodeIterator/
splitNodeIterators/copy, plus reflective load/store from a .properties file,
ImmutableGraph.java:674-738).

Design stance (SURVEY §7): no lazy per-edge iterators.  Successor lists are
dense sorted int64 numpy arrays; sequential scans yield (node, array) pairs;
bulk access goes through :meth:`ImmutableGraph.to_csr` which materializes the
whole graph (or a node range) as CSR arrays ready for device upload.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import properties as javaprops

__all__ = [
    "ImmutableGraph",
    "CSRGraph",
    "load",
    "store",
    "register_graph_class",
    "GRAPH_CLASS_REGISTRY",
]

PROPERTIES_EXTENSION = ".properties"

#: Maps the ``graphclass`` property value to the Python loader class.  Both
#: the big (64-bit) and standard (32-bit) Java class names map to the same
#: implementation: the on-disk formats are identical, only in-memory index
#: widths differed (ImmutableGraph.java:920/:1039 adapters).
GRAPH_CLASS_REGISTRY: Dict[str, type] = {}


def register_graph_class(*java_names):
    """Class decorator registering Java ``graphclass`` aliases for a loader."""

    def deco(cls):
        for name in java_names:
            GRAPH_CLASS_REGISTRY[name] = cls
        cls.java_class_names = java_names
        return cls

    return deco


class ImmutableGraph:
    """Base class for immutable graphs.

    Subclasses must implement :attr:`num_nodes`, :meth:`outdegree`,
    :meth:`successors` (random access, where supported) and
    :meth:`iter_nodes` (sequential access).
    """

    properties: Dict[str, str]

    # -- core contract ----------------------------------------------------

    @property
    def num_nodes(self) -> int:
        raise NotImplementedError

    @property
    def num_arcs(self) -> int:
        raise NotImplementedError

    @property
    def random_access(self) -> bool:
        return True

    def outdegree(self, x: int) -> int:
        return len(self.successors(x))

    def successors(self, x: int) -> np.ndarray:
        """Sorted int64 array of successors of node ``x``."""
        raise NotImplementedError

    def iter_nodes(self, start: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        """Sequential scan yielding ``(node, successors)`` pairs from ``start``."""
        for x in range(start, self.num_nodes):
            yield x, self.successors(x)

    def split_ranges(self, pieces: int) -> List[Tuple[int, int]]:
        """Contiguous node ranges for parallel scans.

        Device analogue of splitNodeIterators (ImmutableGraph.java:405):
        instead of handing out iterator objects, hand out [lo, hi) node
        ranges; each range is decoded/processed independently (on one chip,
        in one shard_map program instance, or on one host).
        """
        n = self.num_nodes
        if pieces <= 0:
            raise ValueError("pieces must be positive")
        bounds = np.linspace(0, n, pieces + 1).astype(np.int64)
        return [(int(bounds[i]), int(bounds[i + 1])) for i in range(pieces)]

    # -- bulk conversion --------------------------------------------------

    def to_csr(self, lo: int = 0, hi: Optional[int] = None) -> "CSRGraph":
        """Materialize nodes [lo, hi) as a CSR graph (offsets renumbered to 0)."""
        hi = self.num_nodes if hi is None else hi
        offs = [0]
        chunks = []
        it = self.iter_nodes(lo)
        for x, succ in it:
            if x >= hi:
                break
            chunks.append(np.asarray(succ, dtype=np.int64))
            offs.append(offs[-1] + len(chunks[-1]))
        succ = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
        return CSRGraph(
            np.asarray(offs, dtype=np.int64), succ, num_nodes=hi - lo
        )

    # -- equality (successor-list semantics, ImmutableGraph.java equals) --

    def equals(self, other: "ImmutableGraph") -> bool:
        if self.num_nodes != other.num_nodes:
            return False
        for (x, a), (y, b) in zip(self.iter_nodes(), other.iter_nodes()):
            if x != y or len(a) != len(b) or not np.array_equal(a, b):
                return False
        return True

    # -- persistence -------------------------------------------------------

    @classmethod
    def load(cls, basename: str, mode: str = "standard") -> "ImmutableGraph":
        raise NotImplementedError

    @classmethod
    def store(cls, graph: "ImmutableGraph", basename: str, **kwargs):
        raise NotImplementedError


class CSRGraph(ImmutableGraph):
    """In-memory CSR graph: ``offsets`` int64[n+1], ``successors`` int64[m].

    The universal interchange format of the framework: decoders produce it,
    encoders and analytics consume it, and its two arrays upload directly to
    device HBM (sharded over a mesh by node ranges).
    """

    def __init__(self, offsets, successors, num_nodes: Optional[int] = None,
                 properties: Optional[Dict[str, str]] = None):
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.succ = np.ascontiguousarray(successors, dtype=np.int64)
        n = len(self.offsets) - 1 if num_nodes is None else num_nodes
        assert len(self.offsets) == n + 1, (len(self.offsets), n)
        self._n = n
        self.properties = properties or {}

    @classmethod
    def from_lists(cls, lists) -> "CSRGraph":
        offs = np.zeros(len(lists) + 1, dtype=np.int64)
        for i, l in enumerate(lists):
            offs[i + 1] = offs[i] + len(l)
        succ = (np.concatenate([np.asarray(l, dtype=np.int64) for l in lists])
                if len(lists) else np.zeros(0, dtype=np.int64))
        return cls(offs, succ)

    @classmethod
    def from_arcs(cls, sources, targets, num_nodes: int,
                  dedup: bool = True) -> "CSRGraph":
        """Build from (unsorted) arc arrays by sort + optional dedup."""
        src = np.asarray(sources, dtype=np.int64)
        tgt = np.asarray(targets, dtype=np.int64)
        order = np.lexsort((tgt, src))
        src, tgt = src[order], tgt[order]
        if dedup and len(src):
            keep = np.concatenate(
                [[True], (src[1:] != src[:-1]) | (tgt[1:] != tgt[:-1])]
            )
            src, tgt = src[keep], tgt[keep]
        offsets = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(offsets, src + 1, 1)
        np.cumsum(offsets, out=offsets)
        return cls(offsets, tgt, num_nodes=num_nodes)

    @property
    def num_nodes(self) -> int:
        return self._n

    @property
    def num_arcs(self) -> int:
        return int(self.offsets[-1])

    def outdegree(self, x: int) -> int:
        return int(self.offsets[x + 1] - self.offsets[x])

    def successors(self, x: int) -> np.ndarray:
        return self.succ[self.offsets[x]:self.offsets[x + 1]]

    def iter_nodes(self, start: int = 0):
        offs, succ = self.offsets, self.succ
        for x in range(start, self._n):
            yield x, succ[offs[x]:offs[x + 1]]

    def to_csr(self, lo: int = 0, hi: Optional[int] = None) -> "CSRGraph":
        if lo == 0 and (hi is None or hi == self._n):
            return self
        hi = self._n if hi is None else hi
        base = self.offsets[lo]
        return CSRGraph(self.offsets[lo:hi + 1] - base,
                        self.succ[base:self.offsets[hi]],
                        num_nodes=hi - lo)

    def transpose(self) -> "CSRGraph":
        src = np.repeat(np.arange(self._n, dtype=np.int64),
                        np.diff(self.offsets))
        return CSRGraph.from_arcs(self.succ, src, self._n, dedup=False)

    def arcs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sources, targets) arc arrays in lexicographic order."""
        src = np.repeat(np.arange(self._n, dtype=np.int64),
                        np.diff(self.offsets))
        return src, self.succ.copy()


def load(basename: str, mode: str = "standard") -> ImmutableGraph:
    """Load any graph by its ``.properties`` file (ImmutableGraph.java:674).

    ``mode``: "standard" (in-memory), "mapped" (mmap the bit stream),
    "offline"/"once" (sequential-only access).
    """
    props = javaprops.load(basename + PROPERTIES_EXTENSION)
    gc = props.get("graphclass", "")
    # strip a possible "class " prefix and resolve aliases
    gc = gc.replace("class ", "").strip()
    cls = GRAPH_CLASS_REGISTRY.get(gc)
    if cls is None:
        # codec classes register themselves on import; pull them in lazily so
        # `core.graph.load` works without the caller importing codecs first
        import importlib

        for mod in ("codecs.bvgraph", "codecs.efgraph", "codecs.ascii",
                    "codecs.intlist", "labelling.graph"):
            try:
                importlib.import_module(f"webgraph_tpu.{mod}")
            except ImportError:  # pragma: no cover - optional codec deps
                pass
        cls = GRAPH_CLASS_REGISTRY.get(gc)
    if cls is None:
        raise IOError(f"Unknown graphclass {gc!r} for basename {basename!r}")
    return cls.load(basename, mode=mode)


def store(graph: ImmutableGraph, basename: str, graph_class=None, **kwargs):
    """Store ``graph`` with the given codec class (default BVGraph)."""
    if graph_class is None:
        from ..codecs.bvgraph import BVGraph as graph_class  # noqa: N813
    return graph_class.store(graph, basename, **kwargs)
