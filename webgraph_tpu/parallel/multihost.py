"""Multi-host scaling: per-host encode shards + distributed decode plans.

The reference's only scaling mechanism is shared-memory threads writing
per-thread temp bit streams that are concatenated bit-exactly
(BVGraph.java:2373-2483).  The device equivalent promotes the same
pattern to hosts (SURVEY §2.11, §5 "Distributed communication backend"):

- **Encode**: the node range splits into per-host shards (arc-balanced,
  the splitNodeIterators analogue, ImmutableGraph.java:405-436); every
  host compresses its shard independently with window resets at the shard
  boundary — exactly the reference's per-thread semantics, with GLOBAL
  node ids (node_base), so the merged stream is what an N-way reference
  encode produces — and writes ``basename-h<k>.{graph,offsets,meta}``;
  a final owner pass concatenates the shard streams bit-exactly, rebases
  the shard offsets, and aggregates properties (BVGraph.java:2432-2483
  promoted from threads to hosts).
- **Decode**: each host builds a kernel plan for its shard
  (:func:`plan_shard_decode`) against the broadcast stream + offsets
  index; no cross-host communication on the hot path because reference
  chains are window-bounded (each plan carries its own halo lists,
  SURVEY §5 "long-context analogue").

Process topology comes from ``jax.distributed`` when launched multi-host
(JAX_COORDINATOR_ADDRESS et al.); single-process runs can emulate any
host count, which is how the tests exercise the shard semantics without
a pod.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["initialize", "shard_bounds", "encode_shard", "merge_shards",
           "store_multihost", "plan_shard_decode"]


def initialize(coordinator: Optional[str] = None, num_processes: int = 0,
               process_id: int = -1) -> Tuple[int, int]:
    """Initialize jax.distributed when a coordinator is configured
    (DCN-level process group); single-process otherwise.  Returns
    (process_id, num_processes)."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes or int(
                os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=(process_id if process_id >= 0
                        else int(os.environ.get("JAX_PROCESS_ID", "0"))))
        return jax.process_index(), jax.process_count()
    return 0, 1


def shard_bounds(csr_off: np.ndarray, n_shards: int) -> np.ndarray:
    """Arc-balanced contiguous node shards (the splitNodeIterators
    contract, ImmutableGraph.java:405-436): int64[n_shards+1]."""
    csr_off = np.asarray(csr_off, dtype=np.int64)
    n = len(csr_off) - 1
    m = int(csr_off[-1])
    targets = (m * np.arange(1, n_shards, dtype=np.int64)) // n_shards
    bounds = np.empty(n_shards + 1, dtype=np.int64)
    bounds[0] = 0
    bounds[1:n_shards] = np.searchsorted(csr_off, targets, side="left")
    bounds[n_shards] = n
    return np.maximum.accumulate(bounds)


def encode_shard(csr_off: np.ndarray, succ: np.ndarray, settings,
                 basename: str, shard: int, lo: int, hi: int,
                 threads: int = 0) -> dict:
    """Host-local encode of nodes [lo, hi) with GLOBAL ids: window resets
    at the shard boundary (per-thread semantics, BVGraph.java:2406) so
    shards are independent.  Writes
    ``basename-h<shard>.{graph,offsets,meta}``."""
    from .. import native

    csr_off = np.asarray(csr_off, dtype=np.int64)
    sco = csr_off[lo:hi + 1] - csr_off[lo]
    ssu = np.asarray(succ[csr_off[lo]:csr_off[hi]])
    graph_b, gbits, offs_b, obits, st = native.bv_encode(
        sco, ssu, settings, threads=threads or (os.cpu_count() or 1),
        node_base=lo)
    part = f"{basename}-h{shard}"
    graph_b.tofile(part + ".graph")
    offs_b.tofile(part + ".offsets")
    meta = dict(shard=shard, lo=lo, hi=hi, bits=int(gbits),
                stats=[int(v) for v in st])
    with open(part + ".meta", "w") as f:
        json.dump(meta, f)
    return meta


def merge_shards(basename: str, n_shards: int, settings,
                 comment: str = "BVGraph properties",
                 keep_parts: bool = False) -> dict:
    """Owner-host pass: bit-exact concatenation of the per-host shard
    streams + offsets rebase + properties aggregation
    (BVGraph.java:2432-2483).  Removes the shard parts on success."""
    from ..codecs.bvgraph import (GRAPH_EXTENSION, OFFSETS_EXTENSION,
                                  PROPERTIES_EXTENSION_FULL, _Encoder)
    from ..ops.vencode import BitCat, pack_gaps
    from ..utils import properties as javaprops
    from .. import native

    cat = BitCat()
    metas = []
    starts_parts = []
    base_bits = 0
    for k in range(n_shards):
        part = f"{basename}-h{k}"
        with open(part + ".meta") as f:
            meta = json.load(f)
        metas.append(meta)
        data = np.fromfile(part + ".graph", dtype=np.uint8)
        cat.push(data.tobytes(), meta["bits"])
        # shard offsets gaps -> absolute starts, rebased to the merged
        # stream (the copyTo offset rebase, BVGraph.java:2432-2483)
        nk = meta["hi"] - meta["lo"]
        ob = np.fromfile(part + ".offsets", dtype=np.uint8)
        gaps_abs = native.decode_offset_stream(ob, nk, settings.offset_coding)
        starts_parts.append(gaps_abs[:-1] + base_bits)
        base_bits += meta["bits"]
    with open(basename + GRAPH_EXTENSION, "wb") as f:
        f.write(cat.to_bytes())
    n = metas[-1]["hi"]
    starts = np.concatenate(starts_parts) if starts_parts else \
        np.zeros(0, dtype=np.int64)
    gaps = (np.concatenate([[0], np.diff(starts), [base_bits - starts[-1]]])
            if n else np.asarray([0], dtype=np.int64))
    offs_b, _bits = pack_gaps(gaps, settings.offset_coding, settings.zeta_k)
    with open(basename + OFFSETS_EXTENSION, "wb") as f:
        f.write(offs_b)
    st = np.sum([mt["stats"] for mt in metas], axis=0)
    enc = _Encoder(settings)
    enc.tot_links = int(st[0] + st[1] + st[2])
    (enc.copied_arcs, enc.intervalised_arcs, enc.residual_arcs,
     enc.tot_ref, enc.tot_dist, enc.bits_for_outdegrees,
     enc.bits_for_references, enc.bits_for_blocks,
     enc.bits_for_intervals, enc.bits_for_residuals) = map(int, st[:10])
    enc.successor_gap_stats = [int(v) for v in st[10:74]]
    enc.residual_gap_stats = [int(v) for v in st[74:138]]
    props = enc.build_properties(n, base_bits)
    javaprops.dump(props, basename + PROPERTIES_EXTENSION_FULL, comment)
    if not keep_parts:
        for k in range(n_shards):
            for ext in (".graph", ".offsets", ".meta"):
                os.remove(f"{basename}-h{k}{ext}")
    return props


def store_multihost(graph, basename: str, n_hosts: int, settings=None,
                    comment: str = "BVGraph properties",
                    threads_per_host: int = 1) -> dict:
    """Single-process emulation/driver of the multi-host encode: shard,
    encode every shard (on a pod each host runs its own
    :func:`encode_shard`), merge.  With ``threads_per_host=1`` the output
    is byte-identical to an n_hosts-thread native encode of the whole
    graph; more threads add further (equally valid) window-reset points
    inside each shard, exactly like extra reference threads."""
    from ..codecs.bvgraph import BVGraphSettings

    s = settings or BVGraphSettings()
    g = graph if hasattr(graph, "offsets") else graph.to_csr()
    csr_off = np.asarray(g.offsets, dtype=np.int64)
    succ = np.asarray(g.succ)
    bounds = shard_bounds(csr_off, n_hosts)
    for k in range(n_hosts):
        encode_shard(csr_off, succ, s, basename, k,
                     int(bounds[k]), int(bounds[k + 1]),
                     threads=threads_per_host)
    return merge_shards(basename, n_hosts, s, comment)


def plan_shard_decode(bv, data: np.ndarray, process_id: int,
                      num_processes: int, **plan_kw):
    """Per-host kernel decode plan: host k plans nodes [b_k, b_{k+1})
    against the shared stream (halo lists localize reference chains, so
    hosts never communicate during decode).  Returns (prep, lo, hi)."""
    from .. import native
    from ..ops import kdecode as K

    n = bv.num_nodes
    offsets = np.asarray(bv.offsets)
    outd = native.decode_outdegrees(np.asarray(data), offsets,
                                    bv.settings.outdegree_coding)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd, out=cum[1:])
    bounds = shard_bounds(cum, num_processes)
    lo, hi = int(bounds[process_id]), int(bounds[process_id + 1])
    prep = K.plan_kernel_decode(offsets[:hi + 1], outd[:hi], bv.settings,
                                np.asarray(data), first_node=lo,
                                **plan_kw)
    return prep, lo, hi
