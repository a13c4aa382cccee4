"""HyperBall — approximate neighbourhood function via HyperLogLog counters.

Device re-design of HyperBall (reference HyperBall.java:217-1130): the
reference keeps a big packed register array updated by a thread team with
broadword max-merges over arc-balanced task chunks; here the counter array
is a dense (n, 2^log2m) uint8 register matrix on device and one iteration is
a single edge-parallel ``segment_max``: c'[x] = max(c[x], max over
successors c[y]) — the natural array formulation of the same broadword merge.

Per-iteration outputs mirror the reference: the neighbourhood function
estimate, the number of modified counters (stopping criterion), and the
discounted centrality accumulators (sum of distances / sum of inverse
distances, HyperBall.java main options), accumulated from per-node count
deltas.

The hash is splitmix64 (documented: the Java reference uses its own jenkins
hash, so *estimates* differ across implementations while statistical
guarantees match; bit-exactness here means parallel == sequential oracle,
the reference's own test discipline, HyperBallTest.java:63-74).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.graph import CSRGraph

__all__ = ["HyperBall", "hyperloglog_init", "estimate_counts",
           "sequential_hyperball"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def hyperloglog_init(n: int, log2m: int, seed: int = 0) -> np.ndarray:
    """Initial registers: each node's counter contains only itself
    (HyperBall.init :571).  Returns uint8 (n, 2^log2m)."""
    m = 1 << log2m
    regs = np.zeros((n, m), dtype=np.uint8)
    h = _splitmix64(np.arange(n, dtype=np.uint64)
                    + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
    j = (h & np.uint64(m - 1)).astype(np.int64)
    w = h >> np.uint64(log2m)
    # rho = trailing zeros of w + 1 (capped)
    rho = np.ones(n, dtype=np.uint8)
    ww = w.copy()
    zero_mask = ww == 0
    rho_v = np.zeros(n, dtype=np.int64)
    ww_nonzero = np.where(zero_mask, np.uint64(1), ww)
    # count trailing zeros via bit tricks
    tz = np.zeros(n, dtype=np.int64)
    v = ww_nonzero.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (v & ((np.uint64(1) << np.uint64(shift)) - np.uint64(1))) == 0
        tz = np.where(mask, tz + shift, tz)
        v = np.where(mask, v >> np.uint64(shift), v)
    rho_v = np.where(zero_mask, 64 - log2m, tz) + 1
    regs[np.arange(n), j] = rho_v.astype(np.uint8)
    return regs


def estimate_counts(regs: np.ndarray) -> np.ndarray:
    """Per-node HLL cardinality estimates with small-range correction."""
    regs = np.asarray(regs)
    m = regs.shape[1]
    est = _alpha(m) * m * m / np.sum(
        np.exp2(-regs.astype(np.float64)), axis=1)
    zeros = np.sum(regs == 0, axis=1)
    small = (est <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lin = m * np.log(m / np.maximum(zeros, 1e-300))
    return np.where(small, lin, est)


@jax.jit
def _hb_round(arc_src, arc_tgt, regs):
    """One HyperBall iteration: register max-merge over all arcs."""
    gathered = jnp.take(regs, arc_tgt, axis=0)          # (m_arcs, R)
    merged = jax.ops.segment_max(
        gathered, arc_src, num_segments=regs.shape[0],
        indices_are_sorted=True)
    merged = jnp.maximum(regs, merged.astype(regs.dtype))
    return merged


@functools.partial(jax.jit, static_argnames=("m",))
def _arc_src_device(bounds, m: int):
    """Per-arc source-node ids from CSR offsets, built on device
    (bounds = csr_off[1:-1] as int32)."""
    return jnp.cumsum(jnp.zeros((m,), jnp.int32)
                      .at[bounds].add(1, mode="drop"))


@jax.jit
def pack_registers(regs_u8):
    """(n, R) uint8 registers -> (n, R//4) uint32 words, 4 registers per
    word in little-endian byte order (the analogue of the reference's
    packed broadword register array, HyperLogLogCounterArray).  Shift
    arithmetic, no bitcasts."""
    n, R = regs_u8.shape
    g = regs_u8.reshape(n, R // 4, 4).astype(jnp.uint32)
    sh = jnp.arange(4, dtype=jnp.uint32) * 8
    return jnp.sum(g << sh[None, None, :], axis=2, dtype=jnp.uint32)


@jax.jit
def unpack_registers(packed_u32):
    """(n, R//4) uint32 -> (n, R) uint8 (inverse of pack_registers)."""
    n, R4 = packed_u32.shape
    sh = jnp.arange(4, dtype=jnp.uint32) * 8
    b = (packed_u32[:, :, None] >> sh[None, None, :]) & jnp.uint32(0xFF)
    return b.astype(jnp.uint8).reshape(n, R4 * 4)


@functools.partial(jax.jit, static_argnames=("logw", "n", "total"))
def _build_class_tgt(succ, starts, lens, logw: int, n: int, total: int):
    """Flat padded per-class successor indices, built on device with 1-D
    ops only (row = j >> logw, offset = j & (width-1))."""
    j = jnp.arange(total, dtype=jnp.int32)
    row = j >> logw
    off = j & ((1 << logw) - 1)
    s = jnp.take(starts, row)
    ln = jnp.take(lens, row)
    idx = jnp.clip(s + off, 0, max(succ.shape[0] - 1, 0))
    t = jnp.take(succ, idx) if succ.shape[0] else jnp.zeros_like(idx)
    return jnp.where(off >= ln, jnp.int32(n), t)


def _swar_max(x, y):
    """Byte-wise max of packed uint32 register words.  HLL registers are
    <= 64 < 0x80, so the per-byte borrow in (x | H) - y can never cross
    bytes and the H-bit of each byte is exactly x_b >= y_b (the broadword
    discipline of the reference's HyperLogLogCounterArray.max)."""
    H = jnp.uint32(0x80808080)
    ge = ((x | H) - y) & H
    msk = (ge - (ge >> 7)) | ge          # 0xFF per byte where x_b >= y_b
    return (x & msk) | (y & ~msk)


class DenseRoundPlan:
    """Dense HyperBall round at memory-bandwidth speed: nodes are grouped
    into power-of-2 degree classes, each class's successor lists padded to
    the class width, so the register max-merge is a DENSE tree reduction
    over packed words instead of a per-element segment_max.  The padded
    target arrays build once on device.

    This is the analogue of the reference's broadword max over arc-
    balanced task chunks (HyperBall.java:654-900) re-shaped as array ops.
    """

    def __init__(self, csr_off: np.ndarray, succ_dev, max_class: int = 14):
        co = np.asarray(csr_off, dtype=np.int64)
        n = len(co) - 1
        deg = np.diff(co)
        cls = np.zeros(n, dtype=np.int32)
        nz = deg > 0
        cls[nz] = np.ceil(np.log2(deg[nz])).astype(np.int32)
        # huge-degree nodes (beyond 2^max_class) fall into chunked rows of
        # the widest class, merged across chunks by repeated scatter-max
        self.classes = []
        succ_dev = succ_dev.astype(jnp.int32)

        def add_class(width, rows, starts, lens, subw=32):
            """One class entry: rows of ``width`` lanes, ``32 // subw``
            nodes PACKED per 32-lane block (subw < 32 packs several small
            nodes into one gather row — the dominant cost is padded rows
            gathered, and sub-32-degree nodes are the bulk of a web
            graph).  Dummy pad slots get row id n (scatter mode=drop) and
            zero length (sentinel targets gather neutral zeros)."""
            if not len(rows):
                return
            p = 32 // subw
            if p > 1:
                pad = (-len(rows)) % p
                if pad:
                    rows = np.concatenate([rows, np.full(pad, n,
                                                         rows.dtype)])
                    starts = np.concatenate([starts,
                                             np.zeros(pad, starts.dtype)])
                    lens = np.concatenate([lens,
                                           np.zeros(pad, lens.dtype)])
            # flat padded target index (pad -> sentinel n: OOB fill-gather
            # yields all-zero register rows, neutral for max).  Everything
            # stays 1-D or (X, R/4).
            tgt = _build_class_tgt(
                succ_dev, jnp.asarray(starts.astype(np.int32)),
                jnp.asarray(lens.astype(np.int32)),
                logw=int(np.log2(subw if p > 1 else width)), n=n,
                total=len(rows) * (subw if p > 1 else width))
            rows_h = tuple(jnp.asarray(rows[h::p].astype(np.int32))
                           for h in range(p))
            self.classes.append((width, p, subw, rows_h, tgt))

        # classes below width 32 are padded UP to a 32-lane block, so
        # every class works in (R4, X) transposed form with 32-lane rows —
        # but degree <= 8 / <= 16 nodes PACK 4 / 2 per row (the un-packed
        # width-32 class pads 537M rows to 721M at uk scale)
        sel = np.flatnonzero(nz & (deg <= 8))
        add_class(32, sel, co[sel], deg[sel], subw=8)
        sel = np.flatnonzero(nz & (deg > 8) & (deg <= 16))
        add_class(32, sel, co[sel], deg[sel], subw=16)
        sel = np.flatnonzero(nz & (deg > 16) & (cls <= 5))
        add_class(32, sel, co[sel], deg[sel])
        for c in range(6, max_class):
            sel = np.flatnonzero(nz & (cls == c))
            add_class(1 << c, sel, co[sel], deg[sel])
        # widest class: nodes beyond 2^max_class split into width-sized
        # chunk rows; each chunk LEVEL is its own entry so scatter rows
        # stay unique (sequential class passes max-merge into `out`)
        width = 1 << max_class
        wide = np.flatnonzero(nz & (cls >= max_class))
        if len(wide):
            nch = -(-deg[wide] // width)
            for lvl in range(int(nch.max())):
                sl = wide[nch > lvl]
                starts = co[sl] + lvl * width
                lens = np.minimum(co[sl + 1] - starts, width)
                add_class(width, sl, starts, lens)
        self.n = n

    # flat padded rows per dispatch: bounds the gather+reduction transient
    # so rounds coexist with a resident decode plan in HBM
    CHUNK_FLAT = 16 << 20

    def round(self, packed):
        """packed (n, R/4) uint32 -> merged packed registers.

        All intermediates are (R4, X)-transposed: the big dimension stays
        minor."""
        R4 = packed.shape[1]
        packed_t = packed.T                     # (R4, n): one relayout
        out = packed
        for width, p, subw, rows_h, tgt in self.classes:
            roww = subw if p > 1 else width     # lanes gathered per slot
            k = int(tgt.shape[0]) // roww       # slots
            step_k = max(p, (self.CHUNK_FLAT // roww) // p * p)
            for lo in range(0, k, step_k):
                hi = min(lo + step_k, k)
                kk = (hi - lo) // p if p > 1 else hi - lo
                # (R4, kk, width) gather along the node axis; tree-reduce
                # by contiguous halving down to 32 lanes, then a
                # rotate-reduce (shifts subw/2..1) that never leaves a
                # lane's subw-block — max is commutative so any pairing
                # tree is exact, sub-32 minors never materialize, and
                # with p > 1 lanes h*subw hold the h-th packed node's max
                g = jnp.take(packed_t, tgt[lo * roww:hi * roww], axis=1,
                             mode="fill", fill_value=0)
                g = g.reshape(R4, kk, 32 if p > 1 else width)
                c = width if p == 1 else 32
                while c > 32:
                    half = c // 2
                    g = _swar_max(g[:, :, :half], g[:, :, half:])
                    c = half
                sh = subw // 2
                while sh >= 1:
                    g = _swar_max(g, jnp.roll(g, -sh, axis=2))
                    sh //= 2
                for h in range(p):
                    merged = g[:, :, h * subw].T       # (kk, R4)
                    rs = rows_h[h][lo // p:hi // p] if p > 1 \
                        else rows_h[0][lo:hi]
                    out = out.at[rs].set(
                        _swar_max(merged, jnp.take(out, rs, axis=0)),
                        mode="drop")
        return out


def device_round(csr_off: np.ndarray, succ_dev, regs_dev, plan=None):
    """One HyperBall iteration consuming a DEVICE-resident CSR — e.g. the
    product of ``ops.kdecode.decode_to_csr`` — with no host roundtrip
    (the reference's iteration consumes successors straight off the graph
    iterator, HyperBall.java:654-900).  Returns the merged registers.

    ``csr_off``: host int64[n+1]; ``succ_dev``: device int32/int64[m];
    ``regs_dev``: device uint8 (n, 2^log2m) register array, or a PACKED
    uint32 (n, 2^log2m / 4) array from :func:`pack_registers` (returned in
    kind).  The packed path runs through a :class:`DenseRoundPlan`
    (degree-class dense reductions); pass ``plan`` to reuse one across
    rounds."""
    if regs_dev.dtype == jnp.uint32:
        if plan is None:
            plan = DenseRoundPlan(csr_off, succ_dev)
        return plan.round(regs_dev)
    csr_off = np.asarray(csr_off)
    m = int(csr_off[-1])
    bounds = jnp.asarray(csr_off[1:-1].astype(np.int32))
    src = _arc_src_device(bounds, m)
    return _hb_round(src, succ_dev, regs_dev)


@functools.partial(jax.jit, static_argnames=("num_must",))
def _hb_round_sparse(seg, tgt, must, regs, num_must):
    """Sparse round: max-merge only the arcs of the must-check nodes.

    ``seg`` maps each (padded) arc to its source's row in ``must``; padded
    arcs point at the trailing dummy segment, padded must rows carry node
    index n (dropped by the scatter).  Returns (regs', changed_rows) where
    changed_rows is per-must-row."""
    gathered = jnp.take(regs, tgt, axis=0, mode="fill", fill_value=0)
    merged = jax.ops.segment_max(gathered, seg, num_segments=num_must + 1,
                                 indices_are_sorted=True)[:-1]
    old = jnp.take(regs, must, axis=0, mode="fill", fill_value=0)
    new = jnp.maximum(old, merged.astype(regs.dtype))
    changed = jnp.any(new != old, axis=1)
    regs = regs.at[must].set(new, mode="drop")
    return regs, changed


@functools.partial(jax.jit, static_argnames=("num_seg",))
def _hb_merge(gathered, seg, old, num_seg):
    """Device merge of pre-gathered successor registers: one segment_max
    plus change detection (the broadword max-merge of
    HyperBall.IterationThread:654-900 as a batched array op)."""
    merged = jax.ops.segment_max(gathered, seg, num_segments=num_seg + 1,
                                 indices_are_sorted=True)[:-1]
    new = jnp.maximum(old, merged.astype(old.dtype))
    return new, jnp.any(new != old, axis=1)


def _pow2(x: int, floor: int = 8) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(x, 1)))))


class HyperBall:
    """Iterative neighbourhood-function computation (HyperBall.run).

    When the transpose graph ``gt`` is supplied, rounds become **sparse**
    once fewer than half the counters changed (the reference's systolic
    threshold, HyperBall.java:1011): the must-check set — predecessors of
    last round's modified counters, found through the transpose — is
    computed up front and the round max-merges only those nodes' arcs
    (register monotonicity makes this exact: a counter without a modified
    successor cannot change).  When the must-check set shrinks below 1% of
    the nodes the round is labelled **local** (HyperBall.java:1021); both
    run the same padded-subset device kernel, whose cost is proportional to
    the arcs actually touched rather than to m.  Without ``gt`` every round
    is dense, as in the reference."""

    def __init__(self, g: CSRGraph, log2m: int = 6, seed: int = 0,
                 gt: Optional[CSRGraph] = None,
                 do_sum_of_distances: bool = False,
                 do_sum_of_inverse_distances: bool = False,
                 external_chunk: int = 0,
                 regs_path: Optional[str] = None):
        """``external_chunk`` > 0 enables the **external** update mode
        (HyperBall.java:268-273, :1104-1130 re-designed): registers stay on
        the host — in a disk-backed memmap when ``regs_path`` is given —
        and each round streams <= external_chunk arcs' worth of gathered
        successor registers through the device merge, so device memory is
        bounded by the chunk, not by n * 2^log2m (the 10^11-node regime)."""
        self.g = g
        self.log2m = log2m
        self.seed = seed
        n = g.num_nodes
        self._off = np.asarray(g.to_csr().offsets, dtype=np.int64)
        self._succ = np.asarray(g.to_csr().succ, dtype=np.int64)
        if gt is not None:
            gtc = gt.to_csr()
            self._gt_off = np.asarray(gtc.offsets, dtype=np.int64)
            self._gt_succ = np.asarray(gtc.succ, dtype=np.int64)
        else:
            self._gt_off = self._gt_succ = None
        self.external_chunk = int(external_chunk)
        init = hyperloglog_init(n, log2m, seed)
        if self.external_chunk:
            self._src = self._tgt = None
            if regs_path is not None:
                mm = np.lib.format.open_memmap(
                    regs_path, mode="w+", dtype=np.uint8, shape=init.shape)
                mm[:] = init
                mm.flush()
                self.regs = mm
            else:
                self.regs = init
        else:
            src, tgt = g.arcs()
            self._src = jnp.asarray(src, dtype=jnp.int32)
            self._tgt = jnp.asarray(tgt, dtype=jnp.int32)
            self.regs = jnp.asarray(init)
        self._counts = estimate_counts(init)
        self.neighbourhood_function: List[float] = [float(n)]
        self.modified = n
        self._mod_mask: Optional[np.ndarray] = None  # None => dense next
        self.iteration = 0
        self.mode_history: List[str] = []
        self.arcs_touched: List[int] = []
        self.sum_of_distances = (np.zeros(n) if do_sum_of_distances else None)
        self.sum_of_inverse_distances = (
            np.zeros(n) if do_sum_of_inverse_distances else None)

    # -- persistence (the analogue of HyperBall main's per-iteration BinIO
    # register dumps, so long runs can resume) ------------------------------
    def save_state(self, path: str) -> None:
        np.savez_compressed(
            path, regs=np.asarray(self.regs), counts=self._counts,
            nf=np.asarray(self.neighbourhood_function),
            iteration=self.iteration, modified=self.modified,
            mod_mask=(self._mod_mask if self._mod_mask is not None
                      else np.zeros(0, dtype=bool)),
            sum_of_distances=(self.sum_of_distances
                              if self.sum_of_distances is not None
                              else np.zeros(0)),
            sum_of_inverse_distances=(
                self.sum_of_inverse_distances
                if self.sum_of_inverse_distances is not None
                else np.zeros(0)),
            log2m=self.log2m, seed=self.seed)

    def load_state(self, path: str) -> None:
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        assert int(z["log2m"]) == self.log2m and int(z["seed"]) == self.seed
        if self.external_chunk:
            self.regs[:] = z["regs"]
        else:
            self.regs = jnp.asarray(z["regs"])
        self._counts = z["counts"]
        self.neighbourhood_function = [float(v) for v in z["nf"]]
        self.iteration = int(z["iteration"])
        self.modified = int(z["modified"])
        mm = z["mod_mask"]
        self._mod_mask = mm if mm.size else None
        if z["sum_of_distances"].size:
            self.sum_of_distances = z["sum_of_distances"]
        if z["sum_of_inverse_distances"].size:
            self.sum_of_inverse_distances = z["sum_of_inverse_distances"]

    def _must_check(self) -> np.ndarray:
        """Predecessors (through the transpose) of last round's modified
        counters — the only nodes whose counters can change this round."""
        mod_nodes = np.flatnonzero(self._mod_mask)
        cnt = self._gt_off[mod_nodes + 1] - self._gt_off[mod_nodes]
        tot = int(cnt.sum())
        pos = (np.arange(tot, dtype=np.int64)
               - np.repeat(np.cumsum(cnt) - cnt, cnt))
        idx = np.repeat(self._gt_off[mod_nodes], cnt) + pos
        return np.unique(self._gt_succ[idx])

    def _iterate_external(self) -> int:
        """External-mode round: host-resident registers, device merges over
        <= external_chunk-arc batches of the active node set (dense, or the
        systolic/local must-check set when the transpose is available)."""
        n = self.g.num_nodes
        t = self.iteration + 1
        sparse = (self._gt_off is not None and self._mod_mask is not None
                  and self.modified < n // 2)
        if sparse:
            must = self._must_check()
            mode = ("local" if self.modified * self.g.num_arcs * 10 < n * n
                    else "systolic") + "-external"
        else:
            must = np.arange(n, dtype=np.int64)
            mode = "dense-external"
        regs = self.regs
        R = regs.shape[1]
        cnt = self._off[must + 1] - self._off[must]
        ccum = np.concatenate([[0], np.cumsum(cnt)])
        tot = int(ccum[-1])
        changed_list = []
        updates = []
        touched = 0
        lo = 0
        while lo < len(must):
            hi = int(np.searchsorted(ccum, ccum[lo] + self.external_chunk,
                                     "right")) - 1
            hi = min(max(hi, lo + 1), len(must))
            b = must[lo:hi]
            cb = cnt[lo:hi]
            tb = int(cb.sum())
            aidx = (np.repeat(self._off[b], cb)
                    + np.arange(tb, dtype=np.int64)
                    - np.repeat(ccum[lo:hi] - ccum[lo], cb))
            P, E = _pow2(len(b)), _pow2(tb)
            seg_p = np.full(E, P, dtype=np.int32)
            seg_p[:tb] = np.repeat(np.arange(len(b), dtype=np.int32), cb)
            gathered = np.zeros((E, R), dtype=np.uint8)
            gathered[:tb] = regs[self._succ[aidx]]   # the host "spill" read
            old = np.zeros((P, R), dtype=np.uint8)
            old[:len(b)] = regs[b]
            new, changed = _hb_merge(jnp.asarray(gathered),
                                     jnp.asarray(seg_p),
                                     jnp.asarray(old), P)
            ch = np.asarray(changed)[:len(b)]
            if ch.any():
                # buffered update list (the analogue of the reference's
                # spilled updates, HyperBall.java:1104-1130): applied only
                # after the full round so every batch reads the previous
                # round's registers (synchronous, register-exact)
                updates.append((b[ch], np.asarray(new)[:len(b)][ch]))
                changed_list.append(b[ch])
            touched += tb
            lo = hi
        for rows, vals in updates:
            regs[rows] = vals
        changed_nodes = (np.concatenate(changed_list) if changed_list
                         else np.zeros(0, dtype=np.int64))
        self.arcs_touched.append(touched)
        self.mode_history.append(mode)
        mask = np.zeros(n, dtype=bool)
        mask[changed_nodes] = True
        self._mod_mask = mask
        self.modified = int(len(changed_nodes))
        self.iteration = t
        if len(changed_nodes):
            new_counts = estimate_counts(regs[changed_nodes])
            delta = np.maximum(new_counts - self._counts[changed_nodes], 0.0)
            if self.sum_of_distances is not None:
                self.sum_of_distances[changed_nodes] += t * delta
            if self.sum_of_inverse_distances is not None:
                self.sum_of_inverse_distances[changed_nodes] += delta / t
            self._counts[changed_nodes] = new_counts
        self.neighbourhood_function.append(float(self._counts.sum()))
        return self.modified

    def iterate(self) -> int:
        """One iteration; returns the number of modified counters
        (HyperBall.iterate :1000)."""
        if self.external_chunk:
            return self._iterate_external()
        n = self.g.num_nodes
        sparse = (self._gt_off is not None and self._mod_mask is not None
                  and self.modified < n // 2)
        t = self.iteration + 1
        if sparse:
            must = self._must_check()
            # label per the reference's preLocal condition
            # (HyperBall.java:1021): modified < 0.1 * n^2 / m
            mode = ("local" if self.modified * self.g.num_arcs * 10 < n * n
                    else "systolic")
            cnt = self._off[must + 1] - self._off[must]
            tot = int(cnt.sum())
            pos = (np.arange(tot, dtype=np.int64)
                   - np.repeat(np.cumsum(cnt) - cnt, cnt))
            aidx = np.repeat(self._off[must], cnt) + pos
            P, E = _pow2(len(must)), _pow2(tot)
            must_p = np.full(P, n, dtype=np.int32)
            must_p[:len(must)] = must
            seg_p = np.full(E, P, dtype=np.int32)
            seg_p[:tot] = np.repeat(np.arange(len(must), dtype=np.int32),
                                    cnt)
            tgt_p = np.full(E, n, dtype=np.int32)
            tgt_p[:tot] = self._succ[aidx]
            self.regs, changed = _hb_round_sparse(
                jnp.asarray(seg_p), jnp.asarray(tgt_p), jnp.asarray(must_p),
                self.regs, P)
            ch = np.asarray(changed)[:len(must)]
            changed_nodes = must[ch]
            self.arcs_touched.append(tot)
        else:
            mode = "dense"
            new = _hb_round(self._src, self._tgt, self.regs)
            changed_nodes = np.flatnonzero(
                np.asarray(jnp.any(new != self.regs, axis=1)))
            self.regs = new
            self.arcs_touched.append(self.g.num_arcs)
        self.mode_history.append(mode)
        mask = np.zeros(n, dtype=bool)
        mask[changed_nodes] = True
        self._mod_mask = mask
        self.modified = int(len(changed_nodes))
        self.iteration = t

        # incremental count update: only changed counters moved
        if len(changed_nodes):
            Pc = _pow2(len(changed_nodes))
            cn_p = np.full(Pc, 0, dtype=np.int32)
            cn_p[:len(changed_nodes)] = changed_nodes
            sub = np.asarray(jnp.take(self.regs, jnp.asarray(cn_p), axis=0))
            new_counts = estimate_counts(sub[:len(changed_nodes)])
            delta = np.maximum(new_counts - self._counts[changed_nodes], 0.0)
            if self.sum_of_distances is not None:
                self.sum_of_distances[changed_nodes] += t * delta
            if self.sum_of_inverse_distances is not None:
                self.sum_of_inverse_distances[changed_nodes] += delta / t
            self._counts[changed_nodes] = new_counts
        self.neighbourhood_function.append(float(self._counts.sum()))
        return self.modified

    def run(self, upper_bound: int = -1, threshold: float = -1.0
            ) -> List[float]:
        """Iterate until no counter changes, the NF stabilizes below
        ``threshold`` relative change, or ``upper_bound`` iterations."""
        if upper_bound < 0:
            upper_bound = self.g.num_nodes
        while self.iteration < upper_bound:
            self.iterate()
            if self.modified == 0:
                break
            if threshold >= 0 and len(self.neighbourhood_function) >= 2:
                a, b = self.neighbourhood_function[-2:]
                if a != 0 and abs(b - a) / a < threshold:
                    break
        return self.neighbourhood_function

    def reachable_counts(self) -> np.ndarray:
        """Per-node reachable-set size estimates."""
        return self._counts.copy()


def sequential_hyperball(g: CSRGraph, log2m: int = 6, seed: int = 0,
                         iterations: int = -1) -> np.ndarray:
    """Scalar oracle: same registers, computed node by node in Python
    (the analogue of test SequentialHyperBall, SURVEY §4.4).  Returns the
    final register matrix for register-exact comparison."""
    n = g.num_nodes
    regs = hyperloglog_init(n, log2m, seed)
    if iterations < 0:
        iterations = n
    for _ in range(iterations):
        new = regs.copy()
        for x in range(n):
            succ = g.successors(x)
            if len(succ):
                new[x] = np.maximum(new[x], regs[succ].max(axis=0))
        if np.array_equal(new, regs):
            break
        regs = new
    return regs


def effective_diameter(neighbourhood_function, alpha: float = 0.9) -> float:
    """Effective diameter at fraction ``alpha`` from a neighbourhood
    function (the EstimateEffectiveDiameter computation): the interpolated
    t where NF(t) reaches alpha * NF(inf)."""
    nf = list(neighbourhood_function)
    if not nf:
        return 0.0
    target = alpha * nf[-1]
    for t in range(len(nf)):
        if nf[t] >= target:
            if t == 0:
                return 0.0
            prev, cur = nf[t - 1], nf[t]
            if cur == prev:
                return float(t)
            return (t - 1) + (target - prev) / (cur - prev)
    return float(len(nf) - 1)
