"""Vectorized BVGraph encoder (XLA ops, device-resident).

The device encode path (SURVEY §7 step 5; reference semantics
CompressionThread.call + diffComp, BVGraph.java:1977-2328).  The reference
encodes one node at a time: greedy reference selection sizes every window
candidate with a counting bit stream (:2256-2270), the winner's diff is
written with measure-then-write discipline (:2259/:2270).  Here the same
computation is re-shaped into four array passes:

1. **membership masks** — for every arc (x, v) and every r in 1..W, does
   the arc (x-r, v) / (x+r, v) exist?  One lexicographic device sort of
   (value, node) puts all arcs sharing a value next to each other; W static
   shifted compares then recover both mask directions with no gathers
   inside loops and no searchsorted.
2. **candidate cost matrix** — copy blocks are the run-length encoding of
   the ref-list membership mask minus its trailing run (two-pointer walk
   BVGraph.java:1996-2051 == RLE over "ref element is in curr list");
   intervals/residuals of the leftover are segmented-scan run detection
   (intervalize :1595-1618).  All (x, r) costs in parallel as closed-form
   code lengths.
3. **greedy selection** — the only sequential step (ref_count chains couple
   consecutive nodes); runs in the native layer over the cost matrix
   (wg_select_refs, exactly :2256-2270 semantics).
4. **packing** — winner tokens (value, code, length) land in a statically
   laid-out slot array; an exclusive scan of lengths gives every token's
   bit position; each token scatters into <= 3 big-endian 32-bit words
   (measure-then-pack, the reference's own two-pass proof of equivalence).

Byte-identical to the scalar oracle (codecs/bvgraph._Encoder), which is
byte-identical to the Java reference on cnr-2000.

64-bit code words require x64 tracing: all entry points trace under
``jax.enable_x64(True)``; large index arrays stay int32.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs.bvgraph import CompressionFlags as _C

__all__ = ["encode_csr", "encode_csr_chunked", "pack_chunk", "pack_gaps",
           "cost_matrix", "member_masks", "select_refs", "supported",
           "EncodeDevicePlan"]

_I32 = jnp.int32
_I64 = jnp.int64
_U64 = jnp.uint64


def supported(settings) -> bool:
    """Codes the vectorized encoder can pack (the defaults and every
    config in the reference's compression sweep; Golomb/nibble residuals
    fall back to the scalar/native encoders)."""
    gd = (_C.GAMMA, _C.DELTA)
    return (settings.outdegree_coding in gd
            and settings.reference_coding in (_C.UNARY, _C.GAMMA, _C.DELTA)
            and settings.block_count_coding in (_C.UNARY, _C.GAMMA, _C.DELTA)
            and settings.block_coding in (_C.UNARY, _C.GAMMA, _C.DELTA)
            and settings.residual_coding in (_C.ZETA, _C.GAMMA, _C.DELTA)
            and settings.offset_coding in gd
            and 0 <= settings.window_size <= 7)


# ---------------------------------------------------------------------------
# closed-form instantaneous codes: value -> (bits uint64, length int32)
# (MSB-first stream; bit patterns per ops/bitio.py write_* semantics)
# ---------------------------------------------------------------------------


def _msb64(z):
    """floor(log2(z)) for z >= 1 (int64)."""
    return 63 - jax.lax.clz(z.astype(_I64))


def _gamma(x):
    z = x.astype(_I64) + 1
    b = _msb64(z)
    return z.astype(_U64), (2 * b + 1).astype(_I32)


def _delta(x):
    z = x.astype(_I64) + 1
    b = _msb64(z)
    zb = (b + 1).astype(_I64)
    bb = _msb64(zb)
    bits = (zb.astype(_U64) << b.astype(_U64)) | (z - (_one64() << b)
                                                  ).astype(_U64)
    return bits, (2 * bb + 1 + b).astype(_I32)


def _unary(x):
    return jnp.ones_like(x, dtype=_U64), (x + 1).astype(_I32)


def _one64():
    return jnp.asarray(1, dtype=_I64)


def _zeta(x, k: int):
    z = x.astype(_I64) + 1
    h = _msb64(z) // k
    hk = h * k
    left = _one64() << hk
    short = z < (left << 1)
    w = jnp.where(short, hk + k - 1, hk + k)
    field = jnp.where(short, z - left, z)
    bits = (_one64().astype(_U64) << w.astype(_U64)) | field.astype(_U64)
    return bits, (h + 1 + w).astype(_I32)


def _code(kind: int, x, zeta_k: int = 3):
    if kind == _C.GAMMA:
        return _gamma(x)
    if kind == _C.DELTA:
        return _delta(x)
    if kind == _C.UNARY:
        return _unary(x)
    if kind == _C.ZETA:
        return _zeta(x, zeta_k)
    raise NotImplementedError(kind)


def _code_len(kind: int, x, zeta_k: int = 3):
    return _code(kind, x, zeta_k)[1]


def _int2nat(x):
    return (x << 1) ^ (x >> 63) if x.dtype == _I64 else \
        ((x.astype(_I64) << 1) ^ (x.astype(_I64) >> 63))


# ---------------------------------------------------------------------------
# membership masks
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("W",))
def _member_masks_dev(seg, val, W: int):
    m = seg.shape[0]
    idx = jnp.arange(m, dtype=_I32)
    sv, sx, si = jax.lax.sort([val, seg, idx], num_keys=2)
    down = jnp.zeros(m, dtype=_I32)
    up = jnp.zeros(m, dtype=_I32)
    for s in range(1, W + 1):
        if s >= m:
            break
        pv = jnp.concatenate([jnp.full(s, -1, _I32), sv[:-s]])
        px = jnp.concatenate([jnp.full(s, -(1 << 30), _I32), sx[:-s]])
        dx = sx - px
        hit = (pv == sv) & (dx <= W)
        down = down | jnp.where(hit, jnp.left_shift(1, dx), 0)
        nv = jnp.concatenate([sv[s:], jnp.full(s, -1, _I32)])
        nx = jnp.concatenate([sx[s:], jnp.full(s, -(1 << 30), _I32)])
        du = nx - sx
        hitu = (nv == sv) & (du >= 1) & (du <= W)
        up = up | jnp.where(hitu, jnp.left_shift(1, du), 0)
    z = jnp.zeros(m, dtype=_I32)
    return z.at[si].set(down), z.at[si].set(up)


def member_masks(seg: np.ndarray, val: np.ndarray, W: int):
    """Per-arc bitmasks: ``down`` bit r set iff arc (seg-r, val) exists,
    ``up`` bit r set iff arc (seg+r, val) exists (r in 1..W)."""
    with jax.enable_x64(True):
        return _member_masks_dev(jnp.asarray(seg, dtype=_I32),
                                 jnp.asarray(val, dtype=_I32), W)


# ---------------------------------------------------------------------------
# segmented-scan helpers (arc arrays; is_first marks each node's first arc)
# ---------------------------------------------------------------------------


def _seg_cumsum_excl(x, first_idx):
    """Exclusive per-segment cumsum: number of earlier x (summed) in the
    same segment."""
    cs = jnp.cumsum(x)
    incl = cs - jnp.take(cs, first_idx) + jnp.take(x, first_idx)
    return incl - x


def _prev_where(cond, first_idx):
    """Index of the latest position j < i in i's segment with cond[j],
    or -1.  (Global cummax works: indices are monotone so earlier segments
    can't win once the segment start resets the comparison via the >=
    first_idx guard.)"""
    m = cond.shape[0]
    i = jnp.arange(m, dtype=_I32)
    v = jnp.where(cond, i, -1)
    cm = jax.lax.cummax(v)
    prev = jnp.concatenate([jnp.full(1, -1, _I32), cm[:-1]])
    return jnp.where(prev >= first_idx, prev, -1)


def _next_where(cond, last_idx):
    """Index of the earliest position j > i in i's segment with cond[j],
    or -1."""
    m = cond.shape[0]
    i = jnp.arange(m, dtype=_I32)
    v = jnp.where(cond, i, jnp.asarray(1 << 30, _I32))
    cmr = jnp.flip(jax.lax.cummin(jnp.flip(v)))
    nxt = jnp.concatenate([cmr[1:], jnp.full(1, 1 << 30, _I32)])
    return jnp.where(nxt <= last_idx, nxt, -1)


def _at_or_after_where(cond, last_idx):
    """Earliest j >= i in i's segment with cond[j], or -1."""
    m = cond.shape[0]
    i = jnp.arange(m, dtype=_I32)
    v = jnp.where(cond, i, jnp.asarray(1 << 30, _I32))
    res = jnp.flip(jax.lax.cummin(jnp.flip(v)))
    return jnp.where(res <= last_idx, res, -1)


# ---------------------------------------------------------------------------
# copy-block costs / tokens (over REF-list arcs)
# ---------------------------------------------------------------------------


def _blocks_scan(mem, is_first, first_idx, last_idx):
    """Shared RLE analysis of a ref-list membership mask.

    Returns (lead, trans_at, run_end_internal, blk_val, blk_j):
      lead[i]: segment's first element is F (virtual leading empty copy run)
      trans_at[i]: run transition at i (i > seg start)
      run_end_internal[i]: i ends a run that is NOT the segment's last
      blk_val[i]: run length ending at i; blk_j[i]: its 0-based block index
      (counting the virtual leading run)."""
    prev_mem = jnp.concatenate([jnp.zeros(1, jnp.bool_), mem[:-1]])
    trans_at = (~is_first) & (mem != prev_mem)
    lead_seg = ~jnp.take(mem, first_idx)      # per-arc: segment starts F
    rid = _seg_cumsum_excl(trans_at.astype(_I32), first_idx) \
        + trans_at.astype(_I32)               # inclusive run index
    i = jnp.arange(mem.shape[0], dtype=_I32)
    start_cond = trans_at | is_first
    rs = jnp.where(start_cond, i, -1)
    rs = jax.lax.cummax(rs)                   # current run start (monotone)
    nxt = jnp.concatenate([trans_at[1:], jnp.zeros(1, jnp.bool_)])
    run_end_internal = nxt & (i < last_idx)   # a transition follows in-seg
    blk_val = i - rs + 1
    blk_j = rid + lead_seg.astype(_I32)
    return lead_seg, trans_at, run_end_internal, blk_val, blk_j


def _blocks_cost(mem, is_first, first_idx, last_idx, spec):
    """Per-arc block-token cost + per-arc-at-seg-start (bc value) parts.

    Returns (cost_per_arc int32, bc int32 per arc valid at seg start)."""
    lead, trans_at, rei, blk_val, blk_j = _blocks_scan(
        mem, is_first, first_idx, last_idx)
    emitted = jnp.where(blk_j > 0, blk_val - 1, blk_val)
    cost = jnp.where(rei,
                     _code_len(spec["block"], emitted, spec["zk"]), 0)
    # virtual leading empty block: value 0 at j = 0, attached to seg start
    cost = cost + jnp.where(is_first & lead,
                            _code_len(spec["block"],
                                      jnp.zeros_like(blk_val), spec["zk"]),
                            0)
    ntrans = _seg_cumsum_excl(trans_at.astype(_I32), first_idx) \
        + trans_at.astype(_I32)
    bc = jnp.take(ntrans, last_idx) + lead.astype(_I32)  # per arc
    return cost, bc


# ---------------------------------------------------------------------------
# extras (intervals + residuals) costs over CURR-list arcs
# ---------------------------------------------------------------------------


def _extras_scan(kept, v, is_first, first_idx, last_idx, minint: int):
    """Shared interval/residual analysis of a kept (extras) mask.

    Returns dict with per-arc: is_int (intervalized), int_start, res (is
    residual), ce (exclusive kept count), run_len (at int_start), plus
    helpers."""
    pk = _prev_where(kept, first_idx)
    pv = jnp.take(v, jnp.maximum(pk, 0))
    chain = kept & (pk >= 0) & (v == pv + 1)
    run_start = kept & ~chain
    ce = _seg_cumsum_excl(kept.astype(_I32), first_idx)
    i = jnp.arange(kept.shape[0], dtype=_I32)
    rs = jax.lax.cummax(jnp.where(run_start, i, -1))
    rs = jnp.where(rs >= first_idx, rs, first_idx)  # clamp (kept-only use)
    # run end: kept position whose next kept (if any, in-seg) starts a run
    nk = _next_where(kept, last_idx)
    nk_chain = jnp.where(nk >= 0, jnp.take(chain, jnp.maximum(nk, 0)),
                         False)
    run_end = kept & ((nk < 0) | ~nk_chain)
    re_idx = _at_or_after_where(run_end, last_idx)
    # total kept in run (valid at kept positions)
    L = jnp.take(ce, jnp.maximum(re_idx, 0)) - jnp.take(ce, rs) + 1
    if minint > 0:
        is_int = kept & (L >= minint)
    else:
        is_int = jnp.zeros_like(kept)
    int_start = run_start & is_int
    res = kept & ~is_int
    return dict(chain=chain, run_start=run_start, run_end=run_end, ce=ce,
                rs=rs, re_idx=re_idx, L=L, is_int=is_int,
                int_start=int_start, res=res)


def _extras_cost(kept, v, gx, is_first, first_idx, last_idx, spec):
    """Per-arc extras cost + the per-node interval-count token cost.

    The interval-count token (gamma) is attached to the segment's first
    arc; it exists iff the node has any extras and minint > 0."""
    minint = spec["minint"]
    E = _extras_scan(kept, v, is_first, first_idx, last_idx, minint)
    cost = jnp.zeros(kept.shape[0], dtype=_I32)
    if minint > 0:
        # interval tokens at interval run starts: left code + len code
        iidx = _seg_cumsum_excl(E["int_start"].astype(_I32), first_idx)
        prev_is = _prev_where(E["int_start"], first_idx)
        pl = jnp.take(v, jnp.maximum(prev_is, 0))
        pL = jnp.take(E["L"], jnp.maximum(prev_is, 0))
        left_val = jnp.where(iidx == 0,
                             _int2nat(v.astype(_I64) - gx.astype(_I64)),
                             (v - (pl + pL) - 1).astype(_I64))
        cost = cost + jnp.where(
            E["int_start"],
            _code_len(_C.GAMMA, left_val)
            + _code_len(_C.GAMMA, E["L"] - minint), 0)
        # per-node interval count token (gamma), on the first arc, only
        # when the node has extras
        n_int = jnp.take(
            _seg_cumsum_excl(E["int_start"].astype(_I32), first_idx)
            + E["int_start"].astype(_I32), last_idx)
        has_extras = (jnp.take(E["ce"], last_idx)
                      + jnp.take(kept, last_idx).astype(_I32)) > 0
        cost = cost + jnp.where(is_first & has_extras,
                                _code_len(_C.GAMMA, n_int), 0)
    # residual tokens
    ridx = _seg_cumsum_excl(E["res"].astype(_I32), first_idx)
    prev_r = _prev_where(E["res"], first_idx)
    pr = jnp.take(v, jnp.maximum(prev_r, 0))
    res_val = jnp.where(ridx == 0,
                        _int2nat(v.astype(_I64) - gx.astype(_I64)),
                        (v - pr - 1).astype(_I64))
    cost = cost + jnp.where(E["res"],
                            _code_len(spec["res"], res_val, spec["zk"]), 0)
    return cost


# ---------------------------------------------------------------------------
# cost matrix
# ---------------------------------------------------------------------------


def _spec(settings) -> Dict[str, int]:
    return dict(outd=settings.outdegree_coding,
                ref=settings.reference_coding,
                bcount=settings.block_count_coding,
                block=settings.block_coding,
                res=settings.residual_coding,
                off=settings.offset_coding,
                zk=settings.zeta_k,
                minint=settings.min_interval_length,
                W=settings.window_size)


@functools.partial(jax.jit, static_argnames=("spec_t",))
def _cost_matrix_dev(seg, v, gx, is_first, first_idx, last_idx, down, up,
                     co, node_gx, spec_t):
    """costs[x, r] for r in 0..W (int64; -1 = ineligible by construction
    is left to the selection pass — here every r with an existing nonempty
    ref list gets a real cost, others get a huge cost)."""
    spec = dict(spec_t)
    W = spec["W"]
    n = co.shape[0] - 1
    outd = (co[1:] - co[:-1]).astype(_I32)
    costs = []
    # r = 0: no blocks, extras = whole list
    c0 = _extras_cost(jnp.ones_like(is_first), v, gx, is_first, first_idx,
                      last_idx, spec)
    cost0 = jax.ops.segment_sum(c0, seg, num_segments=n,
                                indices_are_sorted=True)
    cost0 = cost0 + _code_len(spec["ref"], jnp.zeros(n, _I32)) \
        * (1 if W > 0 else 0)
    costs.append(cost0.astype(_I64))
    for r in range(1, W + 1):
        if r >= n:   # window deeper than the whole slice
            costs.append(jnp.full(n, -1, _I64))
            continue
        # blocks over ref lists: arc k of node y is in the ref list of
        # x = y + r; mem = does (y + r, w) exist = up bit r
        mem = ((up >> r) & 1).astype(jnp.bool_)
        bcost_arc, bc_arc = _blocks_cost(mem, is_first, first_idx,
                                         last_idx, spec)
        bcost = jax.ops.segment_sum(bcost_arc, seg, num_segments=n,
                                    indices_are_sorted=True)
        bc = jax.ops.segment_sum(
            jnp.where(is_first, bc_arc, 0), seg, num_segments=n,
            indices_are_sorted=True)
        bcost = bcost + _code_len(spec["bcount"], bc)
        # shift to x = y + r
        pad = jnp.zeros(r, dtype=bcost.dtype)
        bcost_x = jnp.concatenate([pad, bcost[:n - r]])
        # extras over curr lists: kept = not copied = down bit r unset
        kept = ~(((down >> r) & 1).astype(jnp.bool_))
        ecost_arc = _extras_cost(kept, v, gx, is_first, first_idx,
                                 last_idx, spec)
        ecost = jax.ops.segment_sum(ecost_arc, seg, num_segments=n,
                                    indices_are_sorted=True)
        total = (bcost_x + ecost
                 + _code_len(spec["ref"], jnp.full(n, r, _I32)))
        # eligibility by list existence is the selection pass's job; mark
        # x < r (no such window slot) with -1
        total = jnp.where(jnp.arange(n) < r, -1, total)
        costs.append(total.astype(_I64))
    return jnp.stack(costs, axis=1)  # (n, W+1)


def cost_matrix(co: np.ndarray, succ: np.ndarray, settings,
                node_base: int = 0) -> np.ndarray:
    """Candidate cost matrix (n, W+1): diff_comp bit counts for every
    window candidate (BVGraph.java:2256-2266 sizing pass, vectorized).
    ``node_base``: global id of local node 0 (for sliced encodes)."""
    spec = _spec(settings)
    co = np.asarray(co, dtype=np.int64)
    n = len(co) - 1
    m = int(co[-1])
    seg = np.repeat(np.arange(n, dtype=np.int32),
                    np.diff(co).astype(np.int64))
    with jax.enable_x64(True):
        segj = jnp.asarray(seg)
        vj = jnp.asarray(np.asarray(succ, dtype=np.int32))
        gxj = segj + np.int32(node_base)
        is_first = jnp.asarray(_is_first_np(co, m))
        first_idx = jnp.asarray(np.repeat(co[:-1], np.diff(co))
                                .astype(np.int32))
        last_idx = jnp.asarray(np.repeat(co[1:] - 1, np.diff(co))
                               .astype(np.int32))
        down, up = _member_masks_dev(segj, vj, spec["W"]) \
            if spec["W"] > 0 else (jnp.zeros(m, _I32), jnp.zeros(m, _I32))
        cm = _cost_matrix_dev(segj, vj, gxj, is_first, first_idx, last_idx,
                              down, up, jnp.asarray(co), None,
                              tuple(sorted(spec.items())))
        return np.asarray(cm)


def _is_first_np(co, m):
    f = np.zeros(m, dtype=bool)
    f[co[:-1][np.diff(co) > 0]] = True
    return f


@functools.partial(jax.jit, static_argnames=("W", "maxref", "B"))
def _select_refs_dev(costs, outd, W: int, maxref: int, B: int = 64):
    """Greedy reference selection as a device lax.scan (the native
    wg_select_refs semantics, BVGraph.java:2256-2270; single stream, no
    window resets).  Carries the last-W refcounts/outdegrees as small
    shift registers — no dynamic indexing, so nothing gathers inside the
    loop.  B nodes are processed per scan step with a statically unrolled
    inner loop, so the per-step scan latency amortizes over the block."""
    INF = jnp.int64(1) << jnp.int64(62)
    rr = jnp.arange(W, dtype=_I32)
    n = costs.shape[0]
    npad = -(-max(n, 1) // B) * B
    costs_p = jnp.concatenate(
        [costs, jnp.full((npad - n, W + 1), -1, costs.dtype)])
    outd_p = jnp.concatenate(
        [outd.astype(_I32), jnp.zeros(npad - n, _I32)])

    def step(carry, xs):
        rc_rel, wlen_rel = carry          # (W,): node x-1-r state
        crow, dxv = xs                    # (B, W+1), (B,)
        refs_b = []
        rcs_b = []
        for i in range(B):
            cost_row = crow[i]
            dx = dxv[i]
            valid = jnp.concatenate([
                jnp.ones((1,), bool),
                (rc_rel < maxref) & (wlen_rel != 0)]) & (cost_row >= 0)
            c = jnp.where(valid, cost_row, INF)
            best_r = jnp.argmin(c).astype(_I32)  # ties -> lowest r
            rc_prev = jnp.sum(jnp.where(rr == best_r - 1, rc_rel, 0),
                              dtype=_I32)
            rc_new = jnp.where(best_r == 0, 0, rc_prev + 1).astype(_I32)
            refs_b.append(jnp.where(dx == 0, 0, best_r).astype(_I32))
            rcs_b.append(jnp.where(dx == 0, 0, rc_new).astype(_I32))
            rc_rel = jnp.concatenate([rcs_b[-1][None], rc_rel[:-1]])
            wlen_rel = jnp.concatenate([dx[None], wlen_rel[:-1]])
        return (rc_rel, wlen_rel), (jnp.stack(refs_b), jnp.stack(rcs_b))

    carry0 = (jnp.zeros(W, _I32), jnp.zeros(W, _I32))
    _, (refs, rcs) = jax.lax.scan(
        step, carry0, (costs_p.reshape(npad // B, B, W + 1),
                       outd_p.reshape(npad // B, B)))
    return refs.reshape(npad)[:n], rcs.reshape(npad)[:n]


@functools.partial(jax.jit, static_argnames=("m", "n"))
def _arc_arrays_dev(co32, m: int, n: int):
    """Per-arc arrays (seg, is_first, first_idx, last_idx) derived on
    device from the CSR offsets — no host repeat/upload per encode."""
    seg = jnp.cumsum(jnp.zeros((m,), _I32)
                     .at[co32[1:-1]].add(1, mode="drop"))
    first_idx = jnp.take(co32, seg)
    last_idx = jnp.take(co32, seg + 1) - 1
    is_first = jnp.arange(m, dtype=_I32) == first_idx
    return seg, is_first, first_idx, last_idx


class EncodeDevicePlan:
    """Device-resident whole-graph encoder: the CSR uploads ONCE; each
    ``encode()`` is a handful of jitted dispatches (arc arrays -> masks ->
    cost matrix -> greedy-selection scan -> token pack) with only the
    compressed stream coming back.  Byte-identical to the
    scalar _Encoder / native encoder.  Sized for graphs whose token arrays
    fit HBM (~<= 48M arcs); bigger graphs use encode_csr_chunked."""

    def __init__(self, co: np.ndarray, succ: np.ndarray, settings):
        assert supported(settings)
        self.settings = settings
        self.spec = _spec(settings)
        co = np.asarray(co, dtype=np.int64)
        self.n = len(co) - 1
        self.m = int(co[-1])
        assert self.m < (1 << 31) and co[-1] == len(succ)
        self.co_host = co
        with jax.enable_x64(True):
            self.co64 = jnp.asarray(co)
            self.co32 = jnp.asarray(co.astype(np.int32))
            self.v = jnp.asarray(np.asarray(succ, dtype=np.int64)
                                 .astype(np.int32))
            self.outd = jnp.asarray(np.diff(co).astype(np.int32))

    def encode(self, selection: str = "native"):
        """Returns (graph_bytes, graph_bits, node_starts int64[n],
        refs int32[n], ref_counts int32[n], stats int64[138]).

        ``selection``: "native" downloads the device cost matrix once and
        runs the host greedy pass (wg_select_refs) — the sequential
        recurrence executes as tiny-vector op chains on device; "scan"
        keeps it fully
        on-device (the block-unrolled lax.scan) for environments where
        host<->device bandwidth is the scarcer resource."""
        spec = self.spec
        st = self.settings
        with jax.enable_x64(True):
            seg, is_first, first_idx, last_idx = _arc_arrays_dev(
                self.co32, m=self.m, n=self.n)
            if spec["W"] > 0:
                down, up = _member_masks_dev(seg, self.v, spec["W"])
            else:
                down = up = jnp.zeros(self.m, _I32)
            spec_t = tuple(sorted(spec.items()))
            cm = _cost_matrix_dev(seg, self.v, seg, is_first, first_idx,
                                  last_idx, down, up, self.co64, None,
                                  spec_t)
            if selection == "native":
                refs_np, rcs_np = select_refs(
                    np.asarray(cm), np.diff(self.co_host), st)
                refs = jnp.asarray(np.asarray(refs_np, dtype=np.int32))
                rcs = jnp.asarray(np.asarray(rcs_np, dtype=np.int32))
            else:
                refs, rcs = _select_refs_dev(cm, self.outd, W=spec["W"],
                                             maxref=st.max_ref_count)
            ub_bits = 16 * self.m + 70 * self.n + 128
            for _ in range(3):
                nw = _PAD_WORDS + (-(-ub_bits // 32))
                nw = -(-nw // _WORD_BUCKET) * _WORD_BUCKET
                out = jnp.zeros(nw, dtype=jnp.uint32)
                words, starts, total, stats = _pack_dev(
                    seg, self.v, seg, is_first, first_idx, last_idx,
                    down, up, self.co64, refs, out, spec_t, 0)
                total = int(total)
                if total + 32 * _PAD_WORDS <= nw * 32:
                    break
                ub_bits = total + 256
            else:
                raise RuntimeError("encode buffer sizing did not converge")
            stats = np.array(stats, dtype=np.int64)
            stats[3] = int(np.asarray(jnp.sum(rcs)))
            return (_words_to_bytes(np.asarray(words), total), total,
                    np.asarray(starts), np.asarray(refs),
                    np.asarray(rcs), stats)


def select_refs(costs: np.ndarray, outd: np.ndarray, settings,
                chunk_bounds: Optional[np.ndarray] = None):
    """Greedy reference selection (native wg_select_refs; the one
    sequential pass — BVGraph.java:2256-2270 semantics with window resets
    at chunk bounds).  Returns (refs, ref_counts)."""
    from .. import native as _native
    n = len(outd)
    if chunk_bounds is None:
        chunk_bounds = np.asarray([0, n], dtype=np.int64)
    return _native.select_refs(costs, np.asarray(outd, dtype=np.int64),
                               settings.window_size,
                               settings.max_ref_count,
                               np.asarray(chunk_bounds, dtype=np.int64))


# ---------------------------------------------------------------------------
# bit packer: winner tokens -> positions (segmented scans) -> word scatter
#
# Every token class is naturally ordered by node (and by arc within a node),
# so NO sort is needed: per-node per-class bit totals -> exclusive cumsum
# gives each node's class base offsets; within-(node,class) exclusive
# cumsums place each token.  Each token's value is < 2^min(len,64) (leading
# zeros of long codes are implicit), so its 64-bit window OR-scatters into
# <= 3 big-endian 32-bit words without carries.
# ---------------------------------------------------------------------------


def _seg_excl(x, first_idx):
    """Exclusive per-segment cumsum of int values (int64 result)."""
    x = x.astype(_I64)
    cs = jnp.cumsum(x)
    return cs - jnp.take(cs, first_idx) + jnp.take(x, first_idx) - x


def _emit(out, pos, bits, lens, valid):
    """OR-scatter tokens into the uint32 word array.

    pos int64 stream bit positions (0-based, before the 96-bit front pad);
    bits uint64 right-aligned code values; lens int32 code lengths.  Bits
    of a code beyond its low 64 are leading zeros — nothing to write."""
    e = pos + lens.astype(_I64) + 96          # end bit incl. front pad
    v = jnp.where(valid, bits, jnp.zeros_like(bits))
    j1 = (e - 1) >> 5
    for t in range(3):
        j = j1 - t
        s = (e - 32 * (j + 1)).astype(_I32)   # in [-31, 95]
        sh = jnp.clip(s, 0, 63).astype(_U64)
        part = jnp.where(s >= 64, jnp.zeros_like(v), v >> sh)
        part = jnp.where(s < 0, v << jnp.clip(-s, 0, 63).astype(_U64), part)
        part = (part & jnp.asarray(0xFFFFFFFF, _U64)).astype(jnp.uint32)
        out = out.at[j].add(jnp.where(valid, part, 0), mode="drop")
    return out


def _msb_or_neg(x):
    """floor(log2(x)) for x >= 1, -1 for x == 0 (int64 input)."""
    x = x.astype(_I64)
    return jnp.where(x > 0, 63 - jax.lax.clz(jnp.maximum(x, 1)), -1)


def _gap_bins(vals_first, gaps, valid_first, valid_gap):
    """Exp-binned gap histogram (_Encoder._update_bins semantics): msb of
    raw in-list gaps plus msb(int2nat(first - node)) when >= 0."""
    b1 = _msb_or_neg(gaps)
    b0 = _msb_or_neg(vals_first)
    seg_ok = jnp.where(valid_gap, b1, -1)
    first_ok = jnp.where(valid_first, b0, -1)
    h = jnp.bincount(jnp.clip(seg_ok, 0, 63),
                     weights=(seg_ok >= 0).astype(_I64), length=64)
    h = h + jnp.bincount(jnp.clip(first_ok, 0, 63),
                         weights=(first_ok >= 0).astype(_I64), length=64)
    return h.astype(_I64)


@functools.partial(jax.jit, static_argnames=("spec_t", "emit_from"),
                   donate_argnums=(10,))
def _pack_dev(seg, v, gx, is_first, first_idx, last_idx, down, up, co,
              refs, out, spec_t, emit_from: int):
    """Pack the whole chunk's winner tokens into `out` (uint32 words,
    3 front pad words).  Returns (words, node_starts int64 (emitted nodes
    get real starts; halo nodes -1), total_bits, stats[138])."""
    spec = dict(spec_t)
    W = spec["W"]
    minint = spec["minint"]
    n = co.shape[0] - 1
    m = seg.shape[0]
    outd = (co[1:] - co[:-1]).astype(_I32)
    node_emit = jnp.arange(n, dtype=_I32) >= emit_from
    arc_emit = seg >= emit_from

    refs_arc = jnp.take(refs, seg)

    # ---- per-node header token values/lens --------------------------------
    outd_bits, outd_len = _code(spec["outd"], outd, spec["zk"])
    outd_len = jnp.where(node_emit, outd_len, 0)
    has_ref_tok = node_emit & (outd > 0) if W > 0 else jnp.zeros(n, bool)
    ref_bits, ref_len = _code(spec["ref"], refs, spec["zk"])
    ref_len = jnp.where(has_ref_tok, ref_len, 0)

    # ---- blocks (winner): per-r scan over ref-list (y) arcs ---------------
    l_blk = jnp.zeros(n, _I64)           # per-node block-token bits
    bc_val = jnp.zeros(n, _I32)          # per-node block count
    copied = jnp.zeros((), _I64)
    blk_tok = []                         # (pos-ingredients per r)
    for r in range(1, W + 1):
        if r >= n:   # window deeper than the whole slice
            continue
        mem = ((up >> r) & 1).astype(jnp.bool_)
        lead, trans_at, rei, blk_val, blk_j = _blocks_scan(
            mem, is_first, first_idx, last_idx)
        xn = seg + r                     # token owner node
        x_ok = (xn < n) & (jnp.take(refs, jnp.minimum(xn, n - 1)) == r) \
            & (xn >= emit_from)
        lead_v = is_first & lead & x_ok
        rend_v = rei & x_ok
        emitted = jnp.where(blk_j > 0, blk_val - 1, blk_val)
        b_bits, b_len = _code(spec["block"], emitted, spec["zk"])
        z_bits, z_len = _code(spec["block"], jnp.zeros(m, _I32), spec["zk"])
        L1 = jnp.where(lead_v, z_len, 0)
        L2 = jnp.where(rend_v, b_len, 0)
        seg_tot = jax.ops.segment_sum((L1 + L2).astype(_I64), seg,
                                      num_segments=n,
                                      indices_are_sorted=True)
        pick = jnp.concatenate(
            [jnp.zeros(r, jnp.bool_), (refs[r:] == r) & node_emit[r:]])
        l_blk = l_blk + jnp.where(pick, jnp.roll(seg_tot, r), 0)
        ntrans = _seg_cumsum_excl(trans_at.astype(_I32), first_idx) \
            + trans_at.astype(_I32)
        bc_arc = jnp.take(ntrans, last_idx) + lead.astype(_I32)
        bc_r = jax.ops.segment_sum(jnp.where(is_first, bc_arc, 0), seg,
                                   num_segments=n, indices_are_sorted=True)
        bc_val = bc_val + jnp.where(pick, jnp.roll(bc_r, r), 0)
        copied = copied + jnp.sum(
            jnp.where(mem & x_ok, 1, 0).astype(_I64))
        blk_tok.append((xn, L1, L2, z_bits, b_bits, lead_v, rend_v))

    has_bc = node_emit & (refs > 0)
    bc_bits, bc_len = _code(spec["bcount"], bc_val, spec["zk"])
    bc_len = jnp.where(has_bc, bc_len, 0)

    # ---- extras (winner kept mask; per-arc dynamic r) ----------------------
    kept = ~(((down >> refs_arc) & 1).astype(jnp.bool_)) & arc_emit
    E = _extras_scan(kept, v, is_first, first_idx, last_idx, minint)
    n_kept = jax.ops.segment_sum(kept.astype(_I32), seg, num_segments=n,
                                 indices_are_sorted=True)
    has_extras = node_emit & (n_kept > 0)

    if minint > 0:
        iidx = _seg_cumsum_excl(E["int_start"].astype(_I32), first_idx)
        prev_is = _prev_where(E["int_start"], first_idx)
        pl = jnp.take(v, jnp.maximum(prev_is, 0))
        pL = jnp.take(E["L"], jnp.maximum(prev_is, 0))
        left_val = jnp.where(iidx == 0,
                             _int2nat(v.astype(_I64) - gx.astype(_I64)),
                             (v - (pl + pL) - 1).astype(_I64))
        il_bits, il_len = _code(_C.GAMMA, left_val)
        ll_bits, ll_len = _code(_C.GAMMA, E["L"] - minint)
        Li1 = jnp.where(E["int_start"], il_len, 0)
        Li2 = jnp.where(E["int_start"], ll_len, 0)
        n_int = jax.ops.segment_sum(E["int_start"].astype(_I32), seg,
                                    num_segments=n, indices_are_sorted=True)
        ic_bits, ic_len = _code(_C.GAMMA, n_int)
        ic_len = jnp.where(has_extras, ic_len, 0)
        intervalised = jnp.sum(jnp.where(E["int_start"], E["L"], 0)
                               .astype(_I64))
    else:
        Li1 = Li2 = jnp.zeros(m, _I32)
        il_bits = ll_bits = jnp.zeros(m, _U64)
        ic_bits, ic_len = jnp.zeros(n, _U64), jnp.zeros(n, _I32)
        intervalised = jnp.zeros((), _I64)

    res = E["res"] & kept
    ridx = _seg_cumsum_excl(res.astype(_I32), first_idx)
    prev_r = _prev_where(res, first_idx)
    pr = jnp.take(v, jnp.maximum(prev_r, 0))
    res_val = jnp.where(ridx == 0,
                        _int2nat(v.astype(_I64) - gx.astype(_I64)),
                        (v - pr - 1).astype(_I64))
    r_bits, r_len = _code(spec["res"], res_val, spec["zk"])
    Lr = jnp.where(res, r_len, 0)

    # ---- per-node class offsets -------------------------------------------
    l_int = jax.ops.segment_sum((Li1 + Li2).astype(_I64), seg,
                                num_segments=n, indices_are_sorted=True)
    l_res = jax.ops.segment_sum(Lr.astype(_I64), seg, num_segments=n,
                                indices_are_sorted=True)
    tl = (outd_len.astype(_I64) + ref_len + bc_len + l_blk
          + ic_len + l_int + l_res)
    base = jnp.cumsum(tl) - tl
    ofs_ref = base + outd_len
    ofs_bc = ofs_ref + ref_len
    ofs_blk = ofs_bc + bc_len
    ofs_ic = ofs_blk + l_blk
    ofs_int = ofs_ic + ic_len
    ofs_res = ofs_int + l_int
    total_bits = jnp.sum(tl)

    # ---- emit --------------------------------------------------------------
    out = _emit(out, base, outd_bits, outd_len, node_emit)
    out = _emit(out, ofs_ref, ref_bits, ref_len, has_ref_tok)
    out = _emit(out, ofs_bc, bc_bits, bc_len, has_bc)
    for (xn, L1, L2, z_bits, b_bits, lead_v, rend_v) in blk_tok:
        within = _seg_excl(L1 + L2, first_idx)
        pbase = jnp.take(ofs_blk, jnp.minimum(xn, n - 1)) + within
        out = _emit(out, pbase, z_bits, L1, lead_v)
        out = _emit(out, pbase + L1, b_bits, L2, rend_v)
    out = _emit(out, ofs_ic, ic_bits, ic_len, has_extras & (minint > 0))
    if minint > 0:
        within_i = _seg_excl(Li1 + Li2, first_idx)
        pint = jnp.take(ofs_int, seg) + within_i
        out = _emit(out, pint, il_bits, Li1, E["int_start"])
        out = _emit(out, pint + Li1, ll_bits, Li2, E["int_start"])
    within_r = _seg_excl(Lr, first_idx)
    out = _emit(out, jnp.take(ofs_res, seg) + within_r, r_bits, Lr, res)

    # ---- stats vector (the native-encoder st[] layout) ---------------------
    residual_arcs = jnp.sum(res.astype(_I64))
    # gap bins over full successor lists (emitted, d>0 nodes)
    pv_arc = jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
    succ_bins = _gap_bins(
        _int2nat(jnp.take(v, jnp.minimum(first_idx, m - 1)).astype(_I64)
                 - jnp.take(gx, jnp.minimum(first_idx, m - 1)).astype(_I64)),
        (v - pv_arc).astype(_I64),
        is_first & arc_emit, (~is_first) & arc_emit)
    res_first = res & (ridx == 0)
    res_bins = _gap_bins(
        _int2nat(v.astype(_I64) - gx.astype(_I64)),
        (v - pr).astype(_I64),
        res_first, res & (ridx > 0))
    stats = jnp.concatenate([
        jnp.stack([copied, intervalised, residual_arcs,
                   jnp.zeros((), _I64), jnp.sum(refs.astype(_I64)
                                                * node_emit),
                   jnp.sum(outd_len.astype(_I64)),
                   jnp.sum(ref_len.astype(_I64)),
                   jnp.sum(bc_len.astype(_I64)) + jnp.sum(l_blk),
                   jnp.sum(ic_len.astype(_I64)) + jnp.sum(l_int),
                   jnp.sum(l_res)]),
        succ_bins, res_bins])
    node_starts = jnp.where(node_emit, base, -1)
    return out, node_starts, total_bits, stats


_PAD_WORDS = 3          # 96-bit front pad so token windows never underflow
_WORD_BUCKET = 1 << 16  # output size rounded up to bound recompiles


def pack_chunk(co: np.ndarray, succ: np.ndarray, settings,
               refs: np.ndarray, node_base: int = 0, emit_from: int = 0):
    """Pack winner tokens for nodes [emit_from, n) of a CSR slice into an
    MSB-first bit stream (measure-then-pack, BVGraph.java:2259/:2270).

    Nodes [0, emit_from) are halo context (their arcs feed reference lists
    and masks but emit no bits).  Returns (words uint32 ndarray,
    total_bits int, node_starts int64[n] with -1 for halo, stats[138])."""
    spec = _spec(settings)
    co = np.asarray(co, dtype=np.int64)
    n = len(co) - 1
    m = int(co[-1])
    d = np.diff(co)
    seg = np.repeat(np.arange(n, dtype=np.int32), d)
    with jax.enable_x64(True):
        segj = jnp.asarray(seg)
        vj = jnp.asarray(np.asarray(succ, dtype=np.int64).astype(np.int32))
        gxj = segj + np.int32(node_base)
        is_first = jnp.asarray(_is_first_np(co, m))
        first_idx = jnp.asarray(np.repeat(co[:-1], d).astype(np.int32))
        last_idx = jnp.asarray(np.repeat(co[1:] - 1, d).astype(np.int32))
        down, up = _member_masks_dev(segj, vj, spec["W"]) \
            if spec["W"] > 0 else (jnp.zeros(m, _I32), jnp.zeros(m, _I32))
        # output sizing: start from a typical-density estimate and verify
        # against the packer's own exact total_bits (writes past the buffer
        # are dropped, so an undersized buffer MUST retry, never truncate)
        ub_bits = 16 * m + 70 * n + 128
        for _ in range(3):
            nw = _PAD_WORDS + (-(-ub_bits // 32))
            nw = -(-nw // _WORD_BUCKET) * _WORD_BUCKET
            out = jnp.zeros(nw, dtype=jnp.uint32)
            words, starts, total, stats = _pack_dev(
                segj, vj, gxj, is_first, first_idx, last_idx, down, up,
                jnp.asarray(co), jnp.asarray(refs, dtype=np.int32), out,
                tuple(sorted(spec.items())), int(emit_from))
            total = int(total)
            if total + 32 * _PAD_WORDS <= nw * 32:
                break
            ub_bits = total + 256
        else:
            raise RuntimeError("pack_chunk: buffer sizing did not converge")
        return (np.asarray(words), total, np.asarray(starts),
                np.asarray(stats))


def _words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Strip the front pad, byteswap to the MSB-first byte stream, pad the
    final byte with zeros (BitWriter.to_bytes discipline)."""
    nbytes = -(-total_bits // 8)
    raw = words[_PAD_WORDS:].astype(">u4").tobytes()
    return raw[:nbytes]


def pack_gaps(vals: np.ndarray, coding: int, zeta_k: int = 3):
    """Pack a flat value sequence with one instantaneous code (the offsets
    stream: gamma/delta gaps, n+1 entries with a leading 0)."""
    vals = np.asarray(vals, dtype=np.int64)
    with jax.enable_x64(True):
        v = jnp.asarray(vals)
        bits, lens = _code(coding, v, zeta_k)
        lens = lens.astype(_I64)
        pos = jnp.cumsum(lens) - lens
        total = int(jnp.sum(lens))
        nw = _PAD_WORDS + (-(-total // 32))
        out = jnp.zeros(nw, dtype=jnp.uint32)
        out = _emit(out, pos, bits, lens.astype(_I32),
                    jnp.ones(vals.shape[0], bool))
        return _words_to_bytes(np.asarray(out), total), total


def encode_csr(co: np.ndarray, succ: np.ndarray, settings,
               node_base: int = 0):
    """Full vectorized encode of one CSR graph slice: cost matrix ->
    native greedy selection -> token pack.  Returns
    (graph_bytes, graph_bits, node_starts, refs, ref_counts, stats[138])
    — single-stream semantics (window never resets), byte-identical to
    the scalar _Encoder."""
    co = np.asarray(co, dtype=np.int64)
    outd = np.diff(co)
    costs = cost_matrix(co, succ, settings, node_base=node_base)
    refs, rcs = select_refs(costs, outd, settings)
    words, total, starts, stats = pack_chunk(co, succ, settings, refs,
                                             node_base=node_base)
    stats = np.array(stats, dtype=np.int64)
    stats[3] = int(rcs.sum())
    return (_words_to_bytes(words, total), total, starts, refs, rcs, stats)


class BitCat:
    """MSB-first bit-stream concatenator (the vectorized analogue of the
    reference's per-thread stream concatenation, BVGraph.java:2432-2483):
    appends arbitrary-bit-length byte chunks with a vectorized byte
    shift-and-merge instead of a bit loop."""

    def __init__(self):
        self._buf = bytearray()
        self.bits = 0

    def push(self, data: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        k = self.bits & 7
        nb = -(-nbits // 8)
        a = np.frombuffer(data, dtype=np.uint8, count=nb)
        if k == 0:
            self._buf += a.tobytes()
        else:
            s = np.empty(nb + 1, dtype=np.uint8)
            s[0] = a[0] >> k
            np.left_shift(a, 8 - k, out=s[1:], casting="unsafe")
            s[1:-1] |= a[1:] >> k
            L = -(-(nbits + k) // 8)
            self._buf[-1] |= int(s[0])
            self._buf += s[1:L].tobytes()
        self.bits += nbits
        # zero any slack bits past the logical end (callers may pass
        # byte-padded chunks whose final byte carries stale low bits)
        r = self.bits & 7
        if r:
            self._buf[-1] &= (0xFF00 >> r) & 0xFF

    def to_bytes(self) -> bytes:
        return bytes(self._buf)


def chunk_bounds_by_arcs(co: np.ndarray, target_arcs: int) -> np.ndarray:
    """Node chunk boundaries so each chunk holds <= target_arcs arcs
    (a lone hub node may exceed it); always >= 1 node per chunk."""
    co = np.asarray(co, dtype=np.int64)
    n = len(co) - 1
    bounds = [0]
    while bounds[-1] < n:
        x = int(np.searchsorted(co, co[bounds[-1]] + target_arcs, "right")
                ) - 1
        bounds.append(min(max(x, bounds[-1] + 1), n))
    return np.asarray(bounds, dtype=np.int64)


def encode_csr_chunked(co: np.ndarray, succ: np.ndarray, settings,
                       chunk_arcs: int = 8 << 20, progress=None):
    """Chunked vectorized encode of a whole CSR graph with single-stream
    semantics (byte-identical to the scalar _Encoder and to
    ``encode_csr``): per-chunk device passes bounded to ~chunk_arcs arcs,
    W-node halos carry the reference window across chunk boundaries, one
    global native greedy-selection pass, bit-exact stream concatenation.

    Node ids must fit int32 (the >2^31-node regime streams through the
    native StreamEncoder instead).  Returns
    (graph_bytes, graph_bits, node_starts int64[n], stats[138])."""
    co = np.asarray(co, dtype=np.int64)
    n = len(co) - 1
    W = settings.window_size
    if n == 0:
        return b"", 0, np.zeros(0, np.int64), np.zeros(138, np.int64)
    bounds = chunk_bounds_by_arcs(co, chunk_arcs)
    outd = np.diff(co)
    # pass 1: per-chunk candidate cost matrices (W-node halo)
    costs = np.empty((n, W + 1), dtype=np.int64)
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        h = min(W, lo)
        sco = co[lo - h:hi + 1] - co[lo - h]
        ssu = succ[co[lo - h]:co[hi]]
        cm = cost_matrix(sco, ssu, settings, node_base=lo - h)
        if h:
            # halo rows carry partial windows; recompute eligibility for
            # emitted rows only (they see the full W-deep halo)
            costs[lo:hi] = cm[h:]
        else:
            costs[lo:hi] = cm
        if progress is not None:
            progress("cost", hi, n)
    # pass 2: global greedy selection (the one sequential step)
    refs, rcs = select_refs(costs, outd, settings)
    del costs
    # pass 3: per-chunk pack + bit-exact concatenation
    cat = BitCat()
    starts = np.empty(n, dtype=np.int64)
    stats = np.zeros(138, dtype=np.int64)
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        h = min(W, lo)
        sco = co[lo - h:hi + 1] - co[lo - h]
        ssu = succ[co[lo - h]:co[hi]]
        words, total, st_local, st_vec = pack_chunk(
            sco, ssu, settings, refs[lo - h:hi], node_base=lo - h,
            emit_from=h)
        starts[lo:hi] = st_local[h:] + cat.bits
        cat.push(_words_to_bytes(words, total), total)
        stats += np.asarray(st_vec, dtype=np.int64)
        if progress is not None:
            progress("pack", hi, n)
    stats[3] = int(rcs.sum())
    return cat.to_bytes(), cat.bits, starts, stats
