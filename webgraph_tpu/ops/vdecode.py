"""Vectorized BVGraph decoder in plain XLA.

A data-parallel re-design of BVGraph decoding (reference semantics:
BVGraph.java:995-1097 random access, :1100-1245 sequential window; SURVEY §7
design).  Instead of lazy per-edge iterators we run two data-parallel phases
over the whole graph (or a node chunk):

Phase 1 — *parse*: one vector lane per node steps a lock-step state machine
over the node's entry, reading one instantaneous code per step
(ref/blocks/intervals/residuals).  Interval and residual successor values are
scattered straight into their final CSR slots; copy-blocks are recorded into
a small padded per-node array.  Lanes are size-bucketed (nodes sorted by
entry bit length) so while-loop trip counts stay balanced.

Phase 2 — *resolve*: reference chains (bounded by maxRefCount at encode
time) are resolved by depth: depth-t nodes gather their copied successors
from the already-final rows of their referents through the copy-block mask
(kept-range arithmetic — the vectorized equivalent of MaskedLongIterator),
then completed rows are re-sorted by one lexicographic (row, value) sort.

Everything is jax.numpy / lax — it runs identically on a CPU mesh and on
the GPU, and shards over a device mesh by node ranges (webgraph_tpu.parallel).
Bit-exactness is asserted against the scalar oracle in tests.  Rare nodes
whose copy-block count exceeds the padded capacity are decoded by the scalar
oracle and patched in before resolution.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .packed import pack_words_u32

__all__ = ["ParseConfig", "decode_to_csr", "config_from_settings"]

# code kinds (CompressionFlags ids)
K_DELTA, K_GAMMA, K_GOLOMB, K_SKEWED, K_UNARY, K_ZETA, K_NIBBLE = 1, 2, 3, 4, 5, 6, 7
K_NONE = 0

# parser states
(S_REF, S_BLOCKCNT, S_BLOCK, S_INTCNT, S_ILEFT, S_ILEN, S_IEMIT, S_RESF,
 S_RES, S_DONE) = range(10)
S_EXTRAS = -1  # pseudo-state: transition into the extra part


@dataclasses.dataclass(frozen=True)
class ParseConfig:
    """Static decode parameters (hashable: used as a jit static argument)."""

    window_size: int = 7
    min_interval_length: int = 4
    zeta_k: int = 3
    outdegree_coding: int = K_GAMMA
    block_coding: int = K_GAMMA
    residual_coding: int = K_ZETA
    reference_coding: int = K_UNARY
    block_count_coding: int = K_GAMMA
    max_blocks: int = 32          # padded per-node copy-block capacity
    batch: int = 4096             # lanes per parse batch

    def state_kinds(self) -> Tuple[int, ...]:
        return (
            self.reference_coding,    # S_REF
            self.block_count_coding,  # S_BLOCKCNT
            self.block_coding,        # S_BLOCK
            K_GAMMA,                  # S_INTCNT
            K_GAMMA,                  # S_ILEFT
            K_GAMMA,                  # S_ILEN
            K_NONE,                   # S_IEMIT
            self.residual_coding,     # S_RESF
            self.residual_coding,     # S_RES
            K_NONE,                   # S_DONE
        )

    def parse_kinds(self) -> Tuple[int, ...]:
        ks = set(self.state_kinds()) - {K_NONE}
        if self.window_size == 0:
            ks.discard(self.reference_coding)
        return tuple(sorted(ks))


def _big_fallback(data, offsets, cfg: "ParseConfig", bvgraph=None):
    """Full decode of a >= 2^31-bit stream via the sliced kernel driver
    (ops/bigdecode.py), concatenated in RAM.  Node ids must fit int32; for
    n >= 2^31 use BVGraph.iter_csr_slices (native streaming)."""
    from .bigdecode import decode_big_slices
    if bvgraph is not None:
        settings = bvgraph.settings
    else:
        from ..codecs.bvgraph import BVGraphSettings
        settings = BVGraphSettings(
            window_size=cfg.window_size,
            min_interval_length=cfg.min_interval_length,
            zeta_k=cfg.zeta_k, outdegree_coding=cfg.outdegree_coding,
            block_coding=cfg.block_coding,
            residual_coding=cfg.residual_coding,
            reference_coding=cfg.reference_coding,
            block_count_coding=cfg.block_count_coding)
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    from .. import native as _native
    outd = _native.decode_outdegrees(np.asarray(data), offsets,
                                     settings.outdegree_coding)
    csr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd, out=csr[1:])
    succ = np.empty(int(csr[-1]), dtype=np.int64)
    for lo, hi, _co, su in decode_big_slices(offsets, outd, settings,
                                             np.asarray(data)):
        succ[csr[lo]:csr[hi]] = su
    return csr, succ


def config_from_settings(s, **overrides) -> ParseConfig:
    """Build a ParseConfig from a codecs.bvgraph.BVGraphSettings."""
    return ParseConfig(
        window_size=s.window_size,
        min_interval_length=s.min_interval_length,
        zeta_k=s.zeta_k,
        outdegree_coding=s.outdegree_coding,
        block_coding=s.block_coding,
        residual_coding=s.residual_coding,
        reference_coding=s.reference_coding,
        block_count_coding=s.block_count_coding,
        **overrides,
    )


# ---------------------------------------------------------------------------
# bit-field primitives (uint32 big-endian packed words, int32 bit positions)
# ---------------------------------------------------------------------------


def _u32(x):
    return x.astype(jnp.uint32)


def _clz(v_u32):
    return jax.lax.clz(jax.lax.bitcast_convert_type(v_u32, jnp.int32))


def _window64(words, pos):
    """(hi, lo) uint32 pair = the 64 stream bits starting at ``pos``."""
    w = pos >> 5
    o = _u32(pos & 31)
    w0 = jnp.take(words, w, mode="clip")
    w1 = jnp.take(words, w + 1, mode="clip")
    w2 = jnp.take(words, w + 2, mode="clip")
    ok = o > 0
    no = jnp.where(ok, jnp.uint32(32) - o, 1)  # avoid shift-by-32
    hi = (w0 << o) | jnp.where(ok, w1 >> no, 0)
    lo = (w1 << o) | jnp.where(ok, w2 >> no, 0)
    return hi, lo


#: unary codes longer than this many bits are not decodable by the
#: vectorized readers (no real coding configuration produces them except
#: Golomb quotients of adversarial values); the scalar oracle has no limit.
MAX_UNARY_BITS = 64 * 4


def _read_unary(words, pos, active):
    """Leading-zero count from ``pos`` for ``active`` lanes.

    Scans up to MAX_UNARY_BITS via an unrolled sequence of 64-bit
    windows."""
    hi, lo = _window64(words, pos)
    u = jnp.where(hi != 0, _clz(hi), 32 + _clz(lo))
    pend = active & (hi == 0) & (lo == 0)
    u = jnp.where(active, jnp.where(pend, 64, u), 0)
    for _ in range(MAX_UNARY_BITS // 64 - 1):
        hi2, lo2 = _window64(words, jnp.where(pend, pos + u, pos))
        nz = (hi2 != 0) | (lo2 != 0)
        add = jnp.where(hi2 != 0, _clz(hi2), 32 + _clz(lo2))
        u = jnp.where(pend, u + jnp.where(nz, add, 64), u)
        pend = pend & ~nz
    # lanes still pending exhausted the window sweep: the unary run is
    # longer than MAX_UNARY_BITS and the decoded value is NOT trustworthy —
    # callers must flag the node (scalar-oracle patch), never decode
    # silently wrong (mirrors the kernel's E_UNARY contract, kdecode E_*)
    return u, pend


def _extract(words, pos, nbits):
    """Read ``nbits`` (0..32) stream bits at ``pos`` as uint32."""
    hi, _ = _window64(words, pos)
    nb = _u32(jnp.clip(nbits, 0, 32))
    ok = nb > 0
    return jnp.where(ok, hi >> jnp.where(ok, jnp.uint32(32) - nb, 1), 0)


def _shl1(n):
    """(1 << n) as int32 with n clamped to a safe range."""
    return (jnp.uint32(1) << _u32(jnp.clip(n, 0, 31))).astype(jnp.int32)


def read_code(words, pos, kind, cfg: ParseConfig, kinds_used: Tuple[int, ...]):
    """Read one instantaneous code of per-lane ``kind`` at per-lane ``pos``.

    Returns (value int32, advance int32).  Lanes with kind == K_NONE read
    nothing.  Only the kinds in ``kinds_used`` are traced.
    """
    unary_kinds = {K_UNARY, K_GAMMA, K_DELTA, K_ZETA, K_GOLOMB}
    needs_unary = set(kinds_used) & unary_kinds
    if needs_unary:
        active = jnp.zeros_like(pos, dtype=jnp.bool_)
        for k in needs_unary:
            active = active | (kind == k)
        u, uoflow = _read_unary(words, pos, active)
    else:
        u = jnp.zeros_like(pos)
        uoflow = jnp.zeros_like(pos, dtype=jnp.bool_)
    body = pos + u + 1  # position after the unary terminator

    value = jnp.zeros_like(pos)
    adv = jnp.zeros_like(pos)

    if K_UNARY in kinds_used:
        m = kind == K_UNARY
        value = jnp.where(m, u, value)
        adv = jnp.where(m, u + 1, adv)

    if K_GAMMA in kinds_used:
        m = kind == K_GAMMA
        bits = _extract(words, body, jnp.where(m, u, 0)).astype(jnp.int32)
        v = (_shl1(u) | bits) - 1
        value = jnp.where(m, v, value)
        adv = jnp.where(m, 2 * u + 1, adv)

    if K_DELTA in kinds_used:
        m = kind == K_DELTA
        mant = _extract(words, body, jnp.where(m, u, 0)).astype(jnp.int32)
        e = (_shl1(u) | mant) - 1
        bits2 = _extract(words, body + u, jnp.where(m, e, 0)).astype(jnp.int32)
        v = (_shl1(e) | bits2) - 1
        value = jnp.where(m, v, value)
        adv = jnp.where(m, u + 1 + u + e, adv)

    if K_ZETA in kinds_used:
        k = cfg.zeta_k
        m = kind == K_ZETA
        l1 = u * k + (k - 1)
        bits = _extract(words, body, jnp.where(m, l1, 0)).astype(jnp.int32)
        left = _shl1(u * k)
        short = bits < left
        extra = _extract(words, body + l1,
                         jnp.where(m & ~short, 1, 0)).astype(jnp.int32)
        v = jnp.where(short, bits + left - 1, (bits << 1) + extra - 1)
        value = jnp.where(m, v, value)
        adv = jnp.where(m, u + 1 + l1 + jnp.where(short, 0, 1), adv)

    if K_GOLOMB in kinds_used:
        b = cfg.zeta_k  # the reference uses zetaK as the Golomb modulus
        s = max(b.bit_length() - 1, 0)
        mshort = (1 << (s + 1)) - b
        m = kind == K_GOLOMB
        bits = _extract(words, body, jnp.where(m, s, 0)).astype(jnp.int32)
        short = bits < mshort
        extra = _extract(words, body + s,
                         jnp.where(m & ~short, 1, 0)).astype(jnp.int32)
        r = jnp.where(short, bits, (bits << 1) + extra - mshort)
        value = jnp.where(m, u * b + r, value)
        adv = jnp.where(m, u + 1 + s + jnp.where(short, 0, 1), adv)

    if K_NIBBLE in kinds_used:
        m = kind == K_NIBBLE

        def nib_cond(c):
            return jnp.any(~c[2])

        def nib_body(c):
            acc, p, done = c
            nib = _extract(words, p, jnp.where(done, 0, 4)).astype(jnp.int32)
            acc = jnp.where(done, acc, (acc << 3) | (nib & 7))
            p = jnp.where(done, p, p + 4)
            done = done | ((nib & 8) != 0) | (p >= words.shape[0] * 32)
            return acc, p, done

        acc, pend, _ = jax.lax.while_loop(
            nib_cond, nib_body, (jnp.zeros_like(pos), pos, ~m))
        value = jnp.where(m, acc, value)
        adv = jnp.where(m, pend - pos, adv)

    return value, adv, uoflow


def _nat2int(v):
    return (v >> 1) ^ -(v & 1)


# ---------------------------------------------------------------------------
# pass 0: outdegrees
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def _pass0(words, starts, cfg: ParseConfig):
    kind = jnp.full_like(starts, cfg.outdegree_coding)
    d, adv, uo = read_code(words, starts, kind, cfg,
                            (cfg.outdegree_coding,))
    return d, starts + adv, uo


# ---------------------------------------------------------------------------
# phase 1: parse (scan over size-bucketed batches of lanes)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(4,))
def _parse(words, xs_stack, outd, csr_off, out, cfg: ParseConfig):
    """Scan over lane batches; each batch steps its state machine to DONE.

    Returns (out, blocks, refs, copied, bc, oflow); the per-node arrays have
    N+1 entries (the last row absorbs dummy-lane writes).
    """
    n_plus = outd.shape[0]  # N + 1
    MB = cfg.max_blocks
    kinds_used = cfg.parse_kinds()
    table = jnp.asarray(cfg.state_kinds(), dtype=jnp.int32)
    blocks0 = jnp.zeros((n_plus, MB), dtype=jnp.int32)
    refs0 = jnp.zeros(n_plus, dtype=jnp.int32)
    copied0 = jnp.zeros(n_plus, dtype=jnp.int32)
    bc0 = jnp.zeros(n_plus, dtype=jnp.int32)
    oflow0 = jnp.zeros(n_plus, dtype=jnp.bool_)
    m_sent = out.shape[0] - 1  # dump slot
    dump = n_plus - 1          # dummy node row

    def batch_step(carry, xs):
        out, blocks, refs, copied_arr, bc_arr, oflow = carry
        x, d, pos0 = xs["x"], xs["d"], xs["pos"]
        zero = jnp.zeros_like(x)
        csr0 = jnp.take(csr_off, x, mode="clip").astype(jnp.int32)

        if cfg.window_size > 0:
            st0 = jnp.where(d == 0, S_DONE, S_REF)
            extra0 = zero
            res0 = zero
        elif cfg.min_interval_length != 0:
            st0 = jnp.where(d == 0, S_DONE, S_INTCNT)
            extra0 = d
            res0 = zero
        else:
            st0 = jnp.where(d == 0, S_DONE, S_RESF)
            extra0 = d
            res0 = d
        regs = dict(
            pos=pos0, st=st0, x=x, d=d, ref=zero, ref_outd=zero,
            idx=zero, blk_rem=zero, total=zero, copied=zero,
            int_rem=zero, extra=extra0, ileft=zero, emit_val=zero,
            emit_rem=zero, res_rem=res0, prev=zero,
            wp=jnp.where(st0 != S_DONE, csr0, m_sent),
        )

        def cond(c):
            return jnp.any(c[0]["st"] != S_DONE)

        def body(c):
            regs, out, blocks, oflow_c, refs_c, bc_c = c
            st = regs["st"]
            kind = jnp.take(table, st, mode="clip")
            v, adv, uo = read_code(words, regs["pos"], kind, cfg,
                                   kinds_used)
            x, d = regs["x"], regs["d"]
            new = dict(regs, pos=regs["pos"] + adv)
            # unary overrun: flag the node for the scalar patch
            oflow_c = oflow_c.at[jnp.where(uo, x, dump)].set(True,
                                                             mode="drop")

            def sel(state, field, val):
                new[field] = jnp.where(st == state, val, new[field])

            if cfg.window_size > 0:
                # ---- S_REF: read reference ----
                is_ref = st == S_REF
                sel(S_REF, "ref", v)
                sel(S_REF, "ref_outd",
                    jnp.take(outd, jnp.maximum(x - v, 0), mode="clip"))
                refs_c = refs_c.at[jnp.where(is_ref, x, dump)].set(
                    jnp.where(is_ref, v, 0), mode="drop")
                sel(S_REF, "copied", jnp.int32(0))
                sel(S_REF, "st", jnp.where(v > 0, S_BLOCKCNT, S_EXTRAS))

                # ---- S_BLOCKCNT: read block count ----
                is_bc = st == S_BLOCKCNT
                bc_c = bc_c.at[jnp.where(is_bc, x, dump)].set(
                    jnp.where(is_bc, v, 0), mode="drop")
                sel(S_BLOCKCNT, "blk_rem", v)
                sel(S_BLOCKCNT, "idx", jnp.int32(0))
                sel(S_BLOCKCNT, "total", jnp.int32(0))
                sel(S_BLOCKCNT, "copied",
                    jnp.where(v == 0, regs["ref_outd"], 0))
                sel(S_BLOCKCNT, "st", jnp.where(v == 0, S_EXTRAS, S_BLOCK))

                # ---- S_BLOCK: read one copy-block ----
                is_blk = st == S_BLOCK
                b = v + jnp.where(regs["idx"] > 0, 1, 0)
                ok_idx = regs["idx"] < MB
                blocks = blocks.at[
                    jnp.where(is_blk & ok_idx, x, dump),
                    jnp.where(ok_idx, regs["idx"], 0)].set(
                        jnp.where(is_blk, b, 0), mode="drop")
                oflow_c = oflow_c.at[
                    jnp.where(is_blk & ~ok_idx, x, dump)].set(
                        True, mode="drop")
                total = regs["total"] + b
                copied = regs["copied"] + jnp.where(regs["idx"] % 2 == 0, b, 0)
                last = regs["blk_rem"] == 1
                even_cnt = (regs["idx"] + 1) % 2 == 0
                copied = copied + jnp.where(last & even_cnt,
                                            regs["ref_outd"] - total, 0)
                sel(S_BLOCK, "total", total)
                sel(S_BLOCK, "copied", copied)
                sel(S_BLOCK, "idx", regs["idx"] + 1)
                sel(S_BLOCK, "blk_rem", regs["blk_rem"] - 1)
                sel(S_BLOCK, "st", jnp.where(last, S_EXTRAS, S_BLOCK))

            # ---- pseudo-state: enter the extra part ----
            entering = new["st"] == S_EXTRAS
            extra = d - new["copied"]
            new["extra"] = jnp.where(entering, extra, new["extra"])
            new["wp"] = jnp.where(
                entering,
                jnp.take(csr_off, x, mode="clip").astype(jnp.int32)
                + new["copied"],
                new["wp"])
            new["idx"] = jnp.where(entering, 0, new["idx"])
            if cfg.min_interval_length != 0:
                ex_state = jnp.where(extra == 0, S_DONE, S_INTCNT)
            else:
                ex_state = jnp.where(extra == 0, S_DONE, S_RESF)
                new["res_rem"] = jnp.where(entering, extra, new["res_rem"])
            new["st"] = jnp.where(entering, ex_state, new["st"])

            if cfg.min_interval_length != 0:
                # ---- S_INTCNT: read interval count ----
                sel(S_INTCNT, "int_rem", v)
                sel(S_INTCNT, "idx", jnp.int32(0))
                sel(S_INTCNT, "res_rem",
                    jnp.where(v == 0, regs["extra"], regs["res_rem"]))
                sel(S_INTCNT, "st", jnp.where(v == 0, S_RESF, S_ILEFT))

                # ---- S_ILEFT: read left extreme ----
                left = jnp.where(regs["idx"] == 0, x + _nat2int(v),
                                 regs["prev"] + 1 + v)
                sel(S_ILEFT, "ileft", left)
                sel(S_ILEFT, "st", S_ILEN)

                # ---- S_ILEN: read length; set up the emit run ----
                ilen = v + cfg.min_interval_length
                sel(S_ILEN, "emit_val", regs["ileft"])
                sel(S_ILEN, "emit_rem", ilen)
                sel(S_ILEN, "prev", regs["ileft"] + ilen)
                sel(S_ILEN, "extra", regs["extra"] - ilen)
                sel(S_ILEN, "int_rem", regs["int_rem"] - 1)
                sel(S_ILEN, "idx", regs["idx"] + 1)
                sel(S_ILEN, "st", S_IEMIT)

                # ---- S_IEMIT: emit one interval value (no read) ----
                is_emit = st == S_IEMIT
                emit_last = regs["emit_rem"] == 1
                sel(S_IEMIT, "emit_val", regs["emit_val"] + 1)
                sel(S_IEMIT, "emit_rem", regs["emit_rem"] - 1)
                sel(S_IEMIT, "wp", regs["wp"] + 1)
                after = jnp.where(regs["int_rem"] > 0, S_ILEFT,
                                  jnp.where(regs["extra"] > 0, S_RESF, S_DONE))
                sel(S_IEMIT, "res_rem",
                    jnp.where(emit_last & (regs["int_rem"] == 0),
                              regs["extra"], regs["res_rem"]))
                sel(S_IEMIT, "st", jnp.where(emit_last, after, S_IEMIT))
            else:
                is_emit = jnp.zeros_like(st, dtype=jnp.bool_)

            # ---- S_RESF / S_RES: read one residual (write) ----
            is_rf = st == S_RESF
            is_rs = st == S_RES
            rval = jnp.where(is_rf, x + _nat2int(v), regs["prev"] + v + 1)
            for sres in (S_RESF, S_RES):
                sel(sres, "prev", rval)
                sel(sres, "wp", regs["wp"] + 1)
                sel(sres, "res_rem", regs["res_rem"] - 1)
                sel(sres, "st",
                    jnp.where(regs["res_rem"] == 1, S_DONE, S_RES))

            # single write per lane per step
            writing = is_emit | is_rf | is_rs
            wslot = jnp.where(writing, regs["wp"], m_sent)
            wval = jnp.where(is_emit, regs["emit_val"], rval)
            out = out.at[wslot].set(jnp.where(writing, wval, 0), mode="drop")

            return new, out, blocks, oflow_c, refs_c, bc_c

        regs, out, blocks, oflow, refs, bc_arr = jax.lax.while_loop(
            cond, body, (regs, out, blocks, oflow, refs, bc_arr))
        copied_arr = copied_arr.at[x].set(regs["copied"], mode="drop")
        return (out, blocks, refs, copied_arr, bc_arr, oflow), None

    (out, blocks, refs, copied_arr, bc_arr, oflow), _ = jax.lax.scan(
        batch_step, (out, blocks0, refs0, copied0, bc0, oflow0), xs_stack)
    return out, blocks, refs, copied_arr, bc_arr, oflow


# ---------------------------------------------------------------------------
# phase 2: reference resolution
# ---------------------------------------------------------------------------


@jax.jit
def _depth_round(refs, parent, depth):
    return jnp.where(refs > 0, jnp.take(depth, parent, mode="clip") + 1, 0)


def _depths(refs):
    """Chain depth per node: 0 where ref<=0, else depth[x - ref] + 1.

    Host-driven iteration (converges in maxRefCount rounds)."""
    n = refs.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    parent = jnp.where(refs > 0, idx - refs, idx)
    depth = jnp.where(refs > 0, 1, 0).astype(jnp.int32)
    for _ in range(256):
        nd = _depth_round(refs, parent, depth)
        if bool(jnp.all(nd == depth)):
            break
        depth = nd
    return depth


@functools.partial(jax.jit, static_argnames=("K",))
def _kept_ranges(blocks, bc, ref_len, K: int):
    """Per-node keep-range arrays from copy-blocks.

    Keep-ranges are the even-indexed blocks plus (iff the block count is
    even, including zero) an implicit tail range to the end of the
    reference list.  Returns (kstart, kcum) of shape (N1, K): range k of
    node x copies ref positions [kstart, kstart+len) and holds output
    positions [kcum[k], kcum[k+1]).
    """
    MB = blocks.shape[1]
    cum = jnp.cumsum(blocks, axis=1)
    prefix = cum - blocks
    ka = jnp.arange(K, dtype=jnp.int32)[None, :]
    col = jnp.minimum(2 * ka, MB - 1)
    kstart = jnp.take_along_axis(prefix, col, axis=1)
    klen = jnp.where(2 * ka < bc[:, None],
                     jnp.take_along_axis(blocks, col, axis=1), 0)
    total = jnp.take_along_axis(cum, jnp.maximum(bc - 1, 0)[:, None], axis=1)[:, 0]
    total = jnp.where(bc > 0, total, 0)
    tail_here = (ka == (bc[:, None] + 1) // 2) & (bc[:, None] % 2 == 0)
    kstart = jnp.where(tail_here, total[:, None], kstart)
    klen = jnp.where(tail_here, ref_len[:, None] - total[:, None], klen)
    kcum = jnp.cumsum(klen, axis=1) - klen
    return kstart, klen, kcum


def _g(table, idx, **kw):
    """Gather wrapped in an optimization barrier.

    The barrier keeps the gather a standalone op instead of letting XLA
    fuse it into its elementwise consumers."""
    return jax.lax.optimization_barrier(jnp.take(table, idx, **kw))


@functools.partial(jax.jit, static_argnames=("K",), donate_argnums=(0,))
def _resolve_depth(out, t, csr_off, row_of_slot, refs, copied_arr,
                   kstart, klen, kcum, depth, K: int):
    """Fill copied slots of depth-t rows from their referents' final rows,
    then restore the per-row sorted invariant with one (row, key) sort."""
    m = out.shape[0] - 1
    slots = jnp.arange(m, dtype=jnp.int32)
    x = row_of_slot
    j = (slots - _g(csr_off, x).astype(jnp.int32))
    r = _g(refs, x)
    cop = _g(copied_arr, x)
    dep = _g(depth, x)
    active = (dep == t) & (r > 0) & (j < cop)

    # locate the keep-range holding output position j:  the last k with
    # kcum[k] <= j and (len[k] > 0 or k == 0); zero-length ranges (possible
    # for the first block and the tail) are skipped by the len test.
    kk = jnp.zeros_like(j)
    base = x  # row index into (N1, K) arrays
    for k in range(K):
        c = _g(kcum[:, k], base)
        l = _g(klen[:, k], base)
        kk = jnp.where((c <= j) & ((l > 0) | (k == 0)), k, kk)
    ks = _g(kstart.reshape(-1), base * K + kk)
    kc = _g(kcum.reshape(-1), base * K + kk)
    p = ks + j - kc
    src = (_g(csr_off, jnp.where(r > 0, x - r, x)).astype(jnp.int32) + p)
    val = _g(out, jnp.where(active, src, 0), mode="clip")
    out = out.at[jnp.where(active, slots, m)].set(
        jnp.where(active, val, 0), mode="drop", unique_indices=True)

    # rows completed at depth <= t sort by value; unfinished rows keep order
    finished = dep <= t
    key2 = jnp.where(finished, out[:m], j)
    sorted_vals = jax.lax.sort((x, key2, out[:m]), num_keys=2)[2]
    out = out.at[:m].set(sorted_vals)
    return out


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


def _scalar_patch(out_np, csr_off, flagged, bvgraph):
    """Decode overflow-flagged nodes with the scalar oracle and patch rows."""
    for x in flagged:
        row = bvgraph.successors(int(x))
        out_np[csr_off[x]:csr_off[x] + len(row)] = row
    return out_np


def decode_to_csr(data, offsets, cfg: ParseConfig, bvgraph=None):
    """Full vectorized decode: byte stream + bit offsets -> (csr_off, succ).

    ``bvgraph`` (optional): scalar-oracle graph used to patch rare nodes
    whose copy-block count exceeds cfg.max_blocks.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if offsets[-1] >= 2**31:
        # big stream: delegate to the sliced kernel driver (int32-safe
        # per-slice rebasing, ops/bigdecode.py)
        return _big_fallback(data, offsets, cfg, bvgraph)
    words = jnp.asarray(pack_words_u32(data))

    starts = jnp.asarray(offsets[:-1], dtype=jnp.int32)
    outd, after, uo0 = _pass0(words, starts, cfg)
    if bool(jnp.any(uo0)):
        raise ValueError("unary overrun while reading outdegrees: corrupt "
                         "stream or unsupported coding "
                         f"(nodes {np.flatnonzero(np.asarray(uo0))[:8]})")
    outd_np = np.asarray(outd)
    after_np = np.asarray(after)
    csr_off_np = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd_np, out=csr_off_np[1:])
    m = int(csr_off_np[-1])
    assert m < 2**31, "chunk with >= 2^31 arcs: split into chunks"
    csr_off_np = csr_off_np.astype(np.int64)

    # size-bucketed batching: largest entries first
    B = cfg.batch
    sizes = np.diff(offsets)
    order = np.argsort(-sizes, kind="stable").astype(np.int32)
    nb = max(1, -(-n // B))
    padded = nb * B
    x_all = np.full(padded, n, dtype=np.int32)
    d_all = np.zeros(padded, dtype=np.int32)
    p_all = np.zeros(padded, dtype=np.int32)
    x_all[:n] = order
    d_all[:n] = outd_np[order]
    p_all[:n] = after_np[order]
    xs_stack = {
        "x": jnp.asarray(x_all.reshape(nb, B)),
        "d": jnp.asarray(d_all.reshape(nb, B)),
        "pos": jnp.asarray(p_all.reshape(nb, B)),
    }

    outd_dev = jnp.concatenate([outd, jnp.zeros(1, jnp.int32)])
    csr_dev = jnp.asarray(csr_off_np)
    out = jnp.zeros(m + 1, dtype=jnp.int32)

    out, blocks, refs, copied_arr, bc_arr, oflow = _parse(
        words, xs_stack, outd_dev, csr_dev, out, cfg)

    flagged = np.flatnonzero(np.asarray(oflow[:n]))
    if len(flagged):
        if bvgraph is None:
            raise OverflowError(
                f"{len(flagged)} nodes exceed max_blocks={cfg.max_blocks}; "
                "pass the scalar-oracle graph or raise max_blocks")
        out_np = np.asarray(out).copy()
        out_np = _scalar_patch(out_np, csr_off_np, flagged, bvgraph)
        out = jnp.asarray(out_np)
        # mark patched rows as fully resolved roots
        refs_np = np.asarray(refs).copy()
        refs_np[flagged] = 0
        refs = jnp.asarray(refs_np)
        copied_np = np.asarray(copied_arr).copy()
        copied_np[flagged] = 0
        copied_arr = jnp.asarray(copied_np)

    # phase 2
    depth = _depths(refs[:n]) if n else jnp.zeros(0, jnp.int32)
    depth = jnp.concatenate([depth, jnp.zeros(1, jnp.int32)])
    dmax = int(jnp.max(depth)) if n else 0
    max_bc = int(jnp.max(bc_arr)) if n else 0
    K = min(cfg.max_blocks // 2 + 1, max_bc // 2 + 2)
    K = max(K, 1)
    ref_len = jnp.take(
        outd_dev,
        jnp.maximum(jnp.arange(n + 1, dtype=jnp.int32) - refs, 0),
        mode="clip")
    kstart, klen, kcum = _kept_ranges(blocks, bc_arr, ref_len, K)
    row_of_slot = jnp.asarray(np.repeat(
        np.arange(n, dtype=np.int32), np.diff(csr_off_np)))
    # t = 0 performs no gather but establishes the sorted invariant for
    # root rows (their interval/residual runs may interleave)
    for t in range(0, dmax + 1):
        out = _resolve_depth(out, jnp.int32(t), csr_dev, row_of_slot, refs,
                             copied_arr, kstart, klen, kcum, depth, K)

    succ = np.asarray(out[:m], dtype=np.int64)
    return csr_off_np, succ
