"""Pallas BVGraph decode kernel: lane-per-chunk, fully in-kernel.

The device decode engine (SURVEY §7 step 3, BASELINE north star).  The
graph's node range is split into ~arc-balanced contiguous chunks, one chunk
per lane (1024 lanes per tile, LANES lanes per Triton program).  Each lane
runs the complete BVGraph entry state machine — outdegree / reference /
copy-blocks / intervals / residuals (format spec BVGraph.java:123-233,
decode semantics :995-1097) — over its own bit-stream column, resolving
references *inline* against a per-lane sliding window of already-decoded
lists (the BVGraphNodeIterator discipline, BVGraph.java:1100-1245), so no
post-pass reference resolution is needed.

Chunks are independent because copies only ever target the *final* lists of
the preceding window_size nodes: those halo lists are decoded once at plan
time (or resolved by wavefront passes of the kernel itself, resolve_halos)
and preinjected into each lane's output column via input_output_aliases, so
the kernel neither re-decodes halo nodes nor resolves reference chains
across chunks.  Lanes whose halo+chunk arcs exceed the column budget (dense
hub regions) are skipped and decoded by the device hub path or the native
host path instead.

The kernel is written for the Triton route of Pallas: one lane per thread
(LANES lanes, NUM_WARPS warps per program), and every per-lane random access
is a plain indexed load from global memory — the lane's stream words, copy
heads from its own output column, and a small per-lane scratch area (window
slots, copy blocks, intervals).  A lane only ever reads back addresses it
wrote itself, so no cross-thread ordering is involved.

Error handling: corrupt or unsupported streams set per-lane diagnostic
flags (count mismatches, unary overruns, scratch overflows) instead of
decoding garbage silently; the host wrapper falls back to the XLA/native
decoders when any lane flags.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .packed import pack_words_u32

K_DELTA, K_GAMMA, K_GOLOMB, K_SKEWED, K_UNARY, K_ZETA, K_NIBBLE = (
    1, 2, 3, 4, 5, 6, 7)
K_NONE = 0

# states
ST_DONE = 0
ST_OUTD = 1
ST_REF = 2
ST_BC = 3
ST_BLK = 4
ST_ICNT = 5
ST_ILEFT = 6
ST_ILEN = 7
ST_RESF = 8
ST_EMIT = 9

INT_INF = np.int32(0x7FFFFFFF)
BIG_RUN = np.int32(0x3FFFFFFF)  # "unbounded" keep run (tail copy)

_KERNEL_KINDS = (K_GAMMA, K_DELTA, K_UNARY, K_ZETA)

LANES = 128      # lanes per Triton program: one lane per thread
NUM_WARPS = 4


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static kernel parameters (hashable; keys the compile cache)."""

    window_size: int
    min_interval_length: int
    zeta_k: int
    outdegree_coding: int
    reference_coding: int
    block_count_coding: int
    block_coding: int
    residual_coding: int
    R: int          # stream column rows (uint32 words per lane)
    V: int          # output column rows (successors per lane, halo incl.)
    T: int          # tiles of 1024 lanes
    BMAX: int = 32  # copy-block scratch rows per lane
    IMAX: int = 32  # interval scratch pairs per lane
    max_steps: int = 0

    def supported(self) -> bool:
        ks = {self.outdegree_coding, self.reference_coding,
              self.block_count_coding, self.block_coding,
              self.residual_coding}
        return ks <= set(_KERNEL_KINDS) and 0 <= self.window_size <= 7

    @property
    def scratch_rows(self) -> int:
        """Per-lane scratch: window outdegrees and rows, copy blocks,
        interval lefts and lengths."""
        return 2 * (self.window_size + 1) + self.BMAX + 2 * self.IMAX


# diagnostic row layout
DIAG_ERR, DIAG_WCUR, DIAG_NODES, DIAG_STEPS, DIAG_ROWS = 0, 1, 2, 3, 4

# error bits
E_UNARY = 1        # unary run beyond the 64-bit window
E_WIDTH = 2        # code mantissa beyond 32 bits (value >= 2^32)
E_BLK_OVF = 4      # more copy blocks than BMAX
E_INT_OVF = 8      # more intervals than IMAX
E_COUNT = 16       # emitted successors != outdegree
E_WCUR = 32        # output column overflow
E_STEPS = 64       # step budget exhausted


def _sel3(k32, a, b, c):
    return jnp.where(k32 == 0, a, jnp.where(k32 == 1, b, c))


def _u32(x):
    return x.astype(jnp.uint32)


def _i32(x):
    return x.astype(jnp.int32)


def _make_kernel(spec: KernelSpec):
    W = spec.window_size
    CYC = W + 1
    MININT = spec.min_interval_length
    ZK = spec.zeta_k
    R, V, BMAX, IMAX = spec.R, spec.V, spec.BMAX, spec.IMAX
    # scratch row bases
    S_WD, S_WR = 0, CYC
    S_BLK = 2 * CYC
    S_IL = S_BLK + BMAX
    S_IN = S_IL + IMAX
    PT = 1024 // LANES    # programs per tile

    state_kind = {
        ST_OUTD: spec.outdegree_coding,
        ST_REF: spec.reference_coding if W > 0 else K_NONE,
        ST_BC: spec.block_count_coding if W > 0 else K_NONE,
        ST_BLK: spec.block_coding if W > 0 else K_NONE,
        ST_ICNT: K_GAMMA if MININT else K_NONE,
        ST_ILEFT: K_GAMMA if MININT else K_NONE,
        ST_ILEN: K_GAMMA if MININT else K_NONE,
        ST_RESF: spec.residual_coding,
    }
    kinds_used = tuple(sorted({k for k in state_kind.values()
                               if k != K_NONE}))

    def kernel(meta_ref, col_ref, init_ref, out_ref, diag_ref, scr_ref):
        del init_ref   # aliased to out_ref: the halo lists are already there
        pid = pl.program_id(0)
        t = pid // PT
        lane = (pid % PT) * LANES + jnp.arange(LANES, dtype=jnp.int32)
        zi = jnp.zeros((LANES,), jnp.int32)
        zu = jnp.zeros((LANES,), jnp.uint32)

        def meta(k):
            return meta_ref[t, k, lane]

        # ------------------------------------------------------ memory
        def scr_get(row, en, hi):
            ok = en & (row >= 0) & (row < hi)
            return plgpu.load(scr_ref.at[t, jnp.clip(row, 0, hi - 1), lane],
                              mask=ok, other=0)

        def scr_set(row, val, en):
            plgpu.store(scr_ref.at[t, row, lane], val, mask=en)

        def col_word(rp, en):
            ok = en & (rp < R)
            return _u32(plgpu.load(
                col_ref.at[t, jnp.minimum(rp, R - 1), lane], mask=ok,
                other=0))

        def out_get(row, en):
            ok = en & (row >= 0) & (row < V)
            return plgpu.load(out_ref.at[t, jnp.clip(row, 0, V - 1), lane],
                              mask=ok, other=0)

        n_nodes = meta(0)
        bit0 = meta(1)
        base = meta(2)
        wcur0 = meta(3)  # halo arc count: chunk output starts here
        # meta rows 4.. : initial window (outdegree, halo row) per slot
        for s in range(CYC):
            scr_set(S_WD + s + zi, meta(4 + s), zi == 0)
            scr_set(S_WR + s + zi, meta(4 + CYC + s), zi == 0)
        # preset lanes (hub residual segments, wg_bv_hub_parse checkpoints):
        # start directly in EMIT with a pure residual run — count from meta,
        # head value from meta, stream positioned after the head's code
        pre_cnt = meta(4 + 2 * CYC)
        pre_val = meta(5 + 2 * CYC)
        preset = pre_cnt > 0

        # ------------------------------------------------------ bit buffer
        def refill(b0, b1, b2, avail, rp, active):
            """Append the lane's next stream word at bit position avail
            (96-bit buffer b0:b1:b2) when at most 64 bits are buffered."""
            need = active & (avail <= 64)
            w = col_word(rp, need)
            k32 = avail >> 5
            r = _u32(avail & 31)
            rr = jnp.where(r > 0, jnp.uint32(32) - r, 1)
            w_hi = jnp.where(r > 0, w >> r, w)
            w_lo = jnp.where(r > 0, w << rr, jnp.uint32(0))
            b0 = jnp.where(need & (k32 == 0), b0 | w_hi, b0)
            b1 = jnp.where(need & (k32 == 0), b1 | w_lo,
                           jnp.where(need & (k32 == 1), b1 | w_hi, b1))
            b2 = jnp.where(need & (k32 == 1), b2 | w_lo,
                           jnp.where(need & (k32 == 2), b2 | w_hi, b2))
            avail = jnp.where(need, avail + 32, avail)
            rp = jnp.where(need, rp + 1, rp)
            return b0, b1, b2, avail, rp

        def consume(b0, b1, b2, avail, k):
            k32 = k >> 5
            r = _u32(k & 31)
            B0 = _sel3(k32, b0, b1, b2)
            B1 = _sel3(k32, b1, b2, zu)
            B2 = _sel3(k32, b2, zu, zu)
            rr = jnp.where(r > 0, jnp.uint32(32) - r, 1)
            hasr = r > 0
            nb0 = jnp.where(hasr, (B0 << r) | (B1 >> rr), B0)
            nb1 = jnp.where(hasr, (B1 << r) | (B2 >> rr), B1)
            nb2 = jnp.where(hasr, B2 << r, B2)
            return nb0, nb1, nb2, avail - k

        def extract(b0, b1, b2, off, nb):
            """nb (0..32) bits at bit offset off (0..66) as uint32."""
            k32 = off >> 5
            r = _u32(off & 31)
            B0 = _sel3(k32, b0, b1, b2)
            B1 = _sel3(k32, b1, b2, zu)
            rr = jnp.where(r > 0, jnp.uint32(32) - r, 1)
            top = jnp.where(r > 0, (B0 << r) | (B1 >> rr), B0)
            ok = nb > 0
            return jnp.where(ok, top >> _u32(jnp.where(ok, 32 - nb, 1)),
                             jnp.uint32(0))

        def shl1(n):
            return (jnp.uint32(1) << _u32(jnp.clip(n, 0, 31)))

        def read_code(b0, b1, b2, kind, err):
            """One instantaneous code at the buffer head.

            Returns (value uint32, advance int32, err).  Lanes with
            kind == K_NONE read nothing (value 0, advance 0)."""
            active = kind != K_NONE
            u = jnp.where(b0 != 0, jax.lax.clz(_i32(b0)),
                          32 + jax.lax.clz(_i32(b1)))
            err = err | jnp.where(active & (b0 == 0) & (b1 == 0),
                                  E_UNARY, 0)
            u = jnp.where(active, jnp.minimum(u, 63), 0)
            value = zu
            adv = zi

            if K_UNARY in kinds_used:
                m = kind == K_UNARY
                value = jnp.where(m, _u32(u), value)
                adv = jnp.where(m, u + 1, adv)
            if K_GAMMA in kinds_used:
                m = kind == K_GAMMA
                err = err | jnp.where(m & (u > 31), E_WIDTH, 0)
                um = jnp.where(m, jnp.minimum(u, 31), 0)
                mant = extract(b0, b1, b2, um + 1, um)
                v = (shl1(um) | mant) - 1
                value = jnp.where(m, v, value)
                adv = jnp.where(m, 2 * um + 1, adv)
            if K_DELTA in kinds_used:
                m = kind == K_DELTA
                err = err | jnp.where(m & (u > 31), E_WIDTH, 0)
                um = jnp.where(m, jnp.minimum(u, 31), 0)
                mant = extract(b0, b1, b2, um + 1, um)
                e = _i32((shl1(um) | mant) - 1)
                err = err | jnp.where(m & (e > 31), E_WIDTH, 0)
                e = jnp.where(m, jnp.minimum(e, 31), 0)
                mant2 = extract(b0, b1, b2, 2 * um + 1, e)
                v = (shl1(e) | mant2) - 1
                value = jnp.where(m, v, value)
                adv = jnp.where(m, 2 * um + 1 + e, adv)
            if K_ZETA in kinds_used:
                m = kind == K_ZETA
                l1 = u * ZK + (ZK - 1)
                err = err | jnp.where(m & (l1 > 32), E_WIDTH, 0)
                l1 = jnp.where(m, jnp.minimum(l1, 32), 0)
                bits = extract(b0, b1, b2, u + 1, l1)
                left = shl1(u * ZK)
                short = bits < left
                eb = extract(b0, b1, b2, u + 1 + l1,
                             jnp.where(m & ~short, 1, 0))
                v = jnp.where(short, bits + left - 1, (bits << 1) + eb - 1)
                value = jnp.where(m, v, value)
                adv = jnp.where(m, u + 1 + l1 + jnp.where(short, 0, 1), adv)
            return value, adv, err

        def nat2int(v):
            return _i32(v >> 1) ^ -(_i32(v & 1))

        # ------------------------------------------------------ init
        b0, b1, b2 = zu, zu, zu
        avail, rp = zi, zi
        live0 = n_nodes > 0
        for _ in range(3):
            b0, b1, b2, avail, rp = refill(b0, b1, b2, avail, rp, live0)
        b0, b1, b2, avail = consume(b0, b1, b2, avail,
                                    jnp.where(live0, bit0, 0))

        st0 = jnp.where(live0, jnp.where(preset, ST_EMIT, ST_OUTD), ST_DONE)
        d0 = jnp.where(preset, pre_cnt, 0)

        carry0 = dict(
            step=jnp.int32(0), st=st0, node=zi, x=base, err=zi,
            b0=b0, b1=b1, b2=b2, avail=avail, rp=rp,
            wcur=wcur0, nrow=wcur0, d=d0, ref=zi, e_rem=d0, cop=zi,
            bc=zi, blk_i=zi, blk_tot=zi, blk_cop=zi, blk0=zi,
            icnt=zi, i_idx=zi, iprev=zi, extra=zi,
            ref_row=zi, ref_len=zi,
            c_rem=zi, c_idx=zi, krem=zi, bj=zi, c_val=zi,
            iv=zi, ilen_rem=zi, i_next=zi,
            r_rem=d0, r_val=jnp.where(preset, pre_val, 0),
        )
        keys = tuple(sorted(carry0.keys()))

        def body(cc):
            g = dict(zip(keys, cc))
            st = g["st"]
            err = g["err"]
            x = g["x"]

            # -- refill (two words keep >= 64 bits buffered) + gate
            live = st != ST_DONE
            b0, b1, b2, avail, rp = refill(g["b0"], g["b1"], g["b2"],
                                           g["avail"], g["rp"], live)
            b0, b1, b2, avail, rp = refill(b0, b1, b2, avail, rp, live)
            can = live & (avail >= 64)

            m_outd = can & (st == ST_OUTD)
            m_ref = can & (st == ST_REF)
            m_bc = can & (st == ST_BC)
            m_blk = can & (st == ST_BLK)
            m_icnt = can & (st == ST_ICNT)
            m_ileft = can & (st == ST_ILEFT)
            m_ilen = can & (st == ST_ILEN)
            m_resf = can & (st == ST_RESF)
            m_emit = can & (st == ST_EMIT)

            # -- EMIT winner: the three streams are pairwise disjoint and
            # sorted (BVGraph.java:1062-1090), so the smallest head emits
            cval = jnp.where(g["c_rem"] > 0, g["c_val"], INT_INF)
            ival = jnp.where(g["ilen_rem"] > 0, g["iv"], INT_INF)
            rv = jnp.where(g["r_rem"] > 0, g["r_val"], INT_INF)
            win_c = m_emit & (cval <= ival) & (cval <= rv)
            win_i = m_emit & ~win_c & (ival <= rv)
            win_r = m_emit & ~win_c & ~win_i & (rv < INT_INF)
            emit_en = win_c | win_i | win_r
            emit_val = jnp.where(win_c, cval, jnp.where(win_i, ival, rv))
            err = err | jnp.where(m_emit & ~emit_en, E_COUNT, 0)

            # -- one code read: the header state's code, or the next
            # residual gap after an emitted residual
            kind = zi
            for mm, ss in ((m_outd, ST_OUTD), (m_ref, ST_REF),
                           (m_bc, ST_BC), (m_blk, ST_BLK),
                           (m_icnt, ST_ICNT), (m_ileft, ST_ILEFT),
                           (m_ilen, ST_ILEN), (m_resf, ST_RESF)):
                if state_kind[ss] != K_NONE:
                    kind = jnp.where(mm, state_kind[ss], kind)
            read_res = win_r & (g["r_rem"] > 1)
            kind = jnp.where(read_res, spec.residual_coding, kind)
            value, adv, err = read_code(b0, b1, b2, kind, err)
            vi = _i32(value)
            b0, b1, b2, avail = consume(b0, b1, b2, avail, adv)

            # ================= header transitions =================
            nst = st
            d = g["d"]
            ref = g["ref"]
            cop = g["cop"]
            extra = g["extra"]
            ref_len = g["ref_len"]
            ref_row = g["ref_row"]

            # ST_OUTD: outdegree
            d = jnp.where(m_outd, vi, d)
            done_d0 = m_outd & (d == 0)
            go_ref = m_outd & (d > 0)
            if W > 0:
                nst = jnp.where(go_ref, ST_REF, nst)
                setup = jnp.zeros_like(m_outd)
            else:
                setup = go_ref
                cop = jnp.where(go_ref, 0, cop)
                ref = jnp.where(go_ref, 0, ref)

            # ST_REF: reference
            if W > 0:
                ref = jnp.where(m_ref, vi, ref)
                has_ref = m_ref & (ref > 0)
                slot = jnp.where(has_ref, (x - ref) % CYC, 0)
                ref_len = jnp.where(has_ref,
                                    scr_get(S_WD + slot, has_ref, CYC),
                                    ref_len)
                ref_row = jnp.where(has_ref,
                                    scr_get(S_WR + slot, has_ref,
                                            S_WR + CYC),
                                    ref_row)
                nst = jnp.where(has_ref, ST_BC, nst)
                setup = setup | (m_ref & (ref == 0))
                cop = jnp.where(m_ref, 0, cop)

            # ST_BC / ST_BLK: copy blocks
            bc = g["bc"]
            blk_i = g["blk_i"]
            blk_tot = g["blk_tot"]
            blk_cop = g["blk_cop"]
            blk0 = g["blk0"]
            if W > 0:
                bc = jnp.where(m_bc, vi, bc)
                err = err | jnp.where(m_bc & (bc > BMAX), E_BLK_OVF, 0)
                bc = jnp.where(m_bc, jnp.minimum(bc, BMAX), bc)
                blk_i = jnp.where(m_bc, 0, blk_i)
                blk_tot = jnp.where(m_bc, 0, blk_tot)
                blk_cop = jnp.where(m_bc, 0, blk_cop)
                fin_bc0 = m_bc & (bc == 0)
                # bc == 0: the whole reference list is copied
                cop = jnp.where(fin_bc0, ref_len, cop)
                setup = setup | fin_bc0
                nst = jnp.where(m_bc & (bc > 0), ST_BLK, nst)

                # one block per step; wire value +1 except the first
                # (BVGraph.java:1025, :2076)
                bval = jnp.where(blk_i == 0, vi, vi + 1)
                scr_set(S_BLK + jnp.clip(blk_i, 0, BMAX - 1), bval,
                        m_blk & (blk_i < BMAX))
                blk0 = jnp.where(m_blk & (blk_i == 0), bval, blk0)
                blk_tot = jnp.where(m_blk, blk_tot + bval, blk_tot)
                blk_cop = jnp.where(m_blk & (blk_i % 2 == 0),
                                    blk_cop + bval, blk_cop)
                blk_i = jnp.where(m_blk, blk_i + 1, blk_i)
                fin_blk = m_blk & (blk_i == bc)
                # even block count: implicit tail copy (BVGraph.java:1030)
                cop = jnp.where(
                    fin_blk,
                    blk_cop + jnp.where(bc % 2 == 0, ref_len - blk_tot, 0),
                    cop)
                setup = setup | fin_blk

            # setup: route to intervals / residuals / emit
            extra = jnp.where(setup, d - cop, extra)
            err = err | jnp.where(setup & (extra < 0), E_COUNT, 0)
            icnt = jnp.where(setup, 0, g["icnt"])
            i_idx = g["i_idx"]
            iprev = g["iprev"]
            if MININT:
                nst = jnp.where(setup & (extra > 0), ST_ICNT, nst)
                to_resf = jnp.zeros_like(setup)
            else:
                to_resf = setup & (extra > 0)
            init_emit = setup & (extra == 0)

            # ST_ICNT / ST_ILEFT / ST_ILEN: intervals
            if MININT:
                icnt = jnp.where(m_icnt, vi, icnt)
                err = err | jnp.where(m_icnt & (icnt > IMAX), E_INT_OVF, 0)
                icnt = jnp.where(m_icnt, jnp.minimum(icnt, IMAX), icnt)
                i_idx = jnp.where(m_icnt, 0, i_idx)
                nst = jnp.where(m_icnt & (icnt > 0), ST_ILEFT, nst)
                to_resf = to_resf | (m_icnt & (icnt == 0))

                # left extreme: first int2nat(gamma)+x, later gap+prev+1
                # (BVGraph.java:1040-1059); parked in iprev until its
                # length arrives
                lf = jnp.where(i_idx == 0, nat2int(value) + x,
                               vi + iprev + 1)
                iprev = jnp.where(m_ileft, lf, iprev)
                nst = jnp.where(m_ileft, ST_ILEN, nst)

                ln = vi + MININT
                iw = m_ilen & (i_idx < IMAX)
                scr_set(S_IL + jnp.clip(i_idx, 0, IMAX - 1), iprev, iw)
                scr_set(S_IN + jnp.clip(i_idx, 0, IMAX - 1), ln, iw)
                iprev = jnp.where(m_ilen, iprev + ln, iprev)
                extra = jnp.where(m_ilen, extra - ln, extra)
                err = err | jnp.where(m_ilen & (extra < 0), E_COUNT, 0)
                i_idx = jnp.where(m_ilen, i_idx + 1, i_idx)
                fin_int = m_ilen & (i_idx == icnt)
                nst = jnp.where(m_ilen & ~fin_int, ST_ILEFT, nst)
                to_resf = to_resf | (fin_int & (extra > 0))
                init_emit = init_emit | (fin_int & (extra <= 0))

            nst = jnp.where(to_resf, ST_RESF, nst)

            # ST_RESF: first residual
            r_val = jnp.where(m_resf, nat2int(value) + x, g["r_val"])
            r_rem = jnp.where(m_resf, extra,
                              jnp.where(init_emit, 0, g["r_rem"]))
            init_emit = init_emit | m_resf
            nst = jnp.where(init_emit, ST_EMIT, nst)

            # ================= EMIT advances + init =================
            # residual advance
            r_rem = jnp.where(win_r, r_rem - 1, r_rem)
            r_val = jnp.where(read_res, r_val + vi + 1, r_val)

            # interval advance
            cnt_i = jnp.where(win_i, 1, 0)
            ilen_rem = g["ilen_rem"] - cnt_i
            iv = g["iv"] + cnt_i
            i_next = g["i_next"]
            itrans = win_i & (ilen_rem == 0) & (i_next < icnt)
            ilen_rem = jnp.where(init_emit, 0, ilen_rem)
            i_next = jnp.where(init_emit, 0, i_next)
            if MININT:
                iinit = init_emit & (icnt > 0)
                i_sel = jnp.where(iinit, 0, i_next)
                iread = itrans | iinit
                iv = jnp.where(iread, scr_get(S_IL + i_sel, iread,
                                              S_IL + IMAX), iv)
                ilen_rem = jnp.where(iread, scr_get(S_IN + i_sel, iread,
                                                    S_IN + IMAX), ilen_rem)
                i_next = jnp.where(iread, i_sel + 1, i_next)

            # copy advance
            cnt_c = jnp.where(win_c, 1, 0)
            c_rem = g["c_rem"] - cnt_c
            c_idx = g["c_idx"] + cnt_c
            krem = g["krem"] - cnt_c
            bj = g["bj"]
            c_val = g["c_val"]
            ctrans = win_c & (krem == 0) & (c_rem > 0)
            c_rem = jnp.where(init_emit, 0, c_rem)
            if W > 0:
                cinit = init_emit & (ref > 0)
                c_rem = jnp.where(cinit, cop, c_rem)
                c_idx = jnp.where(cinit, 0, c_idx)
                krem = jnp.where(cinit, jnp.where(bc > 0, blk0, BIG_RUN),
                                 krem)
                bj = jnp.where(cinit, 0, bj)
                cinit_skip = cinit & (krem == 0) & (c_rem > 0)
                # block-run transition: skip run + next keep run
                btrans = ctrans | cinit_skip
                bj_sel = jnp.where(cinit_skip, 0, bj)
                skip = scr_get(S_BLK + bj_sel + 1, btrans, S_BLK + BMAX)
                nkeep = scr_get(S_BLK + bj_sel + 2, btrans, S_BLK + BMAX)
                c_idx = jnp.where(btrans, c_idx + skip, c_idx)
                krem = jnp.where(btrans,
                                 jnp.where(bj_sel + 2 < bc, nkeep, BIG_RUN),
                                 krem)
                bj = jnp.where(btrans, bj_sel + 2, bj)
            e_rem = jnp.where(init_emit, d, g["e_rem"])

            # -- output write
            wcur = g["wcur"]
            ovf = emit_en & (wcur >= V)
            err = err | jnp.where(ovf, E_WCUR, 0)
            plgpu.store(out_ref.at[t, jnp.clip(wcur, 0, V - 1), lane],
                        emit_val, mask=emit_en & ~ovf)
            wcur = wcur + cnt_i + cnt_c + jnp.where(win_r, 1, 0)
            e_rem = e_rem - jnp.where(emit_en, 1, 0)

            if W > 0:
                # next copy head from the lane's own output column
                creload = (win_c | cinit) & (c_rem > 0)
                c_val = jnp.where(creload, out_get(ref_row + c_idx, creload),
                                  c_val)

            # -- node completion
            done_emit = emit_en & (e_rem == 0)
            err = err | jnp.where(
                done_emit & ((c_rem != 0) | (ilen_rem != 0)
                             | (i_next != icnt) | (r_rem != 0)),
                E_COUNT, 0)
            done_any = done_emit | done_d0
            # window update (outdegree + output row of the finished node)
            slot_w = x % CYC
            scr_set(S_WD + slot_w, d, done_any)
            scr_set(S_WR + slot_w, g["nrow"], done_any)
            nrow = jnp.where(done_any, wcur, g["nrow"])
            node = jnp.where(done_any, g["node"] + 1, g["node"])
            x = jnp.where(done_any, x + 1, x)
            nst = jnp.where(done_any,
                            jnp.where(node >= n_nodes, ST_DONE, ST_OUTD),
                            nst)
            # any error: freeze the lane
            nst = jnp.where(err != 0, ST_DONE, nst)

            g.update(step=g["step"] + 1, st=nst, node=node, x=x, err=err,
                     b0=b0, b1=b1, b2=b2, avail=avail, rp=rp,
                     wcur=wcur, nrow=nrow, d=d, ref=ref, e_rem=e_rem,
                     cop=cop, bc=bc, blk_i=blk_i, blk_tot=blk_tot,
                     blk_cop=blk_cop, blk0=blk0, icnt=icnt, i_idx=i_idx,
                     iprev=iprev, extra=extra, ref_row=ref_row,
                     ref_len=ref_len, c_rem=c_rem, c_idx=c_idx, krem=krem,
                     bj=bj, c_val=c_val, iv=iv, ilen_rem=ilen_rem,
                     i_next=i_next, r_rem=r_rem, r_val=r_val)
            return tuple(g[k] for k in keys)

        def cond(cc):
            g = dict(zip(keys, cc))
            busy = jnp.max(jnp.where(g["st"] != ST_DONE, 1, 0))
            return (g["step"] < spec.max_steps) & (busy > 0)

        final = dict(zip(keys, jax.lax.while_loop(
            cond, body, tuple(carry0[k] for k in keys))))
        diag_ref[t, DIAG_ERR, lane] = final["err"] | jnp.where(
            final["st"] != ST_DONE, E_STEPS, 0)
        diag_ref[t, DIAG_WCUR, lane] = final["wcur"]
        diag_ref[t, DIAG_NODES, lane] = final["node"]
        diag_ref[t, DIAG_STEPS, lane] = zi + final["step"]

    return kernel


def kernel_mode() -> bool:
    """Pallas interpret flag for the default backend: the compiled Triton
    kernel on a GPU, the interpreter on the CPU (tests).  Any other platform
    has no kernel route."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(f"no decode-kernel route for platform {platform!r}")


def _decode_call(spec: KernelSpec, T: int, interpret: bool):
    """The pallas_call over ``T`` tiles: (meta, col, init) -> (out, diag)."""
    return pl.pallas_call(
        _make_kernel(spec),
        grid=(T * (1024 // LANES),),
        out_shape=(
            jax.ShapeDtypeStruct((T, spec.V, 1024), jnp.int32),
            jax.ShapeDtypeStruct((T, DIAG_ROWS, 1024), jnp.int32),
            jax.ShapeDtypeStruct((T, spec.scratch_rows, 1024), jnp.int32),
        ),
        input_output_aliases={2: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bv_decode",
    )


@functools.partial(jax.jit, static_argnames=("spec", "interpret"))
def run_tiles(meta, col, init_out, spec: KernelSpec, interpret: bool):
    """Decode every tile of the given arrays in one kernel launch.  Returns
    (out_cols (T, V//8, 8, 8, 128), diag (T, DIAG_ROWS, 8, 128))."""
    T = meta.shape[0]
    out, diag, _ = _decode_call(spec, T, interpret)(
        meta.reshape(T, -1, 1024), col.reshape(T, spec.R, 1024),
        init_out.reshape(T, spec.V, 1024))
    return (out.reshape(T, spec.V // 8, 8, 8, 128),
            diag.reshape(T, DIAG_ROWS, 8, 128))


# ---------------------------------------------------------------------------
# Host-side preparation: chunking + column layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HubPlan:
    """Device-side hub decode plan (nodes whose lists exceed the lane column
    envelope).  Built from wg_bv_hub_parse: every hub node's residual run
    splits into checkpointed segments decoded by PRESET kernel lanes; its
    interval extents are static header data pre-scattered into the hub
    image; its copied ranges become device gathers from the chunked store
    (or from shallower hub nodes, in reference-chain-depth rounds).  The
    merge positions are part of the plan index (derived, like the halo
    lists, from the one-time plan decode)."""

    nodes: np.ndarray        # int64[H] hub node ids (ascending)
    hb_off: np.ndarray       # int64[H+1] bases into the hub value array
    node_is_hub: np.ndarray  # bool[n]
    hub_idx: np.ndarray      # int64[n] node -> hub ordinal (-1 otherwise)
    seg_lane0: int           # first preset lane index
    seg_node: np.ndarray     # int64[P] hub node id per preset lane
    seg_cnt: np.ndarray      # int64[P]
    hub_init: jnp.ndarray    # int32[M_hub] interval values pre-injected
    src_res: jnp.ndarray     # int32[] preset-local lane-major idx (resid.)
    dst_res: jnp.ndarray     # int32[] positions in the hub value array
    src_cop0: jnp.ndarray    # int32[] flat tiled idx (depth-0 copies)
    dst_cop0: jnp.ndarray    # int32[] hub positions (depth-0 copies)
    cop_rounds: list         # [(depth, src idx, dst idx), ...] depth > 0
    src_chunk: np.ndarray    # int64[H] copy-source chunk (-1 none/hub)
    src_hub: np.ndarray      # int64[H] copy-source hub ordinal (-1 none)
    depth: np.ndarray        # int64[H] reference-chain depth among hubs
    # cold-plan deferral: merge positions (dst_*) are unknown until real
    # values exist — each component element gets a static UNSORTED slot
    # ([copies | intervals | residuals] per hub); finalize_hub() expands
    # the compact per-pair/interval/segment bases to element arrays on
    # device and derives the dst arrays from an argsort at the wavefront
    # fixpoint
    finalized: bool = True
    cold_compact: Optional[dict] = None
    # composed-gather source map (cold finalize): final hub position ->
    # lane-major store source (or >= T*1024*V: index into int_table)
    src_final: Optional[jnp.ndarray] = None
    int_table: Optional[jnp.ndarray] = None


def _tiled_flat(lane, row, V):
    """Flat index into the (T, V//8, 8, 8, 128) grouped store layout."""
    return ((lane >> 10) * (V * 1024) + (row >> 3) * 8192
            + (row & 7) * 1024 + (lane & 1023))


@dataclasses.dataclass
class PreparedDecode:
    """Device-ready decode plan: stream columns + per-lane metadata + halo
    lists pre-packed into the output-column image.

    Built once per graph at load/prepare time (the analogue of the
    reference's offsets/.obl index construction; includes one host decode
    for the halo lists).  `decode_chunked` then runs the kernel per tile;
    the per-lane output columns are the chunked successor store."""

    spec: KernelSpec
    meta: jnp.ndarray        # (T, NMETA, 8, 128) int32
    col: jnp.ndarray         # (T, R, 8, 128) int32
    init_out: jnp.ndarray    # (T, V, 8, 128) int32 (halo lists at rows < H)
    n: int
    m: int
    chunk_starts: np.ndarray  # int64[L+1] node boundaries (plan-local)
    halo_arcs: np.ndarray     # int64[L] rows occupied by halo lists
    cum_arcs: np.ndarray      # int64[n+1]
    outdegrees: np.ndarray    # int64[n]
    skipped: np.ndarray       # bool[L]: lanes outside the column envelope
    offsets: np.ndarray       # int64[n+1] bit offsets (native fallback)
    node_base: int = 0        # global id of plan-local node 0 (big slices)
    arc_base: int = 0         # cum_arcs at the first chunked node
    hub: Optional[HubPlan] = None
    exp_arcs: Optional[np.ndarray] = None   # int64[lanes] expected wcur
    exp_nodes: Optional[np.ndarray] = None  # int64[lanes] expected nodes
    # cold-plan state (plan built from .graph/.offsets alone): halo values
    # come from resolve_halos() wavefront passes — wf_dst0/wf_src0 are
    # COMPACT per-halo-list lane-major base positions (dst in the init
    # image, src in the store); the per-element (tiled-flat) index pair is
    # expanded on device at resolve time
    cold: bool = False
    resolved: bool = True
    wf_dst0: Optional[np.ndarray] = None
    wf_src0: Optional[np.ndarray] = None
    wf_nodes: Optional[np.ndarray] = None    # per-halo-list pred node id
    wf_cnt: Optional[np.ndarray] = None      # per-halo-list length
    wf_chunk: Optional[np.ndarray] = None    # per-halo-list source chunk
    wf_depth: Optional[np.ndarray] = None    # per-halo-list chain depth
    # (pred's list is correct after this many kernel passes; from the
    # header refs — per-element convergence, so resolve runs max(depth)
    # passes and extracts only the lists that just became correct)
    node_depth_max: int = 0   # max D over all nodes (hub finalize needs a
    # decode whose store is fully correct, i.e. pass node_depth_max)
    # device-CSR assembly index (plan_csr_index): per-arc tiled-store
    # gather positions + hub arc CSR destinations
    csr_idx4: Optional[jnp.ndarray] = None
    csr_hub_dst: Optional[jnp.ndarray] = None
    csr_fill_dst: Optional[jnp.ndarray] = None  # cached host-fill splice
    csr_fill_val: Optional[jnp.ndarray] = None
    _data: Optional[np.ndarray] = None       # stream bytes (auto-resolve)
    _settings: object = None

    @property
    def lanes(self) -> int:
        return self.spec.T * 1024

    @property
    def n_chunk_lanes(self) -> int:
        return len(self.chunk_starts) - 1


def _chunk_needs(starts, ends, offsets, cum, outd, refs, W, n):
    """Per-chunk resource needs: (needed pred-slot matrix, halo_arcs,
    nwords, need_v).  ``needed[i, j]`` marks predecessor start_i-1-j as
    referenced across the chunk boundary (only the first W chunk nodes can,
    since ref <= W <= 7)."""
    L = len(starts)
    empty = starts == ends
    lanes_idx = np.arange(L)
    needed = np.zeros((L, max(W, 1)), dtype=bool)
    if W > 0:
        if refs is not None:
            for o in range(W):
                xs = starts + o
                valid = (~empty) & (xs < ends) & (xs < n)
                rr = np.where(valid, refs[np.minimum(xs, n - 1)], 0)
                ys = xs - rr
                cross = valid & (rr > 0) & (ys < starts)
                j = (starts - 1 - ys)[cross]
                needed[lanes_idx[cross], j] = True
        else:
            for j in range(W):
                needed[:, j] = (starts - 1 - j) >= 0
    ys_all = starts[:, None] - 1 - np.arange(max(W, 1))[None, :]
    ydeg = np.where(needed & (ys_all >= 0),
                    outd[np.clip(ys_all, 0, max(n - 1, 0))], 0)
    # halo rows padded to a multiple of 8: the stage-flush machinery works
    # on 8-row groups and must never touch the pre-injected halo groups
    halo_arcs = (ydeg.sum(axis=1) + 7) & ~np.int64(7)
    nwords = np.where(empty, 0,
                      (offsets[ends] + 31) // 32 - (offsets[starts] >> 5))
    need_v = halo_arcs + (cum[ends] - cum[starts]) + 1
    return needed, halo_arcs, nwords, need_v


def _split_chunk(s, e, offsets, cum, outd, refs, W, v_cap, r_cap):
    """Greedy walk over [s, e): emit maximal sub-chunks that fit the
    (v_cap, r_cap) envelope.  Single nodes that alone violate it are
    emitted as their own chunk (the planner marks them skipped -> host
    fill).  Returns the list of sub-chunk end boundaries."""
    subs = []
    s2 = s
    while s2 < e:
        if W > 0 and refs is None:
            halo = int(outd[max(s2 - W, 0):s2].sum())
        else:
            halo = 0
        preds = set()
        e2 = s2
        while e2 < e:
            x = e2
            y = -1
            if W > 0 and refs is not None and x - s2 < W:
                r = int(refs[x])
                if r > 0 and x - r < s2:
                    y = x - r
            add = int(outd[y]) if (y >= 0 and y not in preds) else 0
            hp = (halo + add + 7) & ~7
            arcs2 = int(cum[e2 + 1] - cum[s2])
            words = int((offsets[e2 + 1] + 31) // 32 - (offsets[s2] >> 5))
            if hp + arcs2 + 1 > v_cap or words > r_cap - 2:
                if e2 == s2:
                    e2 += 1  # lone violator: emit anyway, becomes skipped
                break
            halo += add
            if y >= 0:
                preds.add(y)
            e2 += 1
        subs.append(e2)
        s2 = e2
    return subs


def _parse_hubs(data, settings, hub_nodes, offsets, outd, arc_q, bit_q):
    """Native hub-entry parse -> per-node header structures + residual
    checkpoint segments (wg_bv_hub_parse)."""
    from .. import native as _native

    return _native.hub_parse(data, hub_nodes, offsets[hub_nodes], outd,
                             settings, arc_q, bit_q)


def _plan_hub_assembly(h, hub_nodes, hco, hsu, outd, cum, bounds,
                       halo_arcs, n, V, seg_lane0, seg_node, seg_cnt,
                       seg_of_node):
    """Build the device assembly plan: merge positions for every hub arc
    (copies / intervals / residual segments), flat gather sources, and
    reference-chain-depth copy rounds."""
    H = len(hub_nodes)
    hb_off = np.zeros(H + 1, dtype=np.int64)
    np.cumsum(outd[hub_nodes], out=hb_off[1:])
    node_is_hub = np.zeros(n, dtype=bool)
    node_is_hub[hub_nodes] = True
    hub_idx = np.full(n, -1, dtype=np.int64)
    hub_idx[hub_nodes] = np.arange(H)
    starts = bounds[:-1]

    M_hub = int(hb_off[-1])
    init_vals = np.zeros(M_hub, dtype=np.int32)
    taken = np.zeros(M_hub, dtype=bool)
    src_chunk = np.full(H, -1, dtype=np.int64)
    src_hub = np.full(H, -1, dtype=np.int64)
    warm = hsu is not None

    def _expand(cnts):
        """within-offsets for flat runs of the given lengths."""
        tot = int(cnts.sum())
        return (np.arange(tot, dtype=np.int64)
                - np.repeat(np.cumsum(cnts) - cnts, cnts))

    if warm:
        # composite-key view of all hub lists at once: key = ord * 2^32 +
        # value (values < 2^31), globally sorted, so one searchsorted
        # resolves merge positions for every hub node without a per-node
        # loop — and positions come out directly in hub-flat coordinates
        hl_idx = np.repeat(hco[hub_nodes], np.diff(hb_off)) + _expand(
            np.diff(hb_off))
        keys = (np.repeat(np.arange(H, dtype=np.int64), np.diff(hb_off))
                << 32) | hsu[hl_idx]

    # copy pairs (flat over kept ranges)
    ref = h["ref"]
    yv = hub_nodes - ref
    has_cop = (ref > 0) & (h["kept_cnt"] > 0)
    y_is_hub = np.zeros(H, dtype=bool)
    y_is_hub[has_cop] = node_is_hub[yv[has_cop]]
    src_hub[has_cop & y_is_hub] = hub_idx[yv[has_cop & y_is_hub]]
    ynorm = has_cop & ~y_is_hub
    src_chunk[ynorm] = np.searchsorted(bounds, yv[ynorm], "right") - 1
    # depth by fixpoint over the (acyclic, y < x) hub reference DAG
    depth = np.zeros(H, dtype=np.int64)
    for _ in range(64):
        nd = np.where(src_hub >= 0, depth[np.maximum(src_hub, 0)] + 1, 0)
        if np.array_equal(nd, depth):
            break
        depth = nd

    pair_node = np.repeat(np.arange(H, dtype=np.int64), h["kept_cnt"])
    pair_s0 = h["kept"][:, 0]
    pair_ln = h["kept"][:, 1]
    pair_yhub = y_is_hub[pair_node]
    pair_depth = depth[pair_node]
    int_node = np.repeat(np.arange(H, dtype=np.int64), h["int_cnt"])
    int_left = h["ints"][:, 0]
    int_ln = h["ints"][:, 1]
    resc = np.asarray(h["res_cnt"], dtype=np.int64)

    # per-pair source BASE: hub-flat position for hub->hub copies,
    # lane-major store position otherwise (element expansion happens on
    # device — see finalize_hub / the warm branch below)
    src0_pair = np.empty(len(pair_node), dtype=np.int64)
    ph = pair_yhub
    src0_pair[ph] = hb_off[hub_idx[yv[pair_node[ph]]]] + pair_s0[ph]
    pn = ~ph
    c_p = src_chunk[pair_node[pn]]
    src0_pair[pn] = (c_p * np.int64(V) + halo_arcs[c_p]
                     + (cum[yv[pair_node[pn]]] - cum[starts[c_p]])
                     + pair_s0[pn])

    idt = np.int32 if (seg_lane0 + len(seg_node) + 1024) * V < (1 << 31) \
        else np.int64

    if warm:
        # merge positions by searchsorted against the known final lists
        el_node = np.repeat(pair_node, pair_ln)
        el_off = np.repeat(pair_s0, pair_ln) + _expand(pair_ln)
        el_yhub = np.repeat(pair_yhub, pair_ln)
        src_cop = np.repeat(src0_pair, pair_ln) + _expand(pair_ln)
        en = ~el_yhub
        lane_en = src_cop[en] // V
        row_en = src_cop[en] - lane_en * V
        src_cop[en] = _tiled_flat(lane_en, row_en, V)
        el_depth = np.repeat(pair_depth, pair_ln)
        iw = _expand(int_ln)
        int_el_val = (np.repeat(int_left, int_ln) + iw).astype(np.int32)
        lane_el = seg_lane0 + np.repeat(
            np.arange(len(seg_cnt), dtype=np.int64), seg_cnt)
        row_el = _expand(np.asarray(seg_cnt, dtype=np.int64))
        src_res = (lane_el - seg_lane0) * V + row_el

        dst_cop = np.searchsorted(keys, (el_node << 32)
                                  | hsu[np.repeat(hco[yv[pair_node]]
                                                  + pair_s0, pair_ln)
                                        + _expand(pair_ln)])
        taken[dst_cop] = True
        int_dst = (np.repeat(np.searchsorted(
            keys, (int_node << 32) | int_left), int_ln) + iw)
        init_vals[int_dst] = int_el_val
        taken[int_dst] = True
        # residuals: the untaken positions, in order == segment emit order
        dst_res = np.flatnonzero(~taken)
        assert len(dst_res) == int(h["res_cnt"].sum())
        rounds = []
        for d in np.unique(el_depth):
            if d == 0:
                continue
            m_d = el_depth == d
            rounds.append((int(d), jnp.asarray(src_cop[m_d].astype(idt)),
                           jnp.asarray(dst_cop[m_d].astype(idt))))
        # depth-0 copies gather from the tiled store; order by destination
        # so the scatter lowers as a sorted unique update
        m0 = el_depth == 0
        o0 = np.argsort(dst_cop[m0], kind="stable")
        return HubPlan(
            nodes=hub_nodes, hb_off=hb_off, node_is_hub=node_is_hub,
            hub_idx=hub_idx, seg_lane0=seg_lane0, seg_node=seg_node,
            seg_cnt=seg_cnt, hub_init=jnp.asarray(init_vals),
            src_res=jnp.asarray(src_res.astype(idt)),
            dst_res=jnp.asarray(dst_res.astype(idt)),
            src_cop0=jnp.asarray(src_cop[m0][o0].astype(idt)),
            dst_cop0=jnp.asarray(dst_cop[m0][o0].astype(idt)),
            cop_rounds=rounds, src_chunk=src_chunk, src_hub=src_hub,
            depth=depth,
        )

    # COLD: no list values exist yet.  Assign each element a static slot in
    # the per-hub [copies | intervals | residuals] unsorted layout; the
    # wavefront assembles values into slots and sorts by (hub, value) —
    # lists are strictly ascending so the sort IS the 3-way merge
    # (BVGraph.java:1062-1090) — and finalize_hub() then converts slots to
    # final merge positions via the fixpoint argsort.  Only COMPACT
    # per-pair/per-interval/per-segment bases are built here; the
    # per-element arrays (tens of millions at uk-2002 scale) expand on
    # device inside finalize_hub.
    copc = np.zeros(H, dtype=np.int64)
    np.add.at(copc, pair_node, pair_ln)
    intc = np.zeros(H, dtype=np.int64)
    np.add.at(intc, int_node, int_ln)

    def _seg_slot0(owner, lens):
        """Per-segment start slot within its hub (owners ascending)."""
        ex = np.cumsum(lens) - lens
        first = np.searchsorted(owner, np.arange(H))
        first = np.minimum(first, max(len(ex) - 1, 0))
        base0 = ex[first] if len(ex) else np.zeros(H, dtype=np.int64)
        return ex - base0[owner]

    slot0_pair = hb_off[pair_node] + _seg_slot0(pair_node, pair_ln)
    slot0_int = (hb_off[int_node] + copc[int_node]
                 + _seg_slot0(int_node, int_ln))
    seg_hub = hub_idx[seg_node]
    slot0_seg = (hb_off[seg_hub] + copc[seg_hub] + intc[seg_hub]
                 + _seg_slot0(seg_hub, np.asarray(seg_cnt, np.int64)))
    src0_seg = np.arange(len(seg_cnt), dtype=np.int64) * V

    cc = dict(M=M_hub, idt=idt,
              pair=(src0_pair, slot0_pair, np.asarray(pair_ln, np.int64),
                    pair_depth, pair_yhub),
              ints=(np.asarray(int_left, np.int64),
                    np.asarray(int_ln, np.int64), slot0_int),
              segs=(src0_seg, np.asarray(seg_cnt, np.int64), slot0_seg))
    return HubPlan(
        nodes=hub_nodes, hb_off=hb_off, node_is_hub=node_is_hub,
        hub_idx=hub_idx, seg_lane0=seg_lane0, seg_node=seg_node,
        seg_cnt=seg_cnt, hub_init=None,
        src_res=None, dst_res=None, src_cop0=None, dst_cop0=None,
        cop_rounds=None, src_chunk=src_chunk, src_hub=src_hub,
        depth=depth, finalized=False, cold_compact=cc,
    )


def _chain_depths(refs, bounds, maxref: int):
    """Per-node cold-decode correctness pass: node x's FINAL list is
    correct in the store after pass D[x] (D = 1 + number of chunk-boundary
    crossings on its reference chain; chains are <= max_ref_count hops,
    BVGraph.java:455).  Vectorized fixpoint in maxref rounds."""
    first = int(bounds[0])
    n_end = int(bounds[-1])
    cnt = (bounds[1:] - bounds[:-1]).astype(np.int64)
    cs = np.repeat(bounds[:-1], cnt)          # chunk start per node
    nn = n_end - first
    x = np.arange(first, n_end, dtype=np.int64)
    r = np.asarray(refs[first:n_end], dtype=np.int64)
    valid = r > 0
    src = x - r
    src_i = np.clip(src - first, 0, max(nn - 1, 0))
    cross = (src < cs).astype(np.int16)
    D = np.ones(nn, dtype=np.int16)
    for _ in range(max(maxref, 1)):
        D = np.where(valid, D[src_i] + cross, D).astype(np.int16)
    return D, first


def plan_kernel_decode(offsets: np.ndarray, outdegrees: np.ndarray,
                       settings, data: np.ndarray,
                       halo_csr: Optional[Tuple[np.ndarray, np.ndarray]]
                       = None,
                       refs: Optional[np.ndarray] = None,
                       target_arcs_per_lane: int = 128,
                       v_cap: int = 512, r_cap: int = 160,
                       bmax: int = 32, imax: int = 32,
                       node_base: int = 0, first_node: int = 0,
                       hub_device: bool = True,
                       ) -> Optional[PreparedDecode]:
    """Build the lane-chunk plan.  Returns None if the config/scale is
    outside the kernel's envelope (caller falls back).

    ``halo_csr``: (csr_off, succ) arrays giving every node's final list
    (warm path — e.g. right after an encode), used only to extract each
    chunk's predecessor lists.  When None the plan is COLD — built from
    the stream + offsets alone, the reference's load contract
    (BVGraph.java:1479-1574): references come from a native header-only
    scan and halo values resolve on device (``resolve_halos`` wavefront;
    run it before decoding, or use ``decode_full``/``decode_to_csr``
    which auto-resolve).
    ``refs``: per-node reference values (native bv_scan_refs); when
    given, only the predecessor lists a chunk ACTUALLY references are
    packed into its halo rows (typically 0-2 lists instead of W), which
    shrinks the column budget.

    Chunks that exceed the (v_cap, r_cap) envelope — dense hub regions —
    are split greedily into sub-chunks that fit (the adaptive analogue of
    the reference's arc-balanced task splitting,
    EliasFanoCumulativeOutdegreeList.java:139); only single nodes too big
    for any lane stay on the native host path."""
    offsets = np.asarray(offsets, dtype=np.int64)
    outd = np.asarray(outdegrees, dtype=np.int64)
    n = len(offsets) - 1
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd, out=cum[1:])
    arc_base = int(cum[first_node])
    m = int(cum[n]) - arc_base  # arcs actually chunked ([first_node, n))

    W = settings.window_size

    L = max(1024, min(1024 * 1024,
                      1 << int(np.ceil(np.log2(max(m, 1)
                                               / target_arcs_per_lane + 1)))))

    # cost-balanced chunk boundaries.  The kernel runs each tile's
    # while_loop until its SLOWEST lane finishes, and a lane's step count is
    # ~ its arcs (one emit per step) plus ~STATE_COST header states per
    # node — so balance the combined cost, not raw arcs (equal-arc chunking
    # hands sparse regions thousands of nodes per lane and the tile idles
    # 10x+ on them).  Arc-balancing analogue of
    # EliasFanoCumulativeOutdegreeList.java:139 with a step-cost model.
    STATE_COST = 5
    cumc = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outd + STATE_COST, out=cumc[1:])
    c0 = int(cumc[first_node])
    mc = int(cumc[n]) - c0
    targets = c0 + (mc * np.arange(1, L, dtype=np.int64)) // L
    bounds = np.empty(L + 1, dtype=np.int64)
    bounds[0] = first_node
    bounds[1:L] = np.searchsorted(cumc, targets, side="left")
    bounds[L] = n
    bounds = np.maximum.accumulate(bounds)

    starts = bounds[:L]
    ends = bounds[1:]
    # halo lists: every chunk needs the final lists of the predecessors it
    # references.  Warm path (halo_csr given, e.g. right after an encode):
    # values are packed into the init image up front.  COLD path (plan from
    # .graph/.offsets alone, the reference's load contract
    # BVGraph.java:1479-1574): no list is decoded on the host — per-node
    # reference values come from a native header-only scan, halo VALUES are
    # resolved by resolve_halos() wavefront passes of the kernel itself
    # (chains are <= max_ref_count hops, BVGraph.java:455, so
    # max_ref_count+1 passes reach a fixpoint), and hub merge positions are
    # derived from a device argsort at the fixpoint.
    cold = halo_csr is None
    hdr_bc = hdr_icnt = None
    from .. import native as _native
    if cold:
        if node_base:
            raise ValueError("sliced plans (node_base != 0) need an "
                             "explicit halo_csr")
        if not _native.available():
            return None
        hco = hsu = None
    else:
        hco, hsu = halo_csr
    if W > 0 and _native.available():
        hdr = _native.bv_scan_hdr(data, offsets[:n + 1], settings)
        if hdr is not None:
            sc_refs, hdr_bc, hdr_icnt = hdr
            if refs is None:
                refs = sc_refs
        elif cold and refs is None:
            refs = _native.bv_scan_refs(data, offsets[:n + 1], settings)
    if refs is not None:
        refs = np.asarray(refs)

    # scratch right-sizing + heavy-header routing.  Header counts are
    # heavy-tailed (cnr-2000: bc max 311 but only 0.07% of nodes above 16),
    # so the per-lane block/interval scratch is sized to cover all but
    # <=0.1% of nodes and the rare oversize nodes are routed
    # through the hub/preset-lane path as forced single-node chunks —
    # still device-decoded, no scratch needed (preset lanes skip header
    # states; hub assembly resolves blocks/intervals from the plan).
    heavy_mask = None
    if hdr_bc is not None and hub_device and node_base == 0:
        lim = max(64, n // 1000)

        def _qbucket(vals, cap, lo=4):
            b = lo
            while b < cap and int((vals > b).sum()) > lim:
                b *= 2
            return b

        bmax = _qbucket(hdr_bc, bmax)
        imax = _qbucket(hdr_icnt, imax)
        heavy = np.flatnonzero((hdr_bc > bmax) | (hdr_icnt > imax))
        heavy = heavy[heavy >= first_node]
        if len(heavy):
            heavy_mask = np.zeros(n, dtype=bool)
            heavy_mask[heavy] = True
            ins = np.unique(np.concatenate([heavy, heavy + 1]))
            nb = np.unique(np.concatenate([bounds, ins]))
            Lp = len(nb) - 1
            L = ((Lp + 1023) // 1024) * 1024
            bounds = np.full(L + 1, n, dtype=np.int64)
            bounds[0] = first_node
            bounds[1:Lp + 1] = nb[1:]
            starts = bounds[:L]
            ends = bounds[1:]

    # first pass: find envelope violators, split them adaptively
    _, _, nwords, need_v = _chunk_needs(starts, ends, offsets, cum, outd,
                                        refs, W, n)
    viol = np.flatnonzero((starts != ends)
                          & ((need_v > v_cap) | (nwords > r_cap - 2))
                          & (ends - starts > 1))
    if len(viol):
        pieces = []
        prev = 0
        for i in viol:
            pieces.append(bounds[prev + 1:i + 1])
            pieces.append(np.asarray(
                _split_chunk(int(bounds[i]), int(bounds[i + 1]), offsets,
                             cum, outd, refs, W, v_cap, r_cap),
                dtype=np.int64))
            prev = i + 1
        pieces.append(bounds[prev + 1:])
        ends_new = np.concatenate(pieces)
        Lp = len(ends_new)
        L = ((Lp + 1023) // 1024) * 1024
        bounds = np.full(L + 1, n, dtype=np.int64)
        bounds[0] = 0
        bounds[1:Lp + 1] = ends_new
        starts = bounds[:L]
        ends = bounds[1:]
    T = L // 1024

    empty = starts == ends
    needed, halo_arcs, nwords, need_v = _chunk_needs(
        starts, ends, offsets, cum, outd, refs, W, n)
    start_bits = offsets[starts]
    w0 = start_bits >> 5
    skipped = (~empty) & ((need_v > v_cap) | (nwords > r_cap - 2))
    if heavy_mask is not None:
        skipped = skipped | ((ends - starts == 1)
                             & heavy_mask[np.minimum(starts, n - 1)])
    active = (~empty) & ~skipped

    V = int(min(v_cap, need_v[active].max() if active.any() else 8))
    V = (V + 7) & ~7
    R = int(min(r_cap, (nwords[active].max() + 2) if active.any() else 2))

    # hub decomposition: single-node chunks outside the envelope decode on
    # device anyway — residual checkpoint segments as PRESET lanes + an
    # assembly pass (intervals/copies), instead of the host fill path
    hub_h = None
    seg_bits = seg_val = seg_cnt = seg_node = None
    seg_of_node = None
    hub_nodes = None
    hub_handled = np.zeros_like(skipped)
    if hub_device and node_base == 0 and skipped.any():
        from .. import native as _native
        single = skipped & (ends - starts == 1)
        if single.any() and _native.available():
            hub_nodes = np.sort(starts[single])
            arc_q = max(16, min(target_arcs_per_lane, v_cap))
            bit_q = 32 * (r_cap - 2) - 256
            try:
                hub_h = _parse_hubs(data, settings, hub_nodes, offsets,
                                    outd, arc_q, bit_q)
            except Exception:
                hub_h = None
            if hub_h is not None:
                cps = hub_h["cps"]
                seg_bits = cps[:, 0]
                seg_val = cps[:, 1]
                seg_cnt = cps[:, 2]
                seg_node = np.repeat(hub_nodes, hub_h["cp_cnt"])
                cpc = np.concatenate([[0], np.cumsum(hub_h["cp_cnt"])])
                seg_of_node = [range(int(cpc[i]), int(cpc[i + 1]))
                               for i in range(len(hub_nodes))]
                if len(seg_cnt):
                    V = max(V, (int(seg_cnt.max()) + 7) & ~7)
                hub_handled = single.copy()
    if seg_node is not None and len(seg_node):
        # per-segment word spans (next checkpoint / end of entry)
        seg_end = np.concatenate([seg_bits[1:], [0]])
        last_idx = np.cumsum(hub_h["cp_cnt"])[hub_h["cp_cnt"] > 0] - 1
        seg_end[last_idx] = offsets[
            hub_nodes[hub_h["cp_cnt"] > 0] + 1]
        seg_w0 = seg_bits >> 5
        seg_nw = np.maximum((seg_end + 31) // 32 - seg_w0, 0)
        R = int(min(r_cap, max(R, int(seg_nw.max()) + 1)))
    P = len(seg_node) if seg_node is not None else 0
    L_tot = L + ((P + 1023) // 1024) * 1024 if P else L
    T = L_tot // 1024

    spec = KernelSpec(
        window_size=W,
        min_interval_length=settings.min_interval_length,
        zeta_k=settings.zeta_k,
        outdegree_coding=settings.outdegree_coding,
        reference_coding=settings.reference_coding,
        block_count_coding=settings.block_count_coding,
        block_coding=settings.block_coding,
        residual_coding=settings.residual_coding,
        R=R, V=V, T=T, BMAX=bmax, IMAX=imax,
        # every step emits an arc or consumes >= 1 stream bit, so this
        # bounds any lane's steps (a corrupt stream errors out first)
        max_steps=V + 32 * R + 64,
    )
    if not spec.supported():
        return None
    if node_base + n >= (1 << 31):
        # int32 value lanes cap the device path at 2^31 node ids; bigger
        # graphs decode through the native streaming path (iter_csr_slices)
        return None

    # stream words, 32-bit big-endian packed.  All packing below is
    # vectorized over lanes (a Python per-lane loop is minutes at uk-2002
    # scale: L reaches 2^20 lanes), and only COMPACT arrays are shipped to
    # the device — the stream words once, per-lane word ranges, the per-lane
    # meta rows, and the sparse halo values; the dense lane columns
    # ((L, R) stream columns and the (L, V) output-column image) are
    # expanded on device by _stage_device (the dense arrays are ~8x bigger
    # than their compact sources).
    words = pack_words_u32(data)
    nw_act = np.where(active, nwords, 0).astype(np.int32)
    CYC = W + 1
    NMETA = 6 + 2 * CYC
    meta = np.zeros((L_tot, NMETA), dtype=np.int32)
    meta[:L, 0] = np.where(active, ends - starts, 0)
    meta[:L, 1] = (start_bits - (w0 << 5)).astype(np.int32)
    meta[:L, 2] = (starts + node_base).astype(np.int32)  # global x
    meta[:L, 3] = np.where(active, halo_arcs, 0).astype(np.int32)
    w0_all = np.zeros(L_tot, dtype=np.int64)
    w0_all[:L] = w0
    nw_all = np.zeros(L_tot, dtype=np.int32)
    nw_all[:L] = nw_act
    if P:
        sl = slice(L, L + P)
        w0_all[sl] = seg_w0
        nw_all[sl] = seg_nw.astype(np.int32)
        meta[sl, 0] = 1
        meta[sl, 1] = (seg_bits - (seg_w0 << 5)).astype(np.int32)
        meta[sl, 2] = seg_node.astype(np.int32)
        meta[sl, 4 + 2 * CYC] = seg_cnt.astype(np.int32)
        meta[sl, 5 + 2 * CYC] = seg_val.astype(np.int32)
    hdst = np.zeros(0, dtype=np.int64)
    hval = np.zeros(0, dtype=np.int32)
    wf_dst = np.zeros(0, dtype=np.int64)   # cold: wavefront-resolved halo
    wf_src = np.zeros(0, dtype=np.int64)   # lane-major src in the store
    wf_nodes = np.zeros(0, dtype=np.int64)
    wf_cnt = np.zeros(0, dtype=np.int64)
    wf_chunk = np.zeros(0, dtype=np.int64)
    if W > 0:
        lanes_i = np.arange(L, dtype=np.int64)
        # per-(lane, j) predecessor y = start-1-j; packed rows accumulate in
        # ascending-y order (j = W-1 .. 0)
        ys = starts[:, None] - 1 - np.arange(W, dtype=np.int64)[None, :]
        in_rng = active[:, None] & (ys >= 0)
        ysc = np.clip(ys, 0, max(n - 1, 0))
        dy = np.where(needed[:, :W] & in_rng, outd[ysc], 0)
        # h[i, j] = sum of dy over j' > j (ascending-y exclusive prefix)
        h = np.cumsum(dy[:, ::-1], axis=1)[:, ::-1] - dy
        # window slots are keyed by GLOBAL node id (the kernel computes
        # (x - ref) % CYC with x = starts + node_base): local keying
        # desyncs sliced plans whose node_base % CYC != 0
        slot = ((ysc + node_base) % CYC).astype(np.int64)
        for j in range(W):
            v = in_rng[:, j]
            # outdegree preload for every in-range window slot (parses need
            # ref_len); list values packed only when actually referenced
            meta[lanes_i[v], 4 + slot[v, j]] = outd[ysc[v, j]]
            pk = v & needed[:, j]
            meta[lanes_i[pk], 4 + CYC + slot[pk, j]] = h[pk, j]
        # ragged halo-list values: flat destinations i*V + h + k
        pk = needed[:, :W] & in_rng
        cnt = dy[pk]
        if cnt.size and cnt.sum():
            dst0 = (np.repeat(lanes_i[:, None], W, axis=1)[pk] * V + h[pk])
            ys_sel = ysc[pk]
            if not cold:
                within = (np.arange(int(cnt.sum()), dtype=np.int64)
                          - np.repeat(np.cumsum(cnt) - cnt, cnt))
                hdst = np.repeat(dst0, cnt) + within
                src0 = hco[ys_sel]
                hval = hsu[np.repeat(src0, cnt) + within].astype(np.int32)
            else:
                # cold: each halo element's VALUE lives in the store itself
                # (pred y's list inside y's own chunk column) — recorded as
                # a COMPACT per-list (dst, src, cnt) triple; the element
                # expansion runs on device in resolve_halos (host repeats
                # over tens of millions of halo arcs cost seconds).  Preds
                # in non-device chunks (skipped singles: hubs by bit size,
                # not arcs — arc-hubs force the referencing chunk itself to
                # skip) are host-decoded here, a bounded chain-chase per
                # node (BVGraph.java:455).
                c_y = np.searchsorted(bounds, ys_sel, side="right") - 1
                # preds before the first chunked node (sharded plans with
                # first_node > 0) have no device source: host-static
                act_y = (c_y >= 0) & active[np.maximum(c_y, 0)] \
                    & (ys_sel >= bounds[0])
                src_lm = (c_y * np.int64(V) + halo_arcs[c_y]
                          + (cum[ys_sel] - cum[starts[c_y]]))
                wf_dst = dst0[act_y]       # per-LIST lane-major bases
                wf_src = src_lm[act_y]
                wf_nodes = ys_sel[act_y]
                wf_cnt = cnt[act_y]
                wf_chunk = c_y[act_y]
                if not act_y.all():
                    ina = ~act_y
                    sval = _host_pred_values(ys_sel[ina], cnt[ina],
                                             data, settings, offsets, outd,
                                             cum)
                    hval = sval.astype(np.int32)
                    ci = cnt[ina]
                    within = (np.arange(int(ci.sum()), dtype=np.int64)
                              - np.repeat(np.cumsum(ci) - ci, ci))
                    hdst = np.repeat(dst0[ina], ci) + within
    wf_depth = None
    node_depth_max = 0
    if cold and refs is not None and len(wf_nodes):
        D, d_first = _chain_depths(refs, bounds, settings.max_ref_count)
        wf_depth = D[np.clip(wf_nodes - d_first, 0, max(len(D) - 1, 0))
                     ].astype(np.int16)
        node_depth_max = int(D.max(initial=1))

    # halo image: scatter the sparse halo values straight into the kernel's
    # tiled (T, V//8, 8, 8, 128) layout (row-major (T, V, 1024): tile, row,
    # lane).  The tiled flat index is computed on host.
    def _to4(flat):
        lane_i = flat // V
        row_i = flat - lane_i * V
        return ((lane_i >> 10) * (V * 1024) + (row_i >> 3) * 8192
                + (row_i & 7) * 1024 + (lane_i & 1023))

    hdst4 = _to4(hdst)
    init4 = _stage_init(jnp.asarray(hdst4), jnp.asarray(hval), T=T, V=V)
    meta4, col4 = _stage_device(
        jnp.asarray(words.view(np.int32)),
        jnp.asarray(w0_all.astype(np.int32)),
        jnp.asarray(nw_all), jnp.asarray(meta),
        T=T, R=R, V=V, NMETA=NMETA)

    # per-lane expectations (check_diag) + the hub assembly plan
    exp_arcs = np.zeros(T * 1024, dtype=np.int64)
    exp_nodes = np.zeros(T * 1024, dtype=np.int64)
    live = active
    exp_arcs[:L] = np.where(live, cum[ends] - cum[starts] + halo_arcs, 0)
    exp_nodes[:L] = np.where(live, ends - starts, 0)
    hub = None
    if P:
        exp_arcs[L:L + P] = seg_cnt
        exp_nodes[L:L + P] = 1
        hub = _plan_hub_assembly(
            hub_h, hub_nodes, hco, hsu, outd, cum, bounds, halo_arcs,
            n, V, L, seg_node, seg_cnt, seg_of_node)
        skipped = skipped & ~hub_handled

    prep = PreparedDecode(
        spec=spec, meta=meta4, col=col4, init_out=init4, n=n, m=m,
        chunk_starts=bounds, halo_arcs=halo_arcs, cum_arcs=cum,
        outdegrees=outd, skipped=skipped, offsets=offsets,
        node_base=node_base, arc_base=arc_base, hub=hub,
        exp_arcs=exp_arcs, exp_nodes=exp_nodes,
        cold=cold, resolved=not (cold and (len(wf_dst) or hub is not None)),
        wf_dst0=wf_dst, wf_src0=wf_src,
        wf_nodes=wf_nodes, wf_cnt=wf_cnt, wf_chunk=wf_chunk,
        wf_depth=wf_depth, node_depth_max=node_depth_max,
        _data=data, _settings=settings)
    return prep


@functools.partial(jax.jit, static_argnames=("T", "V"))
def _stage_init(hdst4, hval, *, T, V):
    """Halo-initialized output image, built by one flat scatter into the
    final (T, V//8, 8, 8, 128) layout."""
    return (jnp.zeros((T * V * 1024,), jnp.int32).at[hdst4].set(hval)
            .reshape(T, V // 8, 8, 8, 128))


@functools.partial(jax.jit, static_argnames=("T", "R", "V", "NMETA"))
def _stage_device(words, w0, nw, meta, *, T, R, V, NMETA):
    """Expand compact plan inputs into the kernel's tiled lane arrays
    (stream columns + meta tiles).

    Tiles are staged one at a time under lax.map: per-tile intermediates
    are ~1 MB, so the outputs alone bound the footprint."""
    nwords_tot = words.shape[0]

    def tile(t):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, t * 1024, 1024)  # noqa: E731
        widx = sl(w0)[:, None] + jnp.arange(R, dtype=jnp.int32)[None, :]
        mask = jnp.arange(R, dtype=jnp.int32)[None, :] < sl(nw)[:, None]
        col = jnp.where(mask,
                        words[jnp.clip(widx, 0, max(nwords_tot - 1, 0))]
                        if nwords_tot else jnp.zeros((), jnp.int32), 0)
        meta_t = sl(meta).T.reshape(NMETA, 8, 128)
        col_t = col.T.reshape(R, 8, 128)
        return meta_t, col_t

    return jax.lax.map(tile, jnp.arange(T, dtype=jnp.int32))


def _host_pred_values(ys, cnts, data, settings, offsets, outd, cum):
    """Host-decode the successor lists of the given predecessor nodes
    (bounded chain-chase: decode from p = y - W*max_ref_count, the chain
    bound BVGraph.java:455) and expand them to the flat per-request element
    array.  Used only for halo predecessors that do not decode on device
    (skipped single-node chunks)."""
    import os as _os

    from .. import native as _native

    ys = np.asarray(ys, dtype=np.int64)
    cnts = np.asarray(cnts, dtype=np.int64)
    uy, inv = np.unique(ys, return_inverse=True)
    W = settings.window_size
    maxref = getattr(settings, "max_ref_count", 3)
    halo_n = W * max(int(maxref), 1) if W > 0 else 0
    p = np.maximum(uy - halo_n, 0)
    init = np.zeros((len(uy), max(W, 1)), dtype=np.int64)
    if W > 0:
        yj = p[:, None] - 1 - np.arange(W, dtype=np.int64)[None, :]
        ok = yj >= 0
        init[ok] = outd[yj[ok]]
    d = outd[uy]
    uo = np.zeros(len(uy) + 1, dtype=np.int64)
    np.cumsum(d, out=uo[1:])
    succ = np.empty(max(int(uo[-1]), 1), dtype=np.int64)
    dpad = np.concatenate([np.ascontiguousarray(data, dtype=np.uint8),
                           np.zeros(16, dtype=np.uint8)])
    _native.bv_fill_ranges(dpad, settings, p, uy, uy + 1,
                           np.asarray(offsets)[p], init, uo[:-1], d, succ,
                           threads=_os.cpu_count() or 1, padded=True)
    within = (np.arange(int(cnts.sum()), dtype=np.int64)
              - np.repeat(np.cumsum(cnts) - cnts, cnts))
    return succ[np.repeat(uo[inv], cnts) + within]


def _to4_np(flat, V):
    """Lane-major flat index -> tiled (T, V//8, 8, 8, 128) flat index."""
    lane = flat // V
    row = flat - lane * V
    return ((lane >> 10) * (V * 1024) + (row >> 3) * 8192
            + (row & 7) * 1024 + (lane & 1023))


@functools.partial(jax.jit, static_argnames=("total", "V"))
def _expand_to4(base, cnt_cum, total: int, V: int):
    """Expand per-segment lane-major bases to per-element tiled-flat
    indices on device (repeat + within + tiling math)."""
    flat = _expand_device(base, cnt_cum, total)
    lane = flat // V
    row = flat - lane * V
    return ((lane >> 10) * (V * 1024) + (row >> 3) * 8192
            + ((row & 7) << 10) + (lane & 1023))


@jax.jit
def _wf_extract(out_cols, src4):
    return jnp.take(out_cols.reshape(-1), src4, mode="clip")


@jax.jit
def _wf_init(base_init, dst4, halo_vals):
    shape = base_init.shape
    return (base_init.reshape(-1).at[dst4].set(halo_vals, mode="drop")
            .reshape(shape))


@functools.partial(jax.jit, static_argnames=("total_b", "V"))
def _expand4_dev(dst0, src0, ccum, e_real, total_b: int, V: int):
    """Bucket-padded element expansion: shapes are pow2 buckets so every
    resolve pass (and every graph of similar scale) reuses ONE compiled
    program — per-subset shapes cost a ~10 s remote compile each.
    Elements past e_real get an out-of-range destination (scatter mode
    "drop")."""
    d = _expand_to4(dst0, ccum, total_b, V)
    s = _expand_to4(src0, ccum, total_b, V)
    pad = jnp.arange(total_b, dtype=jnp.int32) >= e_real
    return jnp.where(pad, jnp.int32(1 << 30), d), jnp.where(pad, 0, s)


@functools.partial(jax.jit, donate_argnums=(0,))
def _wf_init_inplace(base_init, dst4, halo_vals):
    """Donating variant for the incremental depth-path updates (callers
    always rebind prep.init_out; avoids a multi-GB copy per pass)."""
    shape = base_init.shape
    return (base_init.reshape(-1).at[dst4].set(halo_vals, mode="drop")
            .reshape(shape))


def _sort2(ordk, vals, payload=None):
    """Lexicographic (hub-ordinal, value) device sort without 64-bit keys
    (x64 is off); returns sorted vals (+ permuted payload)."""
    ops = (ordk, vals) if payload is None else (ordk, vals, payload)
    out = jax.lax.sort(ops, num_keys=2)
    return out[1] if payload is None else (out[1], out[2])


@functools.partial(jax.jit, static_argnames=("n_rounds", "Lt"))
def _hub_unsorted(out_cols, init_unsorted, src_res, slot_res, src0, slot0,
                  ord_rep, round_srcs, round_slots, n_rounds: int, Lt: int):
    """Assemble hub component values into their UNSORTED static slots
    ([copies | intervals | residuals] per hub) from the store; used by the
    cold-plan finalize.  Hub->hub copy rounds re-sort between depths (the
    source positions index the source hub's final ascending list)."""
    V8 = out_cols.shape[1]
    V = V8 * 8
    un = init_unsorted
    if src_res.size:
        def untile(tile):
            return jnp.transpose(tile.reshape(V8, 8, 1024),
                                 (2, 0, 1)).reshape(1024, V)

        lm = jax.lax.map(untile, out_cols[Lt:]).reshape(-1)
        un = un.at[slot_res].set(jnp.take(lm, src_res, mode="clip"),
                                 mode="drop", indices_are_sorted=True,
                                 unique_indices=True)
    if src0.size:
        un = un.at[slot0].set(jnp.take(out_cols.reshape(-1), src0,
                                       mode="clip"),
                              mode="drop", indices_are_sorted=True,
                              unique_indices=True)
    for r in range(n_rounds):
        sv = _sort2(ord_rep, un)
        un = un.at[round_slots[r]].set(
            jnp.take(sv, round_srcs[r], mode="clip"), mode="drop",
            indices_are_sorted=True, unique_indices=True)
    return un


@jax.jit
def _order_of(ord_rep, un):
    """order[k] = unsorted slot of the k-th final merge position."""
    M = un.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    _, order = _sort2(ord_rep, un, idx)
    return order


@functools.partial(jax.jit, static_argnames=("sizes",))
def _component_pairs(order, slots, srcs, sizes):
    """Per-component sorted (dst, src) pairs from ONE sort.

    Each unsorted slot belongs to exactly one component ([copies |
    intervals | residuals] static layout); tagging slots and gathering
    the tags through ``order`` turns every per-component argsort of the
    old finalize (3-4 argsorts of ~M keys, the measured bulk of
    finalize_hub) into a masked extraction.  ``sizes`` are pow2-bucketed
    counts: padded entries get dst = M and drop in the consumers'
    scatters."""
    M = order.shape[0]
    tag = jnp.zeros((M,), jnp.int32)
    sv = jnp.zeros((M,), jnp.int32)
    for c, (sl, sr) in enumerate(zip(slots, srcs)):
        tag = tag.at[sl].set(c + 1, mode="drop", indices_are_sorted=True,
                             unique_indices=True)
        sv = sv.at[sl].set(sr, mode="drop", indices_are_sorted=True,
                           unique_indices=True)
    tag_s = jnp.take(tag, order)
    src_s = jnp.take(sv, order)
    outs = []
    for c, kpad in enumerate(sizes):
        idx = jnp.nonzero(tag_s == c + 1, size=kpad,
                          fill_value=M)[0].astype(jnp.int32)
        sc = jnp.take(src_s, jnp.minimum(idx, M - 1))
        outs.append((idx, sc))
    return outs


def finalize_hub(prep: PreparedDecode, out_cols) -> None:
    """Cold-plan hub finalization at the wavefront fixpoint: expand the
    compact component bases to per-element device arrays, assemble the
    unsorted values from the store, derive the final merge positions from
    a device argsort, then rewrite the plan to the static-destination form
    the timed assembly uses (assemble_hubs)."""
    hub = prep.hub
    if hub is None or hub.finalized:
        return
    cc = hub.cold_compact
    V = prep.spec.V
    M = int(cc["M"])
    if cc["idt"] is not np.int32 and cc["idt"] != np.int32:
        raise RuntimeError("cold hub finalize needs int32 index domain; "
                           "slice the graph (ops/bigdecode) instead")

    def _ccum(cnt):
        c = np.zeros(len(cnt) + 1, dtype=np.int32)
        np.cumsum(cnt, out=c[1:])
        return c

    def exp(base, cnt):
        c = _ccum(cnt)
        return _expand_device(jnp.asarray(base.astype(np.int32)),
                              jnp.asarray(c), total=int(c[-1]))

    src0_pair, slot0_pair, pair_ln, pair_depth, pair_yhub = cc["pair"]
    m0 = pair_depth == 0
    c0 = _ccum(pair_ln[m0])
    src_cop0 = _expand_to4(jnp.asarray(src0_pair[m0].astype(np.int32)),
                           jnp.asarray(c0), total=int(c0[-1]), V=V)
    slot_cop0 = exp(slot0_pair[m0], pair_ln[m0])
    rounds = []
    for d in np.unique(pair_depth[pair_depth > 0]):
        sel = pair_depth == d
        rounds.append((int(d), exp(src0_pair[sel], pair_ln[sel]),
                       exp(slot0_pair[sel], pair_ln[sel])))
    int_left, int_ln, slot0_int = cc["ints"]
    int_vals = exp(int_left, int_ln)
    int_slots = exp(slot0_int, int_ln)
    src0_seg, seg_cnt, slot0_seg = cc["segs"]
    src_res = exp(src0_seg, seg_cnt)
    slot_res = exp(slot0_seg, seg_cnt)
    ord_rep = _repeat_device(
        jnp.arange(len(hub.nodes), dtype=jnp.int32),
        jnp.asarray(hub.hb_off.astype(np.int32)), total=M)
    init_unsorted = (jnp.zeros((M,), jnp.int32)
                     .at[int_slots].set(int_vals, mode="drop",
                                        indices_are_sorted=True,
                                        unique_indices=True))

    rs = tuple(s for _, s, _ in rounds)
    rt = tuple(t for _, _, t in rounds)
    un = _hub_unsorted(jnp.asarray(out_cols), init_unsorted, src_res,
                       slot_res, src_cop0, slot_cop0,
                       ord_rep, rs, rt, n_rounds=len(rs),
                       Lt=hub.seg_lane0 // 1024)
    order = _order_of(ord_rep, un)       # the ONE finalize sort

    def _bucket(k):
        return 1 << max(int(np.ceil(np.log2(max(k, 1)))), 4)

    n_int = int(int_ln.sum())
    comp_slots = (slot_res, slot_cop0, int_slots) \
        + tuple(slot for _, _, slot in rounds)
    comp_srcs = (src_res, src_cop0,
                 jnp.arange(n_int, dtype=jnp.int32)) \
        + tuple(src for _, src, _ in rounds)
    sizes = tuple(_bucket(int(s.shape[0])) for s in comp_srcs)
    pairs = _component_pairs(order, comp_slots, comp_srcs, sizes=sizes)
    (hub.dst_res, hub.src_res), (hub.dst_cop0, hub.src_cop0), \
        (dst_int, src_int) = pairs[0], pairs[1], pairs[2]
    hub.cop_rounds = [(d, p[1], p[0])
                      for (d, _, _), p in zip(rounds, pairs[3:])]
    iv_safe = int_vals if n_int else jnp.zeros((1,), jnp.int32)
    int_vals_s = jnp.take(iv_safe, jnp.minimum(src_int,
                                               max(n_int - 1, 0)))
    hub.hub_init = (jnp.zeros((M,), jnp.int32)
                    .at[dst_int].set(int_vals_s, mode="drop",
                                     indices_are_sorted=True,
                                     unique_indices=True))

    # composed source map: every FINAL hub position's ultimate source as a
    # lane-major store position (residual segments live in preset lanes of
    # the store; depth-d copies resolve transitively through the static
    # maps) or, for interval values, an index past the store into the
    # static interval-value table.  Lets the CSR assembly fetch hub arcs
    # in the SAME single gather as everything else — no per-decode hub
    # assembly pass.
    Ltot_v = prep.spec.T * 1024 * V
    src_res_lm = exp(src0_seg + np.int64(hub.seg_lane0) * V, seg_cnt)
    src_cop0_lm = _expand_device(
        jnp.asarray(src0_pair[m0].astype(np.int32)), jnp.asarray(c0),
        total=int(c0[-1]))
    sfv = jnp.zeros((M,), jnp.int32)
    sfv = sfv.at[slot_res].set(src_res_lm)
    sfv = sfv.at[slot_cop0].set(src_cop0_lm)
    sfv = sfv.at[int_slots].set(
        Ltot_v + jnp.arange(n_int, dtype=jnp.int32))
    sf = jnp.take(sfv, order)            # slot space -> rank space
    for _, src2, dst in hub.cop_rounds:
        sf = sf.at[dst].set(jnp.take(sf, jnp.minimum(src2, M - 1)),
                            mode="drop")
    hub.src_final = sf
    hub.int_table = int_vals
    hub.finalized = True


def resolve_halos(prep: PreparedDecode, data=None, settings=None,
                  interpret: Optional[bool] = None,
                  max_passes: Optional[int] = None) -> int:
    """Cold-plan halo resolution: wavefront passes of the kernel itself.

    Pass k decodes with the current halo image and re-extracts every halo
    list from the store; a node whose reference chain crosses <= k-1 chunk
    boundaries is correct after pass k (chains are <= max_ref_count hops,
    BVGraph.java:455/:2258, and outdegrees — hence all copy-block
    STRUCTURE — are known up front, so wrong halo values never desync the
    stream, they only propagate wrong list values).  max_ref_count + 1
    passes therefore reach the fixpoint; convergence usually stops earlier
    (halo equality between passes).  Finishes by deriving the hub merge
    positions (finalize_hub).  Returns the number of kernel passes run."""
    if not prep.cold or prep.resolved:
        return 0
    data = prep._data if data is None else data
    settings = prep._settings if settings is None else settings
    maxref = int(getattr(settings, "max_ref_count", 3) or 3)
    if max_passes is None:
        max_passes = maxref + 1

    V = prep.spec.V

    def _expand4(dst0, src0, cnt):
        """Per-list lane-major bases -> per-element tiled-flat device
        index pair, bucket-padded to pow2 shapes (one compiled program
        per bucket instead of one per data-dependent subset shape)."""
        ccum = np.zeros(len(cnt) + 1, dtype=np.int32)
        np.cumsum(cnt, out=ccum[1:])
        total = int(ccum[-1])
        S_b = 1 << max(int(np.ceil(np.log2(max(len(cnt), 1)))), 6)
        E_b = 1 << max(int(np.ceil(np.log2(max(total, 1)))), 10)
        dst_p = np.zeros(S_b, np.int32)
        dst_p[:len(dst0)] = dst0
        src_p = np.zeros(S_b, np.int32)
        src_p[:len(src0)] = src0
        ccum_p = np.full(S_b + 1, total, dtype=np.int32)
        ccum_p[:len(ccum)] = ccum
        return _expand4_dev(jnp.asarray(dst_p), jnp.asarray(src_p),
                            jnp.asarray(ccum_p),
                            jnp.asarray(np.int32(total)),
                            total_b=E_b, V=V)

    have_wf = prep.wf_dst0 is not None and len(prep.wf_dst0) > 0
    base_init = prep.init_out
    use_depth = (have_wf and prep.wf_depth is not None
                 and len(prep.wf_depth) == len(prep.wf_dst0))
    if have_wf and not use_depth:
        dst4, src4 = _expand4(prep.wf_dst0, prep.wf_src0, prep.wf_cnt)
    prev = None
    passes = 0
    o = None
    if use_depth:
        # per-element convergence: list values become correct at pass =
        # their chain depth; each list is extracted exactly ONCE, at that
        # pass (instead of re-extracting everything every pass), and the
        # pass count is the actual max depth, not max_ref_count + 1
        maxD = int(prep.wf_depth.max(initial=1))
        need_final = prep.hub is not None and not prep.hub.finalized
        for k in range(1, min(maxD, max_passes) + 1):
            o, dg = decode_chunked(prep, interpret=interpret)
            jax.block_until_ready(o)
            passes += 1
            if passes == 1:
                errs = check_diag(prep, np.asarray(dg))
                if (errs != 0).any() and prep.wf_chunk is not None:
                    bad = errs[prep.wf_chunk] != 0
                    if bad.any():
                        vals = _host_pred_values(
                            prep.wf_nodes[bad], prep.wf_cnt[bad], data,
                            settings, prep.offsets, prep.outdegrees,
                            prep.cum_arcs)
                        ci = prep.wf_cnt[bad]
                        within = (np.arange(int(ci.sum()), dtype=np.int64)
                                  - np.repeat(np.cumsum(ci) - ci, ci))
                        bad_el = np.repeat(prep.wf_dst0[bad], ci) + within
                        prep.init_out = _wf_init_inplace(
                            prep.init_out, jnp.asarray(_to4_np(bad_el, V)),
                            jnp.asarray(vals.astype(np.int32)))
                        keep = ~bad
                        for f in ("wf_dst0", "wf_src0", "wf_nodes",
                                  "wf_cnt", "wf_chunk", "wf_depth"):
                            setattr(prep, f, getattr(prep, f)[keep])
            sel = np.flatnonzero(prep.wf_depth == k)
            if len(sel):
                d4, s4 = _expand4(prep.wf_dst0[sel], prep.wf_src0[sel],
                                  prep.wf_cnt[sel])
                prep.init_out = _wf_init_inplace(prep.init_out, d4,
                                                 _wf_extract(o, s4))
                jax.block_until_ready(prep.init_out)
        if need_final:
            # one decode with the fully-correct init: the store is then
            # correct for EVERY node, which hub finalize requires
            o, dg = decode_chunked(prep, interpret=interpret)
            jax.block_until_ready(o)
            passes += 1
        if prep.hub is not None and not prep.hub.finalized:
            finalize_hub(prep, o)
        prep.resolved = True
        return passes
    for _ in range(max_passes):
        o, dg = decode_chunked(prep, interpret=interpret)
        passes += 1
        if passes == 1 and have_wf:
            # error-flagged lanes cannot serve as halo sources (their
            # store rows are garbage): patch those predecessors from the
            # host decoder.  Errors are structural (stream-dependent, not
            # halo-dependent), so one check suffices.
            errs = check_diag(prep, np.asarray(dg))
            if (errs != 0).any() and prep.wf_chunk is not None:
                bad = errs[prep.wf_chunk] != 0
                if bad.any():
                    vals = _host_pred_values(
                        prep.wf_nodes[bad], prep.wf_cnt[bad], data,
                        settings, prep.offsets, prep.outdegrees,
                        prep.cum_arcs)
                    ci = prep.wf_cnt[bad]
                    within = (np.arange(int(ci.sum()), dtype=np.int64)
                              - np.repeat(np.cumsum(ci) - ci, ci))
                    bad_el = np.repeat(prep.wf_dst0[bad], ci) + within
                    base_init = _wf_init(
                        base_init, jnp.asarray(_to4_np(bad_el, V)),
                        jnp.asarray(vals.astype(np.int32)))
                    keep = ~bad
                    prep.wf_dst0 = prep.wf_dst0[keep]
                    prep.wf_src0 = prep.wf_src0[keep]
                    prep.wf_nodes = prep.wf_nodes[keep]
                    prep.wf_cnt = prep.wf_cnt[keep]
                    prep.wf_chunk = prep.wf_chunk[keep]
                    have_wf = len(prep.wf_dst0) > 0
                    if have_wf:
                        dst4, src4 = _expand4(prep.wf_dst0, prep.wf_src0,
                                              prep.wf_cnt)
                    prep.init_out = base_init
                    if not have_wf:
                        continue
        if not have_wf:
            break
        halo = _wf_extract(o, src4)
        if prev is not None and bool(jnp.array_equal(halo, prev)):
            break
        prep.init_out = _wf_init(base_init, dst4, halo)
        prev = halo
    if prep.hub is not None and not prep.hub.finalized:
        finalize_hub(prep, o)
    prep.resolved = True
    return passes


def decode_chunked(prep: PreparedDecode, interpret: Optional[bool] = None):
    """Run the kernel over all tiles (one launch).  Returns (out_cols, diag)
    device arrays: out_cols (T, V//8, 8, 8, 128) int32, diag (T, DIAG_ROWS,
    8, 128)."""
    if interpret is None:
        interpret = kernel_mode()
    return run_tiles(prep.meta, prep.col, prep.init_out, prep.spec,
                     interpret)


def chunked_to_csr(prep: PreparedDecode, out_cols,
                   data: Optional[np.ndarray] = None,
                   settings=None,
                   errs: Optional[np.ndarray] = None,
                   hub_vals=None) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble the flat CSR (host-side; used by tests and the API).

    Hub nodes splice in from the device assembly (``hub_vals`` or computed
    here); skipped lanes (outside the column envelope) and error-flagged
    lanes (scratch overflow on extreme nodes) are filled by the native
    host range decoder when ``data``/``settings`` are given."""
    if prep.cold and not prep.resolved:
        raise RuntimeError("cold plan not resolved: run resolve_halos() "
                           "(or use decode_full) before assembling CSR")
    T, V = prep.spec.T, prep.spec.V
    nc = prep.n_chunk_lanes
    cols = np.asarray(out_cols)[:T].reshape(T, V // 8, 8, 1024)
    cols = cols.transpose(0, 3, 1, 2).reshape(T * 1024 * V)
    bad = prep.skipped.copy()
    if errs is not None:
        bad |= errs[:nc] != 0
    # vectorized ragged gather: arc k of chunk i lives at flat position
    # i*V + halo_i + (k - cum[start_i])
    cum = prep.cum_arcs
    starts, ends = prep.chunk_starts[:-1], prep.chunk_starts[1:]
    arcs = cum[ends] - cum[starts]
    base = (np.arange(nc, dtype=np.int64) * V + prep.halo_arcs
            - (cum[starts] - prep.arc_base))
    idx = np.repeat(base, arcs) + np.arange(prep.m, dtype=np.int64)
    # skipped/hub lanes can have halo+arcs > V: their flat indices spill
    # past the lane column (or the array end, for lanes near the tail) —
    # clip; the splice/fill below rewrites every such range anyway
    if bad.any() or prep.hub is not None:
        np.minimum(idx, cols.size - 1, out=idx)
    succ = cols[idx].astype(np.int64)
    hub = prep.hub
    fb = np.zeros(0, dtype=np.int64)
    if hub is not None:
        hv = (np.asarray(hub_vals) if hub_vals is not None
              else np.asarray(assemble_hubs(prep, out_cols)))
        fb = (hub_fallback_nodes(prep, errs) if errs is not None
              else np.zeros(0, dtype=np.int64))
        ok = ~np.isin(hub.nodes, fb)
        hn = hub.nodes[ok]
        cnt = (hub.hb_off[1:] - hub.hb_off[:-1])[ok]
        if cnt.sum():
            within = (np.arange(int(cnt.sum()), dtype=np.int64)
                      - np.repeat(np.cumsum(cnt) - cnt, cnt))
            dst = np.repeat(cum[hn] - prep.arc_base, cnt) + within
            src = np.repeat(hub.hb_off[:-1][ok], cnt) + within
            succ[dst] = hv[src]
    if bad.any() or len(fb):
        if data is None or settings is None:
            raise ValueError("skipped/error lanes need data/settings for "
                             "the native fallback")
        fill_lanes(prep, bad, succ, data, settings, hub_nodes=fb)
    first = int(prep.chunk_starts[0])
    return cum[first:] - prep.arc_base, succ


def fill_lanes(prep: PreparedDecode, lanes_mask: np.ndarray,
               succ: np.ndarray, data: np.ndarray, settings,
               offsets=None, threads: int = 0,
               hub_nodes: Optional[np.ndarray] = None) -> None:
    """Native host decode of the masked lanes (hub regions / overflow).

    Adjacent bad chunks merge into runs (contiguous node ranges share one
    halo warmup); all runs decode in ONE batched native call
    (wg_bv_fill_ranges) split over host threads — per-call overhead
    dominated this path when thousands of hub lanes fell back."""
    import os as _os

    from .. import native as _native

    W = settings.window_size
    maxref = getattr(settings, "max_ref_count", 3)
    halo_n = W * max(int(maxref), 1) if W > 0 else 0
    cum = prep.cum_arcs
    offs = prep.offsets if offsets is None else offsets
    data = np.concatenate([np.ascontiguousarray(data, dtype=np.uint8),
                           np.zeros(16, dtype=np.uint8)])
    nc = prep.n_chunk_lanes
    lanes_mask = np.asarray(lanes_mask)[:nc]
    idx = np.flatnonzero(lanes_mask
                         & (prep.chunk_starts[:-1] != prep.chunk_starts[1:]))
    if not len(idx) and (hub_nodes is None or not len(hub_nodes)):
        return
    if len(idx):
        # merge adjacent bad chunks into runs
        brk = np.flatnonzero(
            (idx[1:] != idx[:-1] + 1)
            | (prep.chunk_starts[idx[:-1] + 1]
               != prep.chunk_starts[idx[1:]]))
        run_first = np.concatenate([[0], brk + 1])
        run_last = np.concatenate([brk, [len(idx) - 1]])
        s = prep.chunk_starts[idx[run_first]]
        e = prep.chunk_starts[idx[run_last] + 1]
    else:
        s = np.zeros(0, dtype=np.int64)
        e = np.zeros(0, dtype=np.int64)
    if hub_nodes is not None and len(hub_nodes):
        hn = np.asarray(hub_nodes, dtype=np.int64)
        s = np.concatenate([s, hn])
        e = np.concatenate([e, hn + 1])
    p = np.maximum(s - halo_n, 0)
    init = np.zeros((len(s), max(W, 1)), dtype=np.int64)
    if W > 0:
        yj = p[:, None] - 1 - np.arange(W, dtype=np.int64)[None, :]
        ok = yj >= 0
        init[ok] = prep.outdegrees[yj[ok]]
    offs = np.asarray(offs) if not hasattr(offs, "get_batch") else offs
    start_bit = (offs.get_batch(p) if hasattr(offs, "get_batch")
                 else offs[p])
    nb = prep.node_base  # node ids are global, stream/arc indices local
    _native.bv_fill_ranges(
        data, settings, p + nb, s + nb, e + nb, start_bit, init,
        cum[s] - prep.arc_base, cum[e] - cum[s], succ,
        threads=threads or (_os.cpu_count() or 1), padded=True)


def check_diag(prep: PreparedDecode, diag) -> np.ndarray:
    """Per-lane error flags (int32[lanes]); nonzero anywhere means
    fallback.

    Beyond the kernel's own flags, cross-checks each lane's emitted arc
    count and completed node count against the offsets-derived expectation —
    a desynced (corrupt) stream cannot pass both."""
    T = prep.spec.T
    d = np.asarray(diag)[:T].reshape(T, DIAG_ROWS, 1024)
    err = d[:, DIAG_ERR, :].reshape(-1).copy()
    wcur = d[:, DIAG_WCUR, :].reshape(-1)
    nodes = d[:, DIAG_NODES, :].reshape(-1)
    if prep.exp_arcs is not None:
        exp_arcs, exp_nodes = prep.exp_arcs, prep.exp_nodes
    else:
        cum = prep.cum_arcs
        starts = prep.chunk_starts[:-1]
        ends = prep.chunk_starts[1:]
        live = (starts != ends) & ~prep.skipped
        exp_arcs = np.where(live, cum[ends] - cum[starts] + prep.halo_arcs,
                            0)
        exp_nodes = np.where(live, ends - starts, 0)
    err |= np.where((wcur != exp_arcs) | (nodes != exp_nodes), E_COUNT, 0)
    return err


def hub_fallback_nodes(prep: PreparedDecode, errs: np.ndarray) -> np.ndarray:
    """Hub nodes that cannot be device-assembled for this run: their own
    preset lanes errored, their copy-source chunk errored, or (through the
    reference chain) a source hub fell back.  Empty normally."""
    hub = prep.hub
    if hub is None:
        return np.zeros(0, dtype=np.int64)
    nc = prep.n_chunk_lanes
    bad = np.zeros(len(hub.nodes), dtype=bool)
    pre = errs[hub.seg_lane0:hub.seg_lane0 + len(hub.seg_node)] != 0
    if pre.any():
        bad[hub.hub_idx[hub.seg_node[pre]]] = True
    bad_chunk = errs[:nc] != 0
    sel = hub.src_chunk >= 0
    hit = np.zeros_like(bad)
    hit[sel] = bad_chunk[hub.src_chunk[sel]]
    bad |= hit
    for _ in range(int(hub.depth.max()) + 1 if len(hub.depth) else 0):
        sel = hub.src_hub >= 0
        prop = np.zeros_like(bad)
        prop[sel] = bad[hub.src_hub[sel]]
        if not (prop & ~bad).any():
            break
        bad |= prop
    return hub.nodes[bad]


def fallback_arc_frac(prep: PreparedDecode, errs: np.ndarray) -> float:
    """Share of the arcs that the device did not decode (skipped or
    errored chunk lanes, hub fallbacks): the host fills them."""
    nc = prep.n_chunk_lanes
    bad = prep.skipped | (errs[:nc] != 0)
    cum = prep.cum_arcs
    bad_arcs = int((cum[prep.chunk_starts[1:]]
                    - cum[prep.chunk_starts[:-1]])[bad].sum())
    fb = hub_fallback_nodes(prep, errs)
    if len(fb):
        bad_arcs += int(np.diff(cum)[fb].sum())
    return bad_arcs / max(prep.m, 1)


@functools.partial(jax.jit, static_argnames=("Lt",))
def _assemble(out_cols, init, src_res, dst_res, src0, dst0, hub_rounds,
              Lt: int):
    # residual-segment sources live in the preset tile region [Lt:]; un-tile
    # just that region to lane-major (per tile under lax.map so the padded
    # transpose intermediate stays ~MB — a whole-store transpose
    # materializes tens of GB at uk-2002 scale), making every residual run
    # a contiguous gather.  Depth-0 copy sources gather from the tiled
    # store with precomputed tiled-flat indices.  Every destination array
    # is ascending and hits each slot once, so the scatters lower as
    # sorted unique updates.
    V8 = out_cols.shape[1]
    V = V8 * 8
    hv = init
    if src_res.size:
        def untile(tile):   # (V8, 8, 8, 128) -> (1024, V) lane-major
            return jnp.transpose(tile.reshape(V8, 8, 1024),
                                 (2, 0, 1)).reshape(1024, V)

        lm = jax.lax.map(untile, out_cols[Lt:]).reshape(-1)
        hv = hv.at[dst_res].set(jnp.take(lm, src_res, mode="clip"),
                                mode="drop", indices_are_sorted=True,
                                unique_indices=True)
    if src0.size:
        hv = hv.at[dst0].set(jnp.take(out_cols.reshape(-1), src0,
                                      mode="clip"),
                             mode="drop", indices_are_sorted=True,
                             unique_indices=True)
    for s, t in hub_rounds:
        hv = hv.at[t].set(jnp.take(hv, s, mode="clip"), mode="drop",
                          indices_are_sorted=True, unique_indices=True)
    return hv


def assemble_hubs(prep: PreparedDecode, out_cols) -> Optional[jnp.ndarray]:
    """Device assembly of hub lists from the kernel output: residual
    segments (preset lanes) + pre-injected intervals + copy gathers in
    reference-chain-depth rounds.  Returns int32[M_hub] or None."""
    if prep.hub is None:
        return None
    if not prep.hub.finalized:
        raise RuntimeError("cold hub plan not finalized: run "
                           "resolve_halos() first")
    hub_rounds = tuple((s, t) for d, s, t in prep.hub.cop_rounds if d > 0)
    return _assemble(jnp.asarray(out_cols), prep.hub.hub_init,
                     prep.hub.src_res, prep.hub.dst_res,
                     prep.hub.src_cop0, prep.hub.dst_cop0,
                     hub_rounds, Lt=prep.hub.seg_lane0 // 1024)


@functools.partial(jax.jit, static_argnames=("total",))
def _expand_device(first, cnt_cum, total: int):
    """repeat(first, counts) + within, built on device from compact
    per-segment arrays (cnt_cum = exclusive cumsum of counts, int32[S+1])."""
    seg = (jnp.cumsum(jnp.zeros((total,), jnp.int32)
                      .at[cnt_cum[:-1]].add(1, mode="drop")) - 1)
    return first[seg] + (jnp.arange(total, dtype=jnp.int32) - cnt_cum[seg])


@functools.partial(jax.jit, static_argnames=("total",))
def _repeat_device(vals, cnt_cum, total: int):
    """repeat(vals, counts) on device (no within-offset)."""
    seg = (jnp.cumsum(jnp.zeros((total,), jnp.int32)
                      .at[cnt_cum[:-1]].add(1, mode="drop")) - 1)
    return vals[seg]


@functools.partial(jax.jit, static_argnames=("m", "V"))
def _csr_index_device(arc_start, halo, m: int, V: int):
    """Per-arc LANE-MAJOR gather index, built on device from per-lane
    compacts: arc k of chunk lane i lives at row halo_i + (k - arc_start_i)
    of lane i's output column."""
    lane = (jnp.cumsum(jnp.zeros((m,), jnp.int32)
                       .at[arc_start[1:]].add(1, mode="drop")))
    row = halo[lane] + (jnp.arange(m, dtype=jnp.int32) - arc_start[lane])
    return lane * V + row


@jax.jit
def _untile_store(out_cols):
    """Tiled (T, V//8, 8, 8, 128) store -> lane-major flat (memory-bandwidth
    cheap: per-tile transposes under lax.map)."""
    V8 = out_cols.shape[1]

    def ut(tile):
        return jnp.transpose(tile.reshape(V8, 8, 1024),
                             (2, 0, 1)).reshape(1024, V8 * 8)

    return jax.lax.map(ut, out_cols).reshape(-1)


@jax.jit
def _csr_gather(out_cols, idx_lm):
    return jnp.take(_untile_store(out_cols), idx_lm, mode="clip")


@jax.jit
def _csr_gather_composed(out_cols, idx_lm, int_table):
    """One gather resolves every arc: chunk arcs + hub residual/copy
    sources from the lane-major store, hub interval values from the static
    table appended past it."""
    src = jnp.concatenate([_untile_store(out_cols), int_table])
    return jnp.take(src, idx_lm, mode="clip")


@functools.partial(jax.jit, donate_argnums=(0,))
def _csr_splice(succ, dst, vals):
    # donated: the splice scatters in place instead of copying the
    # m-element target (callers always rebind `succ = _csr_splice(succ,..)`)
    return succ.at[dst].set(vals, mode="drop", indices_are_sorted=True,
                            unique_indices=True)


def plan_csr_index(prep: PreparedDecode) -> None:
    """Precompute the device-resident flat-CSR assembly index (one gather
    per decode afterwards).  Stored on the plan: ``csr_idx4`` (int32[m]
    lane-major store positions; on cold plans hub arcs point straight at
    their composed sources) and, when a hub plan exists, ``csr_hub_dst``
    (int32[] CSR positions of hub arcs, ascending).

    This is the decode product the analytics layer consumes — the
    reference's iterators hand successors straight to consumers
    (HyperBall.java:654-900); here the chunked store flattens to CSR with
    one device gather instead of a host roundtrip."""
    T, V = prep.spec.T, prep.spec.V
    if T * V * 1024 + (1 << 26) >= (1 << 31) or prep.m >= (1 << 31):
        prep.csr_idx4 = None   # int32 gather domain exceeded: host path
        return
    cum = prep.cum_arcs
    starts = prep.chunk_starts[:-1]
    nc = prep.n_chunk_lanes
    arc_start = np.zeros(nc + 1, dtype=np.int32)
    arc_start[:nc] = (cum[starts] - prep.arc_base).astype(np.int32)
    arc_start[nc] = prep.m
    prep.csr_idx4 = _csr_index_device(
        jnp.asarray(arc_start), jnp.asarray(prep.halo_arcs.astype(np.int32)),
        m=prep.m, V=V)
    hub = prep.hub
    if hub is not None:
        cnt = (hub.hb_off[1:] - hub.hb_off[:-1]).astype(np.int32)
        ccum = np.zeros(len(cnt) + 1, dtype=np.int32)
        np.cumsum(cnt, out=ccum[1:])
        first = (cum[hub.nodes] - prep.arc_base).astype(np.int32)
        prep.csr_hub_dst = _expand_device(
            jnp.asarray(first), jnp.asarray(ccum), total=int(ccum[-1]))
        if hub.src_final is not None:
            # composed: point hub arc positions straight at their ultimate
            # sources — the CSR gather then needs no hub assembly at all
            prep.csr_idx4 = (prep.csr_idx4
                             .at[prep.csr_hub_dst].set(hub.src_final))


def decode_to_csr(prep: PreparedDecode, interpret: Optional[bool] = None,
                  data: Optional[np.ndarray] = None, settings=None):
    """Full decode to a DEVICE-resident flat CSR successor array.

    Returns (csr_off int64[n+1] host, succ int32[m] device, fill) where
    ``fill`` is None when every arc decoded on device, else a
    (bad_lanes_mask, hub_fallback_nodes) pair the caller must patch via
    ``fill_csr_device`` (host native decode of those ranges).

    The kernel's store flattens with one XLA gather (with the composed hub
    source map on cold plans, so hub arcs need no assembly pass).  After
    the first call the fill splice is cached, so steady-state calls are
    pure device work."""
    if prep.cold and not prep.resolved:
        resolve_halos(prep, interpret=interpret)
    if prep.csr_idx4 is None:
        plan_csr_index(prep)
    if prep.csr_idx4 is None:
        raise RuntimeError("graph exceeds the int32 device-CSR envelope")
    first = int(prep.chunk_starts[0])
    co = prep.cum_arcs[first:] - prep.arc_base
    if prep.hub is not None and prep.hub.src_final is not None:
        o, dg = decode_chunked(prep, interpret=interpret)
        succ = _csr_gather_composed(o, prep.csr_idx4, prep.hub.int_table)
    else:
        o, dg, hv = decode_full(prep, interpret=interpret)
        succ = _csr_gather(o, prep.csr_idx4)
        if hv is not None:
            succ = _csr_splice(succ, prep.csr_hub_dst, hv)
        hv = None
    o = None
    if prep.csr_fill_dst is not None:
        # steady state: the error/fill structure is static per graph, so
        # no diag readback
        if prep.csr_fill_dst.size:
            succ = _csr_splice(succ, prep.csr_fill_dst, prep.csr_fill_val)
        return co, succ, None
    errs = check_diag(prep, np.asarray(dg))
    nc = prep.n_chunk_lanes
    bad = prep.skipped | (errs[:nc] != 0)
    fb = hub_fallback_nodes(prep, errs)
    fill = None
    if bad.any() or len(fb):
        fill = (bad, fb)
        if data is not None:
            succ = fill_csr_device(prep, succ, bad, fb, data,
                                   settings or prep._settings)
            fill = None
    else:
        prep.csr_fill_dst = jnp.zeros(0, jnp.int32)
        prep.csr_fill_val = jnp.zeros(0, jnp.int32)
    return co, succ, fill


def fill_csr_device(prep: PreparedDecode, succ, bad, fb, data, settings):
    """Patch a device CSR with host-decoded values for skipped/errored
    lanes (uploads only the affected arc ranges)."""
    host_vals = np.zeros(prep.m, dtype=np.int64)
    fill_lanes(prep, bad, host_vals, data, settings, hub_nodes=fb)
    cum = prep.cum_arcs
    starts, ends = prep.chunk_starts[:-1], prep.chunk_starts[1:]
    segs = [(cum[s] - prep.arc_base, cum[e] - prep.arc_base)
            for s, e in zip(starts[bad], ends[bad])]
    if len(fb):
        segs += [(cum[y] - prep.arc_base, cum[y + 1] - prep.arc_base)
                 for y in fb]
    segs.sort()
    idx = np.concatenate([np.arange(a, b, dtype=np.int64)
                          for a, b in segs]) if segs else np.zeros(0,
                                                                   np.int64)
    if len(idx):
        prep.csr_fill_dst = jnp.asarray(idx.astype(np.int32))
        prep.csr_fill_val = jnp.asarray(host_vals[idx].astype(np.int32))
        succ = _csr_splice(succ, prep.csr_fill_dst, prep.csr_fill_val)
    else:
        prep.csr_fill_dst = jnp.zeros(0, jnp.int32)
        prep.csr_fill_val = jnp.zeros(0, jnp.int32)
    return succ


def decode_full(prep: PreparedDecode, interpret: Optional[bool] = None):
    """Kernel decode + hub assembly: the complete timed device step.
    Returns (out_cols, diag, hub_vals-or-None).  Cold plans auto-resolve
    their halo image on first use (resolve_halos wavefront)."""
    if prep.cold and not prep.resolved:
        resolve_halos(prep, interpret=interpret)
    o, dg = decode_chunked(prep, interpret=interpret)
    return o, dg, assemble_hubs(prep, o)
