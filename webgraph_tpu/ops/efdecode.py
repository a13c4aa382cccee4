"""Vectorized EFGraph decoder — fully parallel, no sequential state at all.

Elias–Fano is a natural device format: unlike BVGraph's sequential
entries, every part of an EF list is directly addressable.  The whole graph
decodes in ONE pass of dense vector ops (no device loops):

1. gamma outdegrees at the per-node offsets (LSB-first longword discipline,
   EFGraph.java:852-990) — one vectorized read;
2. per-node region bases (pointers / lower bits / upper bits) from the
   closed-form parameters l, pointerSize, numberOfPointers
   (EFGraph.java:140-168);
3. *select-by-cumsum*: expand the stream to a bit array, mask it to the
   union of upper-bits regions, prefix-sum the ones; the j-th successor of
   node x has its "one" at global rank rank(up_base[x]) + j, so a single
   scatter+gather yields every upper part at once;
4. value = (one_position - up_base - j) << l | lower_bits[j].
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ef_decode_to_csr", "EFDevicePlan"]


def _clz(v_u32):
    return jax.lax.clz(jax.lax.bitcast_convert_type(v_u32, jnp.int32))


def _ctz32(v_u32):
    """Trailing zeros of a uint32 (32 for zero)."""
    low = v_u32 & (~v_u32 + jnp.uint32(1))  # isolate lowest set bit
    return jnp.where(v_u32 == 0, 32, 31 - _clz(low))


def _lsb_window64(words, pos):
    """(lo, hi) uint32 pair: 64 stream bits starting at pos, LSB-first."""
    w = pos >> 5
    o = pos.astype(jnp.uint32) & 31
    w0 = jnp.take(words, w, mode="clip")
    w1 = jnp.take(words, w + 1, mode="clip")
    w2 = jnp.take(words, w + 2, mode="clip")
    ok = o > 0
    no = jnp.where(ok, jnp.uint32(32) - o, 1)
    lo = (w0 >> o) | jnp.where(ok, w1 << no, 0)
    hi = (w1 >> o) | jnp.where(ok, w2 << no, 0)
    return lo, hi


def _lsb_extract(words, pos, nbits):
    """nbits (0..32) at pos, LSB-first, as uint32."""
    lo, _ = _lsb_window64(words, pos)
    nb = jnp.clip(nbits, 0, 32).astype(jnp.uint32)
    ok = nb > 0
    mask = jnp.where(nb >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << jnp.where(ok, nb, 1)) - 1)
    return jnp.where(ok, lo & mask, 0)


@jax.jit
def _lsb_read_gamma(words, pos):
    """LSB-first gamma (EFGraph writeNonZeroGamma: unary-as-trailing-zeros
    then msb bits).  Returns (value, advance)."""
    lo, hi = _lsb_window64(words, pos)
    t = _ctz32(lo)
    t = jnp.where(lo == 0, 32 + _ctz32(hi), t)  # unary parts here are short
    body = pos + t + 1
    bits = _lsb_extract(words, body, t).astype(jnp.int64)
    value = ((jnp.int64(1) << t.astype(jnp.int64)) | bits) - 1
    return value, 2 * t + 1


def _ilog2(v):
    """floor(log2(v)) for v >= 1 (int32/int64 in, int32 out)."""
    v32 = jnp.maximum(v, 1).astype(jnp.uint32)
    return 31 - _clz(v32)


@functools.partial(jax.jit, static_argnames=("log2_quantum",))
def _ef_params(d, upper_bound, log2_quantum):
    """(l, psize, npointers) for corrected length d+1 (EFGraph.java:140-168)."""
    cl = d + 1
    l = jnp.maximum(_ilog2(upper_bound // cl), 0)
    l = jnp.where(upper_bound // cl >= 1, l, 0)
    shifted = upper_bound >> l.astype(jnp.int64)
    # ceil(log2(cl + shifted))
    s = cl + shifted
    ceil = jnp.where(s <= 1, 0, _ilog2(s - 1) + 1)
    psize = jnp.maximum(ceil, 0)
    npointers = shifted >> log2_quantum
    return l, psize, npointers


@functools.partial(jax.jit, static_argnames=("m", "n", "total_bits",
                                             "log2_quantum"))
def _ef_decode_device(words, starts, up_end, upper_bound,
                      m: int, n: int, total_bits: int, log2_quantum: int):
    """The whole-graph decode as ONE device program (no host roundtrip:
    outdegrees, CSR offsets, per-arc rows and values are all derived on
    device)."""
    d64, adv = _lsb_read_gamma(words, starts)
    d = d64.astype(jnp.int32)
    l, psize, npointers = _ef_params(d64, upper_bound, log2_quantum)

    csr_off = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(d)])

    ptr_base = starts + adv.astype(jnp.int32)
    low_base = ptr_base + (npointers * psize).astype(jnp.int32)
    up_base = low_base + ((d + 1) * l).astype(jnp.int32)

    # ---- select-by-cumsum over the masked upper-bits regions ----
    bits = ((words[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :])
            & 1).astype(jnp.int32).reshape(-1)[:total_bits]
    delta = jnp.zeros(total_bits + 1, dtype=jnp.int32)
    delta = delta.at[up_base].add(1, mode="drop")
    delta = delta.at[up_end].add(-1, mode="drop")
    in_upper = jnp.cumsum(delta[:total_bits]) > 0
    ones = jnp.where(in_upper, bits, 0)
    rank_excl = jnp.cumsum(ones) - ones  # rank of position (exclusive)
    total_ones = m + n  # d+1 ones per node => sum(d) + n
    pos_of_rank = jnp.zeros(total_ones + 1, dtype=jnp.int32)
    # rank_excl is nondecreasing, so this is a SORTED scatter-max: zero
    # positions write value 0 at their (duplicate) rank and lose the max
    # to the real one's position (one at stream position 0 is rank 0
    # anyway, so the duplicate zero write is exact there too)
    pos_of_rank = pos_of_rank.at[rank_excl].max(
        jnp.where(ones > 0, jnp.arange(total_bits, dtype=jnp.int32), 0),
        mode="drop", indices_are_sorted=True)

    # ---- per-arc assembly (row ids from the CSR bounds, on device) ----
    row = jnp.cumsum(jnp.zeros((m,), jnp.int32)
                     .at[csr_off[1:-1]].add(1, mode="drop"))
    j_local = jnp.arange(m, dtype=jnp.int32) - jnp.take(csr_off, row)
    rank0 = jnp.take(rank_excl, jnp.take(up_base, row))
    one_pos = jnp.take(pos_of_rank, rank0 + j_local)
    upper = one_pos - jnp.take(up_base, row) - j_local
    lx = jnp.take(l, row)
    low = _lsb_extract(
        words, jnp.take(low_base, row) + j_local * lx, lx)
    # int32 value lanes (values < upper_bound < 2^31; the EFGraph loader
    # gates bigger graphs to the host path)
    vals = ((upper.astype(jnp.uint32) << lx.astype(jnp.uint32)) | low)
    return csr_off, vals.astype(jnp.int32)


class EFDevicePlan:
    """Device-resident EF decode plan: the stream uploads ONCE; every
    decode after that is a single jitted dispatch returning device
    arrays."""

    def __init__(self, words64: np.ndarray, offsets: np.ndarray,
                 upper_bound: int, log2_quantum: int):
        words32 = np.ascontiguousarray(words64, dtype=np.uint64).view("<u4")
        words32 = np.concatenate([words32.astype(np.uint32),
                                  np.zeros(16, dtype=np.uint32)])
        offsets = np.asarray(offsets, dtype=np.int64)
        assert offsets[-1] < 2**31, "chunk the stream beyond 2^31 bits"
        self.n = len(offsets) - 1
        self.total_bits = int(words32.shape[0] - 16) * 32
        self.upper_bound = int(upper_bound)
        self.log2_quantum = int(log2_quantum)
        self.words = jnp.asarray(words32)
        self.starts = jnp.asarray(offsets[:-1], dtype=jnp.int32)
        self.up_end = jnp.asarray(offsets[1:], dtype=jnp.int32)
        # one tiny plan-time readback: the arc count sizes the program
        d, _ = _lsb_read_gamma(self.words, self.starts)
        d_np = np.asarray(d, dtype=np.int64)
        self.csr_off = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(d_np, out=self.csr_off[1:])
        self.m = int(self.csr_off[-1])

    def decode(self):
        """One dispatch -> (csr_off int32[n+1] device, succ int32[m]
        device)."""
        return _ef_decode_device(
            self.words, self.starts, self.up_end,
            jnp.int64(self.upper_bound), m=self.m, n=self.n,
            total_bits=self.total_bits, log2_quantum=self.log2_quantum)


def ef_decode_to_csr(words64: np.ndarray, offsets: np.ndarray,
                     upper_bound: int, log2_quantum: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a whole EFGraph: uint64 words + per-node bit offsets -> CSR
    (host arrays; one-shot convenience over :class:`EFDevicePlan`)."""
    plan = EFDevicePlan(words64, offsets, upper_bound, log2_quantum)
    _, vals = plan.decode()
    return plan.csr_off, np.asarray(vals, dtype=np.int64)
