"""Elias-Fano monotone list: the offsets index as packed device arrays.

The device analogue of sux4j's ``EliasFanoMonotoneLongBigList`` that the
reference wraps its offsets in (BVGraph.java:1556-1558) and caches as
``.obl`` (BVGraph.java:1545-1555).  Layout follows the classic construction
(also EFGraph.java:140-168 for the successor lists): n monotone values with
upper bound u are split at ell = max(0, floor(log2(u/n))) into

- ``lower``: n * ell bits, packed little-endian into uint64 words;
- ``upper``: a bit vector of n ones among n + (u >> ell) bits, the i-th one
  at position i + (value_i >> ell);
- ``rank``: ones-before-word counts (one int64 per upper word) making
  select_1 a searchsorted + in-word select.

Everything is vectorized numpy on the host; :func:`device_select` is the
jittable batched get for device-resident offset lookups (SURVEY §7 step 4),
using ``lax.population_count`` for the in-word select sweep.

Serialization (``.obl``): our own little-endian format (magic WGOBL1) —
the reference's .obl is a Java-serialized object, which is a cache, not a
compatibility surface; like the reference we only trust it when newer than
the ``.offsets`` file.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["EliasFanoMonotoneList", "build_ef", "device_select"]

_MAGIC = b"WGOBL1\x00\x00"


def _pack_fields(vals: np.ndarray, ell: int) -> np.ndarray:
    """Pack n ell-bit fields (little-endian bit order) into uint64 words."""
    n = len(vals)
    if ell == 0 or n == 0:
        return np.zeros(1, dtype=np.uint64)
    nbits = n * ell
    words = np.zeros((nbits + 63) // 64 + 1, dtype=np.uint64)
    pos = np.arange(n, dtype=np.int64) * ell
    w = pos >> 6
    sh = (pos & 63).astype(np.uint64)
    v = vals.astype(np.uint64) & np.uint64((1 << ell) - 1)
    np.bitwise_or.at(words, w, v << sh)
    spill = sh > 0
    np.bitwise_or.at(words, w[spill] + 1,
                     v[spill] >> (np.uint64(64) - sh[spill]))
    return words


def _unpack_fields(words: np.ndarray, idx: np.ndarray, ell: int) -> np.ndarray:
    if ell == 0:
        return np.zeros(len(idx), dtype=np.int64)
    pos = idx.astype(np.int64) * ell
    w = pos >> 6
    sh = (pos & 63).astype(np.uint64)
    lo = words[w] >> sh
    hi = np.where(sh > 0, words[w + 1] << (np.uint64(64) - sh), 0)
    mask = np.uint64((1 << ell) - 1)
    return ((lo | hi) & mask).astype(np.int64)


_SELECT_BYTE = None


def _select_byte_table():
    """(256, 8) table: position of the k-th set bit in a byte (8 if none)."""
    global _SELECT_BYTE
    if _SELECT_BYTE is None:
        t = np.full((256, 8), 8, dtype=np.uint8)
        for b in range(256):
            k = 0
            for bit in range(8):
                if b >> bit & 1:
                    t[b, k] = bit
                    k += 1
        _SELECT_BYTE = t
    return _SELECT_BYTE


def _select_in_word(words: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Position (0..63) of the k-th (0-based) set bit of each uint64."""
    b = words.view(np.uint8).reshape(-1, 8)  # little-endian byte order
    cnt = np.unpackbits(b, axis=1, bitorder="little").reshape(-1, 8, 8).sum(2)
    ccnt = np.zeros((len(words), 8), dtype=np.int64)
    np.cumsum(cnt[:, :7], axis=1, out=ccnt[:, 1:])
    byte_i = (ccnt <= k[:, None]).sum(1) - 1
    rem = (k - ccnt[np.arange(len(words)), byte_i]).astype(np.int64)
    sel = _select_byte_table()[b[np.arange(len(words)), byte_i], rem]
    return byte_i * 8 + sel


@dataclass
class EliasFanoMonotoneList:
    """n monotone int64 values in ~n*(2 + log2(u/n)) bits, random access."""

    n: int
    u: int  # strict upper bound (all values < u is not required: <= u)
    ell: int
    lower: np.ndarray   # uint64 words, n*ell bits
    upper: np.ndarray   # uint64 words, bit i+ (v_i >> ell) set
    rank: np.ndarray    # int64[len(upper)+1]: ones before each word

    def __len__(self) -> int:
        return self.n

    def get_batch(self, idx) -> np.ndarray:
        """Vectorized select: values at (array of) indices."""
        idx = np.asarray(idx, dtype=np.int64)
        scalar = idx.ndim == 0
        k = idx.reshape(-1)
        if self.n == 0:
            return np.zeros(len(k), dtype=np.int64)
        w = np.searchsorted(self.rank, k, side="right") - 1
        p = _select_in_word(self.upper[w], k - self.rank[w])
        hi = (w * 64 + p) - k
        out = (hi << self.ell) | _unpack_fields(self.lower, k, self.ell)
        return out[0] if scalar else out.reshape(idx.shape)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.get_batch(np.arange(*idx.indices(self.n)))
        return self.get_batch(idx)

    def to_array(self) -> np.ndarray:
        return self.get_batch(np.arange(self.n, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.lower.nbytes + self.upper.nbytes + self.rank.nbytes

    # -- serialization (.obl cache) ---------------------------------------

    def dump(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<qqqqq", self.n, self.u, self.ell,
                                len(self.lower), len(self.upper)))
            f.write(self.lower.tobytes())
            f.write(self.upper.tobytes())
            f.write(self.rank.tobytes())

    @classmethod
    def load(cls, path: str) -> "EliasFanoMonotoneList":
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise IOError(f"{path}: not a WGOBL1 offsets cache")
            n, u, ell, nl, nu = struct.unpack("<qqqqq", f.read(40))
            lower = np.frombuffer(f.read(nl * 8), dtype=np.uint64)
            upper = np.frombuffer(f.read(nu * 8), dtype=np.uint64)
            rank = np.frombuffer(f.read((nu + 1) * 8), dtype=np.int64)
        return cls(n, u, ell, lower, upper, rank)

    # -- device view -------------------------------------------------------

    def device_arrays(self):
        """(lower32, upper32, rank32) int32/uint32 jnp arrays for
        :func:`device_select` (uint64 is not a native device type; words are
        split into lo/hi uint32 pairs)."""
        import jax.numpy as jnp
        lo = self.lower.view(np.uint32).reshape(-1, 2)
        up = self.upper.view(np.uint32).reshape(-1, 2)
        return (jnp.asarray(lo), jnp.asarray(up),
                jnp.asarray(self.rank.astype(np.int32)))


def build_ef(values: np.ndarray, u: int | None = None
             ) -> EliasFanoMonotoneList:
    """Build from a nondecreasing int64 array (vectorized)."""
    vals = np.asarray(values, dtype=np.int64)
    n = len(vals)
    if u is None:
        u = int(vals[-1]) + 1 if n else 1
    ell = max(0, int(np.floor(np.log2(max(u, 1) / max(n, 1))))) if n else 0
    hi = vals >> ell if ell else vals
    pos = np.arange(n, dtype=np.int64) + hi
    nbits = n + (u >> ell) + 1
    upper = np.zeros((nbits + 63) // 64, dtype=np.uint64)
    np.bitwise_or.at(upper, pos >> 6,
                     np.uint64(1) << (pos & 63).astype(np.uint64))
    byts = upper.view(np.uint8).reshape(-1, 8)
    pcnt = np.unpackbits(byts, axis=1, bitorder="little").reshape(
        len(upper), 64).sum(1).astype(np.int64)
    rank = np.zeros(len(upper) + 1, dtype=np.int64)
    np.cumsum(pcnt, out=rank[1:])
    return EliasFanoMonotoneList(n, u, ell, _pack_fields(vals, ell),
                                 upper, rank)


def device_select(lower32, upper32, rank32, ell: int, idx):
    """Jittable batched EF select on device arrays (device_arrays()).

    ``idx`` int32[...]; returns ``(hi, lo)`` int32/uint32 planes with
    value = hi * 2**ell + lo — pure 32-bit arithmetic throughout (JAX x64
    stays off).  Requires ell <= 32
    (true for any realistic offsets index: ell ~ log2(bits/node)); callers
    compose on host, or keep the planes for chunk-relative device math.
    """
    import jax.numpy as jnp
    from jax import lax

    if ell > 32:
        raise NotImplementedError("device_select supports ell <= 32")
    idx = jnp.asarray(idx, dtype=jnp.int32)
    # ones-before-word rank is monotone: searchsorted
    w = jnp.searchsorted(rank32, idx, side="right") - 1
    k = idx - rank32[w]
    wlo = upper32[w, 0]
    whi = upper32[w, 1]
    c_lo = lax.population_count(wlo)
    in_hi = k >= c_lo
    word = jnp.where(in_hi, whi, wlo)
    kk = jnp.where(in_hi, k - c_lo, k)

    # in-word select of the kk-th set bit via prefix-popcount binary search
    p = jnp.zeros_like(kk)
    rem = kk
    for shift in (16, 8, 4, 2, 1):
        mask = jnp.uint32((1 << shift) - 1)
        lowc = lax.population_count(
            (word >> p.astype(jnp.uint32)) & mask).astype(jnp.int32)
        go = rem >= lowc
        rem = jnp.where(go, rem - lowc, rem)
        p = jnp.where(go, p + shift, p)
    bitpos = w * 64 + jnp.where(in_hi, 32, 0) + p
    hi = bitpos - idx

    if ell == 0:
        return hi, jnp.zeros_like(idx).astype(jnp.uint32)
    # bit position idx*ell as (32-bit word, bit) without 64-bit overflow:
    # idx = 32 q + r  =>  idx*ell = 32 (q*ell) + r*ell
    q, r = idx >> 5, idx & 31
    lw = q * ell + ((r * ell) >> 5)
    sh = ((r * ell) & 31).astype(jnp.uint32)
    flat = lower32.reshape(-1)
    a = flat[jnp.minimum(lw, flat.shape[0] - 1)]
    b = flat[jnp.minimum(lw + 1, flat.shape[0] - 1)]
    lo = jnp.where(sh > 0,
                   (a >> sh) | (b << (jnp.uint32(32) - sh)), a)
    if ell < 32:
        lo = lo & jnp.uint32((1 << ell) - 1)
    return hi, lo
