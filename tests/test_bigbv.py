"""webgraph-BIG paths: streaming encode, sliced decode, > 2^31 scale.

Mirrors BVGraphSlowTest.java:30-97 (procedural BigGraph round-trip).  The
full-size (> 2^31 nodes / arcs) variants run when WEBGRAPH_BIG=1 (minutes);
the same machinery is exercised at small scale unconditionally.
"""

import os

import numpy as np
import pytest

from webgraph_tpu import native
from webgraph_tpu.codecs.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu.ops.bigdecode import decode_big_slices

from .graphs import erdos_renyi

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


class BigGraph:
    """Procedural graph of BVGraphSlowTest.java:30-52: nodes 0 and 1 have
    `outdegree` successors {0, step, 2*step, ...}; every other node has
    {x-2, x-1}.  Slices are produced vectorized."""

    def __init__(self, num_nodes, outdegree, step):
        assert outdegree * step <= num_nodes
        self.num_nodes = num_nodes
        self.outdegree = outdegree
        self.step = step

    @property
    def num_arcs(self):
        return 2 * self.outdegree + (self.num_nodes - 2) * 2

    def slice(self, lo, hi):
        """(csr_off, succ) for nodes [lo, hi)."""
        d = np.full(hi - lo, 2, dtype=np.int64)
        if lo == 0:
            d[0] = self.outdegree
        if lo <= 1 < hi:
            d[1 - lo] = self.outdegree
        co = np.zeros(hi - lo + 1, dtype=np.int64)
        np.cumsum(d, out=co[1:])
        su = np.empty(int(co[-1]), dtype=np.int64)
        x = np.arange(max(lo, 2), hi, dtype=np.int64)
        a = int(co[max(lo, 2) - lo])
        rest = np.empty((hi - max(lo, 2), 2), dtype=np.int64)
        rest[:, 0] = x - 2
        rest[:, 1] = x - 1
        su[a:] = rest.reshape(-1)
        head = np.arange(self.outdegree, dtype=np.int64) * self.step
        if lo == 0:
            su[:self.outdegree] = head
        if lo <= 1 < hi:
            b = int(co[1 - lo])
            su[b:b + self.outdegree] = head
        return co, su

    def slices(self, step_nodes=1 << 20):
        lo = 0
        while lo < self.num_nodes:
            hi = min(lo + step_nodes, self.num_nodes)
            yield self.slice(lo, hi)
            lo = hi


class _SeqOnly:
    """Sequential-only wrapper (no CSRGraph fast path) to force the
    streaming branch of BVGraph._store_native."""

    def __init__(self, g):
        self._g = g
        self.num_nodes = g.num_nodes

    def iter_nodes(self, start=0):
        return self._g.iter_nodes(start)


def test_stream_encoder_byte_identity():
    for seed, s in [(0, BVGraphSettings()),
                    (1, BVGraphSettings(window_size=0)),
                    (2, BVGraphSettings(min_interval_length=0))]:
        g = erdos_renyi(400, 0.04, seed=seed)
        co, su = g.offsets, g.succ
        g1, b1, o1, ob1, st1 = native.bv_encode(co, su, s, threads=1)
        enc = native.StreamEncoder(s)
        for lo in range(0, 400, 37):
            hi = min(lo + 37, 400)
            enc.push(co[lo:hi + 1] - co[lo], su[co[lo]:co[hi]])
        g2, b2, o2, ob2, st2 = enc.finish()
        assert b1 == b2 and np.array_equal(g1, g2)
        assert ob1 == ob2 and np.array_equal(o1, o2)
        assert np.array_equal(st1, st2)


def test_store_streams_sequential_graphs(tmp_path):
    g = erdos_renyi(500, 0.03, seed=9)
    b1 = str(tmp_path / "csr")
    b2 = str(tmp_path / "seq")
    BVGraph.store(g, b1, backend="native", num_threads=1)
    BVGraph.store(_SeqOnly(g), b2, backend="native")
    assert open(b1 + ".graph", "rb").read() == open(b2 + ".graph", "rb").read()
    assert (open(b1 + ".offsets", "rb").read()
            == open(b2 + ".offsets", "rb").read())
    p1 = BVGraph.load(b1).properties
    p2 = BVGraph.load(b2).properties
    for k in ("nodes", "arcs", "bitsperlink", "avgref"):
        assert p1[k] == p2[k], k


def test_store_slices_roundtrip(tmp_path):
    bg = BigGraph(50_000, 1000, 4)
    base = str(tmp_path / "big")
    props = BVGraph.store_slices(bg.slices(7_000), base)
    assert int(props["nodes"]) == 50_000
    assert int(props["arcs"]) == bg.num_arcs
    bv = BVGraph.load(base)
    np.testing.assert_array_equal(
        bv.successors(0), np.arange(1000, dtype=np.int64) * 4)
    np.testing.assert_array_equal(bv.successors(777), [775, 776])
    # sequential slice scan reproduces the procedural graph exactly
    for lo, hi, co, su in bv.iter_csr_slices(slice_nodes=9_999):
        eco, esu = bg.slice(lo, hi)
        np.testing.assert_array_equal(co, eco)
        np.testing.assert_array_equal(su, esu)


def test_iter_csr_slices_cnr2000(tmp_path):
    """Slice scan of the cnr-2000-shaped stand-in (generated, encoded with
    cnr-2000's settings) equals the native whole-graph decode and the
    generator."""
    from webgraph_tpu.core.graph import CSRGraph
    from webgraph_tpu.utils.synth import cnr2000_settings, cnr2000_standin

    co, su = cnr2000_standin()
    base = str(tmp_path / "cnr")
    BVGraph.store(CSRGraph(co, su), base, settings=cnr2000_settings())
    bv = BVGraph.load(base)
    data = np.asarray(bv.data)
    hco, hsu = native.bv_decode_all(data, bv.num_nodes, bv.num_arcs,
                                    bv.settings)
    np.testing.assert_array_equal(hco, co)
    np.testing.assert_array_equal(hsu, su)
    got = []
    x_at = 0
    for lo, hi, co, su in bv.iter_csr_slices(slice_nodes=50_021):
        assert lo == x_at
        np.testing.assert_array_equal(co, hco[lo:hi + 1] - hco[lo])
        got.append(su)
        x_at = hi
    assert x_at == bv.num_nodes
    np.testing.assert_array_equal(np.concatenate(got), hsu)


def test_decode_big_slices_small():
    """The sliced device-kernel driver at toy scale (interpret on CPU):
    slice rebasing, node_base/first_node plumbing, halo across slices."""
    g = erdos_renyi(1500, 0.02, seed=4)
    base_settings = BVGraphSettings()
    graph_b, _gb, offs_b, _ob, _st = native.bv_encode(
        g.offsets, g.succ, base_settings, threads=1)
    offsets = native.decode_offset_stream(offs_b, 1500,
                                          base_settings.offset_coding)
    outd = np.diff(g.offsets)
    parts = []
    x_at = 0
    for lo, hi, co, su in decode_big_slices(
            offsets, outd, base_settings, graph_b, slice_arcs=11_000,
            target_arcs_per_lane=16, v_cap=128, r_cap=96):
        assert lo == x_at
        np.testing.assert_array_equal(
            co, g.offsets[lo:hi + 1] - g.offsets[lo])
        parts.append(su)
        x_at = hi
    assert x_at == 1500
    np.testing.assert_array_equal(np.concatenate(parts), g.succ)


@pytest.mark.skipif(not os.environ.get("WEBGRAPH_BIG"),
                    reason="set WEBGRAPH_BIG=1 for the > 2^31 run (minutes)")
def test_biggraph_over_2_31(tmp_path):
    """The real thing: > 2^31 nodes AND arcs, streaming store + slice scan
    (BVGraphSlowTest.java:60-69 semantics, sized to this machine)."""
    n = (1 << 31) + (1 << 21)
    bg = BigGraph(n, 1 << 20, 2)
    assert bg.num_arcs > (1 << 31) and bg.num_nodes > (1 << 31)
    base = str(tmp_path / "huge")
    props = BVGraph.store_slices(bg.slices(4 << 20), base)
    assert int(props["nodes"]) == n and int(props["arcs"]) == bg.num_arcs
    bv = BVGraph.load(base, mode="offline")
    checked = 0
    for lo, hi, co, su in bv.iter_csr_slices(slice_nodes=16 << 20):
        eco, esu = bg.slice(lo, hi)
        assert np.array_equal(co, eco) and np.array_equal(su, esu)
        checked = hi
    assert checked == n
