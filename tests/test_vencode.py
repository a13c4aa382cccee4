"""Vectorized (device) encoder tests.

The vectorized path (ops/vencode: device cost matrix -> native greedy
selection -> device token packing) must be byte-identical to the Python
reference encoder, which is byte-identical to the Java reference on
cnr-2000 (BVGraph.java:1977-2328 semantics).
"""

import hashlib

import numpy as np
import pytest

from webgraph_tpu import native
from webgraph_tpu.codecs.bvgraph import (BVGraph, BVGraphSettings,
                                         CompressionFlags as C)
from webgraph_tpu.core.graph import CSRGraph
from webgraph_tpu.ops import vencode

from .graphs import complete_graph, cycle_graph, erdos_renyi, star_graph

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libwgnative.so not built")


def _store_pair(g, tmp_path, **kwargs):
    a = str(tmp_path / "py")
    b = str(tmp_path / "device")
    pa = BVGraph.store(g, a, backend="python", **kwargs)
    pb = BVGraph.store(g, b, backend="device", **kwargs)
    return a, b, pa, pb


@pytest.mark.parametrize("window,minint", [(0, 0), (0, 4), (2, 2), (7, 4)])
def test_byte_identity_vs_python(tmp_path, window, minint):
    g = erdos_renyi(200, 0.04, seed=7)
    a, b, pa, pb = _store_pair(g, tmp_path, window_size=window,
                               max_ref_count=3, min_interval_length=minint)
    for ext in (".graph", ".offsets"):
        assert open(a + ext, "rb").read() == open(b + ext, "rb").read(), ext
    assert pa == pb  # the full properties/metrics surface must agree


@pytest.mark.parametrize("coding", ["DELTA", "GAMMA", "ZETA"])
def test_byte_identity_residual_codings(tmp_path, coding):
    g = erdos_renyi(120, 0.06, seed=11)
    s = BVGraphSettings(residual_coding=getattr(C, coding),
                        window_size=3, min_interval_length=2)
    a, b, pa, pb = _store_pair(g, tmp_path, settings=s)
    assert open(a + ".graph", "rb").read() == open(b + ".graph", "rb").read()
    assert pa == pb


@pytest.mark.parametrize("gfn", [lambda: complete_graph(12),
                                 lambda: star_graph(64),
                                 lambda: cycle_graph(100),
                                 lambda: erdos_renyi(400, 0.03, seed=1)])
def test_edge_case_graphs(tmp_path, gfn):
    g = gfn()
    a, b, pa, pb = _store_pair(g, tmp_path)
    assert open(a + ".graph", "rb").read() == open(b + ".graph", "rb").read()
    assert open(a + ".offsets", "rb").read() == \
        open(b + ".offsets", "rb").read()
    assert pa == pb


def test_chunked_identical_to_single(tmp_path):
    """Chunked encode (halo-carried windows + bit concat) is byte-identical
    to the one-chunk encode (single-stream semantics across chunk bounds)."""
    g = erdos_renyi(500, 0.03, seed=3)
    gc = g.to_csr()
    s = BVGraphSettings(window_size=7, max_ref_count=3,
                        min_interval_length=3)
    one, bits1, starts1, *_ = vencode.encode_csr(gc.offsets, gc.succ, s)
    many, bits2, starts2, _st = vencode.encode_csr_chunked(
        gc.offsets, gc.succ, s, chunk_arcs=400)
    assert bits1 == bits2
    assert one == many
    np.testing.assert_array_equal(
        starts2, np.asarray(starts1, dtype=np.int64))


def test_bitcat_random_streams():
    rng = np.random.default_rng(0)
    cat = vencode.BitCat()
    want = []
    for _ in range(50):
        nbits = int(rng.integers(1, 70))
        bits = rng.integers(0, 2, nbits)
        want.extend(bits.tolist())
        nb = -(-nbits // 8)
        by = np.zeros(nb, np.uint8)
        for i, v in enumerate(bits):
            by[i >> 3] |= v << (7 - (i & 7))
        cat.push(by.tobytes(), nbits)
    got = np.unpackbits(np.frombuffer(cat.to_bytes(), np.uint8))
    np.testing.assert_array_equal(got[:len(want)], np.asarray(want))
    assert not got[len(want):].any()


def test_cnr2000_device_byte_identity(tmp_path, cnr2000_basename):
    """Vectorized re-encode of cnr-2000 reproduces the Java-written stream
    byte for byte (graph AND offsets)."""
    bv = BVGraph.load(cnr2000_basename)
    csr_off, succ = native.bv_decode_all(
        np.asarray(bv.data), bv.num_nodes, bv.num_arcs, bv.settings)
    s = BVGraphSettings(window_size=7, max_ref_count=3,
                        min_interval_length=3, zeta_k=3)
    out = str(tmp_path / "cnr")
    BVGraph.store(CSRGraph(csr_off, succ), out, settings=s, backend="device")
    want = {
        ".graph": "d56e5ef76121bd184c68ecb0262f5983",
        ".offsets": "afd663cc6560c9784f3b63a4b665de12",
    }
    for ext, md5 in want.items():
        got = hashlib.md5(open(out + ext, "rb").read()).hexdigest()
        assert got == md5, ext


def test_encode_device_plan_byte_identical():
    """EncodeDevicePlan (single-upload, all-device selection scan) must be
    byte-identical to the native encoder (BVGraph.java:2256-2270 greedy +
    measure-then-pack)."""
    from webgraph_tpu import native
    from webgraph_tpu.ops.vencode import EncodeDevicePlan

    rng = np.random.default_rng(11)
    g = erdos_renyi(400, 0.04, seed=5)
    co, su = np.asarray(g.offsets), np.asarray(g.succ)
    settings = BVGraphSettings()
    plan = EncodeDevicePlan(co, su, settings)
    gbytes, gbits, starts, refs, rcs, stats = plan.encode()
    # the all-device selection scan must agree with the native pass
    g2 = plan.encode(selection="scan")
    assert g2[0] == gbytes and np.array_equal(g2[3], refs)
    ng, nbits, _o, _ob, _st = native.bv_encode(co, su, settings, threads=1)
    assert gbits == nbits
    assert np.array_equal(np.frombuffer(gbytes, np.uint8),
                          np.asarray(ng, np.uint8))
    # second encode from the same plan is identical (device-resident reuse)
    gbytes2 = plan.encode()[0]
    assert gbytes2 == gbytes
