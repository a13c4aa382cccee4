"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The analogue of the reference's (absent) distributed testing:
single-chip vs multi-chip decode equality (SURVEY §4.8).
"""

import jax
import numpy as np
import pytest

from webgraph_tpu.codecs.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu.parallel.sharded import decode_sharded_kernel, make_mesh

from .graphs import erdos_renyi


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def _sharded_check(g, settings, cold):
    """Kernel tiles sharded over the 8-device mesh decode ``g`` bit-exactly,
    each device holding its own share of the (padded) tiles."""
    from webgraph_tpu import native
    from webgraph_tpu.ops import kdecode as K

    data, _bits, offs_b, _ob, _st = native.bv_encode(g.offsets, g.succ,
                                                     settings)
    data = np.asarray(data)
    offsets = native.decode_offset_stream(offs_b, g.num_nodes,
                                          settings.offset_coding)
    prep = K.plan_kernel_decode(
        offsets, np.diff(g.offsets), settings, data,
        halo_csr=None if cold else (g.offsets, g.succ),
        target_arcs_per_lane=4, v_cap=64, r_cap=32)
    assert prep is not None and prep.cold == cold
    if cold:
        K.resolve_halos(prep)
    mesh = make_mesh()
    out, diag = decode_sharded_kernel(prep, mesh)
    rows = sorted(sh.index[0].start for sh in out.addressable_shards)
    share = out.shape[0] // 8
    assert out.shape[0] >= prep.spec.T and rows == list(range(0, 8 * share,
                                                            share))
    errs = K.check_diag(prep, np.asarray(diag))
    co, succ = K.chunked_to_csr(prep, np.asarray(out), data=data,
                                settings=settings, errs=errs)
    np.testing.assert_array_equal(co, g.offsets)
    np.testing.assert_array_equal(succ, g.succ)


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_decode_matches_oracle(seed):
    """Warm plan (seed 0) and cold plan with halo resolve (seed 1)."""
    g = erdos_renyi(400, 0.04, seed=seed)
    _sharded_check(g, BVGraphSettings(window_size=7, min_interval_length=3),
                   cold=bool(seed))


def test_sharded_decode_windowless():
    g = erdos_renyi(200, 0.05, seed=2)
    _sharded_check(g, BVGraphSettings(window_size=0), cold=True)


def test_sharded_kernel_decode_cnr2000(cnr2000_basename):
    """Fixture-scale multichip equality: the Pallas kernel decode sharded
    over the 8-device CPU mesh must reproduce the native oracle bit-exactly
    (the analogue of the reference's parallel-vs-sequential oracle
    discipline, SURVEY §4.8)."""
    from webgraph_tpu import native
    from webgraph_tpu.ops import kdecode as K

    bv = BVGraph.load(cnr2000_basename)
    data = np.asarray(bv.data)
    outd = native.decode_outdegrees(data, bv.offsets,
                                    bv.settings.outdegree_coding)
    hco, hsu, refs = native.bv_decode_all_refs(
        data, bv.num_nodes, bv.num_arcs, bv.settings)
    prep = K.plan_kernel_decode(bv.offsets, outd, bv.settings, data,
                                halo_csr=(hco, hsu), refs=refs,
                                target_arcs_per_lane=128, v_cap=256,
                                r_cap=96)
    assert prep is not None
    mesh = make_mesh()
    out, diag = decode_sharded_kernel(prep, mesh)
    errs = K.check_diag(prep, np.asarray(diag))
    co, succ = K.chunked_to_csr(prep, np.asarray(out), data=data,
                                settings=bv.settings, errs=errs)
    np.testing.assert_array_equal(co, hco)
    np.testing.assert_array_equal(succ, hsu)
