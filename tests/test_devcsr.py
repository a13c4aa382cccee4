"""Device CSR assembly tests (``kdecode.decode_to_csr``, interpret mode on
the CPU backend): the kernel's lane-major store flattened to a dense device
CSR by one gather, with hub arcs from the composed source map, static
interval hub values spliced, and lanes outside the device envelope
host-filled and spliced.  Each case is checked bit-exact against the
graph it was encoded from, on the first call and on the steady-state call
that reuses the cached fill splice.
"""

import numpy as np
import pytest

from webgraph_tpu import native
from webgraph_tpu.codecs.bvgraph import BVGraphSettings
from webgraph_tpu.core.graph import CSRGraph
from webgraph_tpu.ops import kdecode as K

from .graphs import erdos_renyi


def _hubby(n=500, seed=3, hub_every=101, span=240, minint_runs=True):
    """Interval-rich hub nodes (beyond the lane envelope), followers that
    copy them, and a sparse background."""
    rng = np.random.default_rng(seed)
    lists = []
    for x in range(n):
        if x % hub_every == 0:
            base = max(0, x - span // 2)
            step = 1 if minint_runs else 3
            runs = np.arange(base, min(base + span, n - 1), step,
                             dtype=np.int64)
            extra = rng.choice(n - 1, size=15, replace=False)
            lists.append(np.unique(np.concatenate([runs, extra])))
        elif x % hub_every == 1 and x > 1:
            lists.append(lists[-1][1:-1].copy())
        else:
            k = int(rng.integers(0, 5))
            lists.append(np.sort(rng.choice(n - 1, size=k, replace=False))
                         .astype(np.int64))
    return CSRGraph.from_lists(lists)


def _chain():
    """Hub -> hub reference chains (copies resolved in depth rounds)."""
    lists = []
    big = np.arange(50, 260, dtype=np.int64)
    for x in range(400):
        if x == 100:
            lists.append(big.copy())
        elif x in (101, 102, 103):
            lists.append(np.unique(np.concatenate(
                [lists[-1][1:-1], [299 + x]])))
        else:
            lists.append(np.asarray([(x + 7) % 400], dtype=np.int64))
    return CSRGraph.from_lists(lists)


def _encode(g, settings):
    data, _bits, offs_b, _ob, _st = native.bv_encode(g.offsets, g.succ,
                                                     settings)
    offsets = native.decode_offset_stream(offs_b, g.num_nodes,
                                          settings.offset_coding)
    return np.asarray(data), offsets


CASES = {
    # plain chunks, warm and cold plans
    "warm_w7": (lambda: erdos_renyi(300, 0.05, seed=1),
                dict(window_size=7, min_interval_length=3), {}, False),
    "cold_w3": (lambda: erdos_renyi(300, 0.05, seed=2),
                dict(window_size=3, min_interval_length=2), {}, True),
    "cold_w0": (lambda: erdos_renyi(200, 0.05, seed=3),
                dict(window_size=0, min_interval_length=0), {}, True),
    # hub nodes on device: composed hub source map + interval splice
    "hub_intervals": (_hubby, dict(window_size=7, min_interval_length=3),
                      dict(target_arcs_per_lane=32, v_cap=64, r_cap=48),
                      True),
    "hub_residuals": (lambda: _hubby(minint_runs=False),
                      dict(window_size=2, min_interval_length=4),
                      dict(target_arcs_per_lane=32, v_cap=64, r_cap=48),
                      True),
    "hub_chain": (_chain, dict(window_size=7, min_interval_length=4),
                  dict(target_arcs_per_lane=16, v_cap=48, r_cap=48), True),
    # lanes outside the envelope, host-filled and spliced
    "skipped_fill": (_hubby, dict(window_size=7, min_interval_length=3),
                     dict(target_arcs_per_lane=32, v_cap=64, r_cap=48,
                          hub_device=False), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_to_csr(case):
    gfn, skw, pkw, cold = CASES[case]
    g = gfn()
    s = BVGraphSettings(max_ref_count=3, **skw)
    data, offsets = _encode(g, s)
    outd = native.decode_outdegrees(data, offsets, s.outdegree_coding)
    prep = K.plan_kernel_decode(
        offsets, outd, s, data,
        halo_csr=None if cold else (g.offsets, g.succ), **pkw)
    assert prep is not None and prep.cold == cold
    if "hub" in case:
        assert prep.hub is not None and len(prep.hub.nodes)
    if case == "skipped_fill":
        assert prep.skipped.any()
    co, succ, fill = K.decode_to_csr(prep, data=data, settings=s)
    assert fill is None
    np.testing.assert_array_equal(co, g.offsets)
    np.testing.assert_array_equal(np.asarray(succ), g.succ)
    # steady state: cached fill splice, no diag readback
    co, succ, fill = K.decode_to_csr(prep)
    assert fill is None
    np.testing.assert_array_equal(np.asarray(succ), g.succ)
