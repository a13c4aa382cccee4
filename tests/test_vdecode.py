"""Vectorized (XLA) decoder tests: bit-exact vs the scalar oracle.

This is the analogue of the reference's parallel-vs-sequential
oracle tests (SURVEY §4.4): the data-parallel decode path must agree with
the scalar reference implementation on every graph and parameter combination.
Runs on the CPU backend in tests; the same code runs on the GPU.
"""

import numpy as np
import pytest

from webgraph_tpu.codecs.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu.ops import vdecode

from .graphs import complete_graph, cycle_graph, erdos_renyi, star_graph


def vdecode_check(g, tmp_path, batch=512, **kw):
    base = str(tmp_path / "g")
    BVGraph.store(g, base, **kw)
    bv = BVGraph.load(base)
    cfg = vdecode.config_from_settings(bv.settings, batch=batch)
    co, succ = vdecode.decode_to_csr(
        np.asarray(bv.data), bv.offsets, cfg, bvgraph=bv)
    exp = g.to_csr()
    np.testing.assert_array_equal(co, exp.offsets)
    np.testing.assert_array_equal(succ, exp.succ)


@pytest.mark.parametrize("seed,p", [(0, 0.15), (1, 0.05), (2, 0.3)])
def test_vdecode_erdos_renyi(tmp_path, seed, p):
    vdecode_check(erdos_renyi(150, p, seed=seed), tmp_path)


@pytest.mark.parametrize("gen", [
    lambda: complete_graph(10),
    lambda: cycle_graph(17),
    lambda: star_graph(13),
])
def test_vdecode_structured(tmp_path, gen):
    vdecode_check(gen(), tmp_path)


@pytest.mark.parametrize("window,min_int", [(0, 4), (7, 0), (0, 0), (2, 2)])
def test_vdecode_param_sweep(tmp_path, window, min_int):
    g = erdos_renyi(100, 0.1, seed=4)
    vdecode_check(g, tmp_path, window_size=window, min_interval_length=min_int)


def test_vdecode_residual_gamma(tmp_path):
    g = erdos_renyi(80, 0.1, seed=6)
    s = BVGraphSettings(residual_coding=2)  # GAMMA
    vdecode_check(g, tmp_path, settings=s)


def test_vdecode_overflow_patch(tmp_path):
    # force tiny max_blocks so the scalar-oracle patch path is exercised
    g = erdos_renyi(80, 0.3, seed=8)
    base = str(tmp_path / "g")
    BVGraph.store(g, base)
    bv = BVGraph.load(base)
    cfg = vdecode.config_from_settings(bv.settings, batch=128, max_blocks=2)
    co, succ = vdecode.decode_to_csr(
        np.asarray(bv.data), bv.offsets, cfg, bvgraph=bv)
    exp = g.to_csr()
    np.testing.assert_array_equal(succ, exp.succ)


def test_vdecode_empty_nodes(tmp_path):
    from webgraph_tpu.core.graph import CSRGraph
    lists = [np.zeros(0, dtype=np.int64),
             np.asarray([0, 1, 2, 3, 4], dtype=np.int64),
             np.zeros(0, dtype=np.int64),
             np.asarray([1], dtype=np.int64)]
    vdecode_check(CSRGraph.from_lists(lists), tmp_path)


def test_unary_overrun_flags_not_silent(tmp_path):
    """A Golomb residual whose unary quotient exceeds MAX_UNARY_BITS must be
    flagged and scalar-patched, never decoded silently wrong (round-3
    review item: the v1 engine previously capped the run and produced
    garbage)."""
    from webgraph_tpu.codecs.bvgraph import (BVGraph, BVGraphSettings,
                                             CompressionFlags as C)
    from webgraph_tpu.core.graph import CSRGraph

    n = 4000
    lists = [np.zeros(0, dtype=np.int64) for _ in range(n)]
    # huge forward gap -> Golomb quotient ~ gap/zeta_k >> MAX_UNARY_BITS
    lists[0] = np.asarray([1, 3000], dtype=np.int64)
    lists[5] = np.asarray([6], dtype=np.int64)
    g = CSRGraph.from_lists(lists)
    s = BVGraphSettings(residual_coding=C.GOLOMB, zeta_k=3, window_size=0,
                        min_interval_length=0)
    base = str(tmp_path / "gol")
    BVGraph.store(g, base, backend="python", settings=s)
    bv = BVGraph.load(base)
    cfg = vdecode.config_from_settings(bv.settings, batch=16)
    co, succ = vdecode.decode_to_csr(np.asarray(bv.data), bv.offsets, cfg,
                                     bvgraph=bv)
    exp = g.to_csr()
    np.testing.assert_array_equal(co, exp.offsets)
    np.testing.assert_array_equal(succ, exp.succ)
