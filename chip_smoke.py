#!/usr/bin/env python
"""Smoke run of the main path on one GPU.

    python chip_smoke.py           # one GPU: all phases below
    python chip_smoke.py --four    # four GPUs: the sharded kernel decode only

Phases (one process; any failure exits non-zero):

1. device: the first JAX device must be a GPU (no CPU fallback);
2. kernel check: a cnr-2000-shaped stand-in (325,557 nodes, ~3.2M arcs,
   generated from a seed, encoded with cnr-2000's settings w=7 maxref=3
   minint=3 zeta_3), the decode kernel compiled at its real widths, its
   compiled output equal to the Pallas interpreter's on a small graph, and
   the cold decode to a device CSR bit-exact against the generator;
3. main path at uk-2002 scale (18.5M nodes, ~355M arcs): native
   multithreaded encode, cold plan -> resolve_halos -> decode_to_csr, the
   device CSR bit-exact against the generator, then HyperBall on it;
4. other device paths: EF device decode and device encode on the stand-in,
   HyperBall registers against the sequential oracle on a small graph.

Every check is exact: all values are integers except HyperBall's count
estimates, which are computed on the host in float64 from registers that
must match exactly.  No matrix product is involved, so TF32 does not arise.

The last line of standard output is one JSON object naming the device.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from webgraph_tpu.utils.runtime import (gpu_name_power,  # noqa: E402
                                        require_gpu, setup_compile_cache)

UK_NODES = 18_500_000
SEED = 0


class _Clock:
    def __init__(self, phase):
        self.phase = phase
        self.t = time.time()

    def lap(self, what, **extra):
        now = time.time()
        info = "".join(f" {k}={v}" for k, v in extra.items())
        print(f"[{self.phase}] {what}: {now - self.t:.2f} s (set-up, "
              f"this card){info}", flush=True)
        self.t = now


def _encode(co, su, settings, threads):
    from webgraph_tpu import native
    graph, bits, offs_b, _ob, _st = native.bv_encode(co, su, settings,
                                                     threads=threads)
    n = len(co) - 1
    offsets = native.decode_offset_stream(offs_b, n, settings.offset_coding)
    return np.asarray(graph), bits, offsets


def _cold_decode(data, offsets, settings, clk):
    """Cold plan -> resolve_halos -> decode_to_csr, through the library's
    own entry points.  Returns (co, succ_dev, prep, passes)."""
    import jax

    from webgraph_tpu import native
    from webgraph_tpu.ops import kdecode as K

    outd = native.decode_outdegrees(data, offsets, settings.outdegree_coding)
    prep = K.plan_kernel_decode(offsets, outd, settings, data)
    assert prep is not None and prep.cold
    clk.lap("plan_kernel_decode", T=prep.spec.T, V=prep.spec.V,
            R=prep.spec.R)
    passes = K.resolve_halos(prep)
    jax.block_until_ready(prep.init_out)
    clk.lap("resolve_halos", resolve_passes=passes)
    co, succ, fill = K.decode_to_csr(prep, data=data, settings=settings)
    succ.block_until_ready()
    assert fill is None
    clk.lap("decode_to_csr (first call, compiles)")
    t0 = time.time()
    co, succ, _ = K.decode_to_csr(prep)
    succ.block_until_ready()
    print(f"  decode_to_csr steady state: {time.time() - t0:.4f} s")
    return co, succ, prep, passes


def _check_csr(co, succ_dev, exp_co, exp_su, what):
    ok_co = np.array_equal(np.asarray(co), exp_co)
    ok_su = np.array_equal(np.asarray(succ_dev).astype(np.int64), exp_su)
    print(f"  {what}: offsets bit-exact={ok_co} successors bit-exact={ok_su}")
    if not (ok_co and ok_su):
        sys.exit(f"FAIL: {what} is not bit-exact")


def _compile_report(data, offsets, settings):
    from webgraph_tpu import native
    from webgraph_tpu.ops import kdecode as K

    outd = native.decode_outdegrees(data, offsets, settings.outdegree_coding)
    prep = K.plan_kernel_decode(offsets, outd, settings, data)
    print(f"  spec: {prep.spec}")
    compiled = K.run_tiles.lower(prep.meta, prep.col, prep.init_out,
                                 spec=prep.spec, interpret=False).compile()
    print("  decode kernel memory_analysis:", compiled.memory_analysis())


def phase_kernel_check(settings):
    """Stand-in graph: compile, compiled vs interpret, cold decode."""
    import jax

    from webgraph_tpu.utils.synth import cnr2000_standin
    from tests.test_kdecode import check_compiled_matches_interpret

    clk = _Clock("kernel check")
    co, su = cnr2000_standin(seed=SEED)
    clk.lap("generate", n=len(co) - 1, m=int(co[-1]))
    data, bits, offsets = _encode(co, su, settings, threads=1)
    clk.lap("native encode (1 thread)",
            bits_per_link=round(bits / int(co[-1]), 4))

    check_compiled_matches_interpret()
    clk.lap("compiled kernel == interpreter on a small graph")

    _compile_report(data, offsets, settings)
    clk.lap("compile decode kernel at real widths")

    dco, dsu, prep, passes = _cold_decode(data, offsets, settings, clk)
    _check_csr(dco, dsu, co, su, "stand-in device CSR")
    del dsu, prep
    jax.clear_caches()
    return co, su, data


def phase_main_path(settings):
    """uk-2002-scale synthetic: encode, cold decode, HyperBall."""
    import jax

    from webgraph_tpu.algo.hyperball import HyperBall
    from webgraph_tpu.core.graph import CSRGraph
    from webgraph_tpu.ops import kdecode as K
    from webgraph_tpu.utils.synth import synthesize_webgraph

    clk = _Clock("main path")
    co, su = synthesize_webgraph(UK_NODES, seed=SEED)
    n, m = len(co) - 1, int(co[-1])
    clk.lap("generate", n=n, m=m)
    data, bits, offsets = _encode(co, su, settings,
                                  threads=os.cpu_count() or 1)
    clk.lap("native encode", threads=os.cpu_count(),
            bits_per_link=round(bits / m, 4))
    dco, dsu, prep, passes = _cold_decode(data, offsets, settings, clk)
    _check_csr(dco, dsu, co, su, "uk-scale device CSR")
    errs = K.check_diag(prep, np.asarray(K.decode_chunked(prep)[1]))
    print(f"  n={n} m={m} bits/link={bits / m:.4f} "
          f"fallback_arc_frac={K.fallback_arc_frac(prep, errs)} "
          f"resolve_passes={passes}")
    clk.lap("check")
    del prep
    hb = HyperBall(CSRGraph(dco, np.asarray(dsu).astype(np.int64)),
                   log2m=4)
    nf = hb.run(upper_bound=3)
    clk.lap("HyperBall log2m=4, 3 iterations")
    print(f"  neighbourhood function: {nf}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    del hb, dsu
    jax.clear_caches()


def phase_other_paths(settings, co, su, data):
    """EF device decode, device encode, HyperBall registers."""
    from webgraph_tpu.algo.hyperball import HyperBall, sequential_hyperball
    from webgraph_tpu.codecs.efgraph import EFGraph
    from webgraph_tpu.core.graph import CSRGraph
    from webgraph_tpu.ops import efdecode, vencode
    from webgraph_tpu.utils.synth import synthesize_webgraph

    clk = _Clock("other paths")
    with tempfile.TemporaryDirectory() as td:
        base = os.path.join(td, "ef")
        EFGraph.store(CSRGraph(co, su), base)
        ef = EFGraph.load(base)
        plan = efdecode.EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                                     ef.log2_quantum)
        eco, esu = plan.decode()
        _check_csr(np.asarray(eco).astype(np.int64), esu, co, su,
                   "EF device decode")
    clk.lap("EF store + device decode")

    plan = vencode.EncodeDevicePlan(co, su, settings)
    gbytes = plan.encode()[0]
    same = np.array_equal(np.frombuffer(gbytes, dtype=np.uint8), data)
    print(f"  device encode byte-identical to the native stream: {same}")
    if not same:
        sys.exit("FAIL: device encode differs from the native stream")
    clk.lap("device encode")

    sco, ssu = synthesize_webgraph(20_000, seed=SEED)
    g = CSRGraph(sco, ssu)
    hb = HyperBall(g, log2m=4)
    hb.run(upper_bound=3)
    oracle = sequential_hyperball(g, log2m=4, iterations=3)
    same = np.array_equal(np.asarray(hb.regs), oracle)
    print(f"  HyperBall registers == sequential oracle (3 iterations, "
          f"n=20000): {same}")
    if not same:
        sys.exit("FAIL: HyperBall registers differ from the oracle")
    clk.lap("HyperBall vs sequential oracle")


def phase_four(settings):
    """The sharded kernel decode on a 4-GPU mesh at uk scale."""
    import jax

    from webgraph_tpu.ops import kdecode as K
    from webgraph_tpu.parallel.sharded import decode_sharded_kernel, make_mesh
    from webgraph_tpu.utils.synth import synthesize_webgraph

    devs = jax.devices()
    if len(devs) < 4:
        sys.exit(f"FAIL: --four needs 4 GPUs, found {len(devs)}")
    clk = _Clock("four cards")
    co, su = synthesize_webgraph(UK_NODES, seed=SEED)
    n, m = len(co) - 1, int(co[-1])
    clk.lap("generate", n=n, m=m)
    data, bits, offsets = _encode(co, su, settings,
                                  threads=os.cpu_count() or 1)
    clk.lap("native encode", bits_per_link=round(bits / m, 4))
    prep = K.plan_kernel_decode(offsets, np.diff(co), settings, data,
                                halo_csr=(co, su))
    clk.lap("plan_kernel_decode (halo lists from the generator)",
            T=prep.spec.T)
    mesh = make_mesh(devs[:4])
    out, diag = decode_sharded_kernel(prep, mesh)
    jax.block_until_ready(out)
    clk.lap("decode_sharded_kernel (first call, compiles)")
    t0 = time.time()
    out, diag = decode_sharded_kernel(prep, mesh)
    jax.block_until_ready(out)
    print(f"  decode_sharded_kernel steady state: {time.time() - t0:.4f} s")
    per_dev = {}
    for sh in out.addressable_shards:
        rows = sh.index[0]
        per_dev[str(sh.device)] = (rows.start, rows.stop)
    print(f"  tile ranges per device: {per_dev}")
    if len(per_dev) != 4 or len({r for r in per_dev.values()}) != 4:
        sys.exit("FAIL: the tiles are not split over four devices")
    errs = K.check_diag(prep, np.asarray(diag))
    kco, ksu = K.chunked_to_csr(prep, np.asarray(out), data=data,
                                settings=settings, errs=errs)
    _check_csr(kco, ksu, co, su, "4-GPU sharded decode")
    clk.lap("check")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded kernel decode on 4 GPUs")
    args = ap.parse_args()

    dev = require_gpu()
    setup_compile_cache()
    import jax

    print(f"device: {dev.device_kind} | {gpu_name_power()}", flush=True)
    from webgraph_tpu.utils.synth import cnr2000_settings
    settings = cnr2000_settings()
    t0 = time.time()
    if args.four:
        phase_four(settings)
    else:
        co, su, data = phase_kernel_check(settings)
        phase_other_paths(settings, co, su, data)
        del co, su, data
        phase_main_path(settings)
    print(f"total: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
