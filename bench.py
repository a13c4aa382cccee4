#!/usr/bin/env python
"""BVGraph cold decode to a device CSR on one GPU.

Decodes two generated graphs with the lane-per-chunk Pallas kernel
(webgraph_tpu.ops.kdecode):

- a cnr-2000-shaped stand-in (325,557 nodes, ~3.2M arcs, cnr-2000's
  settings w=7 maxref=3 minint=3 zeta_3), which also times the EF device
  decode and the device encoder;
- the uk-2002-scale synthetic (BENCH_SYNTH_NODES, default 18.5M nodes /
  ~355M arcs; 0 skips it).

The plan is COLD: built from the stream, offsets and settings alone (native
header-only ref scan + on-device wavefront halo resolution + device-argsort
hub finalize).  The generator's CSR is the oracle, compared after timing.
plan_s / resolve_s / warm_s are one-time set-up; decode and decode_to_csr
are medians of 3 steady-state calls, each ending in block_until_ready.

Output: one JSON line with every result, then the headline JSON line; both
name the device (platform, device_kind, count) and the card's name and
power limit.  Without a GPU the script exits non-zero.

Env knobs: BENCH_TARGET_ARCS / BENCH_VCAP / BENCH_RCAP (default
128/512/160), BENCH_SYNTH_NODES.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from webgraph_tpu.utils.runtime import (gpu_name_power,  # noqa: E402
                                        require_gpu, setup_compile_cache)


def _log(*a):
    if os.environ.get("BENCH_VERBOSE"):
        print(*a, file=sys.stderr, flush=True)


def _median_time(fn, k=3):
    times = []
    for _ in range(k):
        t0 = time.time()
        r = fn()
        r.block_until_ready()
        times.append(time.time() - t0)
    return sorted(times)[k // 2]


def encode(co, su, settings, threads):
    """Native encode -> (stream bytes, bits, bit offsets)."""
    from webgraph_tpu import native
    graph, bits, offs_b, _ob, _st = native.bv_encode(co, su, settings,
                                                     threads=threads)
    offsets = native.decode_offset_stream(offs_b, len(co) - 1,
                                          settings.offset_coding)
    return np.asarray(graph), bits, offsets


def bench_graph(co, su, data, offsets, settings, target_arcs, v_cap,
                r_cap):
    """Cold plan + timed decode of one encoded graph; the generator's CSR
    (co, su) is the oracle."""
    import jax
    import jax.numpy as jnp

    from webgraph_tpu import native
    from webgraph_tpu.algo import hyperball as HB
    from webgraph_tpu.ops import kdecode as K

    m = int(co[-1])
    t0 = time.time()
    outd = native.decode_outdegrees(data, offsets, settings.outdegree_coding)
    prep = K.plan_kernel_decode(offsets, outd, settings, data,
                                target_arcs_per_lane=target_arcs,
                                v_cap=v_cap, r_cap=r_cap)
    plan_s = time.time() - t0
    if prep is None:
        raise RuntimeError("config outside kernel envelope")
    t0 = time.time()
    passes = K.resolve_halos(prep)
    jax.block_until_ready(prep.init_out)
    resolve_s = time.time() - t0
    _log(f"plan {plan_s:.2f}s resolve {resolve_s:.2f}s ({passes} passes)")

    # first decode_to_csr: compiles and caches the host fill of any lanes
    # outside the device envelope
    t0 = time.time()
    dco, succ, _ = K.decode_to_csr(prep, data=data, settings=settings)
    succ.block_until_ready()
    warm_s = time.time() - t0
    succ = None
    errs = K.check_diag(prep, np.asarray(K.decode_chunked(prep)[1]))

    decode_s = _median_time(lambda: K.decode_chunked(prep)[0])
    csr_s = _median_time(lambda: K.decode_to_csr(prep)[1])

    # one HyperBall round consuming the device CSR (decode -> analytics
    # with no host roundtrip; HyperBall.java:654-900)
    _, succ, _ = K.decode_to_csr(prep)
    regs = HB.pack_registers(jnp.asarray(HB.hyperloglog_init(len(co) - 1,
                                                             4)))
    hb_plan = HB.DenseRoundPlan(dco, succ)
    HB.device_round(dco, succ, regs, plan=hb_plan).block_until_ready()
    hb_s = _median_time(lambda: HB.device_round(dco, succ, regs,
                                                plan=hb_plan), k=1)
    del regs, hb_plan

    ok = (np.array_equal(np.asarray(succ).astype(np.int64), su)
          and np.array_equal(np.asarray(dco), co))
    return dict(plan_s=plan_s, resolve_s=resolve_s, resolve_passes=passes,
                warm_s=warm_s, bit_exact=bool(ok),
                decode_s=decode_s, decode_Medges_per_s=m / decode_s / 1e6,
                csr_s=csr_s, decode_to_csr_Medges_per_s=m / csr_s / 1e6,
                hyperball_round_s=hb_s,
                fallback_arc_frac=K.fallback_arc_frac(prep, errs),
                spec=dict(T=prep.spec.T, V=prep.spec.V, R=prep.spec.R))


def bench_ef(co, su):
    """EFGraph device decode rate."""
    from webgraph_tpu.codecs.efgraph import EFGraph
    from webgraph_tpu.core.graph import CSRGraph
    from webgraph_tpu.ops import efdecode

    with tempfile.TemporaryDirectory() as td:
        base = os.path.join(td, "ef")
        t0 = time.time()
        EFGraph.store(CSRGraph(co, su), base)
        enc_s = time.time() - t0
        ef = EFGraph.load(base)
        t0 = time.time()
        plan = efdecode.EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                                     ef.log2_quantum)
        _, succ = plan.decode()
        succ.block_until_ready()
        warm_s = time.time() - t0
        dec_s = _median_time(lambda: plan.decode()[1])
        ok = np.array_equal(np.asarray(succ).astype(np.int64), su)
    return dict(encode_s=enc_s, warm_s=warm_s,
                decode_Medges_per_s=len(su) / dec_s / 1e6, bit_exact=ok)


def bench_device_encode(co, su, settings, golden_bytes):
    """Device encoder: CSR -> BVGraph stream, byte-identical to the
    single-thread native stream."""
    from webgraph_tpu.ops import vencode

    t0 = time.time()
    plan = vencode.EncodeDevicePlan(co, su, settings)
    gbytes = plan.encode()[0]
    warm_s = time.time() - t0
    t0 = time.time()
    gbytes, gbits = plan.encode()[:2]
    enc_s = time.time() - t0
    same = np.array_equal(np.frombuffer(gbytes, dtype=np.uint8),
                          np.asarray(golden_bytes, dtype=np.uint8))
    return dict(warm_s=warm_s, encode_Medges_per_s=len(su) / enc_s / 1e6,
                bits_per_link=gbits / max(len(su), 1), byte_identical=same)


def main():
    dev = require_gpu()
    setup_compile_cache()
    import jax

    from webgraph_tpu.utils.synth import (cnr2000_settings, cnr2000_standin,
                                          synthesize_webgraph)

    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), card=gpu_name_power())
    target_arcs = int(os.environ.get("BENCH_TARGET_ARCS", 128))
    v_cap = int(os.environ.get("BENCH_VCAP", 512))
    r_cap = int(os.environ.get("BENCH_RCAP", 160))
    settings = cnr2000_settings()
    threads = os.cpu_count() or 1

    co, su = cnr2000_standin()
    m = int(co[-1])
    t0 = time.time()
    data, bits, offsets = encode(co, su, settings, threads=1)
    enc_s = time.time() - t0
    standin = bench_graph(co, su, data, offsets, settings, target_arcs,
                          v_cap, r_cap)
    standin.update(nodes=len(co) - 1, arcs=m,
                   encode_1thread_Medges_per_s=m / enc_s / 1e6,
                   encode_bits_per_link=bits / m)
    results = {"device": device, "cnr2000_standin": standin,
               "cnr2000_standin_device_encode": bench_device_encode(
                   co, su, settings, data),
               "cnr2000_standin_ef": bench_ef(co, su)}
    head = ("bvgraph_cold_decode_cnr2000_standin_edges_per_sec",
            standin["decode_Medges_per_s"])

    synth_nodes = int(os.environ.get("BENCH_SYNTH_NODES", 18_500_000))
    if synth_nodes:
        t0 = time.time()
        co, su = synthesize_webgraph(synth_nodes)
        gen_s = time.time() - t0
        m = int(co[-1])
        t0 = time.time()
        data, bits, offsets = encode(co, su, settings, threads)
        enc_s = time.time() - t0
        synth = bench_graph(co, su, data, offsets, settings, target_arcs,
                            v_cap, r_cap)
        synth.update(nodes=len(co) - 1, arcs=m, gen_s=gen_s,
                     encode_Medges_per_s=m / enc_s / 1e6,
                     encode_threads=threads, encode_bits_per_link=bits / m)
        results["synthetic"] = synth
        head = ("bvgraph_cold_decode_uk2002scale_edges_per_sec",
                synth["decode_Medges_per_s"])

    if not all(r.get("bit_exact", r.get("byte_identical", True))
               for r in results.values() if isinstance(r, dict)):
        sys.exit("FAIL: a result is not exact: " + json.dumps(results))
    print(json.dumps(results, default=str))
    print(json.dumps({"metric": head[0], "value": head[1],
                      "unit": "Medges/s", "device": device}))


if __name__ == "__main__":
    main()
