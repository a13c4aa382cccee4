"""CLI implementation.  See package docstring for the command map."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load(basename: str, mode: str = "standard"):
    # import inside commands: keeps --help fast and jax-free
    import webgraph_tpu.codecs.bvgraph  # noqa: F401  (registers classes)
    import webgraph_tpu.codecs.efgraph  # noqa: F401
    import webgraph_tpu.codecs.ascii  # noqa: F401
    import webgraph_tpu.labelling  # noqa: F401
    from webgraph_tpu.core import graph as core
    return core.load(basename, mode=mode)


def cmd_bvgraph(args) -> int:
    from webgraph_tpu.codecs.bvgraph import BVGraph
    if args.offsets:
        g = _load(args.source)
        offs = g.decode_offsets_from_stream()
        from webgraph_tpu.ops.bitio import BitWriter
        w = BitWriter()
        prev = 0
        for o in offs.tolist():
            g.settings.write_offset(w, o - prev)
            prev = o
        with open(args.source + ".offsets", "wb") as f:
            f.write(w.to_bytes())
        return 0
    if args.outdegrees:
        g = _load(args.source)
        g.write_outdegrees(args.source + ".outdegrees")
        return 0
    if args.obl:
        g = _load(args.source)
        print(g.write_offsets_cache(args.source))
        return 0
    dest = args.dest or args.source
    g = _load(args.source, mode="offline" if args.offline else "standard")
    BVGraph.store(g, dest, window_size=args.window_size,
                  max_ref_count=args.max_ref_count,
                  min_interval_length=args.min_interval_length,
                  zeta_k=args.zeta_k)
    return 0


def cmd_efgraph(args) -> int:
    from webgraph_tpu.codecs.efgraph import EFGraph
    g = _load(args.source, mode="offline" if args.offline else "standard")
    EFGraph.store(g, args.dest or args.source,
                  log2_quantum=args.log2_quantum,
                  upper_bound=args.upper_bound)
    return 0


def cmd_transform(args) -> int:
    from webgraph_tpu import transform as T
    from webgraph_tpu.core import graph as core
    g = _load(args.source)
    op = args.operation
    if op in ("transpose", "transposeOffline"):
        out = T.transpose_offline(g) if "Offline" in op else T.transpose(g)
    elif op in ("symmetrize", "symmetrizeOffline"):
        out = (T.symmetrize_offline(g) if "Offline" in op
               else T.symmetrize(g))
    elif op in ("simplify", "simplifyOffline"):
        out = T.simplify_offline(g) if "Offline" in op else T.simplify(g)
    elif op == "identity":
        out = g
    elif op in ("mapOffline", "map"):
        node_map = np.fromfile(args.map_file, dtype=">i8").astype(np.int64)
        out = T.map_offline(g, node_map)
    elif op == "union":
        out = T.union(g, _load(args.other))
    elif op == "compose":
        out = T.compose(g, _load(args.other))
    elif op in ("gray", "grayPerm", "lex", "lexPerm", "random"):
        if op.startswith("gray"):
            perm = T.gray_code_permutation(g)
        elif op.startswith("lex"):
            perm = T.lexicographical_permutation(g)
        else:
            perm = T.random_permutation(g, seed=args.seed)
        if op.endswith("Perm"):
            perm.astype(">i8").tofile(args.dest)
            return 0
        out = T.apply_permutation(g, perm)
    elif op == "arcfilter":
        if args.filter == "NO_LOOPS":
            out = T.filter_arcs(g, T.no_loops)
        else:
            raise SystemExit(f"unknown filter {args.filter}")
    else:
        raise SystemExit(f"unknown operation {op}")
    core.store(out, args.dest)
    if hasattr(out, "cleanup"):
        out.cleanup()
    return 0


def cmd_ascii(args) -> int:
    from webgraph_tpu.codecs.ascii import ASCIIGraph
    from webgraph_tpu.core import graph as core
    if args.to_ascii:
        g = _load(args.source)
        ASCIIGraph.store(g, args.dest)
    else:
        g = ASCIIGraph.load(args.source, mode="offline")
        core.store(g, args.dest)
    return 0


def cmd_scattered(args) -> int:
    from webgraph_tpu.codecs.scattered import ScatteredArcsASCIIGraph
    from webgraph_tpu.core import graph as core
    g = ScatteredArcsASCIIGraph(
        args.source if args.source != "-" else sys.stdin,
        symmetrize=args.symmetrize, no_loops=args.no_loops)
    core.store(g.batch_graph, args.dest)
    g.save_ids(args.dest + ".ids")
    g.batch_graph.cleanup()
    return 0


def cmd_stats(args) -> int:
    from webgraph_tpu.utils.stats import compute_stats, write_stats
    g = _load(args.source, mode="offline" if args.offline else "standard")
    comp = None
    if args.scc:
        from webgraph_tpu.algo import strongly_connected_components
        _, comp = strongly_connected_components(g.to_csr())
    s = compute_stats(g, component=comp)
    write_stats(s, args.dest or args.source)
    for k, v in s.items():
        if not isinstance(v, np.ndarray):
            print(f"{k}={v}")
    return 0


def cmd_hyperball(args) -> int:
    from webgraph_tpu.algo import HyperBall
    g = _load(args.source).to_csr()
    hb = HyperBall(g, log2m=args.log2m, seed=args.seed,
                   do_sum_of_distances=args.sum_of_distances,
                   do_sum_of_inverse_distances=args.harmonic)
    nf = hb.run(upper_bound=args.upper_bound, threshold=args.threshold)
    for t, v in enumerate(nf):
        print(f"{t}\t{v}")
    if args.harmonic and args.dest:
        np.asarray(hb.sum_of_inverse_distances).tofile(args.dest)
    return 0


def cmd_bfs(args) -> int:
    from webgraph_tpu.algo import bfs
    g = _load(args.source).to_csr()
    dist, rounds = bfs(g, [args.start])
    print(f"reached={int((dist >= 0).sum())} rounds={rounds}")
    if args.dest:
        dist.tofile(args.dest)
    return 0


def cmd_cc(args) -> int:
    from webgraph_tpu.algo import (compute_sizes, connected_components,
                                   sort_by_size)
    g = _load(args.source).to_csr()
    comp = connected_components(g)
    if args.sort_by_size:
        comp = sort_by_size(comp)
    sizes = compute_sizes(comp)
    print(f"components={len(sizes)} largest={int(sizes.max())}")
    if args.dest:
        comp.tofile(args.dest)
    return 0


def cmd_scc(args) -> int:
    from webgraph_tpu.algo import scc_sizes, strongly_connected_components
    g = _load(args.source).to_csr()
    k, comp = strongly_connected_components(g)
    sizes = scc_sizes(comp)
    print(f"components={k} largest={int(sizes.max())}")
    if args.dest:
        comp.tofile(args.dest)
    return 0


def cmd_speedtest(args) -> int:
    """Decode-speed harness (test/SpeedTest.java:44-145: warmup + timed
    reps, sequential scan or random access, reports ns/link)."""
    g = _load(args.source, mode="mapped" if args.mapped else "standard")
    n, m = g.num_nodes, g.num_arcs
    rng = np.random.default_rng(0)
    if args.random is not None:
        nodes = rng.integers(0, n, args.random)
        for _ in range(args.warmup):
            for x in nodes[:100]:
                g.successors(int(x))
        times = []
        for _ in range(args.repeat):
            t0 = time.time()
            links = 0
            for x in nodes:
                links += len(g.successors(int(x)))
            times.append((time.time() - t0) / max(links, 1))
        best = min(times)
        print(f"{best * 1e9:.2f} ns/link")
    else:
        from webgraph_tpu import native
        from webgraph_tpu.ops import kdecode as K
        data = np.asarray(g.data)
        outd = native.decode_outdegrees(data, g.offsets,
                                        g.settings.outdegree_coding)
        prep = K.plan_kernel_decode(g.offsets, outd, g.settings, data)
        if prep is None:
            print("speedtest: settings outside the decode kernel's envelope")
            return 1
        # warm-up: cold halo resolve, compilation and the host fill
        K.decode_to_csr(prep, data=data, settings=g.settings)
        times = []
        for _ in range(args.repeat):
            t0 = time.time()
            K.decode_to_csr(prep)[1].block_until_ready()
            times.append(time.time() - t0)
        best = min(times)
        print(f"{best / m * 1e9:.2f} ns/link  "
              f"({m / best / 1e6:.1f} M links/s)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="webgraph_tpu",
        description="WebGraph framework command line (JAX on the GPU)")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("bvgraph", help="compress to / manage BVGraph")
    b.add_argument("source")
    b.add_argument("dest", nargs="?")
    b.add_argument("-w", "--window-size", type=int, default=-1)
    b.add_argument("-m", "--max-ref-count", type=int, default=-1)
    b.add_argument("-i", "--min-interval-length", type=int, default=-1)
    b.add_argument("-k", "--zeta-k", type=int, default=-1)
    b.add_argument("-o", "--offline", action="store_true")
    b.add_argument("-O", "--offsets", action="store_true",
                   help="regenerate the offsets file")
    b.add_argument("-d", "--outdegrees", action="store_true",
                   help="dump the outdegree stream")
    b.add_argument("-L", "--obl", action="store_true",
                   help="write the .obl Elias-Fano offsets cache")
    b.set_defaults(fn=cmd_bvgraph)

    e = sub.add_parser("efgraph", help="compress to EFGraph")
    e.add_argument("source")
    e.add_argument("dest", nargs="?")
    e.add_argument("-q", "--log2-quantum", type=int, default=8)
    e.add_argument("-u", "--upper-bound", type=int, default=-1)
    e.add_argument("-o", "--offline", action="store_true")
    e.set_defaults(fn=cmd_efgraph)

    t = sub.add_parser("transform", help="graph transformations")
    t.add_argument("operation", choices=[
        "identity", "transpose", "transposeOffline", "symmetrize",
        "symmetrizeOffline", "simplify", "simplifyOffline", "mapOffline",
        "union", "compose", "gray", "grayPerm", "lex", "lexPerm", "random",
        "arcfilter"])
    t.add_argument("source")
    t.add_argument("dest")
    t.add_argument("--other", help="second graph (union/compose)")
    t.add_argument("--map-file", help="binary big-endian longs (mapOffline)")
    t.add_argument("--filter", default="NO_LOOPS")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_transform)

    a = sub.add_parser("ascii", help="ASCII graph conversion")
    a.add_argument("source")
    a.add_argument("dest")
    a.add_argument("--to-ascii", action="store_true")
    a.set_defaults(fn=cmd_ascii)

    sc = sub.add_parser("scattered", help="scattered arc-list ingestion")
    sc.add_argument("source", help="file or - for stdin")
    sc.add_argument("dest")
    sc.add_argument("--symmetrize", action="store_true")
    sc.add_argument("--no-loops", action="store_true")
    sc.set_defaults(fn=cmd_scattered)

    st = sub.add_parser("stats", help="graph statistics")
    st.add_argument("source")
    st.add_argument("dest", nargs="?")
    st.add_argument("--scc", action="store_true")
    st.add_argument("-o", "--offline", action="store_true")
    st.set_defaults(fn=cmd_stats)

    h = sub.add_parser("hyperball", help="approximate neighbourhood function")
    h.add_argument("source")
    h.add_argument("dest", nargs="?")
    h.add_argument("-l", "--log2m", type=int, default=6)
    h.add_argument("-s", "--seed", type=int, default=0)
    h.add_argument("-u", "--upper-bound", type=int, default=-1)
    h.add_argument("-t", "--threshold", type=float, default=-1)
    h.add_argument("--sum-of-distances", action="store_true")
    h.add_argument("--harmonic", action="store_true")
    h.set_defaults(fn=cmd_hyperball)

    bf = sub.add_parser("bfs", help="parallel breadth-first visit")
    bf.add_argument("source")
    bf.add_argument("dest", nargs="?")
    bf.add_argument("-s", "--start", type=int, default=0)
    bf.set_defaults(fn=cmd_bfs)

    c = sub.add_parser("cc", help="connected components (symmetric graph)")
    c.add_argument("source")
    c.add_argument("dest", nargs="?")
    c.add_argument("--sort-by-size", action="store_true")
    c.set_defaults(fn=cmd_cc)

    s2 = sub.add_parser("scc", help="strongly connected components")
    s2.add_argument("source")
    s2.add_argument("dest", nargs="?")
    s2.set_defaults(fn=cmd_scc)

    sp = sub.add_parser("speedtest", help="decode speed harness")
    sp.add_argument("source")
    sp.add_argument("-r", "--random", type=int, default=None,
                    help="random-access test over N nodes")
    sp.add_argument("-R", "--repeat", type=int, default=3)
    sp.add_argument("-W", "--warmup", type=int, default=1)
    sp.add_argument("--mapped", action="store_true")
    sp.set_defaults(fn=cmd_speedtest)

    args = p.parse_args(argv)
    from webgraph_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
