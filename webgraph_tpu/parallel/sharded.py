"""Multi-device data-parallel decode over a device mesh.

The device analogue of the reference's multithread node-range
parallelism (BVGraph parallel compression/decompression via
splitNodeIterators, BVGraph.java:2406-2483; SURVEY §2.11): the kernel
plan's lane tiles are split over the devices of a ``jax.sharding.Mesh``
and each device decodes its share under ``shard_map``.  Chunks carry their
own halo lists, so no device needs another's output.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "decode_sharded_kernel"]


def make_mesh(devices=None, axis: str = "chunks") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def decode_sharded_kernel(prep, mesh: Mesh, interpret: Optional[bool] = None):
    """Shard the Pallas kernel decode's lane-tiles over a device mesh.

    The kernel plan (ops.kdecode.PreparedDecode) already cuts the graph into
    independent lane-chunks with pre-injected halos, so data parallelism is
    communication-free: each device runs its share of the tiles (the
    multi-chip analogue of the reference's splitNodeIterators node ranges,
    ImmutableGraph.java:405; per-thread output concatenation
    BVGraph.java:2432-2483 becomes the node-ordered gather of the sharded
    output columns).  Returns (out_cols, diag) sharded over the mesh, their
    leading tile dim T rounded up to a multiple of the mesh size (the
    trailing tiles are empty); feed them to ``kdecode.check_diag`` /
    ``kdecode.chunked_to_csr`` exactly like the single-chip path.
    """
    from ..ops import kdecode as K

    if interpret is None:
        interpret = K.kernel_mode()
    D = mesh.devices.size
    axis = mesh.axis_names[0]
    spec = prep.spec
    T = spec.T
    Tp = -(-T // D) * D
    meta, col, init = prep.meta, prep.col, prep.init_out
    if Tp != T:
        # pad with empty tiles: meta[0] == 0 lanes go straight to ST_DONE
        def pad(a):
            z = jnp.zeros((Tp - T,) + a.shape[1:], a.dtype)
            return jnp.concatenate([a, z])
        meta, col, init = pad(meta), pad(col), pad(init)
    sh = lambda: NamedSharding(mesh, P(axis))  # noqa: E731
    meta = jax.device_put(meta, sh())
    col = jax.device_put(col, sh())
    init = jax.device_put(init, sh())

    return _sharded_decoder(spec, mesh, interpret)(meta, col, init)


@functools.lru_cache(maxsize=None)
def _sharded_decoder(spec, mesh: Mesh, interpret: bool):
    """jit(shard_map(kernel launch over each device's tiles)), built once
    per (spec, mesh)."""
    from jax import shard_map

    from ..ops import kdecode as K

    axis = mesh.axis_names[0]

    def shard_fn(m, c, i):
        return K.run_tiles(m, c, i, spec, interpret)

    return jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    ))
