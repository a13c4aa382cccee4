"""webgraph_tpu — a graph compression and analysis framework in JAX.

A from-scratch re-design of WebGraph (big) for accelerators (an NVIDIA
H200 through JAX, XLA and Pallas-Triton): BVGraph and EFGraph
codecs with vectorized JAX/XLA decode-encode engines, an out-of-core
transformation engine, device-parallel analytics, labelled and typed
graphs, and multi-chip data parallelism over jax.sharding meshes.

See SURVEY.md for the reference structural map this build follows.
"""

__version__ = "0.1.0"
