"""Multi-chip scale-out over a ``jax.sharding.Mesh``.

The reference has no distributed backend at all (SURVEY.md §2.3) — its
only parallelism is SSE2 SIMD and a 3-thread host pipeline. This package
is the scale-out story: frame-batch sharding across the devices of a
host, with XLA collectives for cross-device statistics.
"""

from svc_tpu.parallel.sharding import ShardedEncoder, make_frame_mesh  # noqa: F401
