"""Double-buffered H2D staging: overlap the host->device copy of batch
``i+1`` with the device compute of batch ``i``.

The reference overlaps input I/O with encode via its reader thread +
bounded queue (apps/encoder.cpp:125-149, queue cap 10); the batched
analog overlaps the host->device TRANSFER with compute. A staging call
(``jax.device_put`` of the batch) is submitted on a
worker thread as soon as a batch's host frames are assembled; the main
thread dispatches device compute on the PREVIOUSLY staged batch and only
then collects the new one — so at steady state the copy engine streams
batch ``i+1`` while the cores run batch ``i``, and throughput is bounded
by ``max(transfer, compute)`` instead of their sum.

One batch of lookahead is deliberate: a deeper queue buys nothing (the
copy engine is serial) and costs device memory — each staged 1080p/16
batch holds ~100 MB of HBM.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable, Optional


class DoubleBufferedStager:
    """Stage host batches one ahead of compute.

    Args:
      stage_fn: host array -> device array in the consumer program's
        canonical layout (e.g. ``Encoder.stage_frames``). Runs on the
        worker thread; JAX transfers are thread-safe.
    """

    def __init__(self, stage_fn: Callable[[Any], Any]):
        self._stage = stage_fn
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="svc-stager"
        )
        self._pending: Optional[concurrent.futures.Future] = None

    def submit(self, host_batch) -> None:
        """Begin staging ``host_batch``; at most one may be pending."""
        if self._pending is not None:
            raise RuntimeError(
                "a staged batch is already pending; collect() it first"
            )
        self._pending = self._pool.submit(self._stage, host_batch)

    def collect(self):
        """Wait for and return the pending staged batch."""
        if self._pending is None:
            raise RuntimeError("no staged batch pending")
        fut, self._pending = self._pending, None
        return fut.result()

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
