"""Tracing / profiling harness.

The reference's only observability is a verbose flag printing video
properties and the visualizer window (SURVEY.md §5). This module adds the
observability surface a production codec needs:

* ``Tracer`` — lightweight wall-clock span recorder with JSON export and
  per-stage aggregate stats (count/total/mean/max),
* ``device_profile`` — context manager around ``jax.profiler.trace`` for
  full XLA device traces viewable in TensorBoard/Perfetto,
* throughput accounting used by the apps' ``--trace`` flag.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


class Tracer:
    """Wall-clock span recorder.

    >>> tracer = Tracer()
    >>> with tracer.span("encode"):
    ...     pass
    >>> tracer.stats()["encode"]["count"]
    1
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[Dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.events.append(
                {
                    "name": name,
                    "start_s": t0,
                    "duration_s": time.perf_counter() - t0,
                    **attrs,
                }
            )

    def stats(self) -> Dict[str, Dict[str, float]]:
        agg: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0}
        )
        for e in self.events:
            s = agg[e["name"]]
            s["count"] += 1
            s["total_s"] += e["duration_s"]
            s["max_s"] = max(s["max_s"], e["duration_s"])
        for s in agg.values():
            s["mean_s"] = s["total_s"] / max(s["count"], 1)
        return dict(agg)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"events": self.events, "stats": self.stats()}, f, indent=2
            )

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats().items()):
            lines.append(
                f"{name:24s} n={s['count']:<5d} total={s['total_s']:8.3f}s "
                f"mean={s['mean_s'] * 1000:8.2f}ms max={s['max_s'] * 1000:8.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_profile(log_dir: Optional[str]) -> Iterator[None]:
    """XLA device trace via ``jax.profiler`` when a dir is given."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
