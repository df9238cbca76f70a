"""Build and time the C++ reference encoder on the host CPU (BASELINE.md).

The reference publishes no numbers (reference README.md has only result
videos), so the measurable baseline is the reference binary itself, built
from the unmodified sources via tests/golden/build_reference_apps.sh and
timed on the same synthetic clips the codec's benchmarks use. Output goes to
/dev/null so the number is video-decode + encode compute, not disk
bandwidth (the 1080p bitstream is ~25 MB/frame).

Usage: python benchmarks/bench_reference.py
Prints one JSON line: {"cif_fps": N, "hd1080_fps": N, "host": "..."}
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
sys.path.insert(0, _REPO)

from benchmarks.clips import make_clip  # noqa: E402
from svc_tpu.io.video import write_y4m_video  # noqa: E402

OUT = "/tmp/refbin"
CLIPDIR = "/tmp/svc_bench_clips"


def _time_encode(binary: str, clip: str, frames: int, repeats: int = 3) -> float:
    best = float("inf")
    with open(os.devnull, "wb") as devnull:
        for _ in range(repeats):
            t0 = time.perf_counter()
            subprocess.run(
                [binary, clip], stdout=devnull, stderr=subprocess.DEVNULL,
                check=True,
            )
            best = min(best, time.perf_counter() - t0)
    # the first frame is consumed as the tracked-only reference
    # (encoder.cpp:360-381): frames-1 encoded frames
    return (frames - 1) / best


def main() -> None:
    subprocess.run(
        ["sh", os.path.join(_REPO, "tests", "golden", "build_reference_apps.sh"), OUT],
        check=True,
    )
    os.makedirs(CLIPDIR, exist_ok=True)
    n = 32
    cif = os.path.join(CLIPDIR, "cif.y4m")
    hd = os.path.join(CLIPDIR, "hd1080.y4m")
    if not os.path.exists(cif):
        write_y4m_video(cif, make_clip(352, 288, n))
    if not os.path.exists(hd):
        write_y4m_video(hd, make_clip(1920, 1080, n))

    enc = os.path.join(OUT, "ref_encoder")
    cif_fps = _time_encode(enc, cif, n)
    hd_fps = _time_encode(enc, hd, n)
    print(
        json.dumps(
            {
                "cif_fps": round(cif_fps, 2),
                "hd1080_fps": round(hd_fps, 2),
                "host": platform.platform(),
                "cores": os.cpu_count(),
            }
        )
    )


if __name__ == "__main__":
    main()
