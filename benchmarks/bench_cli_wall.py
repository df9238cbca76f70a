"""Wall-clock CLI benchmark at any geometry: the full host-inclusive path.

bench.py measures the on-device pipeline; this bench instead times the
product surfaces end to end — encoder CLI (container read, device encode,
native serialize, file write) and decoder CLI (reader thread, parse,
device decode, D2H fetch, file write) — with ``time.perf_counter`` around
the subprocesses. The first run pays interpreter startup + compile
(reported separately as *_cold_s); the second run is the steady wall
number. Every frame's pixels and its raw-float32 wire coefficients cross
the host link, so the big geometries are bound by transfers and disk.

Usage: python benchmarks/bench_cli_wall.py [n_frames] [width] [height]
Defaults: 200 frames of CIF 352x288. Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
sys.path.insert(0, _REPO)

from svc_tpu.io.video import write_raw_avi  # noqa: E402


def make_clip(n: int, w: int, h: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, ((h + 128) // 4, (w + 128) // 4))
    base = np.kron(coarse, np.ones((4, 4))).astype(np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    s = min(48, h // 4, w // 4)
    for i in range(n):
        p = i % 64  # pan loops inside the oversized base texture
        f = base[p : p + h, 2 * p : 2 * p + w].copy()
        x = (w // 4 + 5 * (i % 40)) % (w - s)
        f[h // 5 : h // 5 + s, x : x + s] = base[:s, :s]
        frames[i] = np.repeat(f[..., None], 3, -1)
    return frames


def _run(cmd, **kw):
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=_REPO, **kw)
    return time.perf_counter() - t0


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 352
    h = int(sys.argv[3]) if len(sys.argv) > 3 else 288
    batch = min(16, max(4, n - 1))
    out_dir = f"/tmp/svc_cli_wall_{w}x{h}"
    os.makedirs(out_dir, exist_ok=True)
    avi = os.path.join(out_dir, "clip.avi")
    svc = os.path.join(out_dir, "clip.svc")
    npy = os.path.join(out_dir, "clip_dec.npy")
    write_raw_avi(avi, make_clip(n, w, h))

    env = dict(os.environ)
    quiet = {"stderr": subprocess.DEVNULL}

    def encode():
        with open(svc, "wb") as f:
            return _run(
                [sys.executable, "-m", "svc_tpu.apps.encoder_app",
                 "--batch-size", str(batch), avi],
                stdout=f, env=env, **quiet,
            )

    def decode():
        return _run(
            [sys.executable, "-m", "svc_tpu.apps.decoder_app",
             "--batch-size", str(batch), "--input", svc, "--output", npy],
            env=env, **quiet,
        )

    # first run pays interpreter startup + compile; report steady wall
    enc_cold, dec_cold = encode(), decode()
    enc_warm, dec_warm = encode(), decode()

    payloads = n - 1
    print(
        json.dumps(
            {
                "clip": f"{w}x{h}, {n} frames",
                "encode_wall_fps": round(payloads / enc_warm, 2),
                "decode_wall_fps": round(payloads / dec_warm, 2),
                "encode_cold_s": round(enc_cold, 1),
                "decode_cold_s": round(dec_cold, 1),
                "stream_mb": round(os.path.getsize(svc) / 2**20, 1),
            }
        )
    )
    for f in (avi, svc, npy):
        if os.path.exists(f):
            os.remove(f)


if __name__ == "__main__":
    main()
