"""Real-content validation run: encode -> decode -> PSNR/bitrate.

The reference was validated on CDW-2014 changedetection.net clips
(reference README.md:81-97), which the repo does not ship and the
codec never downloads. This run substitutes real *photographic* content from
images shipped on the machine (scikit-learn's sample photographs): a CIF
clip made of a slow camera pan over a real photo with a real-texture
moving object composited on top — natural gradients, edges, and textures
rather than synthetic noise.

Pipeline exercised end to end through the PRODUCT surfaces: raw AVI write
-> encoder CLI -> decoder CLI (several quant configs) -> PSNR/bitrate +
a visualizer composite dump. Results are recorded in BASELINE.md.

Usage: JAX_PLATFORMS=cpu python benchmarks/real_content.py [outdir]
Prints one JSON line with the measured metrics.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
sys.path.insert(0, _REPO)

from svc_tpu.io.video import write_raw_avi  # noqa: E402
from svc_tpu.metrics import psnr  # noqa: E402

_IMAGES = [
    "/opt/venv/lib/python3.12/site-packages/sklearn/datasets/images/china.jpg",
    "/opt/venv/lib/python3.12/site-packages/sklearn/datasets/images/flower.jpg",
]


def make_real_clip(w: int = 352, h: int = 288, n: int = 24) -> np.ndarray:
    """CIF clip: 2 px/frame pan over a real photo + a moving real-texture
    object (a crop of the second photo)."""
    import cv2

    bg = cv2.imread(_IMAGES[0])
    obj = cv2.imread(_IMAGES[1])[140:220, 260:380]  # flower head crop
    if bg is None or obj is None:
        raise RuntimeError("sample photographs unavailable")

    frames = np.empty((n, h, w, 3), np.uint8)
    oh, ow = obj.shape[:2]
    for t in range(n):
        x0, y0 = 2 * t, t // 2  # global pan
        fr = bg[y0 : y0 + h, x0 : x0 + w].copy()
        ox, oy = 30 + 6 * t, 150 - 4 * t  # object motion vs pan: (6,-4)
        fr[oy : oy + oh, ox : ox + ow] = obj
        frames[t] = fr
    return frames


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/svc_real_content"
    os.makedirs(out_dir, exist_ok=True)
    clip = make_real_clip()
    avi = os.path.join(out_dir, "real_cif.avi")
    write_raw_avi(avi, clip)

    env = dict(os.environ)
    svc = os.path.join(out_dir, "real_cif.svc")
    with open(svc, "wb") as f:
        subprocess.run(
            [sys.executable, "-m", "svc_tpu.apps.encoder_app",
             "--visualize", os.path.join(out_dir, "views"), avi],
            stdout=f, stderr=subprocess.DEVNULL, check=True, env=env,
            cwd=_REPO,
        )

    results = {}
    src = clip[1:]  # payload frames (frame 0 is the reference frame)
    raw_bits = src.size * 8
    for name, args in {
        "default (fg 1 / bg 640)": [],
        "uniform fine (fg 1 / bg 8)": ["--background-quant-step", "8"],
        "gazed center": ["--gaze", "176,144"],
    }.items():
        out_npy = os.path.join(out_dir, f"dec_{name.split()[0]}.npy")
        subprocess.run(
            [sys.executable, "-m", "svc_tpu.apps.decoder_app",
             "--output", out_npy] + args,
            stdin=open(svc, "rb"), stderr=subprocess.DEVNULL, check=True,
            env=env, cwd=_REPO,
        )
        dec = np.load(out_npy)
        results[name] = round(float(psnr(dec, src)), 2)

    stream_bits = os.path.getsize(svc) * 8
    out = {
        "clip": "real-photo pan + moving object, CIF, 24 frames",
        "psnr_db": results,
        "stream_bits_per_pixel": round(
            stream_bits / (src.shape[0] * 352 * 288), 2
        ),
        "raw_bits_per_pixel": raw_bits / (src.shape[0] * 352 * 288),
        "views_dir": os.path.join(out_dir, "views"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
