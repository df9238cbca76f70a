#!/usr/bin/env python3
"""Run the codec's main path on one NVIDIA GPU and check what comes out.

Usage::

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded apps only

Phases (one card):

1. card-only tests: ``pytest -m gpu`` in a child process that finishes
   before this process opens the card (one JAX process per card);
2. device: refuse to go on unless JAX's first device is a GPU;
3. compile: the 1080p/16 and 4K/8 encode and decode steps, with compile
   seconds, ``memory_analysis()`` and the compiled boundary layouts;
4. apps: a seeded 33-frame 1080p clip and a 9-frame 4K clip through
   ``encoder_app`` and then ``decoder_app --gaze``, each called as
   ``main(argv)``: a warm-up run, then a timed run, and a check that the
   gaze region of the decoded frames matches the source;
5. parity: a 1080p encode batch on the card against the same jitted
   program on the host CPU backend (motion field, foreground masks and
   block types byte-equal, coefficients within 2.5e-4, decoded display
   bytes within 1), and the stage DCT/IDCT against ``scipy.fft`` in
   float64 at 1080p.

``--four-cards`` runs ``encoder_app --devices 4`` and ``decoder_app
--devices 4`` on the 1080p clip and compares their output byte for byte
with the one-card apps.

Every phase that fails raises; the script then exits non-zero and prints
no result line. The last line of a good run is one JSON object naming the
device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the reference's default codec configuration at the sizes users run
CLIPS = {
    "1080p": dict(w=1920, h=1080, frames=33, batch=16, gaze=(960, 540)),
    "4k": dict(w=3840, h=2160, frames=9, batch=8, gaze=(1920, 1080)),
}
COEFF_GATE = 2.5e-4  # README parity gate on DCT coefficients
SEED = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu(jax_module):
    """The first JAX device, refusing any backend but a GPU."""
    devices = jax_module.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (first device: {devices[0].platform}); "
            "this check runs only on an NVIDIA card"
        )
    return devices


def run_card_tests() -> None:
    """The ``gpu``-marked tests, in a child that owns the card while it
    runs; it must pass every one of them and skip none."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "gpu_tests.xml")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [
                sys.executable, "-m", "pytest", "tests/", "-q", "-m", "gpu",
                "-p", "no:cacheprovider", "-rs", f"--junitxml={report}",
            ],
            cwd=REPO,
            env=env,
            capture_output=True,
            text=True,
            timeout=900,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-16000:] + proc.stderr[-4000:])
            raise RuntimeError(f"card-only tests failed (rc {proc.returncode})")
        log("\n".join(proc.stdout.strip().splitlines()[-3:]))
        import xml.etree.ElementTree as ET

        suite = ET.parse(report).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
        if n == 0 or skipped:
            raise RuntimeError(
                f"card-only tests: {n} collected, {skipped} skipped"
            )
    log(f"card-only tests: {n} passed in {time.perf_counter() - t0:.1f} s")


def _encoder(clip, batch=None):
    from svc_tpu.config import EncoderConfig, VideoProperties
    from svc_tpu.models.encoder import Encoder

    t = batch or clip["batch"]
    return Encoder(
        EncoderConfig(),
        VideoProperties(clip["w"], clip["h"], t + 1),
        batch_size=t,
    )


def _row_major(fmt) -> bool:
    m2m = fmt.layout.major_to_minor
    return tuple(m2m) == tuple(range(len(m2m)))


def compile_steps(jax, card: str) -> None:
    """Compile each size's encode and decode step; report time, memory
    and whether the boundary layouts XLA chose are row-major."""
    import numpy as np

    from svc_tpu.config import DecoderConfig
    from svc_tpu.models.decoder import Decoder

    for name, clip in CLIPS.items():
        t = clip["batch"]
        enc = _encoder(clip)
        dec = Decoder(DecoderConfig(), enc.header(), batch_size=t)
        packed = jax.device_put(
            np.zeros((t + 1, clip["h"], clip["w"] * 3), np.uint8)
        )
        keys = enc._keys(0, t)
        nby, nbx = enc.padded_h // 8, enc.padded_w // 8
        steps = {
            "encode": (enc._encode_batch, (packed, keys)),
            "decode": (
                dec._decode_batch,
                (
                    jax.ShapeDtypeStruct((t, nby, nbx, 192), np.float32),
                    jax.ShapeDtypeStruct((t, nby, nbx), np.uint32),
                    jax.ShapeDtypeStruct((t, 4), np.int32),
                ),
            ),
        }
        for kind, (fn, args) in steps.items():
            t0 = time.perf_counter()
            compiled = fn.lower(*args).compile()
            secs = time.perf_counter() - t0
            ins = compiled.input_formats[0]
            outs = jax.tree_util.tree_leaves(compiled.output_formats)
            row_major = all(_row_major(f) for f in (*ins, *outs))
            mem = compiled.memory_analysis()
            mem = (
                f"args {mem.argument_size_in_bytes / 2**20:.0f} MiB, "
                f"out {mem.output_size_in_bytes / 2**20:.0f} MiB, "
                f"temp {mem.temp_size_in_bytes / 2**20:.0f} MiB"
                if mem is not None
                else "not reported"
            )
            log(
                f"compile {name}/{t} {kind}: {secs:.1f} s on {card}; "
                f"boundary layouts row-major without pins: {row_major}; "
                f"memory: {mem}"
            )


def _write_clip(tmp, name, clip):
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from clips import make_clip

    frames = make_clip(clip["w"], clip["h"], clip["frames"], seed=SEED)
    path = os.path.join(tmp, f"{name}.npy")
    np.save(path, frames)
    return frames, path


def _gaze_psnr(decoded, source, header, gaze, dec_cfg) -> float:
    """PSNR inside the gaze rectangle, where the quant step is 1: the
    decoded frames against the source put through the same display
    resample (the whole padded frame squeezed to the display size)."""
    import numpy as np

    from svc_tpu.metrics import psnr
    from svc_tpu.models.decoder import gaze_rect_from_center
    from svc_tpu.ops.resize import bilinear_axis_weights

    ph, pw = header.padded_frame_h, header.padded_frame_w
    padded = np.zeros((source.shape[0], ph, pw, 3), np.float32)
    padded[:, : header.frame_h, : header.frame_w] = source
    y0, y1, fy, _ = bilinear_axis_weights(header.frame_h, ph)
    x0, x1, fx, _ = bilinear_axis_weights(header.frame_w, pw)
    fy, fx = fy[:, None, None], fx[:, None]
    rows = padded[:, y0] * (1 - fy) + padded[:, y1] * fy
    shown = rows[:, :, x0] * (1 - fx) + rows[:, :, x1] * fx
    shown = np.clip(np.round(shown), 0, 255).astype(np.uint8)
    x, y, w, h = gaze_rect_from_center(
        *gaze, dec_cfg.max_gaze_rect_w, dec_cfg.max_gaze_rect_h,
        header.frame_w, header.frame_h,
    )
    m = 16  # stay clear of partly gazed edge blocks and the resample halo
    crop = (slice(None), slice(y + m, y + h - m), slice(x + m, x + w - m))
    return float(psnr(decoded[crop], shown[crop]))


def run_apps(tmp, card: str, four_cards: bool = False) -> dict:
    """Encode then decode each clip through the CLI apps; returns the
    bitstreams and decoded frames of the last run of each."""
    import numpy as np

    from svc_tpu.apps import decoder_app, encoder_app
    from svc_tpu.config import DecoderConfig
    from svc_tpu.io import bitstream

    results = {}
    names = ["1080p"] if four_cards else list(CLIPS)
    for name in names:
        clip = CLIPS[name]
        source, clip_path = _write_clip(tmp, name, clip)
        gaze = "{},{}".format(*clip["gaze"])
        variants = {"1card": []}
        if four_cards:
            variants["4cards"] = ["--devices", "4"]
        for label, extra in variants.items():
            batch = clip["batch"] // 4 if extra else clip["batch"]
            svc = os.path.join(tmp, f"{name}_{label}.svc")
            out = os.path.join(tmp, f"{name}_{label}.npy")
            enc_argv = [
                "encoder_app", "--batch-size", str(batch), *extra,
                "--output", svc, clip_path,
            ]
            dec_argv = [
                "decoder_app", "--batch-size", str(clip["batch"]), *extra,
                "--gaze", gaze, "--input", svc, "--output", out,
            ]
            n_batches = -(-(clip["frames"] - 1) // clip["batch"])
            # the four-card check compares bytes only: one run each
            runs = ("single",) if four_cards else ("warm-up", "timed")
            for run in runs:
                t0 = time.perf_counter()
                if encoder_app.main(enc_argv) != 0:
                    raise RuntimeError(f"encoder_app failed: {enc_argv}")
                t_enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                if decoder_app.main(dec_argv) != 0:
                    raise RuntimeError(f"decoder_app failed: {dec_argv}")
                t_dec = time.perf_counter() - t0
            log(
                f"apps {name} {label} ({n_batches} batches of "
                f"{clip['batch']}, {run} run) on {card}: encode "
                f"{t_enc / n_batches:.3f} s/batch, decode "
                f"{t_dec / n_batches:.3f} s/batch (wall, file I/O "
                "included)"
            )
            with open(svc, "rb") as f:
                stream = f.read()
            header = bitstream.Header.unpack(stream)
            decoded = np.load(out)
            expect = (clip["frames"] - 1, clip["h"], clip["w"], 3)
            if header.frame_count != clip["frames"] - 1:
                raise RuntimeError(f"{name}: header {header}")
            if decoded.shape != expect or decoded.dtype != np.uint8:
                raise RuntimeError(
                    f"{name}: decoded {decoded.shape} {decoded.dtype}"
                )
            gp = _gaze_psnr(
                decoded, source[1:], header, clip["gaze"], DecoderConfig()
            )
            log(f"apps {name} {label}: gaze-region PSNR {gp:.2f} dB")
            if gp < 40.0:
                raise RuntimeError(f"{name}: gaze-region PSNR {gp:.2f} dB")
            results[(name, label)] = (stream, decoded)
    return results


def check_parity(jax, card: str) -> None:
    """One 1080p encode batch and its decode on the card against the
    same jitted programs on the host CPU backend; the stage transforms
    against SciPy in float64."""
    import numpy as np
    from scipy import fft

    from svc_tpu.config import DecoderConfig
    from svc_tpu.models.decoder import Decoder
    from svc_tpu.ops.dct import dct2_planes_to_wire, idct2_wire_to_planes

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from clips import make_clip

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    clip = CLIPS["1080p"]
    t = 2  # a short batch keeps the host CPU's share of the check brief
    enc = _encoder(clip, batch=t)
    frames = make_clip(clip["w"], clip["h"], t + 1, seed=SEED)
    packed = frames.reshape(t + 1, clip["h"], clip["w"] * 3)
    keys = enc._keys(0, t)
    outs = {}
    for label, device in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        out = enc._encode_batch(
            jax.device_put(packed, device), jax.device_put(keys, device)
        )
        outs[label] = {k: np.asarray(v) for k, v in out.items()}
        log(
            f"parity: 1080p/{t} encode on {label} "
            f"{time.perf_counter() - t0:.1f} s (compile included)"
        )
    g, c = outs["gpu"], outs["cpu"]
    for key in ("mv_field", "foreground_mask_raw", "foreground_mask",
                "block_types"):
        same = np.array_equal(g[key], c[key])
        log(f"parity: {key} byte-equal gpu vs cpu: {same}")
        if not same:
            raise RuntimeError(f"parity: {key} differs between gpu and cpu")
    dc = float(np.abs(g["coeffs"] - c["coeffs"]).max())
    log(f"parity: coeffs max |gpu - cpu| = {dc:.3e} (gate {COEFF_GATE})")
    if dc > COEFF_GATE:
        raise RuntimeError(f"parity: coefficients differ by {dc}")

    dec = Decoder(DecoderConfig(), enc.header(), batch_size=t)
    ry = enc.cfg.mv_block_h // 8
    rx = enc.cfg.mv_block_w // 8
    btypes = g["block_types"].repeat(ry, 1).repeat(rx, 2)
    rects = np.tile(np.array([[900, 500, 128, 96]], np.int32), (t, 1))
    shown = {}
    for label, device in (("gpu", gpu), ("cpu", cpu)):
        args = [jax.device_put(a, device) for a in (g["coeffs"], btypes, rects)]
        shown[label] = np.asarray(dec._decode_batch(*args)).astype(np.int32)
    dd = int(np.abs(shown["gpu"] - shown["cpu"]).max())
    log(f"parity: decoded display bytes max |gpu - cpu| = {dd} (bound 1)")
    if dd > 1:
        raise RuntimeError(f"parity: display bytes differ by {dd}")

    # stage transforms at 1080p against float64 SciPy
    planes = np.moveaxis(frames[1:2], -1, 0)  # (3, 1, H, W) B, G, R
    planes = np.pad(planes, ((0, 0), (0, 0), (0, enc.excess_h), (0, 0)))
    wire = np.asarray(dct2_planes_to_wire(jax.device_put(planes, gpu), 8, 8))
    _, nby, nbx, _ = wire.shape
    blocks = planes[:, 0].reshape(3, nby, 8, nbx, 8).astype(np.float64)
    ref = fft.dctn(blocks, type=2, norm="ortho", axes=(2, 4))
    ref_wire = ref.transpose(1, 3, 0, 2, 4).reshape(nby, nbx, 192)
    d_fwd = float(np.abs(wire[0] - ref_wire).max())
    log(f"parity: 1080p wire DCT max |gpu - scipy| = {d_fwd:.3e}")
    back = np.asarray(
        idct2_wire_to_planes(jax.device_put(wire[0], gpu), 3, 8, 8)
    )
    wire64 = wire[0].reshape(nby, nbx, 3, 8, 8).astype(np.float64)
    ref_back = fft.idctn(wire64, type=2, norm="ortho", axes=(3, 4))
    ref_back = ref_back.transpose(2, 0, 3, 1, 4).reshape(
        3, nby * 8, nbx * 8
    )
    d_inv = float(np.abs(back - ref_back).max())
    log(f"parity: 1080p wire IDCT max |gpu - scipy| = {d_inv:.3e}")
    if max(d_fwd, d_inv) > COEFF_GATE:
        raise RuntimeError("parity: stage DCT/IDCT outside the gate")


def four_card_check(jax, card: str) -> None:
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX finds "
                           f"{len(jax.devices())}")
    with tempfile.TemporaryDirectory() as tmp:
        res = run_apps(tmp, card, four_cards=True)
    one_s, one_d = res[("1080p", "1card")]
    four_s, four_d = res[("1080p", "4cards")]
    same_s, same_d = one_s == four_s, bool((one_d == four_d).all())
    log(f"four cards: bitstream byte-identical to one card: {same_s}; "
        f"decoded frames identical: {same_d}")
    if not (same_s and same_d):
        raise RuntimeError("four-card output differs from one card")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded apps on four cards, against one card",
    )
    args = parser.parse_args(argv)

    card = card_line()
    log(f"card: {card}")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import svc_tpu  # noqa: F401  (fails outside a checkout of the repo)

    if not args.four_cards:
        run_card_tests()

    # the parity phase compares against the host CPU backend
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    from svc_tpu.runtime.cache import enable_persistent_cache

    devices = require_gpu(jax)
    enable_persistent_cache()
    log(
        f"device: {devices[0].device_kind} x{len(devices)} "
        f"(jax {jax.__version__}); {card}"
    )

    if args.four_cards:
        four_card_check(jax, card)
    else:
        compile_steps(jax, card)
        with tempfile.TemporaryDirectory() as tmp:
            run_apps(tmp, card)
        check_parity(jax, card)

    log(f"card: {card}")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
