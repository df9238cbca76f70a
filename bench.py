"""Headline benchmark: 1080p end-to-end encode throughput on one GPU,
plus the metric matrix (1080p decode, 4K encode/decode, CIF encode, the
CIF quality gate, and the legs whose frames cross the host link).

Measures the full encoder pipeline (pad -> luma -> 4-level pyramid -> HBMA
16x16/range-8 -> RANSAC -> morphology -> k-means -> per-cluster CCL ->
blockwise 8x8 DCT) at the reference's default codec configuration
(apps/encoder.cpp:28-58) on synthetic BGR frames, and the decoder pipeline
(gaze/region dequant -> wire IDCT -> display resize -> packed rows) on
wire-shaped coefficient batches.

Every leg runs in its own subprocess, one at a time; this parent process
never imports JAX, so exactly one process holds the card. Each result
names the device it ran on (platform, ``device_kind``, device count). A
leg that fails makes the benchmark exit non-zero.

Timing covers the on-device pipeline, ending each timed window in
``jax.block_until_ready``. Input frames are staged on the device once,
except in the ``staged_h2d_*`` legs, where every batch crosses the host
link with the transfer of batch i+1 double-buffered against the compute
of batch i.

The reference publishes no numbers; ``vs_reference`` is measured against
the C++ reference binary timed on one CPU core (6.46 fps 1080p, 84.8 fps
CIF — benchmarks/bench_reference.py).

Prints exactly one JSON line; the primary metric keys come first, and the
rest of the matrix rides in ``extra_metrics``:
  {"metric": "1080p_encode_fps", "value": N, "unit": "frames/s",
   "vs_reference": N, "device": {...}, "extra_metrics": [...]}
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REFERENCE_FPS = 6.46  # C++ reference, 1080p, one CPU core
REFERENCE_CIF_FPS = 84.8  # C++ reference, CIF, one CPU core

LEG_TIMEOUT_S = 2100


def make_frames(t, h, w, seed=0):
    """Synthetic content: large-scale texture pan + moving objects."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, ((h + 256) // 8, (w + 256) // 8))
    base = np.kron(coarse, np.ones((8, 8))).astype(np.float32)
    frames = np.empty((t, h, w, 3), np.uint8)
    s = min(128, h // 2, w // 2)  # moving object fits any geometry
    for i in range(t):
        f = base[2 * i : 2 * i + h, i : i + w].copy()
        oy = (h // 5 + 6 * i) % (h - s + 1)
        ox = (w // 5 + 10 * i) % (w - s + 1)
        f[oy : oy + s, ox : ox + s] = base[:s, :s]
        frames[i] = np.repeat(f[..., None], 3, -1).astype(np.uint8)
    return frames


def _sync(out):
    """Wait for every array of ``out`` to be computed."""
    import jax

    return jax.block_until_ready(out)


def _pipeline_fps(step, t, iters):
    """Steady-state fps: queue ``iters`` batches, sync once."""
    out = None
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step()
    _sync(out)
    return iters * t / (time.perf_counter() - t0)


def _make_encoder(h, w, t):
    from svc_tpu.config import EncoderConfig, VideoProperties
    from svc_tpu.models.encoder import Encoder

    return Encoder(EncoderConfig(), VideoProperties(w, h, t + 1), batch_size=t)


def _encode_fps(h, w, t, iters):
    """(encode fps, encoder, staged frames, keys, last outputs)."""
    enc = _make_encoder(h, w, t)
    frames = make_frames(t + 1, h, w)
    keys = enc._keys(0, t)
    fdev = enc.stage_frames(frames.reshape(t + 1, h, w * 3))

    t0 = time.perf_counter()
    out = _sync(enc._encode_batch(fdev, keys))
    print(
        f"[{w}x{h}] compile+first batch: {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    _sync(enc._encode_batch(fdev, keys))
    fps = _pipeline_fps(lambda: enc._encode_batch(fdev, keys), t, iters)
    return fps, enc, fdev, keys, out


def _decode_fps(h, w, t, iters, gaze=True, seed=1):
    """Decode fps on synthesized wire-shaped coefficients.

    Synthesizing (rather than re-running the encoder in this process)
    keeps the leg isolated; decode cost is data-independent — the same
    program, shapes, and layouts as decoding a real stream."""
    import jax
    import jax.numpy as jnp

    from svc_tpu.config import DecoderConfig
    from svc_tpu.models.decoder import Decoder

    enc = _make_encoder(h, w, t)  # header/geometry only; never dispatched
    cfg = enc.cfg
    dec = Decoder(DecoderConfig(), enc.header(), batch_size=t)

    nby = enc.padded_h // cfg.transform_block_h
    nbx = enc.padded_w // cfg.transform_block_w
    cpb = 3 * cfg.transform_block_h * cfg.transform_block_w
    rng = np.random.default_rng(seed)
    coeffs_host = (
        rng.standard_normal((t, nby, nbx, cpb)).astype(np.float32) * 64.0
    )
    coeffs_host[..., 0] += 1024.0  # DC offset, realistic magnitude
    btypes = jnp.asarray(
        rng.integers(0, 11, (t, nby, nbx)).astype(np.uint32)
    )
    rect = [w // 3, h // 3, 128, 128] if gaze else [0, 0, 0, 0]
    rects = jax.device_put(np.tile(np.array(rect, np.int32), (t, 1)))
    coeffs = dec.stage_coeffs(coeffs_host)

    t0 = time.perf_counter()
    _sync(dec._decode_batch(coeffs, btypes, rects))
    print(
        f"[{w}x{h}] decode compile+first batch: "
        f"{time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    _sync(dec._decode_batch(coeffs, btypes, rects))
    step = lambda: dec._decode_batch(coeffs, btypes, rects)  # noqa: E731
    fps = _pipeline_fps(step, t, iters)
    return fps, step, t, (coeffs, btypes, rects), dec


def _chained_wall_fps(chain, args, k, t, iters):
    """Steady-state wall fps of a multi-batch dispatch chain: one jitted
    dispatch runs ``k`` back-to-back batches (lax.scan), so the host's
    per-dispatch cost is paid once per ``k`` batches. Every batch's full
    pipeline runs on device; only the host round trips are amortized."""
    out = chain(*args)
    _sync(out)
    _sync(chain(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = chain(*args)
    _sync(out)
    return iters * k * t / (time.perf_counter() - t0)


def _make_encode_chain(enc, k):
    import jax
    import jax.numpy as jnp

    def chain(fdev, keys):
        def body(acc, i):
            ks = jax.vmap(lambda kk: jax.random.fold_in(kk, i))(keys)
            out = enc.encode_batch_fn(fdev, ks)
            # consume every load-bearing output so nothing is DCE'd:
            # coeffs (DCT chain) + block_types (motion -> RANSAC ->
            # morphology -> k-means -> CCL chain); keys vary per
            # iteration, so loop-invariant code motion cannot hoist the
            # body out of the scan
            s = jnp.sum(out["coeffs"][0, 0, 0]) + jnp.sum(
                out["block_types"][0].astype(jnp.float32)
            )
            return acc + s, None
        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(k))
        return acc

    return jax.jit(chain)


def _make_decode_chain(dec, k):
    import jax
    import jax.numpy as jnp

    def chain(coeffs, btypes, rects):
        def body(acc, i):
            # the gaze rect jitters per iteration (1 px, like a real
            # gaze stream) — also blocks loop-invariant hoisting
            r = rects.at[:, 0].add(i % 2)
            out = dec._decode_batch(coeffs, btypes, r)
            return acc + jnp.sum(out[0, 0, :8].astype(jnp.float32)), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(k))
        return acc

    return jax.jit(chain)


# ----------------------------------------------------------------------
# legs (each runs in its own subprocess)
# ----------------------------------------------------------------------


def leg_encode_1080p():
    t, k = 16, 8
    fps, enc, fdev, keys, _ = _encode_fps(1080, 1920, t, iters=10)
    chain = _make_encode_chain(enc, k)
    chained = _chained_wall_fps(chain, (fdev, keys), k, t, iters=4)
    # headline = the chained-dispatch wall (k batches per dispatch, the
    # throughput deployment pattern); the per-batch-dispatch wall stays
    # on the record next to it
    return {
        "metric": "1080p_encode_fps",
        "value": round(chained, 2),
        "unit": "frames/s",
        "vs_reference": round(chained / REFERENCE_FPS, 2),
        "chain_batches_per_dispatch": k,
        "wall_fps_per_batch_dispatch": round(fps, 2),
    }


def leg_decode_1080p():
    t, k = 16, 8
    fps, _, _, chain_args, dec = _decode_fps(1080, 1920, t, iters=8)
    chain = _make_decode_chain(dec, k)
    chained = _chained_wall_fps(chain, chain_args, k, t, iters=4)
    return {
        "metric": "1080p_gaze_decode_fps",
        "value": round(chained, 2),
        "unit": "frames/s",
        "chain_batches_per_dispatch": k,
        "wall_fps_per_batch_dispatch": round(fps, 2),
    }


def leg_encode_4k():
    t, k = 8, 4
    fps, enc, fdev, keys, _ = _encode_fps(2160, 3840, t, iters=6)
    chain = _make_encode_chain(enc, k)
    chained = _chained_wall_fps(chain, (fdev, keys), k, t, iters=3)
    return {
        "metric": "4k_encode_fps",
        "value": round(chained, 2),
        "unit": "frames/s",
        "chain_batches_per_dispatch": k,
        "wall_fps_per_batch_dispatch": round(fps, 2),
    }


def leg_decode_4k():
    t, k = 8, 4
    fps, _, _, chain_args, dec = _decode_fps(2160, 3840, t, iters=6)
    chain = _make_decode_chain(dec, k)
    chained = _chained_wall_fps(chain, chain_args, k, t, iters=3)
    return {
        "metric": "4k_gaze_decode_fps",
        "value": round(chained, 2),
        "unit": "frames/s",
        "chain_batches_per_dispatch": k,
        "wall_fps_per_batch_dispatch": round(fps, 2),
    }


def leg_encode_cif():
    t, k = 32, 16
    fps, enc, fdev, keys, _ = _encode_fps(288, 352, t, iters=10)
    chain = _make_encode_chain(enc, k)
    chained = _chained_wall_fps(chain, (fdev, keys), k, t, iters=4)
    return {
        "metric": "cif_encode_fps",
        "value": round(chained, 2),
        "unit": "frames/s",
        "vs_reference": round(chained / REFERENCE_CIF_FPS, 2),
        "chain_batches_per_dispatch": k,
        "wall_fps_per_batch_dispatch": round(fps, 2),
    }


def leg_quality_cif():
    """CIF encode -> decode PSNR on real photographic content: the
    quality regression gate of the benchmark (a coefficient or
    quantization drift would move these numbers; throughput legs cannot
    see it). Mirrors BASELINE.md's real-content validation: default
    config (heavy background quantization by design) and uniform-fine
    (bg step 8)."""
    from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu.io import bitstream
    from svc_tpu.metrics import psnr
    from svc_tpu.models.decoder import Decoder

    try:
        sys.path.insert(
            0, os.path.join(os.path.dirname(__file__), "benchmarks")
        )
        from real_content import make_real_clip

        frames = make_real_clip(n=17)
        content = "real_photo"
    except Exception:
        frames = make_frames(17, 288, 352)  # cv2-less fallback
        content = "synthetic"

    from svc_tpu.models.encoder import Encoder

    t = frames.shape[0] - 1
    enc = Encoder(
        EncoderConfig(),
        VideoProperties(352, 288, frames.shape[0]),
        batch_size=8,
    )
    payloads = list(enc.encode_video(iter(frames)))
    header = bitstream.Header.unpack(payloads[0])

    def decode_psnr(bg_step):
        dec = Decoder(
            DecoderConfig(background_quant_step=bg_step),
            header,
            batch_size=8,
        )
        outs = np.stack(list(dec.decode_frames(iter(payloads[1:]))))
        return float(psnr(outs, frames[1:]))

    fine = decode_psnr(8)
    default = decode_psnr(640)
    return {
        "metric": "cif_psnr_uniform_fine_db",
        "value": round(fine, 2),
        "unit": "dB",
        "cif_psnr_default_db": round(default, 2),
        "content": content,
        "frames": t,
    }


def leg_staged_h2d_encode_1080p():
    """1080p encode with every batch's frames crossing the host link: the
    H2D copy of batch i+1 is double-buffered against the compute of
    batch i (runtime.staging), so steady state is bounded by
    max(H2D, compute)."""
    from svc_tpu.runtime.staging import DoubleBufferedStager

    t = 16
    enc = _make_encoder(1080, 1920, t)
    frames = make_frames(t + 1, 1080, 1920).reshape(t + 1, 1080, 1920 * 3)
    keys = enc._keys(0, t)
    _sync(enc._encode_batch(enc.stage_frames(frames), keys))  # compile

    iters = 4
    out = None
    with DoubleBufferedStager(enc.stage_frames) as stager:
        stager.submit(frames)
        staged = stager.collect()
        t0 = time.perf_counter()
        for _ in range(iters):
            stager.submit(frames)  # batch i+1 streams H2D...
            out = enc._encode_batch(staged, keys)  # ...while i computes
            staged = stager.collect()
        _sync(out)
        fps = iters * t / (time.perf_counter() - t0)
    return {
        "metric": "1080p_encode_incl_h2d_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
    }


def leg_staged_h2d_decode_1080p():
    """1080p decode with every batch's 401 MB of wire coefficients
    crossing the host link, double-buffered against the previous batch's
    compute (the wiring ``Decoder.decode_frames`` uses)."""
    from svc_tpu.runtime.staging import DoubleBufferedStager

    import jax

    t = 16
    _, _, _, (coeffs, btypes, rects), dec = _decode_fps(
        1080, 1920, t, iters=2
    )
    coeffs_host = np.asarray(jax.device_get(coeffs))

    iters = 3
    out = None
    with DoubleBufferedStager(dec.stage_coeffs) as stager:
        stager.submit(coeffs_host)
        staged = stager.collect()
        t0 = time.perf_counter()
        for _ in range(iters):
            stager.submit(coeffs_host)  # batch i+1 streams H2D...
            out = dec._decode_batch(staged, btypes, rects)  # ...i computes
            staged = stager.collect()
        _sync(out)
        fps = iters * t / (time.perf_counter() - t0)
    return {
        "metric": "1080p_decode_incl_h2d_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
    }


LEGS = {
    "encode_1080p": leg_encode_1080p,
    "decode_1080p": leg_decode_1080p,
    "encode_4k": leg_encode_4k,
    "decode_4k": leg_decode_4k,
    "encode_cif": leg_encode_cif,
    "quality_cif": leg_quality_cif,
    "staged_h2d_encode_1080p": leg_staged_h2d_encode_1080p,
    "staged_h2d_decode_1080p": leg_staged_h2d_decode_1080p,
}


def run_leg(name):
    from svc_tpu.runtime.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    devices = jax.devices()
    print(f"[{name}] device: {devices[0]}", file=sys.stderr)
    result = LEGS[name]()
    result["device"] = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    print(json.dumps(result))


# ----------------------------------------------------------------------
# orchestrator
# ----------------------------------------------------------------------


def _spawn_leg(name):
    """Run one leg in a fresh process; return its JSON dict or None."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--leg", name],
            stdout=subprocess.PIPE,
            stderr=None,  # leg diagnostics pass through
            timeout=LEG_TIMEOUT_S,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired:
        print(f"[{name}] timed out", file=sys.stderr)
        return None
    if proc.returncode != 0:
        print(f"[{name}] exited {proc.returncode}", file=sys.stderr)
        return None
    for line in reversed(proc.stdout.decode().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                pass
    print(f"[{name}] produced no JSON result", file=sys.stderr)
    return None


def main():
    results = {name: _spawn_leg(name) for name in LEGS}
    failed = [n for n, r in results.items() if r is None]
    primary = results["encode_1080p"] or {
        "metric": "1080p_encode_fps",
        "value": None,
        "unit": "frames/s",
    }
    primary["extra_metrics"] = [
        r for n, r in results.items() if n != "encode_1080p" and r
    ]
    if failed:
        primary["failed_legs"] = failed
    print(json.dumps(primary))
    return 1 if failed else 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--leg", choices=sorted(LEGS), default=None)
    args = parser.parse_args()
    if args.leg:
        run_leg(args.leg)
    else:
        sys.exit(main())
