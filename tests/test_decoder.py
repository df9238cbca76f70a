"""The decoder's one display route, and the encoder's frame unpacking,
against independent NumPy references.

The decode reference is written from the reference decoder's semantics
(libs/decoder.cpp:128-216): per-block step selection (1 inside the gaze
rect, the background step for background blocks, the foreground step
otherwise), divide / round-half-away / multiply, a float64 blockwise
inverse DCT (``scipy.fft``), a bilinear resize of the whole padded
reconstruction to the display size (``cv2.resize``), and a rounded,
clamped uint8 interleave. The geometries cover zero frame excess, row
excess, column excess, and a multi-block-row row-excess frame.
"""

import numpy as np
import pytest

import jax

from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream
from svc_tpu.models.decoder import Decoder
from svc_tpu.models.encoder import Encoder

cv2 = pytest.importorskip("cv2")
fft = pytest.importorskip("scipy.fft")

# (display w, display h, excess w, excess h)
GEOMETRIES = [
    (256, 64, 0, 0),
    (256, 56, 0, 8),
    (248, 64, 8, 0),
    (256, 248, 0, 8),
]


def _header(w, h, excess_w, excess_h):
    return bitstream.Header(
        frame_count=2,
        frame_w=w,
        frame_h=h,
        frame_excess_w=excess_w,
        frame_excess_h=excess_h,
        transform_block_w=8,
        transform_block_h=8,
        channel_count=3,
    )


def _decode_reference(hdr, cfg, coeffs, btypes, rects):
    """NumPy model of one decode batch: ``(T, H, W*3)`` uint8."""
    t, nby, nbx, _ = coeffs.shape
    bys = np.arange(nby)[:, None] * 8
    bxs = np.arange(nbx)[None, :] * 8
    out = []
    for i in range(t):
        rx, ry, rw, rh = rects[i]
        gazed = (bxs >= rx) & (bxs < rx + rw) & (bys >= ry) & (bys < ry + rh)
        steps = np.where(
            btypes[i] == 0,
            np.float32(cfg.background_quant_step),
            np.float32(cfg.foreground_quant_step),
        )
        steps = np.where(gazed, np.float32(1), steps)[:, :, None]
        q = coeffs[i] / steps
        deq = np.sign(q) * np.floor(np.abs(q) + np.float32(0.5)) * steps
        blocks = deq.reshape(nby, nbx, 3, 8, 8).astype(np.float64)
        pix = fft.idctn(blocks, type=2, norm="ortho", axes=(-2, -1))
        planes = pix.transpose(2, 0, 3, 1, 4).reshape(3, nby * 8, nbx * 8)
        shown = np.stack(
            [
                cv2.resize(
                    p.astype(np.float32),
                    (hdr.frame_w, hdr.frame_h),
                    interpolation=cv2.INTER_LINEAR,
                )
                for p in planes
            ],
            axis=-1,
        )
        out.append(
            np.clip(np.round(shown), 0, 255)
            .astype(np.uint8)
            .reshape(hdr.frame_h, hdr.frame_w * 3)
        )
    return np.stack(out)


@pytest.mark.parametrize("gaze", [True, False])
@pytest.mark.parametrize("w,h,ew,eh", GEOMETRIES)
def test_decode_batch_matches_numpy_reference(w, h, ew, eh, gaze):
    hdr = _header(w, h, ew, eh)
    cfg = DecoderConfig()
    t = 2
    nby = hdr.padded_frame_h // 8
    nbx = hdr.padded_frame_w // 8
    rng = np.random.default_rng(w * 7 + h + ew + eh)
    coeffs = (rng.normal(size=(t, nby, nbx, 192)) * 90).astype(np.float32)
    coeffs[..., 0] += 1024.0  # DC around mid-grey, like real frames
    btypes = rng.integers(0, 3, (t, nby, nbx)).astype(np.uint32)
    rect = [w // 4, h // 4, 64, 32] if gaze else [0, 0, 0, 0]
    rects = np.tile(np.array([rect], np.int32), (t, 1))

    dec = Decoder(cfg, hdr, batch_size=t)
    got = np.asarray(dec._decode_batch(coeffs, btypes, rects))
    ref = _decode_reference(hdr, cfg, coeffs, btypes, rects)

    assert got.shape == ref.shape == (t, h, w * 3)
    assert got.dtype == np.uint8
    # float32 vs float64 IDCT and resample arithmetic: display bytes may
    # differ by one where a value sits at a rounding boundary
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_stage_coeffs_round_trips():
    hdr = _header(64, 48, 0, 0)
    dec = Decoder(DecoderConfig(), hdr, batch_size=1)
    coeffs = np.random.default_rng(0).normal(size=(1, 6, 8, 192))
    coeffs = coeffs.astype(np.float32)
    staged = dec.stage_coeffs(coeffs)
    assert isinstance(staged, jax.Array)
    np.testing.assert_array_equal(np.asarray(staged), coeffs)


@pytest.mark.parametrize("w,h", [(64, 48), (128, 40), (88, 30)])
def test_encoder_preprocess_unpacks_and_pads_planes(w, h):
    """Packed ``(N, H, W*3)`` BGR rows become zero-padded ``(3, N, PH, PW)``
    channel planes in ``cv::split`` order."""
    n = 3
    enc = Encoder(EncoderConfig(), VideoProperties(w, h, n), batch_size=2)
    rng = np.random.default_rng(w + h)
    frames = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    planes, pyr = enc.preprocess(
        enc.stage_frames(frames.reshape(n, h, w * 3))
    )
    planes = np.asarray(planes)
    assert planes.shape == (3, n, enc.padded_h, enc.padded_w)
    np.testing.assert_array_equal(
        planes[:, :, :h, :w], frames.transpose(3, 0, 1, 2)
    )
    assert not planes[:, :, h:, :].any() and not planes[:, :, :, w:].any()
    assert len(pyr) == enc.cfg.pyr_lvl_count
