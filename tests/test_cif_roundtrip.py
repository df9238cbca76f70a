"""CIF end-to-end gate (the CIF round-trip target in BASELINE.md).

Full default codec configuration (16x16 MV blocks, 4 pyramid levels,
range 8, k=10, 8x8 DCT) on a CIF 352x288 clip — the reference's canonical
zero-padding geometry (352 and 288 divide 16, so frame_excess = 0 and the
reference's Q4 serialization quirk is moot). Encode -> bitstream ->
decode -> PSNR + structural checks.
"""

import numpy as np
import pytest

from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream as bs
from svc_tpu.metrics import bitrate_bits_per_pixel, psnr
from svc_tpu.models.decoder import Decoder
from svc_tpu.models.encoder import Encoder


@pytest.fixture(scope="module")
def cif_clip():
    """Synthetic CIF content: textured pan + two moving objects."""
    rng = np.random.default_rng(7)
    coarse = rng.integers(20, 236, (100, 120)).astype(np.float32)
    base = np.kron(coarse, np.ones((4, 4)))  # 400x480
    frames = []
    for t in range(6):
        f = base[20 + 2 * t : 20 + 2 * t + 288, 30 + t : 30 + t + 352].copy()
        f[60 + 5 * t : 100 + 5 * t, 80 : 140] = 235  # mover 1
        f[200 : 240, 250 - 6 * t : 300 - 6 * t] = 30  # mover 2
        bgr = np.stack([f, np.roll(f, 3, 1), np.roll(f, -2, 0)], -1)
        frames.append(np.clip(bgr, 0, 255).astype(np.uint8))
    return np.stack(frames)


@pytest.fixture(scope="module")
def encoded_cif(cif_clip):
    cfg = EncoderConfig()  # full reference defaults
    props = VideoProperties(352, 288, len(cif_clip))
    enc = Encoder(cfg, props, batch_size=5)
    chunks = list(enc.encode_video(iter(cif_clip)))
    return cfg, chunks


class TestCifRoundTrip:
    def test_zero_excess_geometry(self, encoded_cif):
        _, chunks = encoded_cif
        header = bs.Header.unpack(chunks[0])
        assert (header.frame_w, header.frame_h) == (352, 288)
        assert header.frame_excess_w == 0 and header.frame_excess_h == 0
        assert header.frame_count == 5
        # wire size: 44x36 blocks x (4 + 768 bytes) per frame
        assert header.frame_byte_count == 44 * 36 * (4 + 4 * 64 * 3)

    def test_near_lossless_roundtrip(self, cif_clip, encoded_cif):
        _, chunks = encoded_cif
        header = bs.Header.unpack(chunks[0])
        dec = Decoder(
            DecoderConfig(background_quant_step=1), header, batch_size=5
        )
        out = np.stack(list(dec.decode_frames(iter(chunks[1:]))))
        assert psnr(out, cif_clip[1:]) > 45

    def test_default_bg_quant_preserves_foreground_better(
        self, cif_clip, encoded_cif
    ):
        _, chunks = encoded_cif
        header = bs.Header.unpack(chunks[0])
        types, _ = bs.deserialize_frame_blocks(chunks[3], header)
        dec = Decoder(DecoderConfig(), header, batch_size=5)  # bg 640
        out = np.stack(list(dec.decode_frames(iter(chunks[1:]))))
        frame_idx = 2
        orig = cif_clip[1 + frame_idx].astype(np.float64)
        rec = out[frame_idx].astype(np.float64)
        err = ((orig - rec) ** 2).mean(-1)  # (288, 352)
        # per transform block error split by wire type
        blocks = err.reshape(36, 8, 44, 8).mean((1, 3))
        fg = np.asarray(types) != bs.BLOCK_TYPE_BACKGROUND
        if fg.any() and (~fg).any():
            assert blocks[fg].mean() < blocks[~fg].mean()

    def test_region_ids_cover_movers(self, cif_clip, encoded_cif):
        _, chunks = encoded_cif
        header = bs.Header.unpack(chunks[0])
        types, _ = bs.deserialize_frame_blocks(chunks[3], header)
        # some foreground structure must exist on this clip
        assert (np.asarray(types) != bs.BLOCK_TYPE_BACKGROUND).sum() > 4

    def test_bitrate_accounting(self, cif_clip, encoded_cif):
        _, chunks = encoded_cif
        total = sum(len(c) for c in chunks)
        bpp = bitrate_bits_per_pixel(total, 352, 288, 5)
        # raw float coefficients: ~96 bits/px + type overhead
        assert 96 < bpp < 100
