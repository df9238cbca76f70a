"""End-to-end pipeline tests: encode -> bitstream -> decode -> PSNR.

This is the framework's integration gate (SURVEY.md §4: golden round-trip
parity; tests/test_cif_roundtrip.py is the CIF variant of the same flow).
"""

import io

import numpy as np
import pytest

from svc_tpu.config import (
    DecoderConfig,
    EncoderConfig,
    KMeansParams,
    VideoProperties,
)
from svc_tpu.io import bitstream as bs
from svc_tpu.metrics import psnr
from svc_tpu.models.decoder import Decoder, gaze_rect_from_center
from svc_tpu.models.encoder import Encoder


def _video(t=7, h=48, w=64, seed=0):
    """Textured pan + bright moving square."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(30, 220, (24, 28)).astype(np.float32)
    bg = np.kron(coarse, np.ones((4, 4)))
    frames = []
    for i in range(t):
        f = bg[8 + i : 8 + i + h, 4 + i : 4 + i + w].copy()
        f[10 + 2 * i : 22 + 2 * i, 40 - 2 * i : 52 - 2 * i] = 240
        frames.append(np.repeat(f[..., None], 3, -1).astype(np.uint8))
    return np.stack(frames)


def _cfg(**kw):
    base = dict(
        mv_block_w=8,
        mv_block_h=8,
        mv_search_range=4,
        pyr_lvl_count=2,
        kmeans=KMeansParams(cluster_count=3),
    )
    base.update(kw)
    return EncoderConfig(**base)


@pytest.fixture(scope="module")
def encoded():
    frames = _video()
    cfg = _cfg()
    props = VideoProperties(64, 48, len(frames))
    enc = Encoder(cfg, props, batch_size=3)
    chunks = list(enc.encode_video(iter(frames)))
    return frames, cfg, chunks


class TestEncode:
    def test_header_and_chunk_count(self, encoded):
        frames, cfg, chunks = encoded
        header = bs.Header.unpack(chunks[0])
        assert header.frame_count == len(frames) - 1
        assert len(chunks) == len(frames)  # header + T payloads
        assert header.channel_count == 3
        for payload in chunks[1:]:
            assert len(payload) == header.frame_byte_count

    def test_deterministic_bytes_under_seed(self, encoded):
        frames, cfg, chunks = encoded
        enc2 = Encoder(cfg, VideoProperties(64, 48, len(frames)), batch_size=3)
        chunks2 = list(enc2.encode_video(iter(frames)))
        assert [bytes(c) for c in chunks] == [bytes(c) for c in chunks2]

    def test_different_seed_changes_segmentation_not_coeffs(self, encoded):
        frames, cfg, chunks = encoded
        cfg2 = _cfg(seed=123)
        enc2 = Encoder(cfg2, VideoProperties(64, 48, len(frames)), batch_size=3)
        header = bs.Header.unpack(chunks[0])
        for p1, p2 in zip(chunks[1:], list(enc2.encode_video(iter(frames)))[1:]):
            _, c1 = bs.deserialize_frame(p1, header)
            _, c2 = bs.deserialize_frame(p2, header)
            np.testing.assert_array_equal(c1, c2)

    def test_batch_boundaries_do_not_change_output(self, encoded):
        frames, cfg, chunks = encoded
        enc2 = Encoder(cfg, VideoProperties(64, 48, len(frames)), batch_size=2)
        chunks2 = list(enc2.encode_video(iter(frames)))
        assert [bytes(c) for c in chunks] == [bytes(c) for c in chunks2]

    def test_padded_dims_flow_through(self):
        # 50x30 with mv block 8, 2 levels -> padded to 56x32
        frames = _video(t=3, h=30, w=50)
        cfg = _cfg()
        enc = Encoder(cfg, VideoProperties(50, 30, 3), batch_size=2)
        chunks = list(enc.encode_video(iter(frames)))
        header = bs.Header.unpack(chunks[0])
        assert (header.padded_frame_w, header.padded_frame_h) == (56, 32)
        assert header.frame_excess_w == 6 and header.frame_excess_h == 2
        types, coeffs = bs.deserialize_frame(chunks[1], header)
        assert coeffs.shape == (3, 32, 56)


class TestDecode:
    def test_near_lossless_at_step_one(self, encoded):
        frames, cfg, chunks = encoded
        header = bs.Header.unpack(chunks[0])
        dec = Decoder(
            DecoderConfig(background_quant_step=1), header, batch_size=3
        )
        outs = np.stack(list(dec.decode_frames(iter(chunks[1:]))))
        assert outs.shape == frames[1:].shape
        assert psnr(outs, frames[1:]) > 45

    def test_staged_h2d_decode_byte_identical(self, encoded):
        """The double-buffered coefficient H2D path must produce the
        same bytes as unstaged dispatch, including the padded final
        batch and the drain."""
        frames, cfg, chunks = encoded
        header = bs.Header.unpack(chunks[0])
        dec = Decoder(DecoderConfig(), header, batch_size=2)
        gaze = [(20, 12)] * len(chunks[1:])
        staged = np.stack(
            list(dec.decode_frames(iter(chunks[1:]), iter(gaze)))
        )
        plain = np.stack(
            list(
                dec.decode_frames(
                    iter(chunks[1:]), iter(gaze), stage_h2d=False
                )
            )
        )
        np.testing.assert_array_equal(staged, plain)

    def test_background_quantization_degrades(self, encoded):
        frames, cfg, chunks = encoded
        header = bs.Header.unpack(chunks[0])
        dec = Decoder(DecoderConfig(), header, batch_size=3)  # bg step 640
        outs = np.stack(list(dec.decode_frames(iter(chunks[1:]))))
        p = psnr(outs, frames[1:])
        assert 5 < p < 35  # heavily quantized but structured

    def test_gaze_rect_restores_region(self, encoded):
        frames, cfg, chunks = encoded
        header = bs.Header.unpack(chunks[0])
        dec = Decoder(DecoderConfig(max_gaze_rect_w=32, max_gaze_rect_h=32),
                      header, batch_size=3)
        gaze = (32, 24)
        outs_g = np.stack(
            list(
                dec.decode_frames(
                    iter(chunks[1:]), iter([gaze] * header.frame_count)
                )
            )
        )
        rect = gaze_rect_from_center(32, 24, 32, 32, 64, 48)
        x, y, w, h = rect
        # inside the gaze rect: near-lossless even though bg step is 640
        inside = psnr(
            outs_g[:, y + 8 : y + h - 8, x + 8 : x + w - 8],
            frames[1:, y + 8 : y + h - 8, x + 8 : x + w - 8],
        )
        assert inside > 40

    def test_gaze_rect_semantics(self):
        # centered, unclamped
        assert gaze_rect_from_center(32, 24, 16, 16, 64, 48) == (24, 16, 16, 16)
        # near the left edge: half width shrinks to cx
        assert gaze_rect_from_center(3, 24, 16, 16, 64, 48) == (0, 16, 6, 16)
        # at the corner: degenerate
        assert gaze_rect_from_center(0, 0, 16, 16, 64, 48) == (0, 0, 0, 0)
        # near the right edge
        assert gaze_rect_from_center(62, 24, 16, 16, 64, 48) == (61, 16, 2, 16)

    def test_truncated_payload_raises(self, encoded):
        frames, cfg, chunks = encoded
        header = bs.Header.unpack(chunks[0])
        stream = io.BytesIO(b"".join(chunks[1:])[:-10])
        with pytest.raises(ValueError, match="failed to read block"):
            list(bs.read_frames(stream, header))


class TestReferenceCompatMode:
    def test_compat_flag_changes_only_segmentation(self):
        frames = _video(t=4)
        cfg_a = _cfg()
        cfg_b = _cfg(reference_compat=True)
        props = VideoProperties(64, 48, 4)
        out_a = Encoder(cfg_a, props, batch_size=3).encode_batch(frames, 0)
        out_b = Encoder(cfg_b, props, batch_size=3).encode_batch(frames, 0)
        np.testing.assert_array_equal(
            np.asarray(out_a["coeffs"]), np.asarray(out_b["coeffs"])
        )
        np.testing.assert_array_equal(
            np.asarray(out_a["mv_field"]), np.asarray(out_b["mv_field"])
        )


def test_producer_exception_propagates():
    """A crashed producer must fail the pipeline, not fake a clean EOS
    (a truncated bitstream with exit 0 otherwise)."""
    from svc_tpu.runtime.pipeline import pipeline_threads

    def bad_producer(q):
        q.push(1)
        raise RuntimeError("reader exploded")

    seen = []

    def consumer(q):
        for item in q:
            seen.append(item)

    with pytest.raises(RuntimeError, match="reader exploded"):
        pipeline_threads(bad_producer, consumer, capacity=2)
    assert seen == [1]
