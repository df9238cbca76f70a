"""Seek/resume and tracing subsystem tests.

The reference has no checkpoint/resume or tracing at all (SURVEY.md §5);
these are framework additions: the fixed-size block format makes streams
random-access, and encoding is resumable from any frame index given one
overlap frame.
"""

import io
import os

import numpy as np

from svc_tpu.config import (
    DecoderConfig,
    EncoderConfig,
    KMeansParams,
    VideoProperties,
)
from svc_tpu.io import bitstream as bs
from svc_tpu.models.decoder import Decoder
from svc_tpu.models.encoder import Encoder
from svc_tpu.runtime.tracing import Tracer


def _video(t=7, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(30, 220, (24, 28)).astype(np.float32)
    bg = np.kron(coarse, np.ones((4, 4)))
    frames = []
    for i in range(t):
        f = bg[8 + i : 8 + i + h, 4 + i : 4 + i + w].copy()
        f[10 : 22, 40 : 52] = 240
        frames.append(np.repeat(f[..., None], 3, -1).astype(np.uint8))
    return np.stack(frames)


def _cfg():
    return EncoderConfig(
        mv_block_w=8, mv_block_h=8, mv_search_range=4, pyr_lvl_count=2,
        kmeans=KMeansParams(cluster_count=3),
    )


class TestEncoderResume:
    def test_resumed_stream_matches_full_encode(self):
        frames = _video()
        props = VideoProperties(64, 48, len(frames))
        enc = Encoder(_cfg(), props, batch_size=3)

        full = list(enc.encode_video(iter(frames)))

        # resume: re-encode payloads 3.. given overlap frame 3
        enc2 = Encoder(_cfg(), props, batch_size=3)
        tail = list(
            enc2.encode_video(
                iter(frames[3:]),
                emit_header=False,
                first_anchor_index=3,
            )
        )
        assert [bytes(c) for c in tail] == [bytes(c) for c in full[4:]]

        # stitched stream decodes identically to the straight-through one
        stitched = full[0] + b"".join(full[1:4]) + b"".join(tail)
        assert stitched == b"".join(full)

    def test_partial_header_count(self):
        frames = _video()
        props = VideoProperties(64, 48, len(frames))
        enc = Encoder(_cfg(), props, batch_size=3)
        chunks = list(
            enc.encode_video(iter(frames[:4]), header_frame_count=3)
        )
        header = bs.Header.unpack(chunks[0])
        assert header.frame_count == 3
        assert len(chunks) == 4


class TestBitstreamSeek:
    def _stream(self):
        frames = _video()
        props = VideoProperties(64, 48, len(frames))
        enc = Encoder(_cfg(), props, batch_size=3)
        chunks = list(enc.encode_video(iter(frames)))
        return chunks, bs.Header.unpack(chunks[0])

    def test_frame_offset(self):
        chunks, header = self._stream()
        data = b"".join(chunks)
        for i in range(header.frame_count):
            off = bs.frame_offset(header, i)
            assert data[off : off + header.frame_byte_count] == chunks[1 + i]

    def test_seek_on_file(self, tmp_path):
        chunks, header = self._stream()
        path = tmp_path / "clip.svc"
        path.write_bytes(b"".join(chunks))
        with open(path, "rb") as f:
            f.read(bs.HEADER_SIZE)
            bs.seek_to_frame(f, header, 4)
            got = list(bs.read_frames(f, header, 2))
        assert got == chunks[5:7]

    def test_skip_read_on_pipe(self):
        chunks, header = self._stream()

        class NonSeekable(io.BytesIO):
            def seekable(self):
                return False

        stream = NonSeekable(b"".join(chunks))
        stream.read(bs.HEADER_SIZE)
        bs.seek_to_frame(stream, header, 2)
        got = next(bs.read_frames(stream, header, 1))
        assert got == chunks[3]

    def test_seek_then_decode(self):
        chunks, header = self._stream()
        dec = Decoder(DecoderConfig(background_quant_step=1), header,
                      batch_size=3)
        all_frames = list(dec.decode_frames(iter(chunks[1:])))
        tail = list(dec.decode_frames(iter(chunks[4:])))
        for a, b in zip(all_frames[3:], tail):
            np.testing.assert_array_equal(a, b)


class TestTracer:
    def test_spans_and_stats(self):
        tr = Tracer()
        with tr.span("a"):
            pass
        with tr.span("a"):
            pass
        with tr.span("b", frames=4):
            pass
        stats = tr.stats()
        assert stats["a"]["count"] == 2
        assert stats["b"]["count"] == 1
        assert "mean_s" in stats["a"]
        assert "a" in tr.report()

    def test_disabled_records_nothing(self):
        tr = Tracer(enabled=False)
        with tr.span("x"):
            pass
        assert tr.events == []

    def test_dump(self, tmp_path):
        import json

        tr = Tracer()
        with tr.span("stage"):
            pass
        path = str(tmp_path / "trace.json")
        tr.dump(path)
        data = json.load(open(path))
        assert data["stats"]["stage"]["count"] == 1

    def test_encoder_integration(self):
        frames = _video(t=4)
        props = VideoProperties(64, 48, 4)
        enc = Encoder(_cfg(), props, batch_size=3)
        tr = Tracer()
        list(enc.encode_video(iter(frames), tracer=tr))
        stats = tr.stats()
        assert stats["device_dispatch"]["count"] >= 1
        assert stats["serialize"]["count"] == 3

    def test_decoder_pipeline_overlap(self):
        """decode_frames keeps one batch in flight: with >= 2 batches the
        span order must show batch i+1 DISPATCHED before batch i is
        fetched (parse/compute/fetch overlap)."""
        from svc_tpu.config import DecoderConfig
        from svc_tpu.io import bitstream
        from svc_tpu.models.decoder import Decoder

        frames = _video(t=5)
        props = VideoProperties(64, 48, 5)
        enc = Encoder(_cfg(), props, batch_size=2)
        chunks = list(enc.encode_video(iter(frames)))
        header = bitstream.Header.unpack(chunks[0])

        dec = Decoder(DecoderConfig(), header, batch_size=2)
        tr = Tracer()
        out = list(dec.decode_frames(iter(chunks[1:]), tracer=tr))
        assert len(out) == 4
        order = [e["name"] for e in tr.events]
        # 2 batches: parse x4, dispatch x2, fetch x2 — and the second
        # dispatch precedes the first fetch
        assert order.count("device_dispatch") == 2
        assert order.count("device_fetch") == 2
        assert order.index("device_fetch") > (
            len(order) - 1 - order[::-1].index("device_dispatch")
        )
