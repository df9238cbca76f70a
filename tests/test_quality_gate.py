"""Quality regression gate on real content.

Asserts the recorded real-content PSNR figures (BASELINE.md, measured
2026-08-16 on the same clip builder) within a 0.1 dB guard band, so perf
work on the encode/decode kernels cannot silently corrupt reconstruction
quality. The clip is the real-photo pan + moving-object CIF sequence from
``benchmarks/real_content.py`` (scikit-learn's sample photographs — the
closest available stand-in for the reference's CDW-2014 validation clips,
reference README.md:81-97, with no network egress here).

The pipeline runs in-process through the library surface (Encoder ->
bitstream bytes -> Decoder), which is the same math the CLI apps drive;
frame values are batch-size independent (every frame encodes against only
its predecessor, libs/encoder.cpp:661-663).
"""

import importlib.util
import os

import numpy as np
import pytest

from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream as bs
from svc_tpu.metrics import psnr
from svc_tpu.models.decoder import Decoder
from svc_tpu.models.encoder import Encoder

# Recorded on this clip at these exact configs (BASELINE.md):
#   defaults (fg 1 / bg 640)   19.22 dB
#   uniform fine (bg step 8)   44.83 dB
#   defaults + center gaze     19.32 dB
RECORDED = {
    "default": 19.22,
    "uniform_fine": 44.83,
    "gazed_center": 19.32,
}
GUARD_DB = 0.1

_REAL_CONTENT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks",
    "real_content.py",
)


def _load_clip():
    spec = importlib.util.spec_from_file_location(
        "real_content", _REAL_CONTENT
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        return mod.make_real_clip()
    except (ImportError, RuntimeError) as e:
        pytest.skip(f"real-content clip unavailable: {e}")


@pytest.fixture(scope="module")
def real_stream():
    clip = _load_clip()
    cfg = EncoderConfig()  # full reference defaults
    props = VideoProperties(352, 288, len(clip))
    enc = Encoder(cfg, props, batch_size=8)
    chunks = list(enc.encode_video(iter(clip)))
    header = bs.Header.unpack(chunks[0])
    return clip[1:], header, chunks[1:]


def _decode(header, payloads, dcfg, gazes=None):
    dec = Decoder(dcfg, header, batch_size=8)
    return np.stack(
        list(dec.decode_frames(iter(payloads), gazes))
    )


class TestQualityGate:
    def test_uniform_fine_psnr(self, real_stream):
        src, header, payloads = real_stream
        dec = _decode(
            header, payloads, DecoderConfig(background_quant_step=8)
        )
        value = psnr(dec, src)
        assert value >= RECORDED["uniform_fine"] - GUARD_DB, (
            f"uniform-fine PSNR regressed: {value:.2f} dB < recorded "
            f"{RECORDED['uniform_fine']} - {GUARD_DB}"
        )

    def test_default_config_psnr(self, real_stream):
        src, header, payloads = real_stream
        dec = _decode(header, payloads, DecoderConfig())
        value = psnr(dec, src)
        assert value >= RECORDED["default"] - GUARD_DB

    def test_gazed_center_psnr(self, real_stream):
        src, header, payloads = real_stream
        gazes = iter([(176, 144)] * len(payloads))
        dec = _decode(header, payloads, DecoderConfig(), gazes)
        value = psnr(dec, src)
        assert value >= RECORDED["gazed_center"] - GUARD_DB
        # the gaze rect must actually help relative to no gaze
        base = psnr(_decode(header, payloads, DecoderConfig()), src)
        assert value > base
