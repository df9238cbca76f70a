"""Double-buffered H2D staging (runtime.staging) correctness.

The overlap itself is a timing property, measured on the card; what
the tests pin is the invariant that makes the overlap safe to ship:
the staged stream path produces byte-identical payloads to direct batch
encoding, across batch-boundary and remainder shapes.
"""

import numpy as np
import pytest

from svc_tpu.config import EncoderConfig, VideoProperties
from svc_tpu.models.encoder import Encoder, stream_encode
from svc_tpu.runtime.staging import DoubleBufferedStager


def test_stager_orders_and_rejects_double_submit():
    staged = []
    with DoubleBufferedStager(lambda x: ("dev", x)) as s:
        s.submit(1)
        with pytest.raises(RuntimeError):
            s.submit(2)
        assert s.collect() == ("dev", 1)
        with pytest.raises(RuntimeError):
            s.collect()
        s.submit(2)
        assert s.collect() == ("dev", 2)
        del staged


def test_stager_propagates_stage_errors():
    def boom(x):
        raise ValueError("transfer failed")

    with DoubleBufferedStager(boom) as s:
        s.submit(1)
        with pytest.raises(ValueError, match="transfer failed"):
            s.collect()


@pytest.mark.parametrize("n_frames", [9, 12])  # exact batches + remainder
def test_staged_stream_matches_direct_batches(n_frames):
    t, h, w = 4, 48, 64
    enc = Encoder(
        EncoderConfig(), VideoProperties(w, h, n_frames), batch_size=t
    )
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (n_frames, h, w, 3)).astype(np.uint8)

    # staged streaming path (stream_encode auto-uses the stager on the
    # single-chip batch protocol)
    stream = list(stream_encode(enc, iter(frames)))
    header, payloads = stream[0], stream[1:]
    assert len(payloads) == n_frames - 1

    # direct per-batch dispatch, no staging thread
    direct = []
    i = 0
    while i + 1 < n_frames:
        n_valid = min(t, n_frames - 1 - i)
        window = frames[i : i + n_valid + 1]
        if n_valid < t:  # pad like the stream does
            pad = np.repeat(window[-1:], t - n_valid, axis=0)
            window = np.concatenate([window, pad])
        out = enc.encode_batch(window, i)
        coeffs = np.asarray(out["coeffs"])
        btypes = np.asarray(out["block_types"])
        from svc_tpu.io import bitstream

        tbh, tbw = enc.cfg.transform_block_h, enc.cfg.transform_block_w
        c = coeffs.reshape(
            coeffs.shape[0], coeffs.shape[1], coeffs.shape[2], -1, tbh, tbw
        )
        for k in range(n_valid):
            direct.append(
                bitstream.serialize_frame_blocks(
                    c[k], btypes[k], enc.cfg.mv_block_w, enc.cfg.mv_block_h
                )
            )
        i += n_valid

    assert header == enc.header().pack()
    assert len(direct) == len(payloads)
    for k, (a, b) in enumerate(zip(payloads, direct)):
        assert a == b, f"payload {k} differs"
