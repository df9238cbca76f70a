"""Card-only checks: the codec on an NVIDIA GPU against the same programs
on the host CPU backend, and the exactness the parity gates rely on.

Marked ``gpu``; each test takes the ``gpu_device`` fixture, which skips
where JAX finds no GPU. Run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (``chip_smoke.py``
does this in a child process before it opens the card itself).
"""

import numpy as np
import pytest

import jax

from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.models.decoder import Decoder
from svc_tpu.models.encoder import Encoder

pytestmark = pytest.mark.gpu


def _clip(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 8 + 4, w // 8 + 4, 3))
    base = np.kron(coarse, np.ones((8, 8, 1))).astype(np.uint8)
    return np.stack(
        [base[i % 4 : i % 4 + h, 2 * i : 2 * i + w] for i in range(t)]
    )


def _encode_on(enc, packed, device):
    keys = enc._keys(0, packed.shape[0] - 1)
    out = enc._encode_batch(
        jax.device_put(packed, device), jax.device_put(keys, device)
    )
    return {k: np.asarray(v) for k, v in out.items()}


def test_encode_batch_matches_cpu(gpu_device):
    t, h, w = 4, 96, 160
    enc = Encoder(EncoderConfig(), VideoProperties(w, h, t + 1), batch_size=t)
    packed = _clip(t + 1, h, w).reshape(t + 1, h, w * 3)
    got = _encode_on(enc, packed, gpu_device)
    ref = _encode_on(enc, packed, jax.devices("cpu")[0])
    for key in ("mv_field", "foreground_mask", "block_types"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["coeffs"], ref["coeffs"], atol=2.5e-4)


def test_decode_batch_matches_cpu(gpu_device):
    t, h, w = 2, 56, 128  # row excess: the display resample runs
    enc = Encoder(EncoderConfig(), VideoProperties(w, h, t + 1), batch_size=t)
    dec = Decoder(DecoderConfig(), enc.header(), batch_size=t)
    rng = np.random.default_rng(1)
    nby, nbx = enc.padded_h // 8, enc.padded_w // 8
    coeffs = (rng.normal(size=(t, nby, nbx, 192)) * 90).astype(np.float32)
    btypes = rng.integers(0, 3, (t, nby, nbx)).astype(np.uint32)
    rects = np.tile(np.array([[32, 16, 64, 32]], np.int32), (t, 1))
    outs = []
    for device in (gpu_device, jax.devices("cpu")[0]):
        args = [jax.device_put(a, device) for a in (coeffs, btypes, rects)]
        outs.append(np.asarray(dec._decode_batch(*args)).astype(np.int32))
    assert np.abs(outs[0] - outs[1]).max() <= 1


def test_wire_dct_keeps_full_f32_precision(gpu_device):
    """A float32 product run in TF32 would miss the 2.5e-4 gate by
    orders of magnitude; HIGHEST must hold on the card, and with it the
    exact hi sums of the split transform (ops/dct.py)."""
    fft = pytest.importorskip("scipy.fft")
    from svc_tpu.ops.dct import dct2_planes_to_wire

    rng = np.random.default_rng(2)
    planes = rng.integers(0, 256, (3, 2, 64, 128), dtype=np.uint8)
    got = np.asarray(
        dct2_planes_to_wire(jax.device_put(planes, gpu_device), 8, 8)
    )
    c, t, h, w = planes.shape
    got = got.reshape(t, h // 8, w // 8, c, 8, 8).transpose(0, 3, 1, 4, 2, 5)
    x = planes.transpose(1, 0, 2, 3).astype(np.float64)
    ref = fft.dctn(
        x.reshape(t, c, h // 8, 8, w // 8, 8),
        type=2, norm="ortho", axes=(-3, -1),
    )
    np.testing.assert_allclose(got, ref, atol=2.5e-4, rtol=0)
    # the split transform rounds once: half an ulp, as on the CPU
    half_ulp = 0.5 * np.spacing(np.abs(ref).astype(np.float32))
    assert (np.abs(got - ref) <= half_ulp + 1e-6).all()


def test_sad_table_is_exact(gpu_device):
    """The bf16-operand / f32-accumulate SAD reduction is integer-exact."""
    from svc_tpu.ops.motion import _candidate_offsets, _sad_table

    rng = np.random.default_rng(3)
    h, w, r, b = 32, 64, 2, 8
    tracked = rng.integers(0, 256, (h, w), dtype=np.uint8)
    anchor = rng.integers(0, 256, (h, w), dtype=np.uint8)
    got = np.asarray(
        _sad_table(
            jax.device_put(tracked, gpu_device),
            jax.device_put(anchor, gpu_device),
            r, b, b,
        )
    )
    tp = np.pad(tracked.astype(np.int64), r)
    for i, (dy, dx) in enumerate(_candidate_offsets(r)):
        cand = tp[r + dy : r + dy + h, r + dx : r + dx + w]
        diff = np.abs(cand - anchor.astype(np.int64))
        ref = diff.reshape(h // b, b, w // b, b).sum(axis=(1, 3))
        np.testing.assert_array_equal(got[i], ref)


def test_default_layouts_are_row_major(gpu_device):
    """The compiled encode step's boundary layouts are row-major without
    any pinning, which is what the host ships and the serializer reads."""
    t, h, w = 2, 64, 128
    enc = Encoder(EncoderConfig(), VideoProperties(w, h, t + 1), batch_size=t)
    packed = jax.device_put(
        np.zeros((t + 1, h, w * 3), np.uint8), gpu_device
    )
    keys = jax.device_put(enc._keys(0, t), gpu_device)
    compiled = enc._encode_batch.lower(packed, keys).compile()
    in_fmt = compiled.input_formats[0][0]
    coeff_fmt = compiled.output_formats["coeffs"]
    assert in_fmt.layout.major_to_minor == (0, 1, 2)
    assert coeff_fmt.layout.major_to_minor == (0, 1, 2, 3)
