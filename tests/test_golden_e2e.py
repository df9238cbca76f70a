"""End-to-end golden parity against the reference's full Encoder pipeline.

Builds ``tests/golden/e2e_harness.cpp`` linking the UNMODIFIED
``libs/encoder.cpp`` + ``libs/motion.cpp`` and runs the complete reference
encoder (encoder.cpp:144-671) on a deterministic clip, then runs our
encoder CLI app on the same pixels and compares the bitstreams.

Determinism design (the reference's RANSAC is seeded from
``std::random_device``, motion.cpp:186-187, and cv::kmeans uses OpenCV's
RNG — SURVEY.md Q7 — so the clip and config are chosen to make the output
independent of both):

* **Static noise background** — every background block matches itself with
  MAD 0 at MV (0,0) at every pyramid level, so the motion field is exactly
  0 there. Any RANSAC sample drawn from a zero-MV block yields the model
  (0,0) and therefore THE SAME maximal inlier set; samples from moving
  blocks yield far smaller sets and lose to the ``>=`` keep rule
  (motion.cpp:233-237). The probability that none of the ~7 iterations
  samples a zero-MV block is < 1e-6.
* **Fast textured objects** — velocity (6,-5): squared distance 61 >
  inlier_thresh^2 = 56.25 (motion.cpp:228), so tracked object blocks are
  outliers = foreground.
* **kmeans.cluster_count = 1** — a single cluster regardless of RNG, so
  the foreground region labeling reduces to one connectedComponents pass
  (encoder.cpp:597-623), which is deterministic.
* **Input parity** — frames are fed to the harness as raw BGR bytes and to
  our app as a raw BI_RGB AVI; both are bit-exact (no colorspace round
  trip; see io/video.py).

Compared byte-for-byte: the 32-byte header and every block-type field.
DCT coefficients (RNG-independent) are compared at the measured ulp gate
documented in BASELINE.md: our matrix-product DCT vs OpenCV's factorized DCT
(encoder.cpp:323-339) differ only in float32 summation order.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

_DIR = os.path.join(os.path.dirname(__file__), "golden")
_REF = os.environ.get("SVC_REFERENCE_DIR", "/root/reference")
_HARNESS = os.path.join(_DIR, "e2e_harness")

# Re-baselined DCT coefficient gate (BASELINE.md "DCT coefficient gate"):
# measured max |diff| <= 1.9e-4 on this clip — about two ulp at the DC
# magnitude scale (coefficients reach 255*8 = 2040; 2040 * 2^-23 =
# 2.4e-4). Float32 summation-order divergence is ABSOLUTE, not relative,
# for a fixed-magnitude transform, so the primary gate is absolute; the
# secondary ulp bound is asserted where |coeff| >= 1, where the absolute
# gate implies <= 2.5e-4 / ulp(1.0) ~= 2100 ulp (measured 1056).
MAX_ABSDIFF = 2.5e-4
MAX_ULP_NONTINY = 4096
ULP_CUTOFF = 1.0


def _build_harness():
    src = os.path.join(_DIR, "e2e_harness.cpp")
    if os.path.exists(_HARNESS) and (
        os.path.getmtime(_HARNESS) >= os.path.getmtime(src)
    ):
        return True
    if os.path.exists(_HARNESS):
        os.remove(_HARNESS)  # stale binary predates a harness change
    if not os.path.isdir(_REF):
        return False
    try:
        cflags = subprocess.run(
            ["pkg-config", "--cflags", "opencv4"],
            capture_output=True, text=True, check=True,
        ).stdout.split()
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-msse2", "-DSVC_MOTION_SSE2",
             f"-I{_REF}/libs",
             os.path.join(_DIR, "e2e_harness.cpp"),
             f"{_REF}/libs/encoder.cpp", f"{_REF}/libs/motion.cpp",
             os.path.join(_DIR, "thread_shim.cpp")]
            + cflags
            + ["-lopencv_core", "-lopencv_imgproc", "-o", _HARNESS],
            check=True, capture_output=True,
        )
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _make_parity_clip(w=352, h=288, n=6, seed=3):
    """Static noise bg + two noise objects moving exactly (6,-5)/frame."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    tex1 = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    tex2 = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        fr = bg.copy()
        x1, y1 = 64 + 6 * t, 160 - 5 * t
        x2, y2 = 208 + 6 * t, 96 - 5 * t
        fr[y1 : y1 + 48, x1 : x1 + 64] = tex1
        fr[y2 : y2 + 32, x2 : x2 + 48] = tex2
        frames[t] = fr
    return frames


def _parse_stream(raw):
    hdr = np.frombuffer(raw[:32], np.uint32)
    fc, fw, fh, ew, eh, tbw, tbh, cc = (int(x) for x in hdr)
    assert (ew, eh) == (0, 0), "parity clip must be zero-excess"
    gx, gy = fw // tbw, fh // tbh
    blocksz = 4 + 4 * tbw * tbh * cc
    body = np.frombuffer(raw[32:], np.uint8)
    assert body.size == fc * gx * gy * blocksz
    arr = body.reshape(fc, gx * gy, blocksz)
    btypes = arr[:, :, :4].copy().view(np.uint32)[..., 0]
    coeffs = arr[:, :, 4:].copy().view(np.float32)
    return raw[:32], btypes, coeffs


def _ulp_distance(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    # map to a monotonic integer line so the difference counts
    # representable floats between a and b (sign-magnitude -> offset)
    ma = np.where(ia >= 0, ia, np.int64(-(2**31)) - ia)
    mb = np.where(ib >= 0, ib, np.int64(-(2**31)) - ib)
    return np.abs(ma - mb)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    if not _build_harness():
        pytest.skip("reference e2e harness unavailable")
    tmp = tmp_path_factory.mktemp("e2e")
    clip = _make_parity_clip()
    n = clip.shape[0]

    ref = subprocess.run(
        [_HARNESS, "352", "288", str(n), "1"],
        input=clip.tobytes(), capture_output=True, check=True,
    ).stdout

    from svc_tpu.io.video import write_raw_avi

    avi = str(tmp / "clip.avi")
    write_raw_avi(avi, clip)
    out = str(tmp / "ours.svc")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with open(out, "wb") as f:
        subprocess.run(
            [sys.executable, "-m", "svc_tpu.apps.encoder_app",
             "--kmeans-cluster-count", "1", avi],
            stdout=f, stderr=subprocess.PIPE, check=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
    ours = open(out, "rb").read()
    return ref, ours


class TestGoldenEndToEnd:
    def test_stream_sizes_match(self, streams):
        ref, ours = streams
        assert len(ref) == len(ours)

    def test_header_bytes_equal(self, streams):
        ref, ours = streams
        assert ref[:32] == ours[:32]

    def test_block_types_byte_equal(self, streams):
        """Foreground/background split AND region ids, every frame."""
        _, rt, _ = _parse_stream(streams[0])
        _, ot, _ = _parse_stream(streams[1])
        assert np.array_equal(rt, ot)

    def test_foreground_nontrivial(self, streams):
        """The clip must actually exercise segmentation on both sides."""
        _, rt, _ = _parse_stream(streams[0])
        fg = (rt != 0).mean()
        assert 0.01 < fg < 0.5

    def test_dct_coefficients_within_measured_gate(self, streams):
        _, _, rc = _parse_stream(streams[0])
        _, _, oc = _parse_stream(streams[1])
        absdiff = np.abs(rc - oc)
        assert float(absdiff.max()) <= MAX_ABSDIFF, (
            f"max |diff| {absdiff.max():.3e} exceeds gate {MAX_ABSDIFF:.1e}"
        )
        nontiny = np.abs(rc) >= ULP_CUTOFF
        ulp = _ulp_distance(rc, oc)[nontiny]
        exact = float((_ulp_distance(rc, oc) == 0).mean())
        assert int(ulp.max()) <= MAX_ULP_NONTINY, (
            f"max ulp {int(ulp.max())} exceeds gate {MAX_ULP_NONTINY} "
            f"(exact-bit fraction {exact:.4f})"
        )


def _make_kclamp_clip(w=352, h=288, n=6, seed=11):
    """Static noise bg + ONE 16x16 object moving (6,-5), never
    block-aligned: the foreground never exceeds a handful of MV blocks, so
    ``fg_count < cluster_count`` — the reference's k-clamp regime
    (libs/encoder.cpp:557-559: k = min(cluster_count, fg_count))."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    tex = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        fr = bg.copy()
        x, y = 65 + 6 * t, 161 - 5 * t
        fr[y : y + 16, x : x + 16] = tex
        frames[t] = fr
    return frames


class TestKClampRegime:
    """The reference clamps k = min(cluster_count, fg_count)
    (libs/encoder.cpp:557-559); the static-shape design instead always runs
    ``cluster_count`` centers, with an empty cluster contributing exactly
    +1 to the block-type offset (its ``cv::connectedComponents`` analog
    returns 1 label — just the background). This class constructs the
    0 < fg_count < cluster_count regime and asserts the documented
    consequences:

    * the bg/fg classification is identical to the reference (decode only
      distinguishes 0 vs nonzero, libs/decoder.cpp:128-135),
    * region STRUCTURE matches: per frame the reference and our block
      types are related by a bijection (ids permute with cluster order,
      which is RNG-path dependent — quirk Q7),
    * on frames where fg_count == 1 both sides are RNG-independent and the
      ids must agree exactly, offset by +1 per empty cluster preceding the
      single populated one (here our labels are compact, so byte-equal).
    """

    @pytest.fixture(scope="class")
    def kclamp(self):
        if not _build_harness():
            pytest.skip("reference e2e harness unavailable")
        clip = _make_kclamp_clip()
        n, h, w = clip.shape[0], clip.shape[1], clip.shape[2]
        # morph 1x1 (identity) so the tiny foreground survives; k = 10
        ref = subprocess.run(
            [_HARNESS, str(w), str(h), str(n), "10", "1", "1"],
            input=clip.tobytes(), capture_output=True, check=True,
        ).stdout
        _, ref_bt, _ = _parse_stream(ref)
        gy, gx = h // 8, w // 8
        ref_bt = ref_bt.reshape(n - 1, gy, gx)

        from svc_tpu.config import EncoderConfig, VideoProperties
        from svc_tpu.models.encoder import Encoder

        cfg = EncoderConfig(morph_rect_w=1, morph_rect_h=1)
        enc = Encoder(cfg, VideoProperties(w, h, n), batch_size=n - 1)
        out = enc.encode_batch(clip, 0)
        ours_bt = np.asarray(out["block_types"])  # per MV block
        ours_exp = np.repeat(np.repeat(ours_bt, 2, 1), 2, 2)
        fg = np.asarray(out["foreground_mask"])
        labels = np.asarray(out["cluster_labels"])
        return ref_bt, ours_exp, fg, labels, cfg.kmeans.cluster_count

    def test_regime_is_exercised(self, kclamp):
        """Every payload frame must sit in 0 <= fg_count < cluster_count,
        with at least one frame at fg_count == 1 and one with several."""
        _, _, fg, _, k = kclamp
        counts = fg.reshape(fg.shape[0], -1).sum(1)
        assert counts.max() < k
        assert (counts == 1).any()
        assert (counts > 1).any()

    def test_bg_fg_classification_matches_reference(self, kclamp):
        ref_bt, ours, _, _, _ = kclamp
        np.testing.assert_array_equal(ref_bt != 0, ours != 0)

    def test_region_structure_bijective(self, kclamp):
        ref_bt, ours, _, _, _ = kclamp
        for f in range(ref_bt.shape[0]):
            pairs = set(
                zip(ref_bt[f].ravel().tolist(), ours[f].ravel().tolist())
            )
            fwd = {}
            for a, b in pairs:
                assert fwd.setdefault(a, b) == b, (
                    f"frame {f}: ref id {a} maps to both {fwd[a]} and {b}"
                )
            assert len(set(fwd.values())) == len(fwd), (
                f"frame {f}: our ids collapse distinct reference ids"
            )

    def test_single_fg_frames_match_with_empty_offset(self, kclamp):
        ref_bt, ours, fg, labels, _ = kclamp
        seen = 0
        for f in range(ref_bt.shape[0]):
            if int(fg[f].sum()) != 1:
                continue
            seen += 1
            # reference: k clamps to 1 -> the lone region gets id 1
            assert set(ref_bt[f][ref_bt[f] != 0].tolist()) == {1}
            # ours: id = 1 + (#empty clusters before the populated one),
            # each empty contributing exactly +1 to the offset
            c = int(labels[f][fg[f]][0])
            assert set(ours[f][ours[f] != 0].tolist()) == {1 + c}
        assert seen >= 1


def _build_decoder_harness():
    path = os.path.join(_DIR, "decoder_harness")
    if os.path.exists(path):
        return path
    if not os.path.isdir(_REF):
        return None
    try:
        cflags = subprocess.run(
            ["pkg-config", "--cflags", "opencv4"],
            capture_output=True, text=True, check=True,
        ).stdout.split()
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-DCV_INTER_LINEAR=1",
             f"-I{_REF}/libs",
             os.path.join(_DIR, "decoder_harness.cpp"),
             os.path.join(_DIR, "thread_shim.cpp")]
            + cflags
            + ["-lopencv_core", "-lopencv_imgproc", "-lopencv_highgui",
               "-o", path],
            check=True, capture_output=True,
        )
        return path
    except (OSError, subprocess.CalledProcessError):
        return None


class TestGoldenDecoder:
    """Block decode parity vs the unmodified reference ParseBlock +
    DecodeBlock (libs/decoder.cpp:102-149): dequantization with
    gaze/region step selection, per-channel cv::idct, channel merge."""

    @pytest.mark.parametrize(
        "fg,bg,rect",
        [
            (1, 640, (0, 0, 0, 0)),       # defaults, no gaze
            (2, 16, (64, 48, 96, 64)),    # gazed region unquantized
        ],
    )
    def test_decoded_padded_frames_match(self, streams, fg, bg, rect):
        harness = _build_decoder_harness()
        if harness is None:
            pytest.skip("reference decoder harness unavailable")
        ref_stream = streams[0]
        hdr = np.frombuffer(ref_stream[:32], np.uint32)
        fc, fw, fh = int(hdr[0]), int(hdr[1]), int(hdr[2])

        golden = subprocess.run(
            [harness, str(fg), str(bg)] + [str(v) for v in rect],
            input=ref_stream, capture_output=True, check=True,
        ).stdout
        golden = np.frombuffer(golden, np.float32).reshape(
            fc, fh, fw, 3
        )

        import jax.numpy as jnp

        from svc_tpu.io import bitstream
        from svc_tpu.ops.dct import idct2_wire_to_planes
        from svc_tpu.ops.quant import block_quant_steps, quantize

        header = bitstream.Header.unpack(ref_stream[:32])
        body = ref_stream[32:]
        fsize = header.block_byte_count * (fw // 8) * (fh // 8)
        bys = np.arange(fh // 8, dtype=np.int32)[:, None] * 8
        bxs = np.arange(fw // 8, dtype=np.int32)[None, :] * 8
        gazed = (
            (bxs >= rect[0]) & (bxs < rect[0] + rect[2])
            & (bys >= rect[1]) & (bys < rect[1] + rect[3])
        )
        worst = 0.0
        for f in range(fc):
            types, coeffs = bitstream.deserialize_frame_blocks(
                body[f * fsize : (f + 1) * fsize], header
            )
            steps = block_quant_steps(
                jnp.asarray(types), jnp.asarray(gazed), fg, bg
            )
            deq = quantize(
                jnp.asarray(coeffs.reshape(fh // 8, fw // 8, -1)),
                steps[:, :, None],
            )
            planes = np.asarray(idct2_wire_to_planes(deq, 3, 8, 8))
            ours = np.moveaxis(planes, 0, -1)
            worst = max(worst, float(np.abs(ours - golden[f]).max()))
        # IDCT of (de)quantized 0..2040-scale coefficients: float32
        # summation-order divergence stays absolute, same scale as the
        # forward gate (BASELINE.md)
        assert worst <= 2.5e-4, f"max |diff| {worst:.3e}"
