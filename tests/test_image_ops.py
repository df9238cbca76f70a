"""Image-op parity tests vs OpenCV (the oracle for the reference's kernels).

cv2 is optional: parity tests skip when it is unavailable; invariants tests
always run.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from svc_tpu.ops.color import bgr_to_y
from svc_tpu.ops.pad import pad_frame, padded_dims
from svc_tpu.ops.pyramid import build_pyramid, pyr_down
from svc_tpu.ops.resize import resize_bilinear, resize_nearest_exact

cv2 = pytest.importorskip("cv2")


def _rand_bgr(h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 3)
    ).astype(np.uint8)


class TestColor:
    def test_bgr_to_y_matches_opencv_exhaustive_grid(self):
        # all (b, g, r) combos on a coarse grid plus edge values
        vals = np.array([0, 1, 2, 63, 64, 127, 128, 200, 254, 255], np.uint8)
        b, g, r = np.meshgrid(vals, vals, vals, indexing="ij")
        bgr = np.stack([b, g, r], axis=-1).reshape(-1, 1, 3)
        expected = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV)[..., 0]
        got = np.asarray(bgr_to_y(jnp.asarray(bgr)))
        np.testing.assert_array_equal(got, expected)

    def test_bgr_to_y_matches_opencv_random(self):
        img = _rand_bgr(64, 48)
        expected = cv2.cvtColor(img, cv2.COLOR_BGR2YUV)[..., 0]
        got = np.asarray(bgr_to_y(jnp.asarray(img)))
        np.testing.assert_array_equal(got, expected)

    def test_bgr_to_yuv_full_matches_opencv_grid(self):
        from svc_tpu.ops.color import bgr_planes_to_yuv

        # all (b, g, r) combos on a coarse grid plus edge values — the
        # chroma channels saturate at the corners, so the grid pins the
        # clamp semantics as well as the fixed-point arithmetic
        vals = np.array([0, 1, 2, 63, 64, 127, 128, 200, 254, 255], np.uint8)
        b, g, r = np.meshgrid(vals, vals, vals, indexing="ij")
        bgr = np.stack([b, g, r], axis=-1).reshape(-1, 1, 3)
        expected = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV)
        y, u, v = bgr_planes_to_yuv(
            jnp.asarray(bgr[..., 0]),
            jnp.asarray(bgr[..., 1]),
            jnp.asarray(bgr[..., 2]),
        )
        np.testing.assert_array_equal(np.asarray(y), expected[..., 0])
        np.testing.assert_array_equal(np.asarray(u), expected[..., 1])
        np.testing.assert_array_equal(np.asarray(v), expected[..., 2])

    def test_bgr_to_yuv_full_matches_opencv_random(self):
        from svc_tpu.ops.color import bgr_planes_to_yuv

        img = _rand_bgr(128, 96)
        expected = cv2.cvtColor(img, cv2.COLOR_BGR2YUV)
        y, u, v = bgr_planes_to_yuv(
            jnp.asarray(img[..., 0]),
            jnp.asarray(img[..., 1]),
            jnp.asarray(img[..., 2]),
        )
        got = np.stack([np.asarray(y), np.asarray(u), np.asarray(v)], -1)
        np.testing.assert_array_equal(got, expected)


class TestPad:
    def test_padded_dims_defaults(self):
        # defaults: mv block 16, 4 levels -> divisible by lcm(16, 8) = 16
        assert padded_dims(352, 288, 16, 16, 4) == (352, 288)
        assert padded_dims(1920, 1080, 16, 16, 4) == (1920, 1088)

    def test_pad_frame_bgr(self):
        img = _rand_bgr(10, 12)
        out = np.asarray(pad_frame(jnp.asarray(img), 16, 16))
        assert out.shape == (16, 16, 3)
        np.testing.assert_array_equal(out[:10, :12], img)
        assert out[10:].sum() == 0 and out[:, 12:].sum() == 0

    def test_pad_plane_batch(self):
        img = np.ones((2, 10, 12), np.uint8)
        out = np.asarray(pad_frame(jnp.asarray(img), 16, 16))
        assert out.shape == (2, 16, 16)
        assert out.sum() == 2 * 10 * 12


class TestPyramid:
    @pytest.mark.parametrize("h,w,seed", [(64, 64, 0), (96, 128, 1), (32, 48, 2)])
    def test_pyr_down_matches_opencv(self, h, w, seed):
        img = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
        expected = cv2.pyrDown(img)
        got = np.asarray(pyr_down(jnp.asarray(img)))
        np.testing.assert_array_equal(got, expected)

    def test_build_pyramid_matches_opencv_buildpyramid(self):
        img = np.random.default_rng(3).integers(0, 256, (96, 160)).astype(np.uint8)
        ours = build_pyramid(jnp.asarray(img), 4)
        ref = [img]
        for _ in range(3):
            ref.append(cv2.pyrDown(ref[-1]))
        assert len(ours) == 4
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(np.asarray(a), b)

    # batched shapes the encoder runs, including 1080p's padded frame and
    # a 1920-wide strip whose half-width is not a power of two
    @pytest.mark.parametrize(
        "t,h,w",
        [
            (2, 64, 128),
            (1, 96, 160),
            (3, 32, 64),
            (2, 136, 240),
            (2, 64, 1920),
            (1, 1088, 1920),
        ],
    )
    def test_pyr_down_batched_matches_opencv(self, t, h, w):
        imgs = np.random.default_rng(h + w).integers(
            0, 256, (t, h, w)
        ).astype(np.uint8)
        got = np.asarray(pyr_down(jnp.asarray(imgs)))
        for i in range(t):
            np.testing.assert_array_equal(got[i], cv2.pyrDown(imgs[i]))

    def test_pyr_down_batched(self):
        imgs = np.random.default_rng(4).integers(0, 256, (3, 32, 32)).astype(np.uint8)
        got = np.asarray(pyr_down(jnp.asarray(imgs)))
        for i in range(3):
            np.testing.assert_array_equal(got[i], cv2.pyrDown(imgs[i]))


class TestResize:
    def test_nearest_exact_mask_upscale_matches_opencv(self):
        # the reference's only nearest use: MV-grid mask -> frame size
        # (libs/encoder.cpp:516-517)
        mask = (
            np.random.default_rng(5).integers(0, 2, (6, 8)) * 255
        ).astype(np.uint8)
        expected = cv2.resize(
            mask, (8 * 16, 6 * 16), interpolation=cv2.INTER_NEAREST_EXACT
        )
        got = np.asarray(resize_nearest_exact(jnp.asarray(mask), 6 * 16, 8 * 16))
        np.testing.assert_array_equal(got, expected)

    def test_nearest_exact_non_integer_scale(self):
        mask = np.arange(35, dtype=np.uint8).reshape(5, 7)
        expected = cv2.resize(mask, (20, 13), interpolation=cv2.INTER_NEAREST_EXACT)
        got = np.asarray(resize_nearest_exact(jnp.asarray(mask), 13, 20))
        np.testing.assert_array_equal(got, expected)

    def test_bilinear_downscale_matches_opencv(self):
        # the decoder's display resize: padded float frame -> original size
        # (libs/decoder.cpp:210)
        rng = np.random.default_rng(6)
        img = rng.normal(size=(16, 24, 3)).astype(np.float32)
        expected = cv2.resize(img, (22, 14), interpolation=cv2.INTER_LINEAR)
        got = np.asarray(resize_bilinear(jnp.asarray(img), 14, 22))
        np.testing.assert_allclose(got, expected, atol=2e-5)

    def test_bilinear_identity(self):
        img = np.random.default_rng(7).normal(size=(8, 8)).astype(np.float32)
        got = np.asarray(resize_bilinear(jnp.asarray(img), 8, 8))
        np.testing.assert_allclose(got, img, atol=1e-6)


class TestBilinearPlanes:
    """The decoder's display resize on ``(C, H, W)`` channel planes
    against ``cv2.resize`` per plane: row-only, column-only and same-size
    (identity) geometries."""

    def _planes(self, seed, h=136, w=240):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(3, h, w)) * 60 + 128).astype(np.float32)

    def _cv(self, planes, out_h, out_w):
        return np.stack(
            [
                cv2.resize(p, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
                for p in planes
            ]
        )

    @pytest.mark.parametrize("out_h", [126, 131, 135])
    def test_rows_match_opencv(self, out_h):
        planes = self._planes(out_h)
        got = np.asarray(resize_bilinear(jnp.asarray(planes), out_h, 240))
        np.testing.assert_allclose(
            got, self._cv(planes, out_h, 240), atol=1e-4, rtol=0
        )

    @pytest.mark.parametrize("out_w", [230, 232, 239])
    def test_columns_match_opencv(self, out_w):
        planes = self._planes(out_w)
        got = np.asarray(resize_bilinear(jnp.asarray(planes), 136, out_w))
        np.testing.assert_allclose(
            got, self._cv(planes, 136, out_w), atol=1e-4, rtol=0
        )

    @pytest.mark.parametrize("channels_last", [False, True])
    def test_same_size_is_exact_identity(self, channels_last):
        planes = self._planes(7, 24, 40)
        if channels_last:
            planes = np.ascontiguousarray(planes.transpose(1, 2, 0))
        h, w = (24, 40)
        got = np.asarray(resize_bilinear(jnp.asarray(planes), h, w))
        np.testing.assert_array_equal(got, planes)
