"""Blockwise DCT/IDCT and quantization tests (oracle: cv2.dct/idct)."""

import numpy as np
import pytest

import jax.numpy as jnp

from svc_tpu.ops.dct import dct2_blockwise, dct_matrix, idct2_blockwise
from svc_tpu.ops.quant import block_quant_steps, quantize, round_half_away

cv2 = pytest.importorskip("cv2")


def _blockwise_cv_dct(plane, bw, bh, inverse=False):
    out = plane.copy()
    for y in range(0, plane.shape[0], bh):
        for x in range(0, plane.shape[1], bw):
            blk = plane[y : y + bh, x : x + bw]
            out[y : y + bh, x : x + bw] = (
                cv2.idct(blk) if inverse else cv2.dct(blk)
            )
    return out


class TestDct:
    def test_dct_matrix_orthonormal(self):
        d = dct_matrix(8)
        np.testing.assert_allclose(d @ d.T, np.eye(8), atol=1e-6)

    @pytest.mark.parametrize("bw,bh", [(8, 8), (4, 8), (8, 4)])
    def test_forward_matches_opencv(self, bw, bh):
        rng = np.random.default_rng(0)
        plane = rng.uniform(0, 255, (16, 24)).astype(np.float32)
        ref = _blockwise_cv_dct(plane, bw, bh)
        got = np.asarray(dct2_blockwise(jnp.asarray(plane), bw, bh))
        np.testing.assert_allclose(got, ref, atol=2e-3)

    def test_inverse_matches_opencv(self):
        rng = np.random.default_rng(1)
        coeffs = rng.uniform(-500, 500, (16, 16)).astype(np.float32)
        ref = _blockwise_cv_dct(coeffs, 8, 8, inverse=True)
        got = np.asarray(idct2_blockwise(jnp.asarray(coeffs), 8, 8))
        np.testing.assert_allclose(got, ref, atol=2e-3)

    def test_roundtrip_identity(self):
        rng = np.random.default_rng(2)
        plane = rng.uniform(0, 255, (32, 32)).astype(np.float32)
        coeffs = dct2_blockwise(jnp.asarray(plane), 8, 8)
        back = np.asarray(idct2_blockwise(coeffs, 8, 8))
        np.testing.assert_allclose(back, plane, atol=1e-3)

    def test_batched_channels(self):
        rng = np.random.default_rng(3)
        planes = rng.uniform(0, 255, (3, 16, 16)).astype(np.float32)
        got = np.asarray(dct2_blockwise(jnp.asarray(planes), 8, 8))
        for c in range(3):
            single = np.asarray(dct2_blockwise(jnp.asarray(planes[c]), 8, 8))
            np.testing.assert_array_equal(got[c], single)

    def test_dc_coefficient_is_scaled_block_mean(self):
        plane = np.full((8, 8), 100.0, np.float32)
        coeffs = np.asarray(dct2_blockwise(jnp.asarray(plane), 8, 8))
        assert abs(coeffs[0, 0] - 800.0) < 1e-3  # mean * N for orthonormal
        assert np.abs(coeffs).sum() - abs(coeffs[0, 0]) < 1e-3


class TestQuant:
    def test_round_half_away_from_zero(self):
        x = jnp.asarray([0.5, -0.5, 2.5, -2.5, 1.2, -1.2])
        np.testing.assert_array_equal(
            np.asarray(round_half_away(x)), [1, -1, 3, -3, 1, -1]
        )

    def test_quantize_matches_scalar_semantics(self):
        coeffs = jnp.asarray([637.0, -637.0, 319.9, 320.0])
        got = np.asarray(quantize(coeffs, jnp.float32(640)))
        np.testing.assert_array_equal(got, [640, -640, 0, 640])

    def test_step_one_identity_after_round(self):
        coeffs = jnp.asarray([1.4, -1.6, 0.5])
        got = np.asarray(quantize(coeffs, jnp.float32(1)))
        np.testing.assert_array_equal(got, [1, -2, 1])

    def test_block_quant_steps(self):
        types = jnp.asarray([[0, 3], [1, 0]], jnp.uint32)
        gazed = jnp.asarray([[False, False], [True, True]])
        steps = np.asarray(block_quant_steps(types, gazed, 2, 640))
        np.testing.assert_array_equal(steps, [[640, 2], [1, 1]])


# the wire-layout shapes the encoder and decoder run: (C, T, H, W) planes
# and (T, nby, nbx) coefficient grids, including lane-unaligned widths
WIRE_PLANE_SHAPES = [(3, 2, 32, 48), (3, 3, 64, 256)]
WIRE_GRIDS = [(2, 16, 32), (1, 8, 24)]


def _scipy_dct_blocks(planes, bh, bw, inverse=False):
    """float64 blockwise orthonormal DCT-II (or III) of ``(..., H, W)``."""
    fft = pytest.importorskip("scipy.fft")
    *lead, h, w = planes.shape
    x = planes.astype(np.float64).reshape(*lead, h // bh, bh, w // bw, bw)
    fn = fft.idctn if inverse else fft.dctn
    return fn(x, type=2, norm="ortho", axes=(-3, -1)).reshape(planes.shape)


def _wire_to_planes_np(wire, channels, bh, bw):
    """(T, nby, nbx, C*bh*bw) -> (T, C, nby*bh, nbx*bw), host NumPy."""
    t, nby, nbx, _ = wire.shape
    x = wire.reshape(t, nby, nbx, channels, bh, bw)
    return x.transpose(0, 3, 1, 4, 2, 5).reshape(
        t, channels, nby * bh, nbx * bw
    )


class TestWireDct:
    """The encoder's wire-layout forward DCT and the decoder's wire-layout
    inverse against independent oracles (OpenCV per block, and SciPy in
    float64): the forward transform within the README's 2.5e-4 absolute
    coefficient gate."""

    @pytest.mark.parametrize("oracle", ["opencv", "scipy"])
    @pytest.mark.parametrize("shape", WIRE_PLANE_SHAPES)
    def test_forward_wire_matches_oracle(self, shape, oracle):
        from svc_tpu.ops.dct import dct2_planes_to_wire

        rng = np.random.default_rng(sum(shape))
        planes = rng.integers(0, 256, shape, dtype=np.uint8)
        got = np.asarray(dct2_planes_to_wire(jnp.asarray(planes), 8, 8))
        c, t, h, w = shape
        assert got.shape == (t, h // 8, w // 8, c * 64)
        got_planes = _wire_to_planes_np(got, c, 8, 8)  # (T, C, H, W)
        src = planes.transpose(1, 0, 2, 3).astype(np.float32)
        if oracle == "opencv":
            ref = np.stack(
                [
                    [_blockwise_cv_dct(src[i, ch], 8, 8) for ch in range(c)]
                    for i in range(t)
                ]
            )
        else:
            ref = _scipy_dct_blocks(src, 8, 8)
        np.testing.assert_allclose(got_planes, ref, atol=2.5e-4, rtol=0)

    @pytest.mark.parametrize("bh,bw", [(8, 8), (4, 8), (16, 16)])
    def test_split_weights_hi_sums_exactly(self, bh, bw):
        """Every partial sum of ``uint8 @ hi`` is a float32-exact multiple
        of 2**-frac, and ``hi + lo`` is the float64 transform."""
        from svc_tpu.ops.dct import _dct_matrix64, fwd_split_weights

        weights, frac = fwd_split_weights(bh, bw)
        n = bh * bw
        hi = weights[:, :n].astype(np.float64)
        lo = weights[:, n:].astype(np.float64)
        assert np.array_equal(hi * 2.0**frac, np.round(hi * 2.0**frac))
        assert 255 * np.abs(hi).sum(axis=0).max() < 2.0 ** (24 - frac)
        assert np.abs(lo).max() <= 2.0 ** -(frac + 1)
        exact = np.kron(_dct_matrix64(bh), _dct_matrix64(bw)).T
        np.testing.assert_allclose(hi + lo, exact, rtol=0, atol=1e-11)

    @pytest.mark.parametrize("shape", WIRE_PLANE_SHAPES + [(3, 1, 136, 240)])
    def test_forward_wire_within_half_ulp(self, shape):
        """Each coefficient is the exact transform rounded once: within
        half a float32 ulp (plus the lo half's ~1e-7) of float64 SciPy,
        including saturated blocks whose DC is 2040."""
        from svc_tpu.ops.dct import dct2_planes_to_wire

        rng = np.random.default_rng(sum(shape) + 1)
        planes = rng.integers(0, 256, shape, dtype=np.uint8)
        planes[..., :8, :16] = 255
        got = np.asarray(dct2_planes_to_wire(jnp.asarray(planes), 8, 8))
        src = planes.transpose(1, 0, 2, 3)
        ref = _scipy_dct_blocks(src, 8, 8)
        got_planes = _wire_to_planes_np(got, shape[0], 8, 8)
        half_ulp = 0.5 * np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(got_planes - ref) <= half_ulp + 1e-6).all()

    def test_forward_wire_independent_of_summation_order(self):
        """A float32 NumPy evaluation summing the terms in reverse order
        lands within one ulp: the hi sums agree exactly, so only the last
        rounding of ``hi + lo`` can differ (a GPU and a CPU backend differ
        the same way)."""
        from svc_tpu.ops.dct import dct2_planes_to_wire, fwd_split_weights

        rng = np.random.default_rng(5)
        planes = rng.integers(0, 256, (3, 2, 32, 64), dtype=np.uint8)
        got = np.asarray(dct2_planes_to_wire(jnp.asarray(planes), 8, 8))
        weights, _ = fwd_split_weights(8, 8)
        c, t, h, w = planes.shape
        blocks = planes.reshape(c, t, h // 8, 8, w // 8, 8)
        blocks = blocks.transpose(1, 2, 4, 0, 3, 5).reshape(-1, 64)
        x = blocks.astype(np.float32)
        z = np.zeros((x.shape[0], 128), np.float32)
        for i in reversed(range(64)):
            z += x[:, i : i + 1] * weights[i]
        hi64 = x.astype(np.float64) @ weights[:, :64].astype(np.float64)
        assert np.array_equal(z[:, :64], hi64)
        ref = (z[:, :64] + z[:, 64:]).reshape(got.shape)
        assert (np.abs(got - ref) <= np.spacing(np.abs(ref)) + 1e-6).all()

    @pytest.mark.parametrize("oracle", ["opencv", "scipy"])
    @pytest.mark.parametrize("t,nby,nbx", WIRE_GRIDS)
    def test_inverse_wire_matches_oracle(self, t, nby, nbx, oracle):
        from svc_tpu.ops.dct import idct2_wire_to_planes

        c, bh, bw = 3, 8, 8
        rng = np.random.default_rng(nby + nbx)
        wire = (rng.normal(size=(t, nby, nbx, c * bh * bw)) * 120).astype(
            np.float32
        )
        got = np.stack(
            [
                np.asarray(idct2_wire_to_planes(jnp.asarray(f), c, bh, bw))
                for f in wire
            ]
        )
        assert got.shape == (t, c, nby * bh, nbx * bw)
        coeff_planes = _wire_to_planes_np(wire, c, bh, bw)
        if oracle == "opencv":
            ref = np.stack(
                [
                    [
                        _blockwise_cv_dct(coeff_planes[i, ch], bw, bh, True)
                        for ch in range(c)
                    ]
                    for i in range(t)
                ]
            )
        else:
            ref = _scipy_dct_blocks(coeff_planes, bh, bw, inverse=True)
        np.testing.assert_allclose(got, ref, atol=2e-3)
