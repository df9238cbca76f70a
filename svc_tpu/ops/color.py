"""Color conversion: BGR -> luma (Y), matching OpenCV bit-for-bit.

The reference converts each padded BGR frame to YUV and extracts the Y
channel as the motion-estimation input (reference: libs/encoder.cpp:468-469,
``cv::cvtColor(..., COLOR_BGR2YUV)`` + ``cv::extractChannel(..., 0)``).

OpenCV's 8-bit path uses 14-bit fixed-point BT.601 luma coefficients with
round-half-up descaling:

    Y = (R*4899 + G*9617 + B*1868 + (1 << 13)) >> 14

This op reproduces that integer arithmetic exactly so motion fields (and
therefore everything downstream) can match the reference bit-for-bit.
"""

from __future__ import annotations

import jax.numpy as jnp

# OpenCV fixed-point BT.601 weights, 14 fractional bits. The chroma
# coefficients (B2U = round(0.492*2^14), R2V = round(0.877*2^14)) were
# validated bit-exactly against cv2.cvtColor(BGR2YUV) over dense random
# and corner sweeps (tests/test_image_ops.py).
_R2Y = 4899
_G2Y = 9617
_B2Y = 1868
_B2U = 8061
_R2V = 14369
_SHIFT = 14


def bgr_planes_to_y(
    b: jnp.ndarray, g: jnp.ndarray, r: jnp.ndarray
) -> jnp.ndarray:
    """OpenCV-exact luma from separate uint8 channel planes.

    Same arithmetic as :func:`bgr_to_y`, on the ``(3, ...)`` channel
    planes the encoder's other stages read.
    """
    y = (
        r.astype(jnp.int32) * _R2Y
        + g.astype(jnp.int32) * _G2Y
        + b.astype(jnp.int32) * _B2Y
        + (1 << (_SHIFT - 1))
    ) >> _SHIFT
    return y.astype(jnp.uint8)


def bgr_planes_to_yuv(
    b: jnp.ndarray, g: jnp.ndarray, r: jnp.ndarray
):
    """OpenCV-exact full BGR -> YUV from separate uint8 channel planes.

    The reference materializes the full YUV frame and then extracts Y
    (libs/encoder.cpp:468-469); the encoder pipeline computes Y only
    (U/V are dead values there — see bgr_planes_to_y), but the full
    conversion is part of the framework's public op surface. Matches
    ``cv2.cvtColor(..., COLOR_BGR2YUV)`` bit for bit:

        Y = (R*4899 + G*9617 + B*1868 + 2^13) >> 14
        U = sat((B - Y)*8061  + 2^13) >> 14) + 128
        V = sat((R - Y)*14369 + 2^13) >> 14) + 128

    with saturate_cast clamping to [0, 255]. Returns ``(y, u, v)`` uint8
    planes.
    """
    bi = b.astype(jnp.int32)
    gi = g.astype(jnp.int32)
    ri = r.astype(jnp.int32)
    half = 1 << (_SHIFT - 1)
    y = (ri * _R2Y + gi * _G2Y + bi * _B2Y + half) >> _SHIFT
    u = ((bi - y) * _B2U + half) >> _SHIFT
    v = ((ri - y) * _R2V + half) >> _SHIFT
    return (
        jnp.clip(y, 0, 255).astype(jnp.uint8),
        jnp.clip(u + 128, 0, 255).astype(jnp.uint8),
        jnp.clip(v + 128, 0, 255).astype(jnp.uint8),
    )


def bgr_to_y(frame_bgr: jnp.ndarray) -> jnp.ndarray:
    """Extract OpenCV-exact luma from uint8 BGR pixels.

    Args:
      frame_bgr: ``(..., 3)`` uint8 array, channel order B, G, R.

    Returns:
      ``(...)`` uint8 luma plane.
    """
    f = frame_bgr.astype(jnp.int32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = (r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.astype(jnp.uint8)
