"""Resize ops matching the reference's two OpenCV uses.

* nearest-exact upscale — used to blow MV-grid masks up to frame size in the
  visualizer (reference: libs/encoder.cpp:516-517, INTER_NEAREST_EXACT),
* bilinear resize — used by the decoder to scale the padded reconstruction
  back to the original frame size for display
  (reference: libs/decoder.cpp:210, CV_INTER_LINEAR).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def resize_nearest_exact(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Center-aligned nearest resize of ``(..., H, W)``.

    Matches OpenCV INTER_NEAREST_EXACT: source index =
    round-half-down of the center-aligned coordinate.
    """
    h, w = img.shape[-2], img.shape[-1]
    # src = floor((dst + 0.5) * in/out) — the PIL/skimage convention OpenCV's
    # INTER_NEAREST_EXACT documents itself as matching
    ys = np.minimum(
        np.floor((np.arange(out_h) + 0.5) * h / out_h), h - 1
    ).astype(np.int32)
    xs = np.minimum(
        np.floor((np.arange(out_w) + 0.5) * w / out_w), w - 1
    ).astype(np.int32)
    return img[..., ys, :][..., :, xs]


def bilinear_axis_weights(out_n: int, in_n: int):
    """Center-aligned bilinear source indices/fractions for one axis
    (OpenCV INTER_LINEAR mapping ``src = (dst + 0.5) * scale - 0.5`` with
    edge clamping). Returns ``(i0, i1, frac, identity)`` — host numpy;
    ``identity`` is True when every fraction is exactly zero (the axis is
    a pure index map, callers may skip the blend bit-identically)."""
    src = (np.arange(out_n) + 0.5) * in_n / out_n - 0.5
    i0 = np.floor(src).astype(np.int32)
    frac = (src - i0).astype(np.float32)
    # clamp to valid range; OpenCV clamps coordinates at the borders
    frac = np.where(i0 < 0, 0.0, frac)
    frac = np.where(i0 >= in_n - 1, 0.0, frac).astype(np.float32)
    i0 = np.clip(i0, 0, in_n - 1)
    i1 = np.clip(i0 + 1, 0, in_n - 1)
    return i0, i1, frac, bool((frac == 0).all())


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Center-aligned bilinear resize of float ``(..., H, W)`` or
    ``(..., H, W, C)`` data, matching OpenCV INTER_LINEAR coordinate
    mapping ``src = (dst + 0.5) * scale - 0.5`` with edge clamping.
    """
    channels_last = img.ndim >= 3 and img.shape[-1] <= 4
    if channels_last:
        h, w = img.shape[-3], img.shape[-2]
    else:
        h, w = img.shape[-2], img.shape[-1]
    # the weights stay host-side numpy: the identity decisions need
    # concrete values even while tracing
    y0, y1, fy, y_ident = bilinear_axis_weights(out_h, h)
    x0, x1, fx, x_ident = bilinear_axis_weights(out_w, w)

    def blend(x, axis, i0, i1, frac, ident, n_in):
        """Resample ``x`` along ``axis``; an identity axis (all-zero
        fractions) skips the second gather and the blend, and a same-size
        identity skips the gather too — multiplying by exact 0/1 weights
        is bit-identical."""
        if ident:
            return x if len(i0) == n_in else jnp.take(x, i0, axis=axis)
        fshape = [1] * x.ndim
        fshape[axis] = -1
        f = frac.reshape(fshape)
        return jnp.take(x, i0, axis=axis) * (1 - f) + jnp.take(
            x, i1, axis=axis
        ) * f

    y_axis, x_axis = (-3, -2) if channels_last else (-2, -1)
    mid = blend(img, img.ndim + y_axis, y0, y1, fy, y_ident, h)
    return blend(mid, img.ndim + x_axis, x0, x1, fx, x_ident, w)
