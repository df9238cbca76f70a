"""Gaussian image pyramid, bit-exact with OpenCV's ``buildPyramid``.

The reference builds an L-level pyramid of the luma plane per frame
(reference: libs/encoder.cpp:470 ``cv::buildPyramid(y, pyr, lvl_count - 1)``)
and the HBMA search consumes every level (libs/motion.cpp:412-465).

``cv::pyrDown`` on 8-bit input is a separable 5-tap binomial filter
[1, 4, 6, 4, 1] in each dimension (sum 256), computed in integer arithmetic
with BORDER_REFLECT_101 and final round-half-up descaling by 8 bits, sampled
at even coordinates. This implementation reproduces that integer pipeline
exactly using stride-2 slicing (no data-dependent shapes),
so pyramid levels — and hence motion fields — can match the C++ reference
bit-for-bit.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

_TAPS = (1, 4, 6, 4, 1)


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """One pyramid level reduction of a ``(..., H, W)`` uint8 plane.

    Output dims are ``ceil(H/2), ceil(W/2)`` (here always exact halves:
    codec padding keeps dims divisible by ``2**(levels-1)``).

    The stride-2 5-tap filter is decomposed into even/odd phases so every
    arithmetic op runs on contiguous half-resolution planes:
    ``out[i] = E[i-1] + 6E[i] + E[i+1] + 4(O[i-1] + O[i])`` with
    ``E[i] = x[2i], O[i] = x[2i+1]``. The horizontal stage stays in int16
    (sums <= 16*255), halving memory traffic; the vertical stage needs
    int32 (<= 256*255).
    """
    h, w = img.shape[-2], img.shape[-1]
    out_h, out_w = (h + 1) // 2, (w + 1) // 2
    if h % 2 or w % 2:
        return _pyr_down_general(img)

    def filt(x, axis_last: bool):
        # x padded by 2 (reflect-101) along the target axis, even length
        if axis_last:
            e = x[..., 0::2]
            o = x[..., 1::2]
            return (
                e[..., :-2] + 6 * e[..., 1:-1] + e[..., 2:]
                + 4 * (o[..., :-2] + o[..., 1:-1])
            )
        e = x[..., 0::2, :]
        o = x[..., 1::2, :]
        return (
            e[..., :-2, :] + 6 * e[..., 1:-1, :] + e[..., 2:, :]
            + 4 * (o[..., :-2, :] + o[..., 1:-1, :])
        )

    pad_w = [(0, 0)] * (img.ndim - 1) + [(2, 2)]
    x = jnp.pad(img.astype(jnp.int16), pad_w, mode="reflect")
    x = filt(x, axis_last=True)  # (..., H, out_w + 1) int16, <= 4080

    pad_h = [(0, 0)] * (img.ndim - 2) + [(2, 2), (0, 0)]
    x = jnp.pad(x.astype(jnp.int32), pad_h, mode="reflect")
    x = filt(x, axis_last=False)

    # OpenCV descale: (sum + 128) >> 8
    x = (x + 128) >> 8
    return x.astype(jnp.uint8)


def _pyr_down_general(img: jnp.ndarray) -> jnp.ndarray:
    """Odd-dimension fallback: direct strided 5-tap filtering."""
    h, w = img.shape[-2], img.shape[-1]
    out_h, out_w = (h + 1) // 2, (w + 1) // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(2, 2), (2, 2)]
    x = jnp.pad(img.astype(jnp.int32), pad, mode="reflect")
    x = sum(_TAPS[k] * x[..., :, k : k + 2 * out_w : 2] for k in range(5))
    x = sum(_TAPS[k] * x[..., k : k + 2 * out_h : 2, :] for k in range(5))
    return ((x + 128) >> 8).astype(jnp.uint8)


def build_pyramid(img: jnp.ndarray, level_count: int) -> List[jnp.ndarray]:
    """Levels 0..level_count-1; level 0 is the input itself
    (matching ``cv::buildPyramid(src, dst, maxlevel=level_count-1)``)."""
    levels = [img]
    for _ in range(level_count - 1):
        levels.append(pyr_down(levels[-1]))
    return levels
