"""Binary morphology on the MV-grid foreground mask.

The encoder improves the spatial connectivity of the RANSAC foreground mask
with a rectangular-SE morphological close followed by open
(reference: libs/encoder.cpp:189-190, 524-527 — ``cv::morphologyEx`` with
``getStructuringElement(MORPH_RECT, {w, h})``).

Dilation/erosion are windowed max/min — ``lax.reduce_window`` calls whose padding identity reproduces OpenCV's
default border behavior (border pixels never constrain the min during
erosion nor contribute to the max during dilation). The window anchor is
``(k // 2)`` like OpenCV's default ``(-1, -1)`` anchor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _window(mask: jnp.ndarray, kw: int, kh: int, maximum: bool) -> jnp.ndarray:
    ay, ax = kh // 2, kw // 2
    padding = [(0, 0)] * (mask.ndim - 2) + [
        (ay, kh - 1 - ay),
        (ax, kw - 1 - ax),
    ]
    window = (1,) * (mask.ndim - 2) + (kh, kw)
    init = jnp.array(False) if maximum else jnp.array(True)
    op = jax.lax.bitwise_or if maximum else jax.lax.bitwise_and
    return jax.lax.reduce_window(
        mask,
        init,
        op,
        window_dimensions=window,
        window_strides=(1,) * mask.ndim,
        padding=padding,
    )


def dilate(mask: jnp.ndarray, kw: int, kh: int) -> jnp.ndarray:
    """Rect-SE binary dilation of a bool ``(..., H, W)`` mask."""
    return _window(mask, kw, kh, maximum=True)


def erode(mask: jnp.ndarray, kw: int, kh: int) -> jnp.ndarray:
    """Rect-SE binary erosion of a bool ``(..., H, W)`` mask."""
    return _window(mask, kw, kh, maximum=False)


def close(mask: jnp.ndarray, kw: int, kh: int) -> jnp.ndarray:
    """Dilate then erode (``MORPH_CLOSE``)."""
    return erode(dilate(mask, kw, kh), kw, kh)


def open_(mask: jnp.ndarray, kw: int, kh: int) -> jnp.ndarray:
    """Erode then dilate (``MORPH_OPEN``)."""
    return dilate(erode(mask, kw, kh), kw, kh)


def close_then_open(mask: jnp.ndarray, kw: int, kh: int) -> jnp.ndarray:
    """The encoder's exact sequence (libs/encoder.cpp:524-527)."""
    return open_(close(mask, kw, kh), kw, kh)
