"""Blockwise 2-D DCT-II / DCT-III as matrix products.

The encoder applies an orthonormal 2-D DCT to every ``transform_block`` of
every float RGB channel (reference: libs/encoder.cpp:323-339 driving
``cv::dct`` per 8x8 ROI); the decoder inverts per block with ``cv::idct``
(libs/decoder.cpp:128-149). ``cv::dct`` computes the standard orthonormal
type-II DCT, so each block transform is exactly

    Y = D_h @ X @ D_w^T        (forward)
    X = D_h^T @ Y @ D_w        (inverse)

with ``D_n[k, j] = s_k * cos(pi * (2j + 1) * k / (2n))``,
``s_0 = sqrt(1/n)``, ``s_k = sqrt(2/n)``.

Instead of looping ROIs, whole frames are transformed at once: the blocks
of a batch form one big matmul against a small transform matrix. float32
throughout, every contraction at ``Precision.HIGHEST`` so
that no backend lowers it to a reduced-precision (bf16/TF32) product
(parity with OpenCV's float path is to ~1e-3 absolute on 0..255 inputs;
bit-exactness is not defined across differing float summation orders).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _dct_matrix64(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, float32."""
    return _dct_matrix64(n).astype(np.float32)


@functools.lru_cache(maxsize=None)
def fwd_split_weights(block_h: int, block_w: int):
    """The 2-D forward transform of a ``bh*bw`` block as one float32
    ``(bh*bw, 2*bh*bw)`` matrix ``[hi | lo]`` whose two halves sum to the
    float64 Kronecker matrix ``D_h (x) D_w`` (rows ``(i, j)``, columns
    ``(k, l)``), and the number of fraction bits of ``hi``.

    ``hi`` is ``D_h (x) D_w`` rounded to a multiple of ``2**-frac``, with
    ``frac`` chosen so that every partial sum of ``x @ hi`` for uint8
    ``x`` is a multiple of ``2**-frac`` below ``2**(24 - frac)``: it fits
    the float32 significand, so that contraction is exact in any
    summation order. ``lo`` (``|lo| <= 2**-(frac+1)``) adds terms whose
    sum is below 2.1 for 8x8 blocks; its float32 rounding is ~1e-7. The
    coefficient ``hi_sum + lo_sum`` is therefore within half an ulp (plus
    ~1e-7) of the exact transform on every backend, and two backends
    differ by at most one ulp.
    """
    d2 = np.kron(_dct_matrix64(block_h), _dct_matrix64(block_w))
    bound = 255.0 * np.abs(d2).sum(axis=1).max()
    frac = 24 - (int(np.ceil(np.log2(bound))) + 1)
    hi = np.round(d2 * 2.0**frac) / 2.0**frac
    lo = d2 - hi
    return np.concatenate([hi.T, lo.T], axis=1).astype(np.float32), frac


def _to_blocks(frame: jnp.ndarray, bw: int, bh: int) -> jnp.ndarray:
    """(..., H, W) -> (..., nby, nbx, bh, bw)"""
    *lead, h, w = frame.shape
    x = frame.reshape(*lead, h // bh, bh, w // bw, bw)
    return jnp.moveaxis(x, -3, -2)


def _from_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    *lead, nby, nbx, bh, bw = blocks.shape
    x = jnp.moveaxis(blocks, -2, -3)
    return x.reshape(*lead, nby * bh, nbx * bw)


def dct2_blockwise(frame: jnp.ndarray, block_w: int, block_h: int) -> jnp.ndarray:
    """Forward blockwise 2-D DCT of float32 ``(..., H, W)`` planes."""
    dh = jnp.asarray(dct_matrix(block_h))
    dw = jnp.asarray(dct_matrix(block_w))
    blocks = _to_blocks(frame, block_w, block_h)
    out = jnp.einsum(
        "ki,...ij,lj->...kl", dh, blocks, dw,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return _from_blocks(out)


def dct2_planes_to_wire(
    planes: jnp.ndarray, block_w: int, block_h: int
) -> jnp.ndarray:
    """Forward blockwise DCT of uint8 ``(C, T, H, W)`` channel planes into
    the bitstream's per-block payload layout ``(T, nby, nbx, C*bh*bw)``.

    The wire format stores each transform block contiguously (type, then
    per-channel coefficient rows — libs/encoder.cpp:243-265), so producing
    this layout on device turns host serialization into a plain memcpy.

    Each block is one ``bh*bw``-term contraction against the split
    Kronecker matrix of :func:`fwd_split_weights`, so the result does not
    depend on the order in which a backend sums (float32 rounding of a
    row/column factorization differs by up to 3 ulp between a GPU and a
    CPU). Both halves come out of one dot, each output column its own sum.
    """
    c, t, h, w = planes.shape
    nby, nbx = h // block_h, w // block_w
    n = block_h * block_w
    weights, _ = fwd_split_weights(block_h, block_w)
    blocks = planes.reshape(c, t, nby, block_h, nbx, block_w)
    blocks = jnp.transpose(blocks, (1, 2, 4, 0, 3, 5))
    blocks = blocks.reshape(t, nby, nbx, c, n).astype(jnp.float32)
    z = jax.lax.dot_general(
        blocks, jnp.asarray(weights), (((4,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    out = z[..., :n] + z[..., n:]
    return out.reshape(t, nby, nbx, c * n)


@functools.lru_cache(maxsize=None)
def _inv_stage_weights(channels: int, block_h: int, block_w: int):
    """The two ``(C*n, C*n)`` block-structured inverse-stage matrices.

    Operating in wire-lane space: stage 1 applies ``dh`` over the row
    index (``(c,k,l) -> (c,i,l)``), stage 2 applies ``dw`` over the
    column index (``(c,i,l) -> (c,i,j)``), so the whole inverse runs on
    the wire layout and the only relayout is one transpose of the
    pixel-space result. Each output element sums exactly ``block_h``
    (resp. ``block_w``) nonzero terms, the same row/column factorization
    the golden decoder gate is baselined against.
    """
    dh = dct_matrix(block_h)
    dw = dct_matrix(block_w)
    n = block_h * block_w
    m1 = np.zeros((channels * n, channels * n), np.float32)
    m2 = np.zeros((channels * n, channels * n), np.float32)
    for c in range(channels):
        o = c * n
        for k in range(block_h):
            for i in range(block_h):
                for l in range(block_w):
                    m1[o + k * block_w + l, o + i * block_w + l] = dh[k, i]
        for i in range(block_h):
            for l in range(block_w):
                for j in range(block_w):
                    m2[o + i * block_w + l, o + i * block_w + j] = dw[l, j]
    return m1, m2


def idct2_wire_to_planes(
    blocks: jnp.ndarray, channels: int, block_h: int, block_w: int
) -> jnp.ndarray:
    """Inverse blockwise DCT of one frame's wire coefficients into
    ``(C, H, W)`` float32 channel planes.

    Wire-lane-space stage dots (see :func:`_inv_stage_weights`) followed
    by a single reshape+transpose into planes.
    """
    nby, nbx, cn = blocks.shape
    n = block_h * block_w
    m1, m2 = _inv_stage_weights(channels, block_h, block_w)
    flat = blocks.reshape(nby * nbx, cn)
    a = jax.lax.dot_general(
        flat, jnp.asarray(m1), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    z = jax.lax.dot_general(
        a, jnp.asarray(m2), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    z = z.reshape(nby, nbx, channels, block_h, block_w)
    out = jnp.transpose(z, (2, 0, 3, 1, 4))  # (C, nby, bh, nbx, bw)
    return out.reshape(channels, nby * block_h, nbx * block_w)


def idct2_blockwise(frame: jnp.ndarray, block_w: int, block_h: int) -> jnp.ndarray:
    """Inverse blockwise 2-D DCT (DCT-III) of float32 ``(..., H, W)``."""
    dh = jnp.asarray(dct_matrix(block_h))
    dw = jnp.asarray(dct_matrix(block_w))
    blocks = _to_blocks(frame, block_w, block_h)
    out = jnp.einsum(
        "ik,...ij,jl->...kl", dh, blocks, dw,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return _from_blocks(out)
