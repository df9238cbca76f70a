"""Connected-component labeling on the MV grid, on-device.

Replaces the encoder's per-cluster ``cv::connectedComponents`` call
(reference: libs/encoder.cpp:597-623) with iterative min-label propagation —
a good fit for the MV grid's size (<= a few thousand cells at 1080p/16px;
libs/encoder.cpp:174-177).

Algorithm: every masked cell starts with its linear raster index; each sweep
replaces a cell's label by the minimum over itself and its masked neighbors
(4- or 8-connectivity, libs/encoder.cpp:96-101 validates connectivity in
{4, 8}). Pointer-jumping (``label = label[label]``) after each sweep gives
logarithmic convergence. Labels are then canonicalized to 1..n in raster
order of each component's first pixel — the numbering OpenCV's default
algorithms produce — with 0 = background, so downstream block-type IDs
match the reference's layout (libs/encoder.cpp:608-622).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("connectivity",))
def connected_components_batched(
    masks: jnp.ndarray, connectivity: int = 4
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Label connected regions of a bool ``(B, H, W)`` mask batch.

    All masks propagate under ONE ``while_loop`` (min-label propagation with
    pointer jumping, so path lengths halve each sweep) — the batch dimension
    keeps the device busy: the encoder labels every k-means cluster of
    every frame in a batch at once instead of looping small grids.

    Returns ``(labels, counts)``: labels int32, 0 = background, 1..n per
    mask in raster order of each component's first pixel; ``counts = n + 1``
    including the background label, matching ``cv::connectedComponents``'s
    return value (the encoder advances its block-type offset by it,
    libs/encoder.cpp:609-622).
    """
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    b, h, w = masks.shape
    n = h * w
    # int16 labels halve propagation traffic on codec-scale grids
    # (1080p/16px = 8160 cells); int32 for anything larger
    ldtype = jnp.int16 if n < 32767 else jnp.int32
    idx = jnp.broadcast_to(
        jnp.arange(n, dtype=ldtype).reshape(1, h, w), (b, h, w)
    )
    big = jnp.array(n, ldtype)  # sentinel for background / out of mask
    labels = jnp.where(masks, idx, big)

    # propagation runs on the flattened (B, n) layout: the grid's width is
    # narrower than a vector register, so flat rows pack the lanes fully;
    # grid neighbors become fixed lane offsets with row-boundary masks
    labels = labels.reshape(b, n)
    masks_flat = masks.reshape(b, n)
    col = jnp.arange(n, dtype=jnp.int32) % w
    not_left = (col != 0)[None, :]
    not_right = (col != w - 1)[None, :]

    if connectivity == 4:
        shifts = ((w, None), (-w, None),
                  (1, not_left), (-1, not_right))
    else:
        shifts = (
            (w, None), (-w, None), (1, not_left), (-1, not_right),
            (w + 1, not_left), (w - 1, not_right),
            (-w + 1, not_left), (-w - 1, not_right),
        )

    margin = w + 1  # covers the largest (diagonal) lane offset

    def neighbor_min(lab):
        padded = jnp.concatenate(
            [
                jnp.full((b, margin), big, ldtype),
                lab,
                jnp.full((b, margin), big, ldtype),
            ],
            axis=1,
        )
        m = lab
        for off, ok in shifts:
            sh = jax.lax.slice(
                padded, (0, margin - off), (b, margin - off + n)
            )
            if ok is not None:
                sh = jnp.where(ok, sh, big)
            m = jnp.minimum(m, sh)
        return jnp.where(masks_flat, m, big)

    def sweep_block(lab):
        new = lab
        for _ in range(12):
            new = neighbor_min(new)
        return new

    # phase 1: pure dense sweeps — gather-free, and enough for any mask
    # whose components' path lengths fit the iteration budget (the sweep
    # budget comfortably covers the grid diameter)
    sweep_limit = max(2, (h + w) // 10)

    def body1(state):
        lab, _, it = state
        new = sweep_block(lab)
        return new, jnp.any(new != lab), it + 1

    labels, changed, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < sweep_limit),
        body1,
        (labels, jnp.bool_(True), jnp.int32(0)),
    )

    # phase 2: pointer jumping for adversarial stragglers (long snaking
    # components) — zero iterations when phase 1 already converged
    def body2(state):
        lab, _ = state
        new = sweep_block(lab)
        flat_ext = jnp.concatenate(
            [new, jnp.full((b, 1), big, ldtype)], axis=1
        )
        jumped = jnp.take_along_axis(flat_ext, new.astype(jnp.int32), axis=1)
        new = jnp.where(masks_flat, jnp.minimum(jumped, new), big)
        return new, jnp.any(new != lab)

    labels, _ = jax.lax.while_loop(lambda s: s[1], body2, (labels, changed))
    labels = labels.reshape(b, h, w)

    # canonicalize: components numbered in raster order of their root pixel
    is_root = masks & (labels == idx)
    rank = jnp.cumsum(is_root.reshape(b, n).astype(jnp.int32), axis=1)
    rank_ext = jnp.concatenate([rank, jnp.zeros((b, 1), jnp.int32)], axis=1)
    canon = jnp.where(
        masks,
        jnp.take_along_axis(
            rank_ext, labels.reshape(b, n).astype(jnp.int32), axis=1
        ).reshape(b, h, w),
        0,
    )
    counts = rank[:, -1] + 1
    return canon.astype(jnp.int32), counts


def connected_components(
    mask: jnp.ndarray, connectivity: int = 4
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-mask convenience wrapper over the batched kernel."""
    labels, counts = connected_components_batched(
        mask[None], connectivity
    )
    return labels[0], counts[0]


@functools.partial(jax.jit, static_argnames=("k", "connectivity"))
def block_types_from_clusters(
    cluster_labels: jnp.ndarray, k: int, connectivity: int = 4
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-cluster connected components + running block-type offsets, fused.

    Exactly reproduces the reference's loop over k-means clusters — one
    ``cv::connectedComponents`` per cluster mask, block type = component id
    + running offset, offset advanced by that call's label count
    (libs/encoder.cpp:597-623) — but labels every cluster of a frame in ONE
    propagation: a component of cluster ``c``'s mask is precisely a maximal
    same-cluster-connected region, so propagation over the cluster image
    with same-value connectivity computes all k mask labelings at once.
    This is ~k times less sweep traffic than running the batched mask CCL
    on k separated masks.

    Args:
      cluster_labels: ``(B, H, W)`` int32, values in ``[0, k)`` for
        foreground cells and < 0 for background.
      k: static cluster count.

    Returns:
      ``(block_types, counts)`` — block_types ``(B, H, W)`` int32 (0 =
      background); counts ``(B, k)``, each cluster's component count + 1
      (``cv::connectedComponents``'s return value, including its label 0).
    """
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    b, h, w = cluster_labels.shape
    n = h * w
    ldtype = jnp.int16 if n < 32767 else jnp.int32
    valid = cluster_labels >= 0
    idx = jnp.broadcast_to(jnp.arange(n, dtype=ldtype).reshape(1, h, w), (b, h, w))
    big = jnp.array(n, ldtype)
    labels = jnp.where(valid, idx, big).reshape(b, n)
    cl = jnp.where(valid, cluster_labels, -1).reshape(b, n).astype(jnp.int16)

    col = jnp.arange(n, dtype=jnp.int32) % w
    not_left = (col != 0)[None, :]
    not_right = (col != w - 1)[None, :]
    if connectivity == 4:
        shifts = ((w, None), (-w, None), (1, not_left), (-1, not_right))
    else:
        shifts = (
            (w, None), (-w, None), (1, not_left), (-1, not_right),
            (w + 1, not_left), (w - 1, not_right),
            (-w + 1, not_left), (-w - 1, not_right),
        )
    margin = w + 1

    def shifted(arr, off, fill):
        padded = jnp.concatenate(
            [
                jnp.full((b, margin), fill, arr.dtype),
                arr,
                jnp.full((b, margin), fill, arr.dtype),
            ],
            axis=1,
        )
        return jax.lax.slice(padded, (0, margin - off), (b, margin - off + n))

    # same-cluster neighbor masks are label-independent: compute once
    neigh_ok = []
    for off, ok in shifts:
        eq = shifted(cl, off, jnp.int16(-2)) == cl
        eq &= valid.reshape(b, n)
        if ok is not None:
            eq &= ok
        neigh_ok.append((off, eq))

    def neighbor_min(lab):
        m = lab
        for off, eq in neigh_ok:
            m = jnp.minimum(m, jnp.where(eq, shifted(lab, off, big), big))
        return jnp.where(valid.reshape(b, n), m, big)

    def sweep_block(lab):
        new = lab
        for _ in range(12):
            new = neighbor_min(new)
        return new

    sweep_limit = max(2, (h + w) // 10)

    def body1(state):
        lab, _, it = state
        new = sweep_block(lab)
        return new, jnp.any(new != lab), it + 1

    labels, changed, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < sweep_limit),
        body1,
        (labels, jnp.bool_(True), jnp.int32(0)),
    )

    def body2(state):
        lab, _ = state
        new = sweep_block(lab)
        flat_ext = jnp.concatenate([new, jnp.full((b, 1), big, ldtype)], axis=1)
        jumped = jnp.take_along_axis(flat_ext, new.astype(jnp.int32), axis=1)
        new = jnp.where(valid.reshape(b, n), jnp.minimum(jumped, new), big)
        return new, jnp.any(new != lab)

    labels, _ = jax.lax.while_loop(lambda s: s[1], body2, (labels, changed))

    # per-cluster canonical numbering + running offsets, in one pass:
    # component roots rank 1..n_c in raster order within their own cluster
    # (cv::connectedComponents numbering), then each cluster's ids start at
    # the running offset = sum of previous clusters' (n_c + 1) counts
    roots = valid.reshape(b, n) & (labels == idx.reshape(b, n))
    ranked = jnp.zeros((b, n), jnp.int32)
    counts = []
    offset = jnp.zeros((b, 1), jnp.int32)
    for c in range(k):
        in_c = cl == c
        rank_c = jnp.cumsum((roots & in_c).astype(jnp.int32), axis=1)
        ranked = jnp.where(roots & in_c, rank_c + offset, ranked)
        n_c = rank_c[:, -1:]
        counts.append(n_c + 1)
        offset = offset + n_c + 1
    # every member reads its root's rank: ranked[labels[i]]; background
    # cells carry the sentinel label n and read the appended 0
    table = jnp.concatenate([ranked, jnp.zeros((b, 1), jnp.int32)], axis=1)
    btypes = jnp.take_along_axis(table, labels.astype(jnp.int32), axis=1)
    btypes = jnp.where(valid.reshape(b, n), btypes, 0)
    return (
        btypes.reshape(b, h, w),
        jnp.concatenate(counts, axis=1),
    )
