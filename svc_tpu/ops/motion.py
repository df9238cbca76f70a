"""Block-matching motion estimation (EBMA / HBMA) as batched array ops.

Re-implements the reference's motion layer (libs/motion.cpp) as batched,
static-shape JAX transforms:

* ``ebma`` — exhaustive block matching, all blocks searched simultaneously
  (reference: ``EstimateMotionExhaustiveSearch`` libs/motion.cpp:268-340).
* ``refine`` — one hierarchical refinement pass around propagated MVs
  (reference: ``RefineHierMotionEst`` libs/motion.cpp:342-410 and its SSE2
  specializations libs/motion.cpp:552-689).
* ``hbma`` — the full hierarchical pyramid search. One code path covers both
  the generic ``EstimateMotionHierarchical`` (libs/motion.cpp:412-465) and
  the fixed 4-level/16x16 SSE2 flavor ``EstimateMotionHierarchical16x16Sse2``
  (libs/motion.cpp:691-749), which is the same algorithm with pinned
  parameters.
* global-motion estimators (average / exhaustive / hierarchical), declared
  in the reference but unused by its apps
  (reference: libs/motion.cpp:45-142).

Design: instead of the reference's per-block scalar loops with SSE2 MAD
kernels (``_mm_sad_epu8``, libs/motion.cpp:472-550), every candidate
displacement is evaluated for *all* blocks at once as a whole-frame absolute
difference + per-block reduction. Candidates are visited
in the reference's raster scan order under ``lax.scan``, carrying exactly
the sequential update state, which preserves the reference's observable
semantics bit-for-bit:

* EBMA updates on ``mad <= min`` (last-wins ties, libs/motion.cpp:324);
  refinement updates on strict ``mad < min`` (first-wins ties,
  libs/motion.cpp:401) — quirk Q8;
* EBMA resets an MV to zero when every candidate in its (clamped) search
  area updated the running min — the flat-region heuristic
  (libs/motion.cpp:312-338) — quirk Q6;
* refinement carries ``min_mad`` across pyramid levels rather than
  resetting it (libs/motion.cpp:443-463).

Conventions: frames are ``(H, W)`` uint8 luma planes; a motion field is
``(mfh, mfw, 2)`` float32 with ``[..., 0] = x`` and ``[..., 1] = y``
(anchor -> tracked, backwards estimation); ``min_mad`` is ``(mfh, mfw)``
float32 initialized to FLT_MAX.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_FLT_MAX = float(np.finfo(np.float32).max)


def _candidate_offsets(search_range: int) -> np.ndarray:
    """All displacements in raster order: y ascending, then x ascending."""
    r = search_range
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    return np.stack([dy.ravel(), dx.ravel()], axis=-1).astype(np.int32)


def _block_sums(plane: jnp.ndarray, block_w: int, block_h: int) -> jnp.ndarray:
    """Sum an ``(H, W)`` int array over non-overlapping blocks."""
    h, w = plane.shape
    return plane.reshape(h // block_h, block_h, w // block_w, block_w).sum(
        axis=(1, 3)
    )


@functools.partial(jax.jit, static_argnames=("search_range", "block_w", "block_h"))
def ebma(
    tracked: jnp.ndarray,
    anchor: jnp.ndarray,
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exhaustive block-matching over a symmetric search range.

    Returns ``(mv_field, min_mad)``. Semantics match
    ``EstimateMotionExhaustiveSearch`` (libs/motion.cpp:268-340) including
    the ``<=`` tie-break and the flat-region zero-MV reset.
    """
    fh, fw = tracked.shape
    assert fh % block_h == 0 and fw % block_w == 0
    mfh, mfw = fh // block_h, fw // block_w
    area = float(block_w * block_h)
    r = search_range

    # dense SADs for every displacement, then the sequential selection
    # semantics replayed as a cheap scan over the (small) candidate axis
    table = _sad_table(tracked, anchor, r, block_w, block_h) / jnp.float32(
        area
    )

    offsets = jnp.asarray(_candidate_offsets(r))

    # Per-block anchor top-left coordinates.
    by = jnp.arange(mfh, dtype=jnp.int32)[:, None] * block_h
    bx = jnp.arange(mfw, dtype=jnp.int32)[None, :] * block_w

    def step(state, dm):
        mv, min_mad, update_count, valid_count = state
        d, mad = dm
        dy, dx = d[0], d[1]

        # candidate tracked block must lie fully inside the frame
        valid = (
            (by + dy >= 0)
            & (by + dy <= fh - block_h)
            & (bx + dx >= 0)
            & (bx + dx <= fw - block_w)
        )
        update = valid & (mad <= min_mad)
        mv = jnp.where(
            update[..., None],
            jnp.stack(
                [
                    jnp.broadcast_to(dx, (mfh, mfw)),
                    jnp.broadcast_to(dy, (mfh, mfw)),
                ],
                axis=-1,
            ).astype(jnp.float32),
            mv,
        )
        min_mad = jnp.where(update, mad, min_mad)
        update_count = update_count + update.astype(jnp.int32)
        valid_count = valid_count + valid.astype(jnp.int32)
        return (mv, min_mad, update_count, valid_count), None

    init = (
        jnp.zeros((mfh, mfw, 2), jnp.float32),
        jnp.full((mfh, mfw), _FLT_MAX, jnp.float32),
        jnp.zeros((mfh, mfw), jnp.int32),
        jnp.zeros((mfh, mfw), jnp.int32),
    )
    (mv, min_mad, update_count, valid_count), _ = jax.lax.scan(
        step, init, (offsets, table)
    )

    # flat-region heuristic: every candidate in the search area improved the
    # running min -> uniform texture -> zero MV (libs/motion.cpp:333-338)
    flat = update_count == valid_count
    mv = jnp.where(flat[..., None], 0.0, mv)
    return mv, min_mad


def _block_indicators(fh: int, fw: int, block_w: int, block_h: int):
    """0/1 reduction matrices mapping pixel rows/cols to block rows/cols."""
    mfh, mfw = fh // block_h, fw // block_w
    rows = np.zeros((mfh, fh), np.float32)
    rows[np.arange(fh) // block_h, np.arange(fh)] = 1.0
    cols = np.zeros((fw, mfw), np.float32)
    cols[np.arange(fw), np.arange(fw) // block_w] = 1.0
    return jnp.asarray(rows, jnp.bfloat16), jnp.asarray(cols)


def _sad_table(
    tracked: jnp.ndarray,
    anchor: jnp.ndarray,
    radius: int,
    block_w: int,
    block_h: int,
) -> jnp.ndarray:
    """Dense per-block SADs for every displacement in ``[-radius, radius]^2``.

    The dense core of block matching: instead of gathering each block's
    candidate windows (irregular memory access), compute the whole-frame
    absolute difference for each displacement (a shifted dense subtract)
    and reduce it to per-block sums with 0/1 indicator matmuls. Arithmetic
    is exact: absolute differences are <= 255 (exactly representable in
    bfloat16), the products accumulate in float32, and per-block sums
    stay <= block_area * 255, well under 2**24.

    Returns ``((2*radius+1)^2, mfh, mfw)`` float32 SADs (integer-valued) in
    raster displacement order (dy ascending, dx ascending).
    """
    fh, fw = tracked.shape
    r = radius
    anchor_i = anchor.astype(jnp.int16)
    tracked_pad = jnp.pad(tracked, ((r, r), (r, r)), constant_values=0)
    offsets = jnp.asarray(_candidate_offsets(r))
    row_ind, col_ind = _block_indicators(fh, fw, block_w, block_h)

    def step(_, d):
        cand = jax.lax.dynamic_slice(
            tracked_pad, (r + d[0], r + d[1]), (fh, fw)
        )
        diff = jnp.abs(cand.astype(jnp.int16) - anchor_i)
        # rows -> block rows (bf16 operands exact for values <= 255,
        # f32 accumulation)
        part = jnp.einsum(
            "mh,hw->mw",
            row_ind,
            diff.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        # cols -> block cols; partial sums exceed bf16's integer range, so
        # this small matmul runs in full f32 precision
        sad = jnp.einsum(
            "mw,wn->mn",
            part,
            col_ind,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return None, sad

    _, table = jax.lax.scan(step, None, offsets)
    return table


@functools.partial(
    jax.jit,
    static_argnames=("search_range", "block_w", "block_h", "mv_bound"),
)
def refine(
    tracked: jnp.ndarray,
    anchor: jnp.ndarray,
    search_range: int,
    block_w: int,
    block_h: int,
    mv_field: jnp.ndarray,
    min_mad: jnp.ndarray,
    mv_bound: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One hierarchical refinement pass around propagated MVs.

    Searches ``+-search_range`` around each block's propagated position,
    updating only on strictly smaller MAD and carrying ``min_mad`` in from
    the previous pyramid level (``RefineHierMotionEst``,
    libs/motion.cpp:342-410).

    ``mv_bound``: static bound on ``|mv| + search_range``. When positive
    and small enough, the dense SAD-table path is used (see ``_sad_table``);
    otherwise a per-block gather path. Both are semantically identical.
    """
    r = search_range
    table_radius = mv_bound
    n_offsets = (2 * table_radius + 1) ** 2
    # dense-table path: worth it while the table stays moderate
    if table_radius > 0 and n_offsets <= 4096:
        return _refine_table(
            tracked, anchor, r, block_w, block_h, mv_field, min_mad,
            table_radius,
        )
    return _refine_gather(
        tracked, anchor, r, block_w, block_h, mv_field, min_mad
    )


def _refine_select(
    mads: jnp.ndarray,
    mv_field: jnp.ndarray,
    min_mad: jnp.ndarray,
    r: int,
    block_w: int,
    block_h: int,
    fh: int,
    fw: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Replay the reference's sequential strict-< candidate selection
    (libs/motion.cpp:390-407) over precomputed per-candidate MADs
    ``(ncand, mfh, mfw)`` in raster offset order.

    The candidate axis is a small static count, so the replay is unrolled
    (one fused pass) instead of a ``lax.scan`` with per-iteration carry
    writes.

    Works unbatched (``(mfh, mfw, 2)`` fields) or batched over leading
    axes (``hbma_stack``): block coordinates broadcast from the right.
    """
    mfh, mfw = mv_field.shape[-3:-1]
    by = jnp.arange(mfh, dtype=jnp.int32)[:, None] * block_h
    bx = jnp.arange(mfw, dtype=jnp.int32)[None, :] * block_w
    mv_round = jnp.round(mv_field).astype(jnp.int32)
    py = by + mv_round[..., 1]
    px = bx + mv_round[..., 0]

    mv, best = mv_field, min_mad
    for i, (ey, ex) in enumerate(_candidate_offsets(r)):
        ey, ex = int(ey), int(ex)
        mad = mads[i]
        valid = (
            (py + ey >= 0)
            & (py + ey <= fh - block_h)
            & (px + ex >= 0)
            & (px + ex <= fw - block_w)
        )
        update = valid & (mad < best)
        new_mv = jnp.stack(
            [
                (px + ex - bx).astype(jnp.float32),
                (py + ey - by).astype(jnp.float32),
            ],
            axis=-1,
        )
        mv = jnp.where(update[..., None], new_mv, mv)
        best = jnp.where(update, mad, best)
    return mv, best


def _spread_cells(
    plane: jnp.ndarray, block_w: int, block_h: int, pad: int
) -> jnp.ndarray:
    """Spread a padded frame into per-block neighborhood cells.

    Returns ``(mfh, bh + 2*pad, bw + 2*pad, mfw)`` where cell (i, :, :, j)
    holds the frame region ``[i*bh - pad, i*bh + bh + pad) x
    [j*bw - pad, ...)``. Built from static slices only, in place of
    per-block gathers. The block-column axis (mfw) is the minor one.
    """
    ph, pw = plane.shape
    fh, fw = ph - 2 * pad, pw - 2 * pad
    mfh, mfw = fh // block_h, fw // block_w
    ch, cw = block_h + 2 * pad, block_w + 2 * pad

    # the shifted contiguous reshapes below read up to this column
    needed = ((cw - 1) // block_w) * block_w + mfw * block_w
    if needed > pw:
        plane = jnp.pad(plane, ((0, 0), (0, needed - pw)))

    # rows: mfh overlapping strips via static slices
    strips = jnp.stack(
        [plane[i * block_h : i * block_h + ch, :] for i in range(mfh)]
    )  # (mfh, ch, pw)

    # cols: cw-wide windows at stride bw, assembled from ceil(cw/bw)
    # shifted contiguous reshapes; the parts concatenate on the LAST axis
    # first so the minor-axis transpose happens ONCE on the combined
    # tensor instead of once per part (XLA fuses concat into the transpose)
    parts = []
    for c0 in range(0, cw, block_w):
        seg = strips[:, :, c0 : c0 + mfw * block_w]
        parts.append(seg.reshape(mfh, ch, mfw, block_w))
    stacked = jnp.concatenate(parts, axis=-1)  # (mfh, ch, mfw, n*bw)
    return jnp.swapaxes(stacked, -1, -2)[:, :, :cw, :]  # (mfh, ch, cw, mfw)


def _refine_spread(
    tracked, anchor, r, block_w, block_h, mv_field, min_mad, bound_in
):
    """Refinement via spread cells + masked even-shift window selection.

    ``mv_field`` entering a pyramid refinement is always a doubled integer
    field (libs/motion.cpp:455-459), so per-block window positions are even
    shifts in ``[-bound_in, bound_in]`` — each realized as one static slice
    of the cell tensor selected by a dense mask. No gathers anywhere.
    """
    fh, fw = tracked.shape
    mfh, mfw = fh // block_h, fw // block_w
    area = float(block_w * block_h)
    pad = bound_in + r

    mv_round = jnp.round(mv_field).astype(jnp.int32)

    # u8 end to end through the shift passes (half the traffic of i16);
    # widening happens only at the final reduction
    tp = jnp.pad(tracked, ((pad, pad), (pad, pad)), constant_values=0)
    cells = _spread_cells(tp, block_w, block_h, pad)  # (mfh, ch, cw, mfw)

    mvx = mv_round[..., 0][:, None, None, :]  # vs (mfh, y, x, mfw) layout
    mvy = mv_round[..., 1][:, None, None, :]

    wh, ww = block_h + 2 * r, block_w + 2 * r
    shifts = list(range(-bound_in, bound_in + 1, 2)) or [0]

    def select_windows(src, axis, mvc, extent):
        """Select each block's window position along ``axis`` (1 = rows,
        2 = cols) by its (even, bounded) MV component.

        Wide shift ranges use a two-stage decomposition ``s = a + b``
        (coarse multiples of 6, fine {-2, 0, 2}): an n-way select chain
        reads every candidate slice per output element, so splitting 15
        shifts into 5 + 3 with a slightly taller intermediate cuts the
        selection traffic ~30%. Valid whenever ``bound_in % 6 == 2`` (then
        the edge coarse value ``bound_in - 2`` is a multiple of 6 and its
        stage-1 slice stays inside the cells); the default 4-level pyramid
        hits bound_in = 14 at the base level.
        """
        def take(arr, start, size):
            if axis == 1:
                return arr[:, start : start + size, :, :]
            return arr[:, :, start : start + size, :]

        if len(shifts) < 9 or bound_in % 6 != 2:
            out = None
            for s in shifts:
                sl = take(src, pad + s - r, extent)
                out = sl if out is None else jnp.where(mvc == s, sl, out)
            return out

        amax = bound_in - 2
        a_of = jnp.clip(
            (jnp.round(mvc / 6.0)).astype(jnp.int32) * 6, -amax, amax
        )
        inter = None
        for a in range(-amax, amax + 1, 6):
            sl = take(src, pad + a - 2 - r, extent + 4)
            inter = sl if inter is None else jnp.where(a_of == a, sl, inter)
        out = None
        for f in (-2, 0, 2):
            sl = take(inter, 2 + f, extent)
            out = sl if out is None else jnp.where(mvc - a_of == f, sl, out)
        return out

    win_rows = select_windows(cells, 1, mvy, wh)
    windows = select_windows(win_rows, 2, mvx, ww)

    # all (2r+1)^2 candidates are static slices of the selected windows;
    # |a - b| on uint8 via max - min keeps candidate traffic at one byte
    anchor_blocks = jnp.swapaxes(
        anchor.reshape(mfh, block_h, mfw, block_w), 2, 3
    )  # (mfh, bh, bw, mfw) uint8
    mads = []
    for oy in range(2 * r + 1):
        for ox in range(2 * r + 1):
            cand = windows[:, oy : oy + block_h, ox : ox + block_w, :]
            diff = jnp.maximum(cand, anchor_blocks) - jnp.minimum(
                cand, anchor_blocks
            )
            sad = jnp.sum(diff.astype(jnp.int32), axis=(1, 2))
            mads.append(sad.astype(jnp.float32) / jnp.float32(area))
    # kept as a list: the unrolled selection consumes each MAD in place

    return _refine_select(
        mads, mv_field, min_mad, r, block_w, block_h, fh, fw
    )


def _refine_table(
    tracked, anchor, r, block_w, block_h, mv_field, min_mad, radius
):
    fh, fw = tracked.shape
    mfh, mfw = fh // block_h, fw // block_w
    area = float(block_w * block_h)
    side = 2 * radius + 1

    # (mfh, mfw, n_offsets) MADs for every displacement in range; true
    # division matches the reference's (float)sad / count exactly
    table = (
        jnp.moveaxis(
            _sad_table(tracked, anchor, radius, block_w, block_h), 0, -1
        )
        / jnp.float32(area)
    )

    by = jnp.arange(mfh, dtype=jnp.int32)[:, None] * block_h
    bx = jnp.arange(mfw, dtype=jnp.int32)[None, :] * block_w
    mv_round = jnp.round(mv_field).astype(jnp.int32)
    py = by + mv_round[..., 1]
    px = bx + mv_round[..., 0]

    offsets = jnp.asarray(_candidate_offsets(r))

    def step(state, e):
        mv, best = state
        ey, ex = e[0], e[1]
        dy = jnp.clip(mv_round[..., 1] + ey, -radius, radius)
        dx = jnp.clip(mv_round[..., 0] + ex, -radius, radius)
        idx = (dy + radius) * side + (dx + radius)
        mad = jnp.take_along_axis(table, idx[..., None], axis=-1)[..., 0]

        valid = (
            (py + ey >= 0)
            & (py + ey <= fh - block_h)
            & (px + ex >= 0)
            & (px + ex <= fw - block_w)
        )
        update = valid & (mad < best)
        new_mv = jnp.stack(
            [
                (px + ex - bx).astype(jnp.float32),
                (py + ey - by).astype(jnp.float32),
            ],
            axis=-1,
        )
        mv = jnp.where(update[..., None], new_mv, mv)
        best = jnp.where(update, mad, best)
        return (mv, best), None

    (mv, best), _ = jax.lax.scan(step, (mv_field, min_mad), offsets)
    return mv, best


def _refine_gather(
    tracked, anchor, r, block_w, block_h, mv_field, min_mad
):
    """Per-block gather fallback for unbounded/large MV ranges."""
    fh, fw = tracked.shape
    assert fh % block_h == 0 and fw % block_w == 0
    mfh, mfw = fh // block_h, fw // block_w
    area = float(block_w * block_h)

    anchor_i = anchor.astype(jnp.int32)
    tracked_i = tracked.astype(jnp.int32)

    by = jnp.arange(mfh, dtype=jnp.int32)[:, None] * block_h
    bx = jnp.arange(mfw, dtype=jnp.int32)[None, :] * block_w

    # propagated tracked-block position; MVs hold exact integers so C
    # std::round (libs/math.hpp:15-18, 236-241) is plain rounding
    mv_round = jnp.round(mv_field).astype(jnp.int32)
    py = by + mv_round[..., 1]
    px = bx + mv_round[..., 0]

    # per-pixel shift amount for the gather: pixel (y, x) in block (iy, ix)
    # reads tracked[y + mvy(block) + ey, x + mvx(block) + ex]
    yy = jnp.arange(fh, dtype=jnp.int32)[:, None]
    xx = jnp.arange(fw, dtype=jnp.int32)[None, :]
    mvy_px = jnp.repeat(
        jnp.repeat(mv_round[..., 1], block_h, axis=0), block_w, axis=1
    )
    mvx_px = jnp.repeat(
        jnp.repeat(mv_round[..., 0], block_h, axis=0), block_w, axis=1
    )

    offsets = jnp.asarray(_candidate_offsets(r))

    def step(state, e):
        mv, best = state
        ey, ex = e[0], e[1]
        gy = jnp.clip(yy + mvy_px + ey, 0, fh - 1)
        gx = jnp.clip(xx + mvx_px + ex, 0, fw - 1)
        cand = tracked_i[gy, gx]
        sad = _block_sums(jnp.abs(cand - anchor_i), block_w, block_h)
        mad = sad.astype(jnp.float32) / jnp.float32(area)

        valid = (
            (py + ey >= 0)
            & (py + ey <= fh - block_h)
            & (px + ex >= 0)
            & (px + ex <= fw - block_w)
        )
        update = valid & (mad < best)
        new_mv = jnp.stack(
            [(px + ex - bx).astype(jnp.float32), (py + ey - by).astype(jnp.float32)],
            axis=-1,
        )
        mv = jnp.where(update[..., None], new_mv, mv)
        best = jnp.where(update, mad, best)
        return (mv, best), None

    (mv, best), _ = jax.lax.scan(step, (mv_field, min_mad), offsets)
    return mv, best


def hbma(
    tracked_pyramid: Sequence[jnp.ndarray],
    anchor_pyramid: Sequence[jnp.ndarray],
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hierarchical block matching over a Gaussian pyramid.

    The top level runs EBMA with range ``search_range / 2**(L-1)`` on
    ``2**(L-1)``-times-smaller blocks; every lower level doubles the MVs and
    refines around them with the *same* top-level range
    (``EstimateMotionHierarchical``, libs/motion.cpp:412-465). With
    ``L=4, block 16x16`` this is also exactly
    ``EstimateMotionHierarchical16x16Sse2`` (libs/motion.cpp:691-749).

    Args:
      tracked_pyramid / anchor_pyramid: lists of luma planes, level 0 = base.
      block_w/block_h: base-level block dims.

    Returns ``(mv_field, min_mad)`` at base-level block granularity.
    """
    level_count = len(tracked_pyramid)
    factor = 1 << (level_count - 1)
    if search_range < factor:
        raise ValueError(
            "search range must be >= the top level reduction factor"
        )
    if block_w % factor or block_h % factor:
        # the reference truncates the per-level block dims (uint division,
        # libs/motion.cpp:440-441) and then corrupts its MV field when the
        # doubled dims no longer match — reject clearly instead
        raise ValueError(
            "block dims must be divisible by the top level reduction factor"
        )
    top_range = search_range // factor

    mv, min_mad = ebma(
        tracked_pyramid[-1],
        anchor_pyramid[-1],
        top_range,
        block_w // factor,
        block_h // factor,
    )

    # static bound on |mv| components, tightened per level: the MV entering
    # each refinement is a doubled integer field, so its window positions
    # are even shifts in [-bound_in, bound_in] — the spread-cell path turns
    # each into one masked static slice (no gathers)
    bound = top_range
    for lvl in range(level_count - 2, -1, -1):
        scale = 1 << lvl
        mv = mv * 2.0
        bound_in = 2 * bound
        mv, min_mad = _refine_spread(
            tracked_pyramid[lvl],
            anchor_pyramid[lvl],
            top_range,
            block_w // scale,
            block_h // scale,
            mv,
            min_mad,
            bound_in=bound_in,
        )
        bound = bound_in + top_range
    return mv, min_mad


def hbma_stack(
    pyramid_stack: Sequence[jnp.ndarray],
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hierarchical block matching over a FULL frame-stack pyramid.

    Batched form of :func:`hbma` for the encoder's hot path: each level is
    a ``(T+1, h_l, w_l)`` stack where frame ``t`` is tracked against
    anchor ``t+1`` (the reference's pyramid swap, libs/encoder.cpp:
    661-663). Semantics are identical to ``vmap(hbma)`` over the sliced
    pyramids (asserted in test_motion).

    Returns ``(mv (T, mfh, mfw, 2), min_mad (T, mfh, mfw))``.
    """
    level_count = len(pyramid_stack)
    factor = 1 << (level_count - 1)
    if search_range < factor:
        raise ValueError(
            "search range must be >= the top level reduction factor"
        )
    if block_w % factor or block_h % factor:
        raise ValueError(
            "block dims must be divisible by the top level reduction factor"
        )
    top_range = search_range // factor

    top = pyramid_stack[-1]
    mv, min_mad = jax.vmap(
        lambda tr, an: ebma(
            tr, an, top_range, block_w // factor, block_h // factor
        )
    )(top[:-1], top[1:])

    bound = top_range
    for lvl in range(level_count - 2, -1, -1):
        scale = 1 << lvl
        mv = mv * 2.0
        bound_in = 2 * bound
        bw, bh = block_w // scale, block_h // scale
        stack = pyramid_stack[lvl]
        mv, min_mad = jax.vmap(
            lambda tr, an, m, mm: _refine_spread(
                tr, an, top_range, bw, bh, m, mm, bound_in=bound_in
            )
        )(stack[:-1], stack[1:], mv, min_mad)
        bound = bound_in + top_range
    return mv, min_mad


# ---------------------------------------------------------------------------
# Global-motion estimators (public in the reference, unused by its apps;
# RANSAC — the one the encoder actually uses — lives in ops/ransac.py)
# ---------------------------------------------------------------------------


def estimate_global_motion_avg(motion_field: jnp.ndarray) -> jnp.ndarray:
    """Mean MV of the field (``EstimateGlobalMotionAvg``,
    libs/motion.cpp:45-53; the reference's incremental mean is numerically
    a running average of the same quantity)."""
    return jnp.mean(motion_field.reshape(-1, 2), axis=0)


@functools.partial(jax.jit, static_argnames=("search_range",))
def estimate_global_motion_exhaustive(
    tracked: jnp.ndarray, anchor: jnp.ndarray, search_range: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Whole-frame EBMA with clipped overlap regions.

    For each displacement the MAD is computed over the clipped overlap of
    the two frames; strict ``<`` keeps the first minimum in raster order
    (``EstimateGlobalMotionExhaustiveSearch``, libs/motion.cpp:55-99).

    Deliberate divergence (quirk E9, found by golden testing): the
    reference's displacement loops compare a signed index against the
    UNSIGNED search range (``dy <= search_range`` with uint range,
    libs/motion.cpp:72,81), so for any ``search_range >= 1`` the negative
    start index converts to a huge unsigned value and the loop never runs —
    the function is a no-op returning zero motion and FLT_MAX (consistent
    with it being dead code w.r.t. the reference apps). This
    implementation performs the search as documented.

    Returns ``(global_motion, min_mad)``.
    """
    fh, fw = tracked.shape
    r = search_range
    a = anchor.astype(jnp.int32)
    t = tracked.astype(jnp.int32)
    tp = jnp.pad(t, ((r, r), (r, r)), constant_values=0)

    yy = jnp.arange(fh)[:, None]
    xx = jnp.arange(fw)[None, :]
    offsets = jnp.asarray(_candidate_offsets(r))

    def step(state, d):
        gm, best = state
        dy, dx = d[0], d[1]
        # anchor-coordinate overlap: the tracked block spans
        # [max(0,d), fh+min(0,d)) in tracked coords (libs/motion.cpp:72-88),
        # which is [max(0,-d), fh-max(0,d)) back in anchor coords
        cand = jax.lax.dynamic_slice(tp, (r + dy, r + dx), (fh, fw))
        inside = (
            (yy >= jnp.maximum(0, -dy))
            & (yy < fh - jnp.maximum(0, dy))
            & (xx >= jnp.maximum(0, -dx))
            & (xx < fw - jnp.maximum(0, dx))
        )
        # anchor pixel = tracked pixel shifted back by d
        diff = jnp.where(inside, jnp.abs(cand - a), 0)
        count = jnp.sum(inside)
        mad = jnp.sum(diff).astype(jnp.float32) / count.astype(jnp.float32)
        update = mad < best
        gm = jnp.where(update, jnp.array([dx, dy], jnp.float32), gm)
        best = jnp.where(update, mad, best)
        return (gm, best), None

    init = (jnp.zeros(2, jnp.float32), jnp.float32(_FLT_MAX))
    (gm, best), _ = jax.lax.scan(step, init, offsets)
    return gm, best


def estimate_global_motion_hierarchical(
    tracked_pyramid: Sequence[jnp.ndarray],
    anchor_pyramid: Sequence[jnp.ndarray],
    base_search_range: int,
) -> jnp.ndarray:
    """Pyramid global-motion search (``EstimateGlobalMotionHierarchical``,
    libs/motion.cpp:101-142): top level searched at the reduced range, each
    lower level doubles the estimate and adds a +-1 corrective search
    (which the reference centers at zero displacement, not at the
    propagated estimate — replicated)."""
    level_count = len(tracked_pyramid)
    factor = 1 << (level_count - 1)
    gm, _ = estimate_global_motion_exhaustive(
        tracked_pyramid[-1], anchor_pyramid[-1], base_search_range // factor
    )
    for lvl in range(level_count - 2, -1, -1):
        corrective, _ = estimate_global_motion_exhaustive(
            tracked_pyramid[lvl], anchor_pyramid[lvl], 1
        )
        gm = 2.0 * gm + corrective
    return gm
