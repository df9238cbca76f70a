"""Plain-NumPy *specification models* of the codec's algorithms.

These are deliberately naive sequential implementations written from the
algorithm semantics documented in SURVEY.md (per-block raster scans, running
minima with the reference's tie-break rules, flat-region reset, cross-level
MAD carry). They exist purely as test oracles for the vectorized device ops —
slow, obvious, and independent of the implementation under test.
"""

from __future__ import annotations

import numpy as np

FLT_MAX = np.float32(np.finfo(np.float32).max)


def mad(tracked, anchor, t_pos, a_pos, bw, bh):
    ty, tx = t_pos
    ay, ax = a_pos
    t = tracked[ty : ty + bh, tx : tx + bw].astype(np.int64)
    a = anchor[ay : ay + bh, ax : ax + bw].astype(np.int64)
    return np.float32(np.abs(t - a).sum()) / np.float32(bw * bh)


def ebma_spec(tracked, anchor, r, bw, bh):
    """Exhaustive search; <= tie-break (last wins); flat-region zero reset."""
    fh, fw = anchor.shape
    mfh, mfw = fh // bh, fw // bw
    mv = np.zeros((mfh, mfw, 2), np.float32)
    mm = np.full((mfh, mfw), FLT_MAX, np.float32)
    for iy in range(mfh):
        ay = iy * bh
        y0, y1 = max(0, ay - r), min(fh - bh + 1, ay + r + 1)
        for ix in range(mfw):
            ax = ix * bw
            x0, x1 = max(0, ax - r), min(fw - bw + 1, ax + r + 1)
            updates = 0
            for ty in range(y0, y1):
                for tx in range(x0, x1):
                    m = mad(tracked, anchor, (ty, tx), (ay, ax), bw, bh)
                    if m <= mm[iy, ix]:
                        mm[iy, ix] = m
                        mv[iy, ix] = (tx - ax, ty - ay)
                        updates += 1
            if updates == (y1 - y0) * (x1 - x0):
                mv[iy, ix] = (0.0, 0.0)
    return mv, mm


def refine_spec(tracked, anchor, r, bw, bh, mv, mm):
    """Strict-< refinement around propagated positions; carries min MAD in."""
    fh, fw = anchor.shape
    mfh, mfw = fh // bh, fw // bw
    mv = mv.copy()
    mm = mm.copy()
    for iy in range(mfh):
        ay = iy * bh
        for ix in range(mfw):
            ax = ix * bw
            py = ay + int(np.round(mv[iy, ix, 1]))
            px = ax + int(np.round(mv[iy, ix, 0]))
            y0, y1 = max(0, py - r), min(fh - bh + 1, py + r + 1)
            x0, x1 = max(0, px - r), min(fw - bw + 1, px + r + 1)
            for ty in range(y0, y1):
                for tx in range(x0, x1):
                    m = mad(tracked, anchor, (ty, tx), (ay, ax), bw, bh)
                    if m < mm[iy, ix]:
                        mm[iy, ix] = m
                        mv[iy, ix] = (tx - ax, ty - ay)
    return mv, mm


def hbma_spec(tracked_pyr, anchor_pyr, r, bw, bh):
    levels = len(tracked_pyr)
    factor = 1 << (levels - 1)
    top_r = r // factor
    mv, mm = ebma_spec(
        tracked_pyr[-1], anchor_pyr[-1], top_r, bw // factor, bh // factor
    )
    for lvl in range(levels - 2, -1, -1):
        scale = 1 << lvl
        mv = mv * 2.0
        mv, mm = refine_spec(
            tracked_pyr[lvl], anchor_pyr[lvl], top_r,
            bw // scale, bh // scale, mv, mm,
        )
    return mv, mm


def global_exhaustive_spec(tracked, anchor, r):
    fh, fw = anchor.shape
    best = FLT_MAX
    gm = np.zeros(2, np.float32)
    for dy in range(-r, r + 1):
        ty0, ty1 = max(0, dy), fh + min(0, dy)
        for dx in range(-r, r + 1):
            tx0, tx1 = max(0, dx), fw + min(0, dx)
            t = tracked[ty0:ty1, tx0:tx1].astype(np.int64)
            a = anchor[ty0 - dy : ty1 - dy, tx0 - dx : tx1 - dx].astype(
                np.int64
            )
            m = np.float32(np.abs(t - a).sum()) / np.float32(t.size)
            if m < best:
                best = m
                gm = np.array([dx, dy], np.float32)
    return gm, best
