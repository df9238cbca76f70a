"""Encoder observability: per-stage visualization dumps.

The reference ships an ``encoder-visualizer`` build flavor that renders a
3x3 window of seven pipeline views per frame — base frame, motion field,
global motion, foreground mask, mask after morphology, foreground clusters,
foreground regions (reference: libs/encoder.cpp:383-445 and the
``#ifdef VISUALIZE`` blocks; overlays in libs/draw.cpp). There is no file
output in the reference; this visualizer is headless-first and writes one
composite image per frame (PNG when OpenCV is importable, ``.npy``
otherwise).

Overlays mirror the reference's: per-block motion arrows
(``DrawMotionField``, libs/draw.cpp:57-92) and the global-motion arrow
grid (``DrawMotionVecAsField``, libs/draw.cpp:94-118) rendered with a
pure-NumPy Bresenham rasterizer in the reference's arrow style (color
(20,255,57), tip length 0.2 — libs/draw.cpp:6-14), cluster/region tints
with the reference's exact 36-color palette table (libs/draw.cpp:35-54;
the values below are that table verbatim), plus flow-coloring as an
additional diagnostic view.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# 36 visually distinct BGR colors (same palette family the reference uses,
# libs/draw.cpp:35-54)
_PALETTE = np.array(
    [
        (169, 169, 169), (79, 79, 47), (47, 107, 85), (34, 139, 34),
        (0, 0, 128), (0, 128, 128), (139, 61, 72), (139, 139, 0),
        (128, 0, 0), (50, 205, 154), (127, 0, 127), (143, 188, 143),
        (96, 48, 176), (0, 69, 255), (0, 165, 255), (0, 255, 255),
        (0, 255, 127), (211, 0, 148), (127, 255, 0), (60, 20, 220),
        (255, 255, 0), (255, 191, 0), (96, 164, 244), (255, 0, 0),
        (255, 0, 255), (140, 230, 240), (114, 128, 250), (237, 149, 100),
        (221, 160, 221), (144, 238, 144), (147, 20, 255), (238, 104, 123),
        (238, 238, 175), (238, 130, 238), (196, 228, 255), (193, 182, 255),
    ],
    dtype=np.uint8,
)


def flow_to_bgr(mv: np.ndarray, max_mag: Optional[float] = None) -> np.ndarray:
    """Color-code a ``(h, w, 2)`` motion field: hue=direction, sat=magnitude."""
    x, y = mv[..., 0], mv[..., 1]
    mag = np.sqrt(x * x + y * y)
    ang = (np.arctan2(y, x) + np.pi) / (2 * np.pi)  # 0..1
    m = max_mag or max(float(mag.max()), 1e-6)
    s = np.clip(mag / m, 0, 1)
    h6 = ang * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    v = np.ones_like(s)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i[..., None]  # broadcast against the channel axis
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1), np.stack([q, v, p], -1),
            np.stack([p, v, t], -1), np.stack([p, q, v], -1),
            np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ],
    )
    return (rgb[..., ::-1] * 255).astype(np.uint8)  # BGR


ARROW_COLOR = (20, 255, 57)  # DefaultInit(ArrowedLineParams), draw.cpp:9
ARROW_TIP_LEN = 0.2


def _draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color) -> None:
    """Clipped Bresenham line segment into a uint8 BGR image."""
    h, w = img.shape[:2]
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    x, y = x0, y0
    while True:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color
        if x == x1 and y == y1:
            return
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x += sx
        if e2 < dx:
            err += dx
            y += sy


def draw_arrow(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color=ARROW_COLOR, tip_len: float = ARROW_TIP_LEN) -> None:
    """``cv::arrowedLine`` geometry: main segment plus two tip strokes at
    pi/4 off the reversed direction, tip length = ``tip_len * |segment|``
    (the zero-length case degenerates to a dot, like OpenCV's)."""
    _draw_line(img, x0, y0, x1, y1, color)
    length = float(np.hypot(x1 - x0, y1 - y0))
    if length < 1e-9:
        return
    angle = np.arctan2(float(y0 - y1), float(x0 - x1))
    tip = tip_len * length
    for da in (np.pi / 4, -np.pi / 4):
        tx = int(round(x1 + tip * np.cos(angle + da)))
        ty = int(round(y1 + tip * np.sin(angle + da)))
        _draw_line(img, x1, y1, tx, ty, color)


def _round_half_away(v: float) -> int:
    """C ``std::round`` (``RoundFloatToInt``/``Vec2fToVec2i``,
    libs/math.hpp:15-18, 236-241)."""
    return int(np.floor(v + 0.5)) if v >= 0 else -int(np.floor(-v + 0.5))


def draw_motion_field(img: np.ndarray, mv: np.ndarray, block_w: int,
                      block_h: int, color=ARROW_COLOR) -> np.ndarray:
    """Per-block MV arrows from each block's top-left corner
    (``DrawMotionField``, libs/draw.cpp:57-92). Returns ``img``."""
    mfh, mfw = mv.shape[:2]
    for fy in range(mfh):
        y = fy * block_h
        for fx in range(mfw):
            x = fx * block_w
            draw_arrow(
                img, x, y,
                x + _round_half_away(float(mv[fy, fx, 0])),
                y + _round_half_away(float(mv[fy, fx, 1])),
                color,
            )
    return img


def draw_motion_vec_as_field(img: np.ndarray, gm, block_w: int,
                             block_h: int, color=ARROW_COLOR) -> np.ndarray:
    """The global-motion vector repeated on the block grid
    (``DrawMotionVecAsField``, libs/draw.cpp:94-118). Returns ``img``."""
    h, w = img.shape[:2]
    dx = _round_half_away(float(gm[0]))
    dy = _round_half_away(float(gm[1]))
    for y in range(0, h, block_h):
        for x in range(0, w, block_w):
            draw_arrow(img, x, y, x + dx, y + dy, color)
    return img


def tint_labels(base_bgr: np.ndarray, labels: np.ndarray,
                first_id: int = 1) -> np.ndarray:
    """Tint labeled cells with the palette (labels at MV-grid resolution are
    upscaled by plain repetition, like the reference's per-block tint fills,
    libs/draw.cpp:118-141)."""
    h, w = base_bgr.shape[:2]
    lh, lw = labels.shape
    up = np.repeat(np.repeat(labels, h // lh, 0), w // lw, 1)
    colored = _PALETTE[(up - first_id) % len(_PALETTE)]
    mask = (up >= first_id)[..., None]
    return np.where(mask, (0.5 * base_bgr + 0.5 * colored).astype(np.uint8),
                    base_bgr)


def upscale_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    u = np.repeat(np.repeat(mask, h // mask.shape[0], 0), w // mask.shape[1], 1)
    return (u.astype(np.uint8) * 255)[..., None].repeat(3, -1)


_VIEW_TITLES = (
    "Base", "Motion Field (MF)", "Global Motion (GM)",
    "Foreground (FG) Mask", "FG Mask After Morph", "FG Clusters",
    "FG Regions", "MF Flow",
)


def _draw_titles(views: np.ndarray, h: int, w: int) -> np.ndarray:
    """Outlined view titles like the reference's ``DrawViewTitle``
    (libs/encoder.cpp:284-293, libs/draw.cpp:143-158); needs OpenCV for
    text rasterization, silently skipped otherwise."""
    try:
        import cv2  # type: ignore
    except ImportError:
        return views
    scale = max(min(w, h) / 640.0, 0.35)
    origin_scale = 2 * scale
    for idx, title in enumerate(_VIEW_TITLES):
        oy, ox = divmod(idx, 3)
        pos = (
            ox * w + int(round(8 * origin_scale)),
            oy * h + int(round(16 * origin_scale)),
        )
        for color, thick in (((0, 0, 0), 3), ((255, 255, 255), 1)):
            cv2.putText(
                views, title, pos, cv2.FONT_HERSHEY_COMPLEX, scale, color,
                max(int(thick * scale), 1), cv2.LINE_AA,
            )
    return views


def compose_views(frame_bgr, mv, gm, fg_raw, fg, labels, btypes) -> np.ndarray:
    """Build the 3x3 composite of the reference's seven views
    (libs/encoder.cpp:398-416): MF/GM carry the reference's arrow
    overlays (libs/draw.cpp:57-118) on the base frame."""
    h, w = frame_bgr.shape[:2]
    bh, bw = h // mv.shape[0], w // mv.shape[1]
    views = np.zeros((3 * h, 3 * w, 3), np.uint8)

    views[0:h, 0:w] = frame_bgr                                   # Base
    views[0:h, w:2 * w] = draw_motion_field(                      # MF
        frame_bgr.copy(), mv, bw, bh
    )
    views[0:h, 2 * w:] = draw_motion_vec_as_field(                # GM
        frame_bgr.copy(), np.asarray(gm, np.float32), bw, bh
    )
    views[h:2 * h, 0:w] = upscale_mask(fg_raw, h, w)              # FG mask
    views[h:2 * h, w:2 * w] = upscale_mask(fg, h, w)              # post-morph
    views[h:2 * h, 2 * w:] = tint_labels(frame_bgr, labels, 0)    # clusters
    views[2 * h:, 0:w] = tint_labels(frame_bgr, btypes.astype(np.int64), 1)
    # extra diagnostic: flow-colored motion (hue=direction, sat=magnitude)
    mf_color = np.repeat(np.repeat(flow_to_bgr(mv), bh, 0), bw, 1)
    views[2 * h:, w:2 * w] = (0.5 * frame_bgr + 0.5 * mf_color)
    return _draw_titles(views, h, w)


def _require_planes(encoder) -> None:
    """The visualizer views reconstruct the base image from the encoder's
    ``padded_planes`` output, which plain encodes drop (Encoder
    ``keep_planes``); fail construction clearly instead of at first batch."""
    if not getattr(encoder, "keep_planes", True):
        raise ValueError(
            "visualizing requires an encoder built with keep_planes=True"
        )


class VisualizingEncoder:
    """Wraps an ``Encoder`` and dumps per-frame composites to a directory —
    the framework's equivalent of the encoder-visualizer flavor."""

    def __init__(self, encoder, out_dir: str):
        _require_planes(encoder)
        self.encoder = encoder
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        try:
            import cv2  # type: ignore

            self._imwrite = lambda p, img: cv2.imwrite(p + ".png", img)
        except ImportError:
            self._imwrite = lambda p, img: np.save(p + ".npy", img)

    # batch-protocol passthrough: the app's header-reconcile step and
    # stream_encode read these off the outermost encoder object
    @property
    def cfg(self):
        return self.encoder.cfg

    @property
    def batch_size(self):
        return self.encoder.batch_size

    def header(self, frame_count=None):
        return self.encoder.header(frame_count)

    def encode_video(self, frames, on_batch=None, **kwargs):
        def dump(first_index, out, n_valid):
            # (3, T+1, PH, PW) full-stack planes (frame 0 = overlap)
            # -> (T, PH, PW, 3) BGR anchor images
            frames_np = np.moveaxis(
                np.asarray(out["padded_planes"])[:, 1:], 0, -1
            )
            mv = np.asarray(out["mv_field"])
            gm = np.asarray(out["global_motion"])
            fg_raw = np.asarray(out["foreground_mask_raw"])
            fg = np.asarray(out["foreground_mask"])
            labels = np.asarray(out["cluster_labels"])
            btypes = np.asarray(out["block_types"])
            for i in range(n_valid):
                composite = compose_views(
                    frames_np[i], mv[i], gm[i], fg_raw[i], fg[i],
                    labels[i], btypes[i],
                )
                self._imwrite(
                    os.path.join(
                        self.out_dir, f"frame_{first_index + i:05d}"
                    ),
                    composite,
                )
            if on_batch is not None:
                on_batch(first_index, out, n_valid)

        yield from self.encoder.encode_video(frames, on_batch=dump, **kwargs)


class LiveEncoderView:
    """Wraps an ``Encoder`` and shows the 7-view composite in a window
    while encoding — the reference's encoder-visualizer live display
    (libs/encoder.cpp:654-659: ``imshow`` + quit-on-keypress; here a
    keypress stops the display but encoding continues). Requires OpenCV.
    """

    def __init__(self, encoder, window: str = "svc encoder"):
        import cv2  # raises ImportError without OpenCV, caller gates

        _require_planes(encoder)
        self._cv2 = cv2
        self.encoder = encoder
        self.window = window
        self._open = True
        cv2.namedWindow(window, cv2.WINDOW_NORMAL)

    # batch-protocol passthrough (see VisualizingEncoder)
    @property
    def cfg(self):
        return self.encoder.cfg

    @property
    def batch_size(self):
        return self.encoder.batch_size

    def header(self, frame_count=None):
        return self.encoder.header(frame_count)

    def encode_video(self, frames, on_batch=None, **kwargs):
        cv2 = self._cv2

        def show(first_index, out, n_valid):
            if self._open:
                frames_np = np.moveaxis(
                    np.asarray(out["padded_planes"])[:, 1:], 0, -1
                )
                mv = np.asarray(out["mv_field"])
                gm = np.asarray(out["global_motion"])
                fg_raw = np.asarray(out["foreground_mask_raw"])
                fg = np.asarray(out["foreground_mask"])
                labels = np.asarray(out["cluster_labels"])
                btypes = np.asarray(out["block_types"])
                for i in range(n_valid):
                    composite = compose_views(
                        frames_np[i], mv[i], gm[i], fg_raw[i], fg[i],
                        labels[i], btypes[i],
                    )
                    cv2.imshow(self.window, composite)
                    if cv2.waitKey(1) >= 0:
                        self._open = False
                        cv2.destroyWindow(self.window)
                        break
            if on_batch is not None:
                on_batch(first_index, out, n_valid)

        yield from self.encoder.encode_video(frames, on_batch=show, **kwargs)
