"""The decoder pipeline: gaze/region-adaptive dequantization + IDCT.

Implements the reference decoder's per-frame loop
(reference: libs/decoder.cpp:151-216) as a batched jitted transform:

    per-block quant step (gaze rect / block type) -> quantize -> IDCT
    -> merge channels -> resize to the original frame size

The reference is display-only (``cv::imshow``; no file output exists) and
reads the gaze position from the mouse (libs/decoder.cpp:53-63). This
decoder is headless-first: it returns frames, and gaze comes from an
explicit per-frame position (the apps accept a static position or a
trajectory file; a GUI mode is available when OpenCV is importable).

Replicated reference quirk: the final resize maps the whole PADDED
reconstruction — including the zero padding bands — onto the original
frame size (libs/decoder.cpp:157-210), so streams with nonzero
``frame_excess`` come out slightly squeezed, exactly like the reference
displays them. (The reference's serializer bug Q4 meant it only ever
produced valid streams with zero excess anyway; this framework encodes
padded streams correctly, and faithfully reproduces the display-path
squeeze.)
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svc_tpu.config import DecoderConfig
from svc_tpu.io import bitstream
from svc_tpu.ops.dct import idct2_wire_to_planes
from svc_tpu.ops.quant import block_quant_steps, quantize
from svc_tpu.ops.resize import resize_bilinear
from svc_tpu.utils.mathx import round_half_away_from_zero


def gaze_rect_from_center(
    cx: int, cy: int, max_w: int, max_h: int, frame_w: int, frame_h: int
) -> Tuple[int, int, int, int]:
    """Clamp a gaze rectangle centered at (cx, cy) inside the frame.

    Exact semantics of ``CalcWithinFrameRectFromCenter``
    (libs/decoder.cpp:65-100): the half extents shrink so the rect stays
    within bounds. Returns ``(x, y, w, h)``.
    """
    cx = min(max(cx, 0), frame_w - 1)
    cy = min(max(cy, 0), frame_h - 1)

    half_w = (max_w + 1) // 2
    if cx + half_w >= frame_w:
        half_w = frame_w - cx - 1
    if cx < half_w:
        half_w = cx

    half_h = (max_h + 1) // 2
    if cy + half_h >= frame_h:
        half_h = frame_h - cy - 1
    if cy < half_h:
        half_h = cy

    return cx - half_w, cy - half_h, 2 * half_w, 2 * half_h


class Decoder:
    """Batched bitstream decoder.

    Args:
      cfg: validated ``DecoderConfig``.
      header: bitstream header.
      batch_size: frames decoded per compiled step.
      mesh: optional 1-D frame mesh (``parallel.sharding.make_frame_mesh``)
        — frames are data-parallel in decode (each depends only on its own
        payload and gaze rect, libs/decoder.cpp:151-216), so the batch
        shards across the mesh with no collectives; outputs are identical
        to the single-chip program per frame.
    """

    def __init__(
        self,
        cfg: DecoderConfig,
        header: bitstream.Header,
        batch_size: int = 8,
        mesh=None,
    ):
        self.cfg = cfg
        self.header = header
        self.batch_size = batch_size
        fn = self._build_decode_batch()
        self._mesh = mesh
        if mesh is None:
            self._decode_batch = jax.jit(fn)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from svc_tpu.parallel.sharding import FRAME_AXIS

            if batch_size % mesh.devices.size:
                raise ValueError(
                    f"batch size {batch_size} must divide across "
                    f"{mesh.devices.size} devices"
                )
            spec = P(FRAME_AXIS)
            sharded = jax.jit(
                jax.shard_map(
                    fn,
                    mesh=mesh,
                    in_specs=(spec, spec, spec),
                    out_specs=spec,
                    check_vma=False,
                )
            )
            sharding = NamedSharding(mesh, spec)

            def decode_sharded(coeffs, btypes, rects):
                return sharded(
                    jax.device_put(coeffs, sharding),
                    jax.device_put(btypes, sharding),
                    jax.device_put(rects, sharding),
                )

            self._decode_batch = decode_sharded

    def stage_coeffs(self, coeffs: np.ndarray):
        """Transfer host wire coefficients to the device — the staged half
        of ``decode_frames``' H2D/compute overlap."""
        return jax.device_put(coeffs)

    def _build_decode_batch(self):
        cfg = self.cfg
        h = self.header
        pw, ph = h.padded_frame_w, h.padded_frame_h
        tbw, tbh = h.transform_block_w, h.transform_block_h

        channels = h.channel_count

        def decode_batch(
            coeffs: jnp.ndarray,  # (T, nby, nbx, C*bh*bw) float32 (wire)
            block_types: jnp.ndarray,  # (T, nby, nbx) uint32
            gaze_rects: jnp.ndarray,  # (T, 4) int32 — padded space (x,y,w,h)
        ) -> jnp.ndarray:
            nby, nbx = ph // tbh, pw // tbw
            # block top-left coordinates in padded space
            bys = jnp.arange(nby, dtype=jnp.int32)[:, None] * tbh
            bxs = jnp.arange(nbx, dtype=jnp.int32)[None, :] * tbw

            def frame_steps(types, rect):
                rx, ry, rw, rh = rect[0], rect[1], rect[2], rect[3]
                # cv::Rect::contains: x <= px < x + w (libs/decoder.cpp:201)
                gazed = (
                    (bxs >= rx)
                    & (bxs < rx + rw)
                    & (bys >= ry)
                    & (bys < ry + rh)
                )
                return block_quant_steps(
                    types,
                    gazed,
                    cfg.foreground_quant_step,
                    cfg.background_quant_step,
                )

            steps = jax.vmap(frame_steps)(block_types, gaze_rects)

            def per_frame(c, st):
                # per-block steps broadcast directly in block layout
                deq = quantize(c, st[:, :, None])
                planes = idct2_wire_to_planes(deq, channels, tbh, tbw)
                # display path: /255, bilinear resize to original size,
                # imshow (libs/decoder.cpp:208-211); the /255 and the
                # implicit *255 of display cancel — resize in 0..255 space
                out = resize_bilinear(planes, h.frame_h, h.frame_w)
                return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

            planes = jax.vmap(per_frame)(coeffs, steps)  # (T, C, H, W)
            # interleave to packed (T, H, W*C); the host views the packed
            # rows as (H, W, C) for free
            return jnp.moveaxis(planes, 1, -1).reshape(
                planes.shape[0], h.frame_h, h.frame_w * channels
            )

        return decode_batch

    # ------------------------------------------------------------------

    def padded_gaze_rect(
        self, gaze: Optional[Tuple[int, int]]
    ) -> Tuple[int, int, int, int]:
        """Gaze rect in padded space (libs/decoder.cpp:174-183), or a
        degenerate empty rect when no gaze position is given (the
        reference's zero-initialized mouse state behaves the same)."""
        h = self.header
        if gaze is None:
            return (0, 0, 0, 0)
        rect = gaze_rect_from_center(
            gaze[0],
            gaze[1],
            self.cfg.max_gaze_rect_w,
            self.cfg.max_gaze_rect_h,
            h.frame_w,
            h.frame_h,
        )
        w_ratio = h.padded_frame_w / h.frame_w
        h_ratio = h.padded_frame_h / h.frame_h
        return (
            round_half_away_from_zero(rect[0] * w_ratio),
            round_half_away_from_zero(rect[1] * h_ratio),
            round_half_away_from_zero(rect[2] * w_ratio),
            round_half_away_from_zero(rect[3] * h_ratio),
        )

    def decode_frames(
        self,
        payloads: Iterator[bytes],
        gazes: Optional[Iterator[Optional[Tuple[int, int]]]] = None,
        tracer=None,
        stage_h2d: bool = True,
    ) -> Iterator[np.ndarray]:
        """Decode wire payloads into uint8 BGR frames.

        Batches are padded to the compiled batch shape; surplus outputs are
        discarded.

        Device->host readback OVERLAPS the next batch's compute, mirroring
        the encoder's streaming loop (models.encoder.stream_encode): batch
        ``i``'s outputs are dispatched asynchronously and fetched only
        after batch ``i+1`` has been enqueued, so the D2H transfer and the
        host-side parse of ``i+1`` ride alongside device compute — the
        batched analog of the reference decoder's reader-thread/decode
        overlap (apps/decoder.cpp:55-88).

        Host->device staging ALSO overlaps compute (``stage_h2d``, on the
        single-device path): each batch's wire coefficients —
        by far the heaviest transfer, 401 MB/batch at 1080p/16 — are
        shipped on a worker thread (runtime.staging.DoubleBufferedStager)
        while the previous batch computes, so steady state is bounded by
        ``max(H2D, compute, D2H)`` instead of their sum — the decoder
        twin of the reference's reader thread (apps/decoder.cpp:55-88).
        Output bytes are identical with staging on or off
        (tests/test_pipeline.py). ``tracer`` records
        parse/dispatch/fetch spans (runtime.tracing.Tracer).
        """
        batch = self.batch_size
        buf_c: List[np.ndarray] = []
        buf_t: List[np.ndarray] = []
        buf_g: List[Tuple[int, int, int, int]] = []
        pending = None  # one batch in flight: fetch i while i+1 computes

        def span(name, **kw):
            if tracer is not None:
                return tracer.span(name, **kw)
            import contextlib

            return contextlib.nullcontext()

        def take_buffers():
            while len(buf_c) < batch:
                buf_c.append(buf_c[-1])
                buf_t.append(buf_t[-1])
                buf_g.append(buf_g[-1])
            args = (
                np.stack(buf_c),
                np.stack(buf_t),
                np.asarray(buf_g, np.int32),
            )
            buf_c.clear()
            buf_t.clear()
            buf_g.clear()
            return args

        def fetch(done):
            out, n_valid = done
            packed = np.asarray(out)[:n_valid]  # (n, H, W*C)
            return packed.reshape(
                packed.shape[0],
                self.header.frame_h,
                self.header.frame_w,
                -1,
            )

        def dispatch(coeffs_dev_or_host, types, rects, n_valid: int):
            nonlocal pending
            with span("device_dispatch", frames=n_valid):
                out = self._decode_batch(coeffs_dev_or_host, types, rects)
            prev, pending = pending, (out, n_valid)
            if prev is not None:
                with span("device_fetch", frames=prev[1]):
                    yield from fetch(prev)

        stager = None
        staged_meta = None  # (types, rects, n_valid) of the staged batch
        if stage_h2d and self._mesh is None:
            from svc_tpu.runtime.staging import DoubleBufferedStager

            stager = DoubleBufferedStager(self.stage_coeffs)

        def run(n_valid: int):
            nonlocal staged_meta
            coeffs, types, rects = take_buffers()
            if stager is not None:
                if staged_meta is not None:
                    staged = stager.collect()  # batch i-1's transfer
                    meta = staged_meta
                    stager.submit(coeffs)  # batch i streams H2D...
                    staged_meta = (types, rects, n_valid)
                    # ...while batch i-1 computes
                    yield from dispatch(staged, *meta)
                else:
                    stager.submit(coeffs)
                    staged_meta = (types, rects, n_valid)
            else:
                yield from dispatch(coeffs, types, rects, n_valid)

        try:
            for payload in payloads:
                with span("parse"):
                    types, coeffs = bitstream.deserialize_frame_blocks(
                        payload, self.header
                    )
                gaze = next(gazes, None) if gazes is not None else None
                # merged trailing C*bh*bw axis: a free host view
                buf_c.append(
                    coeffs.reshape(coeffs.shape[0], coeffs.shape[1], -1)
                )
                buf_t.append(types)
                buf_g.append(self.padded_gaze_rect(gaze))
                if len(buf_c) == batch:
                    yield from run(batch)

            if buf_c:
                yield from run(len(buf_c))
            if staged_meta is not None:
                staged = stager.collect()
                yield from dispatch(staged, *staged_meta)
            if pending is not None:
                with span("device_fetch", frames=pending[1]):
                    yield from fetch(pending)
        finally:
            if stager is not None:
                stager.close()
