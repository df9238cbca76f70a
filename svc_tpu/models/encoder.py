"""The encoder pipeline: batched and jitted.

Implements the per-frame pipeline of the reference encoder
(reference: libs/encoder.cpp:341-667) as one jitted transform over a batch
of frames:

    pad -> BGR->Y -> Gaussian pyramid -> HBMA motion search -> RANSAC
    global motion -> foreground mask -> morphology close/open -> k-means
    motion clustering -> per-cluster connected components -> block types
    -> blockwise DCT

Where the reference processes one frame per loop iteration on a CPU thread
(in_queue.Pop ... out_queue.Push, libs/encoder.cpp:453-664), this encoder
consumes ``batch+1`` frames at once: frame ``t`` is tracked against anchor
``t+1``, all pairs in parallel (``vmap``), all stages fused by XLA into one
program per batch shape. Frame t depends on frame t-1 only through the
*input* pyramid (libs/encoder.cpp:661-663), so any contiguous chunk encodes
independently given one overlap frame — the basis for both batching and
multi-chip sharding (svc_tpu.parallel).

Parity decisions (SURVEY.md §2.1):

* Q1 (k-means feature layout bug) — fixed by default: features are
  ``(mv.x, mv.y, block_px_x, block_px_y)``; ``reference_compat=True``
  reproduces the reference's effective ``(0, mv.x, x, y)`` layout
  (libs/encoder.cpp:296-321 + libs/math.hpp:285-291).
* Q4 (serialization stride) — the padded grid is serialized (see
  svc_tpu.io.bitstream).
* Q6/Q8 (flat-region rule, tie-breaks) — replicated exactly (ops.motion).
* Q7 (nondeterminism) — replaced by per-frame PRNG keys derived from
  ``cfg.seed``.
* The reference clamps the cluster count to the foreground block count
  (libs/encoder.cpp:557-559); a jitted program needs static shapes, so
  k-means always runs with ``cluster_count`` centers and surplus clusters
  come out empty — an empty cluster contributes exactly one count to the
  block-type offset, like an empty ``cv::connectedComponents`` call.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svc_tpu.config import EncoderConfig, VideoProperties
from svc_tpu.io import bitstream
from svc_tpu.ops.ccl import block_types_from_clusters
from svc_tpu.ops.color import bgr_planes_to_y
from svc_tpu.ops.dct import dct2_planes_to_wire
from svc_tpu.ops.kmeans import kmeans_t_frames
from svc_tpu.ops.morphology import close_then_open
from svc_tpu.ops.motion import hbma_stack
from svc_tpu.ops.pad import pad_frame, padded_dims
from svc_tpu.ops.pyramid import build_pyramid
from svc_tpu.ops.ransac import estimate_global_motion_ransac, iter_count

class Encoder:
    """Batched video encoder.

    Args:
      cfg: validated ``EncoderConfig``.
      vidprops: source video properties (apps/encoder.cpp:198-204).
      batch_size: anchor frames encoded per compiled step.
      keep_planes: include the padded channel planes in the outputs
        (``padded_planes``, the full ``(3, T+1, PH, PW)`` stack). Only the
        visualizer consumes them, so the default drops the extra
        ~100 MB/batch output at 1080p.
    """

    def __init__(
        self,
        cfg: EncoderConfig,
        vidprops: VideoProperties,
        batch_size: int = 8,
        keep_planes: bool = False,
    ):
        self.cfg = cfg
        self.vidprops = vidprops
        self.batch_size = batch_size
        self.keep_planes = keep_planes

        self.padded_w, self.padded_h = padded_dims(
            vidprops.frame_w,
            vidprops.frame_h,
            cfg.mv_block_w,
            cfg.mv_block_h,
            cfg.pyr_lvl_count,
        )
        self.excess_w = self.padded_w - vidprops.frame_w
        self.excess_h = self.padded_h - vidprops.frame_h
        self.mv_field_w = self.padded_w // cfg.mv_block_w
        self.mv_field_h = self.padded_h // cfg.mv_block_h

        if iter_count(cfg.ransac) == 0:
            raise ValueError(
                "RANSAC parameters yield zero hypotheses; nothing to fit"
            )

        self.encode_pairs = self._build_encode_pairs()
        # the traceable batch step (public, for jit/sharding composition)
        self.encode_batch_fn = self._build_encode_batch()
        self._encode_batch = jax.jit(self.encode_batch_fn)

    # ------------------------------------------------------------------
    # jitted pipeline
    # ------------------------------------------------------------------

    def _build_encode_pairs(self):
        """The shardable core: encode a frame-stack pyramid.

        Every (tracked, anchor) pair is independent — the basis for both
        single-chip batching and frame-parallel multi-chip sharding
        (svc_tpu.parallel.sharding). Motion runs on the FULL stack through
        ``hbma_stack``; the per-frame segmentation tail is vmapped over the
        resulting fields.
        """
        cfg = self.cfg
        mfh, mfw = self.mv_field_h, self.mv_field_w
        k = cfg.kmeans.cluster_count

        def per_pair(mv: jnp.ndarray, key: jnp.ndarray):
            """Segmentation frontend for one frame's motion field
            (everything up to the k-means features; the clustering itself
            runs frame-batched outside the vmap — ops.kmeans
            kmeans_t_frames)."""
            k_ransac, k_kmeans = jax.random.split(key)
            gm, rmse, inliers = estimate_global_motion_ransac(
                mv, cfg.ransac, k_ransac
            )

            # foreground = RANSAC outliers (libs/encoder.cpp:507-513),
            # then morphological cleanup (libs/encoder.cpp:524-527)
            fg_raw = ~inliers
            fg = close_then_open(
                fg_raw, cfg.morph_rect_w, cfg.morph_rect_h
            )

            # k-means features per FG block (libs/encoder.cpp:296-321)
            ys = (
                jnp.arange(mfh, dtype=jnp.float32)[:, None]
                * cfg.mv_block_h
            )
            xs = (
                jnp.arange(mfw, dtype=jnp.float32)[None, :]
                * cfg.mv_block_w
            )
            ys = jnp.broadcast_to(ys, (mfh, mfw))
            xs = jnp.broadcast_to(xs, (mfh, mfw))
            # features built dimension-major (D, N), the layout k-means
            # takes (svc_tpu.ops.kmeans)
            if cfg.reference_compat:
                # quirk Q1: effective reference layout (0, mv.x, x, y)
                rows = [jnp.zeros_like(xs), mv[..., 0], xs, ys]
            else:
                rows = [mv[..., 0], mv[..., 1], xs, ys]
            feats_t = jnp.stack([rw.reshape(-1) for rw in rows])
            mask_flat = fg.reshape(-1)

            return fg_raw, fg, gm, rmse, feats_t, mask_flat, k_kmeans

        def encode_pairs(
            pyr_stack: Tuple[jnp.ndarray, ...],
            planes: jnp.ndarray,
            keys: jnp.ndarray,
        ):
            """Encode ``T`` (tracked, anchor) pairs from a stack pyramid.

            Args:
              pyr_stack: per-level ``(T+1, h_l, w_l)`` luma pyramids of the
                full frame stack; frame ``t`` is tracked against anchor
                ``t+1`` (libs/encoder.cpp:661-663).
              planes: ``(3, T+1, PH, PW)`` uint8 padded channel planes of
                the full stack, order B, G, R (= ``cv::split`` order) —
                frames ``1:`` are the DCT input.
              keys: ``(T,)`` PRNG keys.
            """
            mv, _ = hbma_stack(
                list(pyr_stack),
                cfg.mv_search_range,
                cfg.mv_block_w,
                cfg.mv_block_h,
            )
            fg_raw, fg, gm, rmse, feats, masks, kmeans_keys = jax.vmap(
                per_pair
            )(mv, keys)
            labels, _, _ = kmeans_t_frames(
                feats,
                masks,
                k,
                kmeans_keys,
                attempts=cfg.kmeans.attempt_count,
                max_iter=cfg.kmeans.max_iter_count,
                epsilon=cfg.kmeans.epsilon,
                # reference-compat replicates cv::kmeans' empty-cluster
                # rule (split the biggest cluster) exactly; production
                # uses the global-farthest rule (ops/kmeans.py)
                repair=(
                    "opencv_split"
                    if cfg.reference_compat
                    else "global_farthest"
                ),
            )
            labels = labels.reshape(-1, mfh, mfw)

            # per-cluster connected components -> block types
            # (libs/encoder.cpp:597-623), one fused batched propagation over
            # every frame's cluster image (rationale + numbering semantics
            # in ops/ccl.py:block_types_from_clusters); block type ids start
            # at BLOCK_TYPE_BACKGROUND (= 0, codec.hpp:6)
            btypes, _ = block_types_from_clusters(
                labels, k, cfg.connected_components_connectivity
            )
            btypes = btypes.astype(jnp.uint32)

            # blockwise DCT on float BGR channels of the anchor frames
            # (libs/encoder.cpp:638-640; channel order = cv::split order),
            # emitted in merged wire layout (T, nby, nbx, C*bh*bw) so host
            # serialization is a memcpy (ops/dct.py)
            coeffs = dct2_planes_to_wire(
                planes[:, 1:],
                cfg.transform_block_w,
                cfg.transform_block_h,
            )

            out = {
                "coeffs": coeffs,
                "block_types": btypes,
                "mv_field": mv,
                "foreground_mask_raw": fg_raw,
                "foreground_mask": fg,
                "cluster_labels": labels,
                "global_motion": gm,
                "ransac_rmse": rmse,
            }
            if self.keep_planes:
                # FULL stack (3, T+1, PH, PW): frame 0 is the overlap
                # frame; consumers index [:, 1:] for anchors (keeping the
                # stack whole avoids a 100 MB/batch output slice copy)
                out["padded_planes"] = planes
            return out

        return encode_pairs

    def preprocess(self, packed_bgr: jnp.ndarray):
        """Unpack + pad + luma + pyramid for ``(N, H, W*3)`` packed frames.

        The host ships frames as the free reinterpretation ``(N, H, W*3)``
        of interleaved BGR rows; they are split on device into dense
        ``(3, N, PH, PW)`` channel planes that every downstream stage
        (luma, pyramid, DCT) reads.
        """
        n, h, w3 = packed_bgr.shape
        planes = jnp.moveaxis(
            packed_bgr.reshape(n, h, w3 // 3, 3), -1, 0
        )  # (3, N, H, W): B, G, R
        planes = pad_frame(planes, self.padded_w, self.padded_h)
        y = bgr_planes_to_y(planes[0], planes[1], planes[2])
        return planes, tuple(build_pyramid(y, self.cfg.pyr_lvl_count))

    def _build_encode_batch(self):
        def encode_batch(packed_bgr: jnp.ndarray, keys: jnp.ndarray):
            """Encode ``T = frames - 1`` anchor frames.

            Args:
              packed_bgr: ``(T+1, H, W*3)`` uint8 — interleaved BGR rows
                reinterpreted flat (see ``preprocess``); frame 0 is the
                overlap (tracked-only) frame (libs/encoder.cpp:360-365:
                the first frame is never emitted).
              keys: ``(T,)`` PRNG keys, one per anchor frame.
            """
            planes, pyr = self.preprocess(packed_bgr)
            return self.encode_pairs(pyr, planes, keys)

        return encode_batch

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    def header(self, frame_count: Optional[int] = None) -> bitstream.Header:
        """Bitstream header; first frame is reference-only so the stream
        carries ``frame_count - 1`` frames (libs/encoder.cpp:360-381).
        ``frame_count`` overrides the payload count for partial encodes."""
        if frame_count is None:
            frame_count = self.vidprops.frame_count
            if frame_count > 0:
                frame_count -= 1
        return bitstream.Header(
            frame_count=frame_count,
            frame_w=self.vidprops.frame_w,
            frame_h=self.vidprops.frame_h,
            frame_excess_w=self.excess_w,
            frame_excess_h=self.excess_h,
            transform_block_w=self.cfg.transform_block_w,
            transform_block_h=self.cfg.transform_block_h,
            channel_count=3,
        )

    def stage_frames(self, packed: np.ndarray):
        """Transfer host packed ``(T+1, H, W*3)`` frames to the device —
        the staged half of the protocol ``stream_encode`` uses to overlap
        H2D with compute."""
        return jax.device_put(packed)

    def _keys(self, start_index: int, count: int) -> jnp.ndarray:
        base = jax.random.key(self.cfg.seed)
        return jax.vmap(
            lambda i: jax.random.fold_in(base, i)
        )(jnp.arange(start_index, start_index + count))

    def encode_batch_staged(self, staged, first_anchor_index: int):
        """Dispatch on frames already shipped via :meth:`stage_frames` —
        the public half of the staged protocol ``stream_encode`` uses to
        overlap H2D with compute. Key derivation is the one
        :meth:`encode_batch` uses, kept here so a wrapper overriding
        either entry point cannot silently skip it."""
        keys = self._keys(first_anchor_index, self.batch_size)
        return self._encode_batch(staged, keys)

    def encode_batch(self, frames_bgr: np.ndarray, first_anchor_index: int):
        """Run the jitted pipeline on ``(T+1, H, W, 3)`` uint8 frames."""
        n, h, w, c = frames_bgr.shape
        keys = self._keys(first_anchor_index, n - 1)
        # ship the free (N, H, W*3) reinterpretation (see preprocess)
        packed = np.ascontiguousarray(frames_bgr).reshape(n, h, w * c)
        return self._encode_batch(packed, keys)

    def encode_video(
        self,
        frames: Iterator[np.ndarray],
        on_batch=None,
        emit_header: bool = True,
        header_frame_count: Optional[int] = None,
        first_anchor_index: int = 0,
        tracer=None,
    ) -> Iterator[bytes]:
        """Stream encode: yields the header, then one payload per anchor
        frame. See :func:`stream_encode`."""
        return stream_encode(
            self,
            frames,
            on_batch=on_batch,
            emit_header=emit_header,
            header_frame_count=header_frame_count,
            first_anchor_index=first_anchor_index,
            tracer=tracer,
        )


def stream_encode(
    enc,
    frames: Iterator[np.ndarray],
    on_batch=None,
    emit_header: bool = True,
    header_frame_count: Optional[int] = None,
    first_anchor_index: int = 0,
    tracer=None,
) -> Iterator[bytes]:
    """Stream encode through any encoder exposing the batch protocol
    (``header()``, ``batch_size``, ``cfg``, ``encode_batch``) — the
    single-chip :class:`Encoder` and the mesh-sharded
    ``parallel.sharding.ShardedEncoder`` both do.

    Yields the header, then one payload per anchor frame. The batch shape
    is fixed so the pipeline compiles once; the final partial batch is
    padded and its surplus discarded.

    Device->host readback OVERLAPS the next batch's compute: a batch's
    outputs are dispatched asynchronously and fetched only after the next
    batch has been enqueued (JAX's async dispatch queues the work), so the
    D2H transfer of batch i rides alongside the device compute of batch
    i+1 — the streaming analog of the reference's reader/encoder/writer
    thread overlap (apps/encoder.cpp:172-229).

    Host->device staging ALSO overlaps compute when the encoder exposes
    ``stage_frames`` (the single-chip :class:`Encoder`): each batch's
    frames are staged on a worker thread (runtime.staging) while the
    previous batch computes, so steady-state throughput is bounded by
    ``max(H2D, compute, D2H)`` instead of their sum — the transfer-level
    analog of the reference's reader thread (apps/encoder.cpp:125-149).

    ``on_batch(first_anchor_index, outputs, n_valid)`` is an optional
    observability hook (used by the visualizer); ``tracer`` records
    device/serialize spans (runtime.tracing.Tracer).
    ``emit_header=False`` plus ``first_anchor_index`` support resuming a
    partially written stream — the codec state for frame t is only frame
    t-1 (libs/encoder.cpp:661-663), so the caller just feeds frames
    starting one before the resume point.
    """
    if emit_header:
        yield enc.header(header_frame_count).pack()

    window: List[np.ndarray] = []
    anchor_index = first_anchor_index
    batch = enc.batch_size

    tbw = enc.cfg.transform_block_w
    tbh = enc.cfg.transform_block_h

    def fetch(out):
        # free host-side view back to per-block (C, bh, bw) layout
        c = np.asarray(out["coeffs"])
        t_, nby, nbx, _ = c.shape
        coeffs = c.reshape(t_, nby, nbx, -1, tbh, tbw)
        return coeffs, np.asarray(out["block_types"])

    def serialize(pending):
        out, first_index, n_valid = pending
        if tracer is not None:
            with tracer.span("device_fetch", frames=n_valid):
                coeffs, btypes = fetch(out)
        else:
            coeffs, btypes = fetch(out)
        if on_batch is not None:
            on_batch(first_index, out, n_valid)
        for i in range(n_valid):
            if tracer is not None:
                with tracer.span("serialize"):
                    payload = bitstream.serialize_frame_blocks(
                        coeffs[i],
                        btypes[i],
                        enc.cfg.mv_block_w,
                        enc.cfg.mv_block_h,
                    )
            else:
                payload = bitstream.serialize_frame_blocks(
                    coeffs[i],
                    btypes[i],
                    enc.cfg.mv_block_w,
                    enc.cfg.mv_block_h,
                )
            yield payload

    pending = None  # one batch in flight: fetch i while i+1 computes

    # H2D staging one batch ahead of compute: any encoder exposing the
    # public staged protocol (stage_frames + encode_batch_staged) —
    # the single-chip Encoder and the mesh-sharded ShardedEncoder both do
    use_staging = hasattr(enc, "stage_frames") and hasattr(
        enc, "encode_batch_staged"
    )
    stager = None
    staged_meta = None  # (first_anchor_index, n_valid) of the staged batch

    def dispatch(arr_or_staged, first_index: int, n_valid: int, staged: bool):
        nonlocal pending
        if staged:
            if tracer is not None:
                with tracer.span("device_dispatch", frames=n_valid):
                    out = enc.encode_batch_staged(arr_or_staged, first_index)
            else:
                out = enc.encode_batch_staged(arr_or_staged, first_index)
        else:
            if tracer is not None:
                with tracer.span("device_dispatch", frames=n_valid):
                    out = enc.encode_batch(arr_or_staged, first_index)
            else:
                out = enc.encode_batch(arr_or_staged, first_index)
        prev, pending = pending, (out, first_index, n_valid)
        if prev is not None:
            yield from serialize(prev)

    def run(window_frames: List[np.ndarray], n_valid: int):
        nonlocal anchor_index, staged_meta
        arr = np.stack(window_frames)
        if stager is not None:
            n, h = arr.shape[0], arr.shape[1]
            packed = np.ascontiguousarray(arr).reshape(n, h, -1)
            if staged_meta is not None:
                staged = stager.collect()  # batch i-1's transfer
                fi, nv = staged_meta
                stager.submit(packed)  # batch i streams H2D...
                staged_meta = (anchor_index, n_valid)
                anchor_index += n_valid
                # ...while batch i-1 computes
                yield from dispatch(staged, fi, nv, staged=True)
            else:
                stager.submit(packed)
                staged_meta = (anchor_index, n_valid)
                anchor_index += n_valid
        else:
            fi = anchor_index
            anchor_index += n_valid
            yield from dispatch(arr, fi, n_valid, staged=False)

    try:
        if use_staging:
            from svc_tpu.runtime.staging import DoubleBufferedStager

            stager = DoubleBufferedStager(enc.stage_frames)

        for frame in frames:
            window.append(np.asarray(frame, dtype=np.uint8))
            if len(window) == batch + 1:
                yield from run(window, batch)
                window = window[-1:]  # overlap frame

        remainder = len(window) - 1
        if remainder > 0:
            # pad to the compiled batch shape; discard surplus outputs
            pad = [window[-1]] * (batch - remainder)
            yield from run(window + pad, remainder)
        if staged_meta is not None:
            staged = stager.collect()
            fi, nv = staged_meta
            yield from dispatch(staged, fi, nv, staged=True)
        if pending is not None:
            yield from serialize(pending)
    finally:
        if stager is not None:
            stager.close()
