"""Encoder CLI.

Flag surface mirrors the reference encoder app (#options,
apps/encoder.cpp:75-104) — all flags are always available (the reference
compiles ``mv-block-w/h`` and ``pyr-lvl-count`` out of its SSE2 build,
apps/encoder.cpp:76-80; this framework has no such pinned build). Defaults
match #default-cfg (apps/encoder.cpp:28-65). The bitstream goes to stdout
(or ``--output``); diagnostics go to stderr.

Extensions beyond the reference surface:
  --output PATH     write the bitstream to a file instead of stdout
  --batch-size N    frames per compiled device step (default 8)
  --seed N          PRNG seed for RANSAC/k-means (reference used
                    nondeterministic RNG, quirk Q7)
  --reference-compat N   1 reproduces the reference's k-means feature bug (Q1)
  --visualize DIR   dump per-stage visualization frames to DIR (the
                    encoder-visualizer build flavor, libs/CMakeLists.txt:13-15)
  --show N          1 opens a live window with the 7-view composite while
                    encoding (the reference encoder-visualizer's display,
                    libs/encoder.cpp:654-659); requires OpenCV
  --devices N       shard frame batches across N devices of a 1-D mesh
                    (``jax.sharding``; ``--batch-size`` becomes the
                    per-device batch). The bitstream is byte-identical to
                    a single-device encode. 0 (default) = single device.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from svc_tpu.config import EncoderConfig, VideoProperties
from svc_tpu.config import validate_encoder_config
from svc_tpu.io.video import VideoReader
from svc_tpu.models.encoder import Encoder
from svc_tpu.runtime.pipeline import (
    BoundedQueue,
    CancelToken,
    pipeline_threads,
)
from svc_tpu.utils import cli


class _AppConfig:
    def __init__(self):
        self.encoder = EncoderConfig()
        self.verbose = 1
        self.video_path: Optional[str] = None
        self.output: Optional[str] = None
        self.batch_size = 8
        self.visualize: Optional[str] = None
        self.start_frame = 0
        self.max_frames = 0  # 0 = all
        self.no_header = 0
        self.trace: Optional[str] = None
        self.profile: Optional[str] = None
        self.devices = 0  # 0 = single device
        self.show = 0


def _opts(c: _AppConfig) -> List[cli.Opt]:
    e = c.encoder
    U, F, I, S = (
        cli.OptArgType.UINT,
        cli.OptArgType.FLOAT,
        cli.OptArgType.INT,
        cli.OptArgType.STRING,
    )
    P = cli.OptArgType.PATH
    fs = cli.field_setter
    return [
        cli.Opt("mv-block-w", U, fs(e, "mv_block_w")),
        cli.Opt("mv-block-h", U, fs(e, "mv_block_h")),
        cli.Opt("pyr-lvl-count", U, fs(e, "pyr_lvl_count")),
        cli.Opt("mv-search-range", U, fs(e, "mv_search_range")),
        cli.Opt("ransac-subset-sz", U, fs(e.ransac, "subset_sz")),
        cli.Opt("ransac-inlier-thresh", F, fs(e.ransac, "inlier_thresh")),
        cli.Opt("ransac-success-prob", F, fs(e.ransac, "success_prob")),
        cli.Opt("ransac-inlier-ratio", F, fs(e.ransac, "inlier_ratio")),
        cli.Opt("morph-rect-w", U, fs(e, "morph_rect_w")),
        cli.Opt("morph-rect-h", U, fs(e, "morph_rect_h")),
        cli.Opt("kmeans-cluster-count", U, fs(e.kmeans, "cluster_count")),
        cli.Opt("kmeans-attempt-count", U, fs(e.kmeans, "attempt_count")),
        cli.Opt("kmeans-max-iter-count", U, fs(e.kmeans, "max_iter_count")),
        cli.Opt("kmeans-epsilon", F, fs(e.kmeans, "epsilon")),
        cli.Opt(
            "connected-components-connectivity",
            U,
            fs(e, "connected_components_connectivity"),
        ),
        cli.Opt("transform-block-w", U, fs(e, "transform_block_w")),
        cli.Opt("transform-block-h", U, fs(e, "transform_block_h")),
        cli.Opt("verbose", I, fs(c, "verbose")),
        # framework extensions
        cli.Opt("seed", U, fs(e, "seed")),
        cli.Opt(
            "reference-compat",
            I,
            lambda v: setattr(e, "reference_compat", bool(v)),
        ),
        cli.Opt("output", P, fs(c, "output")),
        cli.Opt("batch-size", U, fs(c, "batch_size")),
        cli.Opt("visualize", P, fs(c, "visualize")),
        cli.Opt("show", I, fs(c, "show")),
        # resume/checkpoint: payload index to resume from (the bitstream is
        # random-access; encoder state is only the previous frame)
        cli.Opt("start-frame", U, fs(c, "start_frame")),
        cli.Opt("max-frames", U, fs(c, "max_frames")),
        cli.Opt("no-header", I, fs(c, "no_header")),
        # observability
        cli.Opt("trace", P, fs(c, "trace")),
        cli.Opt("profile", P, fs(c, "profile")),
        # scale-out
        cli.Opt("devices", U, fs(c, "devices")),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    cfg = _AppConfig()

    status, argi = cli.parse_opts(argv, _opts(cfg))
    if status != cli.Status.OK:
        print(
            f"parsing configuration: parsing options: "
            f"{cli.status_message(status)}",
            file=sys.stderr,
        )
        return 1

    if len(argv) < argi + 1:
        print(
            "parsing configuration: missing video path argument",
            file=sys.stderr,
        )
        return 1
    cfg.video_path = argv[argi]

    err = validate_encoder_config(cfg.encoder)
    if not err.ok:
        print(f"validating configuration: {err.message}.", file=sys.stderr)
        return 1

    try:
        reader = VideoReader(cfg.video_path)
    except (RuntimeError, ValueError, FileNotFoundError) as e:
        print(str(e) or "failed to initialize video capturing",
              file=sys.stderr)
        return 1
    props: VideoProperties = reader.props

    if cfg.verbose:
        print("Video properties:", file=sys.stderr)
        print(f"  Width: {props.frame_w}", file=sys.stderr)
        print(f"  Height: {props.frame_h}", file=sys.stderr)
        print(f"  Frame count: {props.frame_count}", file=sys.stderr)

    from svc_tpu.runtime.cache import enable_persistent_cache

    enable_persistent_cache()

    if cfg.devices > 1:
        import jax

        from svc_tpu.parallel.sharding import ShardedEncoder, make_frame_mesh

        avail = len(jax.devices())
        if avail < cfg.devices:
            print(
                f"requested {cfg.devices} devices but only {avail} "
                "available",
                file=sys.stderr,
            )
            return 1
        encoder = ShardedEncoder(
            cfg.encoder,
            props,
            make_frame_mesh(cfg.devices),
            batch_per_device=cfg.batch_size,
            keep_planes=bool(cfg.visualize or cfg.show),
        )
        if cfg.verbose:
            print(
                f"sharding {encoder.batch_size}-frame batches across "
                f"{cfg.devices} devices",
                file=sys.stderr,
            )
    else:
        # the visualizers are the only consumers of the padded planes
        # output; plain encodes drop it (saves the output materialization)
        encoder = Encoder(
            cfg.encoder,
            props,
            batch_size=cfg.batch_size,
            keep_planes=bool(cfg.visualize or cfg.show),
        )

    if cfg.visualize:
        from svc_tpu.visualize import VisualizingEncoder

        encoder = VisualizingEncoder(encoder, cfg.visualize)

    if cfg.show:
        from svc_tpu.visualize import LiveEncoderView

        try:
            encoder = LiveEncoderView(encoder)
        except ImportError:
            print("--show requires OpenCV (cv2)", file=sys.stderr)
            return 1

    from svc_tpu.runtime import native
    from svc_tpu.runtime.tracing import Tracer, device_profile

    tracer = Tracer(enabled=bool(cfg.trace))

    # resume/partial-encode accounting: payload k encodes source frame k+1
    total_payloads = max(props.frame_count - 1, 0)
    start = min(cfg.start_frame, total_payloads)
    n_payloads = total_payloads - start
    if cfg.max_frames:
        n_payloads = min(n_payloads, cfg.max_frames)

    def frames_from(q):
        it = iter(q)
        for _ in range(start):  # skip up to the overlap frame
            next(it, None)
        for i, frame in enumerate(it):
            if i > n_payloads:  # overlap frame + payload frames
                break
            yield frame

    stats = {"payloads": 0}

    def encode_stream(q):
        chunks = encoder.encode_video(
            frames_from(q),
            emit_header=not cfg.no_header,
            header_frame_count=n_payloads,
            first_anchor_index=start,
            tracer=tracer if cfg.trace else None,
        )
        first = not cfg.no_header
        for chunk in chunks:
            if first:
                first = False
            else:
                stats["payloads"] += 1
            yield chunk

    cancel = CancelToken()

    try:
        # 3-stage pipeline: reader thread -> encode (main) -> writer
        # (the reference's thread layout, apps/encoder.cpp:223-228); the
        # writer stage is the native C++ queue+thread when available.
        # Ctrl-C cancels the token so every stage unwinds promptly (the
        # live counterpart of the reference's unused interruptible-thread
        # framework, libs/thread.hpp:30-152).
        def produce(q: BoundedQueue) -> None:
            for frame in reader:
                cancel.check()
                q.push(frame)

        def consume(q: BoundedQueue) -> None:
            if native.available():
                with native.NativeWriter(cfg.output, capacity=10) as w:
                    for chunk in encode_stream(q):
                        w.push(chunk)
                return

            out = open(cfg.output, "wb") if cfg.output else sys.stdout.buffer

            def write_all(wq: BoundedQueue) -> None:
                for chunk in encode_stream(q):
                    wq.push(chunk)

            def drain(wq: BoundedQueue) -> None:
                for chunk in wq:
                    out.write(chunk)

            try:
                pipeline_threads(write_all, drain, capacity=10,
                                 cancel=cancel)
            finally:
                if cfg.output:
                    out.close()

        with device_profile(cfg.profile):
            pipeline_threads(produce, consume, capacity=10, cancel=cancel)
    except KeyboardInterrupt:
        cancel.cancel()
        print("interrupted", file=sys.stderr)
        return 130
    finally:
        reader.close()

    # reconcile the header with what was actually encoded: container
    # frame-count metadata (cv2 CAP_PROP_FRAME_COUNT) is often wrong, and
    # a header promising more frames than the body holds makes the stream
    # undecodable past the truncation point
    if not cfg.no_header and stats["payloads"] != n_payloads:
        if cfg.output:
            with open(cfg.output, "r+b") as f:
                f.write(encoder.header(stats["payloads"]).pack())
            print(
                f"note: source yielded {stats['payloads']} payload frames "
                f"(container metadata promised {n_payloads}); header "
                "updated",
                file=sys.stderr,
            )
        else:
            print(
                f"warning: wrote {stats['payloads']} payload frames but "
                f"the header (already on the pipe) promises {n_payloads}; "
                "decode with --max-frames or re-encode to a file",
                file=sys.stderr,
            )

    if cfg.trace:
        tracer.dump(cfg.trace)
        print(tracer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
