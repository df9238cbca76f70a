"""Decoder CLI.

Flag surface mirrors the reference decoder app (#options,
apps/decoder.cpp:34-40) with defaults from #default-cfg
(apps/decoder.cpp:21-26). Reads the bitstream from stdin (or ``--input``).

The reference is display-only with mouse-driven gaze
(libs/decoder.cpp:151-218); this app is headless-first:

  --output PATH        write decoded uint8 BGR frames (.npy or .y4m);
                       defaults to out.npy
  --input PATH         read the bitstream from a file instead of stdin
  --gaze X,Y           static gaze position in original-frame pixels
  --gaze-trajectory F  text file with one "frame_index x y" row per line
  --batch-size N       frames per compiled device step (default 8)
  --devices N          shard decode batches across N devices of a 1-D mesh
                       (frames are data-parallel; identical output)
  --show 1             display frames in an OpenCV window with live mouse
                       gaze (requires cv2), emulating the reference GUI
  --trace PATH         dump host pipeline spans (parse/dispatch/fetch) as
                       JSON and print a summary to stderr

The headless path runs the reference decoder's thread layout: a reader
thread streams fixed-size payloads through a bounded queue (cap 100,
apps/decoder.cpp:55-88) while the main thread decodes, and the decoder
keeps one batch in flight so device->host readback overlaps the next
batch's compute.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from svc_tpu.config import DecoderConfig, validate_decoder_config
from svc_tpu.io import bitstream
from svc_tpu.io.video import write_npy_video, write_y4m_video
from svc_tpu.models.decoder import Decoder
from svc_tpu.utils import cli


class _AppConfig:
    def __init__(self):
        self.decoder = DecoderConfig()
        self.input: Optional[str] = None
        self.output = "out.npy"
        self.gaze: Optional[str] = None
        self.gaze_trajectory: Optional[str] = None
        self.batch_size = 8
        self.devices = 0  # 0 = single device
        self.show = 0
        self.start_frame = 0
        self.max_frames = 0  # 0 = all
        self.trace: Optional[str] = None


def _opts(c: _AppConfig) -> List[cli.Opt]:
    d = c.decoder
    U, I, S = cli.OptArgType.UINT, cli.OptArgType.INT, cli.OptArgType.STRING
    P = cli.OptArgType.PATH
    fs = cli.field_setter
    return [
        cli.Opt("foreground-quant-step", U, fs(d, "foreground_quant_step")),
        cli.Opt("background-quant-step", U, fs(d, "background_quant_step")),
        cli.Opt("max-gaze-rect-w", U, fs(d, "max_gaze_rect_w")),
        cli.Opt("max-gaze-rect-h", U, fs(d, "max_gaze_rect_h")),
        # framework extensions
        cli.Opt("input", P, fs(c, "input")),
        cli.Opt("output", P, fs(c, "output")),
        cli.Opt("gaze", S, fs(c, "gaze")),
        cli.Opt("gaze-trajectory", P, fs(c, "gaze_trajectory")),
        cli.Opt("batch-size", U, fs(c, "batch_size")),
        cli.Opt("devices", U, fs(c, "devices")),
        cli.Opt("show", I, fs(c, "show")),
        # random access: every block has identical wire size, so frames
        # are seekable
        cli.Opt("start-frame", U, fs(c, "start_frame")),
        cli.Opt("max-frames", U, fs(c, "max_frames")),
        # observability
        cli.Opt("trace", P, fs(c, "trace")),
    ]


def _parse_gazes(
    cfg: _AppConfig, frame_count: int
) -> List[Optional[Tuple[int, int]]]:
    """Per-frame gaze positions from ``--gaze``/``--gaze-trajectory``.

    Malformed values raise ``ValueError`` with a readable message (the
    caller turns it into an exit status — CLI input must never produce a
    traceback). ``frame_count`` is bounded by ``Header.validate``.
    """
    gazes: List[Optional[Tuple[int, int]]] = [None] * frame_count
    if cfg.gaze:
        parts = cfg.gaze.replace(",", " ").split()
        try:
            pos = (int(parts[0]), int(parts[1]))
        except (IndexError, ValueError):
            raise ValueError(
                f"bad --gaze value {cfg.gaze!r}: expected X,Y integers"
            ) from None
        gazes = [pos] * frame_count
    if cfg.gaze_trajectory:
        table: Dict[int, Tuple[int, int]] = {}
        try:
            f = open(cfg.gaze_trajectory)
        except OSError as e:
            raise ValueError(
                f"failed to open gaze trajectory: {e}"
            ) from None
        with f:
            for lineno, line in enumerate(f, 1):
                fields = line.replace(",", " ").split()
                if len(fields) < 3:
                    continue
                try:
                    table[int(fields[0])] = (
                        int(fields[1]), int(fields[2])
                    )
                except ValueError:
                    raise ValueError(
                        f"bad gaze trajectory line {lineno}: "
                        f"{line.rstrip()!r}"
                    ) from None
        last: Optional[Tuple[int, int]] = None
        for i in range(frame_count):
            last = table.get(i, last)
            gazes[i] = last
    return gazes


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    cfg = _AppConfig()

    status, _ = cli.parse_opts(argv, _opts(cfg))
    if status != cli.Status.OK:
        print(
            f"parsing config: parsing options: {cli.status_message(status)}",
            file=sys.stderr,
        )
        return 1

    err = validate_decoder_config(cfg.decoder)
    if not err.ok:
        print(f"validating config: {err.message}", file=sys.stderr)
        return 1

    try:
        stream = open(cfg.input, "rb") if cfg.input else sys.stdin.buffer
    except OSError as e:
        print(f"failed to open input: {e}", file=sys.stderr)
        return 1
    raw_header = stream.read(bitstream.HEADER_SIZE)
    if len(raw_header) < bitstream.HEADER_SIZE:
        print("failed to read header", file=sys.stderr)
        return 1
    header = bitstream.Header.unpack(raw_header)
    try:
        header.validate()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    from svc_tpu.runtime.cache import enable_persistent_cache

    enable_persistent_cache()

    if cfg.show:
        # latency over throughput in GUI mode: a single-frame program, so
        # the first displayed frame doesn't stall behind a batch compile
        # and the only compiled program is the one the loop uses
        cfg.batch_size = 1
        cfg.devices = 0

    if cfg.devices > 1:
        import jax

        from svc_tpu.parallel.sharding import make_frame_mesh

        avail = len(jax.devices())
        if avail < cfg.devices:
            print(
                f"requested {cfg.devices} devices but only {avail} "
                "available",
                file=sys.stderr,
            )
            return 1
        per_dev = -(-cfg.batch_size // cfg.devices)
        decoder = Decoder(
            cfg.decoder,
            header,
            batch_size=per_dev * cfg.devices,
            mesh=make_frame_mesh(cfg.devices),
        )
    else:
        decoder = Decoder(cfg.decoder, header, batch_size=cfg.batch_size)

    start = min(cfg.start_frame, header.frame_count)
    count = header.frame_count - start
    if cfg.max_frames:
        count = min(count, cfg.max_frames)
    bitstream.seek_to_frame(stream, header, start)

    if cfg.show:
        return _run_gui(cfg, decoder, stream, header, count)

    try:
        gazes = _parse_gazes(cfg, header.frame_count)[start : start + count]
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    # 2-stage pipeline: reader thread -> decode (main), the reference
    # decoder's thread layout (apps/decoder.cpp:55-88, queue cap 100) —
    # stream reads overlap device decode, and decode_frames itself keeps
    # one batch in flight so D2H readback overlaps the next batch
    from svc_tpu.runtime.pipeline import BoundedQueue, pipeline_threads
    from svc_tpu.runtime.tracing import Tracer

    tracer = Tracer(enabled=bool(cfg.trace))
    frames: List[np.ndarray] = []

    def produce(q: BoundedQueue) -> None:
        for payload in bitstream.read_frames(stream, header, count):
            q.push(payload)

    def consume(q: BoundedQueue) -> None:
        frames.extend(
            decoder.decode_frames(
                iter(q), iter(gazes), tracer=tracer if cfg.trace else None
            )
        )

    pipeline_threads(produce, consume, capacity=100)
    video = (
        np.stack(frames)
        if frames
        else np.zeros((0, header.frame_h, header.frame_w, 3), np.uint8)
    )
    if cfg.output.endswith(".y4m"):
        write_y4m_video(cfg.output, video)
    else:
        write_npy_video(cfg.output, video)
    print(f"decoded {len(frames)} frames -> {cfg.output}", file=sys.stderr)
    if cfg.trace:
        tracer.dump(cfg.trace)
        print(tracer.report(), file=sys.stderr)
    return 0


def _run_gui(cfg, decoder, stream, header, count) -> int:
    """Interactive display with live mouse gaze — the reference's GUI mode
    (libs/decoder.cpp:151-216). Requires OpenCV. The stream is already
    positioned at ``--start-frame``; ``count`` honors ``--max-frames``."""
    try:
        import cv2
    except ImportError:
        print("--show requires OpenCV (cv2)", file=sys.stderr)
        return 1

    window = "Decoded Video"
    cv2.namedWindow(window)
    mouse = {"x": 0, "y": 0}

    def on_mouse(event, x, y, flags, _param):
        if event == cv2.EVENT_MOUSEMOVE:
            mouse["x"], mouse["y"] = x, y

    cv2.setMouseCallback(window, on_mouse)

    def gaze_stream():
        for _ in range(count):
            yield (mouse["x"], mouse["y"])

    # main() already built a batch-1 decoder for GUI mode — use it as-is
    for frame in decoder.decode_frames(
        bitstream.read_frames(stream, header, count), gaze_stream()
    ):
        cv2.imshow(window, frame)
        if cv2.waitKey(1) >= 0:
            break
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
