"""Quality/throughput metrics harness.

The reference computes no metrics anywhere (SURVEY.md §5); PSNR and
bitrate measurement are new harness code and the framework's north-star
quality gauges (BASELINE.md).
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two frames/videos."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def bitrate_bits_per_pixel(byte_count: int, frame_w: int, frame_h: int,
                           frame_count: int) -> float:
    """Raw wire bits per source pixel."""
    return 8.0 * byte_count / (frame_w * frame_h * max(frame_count, 1))
