"""Golden parity vs the ACTUAL C++ reference implementation.

Builds a small harness linking the unmodified reference ``motion.cpp``
(a read-only checkout of the reference sources) and compares the JAX
framework's motion fields and min-MADs bit-for-bit — EBMA, generic
HBMA, the pinned
SSE2-flavor HBMA, and whole-frame global motion. HBMA has no RNG, so
exact float equality is required, which transitively validates the
OpenCV-exact pyramid, tie-break rules (Q8), the flat-region heuristic
(Q6), and cross-level MAD carry.

Skips when the native toolchain or the reference checkout is unavailable.
"""

import os
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

from svc_tpu.ops import motion
from svc_tpu.ops.pyramid import build_pyramid

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_HARNESS = os.path.join(_DIR, "harness")
_REF = "/root/reference"


def _build_harness():
    if os.path.exists(_HARNESS):
        return True
    if not os.path.isdir(_REF):
        return False
    try:
        cflags = subprocess.run(
            ["pkg-config", "--cflags", "opencv4"],
            capture_output=True, text=True, check=True,
        ).stdout.split()
        subprocess.run(
            ["g++", "-O2", "-std=c++17", f"-I{_REF}/libs",
             os.path.join(_DIR, "harness.cpp"), f"{_REF}/libs/motion.cpp"]
            + cflags
            + ["-lopencv_core", "-lopencv_imgproc", "-o", _HARNESS],
            check=True, capture_output=True, timeout=180,
        )
        return True
    except Exception:
        return False


pytestmark = pytest.mark.skipif(
    not _build_harness(), reason="reference harness unavailable"
)


def _run_harness(mode, tracked, anchor, levels, rng, bw, bh):
    h, w = tracked.shape
    proc = subprocess.run(
        [_HARNESS, mode, str(w), str(h), str(levels), str(rng), str(bw),
         str(bh)],
        input=tracked.tobytes() + anchor.tobytes(),
        capture_output=True, check=True,
    )
    out = np.frombuffer(proc.stdout, np.float32)
    if mode == "gme":
        return out[:2], out[2]
    n = (h // bh) * (w // bw)
    mv = out[: 2 * n].reshape(h // bh, w // bw, 2)
    mad = out[2 * n :].reshape(h // bh, w // bw)
    return mv, mad


def _planes(h, w, seed, shift=(2, 1)):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 4 + 4, w // 4 + 4)).astype(np.float32)
    smooth = np.kron(coarse, np.ones((4, 4)))
    tracked = np.clip(
        smooth[:h, :w] + rng.normal(0, 3, (h, w)), 0, 255
    ).astype(np.uint8)
    anchor = np.clip(
        smooth[shift[0] : shift[0] + h, shift[1] : shift[1] + w]
        + rng.normal(0, 3, (h, w)),
        0, 255,
    ).astype(np.uint8)
    return tracked, anchor


class TestGoldenMotionParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_ebma_bit_exact(self, seed):
        tracked, anchor = _planes(32, 48, seed)
        ref_mv, ref_mad = _run_harness("ebma", tracked, anchor, 1, 4, 8, 8)
        mv, mad = motion.ebma(jnp.asarray(tracked), jnp.asarray(anchor), 4, 8, 8)
        np.testing.assert_array_equal(np.asarray(mv), ref_mv)
        np.testing.assert_array_equal(np.asarray(mad), ref_mad)

    @pytest.mark.parametrize("seed,levels,rng,blk", [
        (0, 3, 4, 8),
        (1, 2, 2, 8),
        (3, 3, 8, 16),
    ])
    def test_hbma_generic_bit_exact(self, seed, levels, rng, blk):
        tracked, anchor = _planes(64, 96, seed)
        ref_mv, ref_mad = _run_harness(
            "hbma", tracked, anchor, levels, rng, blk, blk
        )
        tp = build_pyramid(jnp.asarray(tracked), levels)
        ap = build_pyramid(jnp.asarray(anchor), levels)
        mv, mad = motion.hbma(tp, ap, rng, blk, blk)
        np.testing.assert_array_equal(np.asarray(mv), ref_mv)
        np.testing.assert_array_equal(np.asarray(mad), ref_mad)

    @pytest.mark.parametrize("seed", [0, 4])
    def test_hbma_sse2_flavor_bit_exact(self, seed):
        # the reference's production path: 4 levels, 16x16 blocks, SSE2 MAD
        # kernels (libs/motion.cpp:691-749); our single hbma path must
        # match it exactly too
        tracked, anchor = _planes(128, 160, seed, shift=(3, 5))
        ref_mv, ref_mad = _run_harness(
            "hbma16", tracked, anchor, 4, 8, 16, 16
        )
        tp = build_pyramid(jnp.asarray(tracked), 4)
        ap = build_pyramid(jnp.asarray(anchor), 4)
        mv, mad = motion.hbma(tp, ap, 8, 16, 16)
        np.testing.assert_array_equal(np.asarray(mv), ref_mv)
        np.testing.assert_array_equal(np.asarray(mad), ref_mad)

    def test_global_motion_exhaustive_zero_range_bit_exact(self):
        # r=0 is the only range the reference actually executes (quirk E9:
        # its signed/unsigned loop bound makes r>=1 a no-op)
        tracked, anchor = _planes(24, 32, 5, shift=(1, 2))
        ref_gm, ref_mad = _run_harness("gme", tracked, anchor, 1, 0, 1, 1)
        gm, mad = motion.estimate_global_motion_exhaustive(
            jnp.asarray(tracked), jnp.asarray(anchor), 0
        )
        np.testing.assert_array_equal(np.asarray(gm), ref_gm)
        np.testing.assert_array_equal(np.float32(mad), ref_mad)

    def test_global_motion_reference_bug_documented(self):
        # quirk E9: the reference's r>=1 loops never execute (signed index
        # vs unsigned bound); ours performs the documented search and
        # recovers the planted (x=2, y=1) shift
        tracked, anchor = _planes(24, 32, 5, shift=(1, 2))
        ref_gm, ref_mad = _run_harness("gme", tracked, anchor, 1, 3, 1, 1)
        np.testing.assert_array_equal(ref_gm, [0.0, 0.0])
        assert ref_mad == np.float32(np.finfo(np.float32).max)
        gm, _ = motion.estimate_global_motion_exhaustive(
            jnp.asarray(tracked), jnp.asarray(anchor), 3
        )
        np.testing.assert_array_equal(np.asarray(gm), [2.0, 1.0])

    def test_flat_region_golden(self):
        # uniform planes exercise the zero-MV reset (Q6) against the
        # reference implementation itself
        tracked = np.full((32, 32), 77, np.uint8)
        anchor = np.full((32, 32), 77, np.uint8)
        ref_mv, ref_mad = _run_harness("ebma", tracked, anchor, 1, 3, 8, 8)
        mv, mad = motion.ebma(jnp.asarray(tracked), jnp.asarray(anchor), 3, 8, 8)
        np.testing.assert_array_equal(np.asarray(mv), ref_mv)
        np.testing.assert_array_equal(np.asarray(mad), ref_mad)
