"""Motion estimation tests: exact-semantics parity vs the sequential spec
model (tie-breaks, flat-region rule, cross-level MAD carry)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from svc_tpu.ops import motion
from svc_tpu.ops.pyramid import build_pyramid

from spec_models import (
    ebma_spec,
    global_exhaustive_spec,
    hbma_spec,
    refine_spec,
)


def _frame_pair(h, w, seed, shift=(0, 0), noise=6):
    """Natural-ish pair: smooth random field, anchor = shifted + noise."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2)).astype(np.float32)
    smooth = np.kron(big, np.ones((4, 4)))[:h, :w]
    tracked = np.clip(smooth + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    sy, sx = shift
    anchor = np.roll(tracked, (sy, sx), axis=(0, 1))
    anchor = np.clip(
        anchor.astype(np.int32) + rng.integers(-noise, noise + 1, (h, w)),
        0,
        255,
    ).astype(np.uint8)
    return tracked, anchor


class TestEbma:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_spec_random(self, seed):
        tracked, anchor = _frame_pair(24, 32, seed)
        mv, mm = motion.ebma(jnp.asarray(tracked), jnp.asarray(anchor), 3, 4, 4)
        mv_s, mm_s = ebma_spec(tracked, anchor, 3, 4, 4)
        np.testing.assert_array_equal(np.asarray(mv), mv_s)
        np.testing.assert_array_equal(np.asarray(mm), mm_s)

    def test_flat_region_resets_mv(self):
        # uniform frames: every candidate ties -> all MVs reset to zero
        tracked = np.full((16, 16), 128, np.uint8)
        anchor = np.full((16, 16), 128, np.uint8)
        mv, mm = motion.ebma(jnp.asarray(tracked), jnp.asarray(anchor), 2, 4, 4)
        np.testing.assert_array_equal(np.asarray(mv), 0.0)
        np.testing.assert_array_equal(np.asarray(mm), 0.0)

    def test_pure_translation_recovered(self):
        rng = np.random.default_rng(3)
        tracked = rng.integers(0, 256, (40, 40)).astype(np.uint8)
        # anchor is tracked shifted by (+2, +1): mv should be (x=1, y=2)
        anchor = np.zeros_like(tracked)
        anchor[2:, 1:] = tracked[:-2, :-1]
        mv, _ = motion.ebma(jnp.asarray(tracked), jnp.asarray(anchor), 4, 8, 8)
        inner = np.asarray(mv)[1:-1, 1:-1]
        np.testing.assert_array_equal(inner[..., 0], -1.0)
        np.testing.assert_array_equal(inner[..., 1], -2.0)


class TestRefine:
    @pytest.mark.parametrize("seed", [0, 4])
    def test_matches_spec_with_carry_in(self, seed):
        tracked, anchor = _frame_pair(32, 32, seed)
        # carry-in from a coarse EBMA at the same level (synthetic scenario)
        mv0, mm0 = ebma_spec(tracked, anchor, 2, 8, 8)
        mv, mm = motion.refine(
            jnp.asarray(tracked),
            jnp.asarray(anchor),
            2,
            8,
            8,
            jnp.asarray(mv0),
            jnp.asarray(mm0),
        )
        mv_s, mm_s = refine_spec(tracked, anchor, 2, 8, 8, mv0, mm0)
        np.testing.assert_array_equal(np.asarray(mv), mv_s)
        np.testing.assert_array_equal(np.asarray(mm), mm_s)

    def test_no_update_when_carry_in_is_better(self):
        tracked, anchor = _frame_pair(16, 16, 5)
        mv0 = np.zeros((2, 2, 2), np.float32)
        mm0 = np.zeros((2, 2), np.float32)  # unbeatable carry-in
        mv, mm = motion.refine(
            jnp.asarray(tracked), jnp.asarray(anchor), 1, 8, 8,
            jnp.asarray(mv0), jnp.asarray(mm0),
        )
        np.testing.assert_array_equal(np.asarray(mv), mv0)
        np.testing.assert_array_equal(np.asarray(mm), mm0)


    @pytest.mark.parametrize("block", [8, 16])
    @pytest.mark.parametrize("bound_in", [8, 14, 20])
    def test_spread_refine_matches_spec(self, bound_in, block):
        """The encoder's pyramid refinement (spread cells + even-shift
        window selection) at the window bounds a 4-level pyramid reaches
        (bound_in 14 at the base level takes the two-stage select)."""
        r = 1
        tracked, anchor = _frame_pair(64, 256, bound_in + block)
        mfh, mfw = 64 // block, 256 // block
        rng = np.random.default_rng(bound_in)
        # entering fields are doubled integer fields: even shifts
        mv0 = (
            rng.integers(-bound_in // 2, bound_in // 2 + 1, (mfh, mfw, 2))
            * 2
        ).astype(np.float32)
        mm0 = rng.uniform(0, 60, (mfh, mfw)).astype(np.float32)
        mv, mm = motion._refine_spread(
            jnp.asarray(tracked), jnp.asarray(anchor), r, block, block,
            jnp.asarray(mv0), jnp.asarray(mm0), bound_in=bound_in,
        )
        mv_s, mm_s = refine_spec(tracked, anchor, r, block, block, mv0, mm0)
        np.testing.assert_array_equal(np.asarray(mv), mv_s)
        np.testing.assert_array_equal(np.asarray(mm), mm_s)


class TestHbma:
    @pytest.mark.parametrize("levels,block,r", [(2, 8, 2), (3, 8, 4)])
    def test_matches_spec_through_pyramid(self, levels, block, r):
        tracked, anchor = _frame_pair(32, 48, 7, shift=(2, -1))
        t_pyr = [np.asarray(p) for p in build_pyramid(jnp.asarray(tracked), levels)]
        a_pyr = [np.asarray(p) for p in build_pyramid(jnp.asarray(anchor), levels)]
        mv, mm = motion.hbma(
            [jnp.asarray(p) for p in t_pyr],
            [jnp.asarray(p) for p in a_pyr],
            r,
            block,
            block,
        )
        mv_s, mm_s = hbma_spec(t_pyr, a_pyr, r, block, block)
        np.testing.assert_array_equal(np.asarray(mv), mv_s)
        np.testing.assert_array_equal(np.asarray(mm), mm_s)

    def test_default_codec_geometry(self):
        # 4 levels, 16x16 blocks, range 8 — the SSE2-pinned configuration
        # (libs/motion.cpp:691-749) on a small padded frame
        tracked, anchor = _frame_pair(64, 80, 8, shift=(3, 2))
        t_pyr = build_pyramid(jnp.asarray(tracked), 4)
        a_pyr = build_pyramid(jnp.asarray(anchor), 4)
        mv, mm = motion.hbma(t_pyr, a_pyr, 8, 16, 16)
        assert mv.shape == (4, 5, 2)
        t_np = [np.asarray(p) for p in t_pyr]
        a_np = [np.asarray(p) for p in a_pyr]
        mv_s, mm_s = hbma_spec(t_np, a_np, 8, 16, 16)
        np.testing.assert_array_equal(np.asarray(mv), mv_s)
        np.testing.assert_array_equal(np.asarray(mm), mm_s)

    def test_search_range_validation(self):
        t = jnp.zeros((16, 16), jnp.uint8)
        with pytest.raises(ValueError):
            motion.hbma([t, t, t], [t, t, t], 2, 8, 8)

    def test_block_divisibility_validation(self):
        # block 10 with 3 levels: the reference would truncate the top-level
        # block to 2 and corrupt its MV field; we reject
        t = jnp.zeros((40, 40), jnp.uint8)
        with pytest.raises(ValueError, match="divisible"):
            motion.hbma([t, t, t], [t, t, t], 8, 10, 10)

    def test_rectangular_blocks_match_spec(self):
        tracked, anchor = _frame_pair(32, 48, 12, shift=(1, 2))
        t_pyr = build_pyramid(jnp.asarray(tracked), 2)
        a_pyr = build_pyramid(jnp.asarray(anchor), 2)
        mv, mm = motion.hbma(t_pyr, a_pyr, 4, 16, 8)
        t_np = [np.asarray(p) for p in t_pyr]
        a_np = [np.asarray(p) for p in a_pyr]
        mv_s, mm_s = hbma_spec(t_np, a_np, 4, 16, 8)
        np.testing.assert_array_equal(np.asarray(mv), mv_s)
        np.testing.assert_array_equal(np.asarray(mm), mm_s)

    @pytest.mark.parametrize(
        "levels,block,r,h,w",
        [
            (4, 16, 8, 128, 256),  # default codec geometry, stack kernel
            (3, 8, 4, 96, 128),    # alternate geometry
            (2, 8, 2, 32, 48),     # small field: falls back to vmap path
        ],
    )
    def test_stack_matches_vmapped_hbma(self, levels, block, r, h, w):
        """hbma_stack (the encoder's stack-kernel motion path, where frame
        pairing lives in BlockSpec index maps) must be bit-identical to
        vmapping hbma over sliced tracked/anchor pyramids."""
        rng = np.random.default_rng(levels * 100 + block)
        T = 3
        stack = rng.integers(0, 256, (T + 1, h, w), dtype=np.uint8)
        for t in range(1, T + 1):
            stack[t, 8 : h // 2, 16 : w - 16] = stack[
                t - 1, 6 : h // 2 - 2, 13 : w - 19
            ]
        pyr = build_pyramid(jnp.asarray(stack), levels)
        mv_s, mm_s = motion.hbma_stack(list(pyr), r, block, block)
        mv_v, mm_v = jax.vmap(
            lambda tp, ap: motion.hbma(list(tp), list(ap), r, block, block)
        )(tuple(l[:-1] for l in pyr), tuple(l[1:] for l in pyr))
        np.testing.assert_array_equal(np.asarray(mv_s), np.asarray(mv_v))
        np.testing.assert_array_equal(np.asarray(mm_s), np.asarray(mm_v))

    def test_vmappable_over_frame_batch(self):
        tracked, anchor = _frame_pair(32, 32, 9)
        t = jnp.stack([jnp.asarray(tracked)] * 3)
        a = jnp.stack([jnp.asarray(anchor)] * 3)
        mv, mm = jax.vmap(
            lambda tt, aa: motion.ebma(tt, aa, 2, 8, 8)
        )(t, a)
        assert mv.shape == (3, 4, 4, 2)
        single, _ = motion.ebma(jnp.asarray(tracked), jnp.asarray(anchor), 2, 8, 8)
        np.testing.assert_array_equal(np.asarray(mv[1]), np.asarray(single))


class TestGlobalMotion:
    def test_avg(self):
        mvf = np.array([[[1.0, 2.0], [3.0, 4.0]]], np.float32)
        got = np.asarray(motion.estimate_global_motion_avg(jnp.asarray(mvf)))
        np.testing.assert_allclose(got, [2.0, 3.0])

    def test_exhaustive_matches_spec(self):
        tracked, anchor = _frame_pair(24, 24, 10, shift=(1, 2))
        gm, mm = motion.estimate_global_motion_exhaustive(
            jnp.asarray(tracked), jnp.asarray(anchor), 3
        )
        gm_s, mm_s = global_exhaustive_spec(tracked, anchor, 3)
        np.testing.assert_array_equal(np.asarray(gm), gm_s)
        np.testing.assert_allclose(np.asarray(mm), mm_s, rtol=1e-6)

    def test_hierarchical_runs(self):
        tracked, anchor = _frame_pair(32, 32, 11, shift=(2, 2))
        t_pyr = build_pyramid(jnp.asarray(tracked), 3)
        a_pyr = build_pyramid(jnp.asarray(anchor), 3)
        gm = motion.estimate_global_motion_hierarchical(t_pyr, a_pyr, 4)
        assert gm.shape == (2,)
