"""Tests for morphology, k-means, and connected components."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from svc_tpu.ops import morphology
from svc_tpu.ops.ccl import connected_components
from svc_tpu.ops.kmeans import kmeans

cv2 = pytest.importorskip("cv2")


def _rand_mask(h, w, p=0.4, seed=0):
    return np.random.default_rng(seed).random((h, w)) < p


class TestMorphology:
    @pytest.mark.parametrize("kw,kh", [(3, 3), (3, 5), (5, 3)])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_close_open_matches_opencv(self, kw, kh, seed):
        mask = _rand_mask(17, 23, seed=seed)
        u8 = mask.astype(np.uint8) * 255
        se = cv2.getStructuringElement(cv2.MORPH_RECT, (kw, kh))
        ref = cv2.morphologyEx(u8, cv2.MORPH_CLOSE, se)
        ref = cv2.morphologyEx(ref, cv2.MORPH_OPEN, se)
        got = morphology.close_then_open(jnp.asarray(mask), kw, kh)
        np.testing.assert_array_equal(
            np.asarray(got), ref.astype(bool)
        )

    def test_dilate_erode_match_opencv(self):
        mask = _rand_mask(12, 15, seed=2)
        u8 = mask.astype(np.uint8) * 255
        se = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
        np.testing.assert_array_equal(
            np.asarray(morphology.dilate(jnp.asarray(mask), 3, 3)),
            cv2.dilate(u8, se).astype(bool),
        )
        np.testing.assert_array_equal(
            np.asarray(morphology.erode(jnp.asarray(mask), 3, 3)),
            cv2.erode(u8, se).astype(bool),
        )

    def test_batched(self):
        masks = np.stack([_rand_mask(8, 8, seed=s) for s in range(3)])
        got = np.asarray(morphology.close(jnp.asarray(masks), 3, 3))
        for i in range(3):
            single = np.asarray(morphology.close(jnp.asarray(masks[i]), 3, 3))
            np.testing.assert_array_equal(got[i], single)


class TestConnectedComponents:
    @pytest.mark.parametrize("connectivity", [4, 8])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_opencv(self, connectivity, seed):
        mask = _rand_mask(15, 20, p=0.45, seed=seed)
        labels, count = connected_components(jnp.asarray(mask), connectivity)
        labels = np.asarray(labels)
        ref_count, ref_labels = cv2.connectedComponents(
            mask.astype(np.uint8) * 255, connectivity=connectivity
        )
        assert int(count) == ref_count
        if connectivity == 4:
            # OpenCV's 4-way SAUF numbers components in raster order of
            # first pixel — identical to our canonical numbering
            np.testing.assert_array_equal(labels, ref_labels)
        else:
            # 8-way BBDT numbering is block-order; require identical
            # partitions (bijection between label sets)
            assert labels.shape == ref_labels.shape
            pairs = {(int(a), int(b)) for a, b in
                     zip(labels.ravel(), ref_labels.ravel())}
            assert len(pairs) == ref_count
            assert len({a for a, _ in pairs}) == ref_count
            assert len({b for _, b in pairs}) == ref_count

    def test_empty_mask(self):
        labels, count = connected_components(jnp.zeros((4, 6), bool), 4)
        assert int(count) == 1  # background only, like cv2
        np.testing.assert_array_equal(np.asarray(labels), 0)

    def test_full_mask_single_component(self):
        labels, count = connected_components(jnp.ones((4, 6), bool), 4)
        assert int(count) == 2
        np.testing.assert_array_equal(np.asarray(labels), 1)

    def test_diagonal_distinguishes_connectivity(self):
        mask = jnp.asarray(np.eye(5, dtype=bool))
        _, c4 = connected_components(mask, 4)
        _, c8 = connected_components(mask, 8)
        assert int(c4) == 6  # five isolated cells + background
        assert int(c8) == 2  # one diagonal chain + background

    def test_invalid_connectivity(self):
        with pytest.raises(ValueError):
            connected_components(jnp.zeros((2, 2), bool), 6)

    def test_adversarial_spiral(self):
        # a single snaking component whose path length far exceeds the
        # sweep budget — exercises the pointer-jumping straggler phase
        h, w = 24, 40
        mask = np.zeros((h, w), bool)
        for row in range(0, h, 2):
            mask[row, :] = True
            if row + 1 < h:
                mask[row + 1, w - 1 if (row // 2) % 2 == 0 else 0] = True
        labels, count = connected_components(jnp.asarray(mask), 4)
        assert int(count) == 2  # one long snake + background
        labs = np.asarray(labels)
        assert set(np.unique(labs[mask])) == {1}
        assert (labs[~mask] == 0).all()


class TestKMeans:
    def test_recovers_separated_clusters(self):
        rng = np.random.default_rng(0)
        c0 = rng.normal((0, 0, 0, 0), 0.3, (40, 4))
        c1 = rng.normal((20, 0, 0, 0), 0.3, (40, 4))
        c2 = rng.normal((0, 20, 20, 0), 0.3, (40, 4))
        x = np.concatenate([c0, c1, c2]).astype(np.float32)
        mask = np.ones(120, bool)
        labels, centers, compact = kmeans(
            jnp.asarray(x), jnp.asarray(mask), 3, jax.random.key(0)
        )
        labels = np.asarray(labels)
        # each ground-truth group maps to exactly one cluster id
        groups = [labels[:40], labels[40:80], labels[80:]]
        ids = [np.unique(g) for g in groups]
        assert all(len(i) == 1 for i in ids)
        assert len({int(i[0]) for i in ids}) == 3
        assert float(compact) < 120 * 4 * 0.5

    def test_frames_batched_matches_per_frame(self):
        """kmeans_t_frames (the encoder's frame-batched entry) must equal
        a per-frame vmap of kmeans_t — labels, centers, compactness."""
        from svc_tpu.ops.kmeans import kmeans_t, kmeans_t_frames

        rng = np.random.default_rng(4)
        f, d, n, k = 3, 4, 192, 5
        feats = rng.integers(-8, 9, (f, d, n)).astype(np.float32)
        mask = rng.random((f, n)) < 0.4
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(3), jnp.arange(f)
        )
        lab_b, cen_b, cmp_b = kmeans_t_frames(
            jnp.asarray(feats), jnp.asarray(mask), k, keys
        )
        lab_p, cen_p, cmp_p = jax.vmap(
            lambda ft, mk, kk: kmeans_t(ft, mk, k, kk)
        )(jnp.asarray(feats), jnp.asarray(mask), keys)
        np.testing.assert_array_equal(np.asarray(lab_b), np.asarray(lab_p))
        np.testing.assert_allclose(
            np.asarray(cmp_b), np.asarray(cmp_p), rtol=1e-6
        )

    @pytest.mark.parametrize(
        "f,repair",
        [(2, "global_farthest"), (4, "global_farthest"), (3, "opencv_split")],
    )
    def test_frames_batched_matches_per_frame_calls(self, f, repair):
        """kmeans_t_frames over a frame stack equals one kmeans_t call per
        frame, bit for bit, under both empty-cluster repair rules."""
        from svc_tpu.ops.kmeans import kmeans_t, kmeans_t_frames

        rng = np.random.default_rng(11 + f)
        d, n, k = 4, 256, 5
        feats = rng.integers(-8, 9, (f, d, n)).astype(np.float32)
        mask = rng.random((f, n)) < 0.5
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(9), jnp.arange(f)
        )
        lab_b, cen_b, cmp_b = kmeans_t_frames(
            jnp.asarray(feats), jnp.asarray(mask), k, keys, repair=repair
        )
        for fi in range(f):
            lab_1, cen_1, cmp_1 = kmeans_t(
                jnp.asarray(feats[fi]), jnp.asarray(mask[fi]), k, keys[fi],
                repair=repair,
            )
            np.testing.assert_array_equal(
                np.asarray(lab_b[fi]), np.asarray(lab_1)
            )
            np.testing.assert_array_equal(
                np.asarray(cen_b[fi]), np.asarray(cen_1)
            )
            np.testing.assert_array_equal(
                np.asarray(cmp_b[fi]), np.asarray(cmp_1)
            )

    def test_frames_batched_remainder_group(self):
        """An odd frame count still matches the vmapped per-frame path."""
        from svc_tpu.ops.kmeans import kmeans_t, kmeans_t_frames

        rng = np.random.default_rng(13)
        f, d, n, k = 5, 4, 192, 4  # prime-ish frame count
        feats = rng.integers(-8, 9, (f, d, n)).astype(np.float32)
        mask = rng.random((f, n)) < 0.4
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(17), jnp.arange(f)
        )
        lab_b, _, cmp_b = kmeans_t_frames(
            jnp.asarray(feats), jnp.asarray(mask), k, keys
        )
        lab_p, _, cmp_p = jax.vmap(
            lambda ft, mk, kk: kmeans_t(ft, mk, k, kk)
        )(jnp.asarray(feats), jnp.asarray(mask), keys)
        np.testing.assert_array_equal(np.asarray(lab_b), np.asarray(lab_p))
        np.testing.assert_allclose(
            np.asarray(cmp_b), np.asarray(cmp_p), rtol=1e-6
        )

    def test_masked_points_excluded(self):
        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, (50, 4)).astype(np.float32)
        x[40:] += 1000  # invalid rows far away
        mask = np.ones(50, bool)
        mask[40:] = False
        labels, centers, _ = kmeans(
            jnp.asarray(x), jnp.asarray(mask), 2, jax.random.key(0)
        )
        labels = np.asarray(labels)
        assert (labels[40:] == -1).all()
        assert np.abs(np.asarray(centers)).max() < 10

    def test_deterministic_under_key(self):
        rng = np.random.default_rng(2)
        x = rng.normal(0, 1, (60, 4)).astype(np.float32)
        mask = np.ones(60, bool)
        a = kmeans(jnp.asarray(x), jnp.asarray(mask), 4, jax.random.key(3))
        b = kmeans(jnp.asarray(x), jnp.asarray(mask), 4, jax.random.key(3))
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))

    def test_fewer_points_than_clusters(self):
        x = np.zeros((10, 4), np.float32)
        x[0] = (1, 0, 0, 0)
        x[1] = (0, 1, 0, 0)
        mask = np.zeros(10, bool)
        mask[:2] = True
        labels, _, _ = kmeans(
            jnp.asarray(x), jnp.asarray(mask), 5, jax.random.key(0)
        )
        labels = np.asarray(labels)
        assert (labels[2:] == -1).all()
        assert set(labels[:2]) <= set(range(5))

    def test_compactness_comparable_to_opencv(self):
        rng = np.random.default_rng(4)
        x = rng.normal(0, 5, (200, 4)).astype(np.float32)
        mask = np.ones(200, bool)
        _, _, compact = kmeans(
            jnp.asarray(x), jnp.asarray(mask), 8, jax.random.key(0),
            attempts=3, max_iter=10, epsilon=1.0,
        )
        crit = (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 10, 1.0)
        ref_compact, _, _ = cv2.kmeans(
            x, 8, None, crit, 3, cv2.KMEANS_PP_CENTERS
        )
        # same ballpark as OpenCV's result (RNGs differ; quirk Q7)
        assert float(compact) < ref_compact * 1.3


class TestBlockTypesFromClusters:
    """The fused per-cluster CCL + offset op must equal the composition the
    encoder previously ran: per-cluster connected_components_batched, ids +
    running offsets (reference loop libs/encoder.cpp:597-623)."""

    @pytest.mark.parametrize("connectivity", [4, 8])
    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_matches_per_cluster_composition(self, connectivity, seed):
        from svc_tpu.ops.ccl import (
            block_types_from_clusters,
            connected_components_batched,
        )

        rng = np.random.default_rng(seed)
        k, b, h, w = 5, 3, 12, 17
        # cluster image: ~half background (-1), rest in [0, k)
        cl = rng.integers(-1, k, (b, h, w)).astype(np.int32)
        cl = np.where(rng.random((b, h, w)) < 0.4, -1, cl)

        btypes, counts = block_types_from_clusters(
            jnp.asarray(cl), k, connectivity
        )
        btypes, counts = np.asarray(btypes), np.asarray(counts)

        for i in range(b):
            masks = np.stack([cl[i] == c for c in range(k)])
            ids, cnts = connected_components_batched(
                jnp.asarray(masks), connectivity
            )
            ids, cnts = np.asarray(ids), np.asarray(cnts)
            offsets = np.concatenate([[0], np.cumsum(cnts)[:-1]])
            expect = np.sum(
                np.where(ids > 0, ids + offsets[:, None, None], 0), axis=0
            )
            np.testing.assert_array_equal(btypes[i], expect)
            np.testing.assert_array_equal(counts[i], cnts)

    def test_all_background(self):
        from svc_tpu.ops.ccl import block_types_from_clusters

        cl = jnp.full((2, 6, 6), -1, jnp.int32)
        btypes, counts = block_types_from_clusters(cl, 3, 4)
        assert not np.asarray(btypes).any()
        np.testing.assert_array_equal(np.asarray(counts), 1)

    def test_empty_cluster_contributes_plus_one_to_offset(self):
        """The documented k-clamp divergence (models/encoder.py docstring):
        an empty cluster advances the running block-type offset by exactly
        1 — the label count ``cv::connectedComponents`` returns on an
        all-zero mask (just the background label; the reference adds that
        count to the offset, libs/encoder.cpp:621)."""
        from svc_tpu.ops.ccl import block_types_from_clusters

        # k=4: clusters 0 and 2 each hold one region; 1 and 3 are empty
        cl = np.full((1, 6, 8), -1, np.int32)
        cl[0, 1:3, 1:3] = 0
        cl[0, 4:6, 5:7] = 2
        btypes, counts = block_types_from_clusters(jnp.asarray(cl), 4, 4)
        btypes, counts = np.asarray(btypes[0]), np.asarray(counts[0])
        # cluster 0 -> id 1, count 2; empty cluster 1 -> count 1 (offset
        # 2 -> 3); cluster 2 -> id 1 + 3 = 4; empty cluster 3 -> count 1
        np.testing.assert_array_equal(counts, [2, 1, 2, 1])
        assert set(btypes[cl[0] == 0].tolist()) == {1}
        assert set(btypes[cl[0] == 2].tolist()) == {4}
        assert not btypes[cl[0] < 0].any()
