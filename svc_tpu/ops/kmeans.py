"""K-means clustering of foreground motion features, on-device.

Replaces the encoder's ``cv::kmeans(features, k, ..., attempts,
KMEANS_PP_CENTERS)`` call (reference: libs/encoder.cpp:557-578) with a
jitted, static-shape implementation:

* k-means++ (D^2-weighted) seeding via inverse-CDF sampling under an
  explicit PRNG key,
* Lloyd iterations as one-hot matmuls (assignment + update),
* OpenCV's termination rule — stop when the squared center shift drops to
  ``epsilon**2`` or ``max_iter`` is reached (TermCriteria COUNT|EPS,
  libs/encoder.cpp:572-575) — realized as a fixed-trip loop with frozen
  updates after convergence (static shapes for jit),
* empty-cluster repair, two rules: the production default re-seeds an
  empty cluster to the globally farthest point from its assigned center
  (one masked argmax, no per-cluster passes; divergence from OpenCV
  compactness-bounded in tests); ``repair="opencv_split"``
  replicates cv::kmeans exactly — the empty cluster takes the farthest
  member of the biggest cluster (used under ``reference_compat``),
* multiple attempts scored by compactness (sum of squared distances), best
  attempt returned — matching the ``attempts`` semantics.

Validity masking: the number of foreground blocks is data-dependent, but
shapes under jit must be static, so the feature array always has mv-field
size and a boolean mask marks real points. Invalid points get label -1.

Determinism: the reference inherits OpenCV's RNG (quirk Q7); here seeding
takes an explicit PRNG key.

Layout: every per-point tensor keeps the POINT axis minor — features
live as ``(D, N)``, labels/distances as ``(N,)``, the assignment one-hot
as ``(k, N)`` — so Lloyd never transposes. The centers update is one
``(D,N)x(k,N) -> (D,k)`` dot_general over the N axis (HIGHEST precision:
exact for the integer-valued motion features).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_BIG = 1e30


def _plus_plus_init(
    key: jnp.ndarray, xt: jnp.ndarray, mask: jnp.ndarray, k: int
) -> jnp.ndarray:
    """k-means++ seeding: D^2-weighted sampling over valid points.

    ``xt`` is ``(D, N)`` (points minor); returns centers ``(k, D)``.

    Sampling is Gumbel-max: with per-point gumbels ``g``,
    ``argmax(log w + g)`` is an exact draw from the categorical
    distribution proportional to ``w``. All ``(k, N)`` gumbels are
    generated in one pass up front, so each of the k sequential picks is
    a single elementwise compare/argmax pass with no per-pick cumsum. The
    unrolled static-k loop also avoids a while op. RNG stream choice
    is already a documented divergence from OpenCV (quirk Q7).
    """
    n = xt.shape[1]
    # gumbels in (k, N): points minor, like every per-point tensor
    u = jax.random.uniform(
        key, (k, n), dtype=jnp.float32, minval=1e-12, maxval=1.0
    )
    gumbels = -jnp.log(-jnp.log(u))
    maskf = mask.astype(xt.dtype)
    neg = jnp.float32(-_BIG)

    def pick(w, g):
        # argmax(log w + g) over valid (w > 0) points; exact Gumbel-max
        # categorical draw proportional to w
        score = jnp.where(w > 0, jnp.log(w) + g, neg)
        return jnp.argmax(score).astype(jnp.int32)

    idx0 = pick(maskf, gumbels[0])
    centers = [jax.lax.dynamic_slice_in_dim(xt, idx0, 1, axis=1)[:, 0]]
    d2 = jnp.full((n,), _BIG, xt.dtype)
    for i in range(1, k):
        d2 = jnp.minimum(
            d2, jnp.sum((xt - centers[i - 1][:, None]) ** 2, axis=0)
        )
        w = jnp.where(mask, d2, 0.0)
        # if all residual weights vanish (fewer distinct points than k),
        # fall back to uniform over valid points
        w = jnp.where(jnp.sum(w) > 0, w, maskf)
        idx = pick(w, gumbels[i])
        centers.append(
            jax.lax.dynamic_slice_in_dim(xt, idx, 1, axis=1)[:, 0]
        )
    return jnp.stack(centers)


def _assign(xt: jnp.ndarray, centers: jnp.ndarray, mask: jnp.ndarray):
    """First-wins argmin assignment over the k axis.

    One fused ``(k, N)`` distance tensor and an argmin over its leading
    axis; ``jnp.argmin`` breaks ties toward the lowest index =
    OpenCV's first-wins update rule.
    """
    d2 = jnp.sum(
        (xt[:, None, :] - centers.T[:, :, None]) ** 2, axis=0
    )  # (k, N)
    labels = jnp.argmin(d2, axis=0).astype(jnp.int32)
    point_d2 = jnp.min(d2, axis=0)
    point_d2 = jnp.where(mask, jnp.maximum(point_d2, 0.0), 0.0)
    return labels, point_d2


def _opencv_split_repair(xt, mask, labels, sums, counts, k):
    """OpenCV's empty-cluster repair (cv::kmeans, core/src/kmeans.cpp):
    each empty cluster — in cluster-index order — takes the farthest
    member (squared L2 to the center, LAST-wins tie like cv's
    ``max_dist <= dist``) of the biggest cluster (by count, FIRST-wins
    tie like cv's strict ``<`` compare), with labels/sums/counts updated
    before the next empty cluster is processed.

    ``sums`` is ``(k, D)`` raw per-cluster feature sums, ``counts``
    ``(k,)``. Returns the adjusted ``(labels, sums, counts)``.
    """
    n = xt.shape[1]
    lanes = jnp.arange(n, dtype=jnp.int32)

    def fix_one(kk, carry):
        labels, sums, counts = carry

        def do(carry):
            labels, sums, counts = carry
            max_k = jnp.argmax(counts).astype(jnp.int32)
            # cv normalizes by RECIPROCAL-MULTIPLY (scale = 1.f/count;
            # center[j] * scale), which can differ from a divide in the
            # last ulp — replicate for exactness
            center = jnp.take(sums, max_k, axis=0) * (
                1.0 / jnp.maximum(jnp.take(counts, max_k), 1.0)
            )  # (D,)
            d2 = jnp.sum((xt - center[:, None]) ** 2, axis=0)
            memb = (labels == max_k) & mask
            d2 = jnp.where(memb, d2, -1.0)
            mx = jnp.max(d2)
            # last index achieving the max (cv: max_dist <= dist)
            far = jnp.max(jnp.where(d2 >= mx, lanes, -1))
            point = jnp.take(xt, far, axis=1)  # (D,)
            labels = labels.at[far].set(kk)
            sums = sums.at[kk].add(point).at[max_k].add(-point)
            counts = counts.at[kk].add(1.0).at[max_k].add(-1.0)
            return labels, sums, counts

        return jax.lax.cond(
            jnp.take(counts, kk) == 0.0,
            do,
            lambda c: c,
            (labels, sums, counts),
        )

    return jax.lax.fori_loop(0, k, fix_one, (labels, sums, counts))


def _lloyd_attempt(
    key: jnp.ndarray,
    xt: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    max_iter: int,
    epsilon: float,
    repair: str = "global_farthest",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    centers = _plus_plus_init(key, xt, mask, k)
    maskf = mask.astype(xt.dtype)

    def iteration(carry, _):
        centers, done = carry
        labels, point_d2 = _assign(xt, centers, mask)
        # (k, N) one-hot, points minor
        onehot_t = (
            labels[None, :] == jnp.arange(k, dtype=jnp.int32)[:, None]
        ).astype(xt.dtype) * maskf[None, :]
        counts = jnp.sum(onehot_t, axis=1)
        # centers update: one (D,N)x(k,N) -> (D,k) contraction over N;
        # HIGHEST keeps f32 operands un-truncated (a default-precision f32
        # dot may run on bf16 or TF32 operands — still exact for small
        # integer motion features, but the op is tiny so pay for
        # generality)
        sums = jax.lax.dot_general(
            xt,
            onehot_t,
            (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        ).T

        if repair == "opencv_split":
            # OpenCV's split-the-biggest-cluster rule, for
            # reference-compat parity (see _opencv_split_repair)
            _, sums, counts = _opencv_split_repair(
                xt, mask, labels, sums, counts, k
            )
            # cv::kmeans normalizes by reciprocal-multiply (scale =
            # 1.f/count; center *= scale), not a divide — match it here
            # too so the whole center chain is bit-identical
            new_centers = (
                sums * (1.0 / jnp.maximum(counts, 1.0))[:, None]
            )
            shift2 = jnp.max(jnp.sum((new_centers - centers) ** 2, axis=-1))
            new_done = done | (shift2 <= epsilon**2)
            centers = jnp.where(done, centers, new_centers)
            return (centers, new_done), None

        new_centers = sums / jnp.maximum(counts, 1.0)[:, None]

        # production empty-cluster repair: the j-th empty cluster (by
        # index) moves onto the j-th farthest valid point (globally);
        # empties are rare, so the masked argmax loop runs a
        # data-dependent n_empty times — usually ZERO (a batched while
        # whose condition is already false), instead of a fixed k passes
        # every Lloyd iteration (lax.top_k is worse still: it lowers to a
        # full sort). Divergence from OpenCV's rule is deliberate (the
        # global pick needs no per-cluster distance passes) and
        # compactness-bounded (test_segmentation_ops.py); exact-rule
        # parity is available via repair="opencv_split".
        empty = counts == 0
        n_empty = jnp.sum(empty.astype(jnp.int32))

        def take_far(i, carry):
            far_idx, d2left = carry
            far = jnp.argmax(d2left)
            far_idx = far_idx.at[i].set(far)
            d2left = jnp.where(
                jnp.arange(d2left.shape[0]) == far, -1.0, d2left
            )
            return far_idx, d2left

        far_idx, _ = jax.lax.fori_loop(
            0,
            n_empty,
            take_far,
            (jnp.zeros((k,), jnp.int32), jnp.where(mask, point_d2, -1.0)),
        )
        empty_rank = jnp.cumsum(empty.astype(jnp.int32)) - 1
        reseed = jnp.take(
            xt, far_idx[jnp.clip(empty_rank, 0, k - 1)], axis=1
        ).T
        new_centers = jnp.where(empty[:, None], reseed, new_centers)

        shift2 = jnp.max(jnp.sum((new_centers - centers) ** 2, axis=-1))
        new_done = done | (shift2 <= epsilon**2)
        centers = jnp.where(done, centers, new_centers)
        return (centers, new_done), None

    def loop_cond(state):
        (_, done), it = state
        return (~done) & (it < max_iter)

    def loop_body(state):
        carry, it = state
        carry, _ = iteration(carry, None)
        return carry, it + 1

    (centers, _), _ = jax.lax.while_loop(
        loop_cond, loop_body, ((centers, jnp.bool_(False)), jnp.int32(0))
    )
    labels, point_d2 = _assign(xt, centers, mask)
    compactness = jnp.sum(point_d2)
    return labels, centers, compactness


@functools.partial(
    jax.jit,
    static_argnames=("k", "attempts", "max_iter", "epsilon", "repair"),
)
def kmeans_t(
    features_t: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    key: jnp.ndarray,
    attempts: int = 3,
    max_iter: int = 10,
    epsilon: float = 1.0,
    repair: str = "global_farthest",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Cluster valid feature columns of ``(D, N)`` features into ``k``
    groups — the transpose-free entry point (callers that can build
    features dimension-major avoid a device transpose per call).

    Args:
      features_t: ``(D, N)`` float32, points on the minor axis.
      mask: ``(N,)`` bool validity (foreground blocks).
      k: cluster count (static; the caller mirrors the reference's
        ``min(cluster_count, fg_count)`` clamp, libs/encoder.cpp:557-559).

    Returns:
      ``(labels, centers, compactness)`` — labels ``(N,)`` int32 in
      ``[0, k)`` for valid rows and -1 elsewhere.
    """
    keys = jax.random.split(key, attempts)
    labels_a, centers_a, compact_a = jax.vmap(
        lambda kk: _lloyd_attempt(
            kk, features_t, mask, k, max_iter, float(epsilon),
            repair=repair,
        )
    )(keys)
    best = jnp.argmin(compact_a)
    labels = jnp.where(mask, labels_a[best], -1)
    return labels.astype(jnp.int32), centers_a[best], compact_a[best]


@functools.partial(
    jax.jit,
    static_argnames=("k", "attempts", "max_iter", "epsilon", "repair"),
)
def kmeans_t_frames(
    features_t: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    keys: jnp.ndarray,
    attempts: int = 3,
    max_iter: int = 10,
    epsilon: float = 1.0,
    repair: str = "global_farthest",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Frame-batched :func:`kmeans_t`: cluster every frame of an encode
    batch in one call.

    Args:
      features_t: ``(F, D, N)`` float32, one feature set per frame.
      mask: ``(F, N)`` bool validity.
      keys: ``(F,)`` PRNG keys (the per-frame streams are split exactly
        as ``kmeans_t`` splits them, so seeds — and hence results — match
        the per-frame path bit for bit).

    Returns ``(labels (F, N), centers (F, k, D), compactness (F,))``.
    """
    return jax.vmap(
        lambda ft, mk, kk: kmeans_t(
            ft, mk, k, kk,
            attempts=attempts, max_iter=max_iter, epsilon=epsilon,
            repair=repair,
        )
    )(features_t, mask, keys)


def kmeans(
    features: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    key: jnp.ndarray,
    attempts: int = 3,
    max_iter: int = 10,
    epsilon: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Cluster valid feature rows of ``(N, D)`` features into ``k`` groups
    (row-major convenience wrapper over :func:`kmeans_t`)."""
    return kmeans_t(
        features.T, mask, k, key,
        attempts=attempts, max_iter=max_iter, epsilon=epsilon,
    )
