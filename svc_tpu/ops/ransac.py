"""RANSAC global-motion estimation as parallel hypothesis scoring.

Data-parallel rebuild of ``EstimateGlobalMotionRansac``
(reference: libs/motion.cpp:144-266): instead of a sequential loop drawing
one random subset per iteration, all ``k`` hypotheses are sampled up front
under an explicit PRNG key and scored against the whole motion field in one
broadcast — the inlier test for every (hypothesis, vector) pair is a single
(k, N) elementwise computation.

Semantics preserved:

* iteration count ``k = ceil(log(1-p) / log(1 - w**n))`` in float32
  (libs/motion.cpp:144-149),
* hypothesis model = mean MV of an ``n``-subset of distinct indices
  (libs/motion.cpp:151-163, 211-222),
* inlier iff squared error < thresh**2 (libs/motion.cpp:228),
* later hypotheses win count ties (the ``>=`` keep rule,
  libs/motion.cpp:233-237),
* final refit: mean + RMSE over the best hypothesis's inliers
  (libs/motion.cpp:243-262).

Deliberate divergences (documented quirks):

* Q7 — the reference seeds from ``std::random_device`` (nondeterministic);
  here sampling takes an explicit ``jax.random`` key.
* E2 — the reference samples indices from an inclusive ``[0, N]`` range and
  can read out of bounds (libs/motion.cpp:208); we sample ``[0, N-1]``.
* E3 — when fewer inliers than ``subset_sz`` are found the reference
  computes RMSE against an *uninitialized* output (libs/motion.cpp:240-242);
  we compute it against the best hypothesis instead.
* Degenerate parameters that would make ``k`` unbounded (w<=0 or p>=1) are
  clamped to ``max_hypotheses``.

Returns a boolean inlier *mask* instead of an index vector — static-shape,
and exactly what the encoder needs to build the foreground mask
(libs/encoder.cpp:507-513).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svc_tpu.config import RansacParams


#: Budget for the (k, N) hypothesis-scoring tensors. Degenerate-but-legal
#: parameters (validation only requires w >= 0; e.g. w -> 0 with p -> 1)
#: can demand millions of hypotheses; without a field-size-aware cap the
#: broadcast scorer would allocate a (k, N) float32 err2 tensor of
#: gigabytes (the reference just loops longer, libs/motion.cpp:210).
_HYPOTHESIS_MEM_BUDGET = 64 << 20


def hypothesis_cap(
    n_points: int, budget_bytes: int = _HYPOTHESIS_MEM_BUDGET
) -> int:
    """Largest hypothesis count whose scoring tensors fit the budget.

    Per (hypothesis, vector) cell the scorer holds 4 bytes of float32
    squared error plus a 1-byte inlier flag. Floored at 1024 so small
    degenerate fields still explore broadly.
    """
    return max(1024, budget_bytes // (5 * max(n_points, 1)))


def iter_count(params: RansacParams, max_hypotheses: int = 65536) -> int:
    """Number of hypotheses, float32 math like the reference
    (libs/motion.cpp:144-149)."""
    p = np.float32(params.success_prob)
    w = np.float32(params.inlier_ratio)
    n = np.float32(params.subset_sz)
    with np.errstate(divide="ignore", invalid="ignore"):
        quot = np.log(np.float32(1) - p)
        div = np.log(np.float32(1) - np.power(w, n))
        ratio = quot / div
    if not np.isfinite(ratio) or ratio < 0:
        return max_hypotheses if (w <= 0 or p >= 1) else 0
    return min(int(math.ceil(float(ratio))), max_hypotheses)


@functools.partial(jax.jit, static_argnames=("subset_sz", "k"))
def _ransac_core(
    f0: jnp.ndarray,
    f1: jnp.ndarray,
    key: jnp.ndarray,
    inlier_thresh: jnp.ndarray,
    subset_sz: int,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Core over SPLIT components ``f0``/``f1`` (each ``(N,)``), so no
    (k, N, 2) scoring intermediate carries a trailing axis of 2. The
    per-component math sums the two squared terms in the same order
    (``d0^2 + d1^2``), so results are bit-identical to the combined
    form."""
    n_points = f0.shape[0]

    if subset_sz == 1:
        idx = jax.random.randint(key, (k, 1), 0, n_points)
    else:
        keys = jax.random.split(key, k)
        idx = jax.vmap(
            lambda kk: jax.random.choice(
                kk, n_points, (subset_sz,), replace=False
            )
        )(keys)

    # hypothesis models: subset means, per component (k,)
    gm0 = jnp.mean(f0[idx], axis=1)
    gm1 = jnp.mean(f1[idx], axis=1)

    # score all hypotheses at once: (k, N)
    d0 = gm0[:, None] - f0[None, :]
    d1 = gm1[:, None] - f1[None, :]
    err2 = d0 * d0 + d1 * d1
    inliers = err2 < inlier_thresh**2
    counts = jnp.sum(inliers, axis=1)

    # ">=" keep rule: the LAST hypothesis attaining the max count wins
    best = (k - 1) - jnp.argmax(counts[::-1])
    best_gm = jnp.stack([gm0[best], gm1[best]])
    best_count = counts[best]
    best_mask = inliers[best]
    best_subset = idx[best]

    degenerate = best_count < subset_sz

    # refit on inliers (masked mean); guard the degenerate empty case
    denom = jnp.maximum(best_count, 1).astype(jnp.float32)
    refit_gm = jnp.stack(
        [
            jnp.sum(jnp.where(best_mask, f0, 0.0)) / denom,
            jnp.sum(jnp.where(best_mask, f1, 0.0)) / denom,
        ]
    )
    gm = jnp.where(degenerate, best_gm, refit_gm)

    # RMSE over inliers (refit case) or over the best subset (degenerate)
    e0 = f0 - gm[0]
    e1 = f1 - gm[1]
    err2_final = e0 * e0 + e1 * e1
    rmse_inliers = jnp.sqrt(
        jnp.sum(jnp.where(best_mask, err2_final, 0.0)) / denom
    )
    rmse_subset = jnp.sqrt(jnp.mean(err2_final[best_subset]))
    rmse = jnp.where(degenerate, rmse_subset, rmse_inliers)

    return gm, rmse, best_mask


def estimate_global_motion_ransac(
    motion_field: jnp.ndarray,
    params: RansacParams,
    key: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Estimate global motion; inlier mask marks background blocks.

    Args:
      motion_field: ``(N, 2)`` or ``(mfh, mfw, 2)`` float32 MVs.
      params: RANSAC parameters (must satisfy ``N >= subset_sz``).
      key: PRNG key for subset sampling.

    Returns:
      ``(global_motion (2,), rmse scalar, inlier_mask)`` — the mask has the
      motion field's leading shape.
    """
    lead_shape = motion_field.shape[:-1]
    # split components up front, so no scoring intermediate carries a
    # trailing axis of 2
    f0 = motion_field[..., 0].reshape(-1)
    f1 = motion_field[..., 1].reshape(-1)
    n_points = f0.shape[0]
    if n_points < params.subset_sz:
        raise ValueError("motion field smaller than RANSAC subset size")

    k = iter_count(params)
    cap = hypothesis_cap(n_points)
    if k > cap:
        import sys

        print(
            f"warning: RANSAC parameters ask for {k} hypotheses; capping "
            f"at {cap} to bound the ({k}, {n_points}) scoring tensor "
            f"(~{5 * k * n_points >> 20} MB)",
            file=sys.stderr,
        )
        k = cap
    if k == 0:
        # no hypotheses sampled: nothing to fit (reference would read
        # uninitialized state here, quirk E3)
        return (
            jnp.zeros(2, jnp.float32),
            jnp.float32(0),
            jnp.zeros(lead_shape, bool),
        )

    gm, rmse, mask = _ransac_core(
        f0,
        f1,
        key,
        jnp.float32(params.inlier_thresh),
        params.subset_sz,
        k,
    )
    return gm, rmse, mask.reshape(lead_shape)
