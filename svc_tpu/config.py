"""Typed configs + validation for the encoder and decoder pipelines.

Mirrors the reference's config structs and ``Validate`` functions so the CLI
surface, defaults, and error messages stay compatible:

* ``RansacParams``      (reference: libs/motion.hpp:60-79)
* ``KMeansParams``      (reference: libs/encoder.hpp:16-21)
* ``EncoderConfig``     (reference: libs/encoder.hpp:25-37)
* ``DecoderConfig``     (reference: libs/decoder.hpp:12-17)
* validation rules      (reference: libs/encoder.cpp:20-142, libs/decoder.cpp:35-47)
* default values        (reference: apps/encoder.cpp:28-58, apps/decoder.cpp:21-26)

New fields beyond the reference (all optional, defaulted):

* ``seed`` — RANSAC/k-means run under an explicit PRNG key instead of the
  reference's nondeterministic ``std::random_device`` (quirk Q7,
  reference: libs/motion.cpp:186-187).
* ``reference_compat`` — when True, reproduces the reference's k-means
  feature-layout bug (quirk Q1, reference: libs/encoder.cpp:316-319 +
  libs/math.hpp:285-291) AND cv::kmeans' exact empty-cluster repair rule
  (split the biggest cluster; ops/kmeans.py ``repair="opencv_split"``)
  for bit-level parity experiments.
"""

from __future__ import annotations

import dataclasses

from svc_tpu.utils.errors import Error, ErrorCode, OK
from svc_tpu.utils.mathx import pow2


@dataclasses.dataclass
class RansacParams:
    subset_sz: int = 1
    inlier_thresh: float = 7.5
    success_prob: float = 0.99
    inlier_ratio: float = 0.5


@dataclasses.dataclass
class KMeansParams:
    cluster_count: int = 10
    attempt_count: int = 3
    max_iter_count: int = 10
    epsilon: float = 1.0


@dataclasses.dataclass
class EncoderConfig:
    mv_block_w: int = 16
    mv_block_h: int = 16
    mv_search_range: int = 8
    pyr_lvl_count: int = 4
    ransac: RansacParams = dataclasses.field(default_factory=RansacParams)
    morph_rect_w: int = 3
    morph_rect_h: int = 3
    kmeans: KMeansParams = dataclasses.field(default_factory=KMeansParams)
    connected_components_connectivity: int = 4
    transform_block_w: int = 8
    transform_block_h: int = 8
    # --- framework extensions (not part of the reference surface) ---
    seed: int = 0
    reference_compat: bool = False


@dataclasses.dataclass
class DecoderConfig:
    foreground_quant_step: int = 1
    background_quant_step: int = 640
    max_gaze_rect_w: int = 64
    max_gaze_rect_h: int = 64


@dataclasses.dataclass
class VideoProperties:
    """reference: libs/encoder.hpp:46-50"""

    frame_w: int = 0
    frame_h: int = 0
    frame_count: int = 0


def validate_ransac_params(p: RansacParams) -> Error:
    """reference: libs/encoder.cpp:20-37"""
    if p.inlier_thresh < 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid inlier threshold: must be >= 0")
    if p.success_prob < 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid success probability: must be >= 0")
    if p.inlier_ratio < 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid inlier ratio: must be >= 0")
    return OK


def validate_kmeans_params(p: KMeansParams) -> Error:
    """reference: libs/encoder.cpp:39-60"""
    if p.cluster_count == 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid cluster count: must be > 0")
    if p.attempt_count == 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid attempt count: must be > 0")
    if p.max_iter_count == 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid maximum iteration count: must be > 0")
    if p.epsilon <= 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid epsilon: must be > 0")
    return OK


def validate_encoder_config(cfg: EncoderConfig) -> Error:
    """reference: libs/encoder.cpp:62-142"""
    if cfg.mv_block_w < 1:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid mv block width: must be > 0")
    if cfg.mv_block_h < 1:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid mv block height: must be > 0")
    if cfg.pyr_lvl_count < 1:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid pyramid level count: must be > 0")

    top_lvl_reduction_factor = pow2(cfg.pyr_lvl_count - 1)
    if cfg.mv_search_range // top_lvl_reduction_factor == 0:
        return Error(
            ErrorCode.INVALID_PARAMETER,
            "invalid mv search and pyramid level count: the quotient from "
            "dividing the mv search range by the pyramid level reduction "
            "factor must be > 0")

    err = validate_ransac_params(cfg.ransac)
    if not err.ok:
        return Error(err.code,
                     "validating RANSAC parameters: " + err.message)

    err = validate_kmeans_params(cfg.kmeans)
    if not err.ok:
        return Error(err.code,
                     "validating k-means parameters: " + err.message)

    if cfg.connected_components_connectivity not in (4, 8):
        return Error(
            ErrorCode.INVALID_PARAMETER,
            "invalid connected components connectivity: must be either 4 or 8")

    if cfg.transform_block_w < 1:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid transform block width: must be > 0")
    if cfg.transform_block_h < 1:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid transform block height: must be > 0")

    # Block-type mapping from MV blocks to transform blocks must be
    # unambiguous (reference: libs/encoder.cpp:113-139).
    if cfg.transform_block_w > cfg.mv_block_w:
        return Error(
            ErrorCode.INVALID_PARAMETER,
            "invalid transform block width and mv block width: transform "
            "block width must be <= mv block width")
    if cfg.transform_block_h > cfg.mv_block_h:
        return Error(
            ErrorCode.INVALID_PARAMETER,
            "invalid transform block height and mv block height: transform "
            "block height must be <= mv block height")
    if cfg.mv_block_w % cfg.transform_block_w != 0:
        return Error(
            ErrorCode.INVALID_PARAMETER,
            "invalid mv block width and transform block width: mv block "
            "width must be divisible by transform block width")
    if cfg.mv_block_h % cfg.transform_block_h != 0:
        return Error(
            ErrorCode.INVALID_PARAMETER,
            "invalid mv block height and transform block height: mv block "
            "height must be divisible by transform block height")

    return OK


def validate_decoder_config(cfg: DecoderConfig) -> Error:
    """reference: libs/decoder.cpp:35-47"""
    if cfg.foreground_quant_step == 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid foreground quantization step: must be > 0")
    if cfg.background_quant_step == 0:
        return Error(ErrorCode.INVALID_PARAMETER,
                     "invalid background quantization step: must be > 0")
    return OK
