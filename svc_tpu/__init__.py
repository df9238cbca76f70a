"""svc_tpu — a JAX/XLA scalable video codec framework for accelerators.

A from-scratch rebuild of the capabilities of
``fonzcastellanos/scalable-video-codec`` (a C++17/OpenCV/SSE2 content- and
gaze-adaptive scalable video codec) designed accelerator-first:

* the hierarchical block-matching motion search (HBMA) is a batched,
  vectorized device kernel instead of an SSE2 scalar loop
  (reference: libs/motion.cpp),
* RANSAC global-motion estimation runs as massively parallel hypothesis
  scoring instead of a sequential iteration loop (libs/motion.cpp:182-266),
* morphology, k-means and connected-component labeling are jitted
  on-device ops replacing OpenCV calls (libs/encoder.cpp:524-623),
* the blockwise 8x8 DCT/IDCT are matrix products, fused with region/gaze
  adaptive quantization (libs/encoder.cpp:323-339, libs/decoder.cpp:128-149),
* the per-frame thread-queue streaming pipeline (apps/encoder.cpp:125-229)
  becomes batched multi-frame jitted execution, sharded over a
  ``jax.sharding.Mesh`` for multi-chip scale-out,
* CLI flag surface and bitstream wire format are preserved
  (apps/encoder.cpp:75-104, libs/codec.hpp:8-17, libs/encoder.cpp:222-269).
"""

__version__ = "0.4.0"

from svc_tpu.config import (  # noqa: F401
    DecoderConfig,
    EncoderConfig,
    KMeansParams,
    RansacParams,
    VideoProperties,
    validate_decoder_config,
    validate_encoder_config,
)
from svc_tpu.utils.errors import Error, ErrorCode  # noqa: F401
