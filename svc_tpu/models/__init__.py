"""Pipeline models: the encoder and decoder, as jitted batched transforms.

Batched, jitted counterpart of the reference's L3 pipeline layer
(libs/encoder.cpp, libs/decoder.cpp). The reference streams one frame at a
time through a thread pipeline; here the pipelines are functional
frame-batch transforms compiled once and reused, with host I/O handled by
``svc_tpu.runtime``.
"""

from svc_tpu.models.encoder import Encoder  # noqa: F401
from svc_tpu.models.decoder import Decoder  # noqa: F401
