"""Frame-parallel sharded encoding over a device mesh.

Scale-out design (SURVEY.md §2.2/§2.3): frames are embarrassingly
parallel given the previous frame — frame ``t`` depends on ``t-1`` only
through the *input* pyramid (reference: libs/encoder.cpp:661-663, the
encoder just swaps pyramids). So a video shards across the devices of a
host as raw packed frame chunks along a ``frames`` mesh axis, each chunk
carrying a one-frame halo (its first anchor's tracked frame — the last
frame of the previous chunk, duplicated host-side; ~one frame of extra
H2D per device). The ENTIRE per-frame transform — de-interleave, pad, luma,
pyramid, motion, segmentation, DCT — runs inside the ``shard_map`` program:
no stage ever materializes the full super-batch on one device, and every
device's H2D transfer is exactly its own chunk. Collectives (``psum``) are
used only for stream-level statistics, never per block.

One ``shard_map`` over a ``Mesh`` takes the place of per-process ranks;
XLA inserts the communication.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svc_tpu.config import EncoderConfig, VideoProperties
from svc_tpu.models.encoder import Encoder

FRAME_AXIS = "frames"


def make_frame_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the frame-batch axis.

    On a multi-GPU host the axis spans the host's cards (every card reaches
    every other at the same rate, so the mesh follows the algorithm
    alone); in tests it spans virtual CPU devices
    (``xla_force_host_platform_device_count``).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


class ShardedEncoder:
    """Encoder whose batch dimension is sharded across a mesh.

    The per-device program is exactly the single-chip pipeline
    (``Encoder.encode_batch_fn`` — frontend included) on a local chunk of
    ``batch_per_device`` anchor frames plus its one-frame halo; ``psum``
    aggregates stream statistics (foreground block count, mean RANSAC
    RMSE) across the mesh.
    """

    def __init__(
        self,
        cfg: EncoderConfig,
        vidprops: VideoProperties,
        mesh: Mesh,
        batch_per_device: int = 4,
        keep_planes: bool = False,
    ):
        self.mesh = mesh
        self.n_devices = mesh.devices.size
        self.batch_per_device = batch_per_device
        self.batch_size = self.n_devices * batch_per_device
        # the per-device program: the single-chip pipeline on a local chunk
        self.inner = Encoder(
            cfg, vidprops, batch_size=batch_per_device,
            keep_planes=keep_planes,
        )

        batch_fn = self.inner.encode_batch_fn

        def local_encode(packed_chunk, keys):
            # (1, bpd+1, H, W*3) local chunk view -> single-chip program
            out = batch_fn(packed_chunk[0], keys[0])
            # cross-device stream statistics
            fg_count = jnp.sum(out["foreground_mask"])
            out["total_foreground_blocks"] = jax.lax.psum(
                fg_count, FRAME_AXIS
            )
            out["mean_ransac_rmse"] = jax.lax.pmean(
                jnp.mean(out["ransac_rmse"]), FRAME_AXIS
            )
            return out

        shard = P(FRAME_AXIS)
        out_specs = {
            "coeffs": shard,
            "block_types": shard,
            "mv_field": shard,
            "foreground_mask_raw": shard,
            "foreground_mask": shard,
            "cluster_labels": shard,
            "global_motion": shard,
            "ransac_rmse": shard,
            "total_foreground_blocks": P(),  # replicated after psum
            "mean_ransac_rmse": P(),
        }
        if keep_planes:
            # (3, bpd+1, PH, PW) per device, frame axis 1; each chunk
            # keeps its own overlap frame in the gathered stack
            out_specs["padded_planes"] = P(None, FRAME_AXIS)

        self._sharded = jax.jit(
            jax.shard_map(
                local_encode,
                mesh=mesh,
                in_specs=(shard, shard),
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._chunk_sharding = NamedSharding(mesh, shard)

    @property
    def cfg(self):
        return self.inner.cfg

    @property
    def keep_planes(self):
        return self.inner.keep_planes

    def header(self, frame_count=None):
        return self.inner.header(frame_count)

    def encode_video(self, frames, **kwargs):
        """Stream shard-encode a video: the single-chip streaming loop
        (models.encoder.stream_encode) over mesh-sharded batches. The
        bitstream is byte-identical to the single-chip encoder's — frames
        are data-parallel given the overlap frame, and the ordered host
        gather preserves the sequential wire contract
        (tests/test_sharding.py asserts CLI-level byte identity)."""
        from svc_tpu.models.encoder import stream_encode

        return stream_encode(self, frames, **kwargs)

    def chunk_frames(self, frames_bgr: np.ndarray) -> np.ndarray:
        """Host-side halo chunking: ``(T+1, H, W, 3)`` uint8 frames ->
        ``(n_devices, bpd+1, H, W*3)`` packed chunks, where chunk ``d``
        holds anchors ``[d*bpd+1, (d+1)*bpd]`` plus the preceding overlap
        frame (the halo — the only duplicated data, one frame per device).
        """
        n, h, w, c = frames_bgr.shape
        bpd = self.batch_per_device
        packed = np.ascontiguousarray(frames_bgr).reshape(n, h, w * c)
        return np.stack(
            [
                packed[d * bpd : d * bpd + bpd + 1]
                for d in range(self.n_devices)
            ]
        )

    def _chunk_packed(self, packed: np.ndarray) -> np.ndarray:
        """Halo-chunk already-packed ``(T+1, H, W*3)`` frames into
        ``(n_devices, bpd+1, H, W*3)`` (see :meth:`chunk_frames`)."""
        bpd = self.batch_per_device
        return np.stack(
            [
                packed[d * bpd : d * bpd + bpd + 1]
                for d in range(self.n_devices)
            ]
        )

    def stage_frames(self, packed: np.ndarray):
        """Ship packed ``(T+1, H, W*3)`` host frames onto the mesh,
        pre-sharded along the frame axis — the staged half of the
        ``stream_encode`` protocol, so the scale-out path overlaps its
        H2D transfers with compute exactly like the single chip does
        (the reference's reader thread, apps/encoder.cpp:125-149)."""
        return jax.device_put(
            self._chunk_packed(packed), self._chunk_sharding
        )

    def _sharded_keys(self, first_anchor_index: int):
        return jax.device_put(
            self.inner._keys(first_anchor_index, self.batch_size).reshape(
                self.n_devices, self.batch_per_device
            ),
            self._chunk_sharding,
        )

    def encode_batch_staged(self, staged, first_anchor_index: int):
        """Dispatch on chunks already staged via :meth:`stage_frames`."""
        return self._sharded(staged, self._sharded_keys(first_anchor_index))

    def encode_batch(self, frames_bgr: np.ndarray, first_anchor_index: int):
        """Encode ``(T+1, H, W, 3)`` uint8 frames, ``T = batch_size``.

        Every input lands on the mesh pre-sharded (``device_put`` with a
        frame-axis ``NamedSharding``): each device receives exactly its
        own chunk — the full super-batch never exists on any one device.
        """
        t = frames_bgr.shape[0] - 1
        if t != self.batch_size:
            raise ValueError(
                f"sharded batch needs {self.batch_size}+1 frames, got {t}+1"
            )
        chunks = jax.device_put(
            self.chunk_frames(frames_bgr), self._chunk_sharding
        )
        return self._sharded(chunks, self._sharded_keys(first_anchor_index))
