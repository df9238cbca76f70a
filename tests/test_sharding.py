"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from svc_tpu.config import EncoderConfig, KMeansParams, VideoProperties
from svc_tpu.models.encoder import Encoder
from svc_tpu.parallel.sharding import (
    FRAME_AXIS,
    ShardedEncoder,
    make_frame_mesh,
)


def _cfg():
    return EncoderConfig(
        mv_block_w=8,
        mv_block_h=8,
        mv_search_range=4,
        pyr_lvl_count=2,
        kmeans=KMeansParams(cluster_count=3),
    )


def _frames(t, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(30, 220, (24, 28)).astype(np.float32)
    bg = np.kron(coarse, np.ones((4, 4)))
    out = []
    for i in range(t):
        f = bg[i : i + h, i : i + w].copy()
        f[10:20, 30:40] = 240 - 5 * i
        out.append(np.repeat(f[..., None], 3, -1).astype(np.uint8))
    return np.stack(out)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_frame_mesh(8)


class TestShardedEncoder:
    def test_matches_single_chip_bitwise(self, mesh):
        cfg = _cfg()
        props = VideoProperties(64, 48, 9)
        frames = _frames(9)
        sharded = ShardedEncoder(cfg, props, mesh, batch_per_device=1)
        single = Encoder(cfg, props, batch_size=8)
        out_s = sharded.encode_batch(frames, 0)
        out_r = single.encode_batch(frames, 0)
        for key in ("coeffs", "block_types", "mv_field", "foreground_mask"):
            np.testing.assert_array_equal(
                np.asarray(out_s[key]), np.asarray(out_r[key])
            )

    def test_output_sharded_along_frames(self, mesh):
        cfg = _cfg()
        props = VideoProperties(64, 48, 9)
        sharded = ShardedEncoder(cfg, props, mesh, batch_per_device=1)
        out = sharded.encode_batch(_frames(9), 0)
        spec = out["coeffs"].sharding.spec
        assert spec[0] == FRAME_AXIS

    def test_collective_stats_replicated(self, mesh):
        cfg = _cfg()
        props = VideoProperties(64, 48, 9)
        sharded = ShardedEncoder(cfg, props, mesh, batch_per_device=1)
        out = sharded.encode_batch(_frames(9), 0)
        fg_total = int(out["total_foreground_blocks"])
        fg_direct = int(np.asarray(out["foreground_mask"]).sum())
        assert fg_total == fg_direct
        assert np.isfinite(float(out["mean_ransac_rmse"]))

    def test_multiple_pairs_per_device(self, mesh):
        cfg = _cfg()
        props = VideoProperties(64, 48, 17)
        sharded = ShardedEncoder(cfg, props, mesh, batch_per_device=2)
        assert sharded.batch_size == 16
        out = sharded.encode_batch(_frames(17), 0)
        assert out["coeffs"].shape[0] == 16

    def test_frontend_runs_inside_the_mesh_program(self, mesh):
        """The de-interleave/pad/luma/pyramid frontend must execute
        inside shard_map, not as a host-side single-device preprocess. The
        host path must never call ``inner.preprocess``, and every input
        must land pre-sharded: one (1, bpd+1, H, W*3) chunk per device."""
        cfg = _cfg()
        props = VideoProperties(64, 48, 9)
        frames = _frames(9)
        sharded = ShardedEncoder(cfg, props, mesh, batch_per_device=1)

        seen = []
        real_preprocess = sharded.inner.preprocess

        def spy(packed):
            seen.append(packed.shape)
            return real_preprocess(packed)

        sharded.inner.preprocess = spy
        chunks = sharded.chunk_frames(frames)
        assert chunks.shape == (8, 2, 48, 64 * 3)
        # halo: chunk d's first frame is chunk d-1's last anchor
        for d in range(1, 8):
            np.testing.assert_array_equal(chunks[d, 0], chunks[d - 1, -1])

        put = jax.device_put(chunks, sharded._chunk_sharding)
        shards = put.addressable_shards
        assert len(shards) == 8
        for s in shards:
            assert s.data.shape == (1, 2, 48, 64 * 3)

        out = sharded.encode_batch(frames, 0)
        # preprocess traced ONLY with per-device chunk shapes (bpd+1
        # frames), never the 9-frame super-batch
        assert seen and all(s == (2, 48, 64 * 3) for s in seen)
        single = Encoder(cfg, props, batch_size=8)
        single_out = single.encode_batch(frames, 0)
        np.testing.assert_array_equal(
            np.asarray(out["coeffs"]), np.asarray(single_out["coeffs"])
        )

    def test_wrong_batch_size_raises(self, mesh):
        cfg = _cfg()
        props = VideoProperties(64, 48, 9)
        sharded = ShardedEncoder(cfg, props, mesh, batch_per_device=1)
        with pytest.raises(ValueError, match="sharded batch"):
            sharded.encode_batch(_frames(5), 0)


class TestGraftEntry:
    def test_entry_compiles_and_runs(self):
        import importlib.util, pathlib

        spec = importlib.util.spec_from_file_location(
            "__graft_entry__",
            pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py",
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        fn, args = mod.entry()
        coeffs, btypes = jax.jit(fn)(*args)
        # merged wire layout: (T, nby, nbx, C*bh*bw)
        assert coeffs.shape == (2, 16, 16, 3 * 8 * 8)
        assert btypes.shape == (2, 8, 8)

        mod.dryrun_multichip(8)


class TestShardedCLI:
    """--devices N is a product feature: the CLI's shard-encoded bitstream
    must be byte-identical to the single-device one."""

    def test_cli_shard_encode_byte_identical(self, tmp_path):
        import os
        import subprocess
        import sys as _sys

        from svc_tpu.io.video import write_raw_avi

        clip = _frames(7, h=48, w=64)
        avi = str(tmp_path / "clip.avi")
        write_raw_avi(avi, clip)

        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=8"
            ).strip(),
        )
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        def run(extra):
            return subprocess.run(
                [_sys.executable, "-m", "svc_tpu.apps.encoder_app",
                 "--mv-block-w", "8", "--mv-block-h", "8",
                 "--mv-search-range", "4", "--pyr-lvl-count", "2",
                 "--kmeans-cluster-count", "3", "--batch-size", "2"]
                + extra + [avi],
                capture_output=True, check=True, env=env, cwd=repo,
            ).stdout

        single = run([])
        sharded = run(["--devices", "2"])
        assert len(single) > 32
        assert sharded == single


class TestShardedDecoder:
    """Decode is frame-data-parallel: a mesh-sharded Decoder must produce
    bitwise-identical frames, and the CLI --devices path must match the
    single-device decode byte for byte."""

    def test_sharded_decode_bitwise(self, mesh):
        import jax.numpy as jnp

        from svc_tpu.config import DecoderConfig
        from svc_tpu.io import bitstream
        from svc_tpu.models.decoder import Decoder

        t, h, w = 8, 48, 64
        hd = bitstream.Header(
            frame_count=t, frame_w=w, frame_h=h,
            frame_excess_w=0, frame_excess_h=0,
            transform_block_w=8, transform_block_h=8, channel_count=3,
        )
        rng = np.random.default_rng(5)
        coeffs = jnp.asarray(
            rng.normal(size=(t, h // 8, w // 8, 192)).astype(np.float32) * 30
        )
        btypes = jnp.asarray(
            rng.integers(0, 4, (t, h // 8, w // 8), np.uint32)
        )
        rects = jnp.asarray(
            np.tile(np.array([[8, 8, 16, 16]], np.int32), (t, 1))
        )
        single = Decoder(DecoderConfig(), hd, batch_size=t)
        sharded = Decoder(DecoderConfig(), hd, batch_size=t, mesh=mesh)
        a = np.asarray(single._decode_batch(coeffs, btypes, rects))
        b = np.asarray(sharded._decode_batch(coeffs, btypes, rects))
        np.testing.assert_array_equal(a, b)

    def test_sharded_decoder_batch_mismatch_raises(self, mesh):
        from svc_tpu.config import DecoderConfig
        from svc_tpu.io import bitstream
        from svc_tpu.models.decoder import Decoder

        hd = bitstream.Header(
            frame_count=4, frame_w=64, frame_h=48,
            frame_excess_w=0, frame_excess_h=0,
            transform_block_w=8, transform_block_h=8, channel_count=3,
        )
        with pytest.raises(ValueError):
            Decoder(DecoderConfig(), hd, batch_size=9, mesh=mesh)

    def test_cli_shard_decode_byte_identical(self, tmp_path):
        import os
        import subprocess
        import sys as _sys

        from svc_tpu.io.video import write_raw_avi

        clip = _frames(7, h=48, w=64)
        avi = str(tmp_path / "clip.avi")
        write_raw_avi(avi, clip)

        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=8"
            ).strip(),
        )
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        stream = subprocess.run(
            [_sys.executable, "-m", "svc_tpu.apps.encoder_app",
             "--mv-block-w", "8", "--mv-block-h", "8",
             "--mv-search-range", "4", "--pyr-lvl-count", "2",
             "--kmeans-cluster-count", "3", "--batch-size", "2", avi],
            capture_output=True, check=True, env=env, cwd=repo,
        ).stdout

        def run_decode(extra, name):
            out = str(tmp_path / name)
            subprocess.run(
                [_sys.executable, "-m", "svc_tpu.apps.decoder_app",
                 "--batch-size", "2", "--output", out] + extra,
                input=stream, capture_output=True, check=True, env=env,
                cwd=repo,
            )
            return np.load(out)

        single = run_decode([], "single.npy")
        sharded = run_decode(["--devices", "2"], "sharded.npy")
        np.testing.assert_array_equal(single, sharded)
