"""The card check refuses to run anywhere but on a GPU, and its decode
check accepts a faithful decode and rejects a wrong one."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_result_line(stdout: str) -> bool:
    return not any(ln.lstrip().startswith("{") for ln in stdout.splitlines())


def test_require_gpu_refuses_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax)


def test_main_refuses_cpu_backend(monkeypatch, capsys):
    """Past the card query and the card-only tests, the device phase
    stops the run on a CPU backend before any result is printed."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "test card, 1 W")
    monkeypatch.setattr(chip_smoke, "run_card_tests", lambda: None)
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert _no_result_line(capsys.readouterr().out)


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_card(tmp_path, alone):
    """Run as the driver runs it: from the checkout, and from a directory
    that holds the script and nothing else of the repo."""
    cwd = REPO
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(script)],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert _no_result_line(proc.stdout)


@pytest.mark.parametrize("excess_h", [0, 8])
def test_gaze_check_accepts_faithful_decode(excess_h):
    from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu.models.decoder import Decoder
    from svc_tpu.models.encoder import Encoder

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from clips import make_clip

    t, w, h = 2, 160, 96 - excess_h
    frames = make_clip(w, h, t + 1, seed=3)
    enc = Encoder(EncoderConfig(), VideoProperties(w, h, t + 1), batch_size=t)
    payloads = list(enc.encode_video(iter(frames)))
    cfg = DecoderConfig()
    dec = Decoder(cfg, enc.header(), batch_size=t)
    gaze = (80, 48)
    decoded = np.stack(
        list(dec.decode_frames(iter(payloads[1:]), iter([gaze] * t)))
    )
    good = chip_smoke._gaze_psnr(decoded, frames[1:], enc.header(), gaze, cfg)
    assert good >= 40.0
    wrong = np.roll(decoded, 3, axis=2)
    bad = chip_smoke._gaze_psnr(wrong, frames[1:], enc.header(), gaze, cfg)
    assert bad < 40.0
