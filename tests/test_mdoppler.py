"""Micro-Doppler spectrogram: golden/device parity + physics sanity.

The synthetic generator models coherent cross-frame slow time
(io/synthetic.py ``slow_t``), so a constant-velocity target must appear
as a constant spectral line at its radial velocity in every STFT
window, and the float64 golden and the jitted matmul path must agree at
the configured precision class.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.ops.decode import decode_to_cube
from mmradar.ops.mdoppler import (
    auto_range_bin,
    micro_doppler_spectrogram,
)


@pytest.fixture(scope="module")
def md_setup():
    cfg = RadarConfig()
    cap = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=0.0,
                     amplitude=2000.0)],
        13, cfg, noise_std=3.0, seed=7,
    )
    frames = jnp.asarray(cap[1:])
    base64 = golden.decode_shorts(cap[0], cfg)
    base_cube = decode_to_cube(jnp.asarray(cap[0]), cfg)
    return cfg, cap, frames, base64, base_cube


def test_micro_doppler_matches_golden(md_setup):
    cfg, cap, frames, base64, base_cube = md_setup
    r_bin = auto_range_bin(frames, base_cube, cfg)
    want = golden.micro_doppler(cap[1:], base64, cfg, range_bin=r_bin,
                                win_frames=4, hop_frames=2)
    got = np.asarray(micro_doppler_spectrogram(
        frames, base_cube, cfg, range_bin=r_bin, win_frames=4,
        hop_frames=2))
    assert got.shape == want.shape
    scale = want.max()
    assert np.abs(got - want).max() / scale < 1e-3


def test_micro_doppler_constant_velocity_line(md_setup):
    cfg, cap, frames, base64, base_cube = md_setup
    r_bin = auto_range_bin(frames, base_cube, cfg)
    spec = np.asarray(micro_doppler_spectrogram(
        frames, base_cube, cfg, range_bin=r_bin, win_frames=4,
        hop_frames=2))
    v_axis = golden.micro_doppler_velocity_axis(spec.shape[1], cfg)
    v_res = v_axis[1] - v_axis[0]
    peak_v = v_axis[np.argmax(spec, axis=1)]
    # a constant-velocity target is a constant line at its velocity
    assert np.all(np.abs(peak_v - 2.0) <= 1.5 * v_res), peak_v


def test_micro_doppler_auto_gate_finds_target(md_setup):
    cfg, cap, frames, base64, base_cube = md_setup
    r_bin = auto_range_bin(frames, base_cube, cfg)
    from mmradar.evaluate import expected_bins

    _, r_true = expected_bins(5.0, 2.0, cfg)
    assert abs(r_bin - r_true) <= 1


def test_micro_doppler_too_short_raises(md_setup):
    cfg, cap, frames, base64, base_cube = md_setup
    with pytest.raises(ValueError, match="too short"):
        micro_doppler_spectrogram(frames, base_cube, cfg, range_bin=0,
                                  win_frames=64)
    with pytest.raises(ValueError, match="too short"):
        golden.micro_doppler(cap[1:], base64, cfg, range_bin=0,
                             win_frames=64)


def test_micro_doppler_mean_clutter_mode(md_setup):
    """base_cube=None (per-frame chirp-mean clutter removal) agrees
    between the twins too."""
    cfg, cap, frames, base64, base_cube = md_setup
    want = golden.micro_doppler(cap[1:], None, cfg, range_bin=11,
                                win_frames=4, hop_frames=4)
    got = np.asarray(micro_doppler_spectrogram(
        frames, None, cfg, range_bin=11, win_frames=4, hop_frames=4))
    assert np.abs(got - want).max() / want.max() < 1e-3


def test_cli_mdoppler(tmp_path, capsys):
    from mmradar.cli import main
    from mmradar.io.capture import write_capture
    from mmradar.io.synthetic import synthesize_capture as synth

    cfg = RadarConfig()
    cap = synth([SceneTarget(range_m=5.0, velocity_mps=2.0,
                             azimuth_deg=0.0, amplitude=2000.0)],
                10, cfg, noise_std=3.0, seed=3)
    p = tmp_path / "cap.bin"
    write_capture(str(p), cap)
    out = tmp_path / "spec.npy"
    plot = tmp_path / "spec.png"
    rc = main(["mdoppler", str(p), "--win-frames", "4", "--hop-frames",
               "2", "--out", str(out), "--plot", str(plot)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["event"] == "micro_doppler"
    assert line["windows"] >= 1
    # the strong 2 m/s target dominates every window
    assert all(abs(v - 2.0) < 1.0 for v in line["peak_velocity_mps"])
    spec = np.load(out)
    assert spec.shape == (line["windows"], line["n_fft"])
    assert plot.exists()
