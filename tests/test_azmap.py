"""Range-azimuth heatmap: golden/device parity + physics sanity."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.ops.aoa import range_azimuth_from_shorts
from mmradar.ops.decode import decode_to_cube


@pytest.fixture(scope="module")
def az_setup():
    cfg = RadarConfig()
    cap = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=20.0,
                     amplitude=2000.0)],
        4, cfg, noise_std=3.0, seed=11,
    )
    frames = jnp.asarray(cap[1:])
    base64 = golden.decode_shorts(cap[0], cfg)
    base_cube = decode_to_cube(jnp.asarray(cap[0]), cfg)
    return cfg, cap, frames, base64, base_cube


def test_range_azimuth_matches_golden(az_setup):
    cfg, cap, frames, base64, base_cube = az_setup
    want = golden.range_azimuth_map(cap[1:], base64, cfg)
    got = np.asarray(range_azimuth_from_shorts(frames, base_cube, cfg))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / want.max() < 1e-3


def test_range_azimuth_peak_at_target(az_setup):
    cfg, cap, frames, base64, base_cube = az_setup
    pmap = np.asarray(
        range_azimuth_from_shorts(frames, base_cube, cfg)).mean(axis=0)
    a_bin, r_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    az = golden.angle_bin_to_deg(a_bin, pmap.shape[0], cfg)
    from mmradar.evaluate import expected_bins

    _, r_true = expected_bins(5.0, 2.0, cfg)
    assert abs(r_bin - r_true) <= 1
    # 4 virtual elements -> coarse beams; within half a beamwidth
    assert abs(az - 20.0) <= 8.0, az


def test_range_azimuth_mimo_compensation_matters():
    """With TDM MIMO (2 TX) the uncompensated map mislocates a moving
    target in angle; the compensated twins agree and peak near truth."""
    cfg = RadarConfig(num_tx=2)
    cap = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=3.0, azimuth_deg=-25.0,
                     amplitude=2500.0)],
        4, cfg, noise_std=2.0, seed=13,
    )
    base64 = golden.decode_shorts(cap[0], cfg)
    want = golden.range_azimuth_map(cap[1:], base64, cfg)
    got = np.asarray(range_azimuth_from_shorts(
        jnp.asarray(cap[1:]), decode_to_cube(jnp.asarray(cap[0]), cfg),
        cfg))
    assert np.abs(got - want).max() / want.max() < 1e-3
    pmap = got.mean(axis=0)
    a_bin, r_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    az = golden.angle_bin_to_deg(a_bin, pmap.shape[0], cfg)
    assert abs(az - (-25.0)) <= 8.0, az


def test_cli_azmap(tmp_path, capsys):
    from mmradar.cli import main
    from mmradar.io.capture import write_capture

    cfg = RadarConfig()
    cap = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=20.0,
                     amplitude=2000.0)],
        4, cfg, noise_std=3.0, seed=11,
    )
    p = tmp_path / "cap.bin"
    write_capture(str(p), cap)
    out = tmp_path / "az.npy"
    plot = tmp_path / "az.png"
    rc = main(["azmap", str(p), "--out", str(out), "--plot", str(plot)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["event"] == "range_azimuth"
    assert abs(line["peak_azimuth_deg"] - 20.0) <= 8.0
    pmap = np.load(out)
    assert pmap.shape == (line["angle_bins"], line["range_bins"])
    assert plot.exists()


def test_range_azimuth_capon_matches_golden(az_setup):
    cfg, cap, frames, base64, base_cube = az_setup
    from mmradar.ops.aoa import range_azimuth_capon_from_shorts

    angles, want = golden.range_azimuth_capon_map(cap[1:], base64, cfg)
    got = np.asarray(range_azimuth_capon_from_shorts(frames, base_cube, cfg))
    assert got.shape == want.shape
    # c64 covariance + inverse vs f64: compare normalized spectra
    gn = got / got.max()
    wn = want / want.max()
    assert np.abs(gn - wn).max() < 1e-2
    # peak at the target
    pmap = got.mean(axis=0)
    a_bin, r_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    lo, hi, na = cfg.angle_grid_deg
    az = np.linspace(lo, hi, int(na))[a_bin]
    from mmradar.evaluate import expected_bins

    _, r_true = expected_bins(5.0, 2.0, cfg)
    assert abs(r_bin - r_true) <= 1
    assert abs(az - 20.0) <= 6.0, az


def test_cli_azmap_capon(tmp_path, capsys):
    from mmradar.cli import main
    from mmradar.io.capture import write_capture

    cfg = RadarConfig()
    cap = synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=20.0,
                     amplitude=2000.0)],
        4, cfg, noise_std=3.0, seed=11,
    )
    p = tmp_path / "cap.bin"
    write_capture(str(p), cap)
    rc = main(["azmap", str(p), "--method", "capon"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["method"] == "capon"
    assert abs(line["peak_azimuth_deg"] - 20.0) <= 6.0
