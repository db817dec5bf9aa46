"""Angle-Doppler map: golden parity, peak physics, CLI."""

import json

import numpy as np
import jax.numpy as jnp

from mmradar import golden
from mmradar.io.capture import write_capture
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.ops.aoa import angle_doppler_from_shorts
from mmradar.ops.decode import decode_to_cube
from mmradar.ops.mdoppler import auto_range_bin


def _capture(cfg, tgts, frames=4, seed=3):
    return synthesize_capture(tgts, frames, cfg, noise_std=5.0, seed=seed)


def test_angle_doppler_matches_golden(cfg):
    cap = _capture(cfg, [
        SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=10.0,
                    amplitude=2000.0)])
    base = decode_to_cube(jnp.asarray(cap[0]), cfg)
    want, gate = golden.angle_doppler_map(cap[1:], np.asarray(base), cfg)
    got = np.asarray(angle_doppler_from_shorts(
        jnp.asarray(cap[1:]), base, cfg, range_bin=gate))
    scale = want.max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-3)
    # the auto gate helper agrees with the golden's strongest-gate pick
    assert auto_range_bin(jnp.asarray(cap[1:]), base, cfg) == gate


def test_angle_doppler_peak_physics(cfg):
    """Two movers at the same range, different velocity AND bearing —
    the case the range-azimuth map cannot fully separate — peak at the
    right (velocity, azimuth) cells."""
    cap = _capture(cfg, [
        SceneTarget(range_m=6.0, velocity_mps=3.0, azimuth_deg=-25.0,
                    amplitude=2000.0),
        SceneTarget(range_m=6.0, velocity_mps=-2.0, azimuth_deg=30.0,
                    amplitude=2000.0),
    ])
    base = decode_to_cube(jnp.asarray(cap[0]), cfg)
    gate = auto_range_bin(jnp.asarray(cap[1:]), base, cfg)
    pmap = np.asarray(angle_doppler_from_shorts(
        jnp.asarray(cap[1:]), base, cfg, range_bin=gate)).mean(axis=0)
    d = cfg.doppler_fft_size
    found = []
    p = pmap.copy()
    for _ in range(2):
        db, ab = np.unravel_index(np.argmax(p), p.shape)
        v = ((db - d // 2) / (d * cfg.slow_time_interval_s)
             * cfg.wavelength_m / 2.0)
        az = float(golden.angle_bin_to_deg(ab, p.shape[1], cfg))
        found.append((v, az))
        # blank a neighborhood (doppler wraps) before the next peak
        for dd in range(-2, 3):
            p[(db + dd) % d, max(ab - 4, 0):ab + 5] = 0.0
    found.sort()
    (v1, az1), (v2, az2) = found
    assert abs(v1 - (-2.0)) < 0.3 and abs(az1 - 30.0) < 4.0
    assert abs(v2 - 3.0) < 0.3 and abs(az2 - (-25.0)) < 4.0


def test_cli_admap(tmp_path, cfg, capsys):
    from mmradar import cli

    cap = _capture(cfg, [
        SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=10.0,
                    amplitude=2000.0)])
    path = tmp_path / "c.bin"
    write_capture(str(path), np.asarray(cap))
    out = tmp_path / "ad.npy"
    png = tmp_path / "ad.png"
    rc = cli.main(["admap", str(path), "--out", str(out),
                   "--plot", str(png)])
    assert rc in (0, None)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["event"] == "angle_doppler"
    assert abs(rec["peak_velocity_mps"] - 2.0) < 0.3
    assert abs(rec["peak_azimuth_deg"] - 10.0) < 4.0
    assert abs(rec["range_m"] - 5.0) < 0.5
    m = np.load(out)
    assert m.shape == (cfg.doppler_fft_size, cfg.num_angle_bins)
    assert png.exists()
