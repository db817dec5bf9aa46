"""Golden model: reference-parity FFT, range pipeline, extended stages."""

import numpy as np
import pytest

from mmradar import golden
from mmradar.io.synthetic import SceneTarget, synthesize_capture, synthesize_cube


class TestButterflyFFT:
    @pytest.mark.parametrize("n", [16, 256, 16384])
    def test_matches_numpy_on_random(self, n):
        rng = np.random.default_rng(n)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got = golden.butterfly_fft(x)
        want = np.fft.fft(x)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)

    def test_ramp_16(self):
        """The reference's dead self-test input (acceleration.cu:361-364)."""
        x = np.arange(1, 17, dtype=np.complex128)
        np.testing.assert_allclose(
            golden.butterfly_fft(x), np.fft.fft(x), rtol=1e-12, atol=1e-9
        )

    def test_impulse_and_tone(self):
        n = 1024
        impulse = np.zeros(n, dtype=np.complex128)
        impulse[0] = 1.0
        np.testing.assert_allclose(
            golden.butterfly_fft(impulse), np.ones(n), atol=1e-12
        )
        k = 37
        tone = np.exp(2j * np.pi * k * np.arange(n) / n)
        spec = golden.butterfly_fft(tone)
        assert np.argmax(np.abs(spec)) == k

    def test_batched(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((4, 64)) + 1j * rng.standard_normal((4, 64))
        got = golden.butterfly_fft(x)
        np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), rtol=1e-9, atol=1e-9)


class TestRangePipeline:
    def test_detects_known_target(self, cfg):
        r_true = 5.0
        shorts = synthesize_capture(
            [SceneTarget(range_m=r_true, amplitude=3000.0)],
            4, cfg, noise_std=5.0, seed=11,
        )
        dets = golden.detect_capture(shorts, cfg)
        assert len(dets) == 3
        # zero-pad leakage of the concatenated-chirp structure can shift the
        # peak a few bins; allow half a chirp-rate harmonic line of error
        line_hz = cfg.sample_rate_hz / cfg.num_samples
        line_m = 3.0e8 * line_hz / (2 * cfg.slope_hz_per_s)
        for d in dets:
            phys = cfg.bin_to_physical_distance(d.peak_bin)
            assert abs(phys - r_true) <= line_m, (phys, r_true)
            assert d.distance_m == cfg.bin_to_distance(d.rescaled_bin)
            # the reference's rescale+Fs_extend math equals the physical
            # formula up to integer quantization of the pre-pad grid
            assert abs(d.distance_m - phys) <= cfg.bin_to_physical_distance(2)

    def test_reference_fft_path_matches_numpy_fft_path(self, cfg, capture):
        dets_np = golden.detect_capture(capture, cfg, use_reference_fft=False)
        dets_ref = golden.detect_capture(capture, cfg, use_reference_fft=True)
        for a, b in zip(dets_np, dets_ref):
            assert a.peak_bin == b.peak_bin
            assert a.distance_m == pytest.approx(b.distance_m, abs=1e-12)
            assert a.peak_magnitude == pytest.approx(b.peak_magnitude, rel=1e-9)

    def test_base_subtraction_removes_clutter(self, cfg):
        # clutter-only capture -> after base subtraction spectrum is ~noise
        shorts = synthesize_capture([], 3, cfg, noise_std=2.0, seed=5)
        base = golden.base_frame_rx0(shorts[0], cfg)
        x = golden.fft_input(shorts[1], base, cfg)
        spec = np.abs(np.fft.fft(x))
        # clutter tone at ~0.8 m would be huge without subtraction
        clutter_bin = round(
            cfg.distance_to_beat_hz(0.8) / cfg.sample_rate_hz * cfg.fft_size
        )
        window = spec[max(clutter_bin - 200, 0) : clutter_bin + 200]
        assert window.max() < 0.05 * 300.0 * cfg.rx_samples

    def test_rescale_uses_integer_division(self, cfg):
        assert cfg.rescale_peak_bin(640) == 500
        assert cfg.rescale_peak_bin(641) == 500  # 641*12800//16384 = 500 (floor)
        assert cfg.rescale_peak_bin(0) == 0

    def test_scan_window_size(self, cfg):
        assert cfg.fft_size == 16384
        assert cfg.scan_bins == 6553


class TestExtendedGolden:
    def test_range_doppler_peak_location(self, cfg):
        r_true, v_true = 6.0, 3.0
        cube = synthesize_cube(
            [SceneTarget(range_m=r_true, velocity_mps=v_true, amplitude=3000.0)],
            3, cfg, noise_std=1.0, seed=13,
        )
        x = cube[2] - cube[0]  # clutter removal
        rd = golden.range_doppler_map(x, cfg)
        power = np.abs(rd).sum(axis=0)  # non-coherent over rx
        d_idx, r_idx = np.unravel_index(np.argmax(power), power.shape)
        fb = cfg.distance_to_beat_hz(r_true)
        expect_r = round(fb / cfg.sample_rate_hz * cfg.range_fft_size)
        fd = cfg.velocity_to_doppler_hz(v_true)
        expect_d = (
            round(fd * cfg.chirp_interval_s * cfg.doppler_fft_size)
            + cfg.doppler_fft_size // 2
        )
        assert abs(r_idx - expect_r) <= 1
        assert abs(d_idx - expect_d) <= 1

    def test_cfar_flags_target_not_noise(self, cfg):
        rng = np.random.default_rng(17)
        power = rng.exponential(1.0, (cfg.doppler_fft_size, cfg.range_fft_size))
        power[40, 70] = 500.0
        hits, thresh = golden.ca_cfar_2d(
            power, cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa
        )
        assert hits[40, 70]
        assert thresh.shape == power.shape
        # false alarms bounded (pfa=1e-4 over 16k cells -> expect ~2)
        assert hits.sum() <= 25

    def test_angle_fft_recovers_azimuth(self, cfg):
        az_true = 25.0
        steering = np.exp(
            1j * 2 * np.pi * cfg.rx_spacing_wavelengths
            * np.sin(np.deg2rad(az_true)) * np.arange(cfg.num_rx)
        )
        spec = golden.angle_fft(steering, cfg.num_angle_bins, cfg)
        est = golden.angle_bin_to_deg(
            int(np.argmax(np.abs(spec))), cfg.num_angle_bins, cfg
        )
        # 4-element array: coarse resolution, fft-grid quantization
        assert abs(est - az_true) < 10.0

    def test_capon_recovers_azimuth(self, cfg):
        az_true = -30.0
        rng = np.random.default_rng(19)
        steer = np.exp(
            1j * 2 * np.pi * cfg.rx_spacing_wavelengths
            * np.sin(np.deg2rad(az_true)) * np.arange(cfg.num_rx)
        )
        sig = (rng.standard_normal((128, 1)) + 1j * rng.standard_normal((128, 1)))
        snaps = sig * steer[None, :] + 0.05 * (
            rng.standard_normal((128, cfg.num_rx))
            + 1j * rng.standard_normal((128, cfg.num_rx))
        )
        angles, p = golden.capon_spectrum(snaps, cfg)
        assert abs(angles[np.argmax(p)] - az_true) <= 3.0
