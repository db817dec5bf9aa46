"""Native C++ golden model vs the NumPy golden model (cross-validation of
the two independent float64 implementations — the reference's dual-path
verification spirit, done for real)."""

import shutil
import subprocess

import numpy as np
import pytest

from mmradar import golden, native
from mmradar.io.capture import decode_shorts, write_capture

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("make") is None,
    reason="native toolchain unavailable",
)


@pytest.fixture(scope="session", autouse=True)
def built_lib():
    return native.build_library()


def test_native_decode_matches_numpy(cfg, capture):
    got = native.decode_frame(capture[1], cfg)
    want = decode_shorts(capture[1], cfg)
    np.testing.assert_array_equal(got, want)


def test_native_fft_matches_numpy():
    rng = np.random.default_rng(41)
    for n in (16, 1024, 16384):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got = native.fft(x)
        np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-9, atol=1e-6)


def test_native_detect_matches_python_golden(cfg, capture):
    base = golden.base_frame_rx0(capture[0], cfg)
    nbase = native.base_frame(capture[0], cfg)
    np.testing.assert_array_equal(nbase, base)
    for i in (1, 5, 9):
        want = golden.detect_frame(capture[i], base, cfg)
        got = native.detect_frame(capture[i], base, cfg)
        assert got.peak_bin == want.peak_bin
        assert got.rescaled_bin == want.rescaled_bin
        assert got.distance_m == pytest.approx(want.distance_m, abs=1e-12)
        assert got.magnitude == pytest.approx(want.peak_magnitude, rel=1e-9)


def test_native_capture_loop(tmp_path, cfg, capture):
    path = tmp_path / "cap.bin"
    write_capture(path, capture, cfg)
    dists, timings = native.process_capture(path, cfg)
    want = golden.detect_capture(capture, cfg)
    assert timings["frames"] == len(want) == len(dists)
    np.testing.assert_allclose(
        dists, [w.distance_m for w in want], atol=1e-12
    )
    assert timings["total"] > 0


def test_bench_cli(tmp_path, cfg, capture):
    path = tmp_path / "cap.bin"
    write_capture(path, capture, cfg)
    exe = native._CPP_DIR / "build" / "radar_bench"
    out = subprocess.run(
        [str(exe), str(path)], capture_output=True, text=True, check=True
    )
    assert "Total Time for 9 frames" in out.stdout
    assert "FPS" in out.stdout
    assert "Total FFT time" in out.stdout


def test_native_range_doppler_matches_numpy_golden(cfg):
    rng = np.random.default_rng(67)
    ch = (rng.standard_normal((cfg.num_chirps, cfg.num_samples))
          + 1j * rng.standard_normal((cfg.num_chirps, cfg.num_samples)))
    want = golden.range_doppler_map(ch, cfg)
    got = native.range_doppler_map(ch, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    # no-window variant too
    np.testing.assert_allclose(
        native.range_doppler_map(ch, cfg, window=False),
        golden.range_doppler_map(ch, cfg, window=False),
        rtol=1e-9, atol=1e-9,
    )


def test_native_window_kinds_match_numpy_golden(cfg):
    # every window kind: the C++ twin computes its own cosine-sum taps
    rng = np.random.default_rng(68)
    ch = (rng.standard_normal((cfg.num_chirps, cfg.num_samples))
          + 1j * rng.standard_normal((cfg.num_chirps, cfg.num_samples)))
    for kind in ("rect", "hann", "hamming", "blackman", "blackmanharris"):
        np.testing.assert_allclose(
            native.range_doppler_map(ch, cfg, window=kind),
            golden.range_doppler_map(ch, cfg, window=kind),
            rtol=1e-9, atol=1e-9, err_msg=kind,
        )


def test_native_cfar_matches_numpy_golden(cfg):
    rng = np.random.default_rng(71)
    power = rng.exponential(1.0, (cfg.doppler_fft_size, cfg.range_fft_size))
    power[30, 40] = 900.0
    want_hits, want_thresh = golden.ca_cfar_2d(
        power, cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
        n_pulses=cfg.cfar_pulses_effective,
    )
    got_hits, got_thresh = native.ca_cfar_2d(power, cfg)
    np.testing.assert_allclose(got_thresh, want_thresh, rtol=1e-12)
    np.testing.assert_array_equal(got_hits, want_hits)


def test_native_os_cfar_matches_golden(cfg):
    rng = np.random.default_rng(53)
    power = rng.exponential(
        1.0, (cfg.doppler_fft_size, cfg.range_fft_size)
    )
    power[40, 70] = 700.0
    want_hits, want_t = golden.os_cfar_2d(
        power, cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
        n_pulses=cfg.cfar_pulses_effective,
    )
    got_hits, got_t = native.os_cfar_2d(power, cfg)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-12)
    np.testing.assert_array_equal(got_hits, want_hits)


def test_native_os_alpha_matches_python():
    from mmradar.golden import os_cfar_alpha

    lib = native.load()
    for n, k, pfa in [(248, 186, 1e-4), (80, 60, 1e-3), (16, 12, 1e-2)]:
        assert abs(lib.radar_os_cfar_alpha(n, k, pfa, 1)
                   - os_cfar_alpha(n, k, pfa)) < 1e-9


def test_os_cfar_half_integer_k_parity(cfg):
    """cfar_train=(4,7) -> n_train=222, 0.75*222=166.5 exactly: all three
    implementations must round k the same way (half away from zero)."""
    from mmradar.config import RadarConfig as RC
    from mmradar.ops.cfar import os_cfar_2d as os_xla
    import jax.numpy as jnp

    c = RC(cfar_train=(4, 7))
    rng = np.random.default_rng(57)
    power = rng.exponential(1.0, (c.doppler_fft_size, c.range_fft_size))
    _, want = golden.os_cfar_2d(power, c.cfar_guard, c.cfar_train, c.cfar_pfa,
                                n_pulses=c.cfar_pulses_effective)
    _, got_native = native.os_cfar_2d(power, c)
    np.testing.assert_allclose(got_native, want, rtol=1e-12)
    _, got_xla = os_xla(jnp.asarray(power.astype(np.float32)), c)
    np.testing.assert_allclose(np.asarray(got_xla), want, rtol=2e-4)


def test_native_go_so_cfar_matches_golden(cfg):
    rng = np.random.default_rng(59)
    power = rng.exponential(
        1.0, (cfg.doppler_fft_size, cfg.range_fft_size)
    )
    power[40, 70] = 700.0
    for kind in ("go", "so"):
        want_hits, want_t = golden.go_so_cfar_2d(
            power, cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa, kind=kind,
            n_pulses=cfg.cfar_pulses_effective,
        )
        got_hits, got_t = native.go_so_cfar_2d(power, cfg, kind=kind)
        np.testing.assert_allclose(got_t, want_t, rtol=1e-9)
        np.testing.assert_array_equal(got_hits, want_hits)


def test_native_go_so_alpha_matches_python():
    from mmradar.golden import go_so_cfar_alpha

    lib = native.load()
    for n, pfa in [(104, 1e-6), (40, 1e-4), (12, 1e-2)]:
        for kind, ki in (("go", 0), ("so", 1)):
            a_py = go_so_cfar_alpha(n, pfa, kind)
            a_c = lib.radar_go_so_cfar_alpha(n, pfa, ki, 1)
            assert abs(a_c - a_py) / a_py < 1e-9, (n, pfa, kind)


def test_native_integrated_alpha_matches_golden():
    from mmradar import golden, native

    for n_p in (1, 2, 4, 8):
        t_c = native.ca_cfar_alpha_integrated(104, 1e-4, n_p)
        t_g = golden.ca_cfar_alpha_integrated(104, 1e-4, n_p)
        # libm lgamma ULP differences flip late bisection branches, so
        # the twins agree to the bisection width, not bit-for-bit
        assert abs(t_c - t_g) <= 1e-10 * t_g, (n_p, t_c, t_g)
    # N = 1 takes the closed form in both: exact
    assert (native.ca_cfar_alpha_integrated(104, 1e-4, 1)
            == golden.ca_cfar_alpha_integrated(104, 1e-4, 1))


def test_native_ca_cfar_respects_n_pulses():
    import dataclasses

    from mmradar import golden, native
    from mmradar.config import RadarConfig

    rng = np.random.default_rng(0)
    p = rng.exponential(1.0, (32, 4, 64, 64)).sum(axis=1)  # Erlang-4 cells
    cfg = dataclasses.replace(RadarConfig(), cfar_n_pulses=4)
    hits_c, thr_c = native.ca_cfar_2d(p[0], cfg)
    hits_g, thr_g = golden.ca_cfar_2d(
        p[0], cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
        cfg.cfar_range_mode, n_pulses=4)
    np.testing.assert_allclose(thr_c, thr_g, rtol=1e-9)
    np.testing.assert_array_equal(hits_c, hits_g)
    # and the matched threshold sits BELOW the single-pulse one (pin
    # cfar_n_pulses=1 explicitly: since round 5 the DEFAULT is the
    # matched auto = num_virtual_rx, which equals 4 here)
    _, thr_1 = native.ca_cfar_2d(
        p[0], dataclasses.replace(RadarConfig(), cfar_n_pulses=1))
    assert thr_c.mean() < thr_1.mean()


def test_native_go_so_integrated_alpha_matches_golden():
    from mmradar.golden import go_so_cfar_alpha

    lib = native.load()
    for n_p in (2, 4):
        for kind, ki in (("go", 0), ("so", 1)):
            a_py = go_so_cfar_alpha(20, 1e-3, kind, n_p)
            a_c = lib.radar_go_so_cfar_alpha(20, 1e-3, ki, n_p)
            assert abs(a_c - a_py) / a_py < 1e-9, (n_p, kind)


def test_native_os_integrated_alpha_matches_golden():
    from mmradar.golden import os_cfar_alpha

    lib = native.load()
    for n_p in (2, 4):
        a_py = os_cfar_alpha(40, 30, 1e-3, n_p)
        a_c = lib.radar_os_cfar_alpha(40, 30, 1e-3, n_p)
        # independent trapezoid grids in the two languages: agree to
        # the quadrature accuracy, not bit-for-bit
        assert abs(a_c - a_py) / a_py < 1e-6, (n_p, a_c, a_py)


def test_native_clutter_map_matches_golden():
    """Native clutter-map CFAR (alpha + full frame-sequence detector)
    == float64 golden, bit-level: the same bisection + MGF-derivative
    series (Erlang n_pulses included), the same block-update recursion
    and pre-update decisions, both seeded and self-seeding forms."""
    from mmradar import golden, native

    for pfa, beta, block, n_p in [(1e-4, 0.25, 1, 1), (1e-3, 0.25, 16, 4),
                                  (1e-4, 0.1, 4, 2)]:
        a_g = golden.clutter_map_alpha(pfa, beta, block, n_p)
        a_c = native.clutter_map_alpha(pfa, beta, block, n_p)
        assert abs(a_c - a_g) / a_g < 1e-12

    rng = np.random.default_rng(5)
    p = rng.gamma(4.0, 1.0, (40, 16, 32))
    for m0 in (None, rng.gamma(4.0, 1.0, (16, 32))):
        h_g, m_g = golden.clutter_map_cfar(p, 1e-3, 0.25, m0, 8, 4)
        h_c, m_c = native.clutter_map_cfar(p, 1e-3, 0.25, m0, 8, 4)
        np.testing.assert_array_equal(h_c, h_g)
        np.testing.assert_allclose(m_c, m_g, rtol=1e-14)
