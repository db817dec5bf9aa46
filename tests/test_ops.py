"""JAX ops vs the float64 golden model, stage by stage."""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.capture import decode_shorts
from mmradar.ops.aoa import angle_fft_spectrum, capon_spectrum, music_spectrum
from mmradar.ops.cfar import ca_cfar_2d
from mmradar.ops.decode import decode_to_cube, rx0_slice
from mmradar.ops.preproc import clutter_subtract_pad
from mmradar.ops.rangefft import range_doppler, range_fft


def test_decode_matches_golden_exactly(cfg, capture):
    got = np.asarray(decode_to_cube(jnp.asarray(capture), cfg))
    want = decode_shorts(capture, cfg)
    # int16 values are exactly representable in float32
    np.testing.assert_array_equal(got.real, want.real.astype(np.float32))
    np.testing.assert_array_equal(got.imag, want.imag.astype(np.float32))


def test_rx0_slice_layout(cfg, capture):
    cube = decode_to_cube(jnp.asarray(capture[0]), cfg)
    rx0 = np.asarray(rx0_slice(cube, cfg))
    want = decode_shorts(capture[0], cfg)[0].reshape(cfg.rx_samples)
    np.testing.assert_array_equal(rx0, want.astype(np.complex64))


def test_clutter_subtract_pad_matches_golden(cfg, capture):
    base64 = golden.base_frame_rx0(capture[0], cfg)
    want = golden.fft_input(capture[1], base64, cfg)

    cube = decode_to_cube(jnp.asarray(capture[1]), cfg)
    base = rx0_slice(decode_to_cube(jnp.asarray(capture[0]), cfg), cfg)
    got = np.asarray(clutter_subtract_pad(rx0_slice(cube, cfg), base, cfg))
    assert got.shape == (cfg.fft_size,)
    # int16 - int16 differences are exact in float32
    np.testing.assert_array_equal(got, want.astype(np.complex64))


def test_range_fft_matches_golden_1e3(cfg, capture):
    base64 = golden.base_frame_rx0(capture[0], cfg)
    want = np.fft.fft(golden.fft_input(capture[1], base64, cfg))

    base = rx0_slice(decode_to_cube(jnp.asarray(capture[0]), cfg), cfg)
    cube = decode_to_cube(jnp.asarray(capture[1]), cfg)
    got = np.asarray(
        range_fft(clutter_subtract_pad(rx0_slice(cube, cfg), base, cfg), cfg)
    )
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-3


def test_range_doppler_matches_golden_1e3(cfg, capture):
    cube64 = decode_shorts(capture[1], cfg) - decode_shorts(capture[0], cfg)
    want = golden.range_doppler_map(cube64, cfg)
    got = np.asarray(range_doppler(jnp.asarray(cube64.astype(np.complex64)), cfg))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-3


def test_cfar_matches_golden(cfg):
    rng = np.random.default_rng(23)
    power = rng.exponential(1.0, (cfg.doppler_fft_size, cfg.range_fft_size)).astype(
        np.float32
    )
    power[50, 100] = 800.0
    power[10, 30] = 600.0
    want_hits, want_thresh = golden.ca_cfar_2d(
        power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
        n_pulses=cfg.cfar_pulses_effective,
    )
    got_hits, got_thresh = ca_cfar_2d(jnp.asarray(power), cfg)
    got_hits, got_thresh = np.asarray(got_hits), np.asarray(got_thresh)
    np.testing.assert_allclose(got_thresh, want_thresh, rtol=1e-4)
    # f32 vs f64 may flip cells sitting exactly on the threshold
    marginal = np.abs(power - want_thresh) < 1e-3 * want_thresh
    disagree = got_hits != want_hits
    assert not np.any(disagree & ~marginal)
    assert got_hits[50, 100] and got_hits[10, 30]


def test_cfar_batched(cfg):
    rng = np.random.default_rng(29)
    power = rng.exponential(
        1.0, (3, cfg.doppler_fft_size, cfg.range_fft_size)
    ).astype(np.float32)
    hits, thresh = ca_cfar_2d(jnp.asarray(power), cfg)
    for i in range(3):
        h_i, t_i = ca_cfar_2d(jnp.asarray(power[i]), cfg)
        np.testing.assert_array_equal(np.asarray(hits[i]), np.asarray(h_i))
        np.testing.assert_allclose(np.asarray(thresh[i]), np.asarray(t_i), rtol=1e-6)


def test_angle_fft_matches_golden(cfg):
    rng = np.random.default_rng(31)
    snap = (
        rng.standard_normal((5, cfg.num_rx)) + 1j * rng.standard_normal((5, cfg.num_rx))
    )
    want = golden.angle_fft(snap, cfg.num_angle_bins, cfg)
    got = np.asarray(angle_fft_spectrum(jnp.asarray(snap.astype(np.complex64)), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_capon_matches_golden(cfg):
    rng = np.random.default_rng(37)
    az = 15.0
    steer = np.exp(
        1j * 2 * np.pi * cfg.rx_spacing_wavelengths
        * np.sin(np.deg2rad(az)) * np.arange(cfg.num_rx)
    )
    sig = rng.standard_normal((64, 1)) + 1j * rng.standard_normal((64, 1))
    snaps = sig * steer + 0.1 * (
        rng.standard_normal((64, cfg.num_rx)) + 1j * rng.standard_normal((64, cfg.num_rx))
    )
    want_angles, want_p = golden.capon_spectrum(snaps, cfg)
    got_angles, got_p = capon_spectrum(jnp.asarray(snaps.astype(np.complex64)), cfg)
    np.testing.assert_allclose(got_angles, want_angles)
    got_p, want_p = np.asarray(got_p), want_p
    # spectra agree in shape; peak location must match
    assert np.argmax(got_p) == np.argmax(want_p)
    np.testing.assert_allclose(
        got_p / got_p.max(), want_p / want_p.max(), rtol=0, atol=1e-2
    )


def test_music_recovers_two_sources(cfg):
    """MUSIC resolves two sources on the 4-element array; golden and device
    implementations agree."""
    rng = np.random.default_rng(77)
    angles_true = [-25.0, 30.0]
    n_snap = 256
    snaps = np.zeros((n_snap, cfg.num_rx), np.complex128)
    for az in angles_true:
        steer = np.exp(
            1j * 2 * np.pi * cfg.rx_spacing_wavelengths
            * np.sin(np.deg2rad(az)) * np.arange(cfg.num_rx)
        )
        sig = rng.standard_normal((n_snap, 1)) + 1j * rng.standard_normal((n_snap, 1))
        snaps += sig * steer
    snaps += 0.05 * (
        rng.standard_normal(snaps.shape) + 1j * rng.standard_normal(snaps.shape)
    )
    want_angles, want_p = golden.music_spectrum(snaps, 2, cfg)
    got_angles, got_p = music_spectrum(
        jnp.asarray(snaps.astype(np.complex64)), 2, cfg
    )
    np.testing.assert_allclose(got_angles, want_angles)
    got_p, want_p = np.asarray(got_p), want_p
    assert np.argmax(got_p) == np.argmax(want_p)
    # both true sources appear as local maxima near truth in both impls
    for p in (want_p, got_p):
        peaks = [
            want_angles[i] for i in range(1, len(p) - 1)
            if p[i] > p[i - 1] and p[i] > p[i + 1] and p[i] > 0.05 * p.max()
        ]
        for az in angles_true:
            assert any(abs(pk - az) <= 4.0 for pk in peaks), (az, peaks)


def test_music_rejects_bad_num_sources(cfg):
    import pytest as _pytest

    snaps = jnp.ones((8, cfg.num_rx), jnp.complex64)
    with _pytest.raises(ValueError):
        music_spectrum(snaps, cfg.num_rx, cfg)
    with _pytest.raises(ValueError):
        golden.music_spectrum(np.ones((8, cfg.num_rx)), 0, cfg)


def test_cfar_range_edges_do_not_wrap(cfg):
    """A strong target hugging range bin 0 must not inflate the noise
    estimate (and thus thresholds) at the far range edge: range is not
    circular.  'wrap' mode keeps the old circular behavior."""
    from mmradar.config import RadarConfig as RC

    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    rng = np.random.default_rng(31)
    power = rng.exponential(1.0, (d, r)).astype(np.float32)
    power[60, 5] = 1e6  # near range edge: in the far edge's training
    # ring under wrap (|dr|=6..10), outside its guard ring

    reflect_cfg = RC(cfar_range_mode="reflect")
    wrap_cfg = RC(cfar_range_mode="wrap")
    _, t_reflect = ca_cfar_2d(jnp.asarray(power), reflect_cfg)
    _, t_wrap = ca_cfar_2d(jnp.asarray(power), wrap_cfg)
    t_reflect, t_wrap = np.asarray(t_reflect), np.asarray(t_wrap)

    # wrap leaks the near-edge target into far-edge thresholds; reflect must not
    assert t_wrap[60, r - 1] > 100 * t_reflect[60, r - 1]
    assert t_reflect[60, r - 1] < 100  # unpolluted noise-level threshold

    # all four twins agree at the edges under the default (reflect) config
    want_hits, want_t = golden.ca_cfar_2d(
        power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
        n_pulses=cfg.cfar_pulses_effective,
    )
    # f32 twins: the 1e6 outlier costs ~3 digits in the (total - inner)
    # cancellation, hence the looser 2e-3 on cells near the target
    np.testing.assert_allclose(
        np.asarray(ca_cfar_2d(jnp.asarray(power), cfg)[1]), want_t, rtol=2e-3
    )
    from mmradar import native

    np.testing.assert_allclose(
        native.ca_cfar_2d(power.astype(np.float64), cfg)[1], want_t, rtol=1e-10
    )


class TestOSCFAR:
    def test_alpha_monotone_and_sane(self):
        from mmradar.golden import os_cfar_alpha

        a1 = os_cfar_alpha(248, 186, 1e-4)
        a2 = os_cfar_alpha(248, 186, 1e-6)
        assert a2 > a1 > 1.0  # stricter pfa -> higher threshold scale

    def test_matches_golden(self, cfg):
        from mmradar.ops.cfar import os_cfar_2d

        rng = np.random.default_rng(41)
        power = rng.exponential(
            1.0, (2, cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        power[0, 50, 100] = 900.0
        want_hits, want_t = golden.os_cfar_2d(
            power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train,
            cfg.cfar_pfa, n_pulses=cfg.cfar_pulses_effective,
        )
        got_hits, got_t = os_cfar_2d(jnp.asarray(power), cfg)
        np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=2e-4)
        assert np.asarray(got_hits)[0, 50, 100]

    def test_false_alarm_rate_bounded(self, cfg):
        """Exponential-cell alpha on raw exponential noise: pin
        cfar_n_pulses=1 (the default auto = num_virtual_rx models
        RX-SUMMED power maps, not this synthetic exp field — the
        matched-default's own Pfa gate is
        test_integrate.test_rx_matched_alpha_realizes_design_pfa)."""
        import dataclasses

        from mmradar.ops.cfar import os_cfar_2d

        c1 = dataclasses.replace(cfg, cfar_n_pulses=1)
        rng = np.random.default_rng(43)
        power = rng.exponential(
            1.0, (4, cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        hits, _ = os_cfar_2d(jnp.asarray(power), c1)
        # pfa=1e-4 over 4*16384 cells -> ~6.5 expected false alarms
        assert np.asarray(hits).sum() <= 60

    def test_os_resists_interferer_in_training_ring(self, cfg):
        """The OS advantage: a second strong target inside the training
        ring biases CA's mean (masking the cell under test) but not the
        3/4-order statistic."""
        from mmradar.ops.cfar import os_cfar_2d

        rng = np.random.default_rng(47)
        power = rng.exponential(
            1.0, (cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        power[60, 60] = 400.0          # cell under test: modest target
        power[60, 66] = 60000.0        # interferer inside the training ring
        ca_hits, _ = ca_cfar_2d(jnp.asarray(power), cfg)
        os_hits, _ = os_cfar_2d(jnp.asarray(power), cfg)
        assert not bool(np.asarray(ca_hits)[60, 60])  # CA masked
        assert bool(np.asarray(os_hits)[60, 60])      # OS detects

    def test_pipeline_with_os_kind(self, cfg, targets):
        from mmradar.config import RadarConfig as RC
        from mmradar.models.rd_pipeline import RDPipeline
        from mmradar.io.synthetic import synthesize_capture

        os_cfg = RC(cfar_kind="os")
        shorts = synthesize_capture(targets, 3, os_cfg, noise_std=2.0, seed=51)
        pipe = RDPipeline(os_cfg, max_detections=8, rd_impl="fused")
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        out = pipe.detect(jnp.asarray(shorts[1:]), base)
        assert np.asarray(out.num_hits).min() > 0


def test_os_cfar_stride_parity_and_pfa(cfg):
    """Decimated OS-CFAR: all three twins agree at stride 4, and the
    recomputed alpha keeps the false-alarm rate bounded."""
    from mmradar.config import RadarConfig as RC
    from mmradar.ops.cfar import os_cfar_2d
    from mmradar import native

    c = RC(cfar_os_stride=4)
    rng = np.random.default_rng(59)
    power = rng.exponential(
        1.0, (c.doppler_fft_size, c.range_fft_size)
    ).astype(np.float64)
    power[50, 100] = 900.0
    want_hits, want_t = golden.os_cfar_2d(
        power, c.cfar_guard, c.cfar_train, c.cfar_pfa, stride=4,
        n_pulses=c.cfar_pulses_effective,
    )
    got_hits, got_t = native.os_cfar_2d(power, c)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-12)
    np.testing.assert_array_equal(got_hits, want_hits)
    _, t_xla = os_cfar_2d(jnp.asarray(power.astype(np.float32)), c)
    np.testing.assert_allclose(np.asarray(t_xla), want_t, rtol=2e-4)
    assert bool(np.asarray(got_hits)[50, 100])
    # pure-noise false alarms still bounded at the decimated alpha
    noise = rng.exponential(1.0, (c.doppler_fft_size, c.range_fft_size))
    h, _ = golden.os_cfar_2d(noise, c.cfar_guard, c.cfar_train, c.cfar_pfa,
                             stride=4)
    assert h.sum() <= 30


def test_cfar_band_matrices_match_padded_boxsum():
    """Band matrices == pad+window-sum ground truth, INCLUDING windows
    wider than the axis (wrap counts cells with multiplicity; reflect
    multi-bounces with period 2n-2) — the regime where a 0/1 mask would
    silently under-count."""
    import numpy as np

    from mmradar.ops.cfar import band_reflect_asym, band_wrap

    rng = np.random.default_rng(0)
    for n, w in [(8, 2), (8, 6), (8, 10), (5, 3), (16, 6), (1, 3)]:
        x = rng.uniform(1.0, 2.0, (n, 7))
        xp_wrap = np.pad(x, ((w, w), (0, 0)), mode="wrap")
        want = np.stack(
            [xp_wrap[i : i + 2 * w + 1].sum(axis=0) for i in range(n)]
        )
        got = band_wrap(n, w) @ x
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"wrap {n},{w}")

        if n > 1:
            xp_ref = np.pad(x, ((w, w), (0, 0)), mode="reflect")
            want = np.stack(
                [xp_ref[i : i + 2 * w + 1].sum(axis=0) for i in range(n)]
            )
            got = band_reflect_asym(n, -w, w) @ x
            np.testing.assert_allclose(
                got, want, rtol=1e-6, err_msg=f"reflect {n},{w}"
            )


def test_cfar_strip_form_exact_identity():
    """The cancellation-free strip form of the GO/SO half-window sums is
    an exact algebraic rewrite of total-minus-inner, with non-negative
    small-integer strip matrices (the rewrite worth carrying into any
    implementation of the band form, ROADMAP)."""
    import numpy as np

    from mmradar.ops.cfar import go_so_band_matrices

    rng = np.random.default_rng(7)
    for cfg_kw in [{}, {"cfar_range_mode": "wrap"},
                   {"cfar_guard": (1, 1), "cfar_train": (2, 2)}]:
        c = RadarConfig(**cfg_kw)
        d, r = 32, 32
        p = rng.exponential(1.0, (d, r))
        p[11, 7] = 1e9  # strong peak: the regime the rewrite protects
        t2, g2, al, alg, bl, blg = (np.asarray(m, np.float64)
                                    for m in go_so_band_matrices(c, d, r))
        # the residual IS the classic form's own f64 cancellation error
        # around the 1e9 peak (~1e-9 relative) — the thing the strip
        # form removes; away from exact zero they agree to f64 roundoff
        np.testing.assert_allclose(
            (t2 - g2) @ p @ al.T + g2 @ p @ (al - alg).T,
            t2 @ p @ al.T - g2 @ p @ alg.T, rtol=1e-8)
        np.testing.assert_allclose(
            (t2 - g2) @ p @ bl.T + g2 @ p @ (bl - blg).T,
            t2 @ p @ bl.T - g2 @ p @ blg.T, rtol=1e-8)
        for m in [t2 - g2, al - alg, bl - blg]:
            assert m.min() >= 0, "strip matrix went negative"
            np.testing.assert_array_equal(m, np.round(m))


# ---------------------------------------------------------------------------
# GOCA / SOCA CFAR


def test_go_so_alpha_identity():
    """Pfa_GO(t) + Pfa_SO(t) = 2*(1+t)^-n: the max/min events partition
    the two-half sample space [Gandhi & Kassam 1988] — solving each kind
    for the same pfa must therefore give t_go > t_so... and the solved t
    must reproduce the target pfa through the closed forms."""
    import math

    from mmradar.golden import go_so_cfar_alpha

    n, pfa = 40, 1e-4
    t_go = go_so_cfar_alpha(n, pfa, "go")
    t_so = go_so_cfar_alpha(n, pfa, "so")
    # SO's min-statistic sits lower, so its multiplier must be larger
    assert t_so > t_go > 0.0

    def pfa_so(t):
        terms = [
            math.lgamma(n + k) - math.lgamma(k + 1) - math.lgamma(n)
            - (n + k) * math.log(2.0 + t)
            for k in range(n)
        ]
        mx = max(terms)
        return 2.0 * math.exp(mx) * sum(math.exp(x - mx) for x in terms)

    assert abs(pfa_so(t_so) - pfa) / pfa < 1e-6
    assert abs((2.0 * (1.0 + t_go) ** (-n) - pfa_so(t_go)) - pfa) / pfa < 1e-6


@pytest.mark.parametrize("kind", ["goca", "soca"])
def test_go_so_cfar_matches_golden(cfg, kind):
    from mmradar.ops.cfar import go_so_cfar_2d

    rng = np.random.default_rng(37)
    power = rng.exponential(
        1.0, (cfg.doppler_fft_size, cfg.range_fft_size)
    ).astype(np.float32)
    power[50, 100] = 800.0
    want_hits, want_thresh = golden.go_so_cfar_2d(
        power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train,
        cfg.cfar_pfa, kind=kind[:2], n_pulses=cfg.cfar_pulses_effective,
    )
    got_hits, got_thresh = go_so_cfar_2d(jnp.asarray(power), cfg, kind[:2])
    got_hits, got_thresh = np.asarray(got_hits), np.asarray(got_thresh)
    np.testing.assert_allclose(got_thresh, want_thresh, rtol=1e-4)
    marginal = np.abs(power - want_thresh) < 1e-3 * want_thresh
    assert not np.any((got_hits != want_hits) & ~marginal)
    assert got_hits[50, 100]


def test_go_so_noise_ordering(cfg):
    """On any map, GO's noise statistic >= SO's pointwise (max vs min of
    the same half sums), so with equal multipliers GO's threshold would
    dominate; with the solved per-kind multipliers both achieve the SAME
    pfa — checked empirically on pure exponential noise."""
    from mmradar.ops.cfar import go_so_cfar_2d

    import dataclasses

    c1 = dataclasses.replace(cfg, cfar_n_pulses=1)  # exp noise -> exp alpha
    rng = np.random.default_rng(41)
    power = rng.exponential(1.0, (64, cfg.doppler_fft_size,
                                  cfg.range_fft_size)).astype(np.float32)
    p = jnp.asarray(power)
    hits_go, _ = go_so_cfar_2d(p, c1, "go")
    hits_so, _ = go_so_cfar_2d(p, c1, "so")
    n_cells = power.size
    # pfa = 1e-6 at defaults; with ~1e6 cells expect O(1) false alarms.
    # Bound loosely: the rates must be within ~30x of pfa, not e.g. 1e-2
    for h in (hits_go, hits_so):
        rate = float(np.asarray(h).sum()) / n_cells
        assert rate < 30.0 * cfg.cfar_pfa, rate


def test_go_so_clutter_edge_behavior(cfg):
    """The motivating scenario: a clutter edge along range.  GOCA takes
    the HOT half's sum as noise, so a cell just inside the cold region
    near the edge is NOT flagged (CA would average hot+cold and fire);
    detection of a strong target well inside the cold region survives."""
    from mmradar.ops.cfar import go_so_cfar_2d

    rng = np.random.default_rng(43)
    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    power = rng.exponential(1.0, (d, r)).astype(np.float32)
    power[:, : r // 2] *= 400.0          # hot clutter in near range
    power[30, r // 2 + 40] = 500.0       # target in the quiet half
    hits_go, _ = go_so_cfar_2d(jnp.asarray(power), cfg, "go")
    hits_go = np.asarray(hits_go)
    assert hits_go[30, r // 2 + 40]
    # cells just past the edge in the cold region: CA fires on the
    # *drop* (mean halves), GO keeps the hot-half estimate -> quiet
    edge_band = hits_go[:, r // 2 : r // 2 + cfg.cfar_guard[1] + 1]
    noise_cells = np.delete(
        edge_band, 30 - 0, axis=0
    )  # exclude the target's Doppler row
    assert noise_cells.mean() < 0.01


def test_go_so_through_pipeline(cfg, capture):
    """cfar_kind='goca'/'soca' runs end-to-end through RDPipeline (fused
    front-end + GO/SO band-matrix CFAR)."""
    from mmradar.models.rd_pipeline import RDPipeline

    for kind in ("goca", "soca"):
        cfg2 = RadarConfig(cfar_kind=kind)
        pipe = RDPipeline(cfg2, max_detections=8, rd_impl="fused")
        base = pipe.prepare_base(jnp.asarray(capture[0]))
        out = pipe.detect(jnp.asarray(capture[1:3]), base)
        assert bool(np.asarray(out.num_hits).max() >= 1)


# ---------------------------------------------------------------------------
# window kinds


def test_window_fn_kinds():
    """Coefficient sanity: hann == the legacy hann_window exactly; all
    kinds are non-negative-ish, peak near the middle, and rect is ones."""
    from mmradar.golden import hann_window, window_fn

    n = 100
    np.testing.assert_array_equal(window_fn(n, "hann"), hann_window(n))
    np.testing.assert_array_equal(window_fn(n, "rect"), np.ones(n))
    for kind in ("hamming", "blackman", "blackmanharris"):
        w = window_fn(n, kind)
        assert w.shape == (n,)
        assert w.min() > -1e-12
        assert abs(np.argmax(w) - n // 2) <= 1
    with pytest.raises(ValueError):
        window_fn(n, "kaiser")


def test_window_kind_sidelobe_ordering():
    """The point of the knob: the windowed DFT matrix's own transform
    (a tone at bin 0 through the dft_matrix path) shows the textbook
    sidelobe ordering — hann ~-31 dB first sidelobe, blackmanharris
    ~-92 dB."""
    from mmradar.ops.dftmat import dft_matrix

    def peak_sidelobe_db(kind, excl):
        # constant input == tone at frequency 0: the spectrum IS the
        # window transform, interpolated on a dense 1024-point grid;
        # ``excl`` masks that window's own main lobe (hann +-2/100 of
        # the axis -> +-20 dense bins; blackmanharris +-4/100 -> +-41)
        f = np.asarray(dft_matrix(100, 1024, windowed=kind))
        spec = np.abs(f @ np.ones(100)) ** 2
        keep = np.ones(1024, bool)
        keep[: excl + 1] = False
        keep[-excl:] = False
        return 10.0 * np.log10(spec[keep].max() / spec.max())

    sl_hann = peak_sidelobe_db("hann", 20)
    sl_bh = peak_sidelobe_db("blackmanharris", 48)
    assert -35.0 < sl_hann < -28.0          # ~-31.5 dB measured/textbook
    assert sl_bh < -85.0                    # ~-92.9 dB measured
    assert sl_bh < sl_hann - 40.0


def test_window_kind_end_to_end_parity(targets):
    """A non-default window kind flows consistently through every path:
    fft == planar == fused, and the RD planes match the golden model
    windowed with the same kind."""
    import dataclasses

    from mmradar import golden as g
    from mmradar.io.capture import decode_shorts
    from mmradar.io.synthetic import synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline
    from mmradar.ops.fuseddft import fused_rd_planes

    cfg2 = RadarConfig(window_kind="blackmanharris")
    shorts = synthesize_capture(targets, 3, cfg2, noise_std=2.0, seed=83)
    det = RDPipeline(cfg2, max_detections=8, rd_impl="fft")
    maps = RDPipeline(cfg2, max_detections=8, rd_impl="planar")
    fused = RDPipeline(cfg2, max_detections=8, rd_impl="fused")
    base = det.prepare_base(jnp.asarray(shorts[0]))
    a = det.detect(jnp.asarray(shorts[1:]), base)
    b = maps.detect(jnp.asarray(shorts[1:]), base)
    c = fused.detect(jnp.asarray(shorts[1:]), base)
    np.testing.assert_array_equal(np.asarray(a.range_bin),
                                  np.asarray(b.range_bin))
    np.testing.assert_array_equal(np.asarray(a.range_bin),
                                  np.asarray(c.range_bin))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(c.valid))

    # golden cross-check of the windowed RD planes
    cube64 = (decode_shorts(shorts[1], cfg2)
              - decode_shorts(shorts[0], cfg2))
    want = g.range_doppler_map(cube64, cfg2)  # uses cfg2.window_kind
    dr, di = fused_rd_planes(jnp.asarray(shorts[1:2]),
                             jnp.asarray(decode_shorts(shorts[0], cfg2)),
                             cfg2)
    got = np.asarray(dr[0]) + 1j * np.asarray(di[0])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-3
