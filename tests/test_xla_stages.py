"""The plain XLA stages the pipelines run — DFT-as-matmul, CA/OS-CFAR,
peak detection, top-K — against the float64 golden model and against
each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import synthesize_cube
from mmradar.ops.cfar import ca_cfar_2d, os_cfar_2d, os_cfar_hits
from mmradar.ops.detect import peak_detect
from mmradar.ops.dftmat import range_doppler_mxu
from mmradar.ops.rangefft import range_doppler

OS_KW = [
    {},
    {"cfar_os_stride": 3},
    {"cfar_range_mode": "wrap"},
    {"cfar_os_k_frac": 0.9},
    {"cfar_guard": (1, 1), "cfar_train": (2, 3)},
]


class TestDFTMatmul:
    def test_matches_fft_path(self, cfg, targets):
        cube = synthesize_cube(targets, 2, cfg, noise_std=1.0, seed=7)
        x = jnp.asarray((cube[1] - cube[0]).astype(np.complex64))
        want = np.asarray(range_doppler(x, cfg))
        got = np.asarray(range_doppler_mxu(x, cfg))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 2e-4

    def test_matches_golden(self, cfg, targets):
        cube = synthesize_cube(targets, 2, cfg, noise_std=1.0, seed=7)
        x64 = cube[1] - cube[0]
        want = golden.range_doppler_map(x64, cfg)
        got = np.asarray(range_doppler_mxu(jnp.asarray(x64.astype(np.complex64)), cfg))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-3

    def test_no_window(self, cfg):
        rng = np.random.default_rng(3)
        x = (rng.standard_normal((cfg.num_chirps, cfg.num_samples))
             + 1j * rng.standard_normal((cfg.num_chirps, cfg.num_samples)))
        want = golden.range_doppler_map(x, cfg, window=False)
        got = np.asarray(
            range_doppler_mxu(jnp.asarray(x.astype(np.complex64)), cfg, window=False)
        )
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


def _golden_ca(power, cfg):
    return golden.ca_cfar_2d(
        power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train,
        cfg.cfar_pfa, cfg.cfar_range_mode,
        n_pulses=cfg.cfar_pulses_effective,
    )


class TestCACFAR:
    def test_matches_golden_batched(self, cfg):
        rng = np.random.default_rng(43)
        power = rng.exponential(
            1.0, (2, cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        power[0, 30, 40] = 900.0
        power[1, 99, 120] = 700.0
        want_hits, want_t = _golden_ca(power, cfg)
        got_hits, got_t = ca_cfar_2d(jnp.asarray(power), cfg)
        np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=1e-4)
        # near-identical thresholds -> hit maps agree except exactly-at-
        # threshold cells
        marginal = np.abs(power - want_t) < 1e-4 * np.abs(want_t)
        disagree = np.asarray(got_hits) != want_hits
        assert not np.any(disagree & ~marginal)
        assert np.asarray(got_hits)[0, 30, 40]
        assert np.asarray(got_hits)[1, 99, 120]

    def test_single_map(self, cfg):
        rng = np.random.default_rng(44)
        power = rng.exponential(
            1.0, (cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        _, want = _golden_ca(power, cfg)
        _, got = ca_cfar_2d(jnp.asarray(power), cfg)
        assert got.shape == power.shape
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4)

    @pytest.mark.parametrize("guard,train,pfa", [
        ((1, 1), (2, 2), 1e-3),
        ((3, 3), (6, 6), 1e-5),
        ((0, 2), (2, 8), 1e-4),
    ])
    def test_param_sweep_matches_golden(self, guard, train, pfa):
        cfg = RadarConfig(cfar_guard=guard, cfar_train=train, cfar_pfa=pfa)
        rng = np.random.default_rng(sum(guard) + sum(train))
        power = rng.exponential(
            1.0, (cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        _, want = _golden_ca(power, cfg)
        _, got = ca_cfar_2d(jnp.asarray(power), cfg)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4)


class TestPeakDetect:
    def test_matches_golden(self, cfg, capture):
        from mmradar.models.range_detector import RangeDetector

        det = RangeDetector(cfg)
        base = det.prepare_base(jnp.asarray(capture[0]))
        spec = det.spectrum(jnp.asarray(capture[1:]), base)
        got = peak_detect(spec, cfg)
        want = golden.detect_capture(capture, cfg)
        np.testing.assert_array_equal(np.asarray(got.peak_bin),
                                      [w.peak_bin for w in want])
        np.testing.assert_allclose(
            np.asarray(got.peak_magnitude),
            [w.peak_magnitude for w in want], rtol=1e-3,
        )

    def test_respects_scan_window(self, cfg):
        # plant the global max OUTSIDE the scan window; it must be ignored
        spec = np.ones((3, cfg.fft_size), np.complex64)
        spec[:, cfg.scan_bins + 10] = 100.0
        spec[0, 5] = 7.0
        spec[1, 100] = 9.0
        spec[2, cfg.scan_bins - 1] = 3.0
        got = peak_detect(jnp.asarray(spec), cfg)
        np.testing.assert_array_equal(
            np.asarray(got.peak_bin), [5, 100, cfg.scan_bins - 1]
        )
        np.testing.assert_allclose(np.asarray(got.peak_magnitude),
                                   [7.0, 9.0, 3.0], rtol=1e-6)

    def test_unbatched(self, cfg):
        spec = np.ones((cfg.fft_size,), np.complex64)
        spec[123] = 50.0
        got = peak_detect(jnp.asarray(spec), cfg)
        assert got.peak_bin.shape == ()
        assert int(got.peak_bin) == 123


class TestTopK:
    """``rd_pipeline.topk_cells``: the static top-K fold of a hit map."""

    def test_matches_sorted_order(self, cfg):
        from mmradar.models.rd_pipeline import topk_cells

        rng = np.random.default_rng(51)
        # distinct values so ordering is unambiguous
        power = rng.permutation(16384 * 3).reshape(3, 128, 128).astype(
            np.float32)
        hits = power > 16384 * 3 - 500
        _, idx, val, valid, d_bin, r_bin = topk_cells(
            jnp.asarray(power), jnp.asarray(hits), 16)
        flat = np.where(hits, power, -np.inf).reshape(3, -1)
        want = np.argsort(-flat, axis=-1, kind="stable")[:, :16]
        np.testing.assert_array_equal(np.asarray(idx), want)
        np.testing.assert_array_equal(
            np.asarray(val), np.take_along_axis(flat, want, axis=-1))
        assert np.asarray(valid).all()
        np.testing.assert_array_equal(np.asarray(d_bin), want // 128)
        np.testing.assert_array_equal(np.asarray(r_bin), want % 128)

    def test_fewer_hits_than_k(self):
        from mmradar.models.rd_pipeline import topk_cells

        power = np.zeros((1, 1, 256), np.float32)
        power[0, 0, 17] = 5.0
        power[0, 0, 200] = 9.0
        n, i, v, valid, _, _ = topk_cells(
            jnp.asarray(power), jnp.asarray(power > 0), 4)
        i, v, valid = np.asarray(i), np.asarray(v), np.asarray(valid)
        assert int(np.asarray(n)[0]) == 2
        assert list(i[0, :2]) == [200, 17]
        assert list(v[0, :2]) == [9.0, 5.0]
        assert list(valid[0]) == [True, True, False, False]
        assert not v[0, 2:].any()  # invalid slots carry power 0

    def test_tie_break_lowest_index(self):
        from mmradar.models.rd_pipeline import topk_cells

        power = np.zeros((1, 1, 128), np.float32)
        power[0, 0, [5, 60, 100]] = 7.0
        _, i, _, _, _, _ = topk_cells(
            jnp.asarray(power), jnp.asarray(power > 0), 3)
        assert list(np.asarray(i)[0]) == [5, 60, 100]

    def test_pipeline_topk_impl_matches(self, cfg, targets):
        """detect() == top-K of its own maps (the tail folds exactly the
        power/hit maps that RDPipeline.maps returns); 'auto' == 'xla'."""
        from mmradar.io.synthetic import synthesize_capture
        from mmradar.models.rd_pipeline import RDPipeline, topk_cells

        shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=53)
        a = RDPipeline(cfg, 8, topk_impl="xla")
        b = RDPipeline(cfg, 8, topk_impl="auto")
        base = a.prepare_base(jnp.asarray(shorts[0]))
        out_a = a.detect(jnp.asarray(shorts[1:]), base)
        out_b = b.detect(jnp.asarray(shorts[1:]), base)
        for la, lb in zip(out_a, out_b):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
        power, hits = a.maps(jnp.asarray(shorts[1:]), base)
        r = cfg.range_fft_size
        hits = hits & (jnp.arange(r) < r - cfg.range_edge_guard_effective)
        n, _, _, valid, d_bin, r_bin = topk_cells(power, hits, 8)
        np.testing.assert_array_equal(np.asarray(out_a.num_hits),
                                      np.asarray(n))
        np.testing.assert_array_equal(np.asarray(out_a.range_bin),
                                      np.asarray(r_bin))
        np.testing.assert_array_equal(np.asarray(out_a.valid),
                                      np.asarray(valid))


def test_topk_exhausted_slots_match_lax(cfg):
    """With fewer hits than K the -inf slots must carry ASCENDING untaken
    indices, exactly like lax.top_k's stable order (regression: a
    knockout selection once re-picked cell 0 for every exhausted slot)."""
    from mmradar.models.rd_pipeline import topk_cells

    m = np.zeros((3, 1, 32), np.float32)
    m[0, 0, 7], m[0, 0, 3] = 5.0, 9.0           # 2 hits
    m[1, 0, 0] = 1.0                            # hit at the tie index
    # row 2: no hits at all
    hits = m > 0
    _, i, _, valid, _, _ = topk_cells(jnp.asarray(m), jnp.asarray(hits), 5)
    flat = jnp.asarray(np.where(hits, m, -np.inf).reshape(3, 32))
    _, i_ref = jax.lax.top_k(flat, 5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(i)[2], np.arange(5))
    assert list(np.asarray(valid).sum(axis=1)) == [2, 1, 0]


def test_mxu_planar_matches_complex(cfg):
    rng = np.random.default_rng(61)
    x = (rng.standard_normal((2, 4, cfg.num_chirps, cfg.num_samples))
         + 1j * rng.standard_normal((2, 4, cfg.num_chirps, cfg.num_samples))
         ).astype(np.complex64)
    a = np.asarray(range_doppler_mxu(jnp.asarray(x), cfg, planar=False))
    b = np.asarray(range_doppler_mxu(jnp.asarray(x), cfg, planar=True))
    assert np.abs(a - b).max() / np.abs(a).max() < 1e-5


def test_range_detector_xla_impl_matches(cfg, capture):
    """detect_impl 'xla' == 'auto' == golden peak bins."""
    from mmradar.models.range_detector import RangeDetector

    a = RangeDetector(cfg, detect_impl="xla")
    b = RangeDetector(cfg, detect_impl="auto")
    base = a.prepare_base(jnp.asarray(capture[0]))
    oa = a.detect(jnp.asarray(capture[1:]), base)
    ob = b.detect(jnp.asarray(capture[1:]), base)
    for la, lb in zip(oa, ob):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    want = golden.detect_capture(capture, cfg)
    np.testing.assert_array_equal(np.asarray(oa.peak_bin),
                                  [w.peak_bin for w in want])
    np.testing.assert_array_equal(np.asarray(oa.rescaled_bin),
                                  [w.rescaled_bin for w in want])


class TestOSCFARForms:
    """The one-pass counting form (``os_cfar_hits``) vs the float64
    golden and the sort form (``os_cfar_2d``)."""

    def _power(self, cfg, frames=2, seed=47):
        rng = np.random.default_rng(seed)
        p = rng.gamma(
            2.0, 100.0, (frames, cfg.doppler_fft_size, cfg.range_fft_size)
        ).astype(np.float32)
        p[0, 50, 100] = 9e5
        return p

    @staticmethod
    def _golden(power, cfg):
        return golden.os_cfar_2d(
            power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train,
            cfg.cfar_pfa, cfg.cfar_os_k_frac, cfg.cfar_range_mode,
            cfg.cfar_os_stride, n_pulses=cfg.cfar_pulses_effective,
        )

    @pytest.mark.parametrize("kw", OS_KW)
    def test_matches_golden(self, kw):
        cfg = RadarConfig(cfar_kind="os", **kw)
        power = self._power(cfg)
        want_hits, want_t = self._golden(power, cfg)
        got = np.asarray(os_cfar_hits(jnp.asarray(power), cfg))
        _, got_t = os_cfar_2d(jnp.asarray(power), cfg)
        np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=2e-4)
        np.testing.assert_array_equal(got, want_hits)
        assert got[0, 50, 100]

    def test_bit_exact_vs_xla_sort(self):
        """Selection by counting and selection by sorting must agree to
        the BIT on the same f32 ring."""
        cfg = RadarConfig(cfar_kind="os")
        power = self._power(cfg, frames=3, seed=11)
        want, _ = os_cfar_2d(jnp.asarray(power), cfg)
        got = os_cfar_hits(jnp.asarray(power), cfg)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_small_single_tile_geometry(self):
        cfg = RadarConfig(
            cfar_kind="os", cfar_guard=(1, 1), cfar_train=(2, 2),
            num_samples=16, num_chirps=16,
        )
        rng = np.random.default_rng(5)
        power = rng.exponential(1.0, (2, 16, 16)).astype(np.float32)
        _, want_t = self._golden(power, cfg)
        hits, t = os_cfar_2d(jnp.asarray(power), cfg)
        np.testing.assert_allclose(np.asarray(t), want_t, rtol=2e-4)
        got = os_cfar_hits(jnp.asarray(power), cfg)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(hits))

    @pytest.mark.parametrize("kw", OS_KW)
    def test_hits_form_matches_threshold_compare(self, kw):
        """The counting form's hit map == power > threshold from the
        sort form, bit-for-bit (the counting identity:
        count(RN(alpha*v) < p) >= k  <=>  p > RN(alpha*T_k))."""
        cfg = RadarConfig(cfar_kind="os", **kw)
        power = self._power(cfg)
        want_hits, _ = os_cfar_2d(jnp.asarray(power), cfg)
        got = os_cfar_hits(jnp.asarray(power), cfg)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want_hits))

    def test_hits_form_exact_tie_is_not_a_hit(self):
        """A cell whose power EQUALS its f32 threshold must not be a hit
        (the gate is strict >), and one ulp above must be — the razor-edge
        case where an inexact reformulation would diverge."""
        cfg = RadarConfig(cfar_kind="os")
        power = self._power(cfg, frames=1, seed=23)
        _, thr = os_cfar_2d(jnp.asarray(power), cfg)
        thr = np.asarray(thr)
        d, r = 40, 60
        for bump, want in [(0, False), (1, True)]:
            p2 = power.copy()
            t = thr[0, d, r]
            # the cell is not in its own training ring, so changing it
            # leaves its own threshold unchanged
            p2[0, d, r] = t if bump == 0 else np.nextafter(
                np.float32(t), np.float32(np.inf)
            )
            got = np.asarray(os_cfar_hits(jnp.asarray(p2), cfg))
            assert bool(got[0, d, r]) is want
            _, thr2 = os_cfar_2d(jnp.asarray(p2), cfg)
            np.testing.assert_array_equal(got, p2 > np.asarray(thr2))

    @pytest.mark.parametrize(
        "kw",
        [
            {},
            {"cfar_range_mode": "wrap"},
            {"cfar_os_k_frac": 0.9},
            {"cfar_guard": (1, 1), "cfar_train": (2, 3)},
            {"num_samples": 48, "num_chirps": 64},   # non-square dims
        ],
    )
    def test_hits_form_edges_match_sort(self, kw):
        """Edge cells, whose windows read the wrap/reflect halo: counting
        form == sort form bit-for-bit with hits planted at every edge."""
        cfg = RadarConfig(cfar_kind="os", **kw)
        d, r = cfg.doppler_fft_size, cfg.range_fft_size
        rng = np.random.default_rng(47)
        power = rng.gamma(2.0, 100.0, (2, d, r)).astype(np.float32)
        for dd, rr in [(0, 0), (0, r - 1), (d - 1, 0), (d - 1, r - 1),
                       (d // 2, r // 2)]:
            power[1, dd, rr] = 8e5
        got = np.asarray(os_cfar_hits(jnp.asarray(power), cfg))
        want = np.asarray(os_cfar_2d(jnp.asarray(power), cfg)[0])
        assert got.any()
        np.testing.assert_array_equal(got, want)

    def test_hits_only_dispatch(self):
        """cfar_detect(hits_only=True) takes the counting form and
        returns no threshold; without the flag it returns the sort
        form's (hits, threshold) — the same hits."""
        from mmradar.ops.cfar import cfar_detect

        cfg = RadarConfig(cfar_kind="os")
        power = self._power(cfg, frames=1)
        hits, thr = cfar_detect(jnp.asarray(power), cfg, hits_only=True)
        assert thr is None
        want, thr_full = cfar_detect(jnp.asarray(power), cfg)
        assert thr_full.shape == power.shape
        np.testing.assert_array_equal(np.asarray(hits), np.asarray(want))

    def test_pipeline_dispatch(self, targets):
        """RDPipeline with cfar_kind='os' (counting form) produces the
        detections the sort form's hit map gives."""
        from mmradar.io.synthetic import synthesize_capture
        from mmradar.models.rd_pipeline import (
            RDPipeline, assemble_result, gather_snapshots,
        )

        cfg = RadarConfig(cfar_kind="os")
        cap = synthesize_capture(targets, 3, cfg, noise_std=5.0, seed=3)
        pipe = RDPipeline(cfg, 16, rd_impl="fft")
        base = pipe.prepare_base(jnp.asarray(cap[0]))
        x = jnp.asarray(cap[1:])
        got = pipe.detect(x, base)
        rd = pipe.rd_cube(x, base)
        power = jnp.sum(rd.real ** 2 + rd.imag ** 2, axis=-3)
        want = assemble_result(power, lambda t: gather_snapshots(rd, t),
                               os_cfar_2d(power, cfg)[0], 16, cfg)
        for f in ("valid", "range_bin", "doppler_bin", "num_hits"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))
