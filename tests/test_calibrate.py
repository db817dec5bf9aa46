"""Per-channel array calibration: estimation + application.

The reference has no calibration story (single-RX0 processing,
acceleration.cu:469-475 slices one antenna); real multi-channel radar
needs per-chain gain/phase correction before any angle estimate.  The
framework models the imperfection in the generator (``rx_response``),
estimates the correction from a boresight capture
(``golden.estimate_rx_cal``) and applies it at every snapshot
chokepoint via ``cfg.rx_cal``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline, apply_rx_cal


# a deliberately ugly channel response: up to 2 dB gain spread and
# +/- 40 deg phase errors -- enough to visibly bias the angle FFT
IMBALANCE = np.array(
    [1.0, 1.26 * np.exp(1j * np.deg2rad(35.0)),
     0.79 * np.exp(-1j * np.deg2rad(40.0)),
     1.12 * np.exp(1j * np.deg2rad(-18.0))]
)


def _golden_cal_snapshots(shorts, cfg):
    """Boresight-target snapshots per frame via the f64 golden path."""
    cube = golden.virtual_cube(
        decode(shorts[1:], cfg) - decode(shorts[:1], cfg), cfg
    )
    rd = golden.range_doppler_map(cube, cfg)        # (N, V, D, R)
    power = (np.abs(rd) ** 2).sum(axis=1)           # (N, D, R)
    snaps, dbins = [], []
    for f in range(rd.shape[0]):
        d, r = np.unravel_index(np.argmax(power[f]), power[f].shape)
        snaps.append(rd[f, :, d, r])
        dbins.append(d)
    return golden.mimo_doppler_compensate(
        np.asarray(snaps), np.asarray(dbins), cfg
    )


def decode(shorts, cfg):
    from mmradar.io.capture import decode_shorts

    return decode_shorts(shorts, cfg)


class TestEstimator:
    def test_recovers_known_imbalance_ideal_snapshots(self):
        """On noise-free model snapshots the correction must invert the
        injected response exactly (up to the common channel-0 scalar)."""
        cfg = RadarConfig()
        rng = np.random.default_rng(7)
        s = rng.standard_normal(12) + 1j * rng.standard_normal(12)
        az = 14.0
        pos = cfg.virtual_positions_wl()
        a = np.exp(2j * np.pi * pos[:, 0] * np.sin(np.deg2rad(az)))
        snaps = IMBALANCE[None, :] * a[None, :] * s[:, None]
        cal = golden.estimate_rx_cal(snaps, azimuth_deg=az, cfg=cfg)
        fixed = cal * IMBALANCE
        # calibrated response == common scalar * ideal (here: g_0)
        np.testing.assert_allclose(fixed, np.full(4, fixed[0]), rtol=1e-12)
        assert cal[0] == pytest.approx(1.0)

    def test_estimate_from_synthetic_boresight_capture(self):
        cfg = RadarConfig()
        shorts = synthesize_capture(
            [SceneTarget(range_m=6.0, velocity_mps=0.0, azimuth_deg=0.0,
                         amplitude=4000.0)],
            5, cfg, noise_std=1.0, seed=3, rx_response=IMBALANCE,
        )
        cal = golden.estimate_rx_cal(_golden_cal_snapshots(shorts, cfg),
                                     azimuth_deg=0.0, cfg=cfg)
        fixed = cal * IMBALANCE
        np.testing.assert_allclose(
            np.abs(fixed), np.abs(fixed[0]), rtol=2e-2
        )
        np.testing.assert_allclose(
            np.angle(fixed / fixed[0]), 0.0, atol=0.03
        )


class TestApplication:
    def test_apply_rx_cal_twins_and_identity(self):
        cfg = RadarConfig(rx_cal=tuple(1.0 / IMBALANCE))
        rng = np.random.default_rng(0)
        snaps = rng.standard_normal((3, 5, 4)) + 1j * rng.standard_normal((3, 5, 4))
        g = golden.apply_rx_cal(snaps, cfg)
        j = apply_rx_cal(jnp.asarray(snaps, jnp.complex64), cfg)
        np.testing.assert_allclose(np.asarray(j), g, rtol=1e-6)
        base = RadarConfig()
        np.testing.assert_array_equal(golden.apply_rx_cal(snaps, base), snaps)

    def test_pipeline_azimuth_restored(self):
        """End-to-end: an imbalanced array biases the azimuth; applying
        the estimated correction restores it to the matched-array value."""
        cfg = RadarConfig()
        tgt = [SceneTarget(range_m=7.0, velocity_mps=1.5, azimuth_deg=22.0,
                           amplitude=3000.0)]
        kw = dict(noise_std=1.0, seed=11)
        clean = synthesize_capture(tgt, 3, cfg, **kw)
        skew = synthesize_capture(tgt, 3, cfg, rx_response=IMBALANCE, **kw)
        cal_cap = synthesize_capture(
            [SceneTarget(range_m=5.0, velocity_mps=0.0, azimuth_deg=0.0,
                         amplitude=4000.0)],
            4, cfg, noise_std=1.0, seed=5, rx_response=IMBALANCE,
        )
        cal = golden.estimate_rx_cal(_golden_cal_snapshots(cal_cap, cfg),
                                     azimuth_deg=0.0, cfg=cfg)

        def peak_az(capture, c):
            pipe = RDPipeline(c, max_detections=4)
            base = pipe.prepare_base(jnp.asarray(capture[0]))
            out = pipe.detect(jnp.asarray(capture[1:]), base)
            k = int(jnp.argmax(out.power[0]))
            return float(out.azimuth_deg[0, k])

        az_true = peak_az(clean, cfg)
        az_skew = peak_az(skew, cfg)
        az_cal = peak_az(skew, RadarConfig(rx_cal=tuple(cal)))
        assert abs(az_true - tgt[0].azimuth_deg) < 3.0
        # the injected imbalance must actually bias the estimate
        # (otherwise this test has no teeth)
        assert abs(az_skew - az_true) > 4.0
        assert abs(az_cal - az_true) < 1.5

    def test_mimo_tiled_cal_and_validation(self):
        cfg = RadarConfig(num_tx=2, rx_cal=tuple(1.0 / IMBALANCE))
        vec = cfg.rx_cal_vector()
        assert vec.shape == (8,)
        np.testing.assert_allclose(vec[:4], vec[4:])
        with pytest.raises(ValueError, match="rx_cal"):
            RadarConfig(rx_cal=(1.0, 1.0, 1.0))

    def test_azmap_calibrated(self):
        """The scene-level range-azimuth map folds the correction into
        its host constants — peak angle must match the clean scene's."""
        from mmradar.ops.aoa import range_azimuth_from_shorts, angle_bins_deg

        cfg = RadarConfig()
        tgt = [SceneTarget(range_m=8.0, velocity_mps=0.8, azimuth_deg=-28.0,
                           amplitude=3000.0)]
        kw = dict(noise_std=1.0, seed=13)
        clean = synthesize_capture(tgt, 2, cfg, **kw)
        skew = synthesize_capture(tgt, 2, cfg, rx_response=IMBALANCE, **kw)
        cal_cap = synthesize_capture(
            [SceneTarget(range_m=5.0, velocity_mps=0.0, azimuth_deg=0.0,
                         amplitude=4000.0)],
            4, cfg, noise_std=1.0, seed=5, rx_response=IMBALANCE,
        )
        cal = golden.estimate_rx_cal(_golden_cal_snapshots(cal_cap, cfg),
                                     azimuth_deg=0.0, cfg=cfg)
        ccfg = RadarConfig(rx_cal=tuple(cal))

        def peak_angle(capture, c):
            from mmradar.ops.decode import decode_to_cube

            base = decode_to_cube(jnp.asarray(capture[0]), c)
            m = np.asarray(range_azimuth_from_shorts(
                jnp.asarray(capture[1:]), base, c))
            ang = angle_bins_deg(c)
            return float(ang[np.argmax(m[0].max(axis=-1))])

        a_true = peak_angle(clean, cfg)
        a_cal = peak_angle(skew, ccfg)
        assert abs(a_cal - a_true) < 3.5
