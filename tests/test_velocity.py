"""TDM velocity disambiguation (phase-hypothesis test).

TDM-MIMO divides the unambiguous velocity by num_tx (the per-TX PRF is
1/(num_tx*Tr)); the hypothesis test recovers the full single-TX span by
picking the TDM compensation that keeps the virtual array coherent.
Golden truth: ``golden.disambiguate_velocity``; jnp twin:
``ops.aoa.disambiguate_velocity``; pipeline: ``RDPipeline.disambiguate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline


@pytest.fixture(scope="module")
def mcfg() -> RadarConfig:
    return RadarConfig(num_tx=2)


def _synth_snapshot(mcfg, fd_true, az_deg, d_bin):
    """Analytic virtual-array snapshot of a target whose TRUE Doppler is
    ``fd_true`` while the map measured (fftshifted) bin ``d_bin`` — the
    TDM phase on TX t's elements follows the TRUE Doppler."""
    v = mcfg.num_virtual_rx
    k = 2.0 * np.pi * mcfg.rx_spacing_wavelengths
    steer = np.exp(1j * k * np.sin(np.deg2rad(az_deg)) * np.arange(v))
    tx_idx = np.arange(v) // mcfg.num_rx
    tdm = np.exp(1j * 2.0 * np.pi * fd_true * tx_idx * mcfg.chirp_interval_s)
    return steer * tdm


class TestGolden:
    def test_recovers_aliased_doppler(self, mcfg):
        ts = mcfg.slow_time_interval_s
        d = mcfg.doppler_fft_size
        # true Doppler one per-TX PRF above what the map can represent
        d_bin = 40
        fd_meas = (d_bin - d // 2) / (d * ts)
        fd_true = fd_meas + 1.0 / ts
        snaps = _synth_snapshot(mcfg, fd_true, 12.0, d_bin)
        vel, h, comp = golden.disambiguate_velocity(
            snaps, np.asarray(d_bin), mcfg
        )
        lim = 1.0 / (2.0 * mcfg.chirp_interval_s)
        want_fd = np.mod(fd_true + lim, 2 * lim) - lim
        assert int(h) == 1
        assert abs(float(vel) - want_fd * mcfg.wavelength_m / 2.0) < 1e-9
        # the winning compensation restores the pure steering vector
        spec = golden.angle_fft(comp, mcfg.num_angle_bins, mcfg)
        az = golden.angle_bin_to_deg(
            np.argmax(np.abs(spec)), mcfg.num_angle_bins, mcfg
        )
        assert abs(float(az) - 12.0) < 3.0

    def test_unaliased_keeps_hypothesis_zero(self, mcfg):
        ts = mcfg.slow_time_interval_s
        d = mcfg.doppler_fft_size
        d_bin = 40
        fd_true = (d_bin - d // 2) / (d * ts)
        snaps = _synth_snapshot(mcfg, fd_true, -20.0, d_bin)
        vel, h, _ = golden.disambiguate_velocity(
            snaps, np.asarray(d_bin), mcfg
        )
        assert int(h) == 0
        assert abs(float(vel) - fd_true * mcfg.wavelength_m / 2.0) < 1e-9

    def test_single_tx_passthrough(self):
        cfg = RadarConfig()
        snaps = _synth_snapshot(cfg, 100.0, 0.0, 70)
        vel, h, comp = golden.disambiguate_velocity(
            snaps, np.asarray(70), cfg
        )
        assert int(h) == 0
        np.testing.assert_array_equal(comp, snaps)


def test_jnp_twin_matches_golden(mcfg):
    from mmradar.ops.aoa import disambiguate_velocity

    rng = np.random.default_rng(3)
    snaps = (rng.normal(size=(2, 5, mcfg.num_virtual_rx))
             + 1j * rng.normal(size=(2, 5, mcfg.num_virtual_rx)))
    d_bin = rng.integers(0, mcfg.doppler_fft_size, size=(2, 5))
    want_v, want_h, want_s = golden.disambiguate_velocity(snaps, d_bin, mcfg)
    got_v, got_h, got_s = disambiguate_velocity(
        jnp.asarray(snaps, jnp.complex64), jnp.asarray(d_bin, jnp.int32), mcfg
    )
    np.testing.assert_array_equal(np.asarray(got_h), want_h)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), want_s, rtol=1e-3,
                               atol=1e-3 * np.abs(want_s).max())


class TestPipeline:
    @pytest.fixture(scope="class")
    def fast_capture(self, mcfg):
        """One mover beyond the per-TX limit (7.6 m/s) + one inside it."""
        return synthesize_capture(
            [
                SceneTarget(range_m=5.0, velocity_mps=10.0, azimuth_deg=15.0,
                            amplitude=2500.0),
                SceneTarget(range_m=9.0, velocity_mps=-3.0, azimuth_deg=-25.0,
                            amplitude=2000.0),
            ],
            num_frames=3, cfg=mcfg, noise_std=2.0, seed=11,
        )

    def test_extended_span_recovered(self, mcfg, fast_capture):
        pipe = RDPipeline(mcfg, max_detections=8)
        shorts = jnp.asarray(fast_capture[1:2])
        base = pipe.prepare_base(jnp.asarray(fast_capture[0]))
        out = pipe.detect(shorts, base)
        valid = np.asarray(out.valid)[0]
        vels = np.asarray(out.velocity_mps)[0]
        ranges = np.asarray(out.range_m)[0]
        # the 10 m/s target wraps to ~10 - 15.2 = -5.2 m/s in the map
        near5 = [k for k in range(8) if valid[k] and abs(ranges[k] - 5.0) < 1.0]
        assert near5 and all(vels[k] < 0 for k in near5)

        vel_x, az_x, hyp = pipe.disambiguate(
            shorts, base, out.doppler_bin, out.range_bin
        )
        vel_x, az_x, hyp = map(np.asarray, (vel_x, az_x, hyp))
        k5 = near5[0]
        assert abs(vel_x[0, k5] - 10.0) < 1.0
        assert hyp[0, k5] == 1
        assert abs(az_x[0, k5] - 15.0) < 6.0
        # the slow target is untouched (hypothesis 0, same velocity)
        near9 = [k for k in range(8) if valid[k] and abs(ranges[k] - 9.0) < 1.0]
        assert near9
        k9 = near9[0]
        assert hyp[0, k9] == 0
        assert abs(vel_x[0, k9] - vels[k9]) < 0.3
        assert abs(vel_x[0, k9] + 3.0) < 1.0

    def test_cli_track_disambiguate(self, tmp_path, mcfg, capsys):
        """Track states carry the TRUE velocity past the TDM limit."""
        import json

        from mmradar import cli
        from mmradar.io.capture import write_capture

        capture = synthesize_capture(
            [SceneTarget(range_m=5.0, velocity_mps=10.0, azimuth_deg=15.0,
                         amplitude=2500.0)],
            num_frames=6, cfg=mcfg, noise_std=2.0, seed=12,
        )
        cap = tmp_path / "fast_track.bin"
        write_capture(str(cap), capture, mcfg)
        rc = cli.main(["track", str(cap), "--num-tx", "2", "--disambiguate"])
        assert rc == 0
        lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
        tracks = [json.loads(l) for l in lines]
        assert tracks
        assert any(abs(t["velocity_mps"] - 10.0) < 1.5 for t in tracks)

    def test_cli_serve_disambiguate(self, mcfg, serve_over_udp):
        """Served velocities cover the extended span (frame 0 = base)."""
        capture = synthesize_capture(
            [SceneTarget(range_m=5.0, velocity_mps=10.0, azimuth_deg=15.0,
                         amplitude=2500.0)],
            num_frames=5, cfg=mcfg, noise_std=2.0, seed=13,
        )
        recs = serve_over_udp(capture, ["--num-tx", "2", "--disambiguate"])
        dets = [d for r in recs if "frame" in r for d in r["detections"]]
        fast = [d for d in dets if abs(d["range_m"] - 5.0) < 1.0]
        assert fast and any(abs(d["velocity_mps"] - 10.0) < 1.0 for d in fast)
        # the interp field shifts by the same hypothesis offset — the
        # two velocity estimates must agree to sub-bin resolution
        assert all(abs(d["velocity_mps"] - d["velocity_mps_interp"]) < 0.5
                   for d in fast)

    def test_cli_disambiguate_flag(self, tmp_path, mcfg, fast_capture):
        import json

        from mmradar import cli
        from mmradar.io.capture import write_capture

        cap = tmp_path / "fast.bin"
        write_capture(str(cap), fast_capture)
        out = tmp_path / "dets.jsonl"
        rc = cli.main([
            "detect", str(cap), "--full", "--disambiguate",
            "--num-tx", "2", "--out", str(out),
        ])
        assert rc == 0
        recs = [json.loads(l) for l in out.read_text().splitlines()]
        dets = [d for r in recs for d in r.get("detections", [])]
        assert all("doppler_hypothesis" in d for d in dets)
        fast = [d for d in dets if abs(d["range_m"] - 5.0) < 1.0]
        assert fast and any(abs(d["velocity_mps"] - 10.0) < 1.0 for d in fast)
