"""Multi-frame tracking over the RD pipeline's detections."""

import jax.numpy as jnp
import numpy as np

from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.models.tracker import (
    Tracker,
    TrackerConfig,
    detections_from_result,
    track_capture,
)


def _det(r, v, a, p=1.0):
    return {"range_m": r, "velocity_mps": v, "azimuth_deg": a, "power": p}


class TestTrackerUnit:
    def test_track_confirm_and_id_stability(self, cfg):
        tr = Tracker(cfg)
        dt = tr.frame_interval_s
        confirmed = tr.update([_det(5.0, 2.0, 10.0)])
        assert confirmed == []  # tentative after 1 hit
        confirmed = tr.update([_det(5.0 + 2.0 * dt, 2.0, 10.0)])
        assert confirmed == []  # still tentative (confirm_hits = 3)
        confirmed = tr.update([_det(5.0 + 4.0 * dt, 2.0, 10.0)])
        assert len(confirmed) == 1
        tid = confirmed[0].track_id
        for i in range(2, 6):
            confirmed = tr.update([_det(5.0 + 2.0 * dt * i, 2.0, 10.0)])
        assert len(confirmed) == 1
        assert confirmed[0].track_id == tid
        assert abs(confirmed[0].velocity_mps - 2.0) < 0.5

    def test_two_targets_two_tracks(self, cfg):
        tr = Tracker(cfg)
        for i in range(4):
            confirmed = tr.update([_det(5.0, 1.0, 10.0), _det(9.0, -2.0, -30.0)])
        assert len(confirmed) == 2
        ranges = sorted(t.range_m for t in confirmed)
        assert abs(ranges[0] - 5.0) < 0.3 and abs(ranges[1] - 9.0) < 0.5

    def test_track_coasts_then_dies(self, cfg):
        params = TrackerConfig(confirm_hits=2, max_misses=2)
        tr = Tracker(cfg, params)
        tr.update([_det(5.0, 0.0, 0.0)])
        tr.update([_det(5.0, 0.0, 0.0)])
        assert len(tr.tracks) == 1
        tr.update([])  # miss 1
        tr.update([])  # miss 2 — still coasting
        assert len(tr.tracks) == 1
        tr.update([])  # miss 3 — deleted
        assert len(tr.tracks) == 0

    def test_clutter_not_confirmed(self, cfg):
        """One-off detections at random places never confirm."""
        rng = np.random.default_rng(3)
        tr = Tracker(cfg)
        for i in range(6):
            confirmed = tr.update([
                _det(float(rng.uniform(1, 15)), float(rng.uniform(-5, 5)),
                     float(rng.uniform(-60, 60)))
            ])
        assert confirmed == []


class TestTrackerEndToEnd:
    def test_tracks_synthetic_scene(self, cfg, targets):
        shorts = synthesize_capture(targets, 9, cfg, noise_std=2.0, seed=42)
        pipe = RDPipeline(cfg, max_detections=8)
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        out = pipe.detect(jnp.asarray(shorts[1:]), base)
        tracker = track_capture(out, cfg)
        confirmed = [t for t in tracker.tracks if t.confirmed]
        assert len(confirmed) >= 2
        # both scene targets tracked at roughly the right kinematics
        frame_interval = cfg.num_chirps * cfg.chirp_interval_s
        for tgt in targets:
            expect_r = tgt.range_m + tgt.velocity_mps * frame_interval * 8
            best = min(confirmed, key=lambda t: abs(t.range_m - expect_r))
            assert abs(best.range_m - expect_r) < 1.0
            assert abs(best.velocity_mps - tgt.velocity_mps) < 1.0
            assert abs(best.azimuth_deg - tgt.azimuth_deg) < 12.0

    def test_detections_from_result_shape(self, cfg, targets):
        shorts = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=1)
        pipe = RDPipeline(cfg, max_detections=8)
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        out = pipe.detect(jnp.asarray(shorts[1:]), base)
        dets = detections_from_result(out, 0)
        assert dets and all(
            set(d) == {"range_m", "velocity_mps", "azimuth_deg", "power"}
            for d in dets
        )


class TestPeakGrouping:
    def test_sidelobes_collapse_to_strongest(self):
        from mmradar.models.tracker import group_peaks

        dets = [
            _det(5.0, 2.0, 15.0, p=100.0),
            _det(5.4, 2.0, 15.0, p=40.0),   # range sidelobe
            _det(5.0, 2.2, 15.0, p=30.0),   # doppler sidelobe
            _det(9.0, -1.0, -30.0, p=80.0),
            _det(8.6, -1.0, -30.0, p=20.0),
        ]
        kept = group_peaks(dets)
        assert len(kept) == 2
        assert kept[0]["power"] == 100.0 and kept[1]["power"] == 80.0

    def test_distinct_targets_survive(self):
        from mmradar.models.tracker import group_peaks

        dets = [_det(5.0, 2.0, 0.0, p=10.0), _det(5.0, -2.0, 0.0, p=9.0)]
        assert len(group_peaks(dets)) == 2  # same range, opposite velocity

    def test_materialize_result_is_numpy(self, cfg, targets):
        from mmradar.models.tracker import materialize_result

        shorts = synthesize_capture(targets, 2, cfg, noise_std=2.0, seed=2)
        pipe = RDPipeline(cfg, max_detections=4)
        base = pipe.prepare_base(jnp.asarray(shorts[0]))
        out = materialize_result(pipe.detect(jnp.asarray(shorts[1:]), base))
        assert all(isinstance(l, np.ndarray) for l in out)
        # idempotent
        out2 = materialize_result(out)
        np.testing.assert_array_equal(out.range_bin, out2.range_bin)


class TestEKFTracker:
    def _make(self, cfg):
        from mmradar.models.tracker import EKFConfig, EKFTracker

        return EKFTracker(cfg, EKFConfig())

    def test_radial_target_converges(self, cfg):
        """Constant radial velocity: EKF locks on and predicts range."""
        tr = self._make(cfg)
        dt = cfg.num_chirps * cfg.chirp_interval_s
        r0, v = 8.0, -3.0
        for f in range(20):
            r = r0 + v * f * dt
            tr.update([{"range_m": round(r / 0.39) * 0.39,
                        "velocity_mps": v, "azimuth_deg": 0.0,
                        "power": 1e9}], dt)
        (t,) = [x for x in tr.tracks if x.confirmed]
        assert abs(t.range_m - (r0 + v * 19 * dt)) < 0.5
        assert abs(t.velocity_mps - v) < 0.4
        assert abs(t.azimuth_deg) < 3.0

    def test_crossing_target_single_track(self, cfg):
        """A target crossing the boresight (pure tangential motion: range
        dips, Doppler flips sign, azimuth sweeps) stays ONE track in the
        Cartesian model and its vector speed is recovered — the case the
        polar alpha-beta filter fragments."""
        import numpy as np
        from mmradar.models.tracker import EKFTracker, EKFConfig

        tr = EKFTracker(cfg, EKFConfig())
        dt = cfg.num_chirps * cfg.chirp_interval_s
        # Cartesian truth: crosses x = -2 .. +2 m at y = 6 m, 12 m/s
        speed = 12.0
        steps = 40
        ids = set()
        for f in range(steps):
            x = -2.0 + speed * f * dt
            y = 6.0
            r = float(np.hypot(x, y))
            vr = (x * speed) / r  # radial component of (vx=speed, vy=0)
            az = float(np.rad2deg(np.arctan2(x, y)))
            tr.update([{"range_m": r, "velocity_mps": vr,
                        "azimuth_deg": az, "power": 1e9}], dt)
            ids |= {t.track_id for t in tr.tracks if t.confirmed}
        assert len(ids) == 1  # no fragmentation
        (t,) = [x for x in tr.tracks if x.confirmed]
        assert abs(t.speed_mps - speed) < 2.5
        # final azimuth tracks the sweep
        x_end = -2.0 + speed * (steps - 1) * dt
        az_end = float(np.rad2deg(np.arctan2(x_end, 6.0)))
        assert abs(t.azimuth_deg - az_end) < 4.0

    def test_mahalanobis_gate_rejects_far_detection(self, cfg):
        tr = self._make(cfg)
        dt = cfg.num_chirps * cfg.chirp_interval_s
        for _ in range(4):
            tr.update([{"range_m": 5.0, "velocity_mps": 0.0,
                        "azimuth_deg": 0.0, "power": 1e9}], dt)
        n_before = len(tr.tracks)
        tr.update([{"range_m": 14.0, "velocity_mps": 0.0,
                    "azimuth_deg": 40.0, "power": 1e9}], dt)
        # far detection spawns a NEW tentative track, never updates the old
        assert len(tr.tracks) == n_before + 1
        old = [t for t in tr.tracks if t.confirmed][0]
        assert abs(old.range_m - 5.0) < 0.5

    def test_coast_and_delete(self, cfg):
        from mmradar.models.tracker import EKFConfig, EKFTracker

        tr = EKFTracker(cfg, EKFConfig(max_misses=2))
        dt = cfg.num_chirps * cfg.chirp_interval_s
        for _ in range(3):
            tr.update([{"range_m": 5.0, "velocity_mps": -2.0,
                        "azimuth_deg": 10.0, "power": 1e9}], dt)
        for _ in range(3):
            tr.update([], dt)
        assert not tr.tracks  # deleted after max_misses

    def test_track_capture_kind_ekf(self, cfg, capture):
        import jax.numpy as jnp
        from mmradar.models.rd_pipeline import RDPipeline
        from mmradar.models.tracker import track_capture

        pipe = RDPipeline(cfg, max_detections=8)
        base = pipe.prepare_base(jnp.asarray(capture[0]))
        out = pipe.detect(jnp.asarray(capture[1:]), base)
        tracker = track_capture(out, cfg, kind="ekf")
        confirmed = [t for t in tracker.tracks if t.confirmed]
        assert len(confirmed) == 2  # the two conftest targets
        ranges = sorted(t.range_m for t in confirmed)
        assert abs(ranges[0] - 3.0) < 0.8 and abs(ranges[1] - 8.0) < 0.8

    def test_track_capture_validates_kind_and_params(self, cfg, capture):
        import jax.numpy as jnp
        import pytest

        from mmradar.models.rd_pipeline import RDPipeline
        from mmradar.models.tracker import (
            EKFConfig, TrackerConfig, track_capture,
        )

        pipe = RDPipeline(cfg, max_detections=8)
        base = pipe.prepare_base(jnp.asarray(capture[0]))
        out = pipe.detect(jnp.asarray(capture[1:3]), base)
        with pytest.raises(ValueError, match="kind"):
            track_capture(out, cfg, kind="EKF")  # typo'd case
        with pytest.raises(ValueError, match="EKFConfig"):
            track_capture(out, cfg, params=TrackerConfig(), kind="ekf")
        with pytest.raises(ValueError, match="TrackerConfig"):
            track_capture(out, cfg, params=EKFConfig(), kind="alpha-beta")


def test_cli_confirm_hits_override(tmp_path):
    """--confirm-hits 2 confirms on a capture too short for the
    round-5 default of 3; bad values are usage errors."""
    import json

    from mmradar import cli

    path = tmp_path / "c.bin"
    assert cli.main(["generate", str(path), "--frames", "3",
                     "--target", "5.0,2.0,10,2500", "--seed", "4"]) == 0
    out = tmp_path / "t.jsonl"
    # 2 post-base frames: default confirm_hits=3 cannot confirm
    assert cli.main(["track", str(path), "--out", str(out)]) == 0
    assert out.read_text().strip() == ""
    assert cli.main(["track", str(path), "--out", str(out),
                     "--confirm-hits", "2"]) == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    # the target confirms at M=2 (2-hit confirmation also lets a
    # deterministic quantization spur through on this scene — exactly
    # the failure mode the round-5 M=3 default exists to filter, so
    # assert presence, not an exact track count)
    assert any(abs(r["history"][-1][0] - 5.0) < 1.0 for r in recs)
    assert cli.main(["track", str(path), "--confirm-hits", "0"]) == 2
