"""Pd/Pfa evaluation harness: the closed loop on the CFAR alpha
derivations.  Runs on the CPU backend with a small geometry so the
statistics are quick; rates are gated loosely (FFT-windowed map cells
are correlated, which the textbook derivations ignore)."""

import json

import numpy as np
import pytest

from mmradar.config import RadarConfig
from mmradar.evaluate import expected_bins, measure_pfa, pd_curve


@pytest.fixture(scope="module")
def small_cfg():
    return RadarConfig(num_samples=64, num_chirps=64, num_rx=2,
                       cfar_pfa=1e-4)


def test_expected_bins_roundtrip(small_cfg):
    """expected_bins inverts cell_physics to within a bin."""
    import jax.numpy as jnp

    from mmradar.models.rd_pipeline import cell_physics

    d, r = expected_bins(6.0, 2.0, small_cfg)
    rng_m, vel = cell_physics(jnp.asarray(d), jnp.asarray(r), small_cfg)
    # bin quantization: within one bin's worth of each quantity
    r_res = float(cell_physics(jnp.asarray(0), jnp.asarray(1),
                               small_cfg)[0])
    v_res = abs(float(cell_physics(jnp.asarray(small_cfg.doppler_fft_size
                                               // 2 + 1),
                                   jnp.asarray(0), small_cfg)[1]))
    assert abs(float(rng_m) - 6.0) <= r_res
    assert abs(float(vel) - 2.0) <= v_res


@pytest.mark.parametrize("kind", ["ca", "goca", "soca"])
def test_measured_pfa_near_configured(small_cfg, kind):
    import dataclasses

    cfg = dataclasses.replace(small_cfg, cfar_kind=kind)
    out = measure_pfa(cfg, frames=24, seed=3)
    # 24 frames x 64x64 cells ~ 98k cells at pfa 1e-4 -> ~10 expected
    # false alarms; gate within ~20x either way (correlated cells)
    assert out["pfa_measured"] < 20 * cfg.cfar_pfa
    assert out["hits"] >= 0


def test_mti_mode_pfa_and_pd(small_cfg):
    """The eval harness closes the loop on the MTI modes too: Pfa stays
    near the configured rate on target-free noise (the canceller is
    linear, so the CFAR alpha derivation still applies to the filtered
    map), and a strong MOVER keeps Pd == 1.0 through the notch."""
    import dataclasses

    cfg = dataclasses.replace(small_cfg, clutter_mode="mti2")
    out = measure_pfa(cfg, frames=24, seed=3)
    assert out["pfa_measured"] < 20 * cfg.cfar_pfa
    pts = pd_curve(cfg, amplitudes=(2000.0,), frames=16, velocity_mps=2.0,
                   noise_std=20.0, seed=5)
    assert pts[-1].pd == 1.0


def test_pd_curve_monotone_ends(small_cfg):
    pts = pd_curve(small_cfg, amplitudes=(2.0, 2000.0), frames=16,
                   noise_std=20.0, seed=5)
    assert pts[0].pd <= 0.5          # buried target: mostly missed
    assert pts[-1].pd == 1.0         # strong target: always detected


def test_pd_curve_tracks_moving_truth(small_cfg):
    """The truth cell is propagated per frame: a strong fast target
    stays Pd == 1.0 even once its motion exceeds tol_bins of range
    drift (a static frame-0 truth mis-scores the late frames)."""
    dt = small_cfg.num_chirps * small_cfg.chirp_interval_s
    frames = 120   # small_cfg range bins are ~0.78 m; the drift must
    v = 4.0        # exceed the 1-bin gate with margin: 4*120*dt ~ 2.0 m
    # the scenario only bites if the drift actually exceeds the gate
    r_res = 3e8 * small_cfg.sample_rate_hz / (
        2 * small_cfg.slope_hz_per_s * small_cfg.range_fft_size)
    assert v * frames * dt > 2 * r_res
    pts = pd_curve(small_cfg, amplitudes=(2000.0,), frames=frames,
                   velocity_mps=v, noise_std=5.0, seed=3)
    assert pts[0].pd == 1.0


def test_object_metrics_tracks_moving_truth():
    """object_metrics propagates truth ranges per frame: centroid RMSE
    measures clustering, not target motion (a fast target over enough
    frames would otherwise accumulate ~0.5 m of pure drift)."""
    from mmradar.evaluate import object_metrics

    cfg = RadarConfig()
    om = object_metrics(cfg, ranges_m=(8.0,), velocities_mps=(-4.0,),
                        amplitude=2500.0, frames=16, noise_std=5.0,
                        seed=1)
    dt = cfg.num_chirps * cfg.chirp_interval_s
    assert 4.0 * 16 * dt > 0.4  # the drift the static truth would leak
    assert om["object_pd"] == 1.0
    assert om["range_rmse_m"] < 0.2


def test_cli_eval_smoke(capsys):
    from mmradar.cli import main

    rc = main(["eval", "--frames", "4", "--amplitudes", "1000",
               "--seed", "2"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    events = {l["event"] for l in lines}
    assert {"pfa", "pd"} <= events
    pd_line = [l for l in lines if l["event"] == "pd"][0]
    assert pd_line["pd"] == 1.0


def test_object_metrics_two_targets():
    """Strong, well-separated targets: every frame reports both objects
    with tight centroids, and clustering dedupes the raw cell list."""
    from mmradar.evaluate import object_metrics

    cfg = RadarConfig()
    om = object_metrics(cfg, ranges_m=(3.0, 8.0),
                        velocities_mps=(2.0, -4.0), amplitude=2500.0,
                        frames=6, noise_std=5.0, seed=1)
    assert om["object_pd"] == 1.0
    assert om["true_objects"] == 2
    assert om["range_rmse_m"] < 0.5
    assert om["velocity_rmse_mps"] < 0.5
    # the raw top-K list carries multiple cells per blob; objects <= cells
    assert om["mean_objects"] <= om["mean_valid_detections"]


def test_cli_eval_objects(capsys):
    from mmradar.cli import main

    rc = main(["eval", "--frames", "4", "--amplitudes", "1000",
               "--seed", "2", "--objects"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    obj = [l for l in lines if l["event"] == "objects"]
    assert len(obj) == 1
    assert 0.0 <= obj[0]["object_pd"] <= 1.0
    assert obj[0]["mean_objects"] >= 1.0


@pytest.mark.parametrize("kind", ["ekf", "alpha-beta"])
def test_track_metrics_clean_scene(kind):
    """On a clean 2-moving-target scene both trackers must hold one
    unbroken track per truth: full post-warmup coverage, zero identity
    switches, no false confirmed tracks, and state RMSE well inside a
    bin width (the synthetic generator moves targets coherently, so the
    truth trajectory is analytic)."""
    from mmradar.evaluate import track_metrics

    m = track_metrics(frames=12, tracker_kind=kind, rd_impl="fused",
                      seed=3)
    assert m["track_pd"] == 1.0
    assert m["id_switches"] == 0
    assert m["fragments_per_truth"] == 1.0
    assert m["false_track_frames"] == 0
    assert m["range_rmse_m"] < 0.3
    assert m["velocity_rmse_mps"] < 0.3
    assert m["azimuth_rmse_deg"] < 2.0


def test_cli_eval_tracks(capsys):
    from mmradar.cli import main

    rc = main(["eval", "--frames", "6", "--amplitudes", "2500",
               "--seed", "2", "--tracks"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    tr = [l for l in lines if l["event"] == "tracks"]
    assert len(tr) == 1
    assert tr[0]["tracker"] == "ekf"
    assert 0.0 <= tr[0]["track_pd"] <= 1.0
    assert tr[0]["n_truths"] == 2


def test_track_metrics_crossing_targets_ekf():
    """Two targets whose ranges CROSS mid-sequence (4+6t vs 7-6t meet at
    t=0.25 s = frame 30 of 40): the EKF's Cartesian constant-velocity
    model must carry both identities through the crossing — zero ID
    switches, one unbroken track per truth — the scenario the
    alpha-beta tracker's polar nearest-neighbor association exists to
    be upgraded from (DESIGN's EKF rationale)."""
    from mmradar.evaluate import track_metrics

    m = track_metrics(ranges_m=(4.0, 7.0), velocities_mps=(6.0, -6.0),
                      azimuths_deg=(20.0, -20.0), frames=40,
                      tracker_kind="ekf", rd_impl="fused", seed=5)
    assert m["track_pd"] == 1.0
    assert m["id_switches"] == 0
    assert m["fragments_per_truth"] == 1.0
    assert m["false_track_frames"] == 0
    assert m["range_rmse_m"] < 0.3
