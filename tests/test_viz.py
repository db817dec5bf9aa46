"""Visualization smoke tests (Agg backend, files rendered to disk)."""

import jax.numpy as jnp
import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from mmradar import viz  # noqa: E402
from mmradar.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from mmradar.models.range_detector import RangeDetector  # noqa: E402
from mmradar.models.rd_pipeline import RDPipeline, integrate_power  # noqa: E402
from mmradar.models.tracker import detections_from_result, track_capture  # noqa: E402


@pytest.fixture(scope="module")
def scene(cfg):
    return synthesize_capture(
        [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0,
                     amplitude=3000.0)],
        6, cfg, noise_std=2.0, seed=81,
    )


def test_plot_range_profile(tmp_path, cfg, scene):
    det = RangeDetector(cfg)
    base = det.prepare_base(jnp.asarray(scene[0]))
    spec = np.asarray(det.spectrum(jnp.asarray(scene[1]), base))
    out = det.detect(jnp.asarray(scene[1]), base)
    p = tmp_path / "profile.png"
    viz.plot_range_profile(spec, cfg, peak_bin=int(out.peak_bin), path=str(p))
    assert p.stat().st_size > 5000


def test_plot_range_doppler_with_detections(tmp_path, cfg, scene):
    pipe = RDPipeline(cfg, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(scene[0]))
    rd = pipe.rd_cube(jnp.asarray(scene[1:2]), base)
    power = np.asarray(integrate_power(rd))[0]
    out = pipe.detect(jnp.asarray(scene[1:]), base)
    dets = detections_from_result(out, 0)
    p = tmp_path / "rd.png"
    viz.plot_range_doppler(power, cfg, detections=dets, path=str(p))
    assert p.stat().st_size > 10000


def test_plot_tracks(tmp_path, cfg, scene):
    pipe = RDPipeline(cfg, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(scene[0]))
    out = pipe.detect(jnp.asarray(scene[1:]), base)
    tracker = track_capture(out, cfg)
    p = tmp_path / "tracks.png"
    viz.plot_tracks(tracker, cfg, path=str(p))
    assert p.stat().st_size > 5000


def test_plot_range_doppler_with_cluster_boxes(tmp_path, cfg, scene):
    """Detection dicts carrying cluster fields render object extent
    boxes without error."""
    pipe = RDPipeline(cfg, max_detections=8)
    base = pipe.prepare_base(jnp.asarray(scene[0]))
    out, cl = pipe.detect_objects(jnp.asarray(scene[1:]), base)
    rd = pipe.rd_cube(jnp.asarray(scene[1:2]), base)
    power = np.asarray(integrate_power(rd))[0]
    dets = []
    valid = np.asarray(out.valid)
    for k in range(valid.shape[1]):
        if valid[0, k]:
            dets.append({
                "range_m": float(out.range_m[0, k]),
                "velocity_mps": float(out.velocity_mps[0, k]),
                "cluster_range_m": float(cl.centroid_range_m[0, k]),
                "cluster_velocity_mps":
                    float(cl.centroid_velocity_mps[0, k]),
                "cluster_extent_bins": [
                    int(cl.extent_doppler_bins[0, k]),
                    int(cl.extent_range_bins[0, k]),
                ],
            })
    assert dets
    p = tmp_path / "rd_clusters.png"
    viz.plot_range_doppler(power, cfg, detections=dets, path=str(p))
    assert p.stat().st_size > 10000
